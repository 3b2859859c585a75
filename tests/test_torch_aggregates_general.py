"""The general aggregate path of duckdb_tpu_torch (device="cpu").

Every aggregate the fused pipeline refuses runs in execution/aggregate_exec
(and aggregate_stats): the variance family, median and the quantiles,
mode, first/last/any_value and arg_min/arg_max with and without ORDER BY
inside the aggregate, bool_and/bool_or, product, fsum, min/max over
strings, the statistical aggregates, FILTER, DISTINCT beside them, and a
computed VARCHAR group key. Each family is compared with the JAX package
(whose executor takes its own general path for the same plans) over the
port's generator's tables at SF 0.01, seed 7: grouped by a dictionary
column (the perfect mode), by a DOUBLE key (the sort-group mode),
ungrouped, and over a LEFT join that leaves groups with no live value;
then no rows, NULL keys, two keys and GROUP BY ALL.
DECIMAL, integer, string, date and NULL values must match exactly, DOUBLE
values within 1e-9 relative, in ORDER BY order. The general-aggregate query
of testing/tpch_oracle (the one chip_smoke.py runs at SF1) is held to the
numpy oracle, and the aggregates left out say which ROADMAP item they wait
for.
"""

import pytest
import torch

import duckdb_tpu
import duckdb_tpu_torch
from duckdb_tpu_torch.ops import grouped as grouped_mod
from duckdb_tpu_torch.testing import tpch_oracle
from duckdb_tpu_torch.testing.tpch_gen import write_tables

torch.set_num_threads(1)

FAMILIES = {
    "variance": "stddev(o_totalprice), stddev_samp(o_totalprice), stddev_pop(o_totalprice), "
                "variance(o_totalprice), var_samp(o_custkey), var_pop(o_totalprice)",
    "quantile": "median(o_totalprice), quantile(o_custkey, 0.25), "
                "quantile_cont(o_totalprice, 0.75), quantile_disc(o_orderdate, 0.5), "
                "approx_quantile(o_totalprice, 0.5), median(o_custkey), "
                "quantile_disc(o_totalprice, 0.9)",
    "pick": "mode(o_orderstatus), mode(o_custkey), first(o_orderkey), last(o_orderkey), "
            "any_value(o_comment), arbitrary(o_orderdate)",
    "order_by": "first(o_orderkey ORDER BY o_totalprice DESC), "
                "last(o_custkey ORDER BY o_orderdate), first(o_comment ORDER BY o_clerk), "
                "any_value(o_orderpriority ORDER BY o_totalprice)",
    "arg": "arg_min(o_orderkey, o_totalprice), arg_max(o_comment, o_orderdate), "
           "max_by(o_custkey, o_totalprice), min_by(o_orderkey, o_clerk), "
           "arg_max_null(o_orderkey, o_totalprice)",
    "bool_product": "bool_and(o_totalprice > 1000), bool_or(o_orderstatus = 'P'), "
                    "product(1 + o_custkey % 3) FILTER (WHERE o_orderkey < 300), "
                    "fsum(o_totalprice), kahan_sum(o_custkey)",
    "strings": "min(o_comment), max(o_orderstatus), min(o_clerk), max(o_orderpriority)",
    "stats": "corr(o_totalprice, o_custkey), covar_pop(o_totalprice, o_custkey), "
             "covar_samp(o_totalprice, o_custkey), regr_avgx(o_totalprice, o_custkey), "
             "regr_sxy(o_totalprice, o_custkey), regr_count(o_totalprice, o_custkey), "
             "skewness(o_totalprice), kurtosis(o_totalprice), kurtosis_pop(o_custkey), "
             "entropy(o_orderstatus), sem(o_totalprice), mad(o_totalprice), "
             "count_if(o_totalprice > 100000)",
    "filter": "count(*) FILTER (WHERE o_totalprice > 150000), "
              "sum(o_totalprice) FILTER (WHERE o_orderstatus = 'F'), "
              "median(o_totalprice) FILTER (WHERE o_custkey % 2 = 0), "
              "min(o_comment) FILTER (WHERE o_orderkey > 100)",
    # the aggregates the fused pipeline takes, here beside one it does not
    "core": "count(*), count(o_custkey), sum(o_totalprice), sum(o_custkey), "
            "avg(o_totalprice), min(o_totalprice), max(o_orderdate), mode(o_orderstatus), "
            "count(DISTINCT o_custkey), sum(DISTINCT o_custkey % 10), "
            "avg(DISTINCT o_totalprice)",
}
SHAPES = {
    "perfect": "SELECT o_orderpriority, {aggs} FROM orders GROUP BY 1 ORDER BY 1",
    "sort_group": "SELECT CAST(o_custkey % 5 AS DOUBLE) AS g, {aggs} FROM orders "
                  "GROUP BY g ORDER BY g",
    "ungrouped": "SELECT {aggs} FROM orders",
    # 17 of the 25 nations have no order above 400,000: groups with no live value
    "no_live": "SELECT c_nationkey, {aggs} FROM customer LEFT JOIN orders "
               "ON c_custkey = o_custkey AND o_totalprice > 400000 GROUP BY 1 ORDER BY 1",
}
# the grouping route each shape shows on the general path
SHAPE_ROUTE = {"perfect": "general_perfect", "sort_group": "general_sort_group",
               "no_live": "general_perfect", "ungrouped": None}
CASES = [(f, s) for f in sorted(FAMILIES) for s in SHAPES
         if s in ("perfect", "ungrouped") or f in ("variance", "quantile", "order_by", "arg",
                                                    "strings", "filter", "core")]

COMPUTED_KEY = {
    "substring": "SELECT substring(o_comment, 1, 1) AS k, count(*), median(o_totalprice), "
                 "sum(o_totalprice) FROM orders GROUP BY k ORDER BY k",
    "upper_two_keys": "SELECT upper(o_orderstatus) AS s, o_orderpriority, count(*), "
                      "max(o_clerk) FROM orders GROUP BY s, o_orderpriority ORDER BY s, 2",
    "concat": "SELECT o_orderstatus || '-' || o_orderpriority AS k, count(*), "
              "sum(o_custkey) FROM orders GROUP BY k ORDER BY k",
}


EDGES = {
    # no live row: no group, in either grouping mode
    "empty_perfect": "SELECT o_orderstatus, median(o_totalprice), count(*) FROM orders "
                     "WHERE o_orderkey < 0 GROUP BY 1",
    "empty_sort_group": "SELECT CAST(o_custkey AS DOUBLE) AS g, mode(o_orderstatus) "
                        "FROM orders WHERE o_orderkey < 0 GROUP BY g",
    # a NULL group key from the LEFT join's unmatched customers
    "null_key": "SELECT o_orderstatus, median(c_acctbal), count(*), mode(c_mktsegment), "
                "stddev(c_acctbal) FROM customer LEFT JOIN orders ON c_custkey = o_custkey "
                "AND o_totalprice > 400000 GROUP BY 1 ORDER BY 1",
    "two_keys": "SELECT o_orderpriority, o_orderstatus, first(o_clerk ORDER BY o_orderdate "
                "DESC), median(o_shippriority) FROM orders GROUP BY 1, 2 ORDER BY 1, 2",
    "two_keys_sort_group_null": "SELECT CAST(o_custkey % 3 AS DOUBLE) AS g, o_orderstatus, "
                                "median(o_totalprice) FROM customer LEFT JOIN orders "
                                "ON c_custkey = o_custkey GROUP BY 1, 2 ORDER BY 1, 2",
    "group_by_all": "SELECT c_mktsegment, quantile_cont(c_acctbal, 0.1), "
                    "quantile_disc(c_acctbal, 0.99), mode(c_nationkey) FROM customer "
                    "GROUP BY ALL ORDER BY 1",
}


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("tpch_gen_aggregates")
    write_tables(str(root), 0.01, seed=7)
    return str(root)


@pytest.fixture(scope="module")
def cons(data_dir):
    jcon = duckdb_tpu.connect()
    jcon.load_tpch(data_dir)
    jcon.sql("SET pallas_grouped_sum = 'on'")
    tcon = duckdb_tpu_torch.connect(device="cpu")
    tcon.load_tpch(data_dir)
    yield jcon, tcon
    jcon.sql("RESET pallas_grouped_sum")


def assert_rows_match(got, want):
    assert len(got) == len(want)
    for g_row, w_row in zip(got, want):
        assert len(g_row) == len(w_row)
        for g, w in zip(g_row, w_row):
            assert type(g) is type(w), (g_row, w_row)
            if isinstance(w, float) and w == w:
                assert g == pytest.approx(w, rel=1e-9, abs=0.0), (g_row, w_row)
            elif isinstance(w, float):
                assert g != g, (g_row, w_row)  # NaN, as the reference's 0/0
            else:
                assert g == w, (g_row, w_row)


@pytest.mark.parametrize("family,shape", CASES, ids=[f"{f}-{s}" for f, s in CASES])
def test_family_matches_jax(cons, family, shape):
    jcon, tcon = cons
    sql = SHAPES[shape].format(aggs=FAMILIES[family])
    tcon.routes.clear()
    got = tcon.sql(sql).rows()
    routes = dict(tcon.routes)
    assert_rows_match(got, jcon.sql(sql).rows())
    if family != "core" or shape != "ungrouped":
        assert routes.get("general_aggregate") == 1, routes
    if SHAPE_ROUTE[shape]:
        assert routes.get(SHAPE_ROUTE[shape]) == 1, routes
    if shape == "no_live":
        assert any(None in r for r in got)


@pytest.mark.parametrize("name", sorted(COMPUTED_KEY))
def test_computed_varchar_key_matches_jax(cons, name):
    """A computed VARCHAR key groups perfectly over the dictionary its
    function made."""
    jcon, tcon = cons
    tcon.routes.clear()
    got = tcon.sql(COMPUTED_KEY[name]).rows()
    assert tcon.routes.get("general_perfect") == 1, dict(tcon.routes)
    assert_rows_match(got, jcon.sql(COMPUTED_KEY[name]).rows())


@pytest.mark.parametrize("name", sorted(EDGES))
def test_edge_shapes_match_jax(cons, name):
    jcon, tcon = cons
    got = tcon.sql(EDGES[name]).rows()
    assert_rows_match(got, jcon.sql(EDGES[name]).rows())
    assert bool(got) != name.startswith("empty")


def test_general_agg_matches_oracle_and_jax(cons, data_dir):
    jcon, tcon = cons
    sql = tpch_oracle.GENERAL_QUERIES["general_agg"]
    got = tcon.sql(sql).rows()
    assert_rows_match(got, tpch_oracle.answer("general_agg", data_dir))
    assert_rows_match(got, jcon.sql(sql).rows())


def test_general_path_sums_through_the_kernel_wrapper(data_dir, monkeypatch):
    """Grouped over at most 256 slots, the general path's int64 sums (here
    the occupancy of the perfect slots, then one count of the live rows
    that count(*) and the median share) go through the grouped-sum kernel's
    wrapper, over the perfect domain and then over the groups."""
    slots = []
    orig = grouped_mod.grouped_sum_i64

    def recording(dense, vectors, nseg):
        slots.append(nseg)
        return orig(dense, vectors, nseg)

    monkeypatch.setattr(grouped_mod, "grouped_sum_i64", recording)
    tcon = duckdb_tpu_torch.connect(device="cpu")
    tcon.load_tpch(data_dir)
    tcon.sql("SELECT o_orderstatus, count(*), median(o_totalprice) FROM orders "
             "GROUP BY 1").rows()
    # the occupancy of 3 statuses + the NULL slot, then one count over the
    # 3 groups
    assert slots == [4, 3]


def test_ungrouped_over_no_rows(cons):
    """One row; count 0, the rest NULL."""
    jcon, tcon = cons
    sql = ("SELECT count(*), median(o_totalprice), mode(o_orderstatus), "
           "first(o_orderkey), stddev(o_totalprice), bool_or(o_custkey > 0), "
           "min(o_comment), corr(o_totalprice, o_custkey), entropy(o_orderstatus) "
           "FROM orders WHERE o_orderkey < 0")
    got = tcon.sql(sql).rows()
    assert got[0][:8] == (0, None, None, None, None, None, None, None)
    assert_rows_match(got, jcon.sql(sql).rows())


@pytest.mark.parametrize("sql,item", [
    # the nested-result aggregates (tests/test_torch_nested_aggs.py) and
    # json_group_array (tests/test_torch_json.py) are ported, and so are
    # aggregates over a window (item 29: tests/test_torch_window.py);
    # an ordered median over a window (item 44) answers each row's running
    # median
    ("SELECT sum(o_totalprice) OVER () FROM orders", "29"),
    ("SELECT o_orderstatus, count(*) OVER (PARTITION BY o_orderstatus) FROM orders", "29"),
    ("SELECT median(o_totalprice) OVER (ORDER BY o_orderkey) FROM orders", "44"),
])
def test_left_out_aggregates_name_their_roadmap_item(cons, sql, item):
    _, tcon = cons
    if item == "29":
        # ported: a whole-partition total on every row, as Python counts it
        rows = tcon.sql(sql).rows()
        want = tcon.sql("SELECT count(*), sum(o_totalprice) FROM orders").rows()[0]
        if "count" in sql:
            per = dict(tcon.sql("SELECT o_orderstatus, count(*) FROM orders GROUP BY 1").rows())
            assert len(rows) == want[0] and all(n == per[st] for st, n in rows)
        else:
            assert len(rows) == want[0] and all(r == (want[1],) for r in rows)
        return
    if item == "44":
        # ported: each row's median of the prices up to its order key (the
        # running frame), as Python's statistics.median of the prefix gives it
        import bisect
        import statistics

        got = tcon.sql(sql.replace(" FROM orders", ", o_orderkey, o_totalprice FROM orders"))
        prefix = []
        for med, _, price in sorted(got.rows(), key=lambda r: r[1]):
            bisect.insort(prefix, float(price))
            assert med == pytest.approx(statistics.median(prefix), rel=1e-12)
        return
    with pytest.raises(ValueError, match=f"ROADMAP item {item}.*not yet ported"):
        tcon.sql(sql)


def test_arity_is_checked(cons):
    _, tcon = cons
    with pytest.raises(ValueError, match="corr requires 2 arguments"):
        tcon.sql("SELECT corr(o_totalprice) FROM orders")


@pytest.mark.parametrize("grouped", [False, True])
def test_float_sum_distinct_is_sql(cons, grouped):
    """sum/avg(DISTINCT) over a DOUBLE on the general path sum the distinct
    values (0 … 9 here). The JAX package sums their orderable bit codes and
    fails while reading the result (ROADMAP Queue 3), so the port is held
    to SQL."""
    _, tcon = cons
    key = "o_orderstatus, " if grouped else ""
    rows = tcon.sql(f"SELECT {key}sum(DISTINCT CAST(o_custkey % 10 AS DOUBLE)), "
                    f"avg(DISTINCT CAST(o_custkey % 10 AS DOUBLE)), median(o_totalprice) "
                    f"FROM orders {'GROUP BY 1 ORDER BY 1' if grouped else ''}").rows()
    assert [r[-3:-1] for r in rows] == [(45.0, 4.5)] * len(rows) and rows
