"""The nested-result aggregates and the nested queries in duckdb_tpu_torch
(device="cpu") against duckdb_tpu.

list/array_agg (with DISTINCT, ORDER BY and FILTER), string_agg (with a
separator, ORDER BY and NULLs), histogram, histogram_exact, approx_top_k,
bitstring_agg and lttb: grouped through the perfect and the sort-group
modes, ungrouped, over NULLs and over no rows, at SF 0.01 seed 7, with rows
equal to the reference's (DOUBLE to 1e-9 relative). Then NESTED_QUERIES'
nested_agg and nested_collect against the reference and the numpy oracle,
their routes and the grouped-sum calls they make.

The reference's list(x ORDER BY y) ignores the ORDER BY (ROADMAP Queue 3,
fault (a)) and its list() … FILTER lists NULLs for the filtered rows; both
are held to numpy here. The reference raises on nested_collect's len()
(fault (f)), so that query is also compared with array_length in its
place.
"""

import numpy as np
import pytest
import torch

import duckdb_tpu
import duckdb_tpu_torch
from duckdb_tpu_torch.ops import grouped as grouped_mod
from duckdb_tpu_torch.testing import tpch_oracle
from duckdb_tpu_torch.testing.tpch_gen import write_tables

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("tpch_gen_nested_aggs")
    write_tables(str(root), 0.01, seed=7)
    return str(root)


@pytest.fixture(scope="module")
def cons(data_dir):
    jcon = duckdb_tpu.connect()
    jcon.load_tpch(data_dir)
    tcon = duckdb_tpu_torch.connect(device="cpu")
    tcon.load_tpch(data_dir)
    return jcon, tcon


def _deep(v, top=True):
    """Inner nested values as tuples (the reference's form, fault (c))."""
    if isinstance(v, (list, tuple)):
        inner = [_deep(x, False) for x in v]
        return inner if top and isinstance(v, list) else tuple(inner)
    if isinstance(v, dict):
        return {k: _deep(x, False) for k, x in v.items()} if top \
            else tuple(_deep(x, False) for x in v.values())
    return v


def _match(got, want):
    assert len(got) == len(want)
    for g_row, w_row in zip(got, want):
        assert len(g_row) == len(w_row)
        for g, w in zip(g_row, w_row):
            g = _deep(g)
            if isinstance(w, float) and w == w:
                assert g == pytest.approx(w, rel=1e-9, abs=0.0), (g_row, w_row)
            elif isinstance(w, list) and w and isinstance(w[0], float):
                assert g == pytest.approx(w, rel=1e-9, abs=0.0), (g_row, w_row)
            else:
                assert g == w, (g_row, w_row)


AGGS = {
    "list_perfect": "SELECT o_orderstatus, list(o_orderpriority), array_agg(o_shippriority) "
                    "FROM orders WHERE o_orderkey < 200 GROUP BY 1 ORDER BY 1",
    "list_sort_group": "SELECT o_custkey, list(o_orderkey) FROM orders WHERE o_custkey < 40 "
                       "GROUP BY 1 ORDER BY 1",
    "list_ungrouped": "SELECT list(r_name), list(r_regionkey) FROM region",
    "list_nulls": "SELECT n_regionkey, list(nullif(n_nationkey % 3, 0)) FROM nation "
                  "GROUP BY 1 ORDER BY 1",
    "list_distinct": "SELECT n_regionkey, list(DISTINCT n_nationkey % 2), "
                     "list(DISTINCT nullif(n_nationkey % 3, 0)) FROM nation GROUP BY 1 ORDER BY 1",
    "over_no_rows": "SELECT list(o_orderkey), string_agg(o_comment, ','), "
                    "histogram(o_orderstatus), "
                    "approx_top_k(o_custkey, 2), bitstring_agg(o_shippriority) FROM orders "
                    "WHERE o_orderkey < 0",
    "list_of_lists": "SELECT n_regionkey, list(string_split(n_name, ' ')) FROM nation "
                     "GROUP BY 1 ORDER BY 1",
    "list_doubles": "SELECT n_regionkey, list(CAST(n_nationkey AS DOUBLE) / 4) FROM nation "
                    "GROUP BY 1 ORDER BY 1",
    "string_agg": "SELECT n_regionkey, string_agg(n_name, '-'), group_concat(n_name), "
                  "listagg(n_name, ';') FROM nation GROUP BY 1 ORDER BY 1",
    "string_agg_order": "SELECT n_regionkey, string_agg(n_name, ',' ORDER BY n_name DESC), "
                        "string_agg(n_name, '|' ORDER BY n_nationkey) FROM nation "
                        "GROUP BY 1 ORDER BY 1",
    "string_agg_ungrouped": "SELECT string_agg(r_name, ', ' ORDER BY r_name) FROM region",
    "string_agg_nulls": "SELECT n_regionkey, string_agg(CASE WHEN n_nationkey % 2 = 0 "
                        "THEN n_name END, ',') FROM nation GROUP BY 1 ORDER BY 1",
    "string_agg_number": "SELECT n_regionkey, string_agg(n_nationkey, ',') FROM nation "
                         "GROUP BY 1 ORDER BY 1",
    "histogram": "SELECT o_orderstatus, histogram(o_orderpriority), histogram(o_shippriority) "
                 "FROM orders GROUP BY 1 ORDER BY 1",
    "histogram_nulls": "SELECT n_regionkey, histogram(nullif(n_nationkey % 3, 0)) FROM nation "
                       "GROUP BY 1 ORDER BY 1",
    "histogram_ints": "SELECT l_returnflag, histogram(l_linenumber), histogram(l_quantity > 25) "
                      "FROM lineitem GROUP BY 1 ORDER BY 1",
    "histogram_sort_group": "SELECT o_custkey, histogram(o_orderstatus) FROM orders "
                            "WHERE o_custkey < 30 GROUP BY 1 ORDER BY 1",
    "histogram_ungrouped": "SELECT histogram(l_shipmode), histogram(l_linestatus) FROM lineitem",
    "approx_top_k": "SELECT l_returnflag, approx_top_k(l_shipmode, 3), "
                    "approx_top_k(l_linenumber, 2) FROM lineitem GROUP BY 1 ORDER BY 1",
    "approx_top_k_ungrouped": "SELECT approx_top_k(o_orderpriority, 2), approx_top_k(o_custkey, 4) "
                              "FROM orders",
    "bitstring_agg": "SELECT n_regionkey, bitstring_agg(n_nationkey) FROM nation "
                     "GROUP BY 1 ORDER BY 1",
    "bitstring_agg_bounds": "SELECT n_regionkey, bitstring_agg(n_nationkey, 0, 30) FROM nation "
                            "GROUP BY 1 ORDER BY 1",
    "bitstring_agg_ungrouped": "SELECT bitstring_agg(l_linenumber) FROM lineitem",
    "histogram_exact": "SELECT n_regionkey, histogram_exact(n_nationkey % 4, [0, 1, 5]) "
                       "FROM nation "
                       "GROUP BY 1 ORDER BY 1",
    "lttb": "SELECT n_regionkey, lttb(n_nationkey, CAST(n_nationkey AS DOUBLE) * 2, 3) "
            "FROM nation GROUP BY 1 ORDER BY 1",
    "functions_of_aggregates": "SELECT o_orderstatus, list_sort(list(o_orderpriority))[1], "
                               "len(list(o_orderkey)), cardinality(histogram(o_orderpriority)), "
                               "histogram(o_orderpriority)['1-URGENT'] FROM orders "
                               "GROUP BY 1 ORDER BY 1",
    "with_core_aggregates": "SELECT l_returnflag, l_linestatus, histogram(l_shipmode), count(*), "
                            "sum(l_quantity), avg(l_discount), list(DISTINCT l_shipinstruct) "
                            "FROM lineitem GROUP BY 1, 2 ORDER BY 1, 2",
}


@pytest.mark.parametrize("name", sorted(AGGS))
def test_aggregate_matches_jax(cons, name):
    jcon, tcon = cons
    tcon.routes.clear()
    got = tcon.sql(AGGS[name]).rows()
    assert tcon.routes.get("general_aggregate") == 1, dict(tcon.routes)
    _match(got, jcon.sql(AGGS[name]).rows())


def test_over_no_rows_is_null(cons):
    _, tcon = cons
    assert tcon.sql(AGGS["over_no_rows"]).rows() == [(None, None, None, None, None)]


def test_fault_a_list_order_by(cons, data_dir):
    """(a) list(x ORDER BY y) orders by y (the reference keeps row order)."""
    _, tcon = cons
    got = tcon.sql("SELECT n_regionkey, list(n_name ORDER BY n_name DESC)[1], "
                   "list(n_nationkey ORDER BY n_name), "
                   "list(n_name ORDER BY n_nationkey DESC) FROM nation "
                   "GROUP BY 1 ORDER BY 1").rows()
    t = tpch_oracle._Tables(data_dir)
    region = t("nation", "n_regionkey")
    names = [v.decode() for v in t("nation", "n_name")]
    keys = t("nation", "n_nationkey").tolist()
    want = []
    for r in np.unique(region).tolist():
        rows = np.flatnonzero(region == r).tolist()
        by_name = sorted(rows, key=lambda i: names[i])
        want.append((r, names[by_name[-1]], [keys[i] for i in by_name],
                     [names[i] for i in sorted(rows, key=lambda i: -keys[i])]))
    assert got == want
    assert got[0][1] == "MOZAMBIQUE"


def test_list_filter_drops_rows(cons, data_dir):
    """list(x) FILTER (WHERE p) lists only the rows p keeps (DuckDB); the
    reference lists a NULL for each row it drops."""
    _, tcon = cons
    got = tcon.sql("SELECT n_regionkey, list(n_nationkey) FILTER (WHERE n_nationkey > 10), "
                   "count(*) FILTER (WHERE n_nationkey > 10) FROM nation "
                   "GROUP BY 1 ORDER BY 1").rows()
    t = tpch_oracle._Tables(data_dir)
    region, key = t("nation", "n_regionkey"), t("nation", "n_nationkey")
    want = []
    for r in np.unique(region).tolist():
        ks = key[(region == r) & (key > 10)].tolist()
        want.append((r, ks or None, len(ks)))
    assert got == want


@pytest.mark.parametrize("sql", [
    "SELECT string_agg(DISTINCT n_name, ',') FROM nation",
    "SELECT histogram(DISTINCT n_regionkey) FROM nation",
])
def test_distinct_forms_the_reference_refuses(cons, sql):
    _, tcon = cons
    with pytest.raises(ValueError, match="distinct aggregate"):
        tcon.sql(sql)


def test_nested_min_max_grouped(cons, data_dir):
    """min/max over a LIST compare DuckDB's ranks, through both groupings."""
    _, tcon = cons
    got = tcon.sql("SELECT o_orderstatus, min(l), max(l) FROM (SELECT o_orderstatus, "
                   "list_value(o_shippriority, o_custkey % 7) AS l FROM orders) "
                   "GROUP BY 1 ORDER BY 1").rows()
    t = tpch_oracle._Tables(data_dir)
    status = t("orders", "o_orderstatus")
    pairs = list(zip(t("orders", "o_shippriority").tolist(),
                     (t("orders", "o_custkey") % 7).tolist()))
    want = []
    for s in np.unique(status).tolist():
        ps = [list(p) for p, st in zip(pairs, status.tolist()) if st == s]
        want.append((s.decode(), min(ps), max(ps)))
    assert got == want


# -- the nested queries over lineitem ------------------------------------------------
def test_nested_agg_matches_jax_and_oracle(cons, data_dir):
    jcon, tcon = cons
    sql = tpch_oracle.NESTED_QUERIES["nested_agg"]
    got = tcon.sql(sql).rows()
    assert got == jcon.sql(sql).rows()
    assert got == tpch_oracle.answer("nested_agg", data_dir)


def test_nested_collect_matches_oracle_and_jax_with_array_length(cons, data_dir):
    jcon, tcon = cons
    sql = tpch_oracle.NESTED_QUERIES["nested_collect"]
    got = tcon.sql(sql).rows()
    assert got == tpch_oracle.answer("nested_collect", data_dir)
    assert got == jcon.sql(sql.replace("len(", "array_length(")).rows()


ROUTES = {"nested_agg": {"general_aggregate": 1, "general_perfect": 1},
          "nested_collect": {"general_aggregate": 1, "general_perfect": 1, "sort_group": 1},
          "nested_words": {"dense": 1},
          "nested_pack": {"general_aggregate": 1, "general_sort_group": 1},
          "nested_pack_agg": {"general_aggregate": 1, "general_perfect": 1}}
# (vectors, slots) of each grouped-sum call: occupancy of the 4 x 3 slots,
# then count(*) and sum(l_quantity) over the 4 groups
KERNEL_CALLS = {"nested_agg": [(1, 12), (1, 4), (1, 4)], "nested_collect": [],
                "nested_words": None, "nested_pack": [(1, 50), (2, 50), (2, 50)],
                "nested_pack_agg": [(1, 26), (1, 24)]}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_nested_query_route_and_grouped_sum_calls(data_dir, monkeypatch, name):
    """The route each takes, and the grouped sum's calls: nested_agg's
    count and sum over the 4 groups (the kernel's small regime on a card)."""
    seen = []
    orig = grouped_mod.grouped_sum_i64

    def recording(dense, vectors, nseg):
        seen.append((len(vectors), nseg))
        return orig(dense, vectors, nseg)

    monkeypatch.setattr(grouped_mod, "grouped_sum_i64", recording)
    tcon = duckdb_tpu_torch.connect(device="cpu")
    tcon.load_tpch(data_dir)
    tcon.sql(tpch_oracle.NESTED_QUERIES[name]).rows()
    assert dict(tcon.routes) == ROUTES[name]
    if KERNEL_CALLS[name] is not None:
        assert seen == KERNEL_CALLS[name]
    else:
        assert len(seen) == 1 and seen[0][1] > 55  # the words' dense slots: the large regime
