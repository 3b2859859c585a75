"""LIKE and count(DISTINCT): TPC-H Q2, Q9, Q13, Q14, Q16 and Q20 end to end
through duckdb_tpu_torch (device="cpu"), against duckdb_tpu and against
the numpy oracle.

Both packages load one directory of all eight tables written by the port's
seeded generator at SF 0.01, seed 7, whose p_name, p_type, s_comment and
o_comment follow the specification. The specification's parameters select
rows there for all six, except that no supplier comment holds "Customer …
Complaints" at this scale (5 in 10,000), so a Q16 variant excludes the
suppliers whose comment holds "x" and then "yz". The JAX connection runs
with `SET pallas_grouped_sum = 'on'`. DECIMAL, integer, date and string
values must match exactly, DOUBLE values (Q14's share, avg) within 1e-9
relative, in the order ORDER BY fixes. Plan trees are compared with the
JAX planner's on fresh connections, so the LIKE filters' selectivity (0.25,
0.75 negated) is held. count, sum and avg DISTINCT run grouped (dense and
sort-group) and ungrouped, over NULLs, a VARCHAR argument and groups with
no live value. The last test holds a materialized CTE's VARCHAR join key
to SQL's answer where the JAX package's catalog statistics mislead it.
"""

import re

import numpy as np
import pytest
import torch

import duckdb_tpu
import duckdb_tpu_torch
from duckdb_tpu.planner.planner import Planner as JPlanner
from duckdb_tpu.sql.parser import Parser as JParser
from duckdb_tpu_torch.catalog.catalog import ColumnDef, TableEntry
from duckdb_tpu_torch.ops import grouped as grouped_mod
from duckdb_tpu_torch.planner.planner import Planner as TPlanner
from duckdb_tpu_torch.sql.parser import Parser as TParser
from duckdb_tpu_torch.testing import tpch_oracle
from duckdb_tpu_torch.testing.tpch_gen import write_tables
from duckdb_tpu_torch.types import INTEGER, VARCHAR

torch.set_num_threads(1)

QUERIES = tpch_oracle.LIKE_QUERIES
Q16_REMARK = ("x", "yz")
DISTINCT = {
    "distinct_grouped": """
SELECT l_returnflag, count(DISTINCT l_suppkey) AS supps, sum(DISTINCT l_quantity) AS qty,
  avg(DISTINCT l_discount) AS disc, count(DISTINCT l_shipmode) AS modes,
  count(l_shipmode) AS lines
FROM lineitem GROUP BY l_returnflag ORDER BY l_returnflag
""",
    "distinct_ungrouped": """
SELECT count(DISTINCT o_custkey) AS custs, sum(DISTINCT o_totalprice) AS total,
  avg(DISTINCT o_totalprice) AS mean, count(DISTINCT o_orderpriority) AS prios,
  sum(DISTINCT o_shippriority) AS ship, count(*) AS n
FROM orders
""",
    "distinct_sort_group": """
SELECT CAST(o_custkey % 7 AS DOUBLE) AS g, count(DISTINCT o_orderpriority) AS prios,
  sum(DISTINCT o_custkey) AS custs
FROM orders GROUP BY g ORDER BY g
""",
    # customers whose key is a multiple of 3 have no order: count 0, sum
    # and avg NULL
    "distinct_nulls": """
SELECT c_custkey, count(DISTINCT o_orderpriority) AS prios,
  sum(DISTINCT o_totalprice) AS total, avg(DISTINCT o_totalprice) AS mean,
  count(o_orderkey) AS n
FROM customer LEFT JOIN orders ON c_custkey = o_custkey
WHERE c_custkey < 30 GROUP BY c_custkey ORDER BY c_custkey
""",
    "distinct_no_live_value": """
SELECT count(DISTINCT o_orderpriority) AS prios, sum(DISTINCT o_totalprice) AS total,
  avg(DISTINCT o_totalprice) AS mean
FROM customer LEFT JOIN orders ON c_custkey = o_custkey AND o_totalprice > 1000000
""",
    # the same argument with and without DISTINCT stays two aggregates
    "distinct_beside_plain": """
SELECT o_orderstatus, count(o_custkey) AS c, count(DISTINCT o_custkey) AS dc
FROM orders GROUP BY o_orderstatus ORDER BY o_orderstatus
""",
}
VARIANTS = dict(QUERIES)
VARIANTS["q16_remark"] = QUERIES["q16"].replace("%Customer%Complaints%",
                                                "%" + "%".join(Q16_REMARK) + "%")
VARIANTS.update(DISTINCT)
PARAMS = {"q16_remark": ("q16", {"remark": Q16_REMARK})}

# (query, the route counts it must show on a fresh connection; every
# eager_* route must be listed)
ROUTES = {
    "q02": {"probe_dense": 1, "dense": 1},
    "q09": {"probe_dense": 4, "dense": 1},
    "q13": {"eager_left": 1, "dense": 1, "sort_group": 1},
    "q14": {"probe_dense": 1, "dense": 1},
    "q16": {"eager_anti": 1, "dense": 1},
    "q20": {"eager_semi": 2, "dense": 1},
    "distinct_grouped": {"dense": 1},
    "distinct_sort_group": {"sort_group": 1},
    "distinct_nulls": {"eager_left": 1, "dense": 1},
}
# the grouped-sum kernel's calls (slot count of each) at SF 0.01: Q9's
# 27 nations × 8 years (the large regime) and Q14's single sums; the other
# four group over more than 256 slots (Q2's parts, Q13's customers, Q16's
# brand × type × size, Q20's part-supplier pairs) and take index_add_
KERNEL_SLOTS = {"q02": [], "q09": [216], "q13": [], "q14": [1], "q16": [], "q20": []}


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("tpch_gen_like_queries")
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


def _fresh(data_dir):
    tcon = duckdb_tpu_torch.connect(device="cpu")
    tcon.load_tpch(data_dir)
    return tcon


def assert_rows_match(got, want):
    assert len(got) == len(want)
    for g_row, w_row in zip(got, want):
        assert len(g_row) == len(w_row)
        for g, w in zip(g_row, w_row):
            assert type(g) is type(w), (g_row, w_row)
            if isinstance(w, float):
                assert g == pytest.approx(w, rel=1e-9, abs=0.0), (g_row, w_row)
            else:
                assert g == w, (g_row, w_row)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_query_matches_jax(cons, name):
    jcon, tcon = cons
    want = jcon.sql(VARIANTS[name]).rows()
    assert want, "the variant must select rows"
    assert_rows_match(tcon.sql(VARIANTS[name]).rows(), want)


@pytest.mark.parametrize("name", sorted(QUERIES) + sorted(PARAMS))
def test_query_matches_oracle(cons, data_dir, name):
    _, tcon = cons
    query, params = PARAMS.get(name, (name, {}))
    want = tpch_oracle.answer(query, data_dir, **params)
    assert want and want != [(None,)]
    assert_rows_match(tcon.sql(VARIANTS[name]).rows(), want)


def test_q16_remark_variant_excludes_suppliers(data_dir):
    """The variant's NOT IN removes rows that the specification's text keeps."""
    spec = tpch_oracle.answer("q16", data_dir)
    variant = tpch_oracle.answer("q16", data_dir, remark=Q16_REMARK)
    assert sum(r[-1] for r in variant) < sum(r[-1] for r in spec)


def test_q13_not_like_removes_orders(cons, data_dir):
    """Q13's NOT LIKE drops real orders: its answer is not q13_nolike's."""
    _, tcon = cons
    nolike = tcon.sql(tpch_oracle.FROM_QUERIES["q13_nolike"]).rows()
    assert tcon.sql(QUERIES["q13"]).rows() != nolike


def _plan_sig(n):
    """A plan tree as nested tuples: node types, scanned tables, and for
    each join its type, keys (without counter suffixes), residual's node
    type, probe and build sides; for each filter its node type and, for an
    IN list, its values."""
    t = type(n).__name__
    if t == "Scan":
        return (t, n.table)
    if t == "Join":
        def names(keys):
            return [re.sub(r"#\d+$", "", getattr(e, "key", type(e).__name__))
                    for e in keys]
        return (t, n.jtype, names(n.probe_keys), names(n.build_keys),
                type(n.extra).__name__, _plan_sig(n.probe), _plan_sig(n.build))
    if t == "Filter":
        items = sorted(str(i.value) for i in getattr(n.expr, "items", []))
        return (t, type(n.expr).__name__, items, _plan_sig(n.child))
    return (t, _plan_sig(n.child))


@pytest.mark.parametrize("name", sorted(QUERIES) + ["q16_remark"])
def test_plan_tree_matches_jax(data_dir, name):
    """Fresh connections on both sides (cached distinct counts feed join
    orders)."""
    jcon = duckdb_tpu.connect()
    jcon.load_tpch(data_dir)
    jplan, _ = JPlanner(jcon.catalog).plan_select(
        JParser(VARIANTS[name]).parse_statements()[0])
    tplan, _ = TPlanner(_fresh(data_dir).catalog).plan_select(
        TParser(VARIANTS[name]).parse_statements()[0])
    assert _plan_sig(tplan) == _plan_sig(jplan)


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_query_route(data_dir, name):
    tcon = _fresh(data_dir)
    tcon.routes.clear()
    tcon.sql(VARIANTS[name]).rows()
    routes = dict(tcon.routes)
    for key, n in ROUTES[name].items():
        assert routes.get(key) == n, routes
    assert {k for k in routes if k.startswith("eager_")} == \
        {k for k in ROUTES[name] if k.startswith("eager_")}, routes


@pytest.mark.parametrize("name", sorted(KERNEL_SLOTS))
def test_grouped_sum_kernel_calls(data_dir, monkeypatch, name):
    """Which of the six reach the grouped-sum kernel's wrapper, and at what
    slot counts: chip_smoke.py checks the kernel at those inputs."""
    slots = []
    orig = grouped_mod.grouped_sum_i64

    def recording(dense, vectors, nseg):
        slots.append(nseg)
        return orig(dense, vectors, nseg)

    monkeypatch.setattr(grouped_mod, "grouped_sum_i64", recording)
    _fresh(data_dir).sql(QUERIES[name]).rows()
    assert slots == KERNEL_SLOTS[name]


def _col(data_dir, table, name):
    return tpch_oracle._Tables(data_dir)(table, name)


def test_distinct_matches_numpy(cons, data_dir):
    """distinct_grouped against numpy: distinct suppliers, quantities,
    discounts and ship modes per return flag."""
    _, tcon = cons
    flag = _col(data_dir, "lineitem", "l_returnflag")
    cols = {c: _col(data_dir, "lineitem", c)
            for c in ("l_suppkey", "l_quantity", "l_discount", "l_shipmode")}
    want = []
    for f in np.unique(flag):
        m = flag == f
        disc = np.unique(cols["l_discount"][m])
        want.append((f.decode(), len(np.unique(cols["l_suppkey"][m])),
                     tpch_oracle._dec(int(np.unique(cols["l_quantity"][m]).sum()), 2),
                     float(disc.sum()) / (len(disc) * 100.0),
                     len(np.unique(cols["l_shipmode"][m])), int(m.sum())))
    assert_rows_match(tcon.sql(DISTINCT["distinct_grouped"]).rows(), want)


def test_distinct_group_without_values(cons):
    """A customer without orders: count DISTINCT 0, sum and avg DISTINCT
    NULL; with orders, the counts and sums of distinct values."""
    _, tcon = cons
    rows = {r[0]: r[1:] for r in tcon.sql(DISTINCT["distinct_nulls"]).rows()}
    assert rows[3] == (0, None, None, 0)
    assert all(p > 0 and total is not None and n >= p
               for k, (p, total, mean, n) in rows.items() if k % 3)
    assert tcon.sql(DISTINCT["distinct_no_live_value"]).rows() == [(0, None, None)]


@pytest.mark.parametrize("sql", [
    # list/string_agg with FILTER and ORDER BY, json_group_array, grouping
    # sets and window aggregates are ported
    "SELECT sum(o_totalprice) OVER (PARTITION BY o_custkey) FROM orders",
    "SELECT o_orderstatus, count(*) FROM orders GROUP BY ROLLUP (o_orderstatus)",
])
def test_aggregate_forms_not_yet_ported_say_so(cons, data_dir, sql):
    """ROLLUP (a UNION ALL of one aggregate per grouping set) gives the JAX
    package's rows; the window aggregate gives each customer's total on
    every one of its orders, as a GROUP BY counts it."""
    jcon, tcon = cons
    if "ROLLUP" in sql:
        def key(r):
            return tuple((v is None, v or "") for v in r)

        assert sorted(tcon.sql(sql).rows(), key=key) == sorted(jcon.sql(sql).rows(), key=key)
        return
    per = dict(tcon.sql("SELECT o_custkey, sum(o_totalprice) FROM orders GROUP BY 1").rows())
    got = _fresh(data_dir).sql(sql.replace("SELECT ", "SELECT o_custkey, ")).rows()
    assert len(got) == tcon.sql("SELECT count(*) FROM orders").rows()[0][0]
    assert all(s == per[c] for c, s in got)


def _varchar_table(name, cols, rows, dictionary):
    """A table whose VARCHAR columns share one dictionary (which may hold
    values no row uses)."""
    entry = TableEntry(name, [ColumnDef(c, t) for c, t in cols])
    entry.nrows = len(rows)
    dvals = np.array(dictionary, dtype=object)
    for (col, t), values in zip(cols, zip(*rows)):
        if t is VARCHAR:
            entry.set_host_column(col, np.searchsorted(dvals, values).astype(np.int32),
                                  None, dvals)
        else:
            entry.set_host_column(col, np.array(values, dtype=np.int32))
    return entry


F1_SQL = """
WITH c AS (SELECT s FROM src WHERE f = 1)
SELECT count(*) FROM p JOIN c ON p.s = c.s
WHERE EXISTS (SELECT 1 FROM c c2 WHERE c2.s = p.s)
"""


@pytest.mark.parametrize("dictionary", [["a", "b", "c", "d"], ["a", "b", "c", "d", "e"]])
def test_materialized_cte_varchar_key_counts_its_codes(dictionary):
    """The CTE referenced twice is materialized into a hidden table that
    keeps src's whole dictionary. Its four rows hold three distinct keys
    (a twice), so the join must not trust the key as unique: p's five a
    rows each match two CTE rows, and SQL's count is 5·2 + 5 + 5 = 20
    (with the dictionary's length equal to the row count a join that
    trusted it would give 15, as the JAX package does)."""
    tcon = duckdb_tpu_torch.connect(device="cpu")
    src = [("a", 1), ("a", 1), ("b", 1), ("c", 1), ("d", 0), ("c", 0)]
    tcon.catalog.create_table(_varchar_table("src", (("s", VARCHAR), ("f", INTEGER)),
                                             src, dictionary))
    tcon.catalog.create_table(_varchar_table("p", (("s", VARCHAR),),
                                             [(v,) for v in "abcd" * 5], dictionary))
    tcon.routes.clear()
    assert tcon.sql(F1_SQL).rows() == [(20,)]
    assert tcon.routes.get("cte_materialized") == 1
    (hidden,) = [n for n in tcon.catalog.tables if n.startswith("__cte_c_")]
    entry = tcon.catalog.get_table(hidden)
    assert entry.nrows == 4 and entry.distinct_count("s") == 3
