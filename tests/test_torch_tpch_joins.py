"""TPC-H Q3, Q5, Q10 and Q12 end to end: duckdb_tpu_torch (device="cpu")
against duckdb_tpu and against a numpy oracle.

Both packages load one directory of all eight tables written by the port's
seeded generator (duckdb_tpu_torch/testing/tpch_gen.py) at SF 0.01, seed 7.
The JAX connection runs with `SET pallas_grouped_sum = 'on'`, so its int64
sums go through the Pallas kernel in interpret mode wherever its VMEM gate
admits the shape. DECIMAL, integer, date and string values must match
exactly, DOUBLE values within 1e-9 relative, in the order ORDER BY fixes.
The four queries are also held against testing/tpch_oracle.py, and their
plan trees (node types, which table probes and which builds, the join
keys) against the JAX planner's. Variants cover the JOIN … ON form, a
many-to-many join (the eager sorted join with pair expansion), and a
composite build key whose domain forces the sorted probe-step mode, and
a float group key, which only the sort-group mode can take.
"""

import re

import pytest
import torch

import duckdb_tpu
import duckdb_tpu_torch
from duckdb_tpu.planner.planner import Planner as JPlanner
from duckdb_tpu.sql.parser import Parser as JParser
from duckdb_tpu_torch.execution import executor as TE
from duckdb_tpu_torch.planner.planner import Planner as TPlanner
from duckdb_tpu_torch.sql.parser import Parser as TParser
from duckdb_tpu_torch.testing import tpch_oracle
from duckdb_tpu_torch.testing.tpch_gen import write_tables

torch.set_num_threads(1)

QUERIES = tpch_oracle.QUERIES
VARIANTS = dict(QUERIES)
VARIANTS.update({
    # Q3 with explicit joins: the same atoms and predicates
    "q03_join_on": """
SELECT l_orderkey, sum(l_extendedprice * (1 - l_discount)) AS revenue,
  o_orderdate, o_shippriority
FROM customer JOIN orders ON c_custkey = o_custkey
  JOIN lineitem ON l_orderkey = o_orderkey
WHERE c_mktsegment = 'BUILDING' AND o_orderdate < CAST('1995-03-15' AS date)
  AND l_shipdate > CAST('1995-03-15' AS date)
GROUP BY l_orderkey, o_orderdate, o_shippriority
ORDER BY revenue DESC, o_orderdate
LIMIT 10
""",
    # many-to-many: every customer meets every supplier of its nation
    "many_to_many": """
SELECT c_mktsegment, count(*) AS pairs, sum(s_acctbal) AS supplier_bal
FROM customer, supplier
WHERE c_nationkey = s_nationkey
GROUP BY c_mktsegment
ORDER BY c_mktsegment
""",
    # two aliases of one table; the composite build key (orderkey, custkey,
    # orderdate) spans far more than the dense LUT holds
    "self_join_sorted_step": """
SELECT o1.o_orderpriority, count(*) AS n, sum(o2.o_totalprice) AS total,
  min(o2.o_orderdate) AS first_date
FROM orders o1, orders o2
WHERE o1.o_orderkey = o2.o_orderkey AND o1.o_custkey = o2.o_custkey
  AND o1.o_orderdate = o2.o_orderdate
  AND o1.o_orderdate < CAST('1995-01-01' AS date)
GROUP BY o1.o_orderpriority
ORDER BY o1.o_orderpriority
""",
    # sort-group with an unbounded (float) key, min/max over segments
    "float_key_sort_group": """
SELECT CAST(l_tax AS DOUBLE) / 7 AS t, min(l_shipdate) AS first_ship,
  max(l_extendedprice) AS top_price, avg(l_quantity) AS avg_qty, count(*) AS n
FROM lineitem
WHERE l_discount > 0.04
GROUP BY t
ORDER BY t DESC
""",
})


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("tpch_gen_all")
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
            if isinstance(w, float):
                assert g == pytest.approx(w, rel=1e-9, abs=0.0), (g_row, w_row)
            else:
                assert g == w, (g_row, w_row)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_query_matches_jax(cons, name):
    jcon, tcon = cons
    want = jcon.sql(VARIANTS[name]).rows()
    got = tcon.sql(VARIANTS[name]).rows()
    assert want, "the variant must select rows"
    assert_rows_match(got, want)


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_query_matches_oracle(cons, data_dir, name):
    _, tcon = cons
    want = tpch_oracle.answer(name, data_dir)
    assert want
    assert_rows_match(tcon.sql(QUERIES[name]).rows(), want)


def _plan_sig(n):
    """A plan tree as nested tuples: node types, scanned tables, join keys
    (binding keys without their counter suffix), probe and build sides."""
    t = type(n).__name__
    if t == "Scan":
        return (t, n.table)
    if t == "Join":
        def names(keys):
            return [re.sub(r"#\d+$", "", e.key) for e in keys]
        return (t, n.jtype, names(n.probe_keys), names(n.build_keys),
                _plan_sig(n.probe), _plan_sig(n.build))
    if t == "Filter":
        return (t, type(n.expr).__name__, _plan_sig(n.child))
    return (t, _plan_sig(n.child))


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_plan_tree_matches_jax(data_dir, name):
    """Fresh connections on both sides: distinct counts that execution
    caches in the catalog feed later join orders."""
    jcon = duckdb_tpu.connect()
    jcon.load_tpch(data_dir)
    tcon = duckdb_tpu_torch.connect(device="cpu")
    tcon.load_tpch(data_dir)
    jplan, jout = JPlanner(jcon.catalog).plan_select(
        JParser(VARIANTS[name]).parse_statements()[0])
    tplan, tout = TPlanner(tcon.catalog).plan_select(
        TParser(VARIANTS[name]).parse_statements()[0])
    assert _plan_sig(tplan) == _plan_sig(jplan)
    assert [(n, k) for n, k, _ in tout] == [(n, k) for n, k, _ in jout]


def _route(tcon, sql, monkeypatch):
    """Run sql once; → (the connection's routes, executor join calls)."""
    calls = {}
    for meth in ("_dense_join", "_sorted_join", "_expand_tail"):
        orig = getattr(TE.Executor, meth)

        def counted(self, *a, _orig=orig, _m=meth, **k):
            calls[_m] = calls.get(_m, 0) + 1
            return _orig(self, *a, **k)

        monkeypatch.setattr(TE.Executor, meth, counted)
    tcon.routes.clear()
    tcon.sql(sql).rows()
    return dict(tcon.routes), calls


@pytest.mark.parametrize("name,mode", [("q03", "sort_group"), ("q05", "dense"),
                                       ("q10", "sort_group"), ("q12", "dense"),
                                       ("float_key_sort_group", "sort_group")])
def test_query_route(data_dir, monkeypatch, name, mode):
    tcon = duckdb_tpu_torch.connect(device="cpu")
    tcon.load_tpch(data_dir)
    routes, _ = _route(tcon, VARIANTS[name], monkeypatch)
    assert routes.get(mode) == 1, routes


def test_many_to_many_takes_sorted_join(data_dir, monkeypatch):
    tcon = duckdb_tpu_torch.connect(device="cpu")
    tcon.load_tpch(data_dir)
    routes, calls = _route(tcon, VARIANTS["many_to_many"], monkeypatch)
    assert calls.get("_sorted_join") == 1 and calls.get("_expand_tail") == 1, calls
    assert routes.get("dense") == 1, routes


def test_wide_composite_key_takes_sorted_probe_step(data_dir, monkeypatch):
    tcon = duckdb_tpu_torch.connect(device="cpu")
    tcon.load_tpch(data_dir)
    routes, calls = _route(tcon, VARIANTS["self_join_sorted_step"], monkeypatch)
    assert routes.get("probe_sorted") == 1 and not routes.get("probe_dense"), routes
    assert not calls, calls  # fused: no eager join


def test_warm_run_reuses_prepared_builds(data_dir, monkeypatch):
    """The second run of Q5 finds its probe steps in the build-prep cache
    and executes no build side."""
    tcon = duckdb_tpu_torch.connect(device="cpu")
    tcon.load_tpch(data_dir)
    first = tcon.sql(QUERIES["q05"]).rows()
    executed = []
    orig = TE.Executor.execute

    def execute(self, node):
        executed.append(type(node).__name__)
        return orig(self, node)

    monkeypatch.setattr(TE.Executor, "execute", execute)
    assert tcon.sql(QUERIES["q05"]).rows() == first
    assert executed.count("Join") <= 1, executed


@pytest.mark.parametrize("sql", [
    "SELECT count(*) FROM orders JOIN lineitem USING (l_orderkey)",
    "SELECT count(*) FROM nation NATURAL JOIN region",
    # an outer join without an equi-join condition (IEJoin, keyless cross)
    "SELECT count(*) FROM orders LEFT JOIN customer ON o_custkey < c_custkey",
    "SELECT count(*) FROM nation, region",  # no equi-join condition
    "SELECT count(*) FROM nation, region WHERE n_regionkey < r_regionkey",
    # a derived table that reads a column of the query around it (LATERAL)
    "SELECT count(*) FROM nation, (SELECT r_name FROM region WHERE r_regionkey = n_regionkey) r",
])
def test_joins_not_yet_ported_say_so(cons, sql):
    """A correlated derived table (LATERAL) still says "not yet ported".
    The USING, NATURAL and keyless forms are ported: each gives the JAX
    package's answer (USING over a column the left side lacks is a
    BindError in both)."""
    jcon, tcon = cons
    if "r_regionkey = n_regionkey) r" in sql:
        with pytest.raises(ValueError, match="not yet ported"):
            tcon.sql(sql)
    elif "USING (l_orderkey)" in sql:
        for con in (jcon, tcon):
            with pytest.raises(ValueError, match="Binder Error"):
                con.sql(sql)
    else:
        assert tcon.sql(sql).rows() == jcon.sql(sql).rows()
