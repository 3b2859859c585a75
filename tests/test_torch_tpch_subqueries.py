"""Subqueries as semi/anti joins and flattened scalar aggregates: TPC-H
Q4, Q11, Q17, Q18 and Q21 end to end through duckdb_tpu_torch
(device="cpu"), against duckdb_tpu and against the numpy oracle.

Both packages load one directory of all eight tables written by the port's
seeded generator (duckdb_tpu_torch/testing/tpch_gen.py) at SF 0.01, seed 7.
The JAX connection runs with `SET pallas_grouped_sum = 'on'`, as in
tests/test_torch_tpch_joins.py. DECIMAL, integer, date and string values
must match exactly, DOUBLE values within 1e-9 relative, in the order ORDER
BY fixes. At this scale Q11's GERMANY has no supplier and no order passes
Q18's `> 300`, so both also run with parameters that select rows (JAPAN,
250), which the oracle takes too. The variants cover NOT EXISTS without a
residual, EXISTS with a local filter, uncorrelated EXISTS and NOT EXISTS,
IN and NOT IN over a plain column, a many-to-many semi build that takes
the eager sorted join, residuals evaluated over expanded pairs, IN with a
`<>` correlation, and an uncorrelated scalar subquery in WHERE. NOT IN and NOT EXISTS over tables
that hold NULLs on either side are checked against the JAX package and
against SQL's answers written out by hand. Q18 and Q21 also run at SF 0.1
against the oracle, on the port alone.
"""

import os
import re

import numpy as np
import pytest
import torch

import duckdb_tpu
import duckdb_tpu_torch
from duckdb_tpu.planner.planner import Planner as JPlanner
from duckdb_tpu.sql.parser import Parser as JParser
from duckdb_tpu_torch.catalog.catalog import ColumnDef, TableEntry
from duckdb_tpu_torch.execution import executor as TE
from duckdb_tpu_torch.planner import bound as TB
from duckdb_tpu_torch.planner import plan as TP
from duckdb_tpu_torch.planner.planner import Planner as TPlanner
from duckdb_tpu_torch.sql.parser import Parser as TParser
from duckdb_tpu_torch.testing import tpch_oracle
from duckdb_tpu_torch.testing.tpch_gen import write_tables
from duckdb_tpu_torch.types import INTEGER

torch.set_num_threads(1)

QUERIES = tpch_oracle.SUBQUERY_QUERIES
# the specification's texts with parameters that select rows at SF 0.01
PARAMS = {"q11_japan": ("q11", {"nation": "JAPAN"}),
          "q18_250": ("q18", {"threshold": 250})}
VARIANTS = dict(QUERIES)
VARIANTS["q11_japan"] = QUERIES["q11"].replace("GERMANY", "JAPAN")
VARIANTS["q18_250"] = QUERIES["q18"].replace("> 300", "> 250")
VARIANTS.update({
    # fused anti step over a build with duplicate keys, no residual
    "not_exists_no_residual": """
SELECT o_orderpriority, count(*) AS n, sum(o_totalprice) AS total
FROM orders
WHERE NOT EXISTS (SELECT * FROM lineitem
                  WHERE l_orderkey = o_orderkey AND l_commitdate < l_receiptdate)
GROUP BY o_orderpriority
ORDER BY o_orderpriority
""",
    # EXISTS whose subquery filters its own table: a fused semi step
    "exists_local_filter": """
SELECT c_mktsegment, count(*) AS n, min(c_acctbal) AS low
FROM customer
WHERE EXISTS (SELECT * FROM orders
              WHERE o_custkey = c_custkey AND o_orderdate >= CAST('1997-01-01' AS date)
                AND o_totalprice > 200000)
GROUP BY c_mktsegment
ORDER BY c_mktsegment
""",
    # uncorrelated EXISTS: a semi join on a constant key
    "uncorrelated_exists": """
SELECT n_regionkey, count(*) AS n
FROM nation
WHERE EXISTS (SELECT * FROM region WHERE r_name = 'ASIA')
GROUP BY n_regionkey
ORDER BY n_regionkey
""",
    # uncorrelated NOT EXISTS over an empty subquery keeps every row
    "uncorrelated_not_exists_empty": """
SELECT n_regionkey, count(*) AS n
FROM nation
WHERE NOT EXISTS (SELECT * FROM region WHERE r_name = 'ATLANTIS')
GROUP BY n_regionkey
ORDER BY n_regionkey
""",
    # IN over a plain column with a unique build: a fused semi step
    "in_plain_column": """
SELECT o_orderstatus, count(*) AS n, sum(o_totalprice) AS total
FROM orders
WHERE o_custkey IN (SELECT c_custkey FROM customer WHERE c_mktsegment = 'BUILDING')
GROUP BY o_orderstatus
ORDER BY o_orderstatus
""",
    # NOT IN: null-aware, so it runs as the eager anti join
    "not_in_plain_column": """
SELECT o_orderstatus, count(*) AS n
FROM orders
WHERE o_custkey NOT IN (SELECT c_custkey FROM customer WHERE c_nationkey < 20)
GROUP BY o_orderstatus
ORDER BY o_orderstatus
""",
    # no aggregate above, and the build's keys repeat: the eager semi join
    # finds duplicates in its dense table and takes the sorted path
    "semi_many_to_many_eager": """
SELECT c_custkey, c_name, c_nationkey
FROM customer
WHERE c_nationkey IN (SELECT s_nationkey FROM supplier WHERE s_acctbal > 8000)
ORDER BY c_custkey
LIMIT 25
""",
    # a `>` residual over a build with duplicate keys cannot fuse: the
    # eager join expands the pairs and evaluates the residual over them
    "exists_residual_expanded": """
SELECT o_orderpriority, count(*) AS n
FROM orders
WHERE EXISTS (SELECT * FROM lineitem
              WHERE l_orderkey = o_orderkey AND l_extendedprice * 4 > o_totalprice)
GROUP BY o_orderpriority
ORDER BY o_orderpriority
""",
    "not_exists_residual_expanded": """
SELECT o_orderpriority, count(*) AS n
FROM orders
WHERE NOT EXISTS (SELECT * FROM lineitem
                  WHERE l_orderkey = o_orderkey AND l_extendedprice * 4 > o_totalprice)
GROUP BY o_orderpriority
ORDER BY o_orderpriority
""",
    # IN with a `<>` correlation over a build with duplicate keys: the
    # eager semi join answers from two count probes (_try_semi_neq)
    "in_neq_residual": """
SELECT l_returnflag, count(*) AS n
FROM lineitem l1
WHERE l1.l_orderkey IN (SELECT l2.l_orderkey FROM lineitem l2
                        WHERE l2.l_suppkey <> l1.l_suppkey)
GROUP BY l_returnflag
ORDER BY l_returnflag
""",
    # a correlated scalar aggregate inside arithmetic on both sides
    "correlated_scalar_arith": """
SELECT c_mktsegment, count(*) AS n
FROM customer
WHERE c_acctbal * 2 > (SELECT avg(o_totalprice) / 100 FROM orders
                       WHERE o_custkey = c_custkey) * 3
GROUP BY c_mktsegment
ORDER BY c_mktsegment
""",
    # uncorrelated scalar subquery in WHERE: a constant computed once
    "scalar_in_where": """
SELECT l_returnflag, count(*) AS n
FROM lineitem
WHERE l_quantity > (SELECT avg(l_quantity) FROM lineitem WHERE l_discount > 0.05)
GROUP BY l_returnflag
ORDER BY l_returnflag
""",
})

# (query, the route counts it must show on a fresh connection)
ROUTES = {
    "q04": {"fused_semi": 1, "dense": 1},
    "q11_japan": {"dense": 2},  # the outer aggregate and the scalar subquery's
    "q17": {"dense": 2},  # the correlated avg atom and the outer sum
    "q18_250": {"fused_semi": 1, "sort_group": 1},
    "q21": {"fused_semi": 1, "fused_anti": 1},
    "not_exists_no_residual": {"fused_anti": 1},
    "exists_local_filter": {"fused_semi": 1},
    "in_plain_column": {"fused_semi": 1},
    "not_in_plain_column": {"eager_anti": 1},
    "semi_many_to_many_eager": {"eager_semi": 1},
    "exists_residual_expanded": {"eager_semi": 1},
    "not_exists_residual_expanded": {"eager_anti": 1},
    "in_neq_residual": {"eager_semi": 1},
}


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("tpch_gen_subq")
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


@pytest.fixture(scope="module")
def sf01_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("tpch_gen_subq_sf01")
    write_tables(str(root), 0.1, seed=7)
    return str(root)


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


def _plan_sig(n):
    """A plan tree as nested tuples: node types, scanned tables, and for
    each join its type, keys (binding keys without their counter suffix),
    residual's node type, NOT IN flag, probe and build sides."""
    t = type(n).__name__
    if t == "Scan":
        return (t, n.table)
    if t == "Join":
        def names(keys):
            return [re.sub(r"#\d+$", "", getattr(e, "key", type(e).__name__))
                    for e in keys]
        return (t, n.jtype, names(n.probe_keys), names(n.build_keys),
                type(n.extra).__name__, n.null_aware, _plan_sig(n.probe),
                _plan_sig(n.build))
    if t == "Filter":
        return (t, type(n.expr).__name__, _plan_sig(n.child))
    return (t, _plan_sig(n.child))


def _fresh(data_dir):
    tcon = duckdb_tpu_torch.connect(device="cpu")
    tcon.load_tpch(data_dir)
    return tcon


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_query_matches_jax(cons, name):
    jcon, tcon = cons
    want = jcon.sql(VARIANTS[name]).rows()
    got = tcon.sql(VARIANTS[name]).rows()
    if name not in ("q11", "q18"):  # the specification's values select nothing here
        assert want, "the variant must select rows"
    assert_rows_match(got, want)


@pytest.mark.parametrize("name", sorted(QUERIES) + sorted(PARAMS))
def test_query_matches_oracle(cons, data_dir, name):
    _, tcon = cons
    query, params = PARAMS.get(name, (name, {}))
    want = tpch_oracle.answer(query, data_dir, **params)
    assert_rows_match(tcon.sql(VARIANTS[name]).rows(), want)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_plan_tree_matches_jax(data_dir, name):
    """Fresh connections on both sides (cached distinct counts feed join
    orders). The signature holds each semi/anti join's type and keys."""
    jcon = duckdb_tpu.connect()
    jcon.load_tpch(data_dir)
    tcon = _fresh(data_dir)
    jplan, jout = JPlanner(jcon.catalog).plan_select(
        JParser(VARIANTS[name]).parse_statements()[0])
    tplan, tout = TPlanner(tcon.catalog).plan_select(
        TParser(VARIANTS[name]).parse_statements()[0])
    assert _plan_sig(tplan) == _plan_sig(jplan)
    assert [(n, k) for n, k, _ in tout] == [(n, k) for n, k, _ in jout]


def _join_nodes(plan):
    out, stack = [], [plan]
    while stack:
        n = stack.pop()
        if isinstance(n, TP.Join):
            out.append(n)
        stack += [getattr(n, a) for a in ("child", "probe", "build") if hasattr(n, a)]
    return out


def test_plans_carry_residuals_and_null_awareness(data_dir):
    """Q21's EXISTS/NOT EXISTS become semi/anti joins against GROUP BY
    l_orderkey: min/max(l_suppkey) with an OR residual; NOT IN is null-aware."""
    tcon = _fresh(data_dir)
    planner = TPlanner(tcon.catalog)
    q21, _ = planner.plan_select(TParser(QUERIES["q21"]).parse_statements()[0])
    semis = [j for j in _join_nodes(q21) if j.jtype != "inner"]
    assert sorted(j.jtype for j in semis) == ["anti", "semi"]
    for j in semis:
        assert isinstance(j.build, TP.Aggregate)
        assert [a.func for a in j.build.aggs] == ["min", "max"]
        assert isinstance(j.extra, TB.BoundConjunction) and j.extra.op == "or"
        assert not j.null_aware
    not_in, _ = planner.plan_select(
        TParser(VARIANTS["not_in_plain_column"]).parse_statements()[0])
    (anti,) = [j for j in _join_nodes(not_in) if j.jtype != "inner"]
    assert anti.jtype == "anti" and anti.null_aware


def _routes(tcon, sql, monkeypatch):
    calls = {}
    for meth in ("_dense_join", "_sorted_join", "_expand_tail", "_try_semi_neq"):
        orig = getattr(TE.Executor, meth)

        def counted(self, *a, _orig=orig, _m=meth, **k):
            calls[_m] = calls.get(_m, 0) + 1
            return _orig(self, *a, **k)

        monkeypatch.setattr(TE.Executor, meth, counted)
    tcon.routes.clear()
    tcon.sql(sql).rows()
    return dict(tcon.routes), calls


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_query_route(data_dir, monkeypatch, name):
    routes, calls = _routes(_fresh(data_dir), VARIANTS[name], monkeypatch)
    for key, n in ROUTES[name].items():
        assert routes.get(key) == n, routes
    fused = any(k.startswith("fused_") for k in ROUTES[name])
    eager = any(k.startswith("eager_") for k in ROUTES[name])
    assert bool(fused) == any(k.startswith("fused_") for k in routes), routes
    assert bool(eager) == any(k.startswith("eager_") for k in routes), routes
    if name in ("semi_many_to_many_eager", "exists_residual_expanded",
                "not_exists_residual_expanded"):
        assert calls.get("_sorted_join") == 1 and calls.get("_expand_tail") == 1, calls
    if name == "in_neq_residual":
        assert calls.get("_try_semi_neq") == 1 and not calls.get("_sorted_join"), calls


def test_warm_q11_reuses_the_scalar_subquery(data_dir, monkeypatch):
    """The plan cache keeps the scalar subquery's value on its bound node:
    a warm Q11 runs one aggregate, not two."""
    tcon = _fresh(data_dir)
    first = tcon.sql(VARIANTS["q11_japan"]).rows()
    tcon.routes.clear()
    assert tcon.sql(VARIANTS["q11_japan"]).rows() == first
    assert tcon.routes.get("dense") == 1, dict(tcon.routes)


@pytest.mark.parametrize("name", ["q18", "q21"])
def test_sf01_matches_oracle(sf01_dir, name):
    """Q18 with the specification's 300 and Q21 at SF 0.1, port alone."""
    want = tpch_oracle.answer(name, sf01_dir)
    assert want
    assert_rows_match(_fresh(sf01_dir).sql(QUERIES[name]).rows(), want)


# -- NULL semantics over tables made in the catalog ---------------------------
PROBE = [1, 2, None, 4, 5, 7]
BUILD_NO_NULL = [2, 4, 4, 9]
BUILD_NULL = [2, None, 4]

NULL_CASES = {
    # query → the rows SQL gives
    "SELECT x FROM tp WHERE x NOT IN (SELECT y FROM tb) ORDER BY x": [(1,), (5,), (7,)],
    "SELECT x FROM tp WHERE x NOT IN (SELECT y FROM tbn) ORDER BY x": [],
    "SELECT x FROM tp WHERE x IN (SELECT y FROM tbn) ORDER BY x": [(2,), (4,)],
    "SELECT x FROM tp WHERE NOT EXISTS (SELECT * FROM tbn WHERE y = x) ORDER BY x":
        [(1,), (5,), (7,), (None,)],
    "SELECT x FROM tp WHERE EXISTS (SELECT * FROM tb WHERE y = x) ORDER BY x": [(2,), (4,)],
    # fused anti step: the NULL and the out-of-range probe keys survive
    "SELECT count(*) AS n, sum(x) AS s FROM tp WHERE NOT EXISTS "
    "(SELECT * FROM tb WHERE y = x)": [(4, 13)],
    "SELECT count(*) AS n, sum(x) AS s FROM tp WHERE x NOT IN (SELECT y FROM tb)": [(3, 13)],
}
# The JAX package reads NOT IN's NULLs over the whole build, so these are
# held to SQL only. NOT IN over an empty subquery is TRUE for every row, a
# NULL one too. Correlated, each probe row sees only its group: the build
# rows of its g (none for a NULL g). Over an empty group it is TRUE; over
# a group holding a NULL, never; a NULL g in the build matches no row.
SQL_ONLY_CASES = {
    "SELECT x FROM tp WHERE x NOT IN (SELECT y FROM tbn WHERE y > 100) ORDER BY x":
        [(1,), (2,), (4,), (5,), (7,), (None,)],
    "SELECT id, g, x FROM tpc WHERE x NOT IN "
    "(SELECT y FROM tbc WHERE tbc.g = tpc.g) ORDER BY id":
        [(1, 1, 1), (6, 3, 5), (7, None, 6), (9, 5, None)],
    "SELECT count(*) AS n FROM tpc WHERE x NOT IN "
    "(SELECT y FROM tbc WHERE tbc.g = tpc.g AND y < 9)": [(5,)],
}
# tpc: (id, g, x); tbc: (g, y)
PROBE_CORR = [(1, 1, 1), (2, 1, 2), (3, 1, None), (4, 2, 3), (5, 2, None),
              (6, 3, 5), (7, None, 6), (8, 4, 7), (9, 5, None), (10, 2, 8)]
BUILD_CORR = [(1, 2), (1, 4), (2, None), (2, 8), (3, 9), (None, 5), (4, 7)]


def _int_table(name, cols, rows):
    """An INTEGER table `name` with columns `cols` holding `rows` (tuples,
    None for NULL)."""
    entry = TableEntry(name, [ColumnDef(col, INTEGER) for col in cols])
    entry.nrows = len(rows)
    for col, values in zip(cols, zip(*rows)):
        valid = np.array([v is not None for v in values])
        entry.set_host_column(col, np.array([v or 0 for v in values], dtype=np.int32),
                              None if valid.all() else valid)
    return entry


@pytest.fixture(scope="module")
def null_cons():
    jcon = duckdb_tpu.connect()
    tcon = duckdb_tpu_torch.connect(device="cpu")
    for name, col, values in (("tp", "x", PROBE), ("tb", "y", BUILD_NO_NULL),
                              ("tbn", "y", BUILD_NULL)):
        jcon.sql(f"CREATE TABLE {name} ({col} INTEGER)")
        jcon.sql(f"INSERT INTO {name} VALUES "
                 + ", ".join("(NULL)" if v is None else f"({v})" for v in values))
        tcon.catalog.create_table(_int_table(name, [col], [(v,) for v in values]))
    tcon.catalog.create_table(_int_table("tpc", ["id", "g", "x"], PROBE_CORR))
    tcon.catalog.create_table(_int_table("tbc", ["g", "y"], BUILD_CORR))
    return jcon, tcon


@pytest.mark.parametrize("sql", sorted(NULL_CASES))
def test_null_semantics(null_cons, sql):
    jcon, tcon = null_cons
    got = tcon.sql(sql).rows()
    assert got == NULL_CASES[sql]
    assert got == jcon.sql(sql).rows()


@pytest.mark.parametrize("sql", sorted(SQL_ONLY_CASES))
def test_not_in_groups_follow_sql(null_cons, sql):
    _, tcon = null_cons
    tcon.routes.clear()
    assert tcon.sql(sql).rows() == SQL_ONLY_CASES[sql]
    assert tcon.routes.get("eager_anti") == 1, dict(tcon.routes)


# -- the eager `<>` residual path, on a hand-built plan --------------------------
@pytest.mark.parametrize("jtype", ["semi", "anti"])
def test_try_semi_neq_counts_other_suppliers(data_dir, jtype, monkeypatch):
    """A semi/anti join whose residual is one bare `probe.c <> build.c`
    (an IN subquery's; the planner rewrites EXISTS to min/max) answers
    from two count probes: a line of the same order from another supplier
    exists iff the order has more lines than lines of this one."""
    tcon = _fresh(data_dir)
    cat = tcon.catalog
    ent = cat.get_table("lineitem")

    def scan(alias):
        return TP.Scan("lineitem", alias, [(c, f"{alias}.{c}", ent.col_types[c])
                                           for c in ("l_orderkey", "l_suppkey")])

    ref = {k: TB.BoundColumnRef(k, ent.col_types[k.split(".")[1]])
           for k in ("l1.l_orderkey", "l1.l_suppkey", "l2.l_orderkey", "l2.l_suppkey")}
    node = TP.Join(scan("l1"), scan("l2"), jtype, [ref["l1.l_orderkey"]],
                   [ref["l2.l_orderkey"]],
                   TB.BoundComparison("<>", ref["l2.l_suppkey"], ref["l1.l_suppkey"]))
    calls = []
    orig = TE.Executor._try_semi_neq
    monkeypatch.setattr(TE.Executor, "_try_semi_neq",
                        lambda self, *a: calls.append(1) or orig(self, *a))
    ex = TE.Executor(cat)
    live = ex.execute(node).live[:ent.nrows].numpy()
    assert calls
    okey = ent.host_column("l_orderkey")[0]
    supp = ent.host_column("l_suppkey")[0]
    pair = okey * 1_000_000 + supp
    per_order = np.unique(okey, return_inverse=True, return_counts=True)
    per_pair = np.unique(pair, return_inverse=True, return_counts=True)
    others = (per_order[2][per_order[1].reshape(-1)]
              - per_pair[2][per_pair[1].reshape(-1)]) > 0
    np.testing.assert_array_equal(live, others if jtype == "semi" else ~others)


@pytest.mark.parametrize("sql", [
    # IN / EXISTS outside a WHERE conjunct need the MARK join
    "SELECT CASE WHEN o_custkey IN (SELECT c_custkey FROM customer) THEN 1 ELSE 0 END "
    "FROM orders",
    "SELECT count(*) FROM orders WHERE o_custkey IN (SELECT c_custkey FROM customer) "
    "OR o_totalprice > 100",
    "SELECT EXISTS (SELECT * FROM region) FROM nation",
    # NOT IN correlated by more than equalities: its NULL cases would need
    # the residual inside each group
    "SELECT count(*) FROM orders WHERE o_custkey NOT IN "
    "(SELECT c_custkey FROM customer WHERE c_acctbal > o_totalprice)",
    # a derived table correlated with the query around it (LATERAL), at
    # the top and inside a subquery
    "SELECT count(*) FROM orders, (SELECT c_name FROM customer WHERE c_custkey = o_custkey) c",
    "SELECT count(*) FROM orders WHERE o_orderkey IN "
    "(SELECT l_orderkey FROM (SELECT * FROM lineitem WHERE l_orderkey = o_orderkey) l)",
])
def test_subquery_forms_not_yet_ported_say_so(cons, data_dir, sql):
    """A derived table correlated with the query around it (LATERAL)
    still says "not yet ported". IN and EXISTS outside a WHERE conjunct
    (MARK joins) give the JAX package's answers; NOT IN correlated by a
    residual is held to a nested-loop answer in numpy."""
    jcon, tcon = cons
    if "LATERAL" in sql or "= o_custkey) c" in sql or "= o_orderkey) l" in sql:
        with pytest.raises(ValueError, match="not yet ported"):
            _fresh(data_dir).sql(sql)
    elif "NOT IN" in sql:
        t = tpch_oracle._Tables(data_dir)
        acct, cust = t("customer", "c_acctbal"), t("customer", "c_custkey")
        price, ocust = t("orders", "o_totalprice"), t("orders", "o_custkey")
        # no customer key is NULL: NOT IN holds unless a customer with
        # c_acctbal > o_totalprice has the order's key
        seen = (ocust[:, None] == cust[None, :]) & (acct[None, :] > price[:, None])
        assert tcon.sql(sql).rows() == [(int((~seen.any(axis=1)).sum()),)]
    else:
        assert tcon.sql(sql).rows() == jcon.sql(sql).rows()
