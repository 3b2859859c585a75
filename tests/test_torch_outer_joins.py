"""Outer, semi and anti joins, and correlated count/coalesce scalar
subqueries, through duckdb_tpu_torch (device="cpu").

Tables are made with `catalog.create_table` (and the same rows inserted
into a duckdb_tpu connection). Every join is held to SQL's answer: small
cases written out by hand, and for seeded tables with duplicate build keys
and NULL keys on both sides, a nested-loop join written in plain Python
(`sql_join`). The JAX package pushes an ON conjunct that reads only a
preserved side into that side's input, and a FULL join there drops the
build rows whose key is NULL; the cases it gets right are also compared
with it, the others only with SQL. LEFT joins over unique build keys take
the direct-address path, the others the sorted path with pair expansion;
FULL joins always the latter. The correlated `count(*)` and `coalesce`
subqueries are flattened through a LEFT join, so the outer rows that no
subquery row matches stay (the JAX package drops them: its COUNT bug).
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
from duckdb_tpu_torch.execution import executor as TE
from duckdb_tpu_torch.planner import bound as TB
from duckdb_tpu_torch.planner import plan as TP
from duckdb_tpu_torch.planner.planner import Planner as TPlanner
from duckdb_tpu_torch.sql.parser import Parser as TParser
from duckdb_tpu_torch.testing.tpch_gen import write_tables
from duckdb_tpu_torch.types import INTEGER

torch.set_num_threads(1)

# the motivating tables: a(k, x), b(k, y) with a duplicate build key, and
# bu(k, y) with unique keys and one NULL key
A = [(1, 1), (2, 10), (3, 10), (None, 10)]
B = [(1, 100), (2, 200), (2, 201), (4, 400)]
BU = [(1, 100), (2, 200), (4, 400), (None, 500)]


def _seeded():
    """p(k, x) probes; d(k, y) has duplicate keys, u(k, y) unique ones; all
    three hold NULL keys, and p's keys reach past the builds' range."""
    rng = np.random.default_rng(11)

    def nulls(values, share):
        return [None if rng.random() < share else int(v) for v in values]

    p = list(zip(nulls(rng.integers(-3, 40, 240), 0.1), nulls(rng.integers(0, 100, 240), 0.05)))
    d = list(zip(nulls(rng.integers(0, 30, 160), 0.1), rng.integers(0, 100, 160).tolist()))
    u = list(zip([int(k) for k in rng.permutation(30)] + [None, None],
                 rng.integers(0, 100, 32).tolist()))
    return {"p": p, "d": d, "u": u}


SEEDED = _seeded()
TABLES = {"a": (("k", "x"), A), "b": (("k", "y"), B), "bu": (("k", "y"), BU),
          "p": (("k", "x"), SEEDED["p"]), "d": (("k", "y"), SEEDED["d"]),
          "u": (("k", "y"), SEEDED["u"])}


def _int_table(name, cols, rows):
    entry = TableEntry(name, [ColumnDef(col, INTEGER) for col in cols])
    entry.nrows = len(rows)
    for col, values in zip(cols, zip(*rows)):
        valid = np.array([v is not None for v in values])
        entry.set_host_column(col, np.array([v or 0 for v in values], dtype=np.int32),
                              None if valid.all() else valid)
    return entry


@pytest.fixture(scope="module")
def cons():
    jcon = duckdb_tpu.connect()
    tcon = duckdb_tpu_torch.connect(device="cpu")
    for name, (cols, rows) in TABLES.items():
        jcon.sql(f"CREATE TABLE {name} ({', '.join(c + ' INTEGER' for c in cols)})")
        jcon.sql(f"INSERT INTO {name} VALUES " + ", ".join(
            "(" + ", ".join("NULL" if v is None else str(v) for v in r) + ")" for r in rows))
        tcon.catalog.create_table(_int_table(name, cols, rows))
    return jcon, tcon


def _sorted(rows):
    return sorted(rows, key=lambda r: tuple((v is None, v or 0) for v in r))


# -- the motivating cases, written out by hand --------------------------------
HAND_CASES = {
    # the reference drops (1, 1, NULL, NULL): its a.x > 5 filters a itself
    "SELECT a.k, a.x, b.k, b.y FROM a LEFT JOIN b ON a.k = b.k AND a.x > 5":
        [(1, 1, None, None), (2, 10, 2, 200), (2, 10, 2, 201), (3, 10, None, None),
         (None, 10, None, None)],
    # the reference drops (NULL, NULL, 4, 400): its b.y < 300 filters b itself
    "SELECT a.k, a.x, b.k, b.y FROM a FULL JOIN b ON a.k = b.k AND b.y < 300":
        [(1, 1, 1, 100), (2, 10, 2, 200), (2, 10, 2, 201), (3, 10, None, None),
         (None, None, 4, 400), (None, 10, None, None)],
    # a build row with a NULL key matches nothing and is kept (the reference
    # drops it)
    "SELECT a.k, a.x, bu.k, bu.y FROM a FULL JOIN bu ON a.k = bu.k":
        [(1, 1, 1, 100), (2, 10, 2, 200), (3, 10, None, None), (None, None, 4, 400),
         (None, 10, None, None), (None, None, None, 500)],
    # a probe-side conjunct of an ANTI join keeps the rows it is not TRUE for
    "SELECT a.k, a.x FROM a ANTI JOIN b ON a.k = b.k AND a.x > 5":
        [(1, 1), (3, 10), (None, 10)],
    "SELECT a.k, a.x, bu.k, bu.y FROM a LEFT JOIN bu ON a.k = bu.k AND a.x > 5":
        [(1, 1, None, None), (2, 10, 2, 200), (3, 10, None, None), (None, 10, None, None)],
}
# cases the JAX package also gets right
HAND_CASES_JAX = {
    "SELECT a.k, a.x, b.k, b.y FROM a RIGHT JOIN b ON a.k = b.k AND a.x > 5":
        [(None, None, 1, 100), (2, 10, 2, 200), (2, 10, 2, 201), (None, None, 4, 400)],
    "SELECT a.k, a.x, b.k, b.y FROM a LEFT JOIN b ON a.k = b.k AND b.y > 150":
        [(1, 1, None, None), (2, 10, 2, 200), (2, 10, 2, 201), (3, 10, None, None),
         (None, 10, None, None)],
    "SELECT a.k, a.x, bu.k, bu.y FROM a LEFT JOIN bu ON a.k = bu.k":
        [(1, 1, 1, 100), (2, 10, 2, 200), (3, 10, None, None), (None, 10, None, None)],
    "SELECT a.k FROM a SEMI JOIN b ON a.k = b.k": [(1,), (2,)],
    "SELECT a.k FROM a ANTI JOIN b ON a.k = b.k": [(3,), (None,)],
    "SELECT a.k, a.x FROM a SEMI JOIN b ON a.k = b.k AND a.x > 5": [(2, 10)],
    "SELECT count(*) AS n, count(b.k) AS nk, sum(b.y) AS s FROM a LEFT JOIN b ON a.k = b.k":
        [(5, 3, 501)],
}


@pytest.mark.parametrize("sql", sorted(HAND_CASES))
def test_outer_join_follows_sql(cons, sql):
    _, tcon = cons
    assert _sorted(tcon.sql(sql).rows()) == _sorted(HAND_CASES[sql])


@pytest.mark.parametrize("sql", sorted(HAND_CASES_JAX))
def test_outer_join_matches_sql_and_jax(cons, sql):
    jcon, tcon = cons
    got = _sorted(tcon.sql(sql).rows())
    assert got == _sorted(HAND_CASES_JAX[sql])
    assert got == _sorted(jcon.sql(sql).rows())


def test_semi_join_build_columns_leave_scope(cons):
    _, tcon = cons
    with pytest.raises(ValueError, match="not found"):
        tcon.sql("SELECT a.k, b.y FROM a SEMI JOIN b ON a.k = b.k")


# -- seeded tables against a nested-loop join ---------------------------------
def _gt(x, y):
    return x is not None and y is not None and x > y


# residual name → (SQL text, predicate over (probe row, build row), side)
RESIDUALS = {
    "none": ("", lambda l, r: True, None),
    "build": (" AND {b}.y > 50", lambda l, r: _gt(r[1], 50), "build"),
    "probe": (" AND p.x > 30", lambda l, r: _gt(l[1], 30), "probe"),
    "across": (" AND p.x < {b}.y", lambda l, r: _gt(r[1], l[1]), "across"),
}


def sql_join(jt, left, right, on):
    """SQL's answer for `left <jt> JOIN right ON <key equality> AND on`,
    by nested loops: a NULL key equals nothing."""
    width_l, width_r = len(left[0]), len(right[0])
    out, right_hit = [], [False] * len(right)
    for lrow in left:
        hit = False
        for i, rrow in enumerate(right):
            if lrow[0] is not None and lrow[0] == rrow[0] and on(lrow, rrow):
                hit = right_hit[i] = True
                if jt in ("inner", "left", "full"):
                    out.append(lrow + rrow)
        if (jt == "semi" and hit) or (jt == "anti" and not hit):
            out.append(lrow)
        if jt in ("left", "full") and not hit:
            out.append(lrow + (None,) * width_r)
    if jt == "full":
        out += [(None,) * width_l + r for r, h in zip(right, right_hit) if not h]
    return out


def _jax_is_right(jt, side):
    """Whether the JAX package gets this join right: it filters a preserved
    side (p for LEFT and ANTI, the build table for RIGHT) by that side's ON
    conjuncts, and its FULL join drops NULL-key build rows (both builds
    here hold some)."""
    if jt == "full":
        return False
    return side != {"left": "probe", "anti": "probe", "right": "build"}.get(jt)


SEEDED_CASES = [(jt, build, res) for jt in ("left", "right", "full", "semi", "anti")
                for build in ("u", "d") for res in RESIDUALS]


def _seeded_sql(jt, build, res):
    cond = RESIDUALS[res][0].format(b=build)
    cols = "p.k, p.x" if jt in ("semi", "anti") else f"p.k, p.x, {build}.k, {build}.y"
    return f"SELECT {cols} FROM p {jt.upper()} JOIN {build} ON p.k = {build}.k{cond}"


def _seeded_want(jt, build, res):
    on = RESIDUALS[res][1]
    p, b = SEEDED["p"], SEEDED[build]
    if jt == "right":
        # p RIGHT JOIN b keeps every b row: b LEFT JOIN p, columns reordered
        rows = sql_join("left", b, p, lambda r, l: on(l, r))
        return [r[2:] + r[:2] for r in rows]
    return sql_join(jt, p, b, on)


@pytest.mark.parametrize("jt,build,res", SEEDED_CASES)
def test_seeded_join_follows_sql(cons, monkeypatch, jt, build, res):
    """Every join type over unique (u) and duplicate (d) build keys, NULL
    keys on both sides, with each kind of ON residual. The route and the
    executor path are checked too."""
    jcon, tcon = cons
    sql = _seeded_sql(jt, build, res)
    calls = []
    orig = TE.Executor._sorted_join
    monkeypatch.setattr(TE.Executor, "_sorted_join",
                        lambda self, *a: calls.append(1) or orig(self, *a))
    tcon.routes.clear()
    got = _sorted(tcon.sql(sql).rows())
    want = _sorted(_seeded_want(jt, build, res))
    assert want, sql
    assert got == want, sql
    kind = "left" if jt == "right" else jt
    assert dict(tcon.routes) == {f"eager_{kind}": 1}, dict(tcon.routes)
    if kind in ("left", "full"):
        # unique builds take the direct-address path; duplicates (p, the
        # build of a RIGHT join, has them) and every full join expand pairs
        assert bool(calls) == (build == "d" or jt in ("right", "full")), calls
    if _jax_is_right(jt, RESIDUALS[res][2]):
        assert got == _sorted(jcon.sql(sql).rows()), sql


def _plan_sig(n):
    t = type(n).__name__
    if t == "Scan":
        return (t, n.table)
    if t == "Join":
        def names(keys):
            return [re.sub(r"#\d+$", "", getattr(e, "key", type(e).__name__)) for e in keys]
        return (t, n.jtype, names(n.probe_keys), names(n.build_keys),
                type(n.extra).__name__, _plan_sig(n.probe), _plan_sig(n.build))
    if t == "Filter":
        return (t, type(n.expr).__name__, _plan_sig(n.child))
    return (t, _plan_sig(n.child))


@pytest.mark.parametrize("jt,build,res", [c for c in SEEDED_CASES
                                          if _jax_is_right(c[0], RESIDUALS[c[2]][2])])
def test_seeded_plan_matches_jax(cons, jt, build, res):
    """Where the JAX package is right, the port plans the same tree: a
    RIGHT join as a LEFT join with the sides swapped, a non-preserved
    side's conjunct pushed into its pool, a cross-side one as the residual."""
    jcon, tcon = cons
    sql = _seeded_sql(jt, build, res)
    jplan, _ = JPlanner(jcon.catalog).plan_select(JParser(sql).parse_statements()[0])
    tplan, _ = TPlanner(tcon.catalog).plan_select(TParser(sql).parse_statements()[0])
    assert _plan_sig(tplan) == _plan_sig(jplan)


@pytest.mark.parametrize("jt", ["left", "full", "anti"])
def test_preserved_side_conjunct_is_residual(cons, jt):
    """An ON conjunct over a preserved side never filters that side: it
    stays in the join's residual."""
    _, tcon = cons
    sql = _seeded_sql(jt, "d", "probe")
    plan, _ = TPlanner(tcon.catalog).plan_select(TParser(sql).parse_statements()[0])
    while not isinstance(plan, TP.Join):
        plan = plan.child
    assert isinstance(plan.probe, TP.Scan) and isinstance(plan.build, TP.Scan)
    assert isinstance(plan.extra, TB.BoundComparison) and plan.extra.op == ">"


def _nested_loop_counts():
    """SQL's answers for the three join forms below, by nested loops."""
    p, d = SEEDED["p"], SEEDED["d"]
    left = sum(max(1, sum(1 for dk, _ in d if None not in (pk, dk) and pk < dk))
               for pk, _ in p)
    pairs = [(i, j) for i, (pk, _) in enumerate(p) for j, (dk, _) in enumerate(d)
             if pk is not None and pk == dk]
    full = (len(pairs) + len(p) - len({i for i, _ in pairs})
            + len(d) - len({j for _, j in pairs}))
    asof = sum(1 for pk, px in p if px is not None and any(
        pk is not None and dk == pk and dy <= px for dk, dy in d))
    return {"left": left, "full": full, "asof": asof}


@pytest.mark.parametrize("sql", [
    "SELECT count(*) FROM p LEFT JOIN d ON p.k < d.k",  # no equi key
    "SELECT count(*) FROM p FULL JOIN d USING (k)",
    "SELECT count(*) FROM p ASOF JOIN d ON p.k = d.k AND p.x >= d.y",
    "SELECT k, row_number() OVER (ORDER BY x) FROM p",  # a window (item 29)
])
def test_outer_join_forms_not_yet_ported_say_so(cons, sql):
    """The keyless LEFT join, FULL JOIN … USING and the ASOF join are
    ported and give SQL's counts (nested loops over the seeded tables);
    so is the window function, which numbers the rows in x order."""
    _, tcon = cons
    if "OVER" in sql:
        got = tcon.sql("SELECT x, row_number() OVER (ORDER BY x) FROM p").rows()
        assert sorted(r[1] for r in got) == list(range(1, len(got) + 1))
        # x ascending, NULLs last, along the numbering
        xs = [x for x, _ in sorted(got, key=lambda r: r[1])]
        assert xs == sorted(xs, key=lambda x: (x is None, x or 0))
        return
    want = _nested_loop_counts()[sql.split()[4].lower()]
    assert tcon.sql(sql).rows() == [(want,)]


# -- inner joins with a residual, on a hand-built plan ------------------------
@pytest.mark.parametrize("probe,build", [("p", "u"), ("p", "d")])
def test_inner_join_residual(cons, monkeypatch, probe, build):
    """The planner folds an inner join's non-equi conjuncts into filters; a
    Join node that carries one runs through the direct-address (unique
    build) or the sorted tail, counted as eager_inner_residual."""
    _, tcon = cons
    cat = tcon.catalog

    def scan(name, cols):
        return TP.Scan(name, name, [(c, f"{name}.{c}", INTEGER) for c in cols])

    def ref(key):
        return TB.BoundColumnRef(key, INTEGER)

    node = TP.Join(scan(probe, ("k", "x")), scan(build, ("k", "y")), "inner",
                   [ref(f"{probe}.k")], [ref(f"{build}.k")],
                   TB.BoundComparison("<", ref(f"{probe}.x"), ref(f"{build}.y")))
    calls = []
    orig = TE.Executor._sorted_join
    monkeypatch.setattr(TE.Executor, "_sorted_join",
                        lambda self, *a: calls.append(1) or orig(self, *a))
    ex = TE.Executor(cat)
    out = [("a", f"{probe}.k", INTEGER), ("b", f"{probe}.x", INTEGER),
           ("c", f"{build}.k", INTEGER), ("d", f"{build}.y", INTEGER)]
    got = _sorted(ex.run(node, out).rows())
    want = _sorted(sql_join("inner", SEEDED[probe], SEEDED[build], RESIDUALS["across"][1]))
    assert got == want and want
    assert ex.routes == {"eager_inner_residual": 1}
    assert bool(calls) == (build == "d")


# -- correlated count / coalesce scalar subqueries ----------------------------
COUNT_CASES = {
    "SELECT a.k FROM a WHERE 0 = (SELECT count(*) FROM b WHERE b.k = a.k)":
        [(3,), (None,)],
    "SELECT a.k FROM a WHERE 0 = (SELECT coalesce(sum(b.y), 0) FROM b WHERE b.k = a.k)":
        [(3,), (None,)],
    "SELECT a.k FROM a WHERE 0 = coalesce((SELECT sum(b.y) FROM b WHERE b.k = a.k), 0)":
        [(3,), (None,)],
    "SELECT a.k FROM a WHERE 1 < (SELECT count(*) FROM b WHERE b.k = a.k)": [(2,)],
    # a.x > 5 * (lines of b): 1 > 5, 10 > 10 are false; 10 > 0 holds twice
    "SELECT a.k, a.x FROM a WHERE a.x > (SELECT count(b.y) * 5 FROM b WHERE b.k = a.k)":
        [(3, 10), (None, 10)],
    # sum is NULL over no rows, so the comparison is too: the inner join
    "SELECT a.k FROM a WHERE 300 < (SELECT sum(b.y) FROM b WHERE b.k = a.k)": [(2,), ],
}


@pytest.mark.parametrize("sql", sorted(COUNT_CASES))
def test_correlated_count_keeps_rows_without_match(cons, sql):
    _, tcon = cons
    tcon.routes.clear()
    assert _sorted(tcon.sql(sql).rows()) == _sorted(COUNT_CASES[sql])
    left = "count" in sql or "coalesce" in sql
    assert tcon.routes.get("eager_left", 0) == (1 if left else 0), dict(tcon.routes)


def test_count_subquery_plan_stacks_a_left_join(cons):
    _, tcon = cons
    sql = "SELECT a.k FROM a WHERE 0 = (SELECT count(*) FROM b WHERE b.k = a.k)"
    plan, _ = TPlanner(tcon.catalog).plan_select(TParser(sql).parse_statements()[0])
    while not isinstance(plan, TP.Filter):
        plan = plan.child
    join = plan.child
    assert isinstance(join, TP.Join) and join.jtype == "left"
    assert isinstance(join.build, TP.Project) and isinstance(join.build.child, TP.Aggregate)
    # the value is the count where a group matched, else count over no rows
    case = plan.expr.right
    assert isinstance(case, TB.BoundCase) and isinstance(case.whens[0][0], TB.BoundIsNull)
    assert case.whens[0][1].value == 0


@pytest.fixture(scope="module")
def tpch(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tpch_gen_outer"))
    write_tables(root, 0.01, seed=7)
    tcon = duckdb_tpu_torch.connect(device="cpu")
    tcon.load_tpch(root)
    return tcon, tcon.catalog


def _no_order_customers(catalog):
    ckey = catalog.get_table("customer").host_column("c_custkey")[0]
    okey = catalog.get_table("orders").host_column("o_custkey")[0]
    return int((~np.isin(ckey, okey)).sum())


@pytest.mark.parametrize("sql", [
    "SELECT count(*) FROM customer WHERE 0 = "
    "(SELECT count(*) FROM orders WHERE o_custkey = c_custkey)",
    "SELECT count(*) FROM customer WHERE 0 = "
    "(SELECT coalesce(sum(o_totalprice), 0) FROM orders WHERE o_custkey = c_custkey)",
    "SELECT count(*) FROM customer WHERE 0 = coalesce("
    "(SELECT sum(o_totalprice) FROM orders WHERE o_custkey = c_custkey), 0)",
])
def test_count_subquery_counts_customers_without_orders(tpch, sql):
    """o_custkey is never a multiple of 3, so a third of the customers
    have no order; each counts once."""
    tcon, catalog = tpch
    want = _no_order_customers(catalog)
    assert want == 500
    tcon.routes.clear()
    assert tcon.sql(sql).rows() == [(want,)]
    assert tcon.routes.get("eager_left") == 1, dict(tcon.routes)
