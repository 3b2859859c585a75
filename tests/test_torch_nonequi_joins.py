"""Joins without an equality (cross products, inequality joins, ASOF,
POSITIONAL) and USING / NATURAL joins through duckdb_tpu_torch
(device="cpu"), against duckdb_tpu and against nested-loop SQL answers.

Both packages load one directory of all eight tables written by the port's
seeded generator at SF 0.01, seed 7. Small hand-made tables (made with
`catalog.create_table` in the port and CREATE TABLE in the reference) hold
NULLs and duplicates; on them every join is held to a nested loop in plain
Python. The reference's faults are held to SQL (DuckDB's rules):
- R2: LEFT, RIGHT and FULL joins USING, and NATURAL joins, equate their
  columns (the reference gives the cross product);
- R3: an unqualified USING column reads the left side's value (the right
  side's in a RIGHT join, COALESCE(left, right) in a FULL join); the
  reference calls it ambiguous.
"""

import numpy as np
import pytest
import torch

import duckdb_tpu
import duckdb_tpu_torch
from duckdb_tpu_torch.catalog.catalog import ColumnDef, TableEntry
from duckdb_tpu_torch.planner import plan as TP
from duckdb_tpu_torch.planner.bound import BindError
from duckdb_tpu_torch.planner.planner import Planner as TPlanner
from duckdb_tpu_torch.sql.parser import Parser as TParser
from duckdb_tpu_torch.testing import tpch_oracle
from duckdb_tpu_torch.testing.tpch_gen import write_tables
from duckdb_tpu_torch.types import INTEGER

torch.set_num_threads(1)

# l(k, x) and r(k, y): duplicate keys, NULL keys and values on both sides
L = [(1, 5), (2, 7), (2, None), (4, 1), (None, 3), (6, 9)]
R = [(1, 4), (2, 7), (2, 8), (3, 2), (None, 6), (6, None), (7, 1)]


def _int_table(name, cols, rows):
    entry = TableEntry(name, [ColumnDef(col, INTEGER) for col in cols])
    entry.nrows = len(rows)
    for col, values in zip(cols, zip(*rows)):
        valid = np.array([v is not None for v in values])
        entry.set_host_column(col, np.array([v or 0 for v in values], dtype=np.int32),
                              None if valid.all() else valid)
    return entry


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("tpch_gen_nonequi")
    write_tables(str(root), 0.01, seed=7)
    return str(root)


@pytest.fixture(scope="module")
def cons(data_dir):
    jcon = duckdb_tpu.connect()
    jcon.load_tpch(data_dir)
    tcon = duckdb_tpu_torch.connect(device="cpu")
    tcon.load_tpch(data_dir)
    for name, cols, rows in (("l", ("k", "x"), L), ("r", ("k", "y"), R)):
        jcon.sql(f"CREATE TABLE {name} ({', '.join(c + ' INTEGER' for c in cols)})")
        jcon.sql(f"INSERT INTO {name} VALUES " + ", ".join(
            "(" + ", ".join("NULL" if v is None else str(v) for v in row) + ")" for row in rows))
        tcon.catalog.create_table(_int_table(name, cols, rows))
    return jcon, tcon


def _sorted(rows):
    return sorted(rows, key=lambda r: tuple((v is None, 0 if v is None else v) for v in r))


def _lt(a, b):
    return a is not None and b is not None and a < b


def _outer(pairs_ok, kind):
    """Rows of l ⋈ r under `pairs_ok(lrow, rrow)` for an inner, left,
    right or full join: (l.k, l.x, r.k, r.y), NULL-extended."""
    out, l_hit, r_hit = [], set(), set()
    for i, a in enumerate(L):
        for j, b in enumerate(R):
            if pairs_ok(a, b):
                out.append(a + b)
                l_hit.add(i)
                r_hit.add(j)
    if kind in ("left", "full"):
        out += [a + (None, None) for i, a in enumerate(L) if i not in l_hit]
    if kind in ("right", "full"):
        out += [(None, None) + b for j, b in enumerate(R) if j not in r_hit]
    return out


# -- cross products and inequality joins against the reference ------------------
PARITY = [
    "SELECT count(*) FROM range(3) t(x), range(4) s(y)",
    "SELECT x, y FROM range(3) t(x), range(2) s(y)",
    "SELECT count(*) FROM nation a JOIN nation b ON a.n_nationkey < b.n_nationkey",
    "SELECT r_name, count(*), sum(n_nationkey) FROM nation, region GROUP BY r_name",
    "SELECT count(*) FROM nation, region WHERE n_regionkey < r_regionkey",
    "SELECT count(*) FROM nation a, nation b WHERE a.n_nationkey <= b.n_nationkey "
    "AND b.n_nationkey < a.n_nationkey + 3",
    "SELECT count(*), sum(s_suppkey) FROM part, supplier "
    "WHERE p_retailprice BETWEEN s_acctbal - 1 AND s_acctbal + 1",
    "SELECT count(*) FROM nation a, region b, nation c WHERE a.n_regionkey = b.r_regionkey "
    "AND c.n_nationkey > a.n_nationkey",
    "SELECT count(*) FROM orders LEFT JOIN customer ON o_custkey < c_custkey "
    "WHERE o_orderkey < 200",
]


@pytest.mark.parametrize("sql", PARITY)
def test_keyless_joins_match_reference(cons, sql):
    jcon, tcon = cons
    assert _sorted(tcon.sql(sql).rows()) == _sorted(jcon.sql(sql).rows())


def test_keyless_join_plans(cons):
    """An inequality between two atoms makes a keyless Join (the IE join);
    no condition at all makes a CrossJoin."""
    _, tcon = cons

    def nodes(sql):
        plan, _ = TPlanner(tcon.catalog).plan_select(TParser(sql).parse_statements()[0])
        stack, out = [plan], []
        while stack:
            n = stack.pop()
            out.append(n)
            stack += [c for c in (getattr(n, a, None) for a in ("child", "probe", "build"))
                      if c is not None]
        return out

    ie = [n for n in nodes("SELECT count(*) FROM nation, region WHERE n_regionkey < r_regionkey")
          if isinstance(n, TP.Join)]
    assert len(ie) == 1 and not ie[0].probe_keys and ie[0].extra is not None
    assert any(isinstance(n, TP.CrossJoin) for n in nodes("SELECT count(*) FROM nation, region"))
    tcon.routes.clear()
    tcon.sql("SELECT count(*) FROM part, supplier "
             "WHERE p_retailprice BETWEEN s_acctbal - 1 AND s_acctbal + 1").rows()
    assert tcon.routes["ie_join"] == 1 and not tcon.routes["cross_product"]


def test_band_join_against_numpy(cons, data_dir):
    _, tcon = cons
    got = tcon.sql(tpch_oracle.SELECT_FORM_QUERIES["band_join"]).rows()
    assert got == tpch_oracle.answer("band_join", data_dir)


KEYLESS_OUTER = {
    "inner": ("SELECT l.k, l.x, r.k, r.y FROM l JOIN r ON l.x < r.y", "inner",
              lambda a, b: _lt(a[1], b[1])),
    "left": ("SELECT l.k, l.x, r.k, r.y FROM l LEFT JOIN r ON l.x < r.y", "left",
             lambda a, b: _lt(a[1], b[1])),
    "right": ("SELECT l.k, l.x, r.k, r.y FROM l RIGHT JOIN r ON l.x < r.y", "right",
              lambda a, b: _lt(a[1], b[1])),
    "full": ("SELECT l.k, l.x, r.k, r.y FROM l FULL JOIN r ON l.x < r.y", "full",
             lambda a, b: _lt(a[1], b[1])),
    "band": ("SELECT l.k, l.x, r.k, r.y FROM l FULL JOIN r ON l.x >= r.y AND l.x <= r.y + 2",
             "full", lambda a, b: None not in (a[1], b[1]) and b[1] <= a[1] <= b[1] + 2),
    "cross_left": ("SELECT l.k, l.x, r.k, r.y FROM l LEFT JOIN r ON l.x + r.y = 12", "left",
                   lambda a, b: None not in (a[1], b[1]) and a[1] + b[1] == 12),
}


@pytest.mark.parametrize("name", sorted(KEYLESS_OUTER))
def test_keyless_outer_joins_follow_sql(cons, name):
    """Inner and outer joins without an equi key, over NULL values, against
    a nested loop (the inequality join, and the cross expansion where no
    inequality prunes)."""
    _, tcon = cons
    sql, kind, ok = KEYLESS_OUTER[name]
    assert _sorted(tcon.sql(sql).rows()) == _sorted(_outer(ok, kind))


# -- ASOF ------------------------------------------------------------------------------
def test_asof_matches_reference(cons):
    jcon, tcon = cons
    sql = ("SELECT count(*), sum(o_totalprice) FROM lineitem l ASOF JOIN orders o "
           "ON l.l_orderkey = o.o_orderkey AND l.l_shipdate >= o.o_orderdate")
    assert tcon.sql(sql).rows() == jcon.sql(sql).rows()
    assert tcon.sql("SELECT count(*) FROM lineitem l ASOF JOIN orders o ON l.l_orderkey = "
                    "o.o_orderkey AND l.l_shipdate >= o.o_orderdate").rows() == [(60012,)]


def _asof(op, left_outer):
    """l ASOF [LEFT] JOIN r ON l.k = r.k AND l.x op r.y: the nearest r.y."""
    out = []
    for a in L:
        cands = [b for b in R if a[0] is not None and b[0] == a[0] and None not in (a[1], b[1])
                 and {">=": a[1] >= b[1], ">": a[1] > b[1], "<=": a[1] <= b[1],
                      "<": a[1] < b[1]}[op]]
        if cands:
            best = (max if op in (">=", ">") else min)(cands, key=lambda b: b[1])
            out.append(a + best)
        elif left_outer:
            out.append(a + (None, None))
    return out


@pytest.mark.parametrize("op", [">=", ">", "<=", "<"])
@pytest.mark.parametrize("left_outer", [False, True])
def test_asof_follows_sql(cons, op, left_outer):
    _, tcon = cons
    sql = (f"SELECT l.k, l.x, r.k, r.y FROM l ASOF {'LEFT ' if left_outer else ''}JOIN r "
           f"ON l.k = r.k AND l.x {op} r.y")
    assert _sorted(tcon.sql(sql).rows()) == _sorted(_asof(op, left_outer))


def test_asof_needs_an_inequality(cons):
    _, tcon = cons
    with pytest.raises(BindError, match="ASOF JOIN requires an inequality"):
        tcon.sql("SELECT count(*) FROM l ASOF JOIN r ON l.k = r.k")


# -- POSITIONAL ----------------------------------------------------------------------
def test_positional_matches_reference(cons):
    jcon, tcon = cons
    sql = "SELECT n_name, r_name FROM nation POSITIONAL JOIN region"
    assert tcon.sql(sql).rows() == jcon.sql(sql).rows()
    assert tcon.sql("SELECT count(*) FROM nation POSITIONAL JOIN region").rows() == [(25,)]


def test_positional_pads_with_nulls(cons, data_dir):
    _, tcon = cons
    got = tcon.sql("SELECT l.k, r.y FROM l POSITIONAL JOIN (SELECT y FROM r WHERE y > 3) r")
    want = [(a[0], b) for a, b in zip(L, [y for _, y in R if y is not None and y > 3]
                                      + [None] * len(L))]
    assert got.rows() == want
    assert tcon.sql(tpch_oracle.SELECT_FORM_QUERIES["positional"]).rows() == \
        tpch_oracle.answer("positional", data_dir)


# -- USING and NATURAL ------------------------------------------------------------------
def test_inner_using_matches_reference(cons):
    """The count against the reference; the unqualified USING column, which
    the reference calls ambiguous in every join type (R3), against DuckDB."""
    jcon, tcon = cons
    sql = ("SELECT count(*) FROM nation JOIN "
           "(SELECT r_regionkey AS n_regionkey, r_name FROM region) r USING (n_regionkey)")
    assert tcon.sql(sql).rows() == jcon.sql(sql).rows() == [(25,)]
    assert tcon.sql(sql.replace("count(*)", "count(*), sum(n_regionkey)")).rows() == [(25, 50)]


USING_CASES = {
    # R2: LEFT / RIGHT / FULL joins USING equate the column
    "SELECT count(*) FROM (SELECT n_nationkey k FROM nation) a "
    "LEFT JOIN (SELECT r_regionkey k FROM region) b USING (k)": [(25,)],
    "SELECT count(*) FROM (SELECT n_regionkey k FROM nation) a "
    "FULL JOIN (SELECT r_regionkey + 2 k FROM region) b USING (k)": [(27,)],
    "SELECT count(*) FROM (SELECT n_regionkey k FROM nation) a "
    "RIGHT JOIN (SELECT r_regionkey + 2 k FROM region) b USING (k)": [(17,)],
    "SELECT count(*) FROM (SELECT n_nationkey, n_regionkey FROM nation) a "
    "NATURAL JOIN (SELECT r_regionkey AS n_regionkey, r_name FROM region) b": [(25,)],
    # R3: the unqualified column reads COALESCE(a.k, b.k)
    "SELECT k, a.k, b.k FROM (SELECT n_nationkey k FROM nation WHERE n_nationkey < 3) a "
    "FULL JOIN (SELECT r_regionkey + 2 k FROM region) b USING (k)":
        [(0, 0, None), (1, 1, None), (2, 2, 2), (3, None, 3), (4, None, 4), (5, None, 5),
         (6, None, 6)],
    # the right side's value in a RIGHT join, and `*` lists k once
    "SELECT * FROM (SELECT n_nationkey k, n_name FROM nation WHERE n_nationkey < 3) a "
    "RIGHT JOIN (SELECT r_regionkey + 2 k, r_name FROM region) b USING (k)":
        [(2, "BRAZIL", "AFRICA"), (3, None, "AMERICA"), (4, None, "ASIA"),
         (5, None, "EUROPE"), (6, None, "MIDDLE EAST")],
    "SELECT * FROM l JOIN r USING (k)": [(1, 5, 4), (2, 7, 7), (2, 7, 8), (2, None, 7),
                                         (2, None, 8), (6, 9, None)],
    "SELECT * FROM l NATURAL JOIN (SELECT k, y AS x FROM r) s": [(2, 7)],
    # with no column in common, NATURAL JOIN is the cross product
    "SELECT count(*) FROM nation NATURAL JOIN region": [(125,)],
}


@pytest.mark.parametrize("sql", sorted(USING_CASES))
def test_using_follows_duckdb(cons, sql):
    _, tcon = cons
    assert _sorted(tcon.sql(sql).rows()) == _sorted(USING_CASES[sql])


def test_full_using_against_nested_loop(cons):
    """FULL JOIN … USING over NULL keys: a NULL key matches nothing, and
    the unqualified column is COALESCE of both sides."""
    _, tcon = cons
    rows = _outer(lambda a, b: a[0] is not None and a[0] == b[0], "full")
    want = [(r[0] if r[0] is not None else r[2], r[1], r[3]) for r in rows]
    assert _sorted(tcon.sql("SELECT k, x, y FROM l FULL JOIN r USING (k)").rows()) == \
        _sorted(want)


def test_using_unknown_column_is_a_bind_error(cons):
    _, tcon = cons
    with pytest.raises(BindError, match='"nope" does not exist'):
        tcon.sql("SELECT count(*) FROM l JOIN r USING (nope)")


@pytest.mark.parametrize("name", ["using_left", "using_full", "natural_join"])
def test_using_queries_against_numpy(cons, data_dir, name):
    _, tcon = cons
    assert tcon.sql(tpch_oracle.SELECT_FORM_QUERIES[name]).rows() == \
        tpch_oracle.answer(name, data_dir)


def test_pair_cap_refuses_before_expanding(cons, monkeypatch):
    """A join without an equality reads its pair count first and refuses
    to expand past the cap (the JAX package's IE_PAIR_CAP)."""
    from duckdb_tpu_torch.errors import OutOfRangeException
    from duckdb_tpu_torch.execution import executor as TE

    _, tcon = cons
    monkeypatch.setattr(TE.Executor, "PAIR_CAP", 100)
    for sql in ("SELECT count(*) FROM nation, region",  # 125 pairs
                "SELECT count(*) FROM nation a JOIN nation b ON a.n_nationkey < b.n_nationkey",
                "SELECT count(*) FROM nation a LEFT JOIN nation b "
                "ON a.n_nationkey + b.n_nationkey = 3"):
        with pytest.raises(OutOfRangeException, match="would expand"):
            tcon.sql(sql)
    assert tcon.sql("SELECT count(*) FROM region a, region b").rows() == [(25,)]
