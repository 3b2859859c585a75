"""Set operations, VALUES, GROUPING SETS / ROLLUP / CUBE and WITH
RECURSIVE through duckdb_tpu_torch (device="cpu"), against duckdb_tpu and,
where the reference is at fault, against SQL's answer.

Both packages load one directory of all eight tables written by the port's
seeded generator (duckdb_tpu_torch/testing/tpch_gen.py) at SF 0.01, seed 7;
the JAX connection runs with `SET pallas_grouped_sum = 'on'`. DECIMAL,
integer, string, date and NULL values must match exactly, DOUBLE values
within 1e-9 relative; rows are compared as multisets unless ORDER BY fixes
their order.

The reference's faults that the port does not copy are held to SQL here:
- R1: a VARCHAR column under a set operation whose first branch gives it
  no dictionary comes out as codes in the reference (`SELECT NULL UNION ALL
  SELECT 'x'`, GROUPING SETS ((a), (b)));
- R4: an ungrouped column in a GROUPING SETS select list is a KeyError in
  the reference and a BindError here, as in DuckDB;
- EXCEPT ALL and INTERSECT ALL keep multiplicities, and INTERSECT and
  EXCEPT match NULL to NULL (the reference dedups and semi/anti joins);
- R5: each input of a set operation is cast to the widened type (the
  reference casts only the right side: `SELECT 1 UNION ALL SELECT 2.5`
  gives an INTEGER 1 beside a DECIMAL 2.5);
- F4: `SELECT *` over two columns of one name lists both (the reference
  repeats the last).
"""

import datetime
import decimal

import pytest
import torch

import duckdb_tpu
import duckdb_tpu_torch
from duckdb_tpu_torch.ops import grouped as grouped_mod
from duckdb_tpu_torch.planner.bound import BindError
from duckdb_tpu_torch.testing import tpch_oracle
from duckdb_tpu_torch.testing.tpch_gen import write_tables

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("tpch_gen_setops")
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


def _key(row):
    return tuple((v is None, "" if v is None else repr(type(v)), v if v is not None else 0)
                 for v in row)


def assert_rows_match(got, want, ordered=False):
    if not ordered:
        got, want = sorted(got, key=_key), sorted(want, key=_key)
    assert len(got) == len(want), (got[:5], want[:5])
    for g_row, w_row in zip(got, want):
        assert len(g_row) == len(w_row)
        for g, w in zip(g_row, w_row):
            assert type(g) is type(w), (g_row, w_row)
            if isinstance(w, float):
                assert g == pytest.approx(w, rel=1e-9, abs=0.0), (g_row, w_row)
            else:
                assert g == w, (g_row, w_row)


# -- F4: `*` by binding, not by name ---------------------------------------------
F4_CASES = {
    "SELECT * FROM (SELECT n_nationkey AS k, n_regionkey AS k FROM nation) t LIMIT 3":
        [(0, 0), (1, 1), (2, 1)],
    "SELECT * FROM (SELECT 1 AS a, 2 AS a) t": [(1, 2)],
    "SELECT * FROM (SELECT 1, 1 + 1, 2) t": [(1, 2, 2)],
    # the control: an alias list names the two columns apart in both packages
    "SELECT * FROM (SELECT n_nationkey AS k, n_regionkey AS k FROM nation) t(a, b) LIMIT 3":
        [(0, 0), (1, 1), (2, 1)],
}


@pytest.mark.parametrize("sql", sorted(F4_CASES))
def test_star_lists_each_binding(cons, sql):
    """ROADMAP F4: DuckDB's answers (the reference gives (1, 1) for the
    third row of the first, (2, 2) and (2, 2, 2) for the next two)."""
    _, tcon = cons
    assert tcon.sql(sql).rows() == F4_CASES[sql]


def test_star_alias_list_control_matches_reference(cons):
    jcon, tcon = cons
    sql = "SELECT * FROM (SELECT n_nationkey AS k, n_regionkey AS k FROM nation) t(a, b)"
    assert_rows_match(tcon.sql(sql).rows(), jcon.sql(sql).rows(), ordered=True)


# -- set operations and VALUES against the reference ---------------------------
PARITY = [
    "SELECT 1 UNION ALL SELECT 2",
    "SELECT 1 AS x UNION ALL SELECT 2 UNION ALL SELECT 3 UNION ALL SELECT 2",
    "SELECT n_regionkey FROM nation UNION SELECT r_regionkey FROM region",
    "SELECT n_name FROM nation UNION ALL SELECT r_name FROM region",
    "SELECT n_name FROM nation UNION SELECT r_name FROM region",
    "SELECT n_regionkey FROM nation INTERSECT SELECT r_regionkey FROM region "
    "WHERE r_regionkey > 1",
    "SELECT n_regionkey FROM nation EXCEPT SELECT r_regionkey FROM region WHERE r_regionkey > 1",
    "SELECT n_name, n_regionkey FROM nation EXCEPT SELECT n_name, n_regionkey FROM nation "
    "WHERE n_regionkey = 3",
    "SELECT o_orderstatus, o_orderpriority FROM orders INTERSECT "
    "SELECT o_orderstatus, o_orderpriority FROM orders WHERE o_totalprice > 300000",
    "SELECT sum(n_nationkey) FROM nation UNION ALL SELECT 7",
    "SELECT * FROM (VALUES (1, 'a'), (2, 'b')) v(i, s)",
    "SELECT * FROM (VALUES (1, 'a'), (2, 'b'), (3, 'a')) v",
    "SELECT s, count(*) FROM (VALUES (1, 'a'), (2, 'b'), (3, 'a')) v(i, s) GROUP BY s",
    "SELECT count(*), sum(x) FROM (SELECT l_quantity AS x FROM lineitem "
    "UNION ALL SELECT ps_availqty FROM partsupp)",
    "SELECT x FROM (SELECT o_orderdate AS x FROM orders WHERE o_orderkey < 40 "
    "UNION SELECT l_shipdate FROM lineitem WHERE l_orderkey < 10)",
    "SELECT count(*) FROM nation WHERE n_regionkey IN "
    "(SELECT 1 UNION ALL SELECT 3)",
]


@pytest.mark.parametrize("sql", PARITY)
def test_setops_match_reference(cons, sql):
    jcon, tcon = cons
    assert_rows_match(tcon.sql(sql).rows(), jcon.sql(sql).rows())


ORDERED = [
    "SELECT n_name AS x FROM nation UNION SELECT r_name FROM region ORDER BY x DESC LIMIT 7",
    "SELECT n_nationkey, n_name FROM nation WHERE n_nationkey < 3 UNION ALL "
    "SELECT r_regionkey, r_name FROM region ORDER BY 1, 2",
    "SELECT n_regionkey AS k FROM nation EXCEPT SELECT 2 ORDER BY k LIMIT 2 OFFSET 1",
]


@pytest.mark.parametrize("sql", ORDERED)
def test_setops_order_limit_match_reference(cons, sql):
    jcon, tcon = cons
    assert_rows_match(tcon.sql(sql).rows(), jcon.sql(sql).rows(), ordered=True)


def test_setop_names_and_types(cons):
    """Names from the left side; each column's type the widest."""
    _, tcon = cons
    res = tcon.sql("SELECT 1 AS a, 'x' AS b UNION ALL SELECT 2.5, NULL")
    assert res.names == ["a", "b"]
    assert [str(t) for t in res.types] == ["DECIMAL(11,1)", "VARCHAR"]
    assert res.rows() == [(decimal.Decimal("1.0"), "x"), (decimal.Decimal("2.5"), None)]


SQL_ANSWERS = {
    # R1: the first branch gives the column no dictionary
    "SELECT NULL AS a UNION ALL SELECT 'x'": [(None,), ("x",)],
    "SELECT * FROM (VALUES (NULL), ('x'), ('y')) v(s)": [(None,), ("x",), ("y",)],
    # ALL keeps multiplicities; NULL matches NULL
    "SELECT a FROM (VALUES (1), (1), (2)) t(a) EXCEPT ALL SELECT 1": [(1,), (2,)],
    "SELECT a FROM (VALUES (1), (1), (2)) t(a) INTERSECT ALL "
    "SELECT a FROM (VALUES (1), (1), (3)) s(a)": [(1,), (1,)],
    "SELECT a FROM (VALUES (1), (NULL)) t(a) INTERSECT "
    "SELECT a FROM (VALUES (NULL), (2)) s(a)": [(None,)],
    "SELECT a FROM (VALUES (1), (NULL)) t(a) EXCEPT SELECT a FROM (VALUES (NULL), (2)) s(a)":
        [(1,)],
    "SELECT a FROM (VALUES (1), (1), (1), (2)) t(a) EXCEPT ALL "
    "SELECT a FROM (VALUES (1), (3)) s(a)": [(1,), (1,), (2,)],
    "SELECT a FROM (VALUES (NULL), (NULL), (4)) t(a) INTERSECT ALL "
    "SELECT a FROM (VALUES (NULL), (NULL), (NULL)) s(a)": [(None,), (None,)],
    "SELECT a FROM (VALUES (1), (1)) t(a) UNION SELECT a FROM (VALUES (NULL), (NULL)) s(a)":
        [(1,), (None,)],
    # the left side widens too (the reference leaves its 1 an INTEGER: R5)
    "SELECT 1 UNION ALL SELECT 2.5": [(decimal.Decimal("1.0"),), (decimal.Decimal("2.5"),)],
    # nested values concatenate their dictionaries
    "SELECT [1, 2] AS l UNION ALL SELECT [3]": [([1, 2],), ([3],)],
    "SELECT DATE '1992-01-01' AS d UNION ALL SELECT DATE '1998-12-31'":
        [(datetime.date(1992, 1, 1),), (datetime.date(1998, 12, 31),)],
}


@pytest.mark.parametrize("sql", sorted(SQL_ANSWERS))
def test_setops_hold_to_sql(cons, sql):
    """The reference's set-operation faults (R1, ALL, NULL rows) held to
    SQL's answers."""
    _, tcon = cons
    assert_rows_match(tcon.sql(sql).rows(), SQL_ANSWERS[sql])


def test_setop_widths_must_agree(cons):
    _, tcon = cons
    with pytest.raises(BindError, match="same number of result columns"):
        tcon.sql("SELECT 1, 2 UNION SELECT 3")


def test_set_operations_against_numpy(cons, data_dir):
    """INTERSECT and EXCEPT, with and without ALL, of l_partkey and
    p_partkey against numpy's multisets (phase 14's setops_big at SF 0.01)."""
    import collections

    import numpy as np

    _, tcon = cons
    t = tpch_oracle._Tables(data_dir)
    ship = t("lineitem", "l_shipdate")
    left = collections.Counter(t("lineitem", "l_partkey")[
        (ship >= tpch_oracle._day("1995-01-01")) & (ship < tpch_oracle._day("1995-03-01"))
    ].tolist())
    right = collections.Counter(t("part", "p_partkey")[t("part", "p_size") < 20].tolist())
    lsql = ("SELECT l_partkey FROM lineitem WHERE l_shipdate >= DATE '1995-01-01' "
            "AND l_shipdate < DATE '1995-03-01'")
    rsql = "SELECT p_partkey FROM part WHERE p_size < 20"
    for op, want in (("INTERSECT", left.keys() & right.keys()),
                     ("EXCEPT", left.keys() - right.keys()),
                     ("INTERSECT ALL", (left & right).elements()),
                     ("EXCEPT ALL", (left - right).elements())):
        got = sorted(r[0] for r in tcon.sql(f"{lsql} {op} {rsql}").rows())
        assert got == sorted(want), op
    assert np.isin(list(left), list(right)).any()  # the sets do overlap


# -- GROUPING SETS, ROLLUP and CUBE ---------------------------------------------
GROUPING = [
    "SELECT l_returnflag, l_linestatus, count(*), sum(l_quantity) FROM lineitem "
    "GROUP BY ROLLUP (l_returnflag, l_linestatus)",
    "SELECT l_returnflag, l_linestatus, count(*) FROM lineitem "
    "GROUP BY CUBE (l_returnflag, l_linestatus)",
    "SELECT l_returnflag, grouping(l_returnflag), grouping_id(l_returnflag, l_linestatus), "
    "avg(l_discount) FROM lineitem GROUP BY ROLLUP (l_returnflag, l_linestatus)",
    "SELECT l_returnflag, l_linestatus, count(*) FROM lineitem "
    "GROUP BY GROUPING SETS ((l_returnflag, l_linestatus), ())",
    "SELECT o_orderpriority, count(*) FROM orders GROUP BY ROLLUP (o_orderpriority) "
    "ORDER BY 1 NULLS LAST",
    "SELECT l_returnflag, l_linestatus, sum(l_quantity) FROM lineitem GROUP BY "
    "ROLLUP (l_returnflag, l_linestatus) ORDER BY grouping(l_returnflag), 1, 2",
]


@pytest.mark.parametrize("sql", GROUPING)
def test_grouping_sets_match_reference(cons, sql):
    jcon, tcon = cons
    assert_rows_match(tcon.sql(sql).rows(), jcon.sql(sql).rows(), ordered="ORDER BY" in sql)


def test_grouping_sets_r1_held_to_numpy(cons, data_dir):
    """R1: the (l_linestatus) branch's key keeps its text values ('F',
    'O'); the reference gives its codes."""
    import numpy as np

    _, tcon = cons
    t = tpch_oracle._Tables(data_dir)
    want = []
    for col, pos in (("l_returnflag", 0), ("l_linestatus", 1)):
        vals, counts = np.unique(t("lineitem", col), return_counts=True)
        for v, c in zip(vals, counts):
            row = [None, None, int(c)]
            row[pos] = v.decode()
            want.append(tuple(row))
    got = tcon.sql("SELECT l_returnflag, l_linestatus, count(*) FROM lineitem "
                   "GROUP BY GROUPING SETS ((l_returnflag), (l_linestatus))").rows()
    assert_rows_match(got, want)


def test_grouping_sets_ungrouped_column_is_a_bind_error(cons):
    """R4: DuckDB's BindError (the reference raises KeyError)."""
    _, tcon = cons
    with pytest.raises(BindError, match='"l_returnflag" must appear in the GROUP BY'):
        tcon.sql("SELECT l_returnflag, count(*) FROM lineitem "
                 "GROUP BY GROUPING SETS ((l_linestatus), ())")


# -- WITH RECURSIVE ------------------------------------------------------------------
RECURSIVE = [
    "WITH RECURSIVE r(n) AS (SELECT 1 UNION ALL SELECT n + 1 FROM r WHERE n < 10) "
    "SELECT sum(n) FROM r",
    "WITH RECURSIVE r(n, s) AS (SELECT 0, 'x' UNION ALL SELECT n + 1, s || 'y' FROM r "
    "WHERE n < 4) SELECT n, s FROM r ORDER BY n",
    "WITH RECURSIVE r(k) AS (SELECT 0 UNION ALL SELECT k + 5 FROM r WHERE k < 20) "
    "SELECT n_name FROM nation, r WHERE n_nationkey = k ORDER BY 1",
    "WITH RECURSIVE t(n) AS (SELECT 1) SELECT n FROM t",
]


@pytest.mark.parametrize("sql", RECURSIVE)
def test_recursive_cte_matches_reference(cons, sql):
    jcon, tcon = cons
    assert_rows_match(tcon.sql(sql).rows(), jcon.sql(sql).rows(), ordered="ORDER BY" in sql)


def test_recursive_union_stops_at_fixpoint(cons):
    """UNION (not ALL) recursion ends when a round adds no new row, so a
    cycle terminates."""
    _, tcon = cons
    got = tcon.sql("WITH RECURSIVE t(n) AS (SELECT 1 UNION SELECT n % 3 + 1 FROM t) "
                   "SELECT n FROM t ORDER BY n").rows()
    assert got == [(1,), (2,), (3,)]


def test_recursive_cte_tables_live_with_the_plan(data_dir):
    """Each round's working table is dropped as the fixpoint goes; the
    final table lives as long as the cached plan."""
    tcon = duckdb_tpu_torch.connect(device="cpu")
    tcon.load_tpch(data_dir)
    sql = ("WITH RECURSIVE r(n) AS (SELECT 1 UNION SELECT n + 1 FROM r WHERE n < 30) "
           "SELECT count(*) FROM r")
    assert tcon.sql(sql).rows() == [(30,)]
    hidden = [n for n in tcon.catalog.tables if n.startswith("__")]
    assert len(hidden) == 1 and hidden[0].startswith("__cte_r"), hidden
    assert tcon.routes["cte_recursive"] == 1
    tcon.load_tpch(data_dir)
    assert not [n for n in tcon.catalog.tables if n.startswith("__")]


# -- the slice as a whole --------------------------------------------------------------
def test_slice_rollup_and_mark_q4(cons, data_dir, monkeypatch):
    """rollup_q1 and mark_q4 (phase 14's queries) at SF 0.01 through both
    packages and the numpy oracle; each ROLLUP branch is a dense aggregate
    that launches the port's grouped sum once."""
    jcon, tcon = cons
    calls = []
    orig = grouped_mod.grouped_sum_i64

    def spy(dense, vectors, nseg):
        calls.append(nseg)
        return orig(dense, vectors, nseg)

    monkeypatch.setattr(grouped_mod, "grouped_sum_i64", spy)
    for name in ("rollup_q1", "mark_q4"):
        sql = tpch_oracle.SELECT_FORM_QUERIES[name]
        calls.clear()
        got = tcon.sql(sql).rows()
        assert_rows_match(got, tpch_oracle.answer(name, data_dir), ordered=True)
        assert_rows_match(got, jcon.sql(sql).rows(), ordered=True)
        if name == "rollup_q1":
            assert len(calls) == 3, calls  # (flag, status), (flag), ()
        else:
            assert calls, "mark_q4's dense aggregate did not reach the grouped sum"
