"""The forms the JAX package answers and the port used to refuse (ROADMAP
item 47), through duckdb_tpu_torch (device="cpu") and duckdb_tpu with the
same SQL over the same tables: windows over HUGEINT values, DISTINCT and
FILTER over a window, median over a VARCHAR window, ASOF JOIN over a
VARCHAR inequality, COLLATE, INTERVAL → VARCHAR and ON CONFLICT DO UPDATE
from a column of another type.

DECIMAL, integer, string, date and NULL values must match exactly, DOUBLE
values within 1e-9 relative. Where the JAX package is wrong the port is
held to SQL or DuckDB, with the expected rows written here, and each such
test also asserts that the JAX package still differs:
- W8: FILTER over a window is ignored;
- W9: median over a VARCHAR window gives the dictionary codes' median as
  DOUBLE; DuckDB gives quantile_disc, the lower middle value, as VARCHAR;
- W10: DISTINCT over a window is ignored (count(DISTINCT b) counts every
  row);
- W11: ASOF JOIN over a VARCHAR inequality with > or <= gives a wrong row
  to a probe value the build side lacks;
- INTERVAL → VARCHAR gives the microseconds; DuckDB gives '1 day'.
Tables are small, made from a numpy seed where they are not hand-written.
"""

import decimal

import numpy as np
import pytest
import torch

import duckdb_tpu
import duckdb_tpu_torch
from duckdb_tpu_torch.planner.bound import BindError

from _torch_parity import outcome, same

torch.set_num_threads(1)

RNG = np.random.default_rng(47)
N = 60
_G = RNG.integers(0, 4, N)
_H = RNG.integers(-(10 ** 12), 10 ** 12, N)
_B = RNG.integers(0, 5, N)
_S = RNG.choice(["ant", "bee", "cat", "dog", "eel", "fox"], N)
_ROWS = ", ".join(
    f"({i}, {g}, {h}, {b}, '{s}', {'NULL' if i % 11 == 3 else i % 7})"
    for i, (g, h, b, s) in enumerate(zip(_G, _H, _B, _S)))
SETUP = [
    "CREATE TABLE w (i INTEGER, g INTEGER, h HUGEINT, b INTEGER, s VARCHAR, o INTEGER)",
    f"INSERT INTO w VALUES {_ROWS}",
]


@pytest.fixture(scope="module")
def cons():
    jcon, tcon = duckdb_tpu.connect(), duckdb_tpu_torch.connect(device="cpu")
    for sql in SETUP:
        jcon.sql(sql)
        tcon.sql(sql)
    return jcon, tcon


def both(cons, sql):
    jcon, tcon = cons
    j, t = outcome(jcon, sql), outcome(tcon, sql)
    same(sql, j, t)
    return t[1]


# -- windows over HUGEINT values ------------------------------------------------------
HUGEINT_WINDOWS = [
    "sum(h) OVER (ORDER BY g, i)",
    "sum(h) OVER (PARTITION BY g)",
    "sum(h) OVER (PARTITION BY g ORDER BY i ROWS BETWEEN 2 PRECEDING AND 1 FOLLOWING)",
    "min(h) OVER (PARTITION BY g)",
    "max(h) OVER (PARTITION BY g)",
    "min(h) OVER (PARTITION BY g ORDER BY i)",
    "max(h) OVER (ORDER BY i ROWS BETWEEN 3 PRECEDING AND CURRENT ROW)",
    "lag(h) OVER (PARTITION BY g ORDER BY i)",
    "lead(h, 2) OVER (ORDER BY i)",
    "first_value(h) OVER (PARTITION BY g ORDER BY i)",
    "last_value(h) OVER (PARTITION BY g ORDER BY i)",
    "count(h) OVER (PARTITION BY g)",
]


@pytest.mark.parametrize("win", HUGEINT_WINDOWS)
def test_hugeint_windows_match_jax(cons, win):
    both(cons, f"SELECT i, g, h, {win} FROM w ORDER BY i")


WIDE = ("(VALUES (1, 1, 500000000000000000000001), (1, 2, -300000000000000000000007), "
        "(1, 3, 2), (1, 4, NULL), (2, 1, 18446744073709551615), (2, 2, 18446744073709551615), "
        "(2, 3, -18446744073709551617), (3, 1, -5)) t(g, o, h)")


def test_hugeint_windows_carry_between_the_halves(cons):
    """Values past 64 bits (the JAX package keeps only their low halves in
    VALUES, so they are held to Python's integers): a running sum carries
    from the low half into the high one, min/max compare both halves, lag
    and first_value move both."""
    _, tcon = cons
    rows = tcon.sql(f"SELECT g, o, h, sum(h) OVER (PARTITION BY g ORDER BY o), "
                    f"min(h) OVER (PARTITION BY g), max(h) OVER (PARTITION BY g), "
                    f"lag(h, 1, 7) OVER (PARTITION BY g ORDER BY o), "
                    f"first_value(h) OVER (PARTITION BY g ORDER BY o DESC) "
                    f"FROM {WIDE} ORDER BY g, o").rows()
    groups = {}
    for g, o, h in [(1, 1, 500000000000000000000001), (1, 2, -300000000000000000000007),
                    (1, 3, 2), (1, 4, None), (2, 1, 2 ** 64 - 1), (2, 2, 2 ** 64 - 1),
                    (2, 3, -(2 ** 64) - 1), (3, 1, -5)]:
        groups.setdefault(g, []).append((o, h))
    want = []
    for g, items in groups.items():
        vals = [h for _, h in items if h is not None]
        run = 0
        for k, (o, h) in enumerate(items):
            run += h or 0
            seen = [x for _, x in items[:k + 1] if x is not None]
            want.append((g, o, h, run if seen else None, min(vals), max(vals),
                         7 if k == 0 else items[k - 1][1], items[-1][1]))
    assert rows == want


# -- DISTINCT and FILTER over a window ------------------------------------------------
def test_distinct_windows_match_jax_where_values_are_distinct(cons):
    """Over i, every value of a partition is distinct, so the JAX package
    (which ignores DISTINCT) and SQL agree."""
    both(cons, "SELECT i, count(DISTINCT i) OVER (PARTITION BY g), "
               "sum(DISTINCT i) OVER (PARTITION BY g), avg(DISTINCT i) OVER (PARTITION BY g) "
               "FROM w ORDER BY i")


def _distinct_expected(running: bool):
    want = []
    for i in range(N):
        part = [k for k in range(N) if _G[k] == _G[i] and (not running or k <= i)]
        d = {int(_B[k]) for k in part}
        want.append((i, len(d), sum(d)))
    return want


@pytest.mark.parametrize("running", [False, True])
def test_w10_distinct_over_a_window_follows_sql(cons, running):
    """count(DISTINCT b) / sum(DISTINCT b), over the partition and running
    (each value counts at its first row in window order); the JAX package
    counts every row."""
    jcon, tcon = cons
    over = "PARTITION BY g ORDER BY i" if running else "PARTITION BY g"
    sql = (f"SELECT i, count(DISTINCT b) OVER ({over}), sum(DISTINCT b) OVER ({over}) "
           f"FROM w ORDER BY i")
    want = _distinct_expected(running)
    assert tcon.sql(sql).rows() == want
    assert jcon.sql(sql).rows() != want


def test_distinct_varchar_window(cons):
    _, tcon = cons
    rows = tcon.sql("SELECT i, count(DISTINCT s) OVER (PARTITION BY g) FROM w ORDER BY i").rows()
    assert rows == [(i, len({_S[k] for k in range(N) if _G[k] == _G[i]})) for i in range(N)]


FILTER_SQL = ("SELECT g, o, sum(o) FILTER (WHERE o > 2) OVER (PARTITION BY g), "
              "count(o) FILTER (WHERE o > 1) OVER (PARTITION BY g), "
              "count(*) FILTER (WHERE o IS NULL) OVER (PARTITION BY g), "
              "max(o) FILTER (WHERE o < 3) OVER (PARTITION BY g ORDER BY o) "
              "FROM (VALUES (1, 1), (1, 2), (2, 1), (2, 3), (2, 5), (2, NULL)) t(g, o) "
              "ORDER BY g, o NULLS LAST")
FILTER_SQL_WANT = [(1, 1, None, 1, 0, 1), (1, 2, None, 1, 0, 2), (2, 1, 8, 2, 1, 1),
                   (2, 3, 8, 2, 1, 1), (2, 5, 8, 2, 1, 1), (2, None, 8, 2, 1, 1)]


def test_w8_filter_over_a_window_follows_sql(cons):
    """The rows the FILTER is not TRUE for do not count (SQL); the JAX
    package ignores the FILTER."""
    jcon, tcon = cons
    assert tcon.sql(FILTER_SQL).rows() == FILTER_SQL_WANT
    assert jcon.sql(FILTER_SQL).rows() != FILTER_SQL_WANT


def test_filter_and_distinct_need_an_aggregate(cons):
    _, tcon = cons
    with pytest.raises(BindError, match="need an aggregate"):
        tcon.sql("SELECT row_number() FILTER (WHERE o > 1) OVER (ORDER BY i) FROM w")


# -- median over a VARCHAR window (W9) --------------------------------------------------
MEDIAN_SQL = ("SELECT g, s, median(s) OVER (PARTITION BY g) FROM (VALUES (0, '0'), (1, '1'), "
              "(0, '2'), (1, '3'), (0, '4'), (2, 'b'), (2, 'a'), (3, 'c'), (3, NULL)) t(g, s) "
              "ORDER BY g, s NULLS LAST")
MEDIAN_WANT = [(0, "0", "2"), (0, "2", "2"), (0, "4", "2"), (1, "1", "1"), (1, "3", "1"),
               (2, "a", "a"), (2, "b", "a"), (3, "c", "c"), (3, None, "c")]


def test_w9_varchar_median_window_follows_duckdb(cons):
    """DuckDB's quantile_disc: the lower middle value, as VARCHAR; the JAX
    package gives the codes' median as a DOUBLE."""
    jcon, tcon = cons
    assert tcon.sql(MEDIAN_SQL).rows() == MEDIAN_WANT
    assert jcon.sql(MEDIAN_SQL).rows() != MEDIAN_WANT


def test_varchar_median_over_a_seeded_table(cons):
    _, tcon = cons
    rows = tcon.sql("SELECT i, median(s) OVER (PARTITION BY g) FROM w ORDER BY i").rows()
    for i, m in rows:
        vals = sorted(_S[k] for k in range(N) if _G[k] == _G[i])
        assert m == vals[(len(vals) - 1) // 2]


# -- ASOF JOIN over a VARCHAR inequality -----------------------------------------------
AP = [("b", 1), ("d", 2), ("a", 3), ("bb", 4), ("zz", 5)]
AQ = [("c", 10), ("a", 20), ("bb", 30), ("b", 40)]


def _asof_reference(op, left):
    """Per probe row, the build row whose value is nearest on op's side."""
    ok = {">=": lambda p, q: p >= q, ">": lambda p, q: p > q,
          "<=": lambda p, q: p <= q, "<": lambda p, q: p < q}[op]
    out = []
    for s, v in AP:
        cand = [(qs, w) for qs, w in AQ if ok(s, qs)]
        if cand:
            out.append((s, v) + (max(cand) if op in (">=", ">") else min(cand)))
        elif left:
            out.append((s, v, None, None))
    return out


@pytest.fixture(scope="module")
def asof_tables(cons):
    for c in cons:
        c.sql("CREATE TABLE ap (s VARCHAR, v INTEGER)")
        c.sql("CREATE TABLE aq (s VARCHAR, w INTEGER)")
        c.sql("INSERT INTO ap VALUES " + ", ".join(f"('{s}', {v})" for s, v in AP))
        c.sql("INSERT INTO aq VALUES " + ", ".join(f"('{s}', {w})" for s, w in AQ))
    return cons


@pytest.mark.parametrize("op", [">=", ">", "<=", "<"])
@pytest.mark.parametrize("left", [False, True])
def test_asof_varchar_follows_sql(asof_tables, op, left):
    """Both sides' strings compare through one merged, sorted dictionary;
    rows held to a nested loop."""
    _, tcon = asof_tables
    join = "ASOF LEFT JOIN" if left else "ASOF JOIN"
    got = tcon.sql(f"SELECT * FROM ap {join} aq ON ap.s {op} aq.s ORDER BY v").rows()
    assert got == _asof_reference(op, left)


def test_asof_varchar_matches_jax(asof_tables):
    """The JAX package's answers where they are right: ROADMAP item 47's repro and
    >= over the two tables. With > and <=, a probe value that the build side
    lacks ('d') gets a wrong row there (W11)."""
    jcon, tcon = asof_tables
    both(asof_tables, "SELECT * FROM (SELECT 'a' AS s, 1 AS v) p ASOF JOIN "
                      "(SELECT 'a' AS s, 2 AS w) q ON p.s >= q.s")
    both(asof_tables, "SELECT * FROM ap ASOF LEFT JOIN aq ON ap.s >= aq.s ORDER BY v")
    for op in (">", "<="):
        sql = f"SELECT * FROM ap ASOF LEFT JOIN aq ON ap.s {op} aq.s ORDER BY v"
        assert jcon.sql(sql).rows() != _asof_reference(op, True)


def test_asof_varchar_with_an_equality(cons):
    both(cons, "SELECT p.g, p.s, q.s, q.i FROM w p ASOF JOIN w q ON p.g = q.g AND p.s > q.s "
               "WHERE p.i < 20 ORDER BY p.i")


# -- COLLATE ----------------------------------------------------------------------------
COLLATE_SQL = [
    "SELECT 'abc' COLLATE NOCASE = 'ABC'",
    "SELECT 'ABC' = 'abc' COLLATE NOCASE, 'Abc' COLLATE NOCASE < 'abd'",
    "SELECT 'x' COLLATE C = 'X', 'x' COLLATE BINARY = 'x'",
    "SELECT 'é' COLLATE NOACCENT = 'e', 'Émile' COLLATE NOCASE.NOACCENT = 'emile'",
    "SELECT s FROM (VALUES ('b'), ('A'), ('a'), ('B')) t(s) ORDER BY s COLLATE NOCASE, s",
    "SELECT count(*) FROM w WHERE s COLLATE NOCASE = 'ANT'",
]


@pytest.mark.parametrize("sql", COLLATE_SQL)
def test_collate_matches_jax(cons, sql):
    both(cons, sql)


def test_unknown_collation_is_a_catalog_error(cons):
    both(cons, "SELECT 'a' COLLATE klingon = 'A'")
    _, tcon = cons
    with pytest.raises(BindError, match="Collation with name klingon does not exist"):
        tcon.sql("SELECT 'a' COLLATE klingon = 'A'")


# -- INTERVAL → VARCHAR -----------------------------------------------------------------
INTERVAL_TEXT = [
    ("INTERVAL 1 DAY", "1 day"),
    ("INTERVAL '2 months 3 days 04:05:06'", "2 months 3 days 04:05:06"),
    ("INTERVAL '-1 year'", "-1 year"),
    ("INTERVAL '0 days'", "00:00:00"),
    ("INTERVAL '14 months'", "1 year 2 months"),
    ("INTERVAL '1.5 seconds'", "00:00:01.5"),
    ("INTERVAL '-36 hours'", "-36:00:00"),
]


@pytest.mark.parametrize("expr,want", INTERVAL_TEXT)
def test_interval_to_varchar_follows_duckdb(cons, expr, want):
    """DuckDB's text; the JAX package gives the interval's microseconds."""
    jcon, tcon = cons
    sql = f"SELECT CAST({expr} AS VARCHAR)"
    assert tcon.sql(sql).rows() == [(want,)]
    assert outcome(jcon, sql) != ("rows", [(want,)])


def test_interval_column_to_varchar(cons):
    """A column of intervals keeps microseconds only (months folded to 30
    days), so its text shows days and the time of day."""
    _, tcon = cons
    rows = tcon.sql("SELECT CAST(i AS VARCHAR) FROM (SELECT INTERVAL 3 DAY AS i UNION ALL "
                    "SELECT INTERVAL 36 HOUR UNION ALL SELECT INTERVAL '-90 minutes') "
                    "ORDER BY 1").rows()
    assert rows == [("-01:30:00",), ("1 day 12:00:00",), ("3 days",)]


# -- ON CONFLICT DO UPDATE from a column of another type -----------------------------------
def test_on_conflict_update_from_another_type_matches_jax(cons):
    """excluded.v (INTEGER) into w (BIGINT) is cast as an INSERT casts it;
    the Count differs by the updated row (D10: DuckDB counts it)."""
    jcon, tcon = cons
    for c in (jcon, tcon):
        c.sql("CREATE TABLE up (k INTEGER PRIMARY KEY, v INTEGER, w BIGINT, d DECIMAL(9, 2))")
        c.sql("INSERT INTO up VALUES (1, 1, 1, 1.5), (2, 1, 1, 2.5)")
    assert tcon.sql("INSERT INTO up VALUES (2, 5, 7, 0), (3, 4, 4, 0) ON CONFLICT DO UPDATE "
                    "SET w = excluded.v").rows() == [(2,)]
    jcon.sql("INSERT INTO up VALUES (2, 5, 7, 0), (3, 4, 4, 0) ON CONFLICT DO UPDATE "
             "SET w = excluded.v")
    both(cons, "SELECT * FROM up ORDER BY k")
    assert tcon.sql("SELECT w FROM up WHERE k = 2").rows() == [(5,)]
    sql = "INSERT INTO up VALUES (1, 9, 9, 0) ON CONFLICT DO UPDATE SET d = excluded.v"
    jcon.sql(sql)
    tcon.sql(sql)
    both(cons, "SELECT * FROM up ORDER BY k")
    assert tcon.sql("SELECT d FROM up WHERE k = 1").rows() == [(decimal.Decimal("9.00"),)]
