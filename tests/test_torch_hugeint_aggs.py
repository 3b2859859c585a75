"""HUGEINT values past 64 bits and the variance family in duckdb_tpu_torch
(device="cpu"), held to Python's exact arithmetic (ROADMAP Queue 3, F13
and F18).

F13: sum, min, max and avg over HUGEINT keep both halves of every value,
on the fused route (ungrouped and over ≤ 256 dense slots: the high halves
summed as more int64 vectors through the grouped sum) and on the general
route (min and max compare the (hi, lo) pair there; the fused route hands
them over). A sum that leaves int128 raises OutOfRangeException, as
DuckDB's does. The HUGEINT arithmetic that makes such values (+ - * // %,
negation, abs, sign, CASE, coalesce, greatest/least, casts) is exact too.
The JAX package keeps only the low halves: the repros assert that it
still differs.

F18: stddev, stddev_pop, var_samp, var_pop and variance take two passes
(each group's mean, then its squared deviations), so equal values give
exactly 0, as DuckDB's Welford update does; random groups whose mean is
not far above their spread stay within 1e-9 relative of the JAX
package's.
"""

import random

import numpy as np
import pytest
import torch

import duckdb_tpu
import duckdb_tpu_torch
from duckdb_tpu_torch import errors as TE

torch.set_num_threads(1)

E20 = 100000000000000000000
I128_MAX = (1 << 127) - 1


def _con():
    return duckdb_tpu_torch.connect(device="cpu")


def _both(sql):
    out = []
    for con in (duckdb_tpu.connect(), _con()):
        try:
            out.append(con.sql(sql).rows())
        except Exception as e:  # noqa: BLE001 — the outcome is compared
            out.append(type(e).__name__)
    return out


@pytest.mark.parametrize("sql,want", [
    ("SELECT sum(h), min(h), max(h) FROM (VALUES (500000000000000000000001), "
     "(-300000000000000000000007), (2)) t(h)",
     [(199999999999999999999996, -300000000000000000000007, 500000000000000000000001)]),
    ("SELECT sum(CAST(x AS HUGEINT) * 100000000000000000000) FROM range(3) t(x)",
     [(300000000000000000000,)]),
    ("SELECT max(CAST(a AS HUGEINT) * 100000000000000000000) FROM (VALUES (1), (2), (3)) t(a)",
     [(300000000000000000000,)]),
])
def test_f13_repros(sql, want):
    jax, port = _both(sql)
    assert port == want
    assert jax != want


def _table(con, rows):
    con.sql("CREATE TABLE t (g INTEGER, a BIGINT)")
    con.sql("INSERT INTO t VALUES " + ", ".join(f"({g}, {a})" for g, a in rows))
    return con


def _rows(seed, n=300, groups=7):
    rng = random.Random(seed)
    return [(rng.randrange(groups), rng.randrange(-10**12, 10**12)) for _ in range(n)]


def _h(a):
    """The query's value of a row: a · 10^20 + 7 (past 64 bits)."""
    return a * E20 + 7


H = "(CAST(a AS HUGEINT) * 100000000000000000000 + 7)"


def _py_aggs(vals):
    return (sum(vals), min(vals), max(vals), sum(vals) / len(vals))


@pytest.mark.parametrize("route", ["fused", "general"])
@pytest.mark.parametrize("grouped", [False, True])
def test_f13_sum_avg_min_max_against_python(route, grouped):
    rows = _rows(11)
    con = _table(_con(), rows)
    extra = ", median(a)" if route == "general" else ""
    aggs = f"sum({H}), avg({H})" + ("" if route == "fused" else f", min({H}), max({H})")
    if grouped:
        sql = f"SELECT g, {aggs}{extra} FROM t GROUP BY g ORDER BY g"
    else:
        sql = f"SELECT {aggs}{extra} FROM t"
    con.routes.clear()
    got = con.sql(sql).rows()
    if route == "fused":
        assert "general_aggregate" not in con.routes and con.routes["dense"] >= 1, con.routes
    else:
        assert con.routes["general_aggregate"] >= 1
    groups = sorted({g for g, _ in rows}) if grouped else [None]
    assert len(got) == len(groups)
    for g, r in zip(groups, got):
        vals = [_h(a) for gg, a in rows if g is None or gg == g]
        s, mn, mx, avg = _py_aggs(vals)
        r = r[1:] if grouped else r
        assert r[0] == s and isinstance(r[0], int)
        assert abs(r[1] - avg) <= 1e-12 * abs(avg)
        if route == "general":
            assert (r[2], r[3]) == (mn, mx)


def test_f13_min_max_take_the_general_route():
    """The fused route hands a HUGEINT min/max over; the (hi, lo) pair is
    compared on the general route (ungrouped and grouped)."""
    rows = _rows(13, n=120, groups=3)
    con = _table(_con(), rows)
    for sql, groups in ((f"SELECT min({H}), max({H}) FROM t", [None]),
                        (f"SELECT g, min({H}), max({H}) FROM t GROUP BY g ORDER BY g",
                         sorted({g for g, _ in rows}))):
        con.routes.clear()
        got = con.sql(sql).rows()
        assert con.routes["general_aggregate"] == 1
        for g, r in zip(groups, got):
            vals = [_h(a) for gg, a in rows if g is None or gg == g]
            assert r[-2:] == (min(vals), max(vals))


def test_f13_values_differ_only_in_the_low_half():
    """Equal high halves, low halves past 2^63 as unsigned: min/max read
    the low half unsigned, sum carries into the high half."""
    vals = [(5 << 64) + (1 << 63) + 3, (5 << 64) + 2, (5 << 64) + (1 << 64) - 1, -(5 << 64) + 1]
    sql = ("SELECT sum(h), min(h), max(h) FROM (VALUES " +
           ", ".join(f"({v})" for v in vals) + ") t(h)")
    assert _con().sql(sql).rows() == [(sum(vals), min(vals), max(vals))]


@pytest.mark.parametrize("extra", ["", ", median(a)"])
def test_f13_sum_past_int128_raises(extra):
    sql = (f"SELECT sum(CAST(a AS HUGEINT) + 85070591730234615865843651857942052864){extra} "
           "FROM range(3) t(a)")
    with pytest.raises(TE.OutOfRangeException):
        _con().sql(sql).rows()
    # two of them fit
    sql2 = sql.replace("range(3)", "range(1)")
    assert _con().sql(sql2).rows()[0][0] == 1 << 126


def _wide_values(seed, n=40):
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        bits = rng.choice([10, 62, 63, 64, 65, 90, 120])
        out.append(rng.randrange(-(1 << bits), 1 << bits))
    return out + [0, 1, -1, 1 << 64, -(1 << 64), (1 << 63), -(1 << 63) - 1]


def _trunc_div(x, y):
    q = abs(x) // abs(y)
    return q if (x < 0) == (y < 0) else -q


@pytest.mark.parametrize("op", ["+", "-", "*", "//", "%"])
def test_hugeint_arithmetic_against_python(op):
    xs, ys = _wide_values(1), _wide_values(2)
    pairs = list(zip(xs, ys))
    sql = ("SELECT x " + op + " y FROM (VALUES " +
           ", ".join(f"(CAST({x} AS HUGEINT), CAST({y} AS HUGEINT))" for x, y in pairs) +
           ") t(x, y)")
    want = []
    for x, y in pairs:
        if op in ("//", "%") and y == 0:
            want.append(None)
            continue
        v = {"+": x + y, "-": x - y, "*": x * y, "//": _trunc_div(x, y) if y else None,
             "%": x - _trunc_div(x, y) * y if y else None}[op]
        want.append(v)
    if any(v is not None and not -(1 << 127) <= v <= I128_MAX for v in want):
        with pytest.raises(TE.OutOfRangeException):
            _con().sql(sql).rows()
        keep = [(x, y) for (x, y), v in zip(pairs, want)
                if v is None or -(1 << 127) <= v <= I128_MAX]
        sql = ("SELECT x " + op + " y FROM (VALUES " +
               ", ".join(f"(CAST({x} AS HUGEINT), CAST({y} AS HUGEINT))" for x, y in keep) +
               ") t(x, y)")
        want = [v for v in want if v is None or -(1 << 127) <= v <= I128_MAX]
    assert [r[0] for r in _con().sql(sql).rows()] == want


def test_hugeint_unary_and_conditional_forms():
    xs = _wide_values(3, n=10)
    src = "(VALUES " + ", ".join(f"(CAST({x} AS HUGEINT))" for x in xs) + ") t(x)"
    got = _con().sql(f"SELECT -x, abs(x), sign(x), greatest(x, 5), least(x, 5), "
                     f"coalesce(NULL, x), nullif(x, 0), CASE WHEN x > 0 THEN x ELSE -1 END, "
                     f"CAST(x AS VARCHAR), TRY_CAST(x AS BIGINT) FROM {src}").rows()
    for x, r in zip(xs, got):
        assert r == (-x, abs(x), (x > 0) - (x < 0), max(x, 5), min(x, 5), x,
                     None if x == 0 else x, x if x > 0 else -1, str(x),
                     x if -(1 << 63) <= x < (1 << 63) else None)
    with pytest.raises(TE.ConversionException):
        _con().sql("SELECT CAST(CAST(9223372036854775807 AS HUGEINT) + 1 AS BIGINT)").rows()


def test_hugeint_overflow_raises():
    for sql in ("SELECT CAST(9223372036854775807 AS HUGEINT) * 9223372036854775807 * 4",
                "SELECT x * x * 4 FROM (VALUES (CAST(9223372036854775807 AS HUGEINT))) t(x)",
                "SELECT x + x FROM (VALUES (170141183460469231731687303715884105727)) t(x)",
                "SELECT -x - 2 FROM (VALUES (170141183460469231731687303715884105727)) t(x)"):
        with pytest.raises(TE.OutOfRangeException):
            _con().sql(sql).rows()


# -- F18: the variance family ----------------------------------------------------------
VARIANCE = ("stddev", "stddev_samp", "stddev_pop", "var_samp", "var_pop", "variance")


@pytest.mark.parametrize("fn", VARIANCE)
def test_f18_equal_values_give_exactly_zero(fn):
    rng = np.random.default_rng(5)
    for v in (-0.984, 0.1, 1e-3, 123456.789):
        n = int(rng.integers(2, 300))
        vals = ", ".join(f"({g}, {v})" for g in rng.integers(0, 4, n))
        grouped = _con().sql(f"SELECT g, {fn}(x) FROM (VALUES {vals}) t(g, x) GROUP BY g").rows()
        assert all(r[1] in (0.0, None) for r in grouped), grouped
        (whole,) = _con().sql(f"SELECT {fn}(x) FROM (VALUES {vals}) t(g, x)").rows()
        assert whole == (0.0,)
        # as DOUBLE and over the DECIMAL of the fuzzer's literal
        (dbl,) = _con().sql(f"SELECT {fn}(CAST(x AS DOUBLE)) FROM (VALUES {vals}) t(g, x)").rows()
        assert dbl == (0.0,)


def test_f18_the_fuzzers_form_differs_from_the_jax_package():
    """stddev(-0.984) per group of the fuzzer's t1: 0 here; the JAX package's
    summation gives 0 for this query but not for every one (its formula is
    Σx² − (Σx)²/n)."""
    from duckdb_tpu_torch.testing.fuzz import SETUP

    con = _con()
    for stmt in SETUP:
        con.sql(stmt)
    got = con.sql("SELECT g, stddev(-0.984) FROM t1 GROUP BY g ORDER BY g").rows()
    assert [r[1] for r in got] == [0.0] * 5 + [None]
    sql = ("SELECT g, stddev(CAST(g AS DECIMAL(12,3)) - 1.085) FROM t1 GROUP BY g "
           "ORDER BY 1 DESC")
    assert [r[1] for r in con.sql(sql).rows()] == [0.0] * 5 + [None]
    jcon = duckdb_tpu.connect()
    for stmt in SETUP:
        jcon.sql(stmt)
    assert [r[1] for r in jcon.sql(sql).rows()] != [0.0] * 5 + [None]


@pytest.mark.parametrize("fn", VARIANCE)
def test_f18_random_groups_match_the_jax_package(fn):
    """Groups whose mean (about 13) is a few spreads (about 1.7) above zero,
    made by a multiplicative hash of range so that both packages build them
    fast: within 1e-9 relative of the JAX package's and of numpy's."""
    src = ("(SELECT range % 6 AS g, 10.0 + ((range * 7919 + 13) % 997) * 0.006 AS x "
           "FROM range(400)) t")
    sql = f"SELECT g, {fn}(x) FROM {src} GROUP BY g ORDER BY g"
    jax, port = _both(sql)
    assert len(jax) == len(port) == 6
    r = np.arange(400)
    g, x = r % 6, 10.0 + ((r * 7919 + 13) % 997) * 0.006
    for (gj, vj), (gp, vp) in zip(jax, port):
        assert gj == gp and abs(vj - vp) <= 1e-9 * abs(vj)
        ddof = 0 if fn.endswith("_pop") else 1
        want = x[g == gp].var(ddof=ddof)
        want = want ** 0.5 if fn.startswith("stddev") else want
        assert abs(vp - want) <= 1e-9 * want


def test_hugeint_in_list_compares_both_halves():
    """1 and 2^64 + 1 share their low halves: IN tells them apart."""
    got = _con().sql("SELECT x IN (18446744073709551617, 5) FROM (VALUES (CAST(1 AS HUGEINT)), "
                     "(18446744073709551617), (CAST(5 AS HUGEINT))) t(x)").rows()
    assert got == [(False,), (True,), (True,)]
