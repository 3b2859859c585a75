"""median, quantile_cont, stddev and var over an ORDER BY or a frame, and
count / sum / avg / min / max (DISTINCT …) over an explicit frame, through
duckdb_tpu_torch (device="cpu"), against a numpy oracle.

The JAX package answers the holistic windows over the whole partition
whatever the ORDER BY or frame (W3) and ignores DISTINCT over a window
(W10), so the port is held to DuckDB's semantics, written here as a numpy
oracle over each row's frame: ROWS frames by position in window order,
RANGE frames (numeric and INTERVAL offsets, CURRENT ROW with its peers)
by the ORDER BY key, ASC and DESC, and the default frame with an ORDER BY
(the partition's start to the current row's last peer). NULL values do
not count; an empty frame, or one of only NULLs, gives NULL, as does
stddev_samp / var_samp of one value. quantile_cont interpolates as
np.quantile does; median over VARCHAR is quantile_disc (W9). DOUBLE
results must match within 1e-9 relative; VARCHAR, integer and DECIMAL
results exactly.

H2: the eight holistic functions with DISTINCT (median, quantile_cont,
stddev, stddev_samp, stddev_pop, var_samp, var_pop, variance) over every
frame above, the whole partition and frames from UNBOUNDED PRECEDING
among them, against the same oracle over each frame's distinct non-NULL
values, as DuckDB answers them; the JAX package ignores DISTINCT (W10).

Also here: the structures behind them (ops/frame_stats.py) against brute
force, and a cancellation case (1e9 + 0.1·k) where sums of x² fail 1e-9.
"""

import datetime
import decimal
import math

import numpy as np
import pytest
import torch

import duckdb_tpu
import duckdb_tpu_torch
from duckdb_tpu_torch.ops.frame_stats import MomentTree, WaveletMatrix

torch.set_num_threads(1)

SIZES = (1, 7, 20, 32)  # rows of each partition g = 0 … 3
D0 = datetime.date(2024, 1, 1)
WORDS = ("ash", "birch", "cedar", "elm", "fir", "oak")


def _make_rows(seed=0):
    rng = np.random.default_rng(seed)
    rows = []
    for g, size in enumerate(SIZES):
        o = rng.permutation(size) * 3 + rng.integers(0, 2, size)  # unique, with gaps
        for k in range(size):
            null = rng.random(4) < 0.2
            rows.append({
                "g": g, "o": int(o[k]), "ot": int(o[k]) // 6,
                "d": D0 + datetime.timedelta(days=int(o[k]) // 2),
                "x": None if null[0] else int(rng.integers(0, 6)),
                "y": None if null[1] else float(np.round(rng.normal(50, 20), 1)),
                "z": None if null[2] else decimal.Decimal(int(rng.integers(0, 500))).scaleb(-2),
                "s": None if null[3] else WORDS[int(rng.integers(0, len(WORDS)))]})
    order = rng.permutation(len(rows))  # insert in no window order
    return [dict(rows[j], i=i) for i, j in enumerate(order)]


ROWS = _make_rows()


def _lit(v):
    if v is None:
        return "NULL"
    if isinstance(v, str):
        return f"'{v}'"
    if isinstance(v, datetime.date):
        return f"DATE '{v.isoformat()}'"
    return str(v)


@pytest.fixture(scope="module")
def tcon():
    con = duckdb_tpu_torch.connect(device="cpu")
    con.sql("CREATE TABLE t (i INTEGER, g INTEGER, o INTEGER, ot INTEGER, d DATE, x INTEGER, "
            "y DOUBLE, z DECIMAL(10, 2), s VARCHAR)")
    cols = ("i", "g", "o", "ot", "d", "x", "y", "z", "s")
    con.sql("INSERT INTO t VALUES " + ", ".join(
        "(" + ", ".join(_lit(r[c]) for c in cols) + ")" for r in ROWS))
    return con


# -- the frames, and the oracle's reading of them -----------------------------------
# name → (ORDER BY column, frame clause with {dir}, kind, offsets)
FRAMES = {
    "rows": ("o", "ROWS BETWEEN 2 PRECEDING AND 1 FOLLOWING", "rows", (-2, 1)),
    "rows_empty": ("o", "ROWS BETWEEN 3 PRECEDING AND 2 PRECEDING", "rows", (-3, -2)),
    "unbounded": ("o", "ROWS BETWEEN CURRENT ROW AND UNBOUNDED FOLLOWING", "rows",
                  (0, math.inf)),
    "range": ("ot", "RANGE BETWEEN 1 PRECEDING AND CURRENT ROW", "range", (-1, 0)),
    "range_empty": ("o", "RANGE BETWEEN 4 FOLLOWING AND 8 FOLLOWING", "range", (4, 8)),
    "interval": ("d", "RANGE BETWEEN INTERVAL '4 days' PRECEDING AND INTERVAL '1 day' "
                      "FOLLOWING", "range", (-4, 1)),
    "default": ("ot", "", "range", (-math.inf, 0)),
    "rows_from_start": ("o", "ROWS BETWEEN UNBOUNDED PRECEDING AND 1 FOLLOWING", "rows",
                        (-math.inf, 1)),
    "range_from_start": ("ot", "RANGE BETWEEN UNBOUNDED PRECEDING AND 2 FOLLOWING", "range",
                         (-math.inf, 2)),
    "whole": (None, "", "whole", None),  # no ORDER BY: the whole partition
}


def _key(r, col):
    v = r[col]
    return (v - D0).days if isinstance(v, datetime.date) else v


def frame_of(r, frame, desc):
    """The rows of r's frame (a list, in window order)."""
    col, _, kind, offsets = FRAMES[frame]
    if kind == "whole":
        return [q for q in ROWS if q["g"] == r["g"]]
    a, b = offsets
    part = sorted((q for q in ROWS if q["g"] == r["g"]), key=lambda q: _key(q, col),
                  reverse=desc)
    if kind == "rows":
        p = part.index(r)
        lo, hi = max(p + a, 0), min(p + b, len(part) - 1) if b != math.inf else len(part) - 1
        return part[lo:hi + 1] if hi >= lo else []
    k = _key(r, col)
    # PRECEDING means toward the start of the window order: smaller keys
    # under ASC, larger under DESC
    lo, hi = (k - b, k - a) if desc else (k + a, k + b)
    return [q for q in part if lo <= _key(q, col) <= hi]


def _clause(frame, desc):
    col, spec, _, _ = FRAMES[frame]
    if col is None:
        return ""
    return f"ORDER BY {col}{' DESC' if desc else ''} {spec}".strip()


def _num(v):
    return float(v) if isinstance(v, decimal.Decimal) else v


HOLISTIC = {
    "median(x)": lambda v: float(np.median(v)),
    "median(y)": lambda v: float(np.median(v)),
    "median(z)": lambda v: float(np.median(v)),
    "median(s)": lambda v: sorted(v)[max(1, math.ceil(len(v) * 0.5)) - 1],
    "quantile_cont(x, 0.25)": lambda v: float(np.quantile(v, 0.25)),
    "quantile_cont(y, 0.9)": lambda v: float(np.quantile(v, 0.9)),
    "stddev(y)": lambda v: float(np.std(v, ddof=1)) if len(v) > 1 else None,
    "stddev_samp(x)": lambda v: float(np.std(v, ddof=1)) if len(v) > 1 else None,
    "stddev_pop(z)": lambda v: float(np.std(v)),
    "variance(y)": lambda v: float(np.var(v, ddof=1)) if len(v) > 1 else None,
    "var_samp(z)": lambda v: float(np.var(v, ddof=1)) if len(v) > 1 else None,
    "var_pop(x)": lambda v: float(np.var(v)),
}


def _arg(expr):
    return expr[expr.index("(") + 1:].split(",")[0].split(")")[0].split()[-1]


def oracle(expr, fn, frame, desc):
    """{row id: the oracle's value of expr over the row's frame}."""
    col = _arg(expr)
    out = {}
    for r in ROWS:
        vals = [_num(q[col]) for q in frame_of(r, frame, desc) if q[col] is not None]
        out[r["i"]] = fn(vals) if vals else None
    return out


def _same(got, want):
    if want is None or got is None:
        return got is want
    if isinstance(want, float):
        return isinstance(got, float) and got == pytest.approx(want, rel=1e-9, abs=1e-12)
    return type(got) is type(want) and got == want


_answers = {}


def _answer(tcon, exprs, frame, desc):
    """{row id: (values of exprs)} of one query over all of exprs (cached, so
    that each parametrized case reads its column of one query)."""
    key = (tuple(exprs), frame, desc)
    if key not in _answers:
        over = f"PARTITION BY g {_clause(frame, desc)}"
        sql = "SELECT i, " + ", ".join(f"{e} OVER ({over})" for e in exprs) + " FROM t"
        _answers[key] = {r[0]: r[1:] for r in tcon.sql(sql).rows()}
    return _answers[key]


@pytest.mark.parametrize("desc", [False, True], ids=["asc", "desc"])
@pytest.mark.parametrize("frame", sorted(FRAMES))
@pytest.mark.parametrize("expr", sorted(HOLISTIC))
def test_holistic_over_frames_match_numpy(tcon, expr, frame, desc):
    exprs = sorted(HOLISTIC)
    got = _answer(tcon, exprs, frame, desc)
    want = oracle(expr, HOLISTIC[expr], frame, desc)
    j = exprs.index(expr)
    bad = [(i, got[i][j], w) for i, w in want.items() if not _same(got[i][j], w)]
    assert not bad, bad[:5]
    if frame in ("rows_empty", "range_empty"):
        assert any(w is None for w in want.values())  # the case has empty frames


DISTINCT = {
    "count(DISTINCT x)": lambda v: len(set(v)),
    "sum(DISTINCT x)": lambda v: sum(set(v)) if v else None,
    "avg(DISTINCT x)": lambda v: sum(set(v)) / len(set(v)) if v else None,
    "sum(DISTINCT z)": lambda v: sum(set(v)) if v else None,
    "avg(DISTINCT z)": lambda v: float(sum(set(v))) / len(set(v)) if v else None,
    "sum(DISTINCT y)": lambda v: float(np.sum(sorted(set(v)))) if v else None,
    "count(DISTINCT s)": lambda v: len(set(v)),
    "min(DISTINCT x)": lambda v: min(v) if v else None,
    "max(DISTINCT y)": lambda v: max(v) if v else None,
}


def distinct_oracle(expr, frame, desc):
    col = _arg(expr)
    out = {}
    for r in ROWS:
        vals = [q[col] for q in frame_of(r, frame, desc) if q[col] is not None]
        w = DISTINCT[expr](vals)
        if expr.startswith("count") or w is None:
            out[r["i"]] = w
        elif col == "x" and expr.startswith("sum"):
            out[r["i"]] = int(w)
        else:
            out[r["i"]] = w if isinstance(w, (decimal.Decimal, int)) or expr.startswith(
                ("min", "max")) else float(w)
    return out


@pytest.mark.parametrize("desc", [False, True], ids=["asc", "desc"])
@pytest.mark.parametrize("frame", sorted(set(FRAMES) - {"default"}))
@pytest.mark.parametrize("expr", sorted(DISTINCT))
def test_distinct_over_frames_match_numpy(tcon, expr, frame, desc):
    exprs = sorted(DISTINCT)
    got = _answer(tcon, exprs, frame, desc)
    want = distinct_oracle(expr, frame, desc)
    j = exprs.index(expr)
    bad = [(i, got[i][j], w) for i, w in want.items() if not _same(got[i][j], w)]
    assert not bad, bad[:5]


def test_distinct_over_a_rows_frame_with_repeats_matches_numpy():
    """Runs of repeated values, NULLs among them, in several partitions:
    each frame counts and sums its distinct values once (a numpy oracle of
    np.unique per frame). The JAX package ignores DISTINCT here (W10)."""
    rng = np.random.default_rng(3)
    n = 400
    g = rng.integers(0, 5, n)
    v = np.repeat(rng.integers(0, 9, n // 4), 4)  # runs of four equal values
    v = np.where(rng.random(n) < 0.1, -1, v)  # -1: NULL
    src = "(VALUES " + ", ".join(
        f"({i}, {g[i]}, {'NULL' if v[i] < 0 else v[i]})" for i in range(n)) + ") t(i, g, v)"
    over = "(PARTITION BY g ORDER BY i ROWS BETWEEN 6 PRECEDING AND 2 FOLLOWING)"
    q = (f"SELECT i, count(DISTINCT v) OVER {over}, sum(DISTINCT v) OVER {over}, "
         f"avg(DISTINCT v) OVER {over} FROM {src} ORDER BY i")
    got = duckdb_tpu_torch.connect(device="cpu").sql(q).rows()
    for i, cnt, s, a in got:
        part = np.flatnonzero(g == g[i])
        p = int(np.searchsorted(part, i))
        frame = v[part[max(p - 6, 0):p + 3]]
        u = np.unique(frame[frame >= 0])
        assert cnt == len(u)
        assert s == (int(u.sum()) if len(u) else None)
        assert a == (pytest.approx(float(u.mean()), rel=1e-12) if len(u) else None)
    small = ("SELECT o, sum(DISTINCT x) OVER (ORDER BY o ROWS 1 PRECEDING) FROM "
             "(VALUES (1, 1), (1, 2), (2, 3)) t(x, o) ORDER BY o")
    assert duckdb_tpu_torch.connect(device="cpu").sql(small).rows() == [(1, 1), (2, 1), (3, 3)]
    assert duckdb_tpu.connect().sql(small).rows() == [(1, 1), (2, 2), (3, 3)]  # W10


def test_moments_survive_cancellation():
    """Values 1e9 + 0.1·k: the frame's variance is about 1e-2 while x² is
    about 1e18, so differences of prefix sums of x and x² (shown below) miss
    by far more than 1e-9; the segment tree of shifted sums holds 1e-9
    against numpy's two-pass variance."""
    k = np.arange(300)
    x = 1e9 + 0.1 * k
    src = "(VALUES " + ", ".join(f"({i}, {float(x[i])!r})" for i in k) + ") t(k, x)"
    sql = (f"SELECT k, var_samp(x) OVER (ORDER BY k ROWS BETWEEN 3 PRECEDING AND CURRENT ROW), "
           f"stddev_pop(x) OVER (ORDER BY k), var_pop(x) OVER (ORDER BY k DESC RANGE BETWEEN "
           f"10 PRECEDING AND 5 FOLLOWING) FROM {src} ORDER BY k")
    got = duckdb_tpu_torch.connect(device="cpu").sql(sql).rows()
    worst_naive = 0.0
    s1, s2 = np.cumsum(x), np.cumsum(x * x)
    for i, vs, sp, vp in got:
        w = x[max(i - 3, 0):i + 1]
        want = float(np.var(w, ddof=1)) if len(w) > 1 else None
        assert (vs is None) if want is None else vs == pytest.approx(want, rel=1e-9)
        assert sp == pytest.approx(float(np.std(x[:i + 1])), rel=1e-9, abs=1e-12)
        assert vp == pytest.approx(float(np.var(x[max(i - 5, 0):i + 11])), rel=1e-9)
        if i >= 3:
            n = 4
            a, b = s1[i] - s1[i - 4], s2[i] - s2[i - 4]
            naive = (b - a * a / n) / (n - 1)
            worst_naive = max(worst_naive, abs(naive - want) / want)
    assert worst_naive > 1e-9


HOLISTIC_DISTINCT = {
    "median(DISTINCT x)": lambda v: float(np.median(v)),
    "median(DISTINCT z)": lambda v: float(np.median(v)),
    "median(DISTINCT s)": lambda v: v[max(1, math.ceil(len(v) * 0.5)) - 1],
    "quantile_cont(DISTINCT x, 0.25)": lambda v: float(np.quantile(v, 0.25)),
    "quantile_cont(DISTINCT y, 0.9)": lambda v: float(np.quantile(v, 0.9)),
    "stddev(DISTINCT x)": lambda v: float(np.std(v, ddof=1)) if len(v) > 1 else None,
    "stddev_samp(DISTINCT y)": lambda v: float(np.std(v, ddof=1)) if len(v) > 1 else None,
    "stddev_pop(DISTINCT z)": lambda v: float(np.std(v)),
    "var_samp(DISTINCT x)": lambda v: float(np.var(v, ddof=1)) if len(v) > 1 else None,
    "var_pop(DISTINCT y)": lambda v: float(np.var(v)),
    "variance(DISTINCT z)": lambda v: float(np.var(v, ddof=1)) if len(v) > 1 else None,
}


def distinct_values(vals):
    """A frame's distinct non-NULL values, sorted (floats as floats)."""
    return sorted({_num(v) for v in vals if v is not None})


@pytest.mark.parametrize("desc", [False, True], ids=["asc", "desc"])
@pytest.mark.parametrize("frame", sorted(FRAMES))
@pytest.mark.parametrize("expr", sorted(HOLISTIC_DISTINCT))
def test_h2_holistic_distinct_over_frames_match_numpy(tcon, expr, frame, desc):
    exprs = sorted(HOLISTIC_DISTINCT)
    got = _answer(tcon, exprs, frame, desc)
    col = _arg(expr)
    j = exprs.index(expr)
    bad = []
    for r in ROWS:
        vals = distinct_values(q[col] for q in frame_of(r, frame, desc))
        want = HOLISTIC_DISTINCT[expr](vals) if vals else None
        if not _same(got[r["i"]][j], want):
            bad.append((r["i"], got[r["i"]][j], want))
    assert not bad, bad[:5]


def _repeats_table(n=400, seed=5):
    """Runs of repeated values with NULLs among them, in five partitions:
    (i, g, v) with v None where NULL."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 5, n)
    v = np.repeat(rng.integers(0, 12, n // 4), 4).astype(float) * 0.5
    v = np.where(rng.random(n) < 0.1, np.nan, v)
    return [(i, int(g[i]), None if np.isnan(v[i]) else float(v[i])) for i in range(n)]


REPEAT_FRAMES = {
    "moving": ("ORDER BY i ROWS BETWEEN 6 PRECEDING AND 2 FOLLOWING", lambda p, i: (p - 6, p + 2)),
    "moving_desc": ("ORDER BY i DESC ROWS BETWEEN 3 PRECEDING AND CURRENT ROW",
                    lambda p, i: (p - 3, p)),
    "from_start": ("ORDER BY i ROWS BETWEEN UNBOUNDED PRECEDING AND 1 FOLLOWING",
                   lambda p, i: (0, p + 1)),
    "running": ("ORDER BY i", lambda p, i: (0, p)),
    "whole": ("", lambda p, i: (0, 10 ** 9)),
}


@pytest.mark.parametrize("frame", sorted(REPEAT_FRAMES))
def test_h2_holistic_distinct_with_repeats_and_nulls_match_numpy(frame):
    """Runs of four equal values and NULLs: each function over each frame's
    np.unique of its non-NULL values (1e-9 relative)."""
    rows = _repeats_table()
    src = "(VALUES " + ", ".join(f"({i}, {g}, {'NULL' if v is None else v})"
                                 for i, g, v in rows) + ") t(i, g, v)"
    spec, span = REPEAT_FRAMES[frame]
    fns = {"median": np.median, "quantile_cont(DISTINCT v, 0.3)": None,
           "stddev_pop": np.std, "var_samp": None}
    over = f"(PARTITION BY g {spec})"
    sql = (f"SELECT i, median(DISTINCT v) OVER {over}, quantile_cont(DISTINCT v, 0.3) OVER "
           f"{over}, stddev_pop(DISTINCT v) OVER {over}, var_samp(DISTINCT v) OVER {over} "
           f"FROM {src} ORDER BY i")
    got = duckdb_tpu_torch.connect(device="cpu").sql(sql).rows()
    assert len(fns) == 4 and len(got) == len(rows)
    v = np.array([np.nan if r[2] is None else r[2] for r in rows])
    g = np.array([r[1] for r in rows])
    desc = "DESC" in spec
    for i, med, q3, sp, vs in got:
        part = np.flatnonzero(g == g[i])[::-1] if desc else np.flatnonzero(g == g[i])
        p = int(np.flatnonzero(part == i)[0])
        a, b = span(p, i)
        frame_v = v[part[max(a, 0):b + 1]]
        u = np.unique(frame_v[~np.isnan(frame_v)])
        want = (float(np.median(u)), float(np.quantile(u, 0.3)), float(np.std(u)),
                float(np.var(u, ddof=1)) if len(u) > 1 else None) if len(u) else (None,) * 4
        for x, w in zip((med, q3, sp, vs), want):
            assert (x is None) if w is None else x == pytest.approx(w, rel=1e-9, abs=1e-12), \
                (i, x, w)


def test_h2_forms_where_distinct_changes_the_answer():
    """DISTINCT changes these answers: the port's are over the distinct
    values, the JAX package's over every row (W10)."""
    setup = ("CREATE TABLE t AS SELECT * FROM (VALUES (1, 2.5, 1), (1, 0.5, 2), (1, 0.5, 3), "
             "(2, 3.0, 1), (2, 3.0, 2), (2, NULL, 3), (2, 5.0, 4)) v(a, c, o)")
    cons = [duckdb_tpu_torch.connect(device="cpu"), duckdb_tpu.connect()]
    for c in cons:
        c.sql(setup)
    cases = {
        "median(DISTINCT a) OVER ()": [1.5] * 7,
        "stddev(DISTINCT c) OVER ()": [float(np.std([0.5, 2.5, 3.0, 5.0], ddof=1))] * 7,
        "quantile_cont(DISTINCT c, 0.5) OVER (PARTITION BY a)": [1.5] * 3 + [4.0] * 4,
        "var_pop(DISTINCT c) OVER (PARTITION BY a ORDER BY o ROWS BETWEEN 1 PRECEDING AND "
        "1 FOLLOWING)": [1.0, 1.0, 0.0, 0.0, 0.0, 1.0, 0.0],
        "median(DISTINCT c) OVER (PARTITION BY a ORDER BY o ROWS BETWEEN 1 PRECEDING AND "
        "1 FOLLOWING)": [1.5, 1.5, 0.5, 3.0, 3.0, 4.0, 5.0],
    }
    for expr, want in cases.items():
        sql = f"SELECT {expr} FROM t ORDER BY a, o"
        got = [r[0] for r in cons[0].sql(sql).rows()]
        assert got == pytest.approx(want, rel=1e-12), expr
        assert [r[0] for r in cons[1].sql(sql).rows()] != pytest.approx(want, rel=1e-9), expr


def test_h2_distinct_moments_survive_cancellation_and_drift():
    """Values 1e9 + 0.1·(k // 2), each twice, 30,000 of them in one
    partition: var_samp(DISTINCT x) over a moving frame and over the
    default frame holds 1e-9 against numpy's two-pass variance of each
    frame's distinct values. The frames drift far from the partition's
    first value, so sums of (x - pivot) and (x - pivot)² about one pivot a
    partition (shown below) miss 1e-9; the pivots inside each frame do not."""
    con = duckdb_tpu_torch.connect(device="cpu")
    con.sql("CREATE TABLE c AS SELECT range AS k, 1e9 + 0.1 * (range // 2) AS x "
            "FROM range(30000)")
    sql = ("SELECT k, x, var_samp(DISTINCT x) OVER (ORDER BY k ROWS BETWEEN 11 PRECEDING AND "
           "CURRENT ROW), stddev_pop(DISTINCT x) OVER (ORDER BY k) FROM c ORDER BY k")
    got = con.sql(sql).rows()
    x = np.array([r[1] for r in got])
    assert len(np.unique(x)) == 15000
    worst_pivot = 0.0
    for k, _, vs, sp in got:
        u = np.unique(x[max(k - 11, 0):k + 1])
        want = float(np.var(u, ddof=1)) if len(u) > 1 else None
        assert (vs is None) if want is None else vs == pytest.approx(want, rel=1e-9)
        if k % 97 == 0:  # the running frame's std, sampled
            assert sp == pytest.approx(float(np.std(np.unique(x[:k + 1]))), rel=1e-9,
                                       abs=1e-12)
        if want is not None and k > 20000:
            d = u - x[0]
            m2 = float((d * d).sum() - d.sum() ** 2 / len(u))
            worst_pivot = max(worst_pivot, abs(m2 / (len(u) - 1) - want) / want)
    assert worst_pivot > 1e-9


# -- ops/frame_stats.py against brute force ------------------------------------------
@pytest.mark.parametrize("n,bits", [(1, 1), (2, 1), (37, 3), (500, 6), (1000, 10)])
def test_wavelet_matrix_matches_brute_force(n, bits):
    rng = np.random.default_rng(n)
    keys = rng.integers(0, 2 ** bits, n)
    wi = rng.integers(-2 ** 62, 2 ** 62, n)  # int64 sums wrap, as the engine's do
    wf = rng.normal(size=n)
    wm = WaveletMatrix(torch.tensor(keys), bits, [torch.tensor(wi), torch.tensor(wf)])
    q = 300
    lo = rng.integers(0, n + 1, q)
    hi = np.minimum(n, lo + rng.integers(0, 60, q))
    k = np.array([rng.integers(0, max(b - a, 1)) for a, b in zip(lo, hi)])
    t = rng.integers(0, 2 ** bits, q)
    kth = wm.kth(torch.tensor(lo), torch.tensor(hi), torch.tensor(k)).numpy()
    cnt, (si, sf) = wm.count_below(torch.tensor(lo), torch.tensor(hi), torch.tensor(t))
    for j in range(q):
        span = keys[lo[j]:hi[j]]
        if len(span):
            assert kth[j] == np.sort(span)[k[j]]
        m = span < t[j]
        assert int(cnt[j]) == int(m.sum())
        with np.errstate(over="ignore"):
            assert int(si[j]) == int(wi[lo[j]:hi[j]][m].sum(dtype=np.int64))
        assert float(sf[j]) == pytest.approx(float(wf[lo[j]:hi[j]][m].sum()), abs=1e-12)


@pytest.mark.parametrize("n,bits,fbits", [(1, 1, 1), (37, 3, 4), (500, 6, 5), (1000, 9, 8)])
def test_wavelet_matrix_moments_and_filtered_kth_match_brute_force(n, bits, fbits):
    """`moments_below` against two-pass moments of the keys below t, and
    `kth` with a threshold against the k-th smallest key among the span's
    rows whose filter key is below t."""
    rng = np.random.default_rng(n + 1)
    keys = rng.integers(0, 2 ** bits, n)
    fkeys = rng.integers(0, 2 ** fbits, n)
    x = rng.normal(size=n) * 5 + 1e6
    valid = rng.random(n) < 0.85
    wm = WaveletMatrix(torch.tensor(keys), bits, moments=(torch.tensor(x), torch.tensor(valid),
                                                          n.bit_length() + 1),
                       filter=(torch.tensor(fkeys), fbits))
    q = 300
    lo = rng.integers(0, n + 1, q)
    hi = np.minimum(n, lo + rng.integers(0, 80, q))
    t = rng.integers(0, 2 ** bits, q)
    ft = rng.integers(0, 2 ** fbits - 1, q)  # a filter key of all ones never counts
    cnt, s, qq = wm.moments_below(torch.tensor(lo), torch.tensor(hi), torch.tensor(t))
    fcount = [int(((fkeys[a:b]) < c).sum()) for a, b, c in zip(lo, hi, ft)]
    k = np.array([rng.integers(0, max(c, 1)) for c in fcount])
    kth = wm.kth(torch.tensor(lo), torch.tensor(hi), torch.tensor(k), torch.tensor(ft)).numpy()
    for j in range(q):
        span = slice(lo[j], hi[j])
        v = x[span][(keys[span] < t[j]) & valid[span]]
        assert int(cnt[j]) == len(v)
        if len(v):
            m2 = float(qq[j] - s[j] ** 2 / cnt[j])
            assert m2 == pytest.approx(float(((v - v.mean()) ** 2).sum()), rel=1e-9, abs=1e-9)
        if fcount[j]:
            assert kth[j] == np.sort(keys[span][fkeys[span] < ft[j]])[k[j]]


@pytest.mark.parametrize("n", [1, 2, 3, 64, 65, 777])
def test_moment_tree_matches_two_pass(n):
    rng = np.random.default_rng(n)
    x = rng.normal(size=n) * 3 + 1e6
    valid = rng.random(n) < 0.8
    tree = MomentTree(torch.tensor(x), torch.tensor(valid), n.bit_length() + 1)
    lo = rng.integers(0, n + 1, 400)
    hi = np.minimum(n, lo + rng.integers(0, n + 1, 400))
    cnt, s, q = tree.query(torch.tensor(lo), torch.tensor(hi))
    for j in range(400):
        v = x[lo[j]:hi[j]][valid[lo[j]:hi[j]]]
        assert int(cnt[j]) == len(v)
        if len(v):
            m2 = float(q[j] - s[j] ** 2 / cnt[j])
            assert m2 == pytest.approx(float(((v - v.mean()) ** 2).sum()), rel=1e-9, abs=1e-9)


# -- chip_smoke.py phase 26's numpy oracle against the port on the CPU -------------------
@pytest.fixture(scope="module")
def sf001(tmp_path_factory):
    from duckdb_tpu_torch.testing.tpch_gen import write_tables

    root = str(tmp_path_factory.mktemp("tpch_gen_frames"))
    write_tables(root, 0.01, seed=7)
    con = duckdb_tpu_torch.connect(device="cpu")
    con.load_tpch(root, tables=["lineitem", "orders"])
    return root, con


@pytest.mark.parametrize("name", ["win_median_rows", "win_quantile_running", "win_stddev_30d",
                                  "win_var_pop_orders", "win_distinct_rows",
                                  "win_median_distinct_rows", "win_stddev_distinct_rows"])
def test_phase26_windows_match_the_chip_oracle(sf001, name):
    """Phase 26's seven windows at SF 0.01 on the CPU: the groups and the
    read-back rows equal chip_smoke's numpy oracle (written apart from the
    port: sorted frames, exact integer moments, bitmask distinct sets),
    and the outer count(*) takes the dense route."""
    import chip_smoke as CS

    root, con = sf001
    cols = CS.phase26_columns(root)
    want, want_rows = CS.phase26_want(cols, name, CS.phase26_oracle(cols, name))
    grouped, readback = CS.phase26_sql(name)
    con.routes.clear()
    assert CS.rows_match(con.sql(grouped).rows(), want) == ""
    assert dict(con.routes) == {"window": 1, "dense": 1}
    got = con.sql(readback).rows()
    assert want_rows and CS.rows_match(got, want_rows) == ""


def test_frame_windows_stay_on_one_device_under_shards():
    """With num_shards = 8 over 20,000 rows the windows over frames run on
    one device (no sharded_window route) and answer as with one shard."""
    con = duckdb_tpu_torch.connect(device="cpu")
    con.sql("CREATE TABLE r AS SELECT range AS i, range % 7 AS g, (range * 37) % 101 AS v "
            "FROM range(20000)")
    sql = ("SELECT i, median(v) OVER (PARTITION BY g ORDER BY i ROWS BETWEEN 5 PRECEDING AND "
           "CURRENT ROW), var_pop(v) OVER (PARTITION BY g ORDER BY i), count(DISTINCT v) OVER "
           "(PARTITION BY g ORDER BY i ROWS BETWEEN 9 PRECEDING AND CURRENT ROW) FROM r")
    one = sorted(con.sql(sql).rows())
    con.sql("SET num_shards = 8")
    con.routes.clear()
    assert sorted(con.sql(sql).rows()) == one
    assert con.routes["window"] == 1 and "sharded_window" not in con.routes
