"""Window functions: one sort, then segmented scans, as torch ops.

As in the JAX package (duckdb_tpu/execution/window_exec.py): the rows are
ordered once by (dead, PARTITION BY keys, ORDER BY keys) with a stable
sort, every window function is a composition of scans over partition
(segment) and peer boundaries, and the results go back to row order
through the sort's permutation (no index repeats, so no scatter has two
writers). Windows with one PARTITION BY and ORDER BY share one sort.
Each row's partition and peer-run bounds come from one cumsum of the
boundary flags and a table of run starts and ends (`_run_bounds`).

Scans: torch has no segmented associative scan. An int64 (and DECIMAL)
sum is cumsum minus its value at the segment's start, exact and wrapping
as the reference's does; a DOUBLE sum, min and max are log-step
(Hillis-Steele) scans, ceil(log2(longest partition)) passes of one shift
each, so no partition's sum carries another's rounding and no value is
offset (an offset by a segment id would overflow int64).

Frames reduce to each row's [lo, hi] span in sorted order: ROWS offsets
by index arithmetic, RANGE offsets by a per-row binary search of the
order key inside its partition (a fixed loop of log2(longest partition)
gathers), INTERVAL offsets by calendar months and days. Span sums are
differences of the segmented prefix sums; span min/max read a sparse table
built level by level only up to log2(longest span), so ROWS BETWEEN 3
PRECEDING AND 3 FOLLOWING keeps 3 levels of n values, not log2(n).

median, quantile_cont, stddev and var run over whole partitions only (the
planner refuses them with an ORDER BY or a frame, ROADMAP item 44); the
moments of a DECIMAL are taken of its values, not its scaled integers.

Where the JAX package is wrong the port follows SQL: FILTER drops the rows
it is not TRUE for (W8), DISTINCT counts each value of a partition once, at
its first row in window order (W10), and median over VARCHAR is DuckDB's
quantile_disc (W9). HUGEINT values keep both int64 halves through the sort,
the gathers and the scans; a running sum carries between them.
"""

from __future__ import annotations

import decimal
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from duckdb_tpu_torch.blocks import Column
from duckdb_tpu_torch.blocks.nested import UNSORTED_DICT_IDS
from duckdb_tpu_torch.ops import sort as S
from duckdb_tpu_torch.ops.scan import cummax, cummin
from duckdb_tpu_torch.planner import bound as B
from duckdb_tpu_torch.planner import plan as P
from duckdb_tpu_torch.planner.bound import BindError, bcast
from duckdb_tpu_torch.types import TypeId

_I64_MIN = torch.iinfo(torch.int64).min
_I64_MAX = torch.iinfo(torch.int64).max
_DAY_US = 86_400_000_000


def _rev_cummin(x: torch.Tensor) -> torch.Tensor:
    return cummin(x.flip(0)).flip(0)


def _run_bounds(starts: torch.Tensor):
    """(first position, last position, run id) of each row's run, a run
    beginning where `starts` is True (starts[0] is). One cumsum numbers the
    runs, and each run's first and last position land in a table by run id:
    every slot has one writer, and the rows that start or end no run write
    a spare slot past the table that nothing reads. (torch.cummax/cummin
    over the positions would give the same, but compute indices too and
    took 18 ms a call over 6.3M rows on an H100 80GB HBM3 at 700 W, PERF.md.)"""
    n = starts.shape[0]
    idx = torch.arange(n, device=starts.device)
    rid = torch.cumsum(starts.to(torch.int64), 0) - 1
    ends = torch.ones_like(starts)
    ends[:-1] = starts[1:]
    first = torch.zeros(n + 1, dtype=torch.int64, device=starts.device)
    first.scatter_(0, torch.where(starts, rid, n), idx)
    last = torch.zeros(n + 1, dtype=torch.int64, device=starts.device)
    last.scatter_(0, torch.where(ends, rid, n), idx)
    return first[rid], last[rid], rid


@dataclass
class _Order:
    """One sort of the block and the boundaries every window over it reads
    (all in sorted order)."""

    perm: torch.Tensor  # sorted position → row
    live: torch.Tensor  # bool, the row at each sorted position is live
    seg_start: torch.Tensor  # bool, first row of a partition
    peer_start: torch.Tensor  # bool, first row of a peer run (equal ORDER BY keys)
    start: torch.Tensor  # int64, first position of the row's partition
    end: torch.Tensor  # int64, last position of the row's partition
    seg_id: torch.Tensor  # int64, the partition's number (0, 1, … in sorted order)
    peer_s: torch.Tensor  # first position of the row's peer run
    peer_e: torch.Tensor  # last position of the row's peer run
    peer_id: torch.Tensor  # int64, the peer run's number
    has_order: bool
    _longest: Optional[int] = None

    @property
    def longest(self) -> int:
        """Rows in the longest partition (one read from the device)."""
        if self._longest is None:
            self._longest = int((self.end - self.start).max()) + 1
        return self._longest


def _boundaries(keys: List[torch.Tensor], n: int, first) -> torch.Tensor:
    out = first.clone()
    for k in keys:
        out[1:] |= k[1:] != k[:-1]
    return out


def _window_keys(b, w: P.BoundWindow, env):
    """The window's normalized PARTITION BY and ORDER BY keys over b."""
    return _partition_keys(b, w, env), _order_keys(b, w, env)


def _partition_keys(b, w: P.BoundWindow, env):
    from duckdb_tpu_torch.execution.executor import sort_keys

    return [k for e in w.partition_by for k in sort_keys(e.eval(env), b.plen, False, True)]


def _order_keys(b, w: P.BoundWindow, env):
    from duckdb_tpu_torch.execution.executor import sort_keys

    return [k for e, desc, nf in w.order_by
            for k in sort_keys(e.eval(env), b.plen, desc, bool(nf))]


def _sort(executor, b, w: P.BoundWindow, env) -> _Order:
    return order_from_keys(*_window_keys(b, w, env), b.live)


def order_from_keys(pkeys, okeys, live) -> _Order:
    """One stable sort by (dead, partition keys, order keys) — ties keep
    row order — and the partition and peer runs in sorted order."""
    plen = live.shape[0]
    device = live.device
    perm = S.sort_permutation(pkeys + okeys, live)
    live = live[perm]
    first = torch.arange(plen, device=device) == 0
    # the dead rows (sorted last) are a partition of their own
    seg_start = _boundaries([live] + [k[perm] for k in pkeys], plen, first)
    peer_start = _boundaries([k[perm] for k in okeys], plen, seg_start)
    start, end, seg_id = _run_bounds(seg_start)
    peer_s, peer_e, peer_id = _run_bounds(peer_start)
    return _Order(perm=perm, live=live, seg_start=seg_start, peer_start=peer_start,
                  start=start, end=end, seg_id=seg_id, peer_s=peer_s, peer_e=peer_e,
                  peer_id=peer_id, has_order=bool(okeys))


def execute_window(executor, node: P.Window):
    from duckdb_tpu_torch.execution.executor import Batch, ChainCols, DictCols
    from duckdb_tpu_torch.planner.planner import _bound_eq

    b = executor.execute(node.child)
    env = b.env()
    orders = []  # [(window, _Order)]: windows of one signature share a sort
    out = _sharded_windows(executor, node.windows, env, b)
    for w in node.windows:
        if w.key in out:
            continue
        od = next((o for w2, o in orders if _same_sort(w, w2, _bound_eq)), None)
        if od is None:
            od = _sort(executor, b, w, env)
            orders.append((w, od))
        res, valid, dvals, *hi = _compute(w, env, b.plen, od)
        data = torch.empty_like(res)
        data[od.perm] = res
        data_hi = None
        if hi:  # the high halves of HUGEINT values
            data_hi = torch.empty_like(hi[0])
            data_hi[od.perm] = hi[0]
        validity = None
        if valid is not None:
            validity = torch.empty_like(valid)
            validity[od.perm] = valid
        out[w.key] = Column(data=data, ltype=w.ltype, validity=validity, dict_values=dvals,
                            data_hi=data_hi)
    executor.routes["window"] += 1
    return Batch(src=ChainCols([DictCols(out), b.src]), plen=b.plen, live=b.live)


_SHARDED_WINDOW_FNS = {"row_number", "rank", "dense_rank", "count", "sum", "avg", "min",
                       "max"}
_SHARDED_MIN_ROWS = 1 << 14


def _sharded_windows(executor, windows, env, b) -> Dict[str, Column]:
    """The windows that run over the mesh (parallel/shard.make_sharded_window)
    when rows are sharded: a ranking function or a whole-partition /
    running count, sum, avg, min or max over PARTITION BY, without a
    frame, from _SHARDED_MIN_ROWS padded rows (the JAX package's gates; min
    and max only over whole partitions). Windows of one PARTITION BY share
    one exchange, and those of one ORDER BY one sort on each shard.
    → {window key: Column}; the others run on one device."""
    from duckdb_tpu_torch.planner.planner import _bound_eq

    n = executor._join_shards(rows=b.plen) if b.plen >= _SHARDED_MIN_ROWS else 1
    if n <= 1:
        return {}
    picked = [(w, a) for w in windows for a in [_sharded_arg(w, env, b)] if a is not None]
    groups = []  # [[(window, arg)]] of one PARTITION BY
    for w, a in picked:
        g = next((g for g in groups if len(g[0][0].partition_by) == len(w.partition_by)
                  and all(_bound_eq(x, y) for x, y in zip(g[0][0].partition_by,
                                                            w.partition_by))), None)
        if g is None:
            groups.append([(w, a)])
        else:
            g.append((w, a))
    out = {}
    for group in groups:
        out.update(_sharded_group(executor, n, group, env, b, _bound_eq))
    return out


def _sharded_arg(w: P.BoundWindow, env, b):
    """(argument, validity, scale) of a window the mesh takes, None for
    count(*)'s; None where the window stays on one device."""
    from duckdb_tpu_torch.execution.executor import _full_valid

    if (not w.partition_by or w.frame is not None or w.func not in _SHARDED_WINDOW_FNS
            or len(w.args) > 1 or (w.func in ("min", "max") and w.order_by)
            or w.distinct or w.filter is not None):
        return None
    if not w.args:
        return None, None, 1.0
    c = w.args[0].eval(env)
    if c.ltype.id in (TypeId.VARCHAR, TypeId.BLOB) or c.data_hi is not None \
            or c.ltype.id in UNSORTED_DICT_IDS:
        return None
    scale = 10.0 ** c.ltype.scale if c.ltype.id is TypeId.DECIMAL else 1.0
    return bcast(c.data, b.plen), _full_valid(c, b.plen), scale


def _sharded_group(executor, n, group, env, b, eq) -> Dict[str, Column]:
    """The windows of one PARTITION BY over n shards, in one exchange."""
    from duckdb_tpu_torch.parallel import shard

    plen, device = b.plen, b.live.device
    firsts, specs = [], []  # a window of each distinct ORDER BY; (kind, its index)
    for w, _ in group:
        o = next((i for i, f in enumerate(firsts) if _same_sort(w, f, eq)), None)
        if o is None:
            o = len(firsts)
            firsts.append(w)
        specs.append((w.func, o))
    pkeys = _partition_keys(b, group[0][0], env)
    okeys = [_order_keys(b, f, env) for f in firsts]
    mesh = executor._mesh(n, "sharded_window")
    res = shard.make_sharded_window(mesh, len(pkeys), [len(k) for k in okeys], specs)(
        pkeys[0], b.live, torch.arange(plen, device=device), pkeys, okeys,
        [a for _, a in group])
    out = {}
    for (w, _), r in zip(group, res):
        # each live row's value back at its row (every row id once)
        data = torch.zeros(plen, dtype=r.values.dtype, device=device)
        data[r.rows] = r.values
        validity = None
        if w.func not in ("row_number", "rank", "dense_rank", "count"):
            validity = torch.zeros(plen, dtype=torch.bool, device=device)
            validity[r.rows] = r.valid
        out[w.key] = Column(data=data, ltype=w.ltype, validity=validity)
    return out


def _same_sort(a: P.BoundWindow, b: P.BoundWindow, eq) -> bool:
    return (len(a.partition_by) == len(b.partition_by) and len(a.order_by) == len(b.order_by)
            and all(eq(x, y) for x, y in zip(a.partition_by, b.partition_by))
            and all(eq(x, y) and d1 == d2 and bool(n1) == bool(n2)
                    for (x, d1, n1), (y, d2, n2) in zip(a.order_by, b.order_by)))


def _const_int(e, what: str) -> int:
    v = e.const_value() if e.is_const() else None
    if v is None or isinstance(v, (tuple, float)):
        raise BindError(f"Binder Error: {what} must be a constant integer")
    return int(v)


def _compute(w: P.BoundWindow, env, plen: int, od: _Order):
    """→ (values, validity | None, dictionary | None[, high halves]), in
    sorted order; the high halves come with a HUGEINT result."""
    device = od.perm.device
    idx = torch.arange(plen, device=device)
    f = w.func
    if f in ("row_number", "rank", "dense_rank"):
        return _rank_values(f, od, idx), None, None
    size = od.end - od.start + 1
    if f == "percent_rank":
        rk = (od.peer_s - od.start).to(torch.float64)
        sz = size.to(torch.float64)
        return torch.where(size > 1, rk / (sz - 1).clamp(min=1.0), 0.0), None, None
    if f == "cume_dist":
        return (od.peer_e - od.start + 1).to(torch.float64) / size.to(torch.float64), None, None
    if f == "ntile":
        n = _const_int(w.args[0], "ntile's argument")
        if n <= 0:
            raise BindError("Invalid Input Error: Argument for ntile must be greater than zero")
        k = idx - od.start
        base, rem = size // n, size % n
        big = rem * (base + 1)
        tile = torch.where(k < big, k // (base + 1),
                           rem + (k - big) // base.clamp(min=1))
        return tile + 1, None, None

    # the functions of a value: the argument in sorted order
    c = hi = None
    if w.args:
        c = w.args[0].eval(env)
        vals = bcast(c.data, plen)[od.perm]
        valid = od.live if c.validity is None else bcast(c.validity, plen)[od.perm] & od.live
        if c.data_hi is not None:  # HUGEINT: the high halves ride along
            hi = bcast(c.data_hi, plen)[od.perm]
    else:
        vals = torch.zeros(plen, dtype=torch.int64, device=device)
        valid = od.live
    if w.filter is not None:  # FILTER: the rows it is not TRUE for do not count (W8)
        fc = w.filter.eval(env)
        keep = bcast(fc.data.to(torch.bool), plen)
        if fc.validity is not None:
            keep = keep & bcast(fc.validity, plen)
        valid = valid & keep[od.perm]
    if w.distinct:  # each value counts once, at its first row in window order
        valid = _first_marks(vals, hi, valid, od)
    dvals = c.dict_values if c is not None and w.ltype.id in (TypeId.VARCHAR, TypeId.BLOB) \
        else None

    def pick(p):
        """The argument at sorted positions p (clamped), both halves of a HUGEINT."""
        return (vals[p],) if hi is None else (vals[p], hi[p])

    def at(p, ok):
        v = pick(p)
        return (v[0], ok, dvals) + v[1:]

    if f == "fill":
        return _fill(vals, valid, od, idx) + (dvals,)
    if f in ("lag", "lead"):
        return _lag_lead(w, env, c, vals, hi, valid, od, idx, plen, dvals)
    framed = w.frame is not None
    span = _frame_bounds(w, env, od, idx, plen) if framed else None
    if framed:
        lo = span[0]
    if f == "nth_value":
        n = _const_int(w.args[1], "nth_value's index")
        if framed:
            p, limit = lo + n - 1, span[1]
        else:
            p, limit = od.start + n - 1, od.peer_e if od.has_order else od.end
        pc = p.clamp(0, plen - 1)
        return at(pc, (p <= limit) & (n >= 1) & valid[pc])
    if f == "first_value":
        p = lo if framed else od.start
        pc = p.clamp(0, plen - 1)
        return at(pc, valid[pc] if not framed else valid[pc] & (span[1] >= lo))
    if f == "last_value":
        p = span[1] if framed else (od.peer_e if od.has_order else od.end)
        pc = p.clamp(0, plen - 1)
        return at(pc, valid[pc] if not framed else valid[pc] & (span[1] >= lo))
    if f in ("stddev", "stddev_samp", "stddev_pop", "var_samp", "var_pop", "variance"):
        return _moments(f, c, vals, valid, od, plen) + (None,)
    if f in ("median", "quantile_cont"):
        q = 0.5 if f == "median" or len(w.args) < 2 else float(w.args[1].const_value())
        return _quantile(q, c, vals, valid, od, plen) + (dvals,)

    if f in ("count", "sum", "avg", "min", "max"):
        scale = 10.0 ** c.ltype.scale if c is not None and c.ltype.id is TypeId.DECIMAL else 1.0
        if hi is not None and f != "count":
            return _wide_agg_over(f, vals, hi, valid, od, span, plen, scale)
        res, ok = _agg_over(f, vals, valid, od, span, plen, scale)
        return res, ok, dvals if f in ("min", "max") else None
    raise BindError(f"Binder Error: window function {f} is not supported")


def _agg_over(f, vals, valid, od: _Order, span, plen: int, scale: float):
    """count, sum, avg, min or max over the whole partition, running (the
    default frame with an ORDER BY: up to the current row's last peer), or
    over an explicit frame `span` → (values, validity | None), in sorted
    order. `scale` divides an avg of a DECIMAL's scaled integers."""
    n_valid = _over(valid.to(torch.int64), od, span, plen)
    if f == "count":
        return n_valid, None
    is_float = vals.dtype.is_floating_point
    if f in ("sum", "avg"):
        zero = 0.0 if is_float else 0
        x = torch.where(valid, vals.to(torch.float64 if is_float else torch.int64), zero)
        s = _over(x, od, span, plen)
        if f == "sum":
            return s, n_valid > 0
        return s.to(torch.float64) / (n_valid.to(torch.float64) * scale), n_valid > 0
    op = torch.minimum if f == "min" else torch.maximum
    if is_float:
        ident = float("inf") if f == "min" else float("-inf")
        x = torch.where(valid, vals.to(torch.float64), ident)
    else:
        ident = _I64_MAX if f == "min" else _I64_MIN
        x = torch.where(valid, vals.to(torch.int64), ident)
    if span is not None:
        run = _span_minmax(x, span[0], span[1], op, ident)
    else:
        run = _seg_scan(x, od, op)[od.peer_e if od.has_order else od.end]
    return run.to(vals.dtype), n_valid > 0


_M32 = 0xFFFFFFFF


def _wide_agg_over(f, lo, hi, valid, od: _Order, span, plen: int, scale: float):
    """sum, avg, min or max of HUGEINT values (lo, hi int64 halves) over the
    frames of `_agg_over` → (low halves or DOUBLE, validity, None[, high
    halves]). A sum adds the low halves as two 32-bit halves, exact in
    int64 below 2^31 rows, and carries into the high halves, which wrap mod
    2^64 (the sum wraps mod 2^128). min and max scan the values' ranks
    among the distinct (hi, unsigned lo) pairs."""
    n_valid = _over(valid.to(torch.int64), od, span, plen)
    if f in ("min", "max"):
        uniq, rank = torch.unique(torch.stack([hi, lo ^ _I64_MIN], 1), dim=0,
                                  return_inverse=True)
        r, ok = _agg_over(f, rank, valid, od, span, plen, 1.0)
        top = uniq[r.clamp(0, uniq.shape[0] - 1)]
        return top[:, 1] ^ _I64_MIN, ok, None, top[:, 0]
    zero = torch.zeros((), dtype=torch.int64, device=lo.device)
    a = _over(torch.where(valid, lo & _M32, zero), od, span, plen)
    b = _over(torch.where(valid, (lo >> 32) & _M32, zero), od, span, plen)
    h = _over(torch.where(valid, hi, zero), od, span, plen)
    t = (a >> 32) + b
    s_lo, s_hi = ((t & _M32) << 32) | (a & _M32), h + (t >> 32)
    if f == "sum":
        return s_lo, n_valid > 0, None, s_hi
    total = s_hi.to(torch.float64) * 2.0 ** 64 + (s_lo ^ _I64_MIN).to(torch.float64) + 2.0 ** 63
    return total / (n_valid.to(torch.float64) * scale), n_valid > 0, None


def _first_marks(vals, hi, valid, od: _Order) -> torch.Tensor:
    """DISTINCT over a window: True at the first valid row, in window order,
    of each value of a partition. A stable sort by (partition, value) keeps
    the window order among equal values."""
    keys = [od.seg_id] + ([] if hi is None else [hi]) + [vals]
    perm2 = S.sort_permutation(keys, valid)
    n = valid.shape[0]
    first = _boundaries([k[perm2] for k in keys], n,
                        torch.arange(n, device=valid.device) == 0)
    marks = torch.zeros_like(valid)
    marks[perm2] = first & valid[perm2]
    return marks


def _rank_values(f, od: _Order, idx):
    if f == "row_number":
        return idx - od.start + 1
    if f == "rank":
        return od.peer_s - od.start + 1
    return od.peer_id - od.peer_id[od.start] + 1  # dense_rank


def keyed_window_values(kind: str, od: _Order, vals, valid, scale: float = 1.0):
    """A sharded window's values over one shard's rows, sorted (`od`), with
    the single-device code: a ranking function, or count / sum / avg / min
    / max over the whole partition or running to the last peer. vals and
    valid are the argument in sorted order. → (values, validity | None)."""
    plen = od.perm.shape[0]
    if kind in ("row_number", "rank", "dense_rank"):
        return _rank_values(kind, od, torch.arange(plen, device=od.perm.device)), None
    return _agg_over(kind, vals, valid & od.live, od, None, plen, scale)


# -- scans ------------------------------------------------------------------------
def _seg_scan(x: torch.Tensor, od: _Order, op) -> torch.Tensor:
    """Inclusive scan of x by `op` inside each partition (log-step)."""
    idx = torch.arange(x.shape[0], device=x.device)
    d = 1
    while d < od.longest:
        prev = torch.empty_like(x)
        prev[d:] = x[:-d]
        prev[:d] = x[:d]
        x = torch.where(idx - d >= od.start, op(x, prev), x)
        d *= 2
    return x


def _seg_prefix(x: torch.Tensor, od: _Order) -> torch.Tensor:
    """Inclusive prefix sums of x inside each partition: for int64, the
    running sum less its value before the partition (exact, wrapping); for
    DOUBLE a log-step scan, so no other partition's sum cancels."""
    if x.dtype.is_floating_point:
        return _seg_scan(x, od, torch.add)
    c = torch.cumsum(x, 0)
    return c - (c[od.start] - x[od.start])


def _over(x: torch.Tensor, od: _Order, span, plen: int) -> torch.Tensor:
    """Sums of x over each row's frame: `span` (lo, hi), else (None) the
    running frame up to the last peer when ordered, else the whole
    partition."""
    pref = _seg_prefix(x, od)
    if span is None:
        return pref[od.peer_e if od.has_order else od.end]
    lo, hi = span
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    hi_v = torch.where(hi >= od.start, pref[hi.clamp(0, plen - 1)], zero)
    lo_v = torch.where(lo > od.start, pref[(lo - 1).clamp(0, plen - 1)], zero)
    return torch.where(hi >= lo, hi_v - lo_v, zero)


def _span_minmax(x, lo, hi, op, ident) -> torch.Tensor:
    """min/max of x over each row's [lo, hi] from a sparse table: level j
    holds op over [i, i + 2^j), built only up to the longest span; each row
    reads two overlapping power-of-two blocks."""
    n = x.shape[0]
    ln = hi - lo + 1
    longest = int(ln.max()) if n else 0
    levels = [x]
    h = 1
    while 2 * h <= longest:
        prev = levels[-1]
        shifted = torch.full_like(prev, ident)
        shifted[:n - h] = prev[h:]
        levels.append(op(prev, shifted))
        h *= 2
    kk = torch.zeros_like(ln)
    for j in range(1, len(levels)):
        kk += (ln >= (1 << j)).to(kk.dtype)
    tbl = torch.stack(levels)
    a = tbl[kk, lo.clamp(0, n - 1)]
    b2 = tbl[kk, (hi - (1 << kk) + 1).clamp(0, n - 1)]
    return torch.where(ln >= 1, op(a, b2), torch.full_like(a, ident))


# -- value functions ------------------------------------------------------------------
def _fill(vals, valid, od: _Order, idx):
    """NULLs linearly interpolated between the nearest valid neighbours of
    their partition (DuckDB's fill(); only one neighbour: its value)."""
    plen = vals.shape[0]
    prev_i = cummax(torch.where(valid, idx, -1))
    prev_i = torch.where(prev_i >= od.start, prev_i, -1)
    next_i = _rev_cummin(torch.where(valid, idx, _I64_MAX))
    next_i = torch.where(next_i <= od.end, next_i, _I64_MAX)
    has_p, has_n = prev_i >= 0, next_i < _I64_MAX
    pv = vals[prev_i.clamp(0, plen - 1)].to(torch.float64)
    nv = vals[next_i.clamp(0, plen - 1)].to(torch.float64)
    span = (next_i - prev_i).to(torch.float64).clamp(min=1.0)
    interp = pv + (nv - pv) * ((idx - prev_i).to(torch.float64) / span)
    filled = torch.where(has_p & has_n, interp, torch.where(has_p, pv, nv))
    out = torch.where(valid, vals, filled.to(vals.dtype))
    return out, valid | has_p | has_n


def _lag_lead(w, env, c, vals, hi, valid, od: _Order, idx, plen, dvals):
    """lag / lead → (values, validity, dictionary[, high halves of a
    HUGEINT]). A VARCHAR default from outside the argument's dictionary
    merges the two (sorted) dictionaries and maps both sides' codes into
    it."""
    off = _const_int(w.args[1], f"{w.func}'s offset") if len(w.args) > 1 else 1
    src = idx + (-off if w.func == "lag" else off)
    srcc = src.clamp(0, plen - 1)
    ok = (src >= 0) & (src < plen) & (od.start[srcc] == od.start)
    outv = ok & valid[srcc]
    zero = torch.zeros((), dtype=vals.dtype, device=vals.device)
    wide = () if hi is None else (torch.where(ok, hi[srcc], zero),)
    if len(w.args) < 3:
        return (torch.where(ok, vals[srcc], zero), outv, dvals) + wide
    d = w.args[2].eval(env)
    if c.ltype.id is TypeId.VARCHAR:
        dd = np.asarray(d.dict_values if d.dict_values is not None else [], dtype=object)
        dvals = np.union1d(np.asarray(c.dict_values, dtype=object), dd)

        def lut(dictionary):
            return torch.from_numpy(np.searchsorted(dvals, dictionary).astype(np.int32)
                                    ).to(vals.device)

        va, vb = lut(np.asarray(c.dict_values, dtype=object)), lut(dd) if len(dd) else None
        vals = va[vals.long().clamp(0, va.shape[0] - 1)]
        dv = torch.zeros(plen, dtype=torch.int32, device=vals.device) if vb is None \
            else vb[bcast(d.data, plen).long().clamp(0, vb.shape[0] - 1)][od.perm]
    else:
        if d.ltype != c.ltype:
            d = B._coerce_to(d, c.ltype, env)
        dv = bcast(d.data, plen)[od.perm].to(vals.dtype)
        if hi is not None:
            dv_hi = dv >> 63 if d.data_hi is None else bcast(d.data_hi, plen)[od.perm]
            wide = (torch.where(ok, hi[srcc], dv_hi),)
    dvalid = torch.ones_like(ok) if d.validity is None else bcast(d.validity, plen)[od.perm]
    return (torch.where(ok, vals[srcc], dv), torch.where(ok, outv, dvalid), dvals) + wide


# -- whole-partition holistics ----------------------------------------------------------
def _seg_total(x: torch.Tensor, od: _Order) -> torch.Tensor:
    """Each row's partition total of x (one index_add_ over partition ids)."""
    tot = torch.zeros_like(x).index_add_(0, od.seg_id, x)
    return tot[od.seg_id]


def _values(c, vals) -> torch.Tensor:
    """DOUBLE values of the argument: a DECIMAL unscaled (W4)."""
    x = vals.to(torch.float64)
    if c.ltype.id is TypeId.DECIMAL:
        x = x / (10.0 ** c.ltype.scale)
    return x


def _moments(f, c, vals, valid, od: _Order, plen):
    x = torch.where(valid, _values(c, vals), 0.0)
    n_ = _seg_total(valid.to(torch.float64), od)
    mean = _seg_total(x, od) / n_.clamp(min=1.0)
    d = torch.where(valid, _values(c, vals) - mean, 0.0)
    m2 = _seg_total(d * d, od)
    if f in ("stddev_pop", "var_pop"):
        var, ok = m2 / n_.clamp(min=1.0), n_ >= 1
    else:
        var, ok = m2 / (n_ - 1.0).clamp(min=1.0), n_ >= 2
    var = var.clamp(min=0.0)
    return (var if f.startswith("var") else torch.sqrt(var)), ok


def _quantile(q, c, vals, valid, od: _Order, plen):
    """quantile_cont(q) of each partition: a second sort by (partition,
    value), then the interpolated middle of its valid values. Over VARCHAR
    it is DuckDB's quantile_disc: the value at max(1, ceil(n·q)) - 1, the
    lower middle for the median (W9); the dictionary is sorted, so the
    codes order the values."""
    perm2 = S.sort_permutation([od.seg_id, S.orderable_int64(vals, valid, False, False)],
                               torch.ones_like(valid))
    nval = _seg_total(valid.to(torch.int64), od)
    if c.ltype.id is TypeId.VARCHAR:
        k = torch.ceil(nval.to(torch.float64) * q).to(torch.int64).clamp(min=1) - 1
        return vals[perm2][(od.start + k).clamp(0, plen - 1)], nval > 0
    x2 = _values(c, vals)[perm2]
    pos = (nval.to(torch.float64) - 1.0) * q
    lo = torch.floor(pos).to(torch.int64)
    hi = torch.ceil(pos).to(torch.int64)
    frac = pos - lo.to(torch.float64)
    vlo = x2[(od.start + lo).clamp(0, plen - 1)]
    vhi = x2[(od.start + hi).clamp(0, plen - 1)]
    return vlo * (1.0 - frac) + vhi * frac, nval > 0


# -- frames -----------------------------------------------------------------------
def _frame_const(e):
    """A frame offset's constant: an int, a float, a decimal.Decimal, or
    ('interval', (months, days, micros))."""
    from duckdb_tpu_torch.planner.binder import ExprBinder, Scope

    be = e if isinstance(e, B.BoundExpr) else ExprBinder(Scope()).bind(e)
    if not be.is_const():
        raise BindError("Binder Error: a window frame offset must be a constant")
    v = be.const_value()
    if be.ltype.id is TypeId.INTERVAL:
        return ("interval", v)
    if be.ltype.id is TypeId.DECIMAL:
        return decimal.Decimal(int(v)).scaleb(-be.ltype.scale)
    return v


def _frame_bounds(w: P.BoundWindow, env, od: _Order, idx, plen):
    """The explicit ROWS / RANGE frame → each row's inclusive [lo, hi]
    positions, clamped to its partition (hi < lo: an empty frame)."""
    mode, lo_spec, hi_spec = w.frame
    if mode == "rows":
        def pos(spec):
            kind, e = spec
            if kind == "unbounded_preceding":
                return od.start
            if kind == "unbounded_following":
                return od.end
            if kind == "current":
                return idx
            n = _frame_const(e)
            if not isinstance(n, int) or isinstance(n, bool):
                raise BindError("Binder Error: a ROWS frame offset must be an integer")
            return idx - n if kind == "preceding" else idx + n

        lo, hi = pos(lo_spec), pos(hi_spec)
    else:
        lo, hi = _range_bounds(w, env, od, idx, plen, lo_spec, hi_spec)
    return torch.maximum(torch.minimum(lo, od.end + 1), od.start), \
        torch.minimum(torch.maximum(hi, od.start - 1), od.end)


def _bisect(keys, targets, lo0, hi0, right: bool, iters: int):
    """Per row, the first position in [lo0, hi0) whose key is >= its target
    (> with `right`); keys ascend inside each row's span."""
    lo, hi = lo0, hi0
    n = keys.shape[0]
    for _ in range(iters):
        mid = (lo + hi) // 2
        kv = keys[mid.clamp(0, n - 1)]
        go = (lo < hi) & ((kv <= targets) if right else (kv < targets))
        lo, hi = torch.where(go, mid + 1, lo), torch.where(go, hi, torch.where(lo < hi, mid, hi))
    return lo


def _range_bounds(w, env, od: _Order, idx, plen, lo_spec, hi_spec):
    """RANGE frames with offsets: bounds in the value space of the one
    ORDER BY key, found by binary search inside the row's partition. NULL
    keys frame their peers (all NULLs)."""
    offsets = [s for s in (lo_spec, hi_spec) if s[0] in ("preceding", "following")]
    if offsets and len(w.order_by) != 1:
        raise BindError("Binder Error: RANGE frames with offsets require exactly one "
                        "ORDER BY expression")

    def pos(spec, is_lo):
        kind, e = spec
        if kind == "unbounded_preceding":
            return od.start
        if kind == "unbounded_following":
            return od.end
        if kind == "current":
            return od.peer_s if is_lo else od.peer_e
        tgt = _range_target(w, keys, _frame_const(e), -1 if kind == "preceding" else 1)
        p = _bisect(keys, tgt, od.start, od.end + 1, not is_lo,
                    max(1, od.longest.bit_length() + 1))
        p = p if is_lo else p - 1
        return torch.where(kvalid, p, od.peer_s if is_lo else od.peer_e)

    if offsets:
        keys, kvalid = _range_keys(w, env, od, plen)
    return pos(lo_spec, True), pos(hi_spec, False)


def _range_keys(w, env, od: _Order, plen):
    """The ORDER BY key in sorted order, ascending (negated under DESC),
    NULLs pinned to the end they sort at."""
    e, desc, nf = w.order_by[0]
    c = e.eval(env)
    if c.ltype.id not in (TypeId.DATE, TypeId.TIMESTAMP, TypeId.DECIMAL) \
            and not c.ltype.is_integer and not c.ltype.is_float:
        raise BindError(f"Binder Error: a RANGE frame offset needs a numeric or temporal "
                        f"ORDER BY key, not {c.ltype!r}")
    kv = bcast(c.data, plen)[od.perm]
    kvalid = od.live if c.validity is None else bcast(c.validity, plen)[od.perm]
    k = kv.to(torch.float64) if c.ltype.is_float else kv.to(torch.int64)
    if desc:
        k = -k
    null = (float("-inf") if nf else float("inf")) if c.ltype.is_float \
        else (_I64_MIN if nf else _I64_MAX)
    return torch.where(kvalid, k, null), kvalid


def _range_target(w, keys, n, sign):
    """Each row's key (from `_range_keys`) shifted by the offset n toward
    `sign` (in the ascending key space, so DESC keys shift the other way)."""
    e, desc, _ = w.order_by[0]
    t = e.ltype
    if isinstance(n, tuple):
        return _shift_interval(keys, n[1], sign, t.id, desc)
    if t.is_float:
        return keys + sign * float(n)
    scale = 10 ** t.scale if t.id is TypeId.DECIMAL else 1
    return keys + sign * int(decimal.Decimal(str(n)) * scale)


def _shift_interval(keys, iv, sign, tid, desc):
    """Keys (DATE days or TIMESTAMP micros, negated under DESC) moved by
    the interval toward `sign` in that key space: calendar months with the
    day clamped to the month's length, then days and microseconds
    (DuckDB's window_boundaries_state.cpp). Under DESC the values shift
    the other way, as the numeric offsets of `_range_target` do: PRECEDING
    rows hold the larger values."""
    from duckdb_tpu_torch.planner.bound import civil_from_days
    from duckdb_tpu_torch.planner.functions_ext import civil_to_days

    if tid not in (TypeId.DATE, TypeId.TIMESTAMP):
        raise BindError("Binder Error: INTERVAL RANGE offsets require a DATE or TIMESTAMP "
                        "ORDER BY key")
    months, days_, micros = iv
    k = -keys if desc else keys
    sign = -sign if desc else sign
    is_ts = tid is TypeId.TIMESTAMP
    days = torch.div(k, _DAY_US, rounding_mode="floor") if is_ts else k
    tod = k - days * _DAY_US if is_ts else None
    if months:
        y, m, d = civil_from_days(days)
        t = y * 12 + (m - 1) + sign * months
        y2, m2 = torch.div(t, 12, rounding_mode="floor"), torch.remainder(t, 12) + 1
        mdays = torch.tensor([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31],
                             dtype=torch.int64, device=k.device)[m2 - 1]
        leap = ((y2 % 4 == 0) & ((y2 % 100 != 0) | (y2 % 400 == 0))) & (m2 == 2)
        days = civil_to_days(y2, m2, torch.minimum(d, mdays + leap.to(torch.int64)))
    days = days + sign * days_
    out = days * _DAY_US + tod + sign * micros if is_ts \
        else days + sign * int(micros // _DAY_US)
    return -out if desc else out
