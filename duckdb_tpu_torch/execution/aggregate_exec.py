"""General grouped aggregation: every aggregate the fused pipeline does not take.

The JAX package's execution/aggregate_exec.py, eager in torch. The executor
runs the fused pipeline (fused_agg) first and comes here when it refuses
the plan: a holistic or order-dependent aggregate (median, quantile, mode,
first/last, arg_min/arg_max), a statistical one (aggregate_stats), min/max
over strings, a computed VARCHAR group key (TPC-H Q22's
`substring(c_phone, 1, 2)`), or more than one argument. The child plan has
already run; this module groups its rows and reduces each aggregate.

Grouping mirrors the reference's PerfectAggregateHashTable /
GroupedAggregateHashTable split:
- perfect: every key has a static bound (catalog stats, or the length of a
  VARCHAR key's dictionary, which for a computed key is the dictionary the
  string function made) and the mixed-radix domain is at most
  PERFECT_LIMIT: dense slot ids, slot occupancy, the occupied slots
  compacted into group ids;
- sort-group otherwise: a stable lexicographic sort over (NULL flag, value)
  per key, group ids from key changes.
NULL keys form their own group. Group ids are dense in [0, n_groups); dead
rows take the trash id G (the output capacity), which ops/grouped counts as
dead. The live count and the group count are each read once from the
device; the rows are compacted with ops/compact.packed_indices when that
halves the block.

Every per-group reduction goes through ops/grouped.grouped_reduce: int64
sums over at most 256 slots (Q22's count and sum, the statistical
aggregates' counts) launch the hand-written grouped-sum kernel, and the
rest are index_add_ / scatter_reduce_. A per-group pick (first, arg_min,
a representative row) is a min over row indices, never a scatter whose
winner decides, since duplicate-index writes on CUDA keep an arbitrary one.
Sort-based aggregates (median, quantile, mode, DISTINCT) use
ops/sort.sort_permutation over (group id, orderable value).

Not carried over (TPU-only): the 22-bit f64 limbs of `_seg_sum`, the learned
compaction caps and key bounds with their deferred re-runs, and the 62-bit
word packing of the sort keys. bit_and/bit_or/bit_xor count each bit per
group (ops/scan.grouped_bitwise) instead of the reference's segmented scan;
approx_count_distinct keeps the reference's HyperLogLog.

The nested-result aggregates (list/array_agg, string_agg, histogram,
histogram_exact, approx_top_k, bitstring_agg, lttb) finalize per group, not
per row: one device sort by (dead, group[, ORDER BY keys][, value]), the
group boundaries (and runs of equal values) found on the device, one copy
of the rows or run representatives to the host, and each group's value
built from its slice.
Where the reference differs from DuckDB, the port follows DuckDB:
list(x ORDER BY y) orders by y, and list() … FILTER drops the filtered rows
instead of listing NULLs. min/max over a nested value compare DuckDB's
ranks (blocks/nested.py), not its first-seen codes.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from duckdb_tpu_torch.blocks import Column, pad_bucket
from duckdb_tpu_torch.blocks.nested import UNSORTED_DICT_IDS
from duckdb_tpu_torch.errors import OutOfRangeException
from duckdb_tpu_torch.ops import int128 as I128
from duckdb_tpu_torch.ops import sort as S
from duckdb_tpu_torch.ops.compact import packed_indices
from duckdb_tpu_torch.ops.grouped import grouped_reduce
from duckdb_tpu_torch.ops.hash import clz64, hash64
from duckdb_tpu_torch.ops.scan import BITWISE_KINDS, grouped_bitwise
from duckdb_tpu_torch.planner import bound as B
from duckdb_tpu_torch.planner import plan as P
from duckdb_tpu_torch.planner.bound import not_ported
from duckdb_tpu_torch.types import BIGINT, DOUBLE, TypeId

_I64_MIN = torch.iinfo(torch.int64).min
_I64_MAX = torch.iinfo(torch.int64).max

PERFECT_LIMIT = 1 << 23  # max dense group domain for the perfect path
COMPACT_MIN_ROWS = 1 << 16  # blocks from this size are compacted first

QUANTILE_AGGS = ("median", "quantile_cont", "quantile_disc")
VARIANCE_AGGS = ("stddev", "stddev_samp", "var_samp", "variance", "stddev_pop",
                 "var_pop")
PICK_AGGS = ("first", "last", "any_value", "arg_min", "arg_max", "arg_min_null",
             "arg_max_null")
# aggregates whose result is a new value per group (a list, a map, a
# string): finalized on the host once per group (`_nested_result_agg`)
NESTED_RESULT_AGGS = {"histogram", "approx_top_k", "bitstring_agg", "histogram_exact", "lttb",
                      "list", "array_agg", "string_agg"}


def _key_data(c: Column, plen: int) -> torch.Tensor:
    """The key as an orderable int64: equal values give equal codes, and a
    float is bit-cast so that the codes order as the floats do."""
    return S.orderable_int64(B.bcast(c.data, plen).contiguous(), None, False, False)


def _decode_float_key(enc: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Invert _key_data's float encoding."""
    bits = torch.where(enc >= 0, enc, ~(enc ^ _I64_MIN))
    return bits.view(torch.float64).to(dtype)


def run_lengths(start: torch.Tensor) -> torch.Tensor:
    """Each row's run length, a run beginning at every row where `start`
    holds: the run ids ascend, so a run spans from the first to past the
    last position of its id (two binary searches per row). A scatter-add
    by run id would collide on a few addresses when the runs are few and
    long, and CUDA's cummax/cummin over 6M rows take 18 ms each on an H100
    80GB HBM3 at 700 W."""
    run_id = torch.cumsum(start.to(torch.int64), 0)
    return torch.searchsorted(run_id, run_id, right=True) - torch.searchsorted(run_id, run_id)


def _float_of(c: Column, data: torch.Tensor) -> torch.Tensor:
    """The values as float64 (DECIMAL unscaled, a wide value's high plane
    added)."""
    out = data.to(torch.float64)
    scale = 10.0 ** c.ltype.scale if c.ltype.id is TypeId.DECIMAL else 1.0
    if scale != 1.0:
        out = out / scale
    if c.data_hi is not None:
        # wide value = hi·2^64 + uint64(lo)
        out = out + torch.where(data < 0, 2.0 ** 64 / scale, 0.0) \
            + B.bcast(c.data_hi, data.shape[0]).to(torch.float64) * (2.0 ** 64 / scale)
    return out


class Groups:
    """Group ids of one aggregate's rows: gids (plen,) int64 in [0, n_groups)
    for live rows and G for dead ones; G is the output capacity."""

    def __init__(self, gids: torch.Tensor, n_groups: int, G: int, live: torch.Tensor):
        self.gids = gids
        self.n_groups = n_groups
        self.G = G
        self.live = live
        self.plen = gids.shape[0]
        self._counts = {}  # id(mask) → (mask, per-group count) for count()

    def reduce(self, vectors, kinds, ids=None) -> List[torch.Tensor]:
        """Per-group reductions (G,) of per-row vectors by `ids` (the group
        ids by default; an id of n_groups or more is dead). The reduction
        spans the live groups only, so a few groups keep the grouped-sum
        kernel's small regime; the slots past them are padding."""
        nseg = max(self.n_groups, 1)
        out = grouped_reduce(self.gids if ids is None else ids, vectors, kinds, nseg)
        if nseg == self.G:
            return out
        return [torch.cat([r, r.new_zeros(self.G - nseg)]) for r in out]

    def count(self, mask: torch.Tensor) -> torch.Tensor:
        """Per-group count of the rows in `mask`; computed once per mask
        tensor (most aggregates count the same live rows)."""
        hit = self._counts.get(id(mask))
        if hit is None or hit[0] is not mask:
            hit = (mask, self.reduce([mask.to(torch.int64)], ["sum"])[0])
            self._counts[id(mask)] = hit
        return hit[1]

    def at_rows(self, per_group: torch.Tensor, ids=None) -> torch.Tensor:
        """Each row's group value (a dead row reads the last group's)."""
        g = self.gids if ids is None else ids
        return per_group[g.clamp(0, self.G - 1)]

    def sorted_by(self, keys, mask):
        """(perm, group id, dead) of the rows in (group, keys...) order, the
        rows outside `mask` last; a dead row's group id is G."""
        perm = S.sort_permutation([self.gids] + list(keys), mask)
        dead_s = ~mask[perm]
        gid_s = torch.where(dead_s, self.G, self.gids[perm])
        return perm, gid_s, dead_s


def execute_aggregate(executor, child, node: P.Aggregate):
    """The aggregate node over its executed child batch → Batch of groups."""
    from duckdb_tpu_torch.execution.executor import Batch, DictCols, GatherCols, _full_valid
    from duckdb_tpu_torch.execution.fused_agg import sum_needs_wide

    plen, live = child.plen, child.live
    if plen > COMPACT_MIN_ROWS:
        n = int(live.sum())  # the live count, read once
        cap = max(128, pad_bucket(n))
        if cap <= plen // 2:
            rows = packed_indices(live, cap)
            live = torch.arange(cap, device=live.device) < n
            child = Batch(src=GatherCols(child.src, rows), plen=cap, live=live)
            plen = cap
    env = child.env()

    key_cols = [expr.eval(env) for _, expr in node.groups]
    key_data = [_key_data(c, plen) for c in key_cols]
    key_valid = [_full_valid(c, plen) for c in key_cols]
    inputs, extras, orders, filters = [], [], [], []
    for agg in node.aggs:
        if agg.filter is not None:
            fc = agg.filter.eval(env)
            filters.append(live & B.bcast(fc.data.to(torch.bool), plen) & _full_valid(fc, plen))
        else:
            filters.append(None)
        agg._wide = sum_needs_wide(agg, child.src, plen)
        if agg.args:
            c = agg.args[0].eval(env)
            inputs.append((c, _full_valid(c, plen)))
            extras.append([a.eval(env) for a in agg.args[1:]])
        else:
            inputs.append(None)
            extras.append([])
        orders.append([(e.eval(env), desc, nf) for e, desc, nf in agg.order_by])

    if node.groups:
        bounds = [_static_bounds(expr, c, child.src)
                  for (_, expr), c in zip(node.groups, key_cols)]
        grp, reps, perfect = _group(key_cols, key_data, key_valid, live, plen, bounds)
        executor.routes["general_perfect" if perfect else "general_sort_group"] += 1
    else:
        G = 128  # one output row, live even over no input rows
        grp = Groups(torch.where(live, 0, G), 1, G, live)
        reps = []

    cols = {gkey: rep for (gkey, _), rep in zip(node.groups, reps)}
    for agg, inp, extra, ocols, rows in zip(node.aggs, inputs, extras, orders, filters):
        cols[agg.key] = _compute_agg(agg, inp, grp, extra, ocols, rows)
    out_live = torch.arange(grp.G, device=live.device) < grp.n_groups
    return Batch(src=DictCols(cols), plen=grp.G, live=out_live)


def _static_bounds(expr, c: Column, src) -> Optional[Tuple[int, int]]:
    """(lo, hi) of a group key without reading the device: a VARCHAR key's
    dictionary (for a computed key, the one its function made) or a column's
    catalog stats; None → the sort-group mode."""
    if c.ltype.id is TypeId.VARCHAR or c.ltype.id in UNSORTED_DICT_IDS:
        # codes index the dictionary (a nested one groups by equality only)
        return (0, max(0, len(c.dict_values) - 1)) if c.dict_values is not None else None
    if c.ltype.is_float or not isinstance(expr, B.BoundColumnRef):
        return None
    rng = src.stats_range(expr.key)
    return None if rng is None else (int(rng[0]), int(rng[1]))


def _group(key_cols, key_data, key_valid, live, plen, bounds):
    """→ (Groups, the representative key Columns sized G, whether the
    perfect mode grouped)."""
    domains = []
    perfect = all(b is not None for b in bounds)
    total = 1
    if perfect:
        for lo, hi in bounds:
            domains.append(hi - lo + 2)  # +1 slot for NULL
            total *= domains[-1]
            if total > PERFECT_LIMIT:
                perfect = False
                break
    if perfect:
        grp, reps = _perfect_group(key_cols, key_data, key_valid, live, plen,
                                   [lo for lo, _ in bounds], domains, total)
    else:
        grp, reps = _sort_group(key_cols, key_data, key_valid, live, plen)
    return grp, reps, perfect


def _perfect_group(key_cols, key_data, key_valid, live, plen, mins, domains, total):
    device = live.device
    dense = torch.zeros(plen, dtype=torch.int64, device=device)
    for kd, kv, lo, dom in zip(key_data, key_valid, mins, domains):
        off = torch.where(kv, (kd - lo + 1).clamp(0, dom - 1), 0)
        dense = dense * dom + off
    dense = torch.where(live, dense, total)
    occ = grouped_reduce(dense, [live.to(torch.int64)], ["sum"], total)[0]
    n_groups = int((occ > 0).sum())  # the group count, read once
    G = max(128, pad_bucket(n_groups))
    slots = packed_indices(occ > 0, G)
    slot_live = torch.arange(G, device=device) < n_groups
    # dense slot → group id; the occupied slots are distinct, so each
    # position of the remap has one writer
    remap = torch.full((total + 1,), G, dtype=torch.int64, device=device)
    remap[slots[:n_groups]] = torch.arange(n_groups, device=device)
    gids = remap[dense]
    reps = []
    stride = total
    for c, lo, dom in zip(key_cols, mins, domains):
        stride //= dom
        comp = (slots // stride) % dom
        vals = comp - 1 + lo  # float keys have no static bounds: never here
        reps.append(Column(data=vals.to(c.data.dtype), ltype=c.ltype,
                           validity=(comp > 0) & slot_live, dict_values=c.dict_values))
    return Groups(gids, n_groups, G, live), reps


def _sort_group(key_cols, key_data, key_valid, live, plen):
    device = live.device
    keys = []
    for kd, kv in zip(key_data, key_valid):
        keys.append((~kv).to(torch.int64))  # NULLs group together, last
        keys.append(torch.where(kv, kd, 0))
    perm = S.sort_permutation(keys, live)
    dead_s = ~live[perm]
    change = torch.zeros(plen, dtype=torch.bool, device=device)
    for k in keys:
        ks = k[perm]
        change = change | (ks != torch.roll(ks, 1))
    change[0] = True
    change = change & ~dead_s
    n_groups = int(change.sum())  # the group count, read once
    G = max(128, pad_bucket(n_groups))
    gid_sorted = torch.where(dead_s, G, torch.cumsum(change.to(torch.int64), 0) - 1)
    gids = torch.empty(plen, dtype=torch.int64, device=device)
    gids[perm] = gid_sorted  # perm is a permutation: one writer per row
    grp = Groups(gids, n_groups, G, live)
    # each group's smallest row is its representative
    rep_rows = grp.reduce([torch.arange(plen, device=device)], ["min"])[0].clamp(max=plen - 1)
    slot_live = torch.arange(G, device=device) < n_groups
    reps = []
    for c in key_cols:
        v = slot_live if c.validity is None else B.bcast(c.validity, plen)[rep_rows] & slot_live
        reps.append(Column(data=B.bcast(c.data, plen)[rep_rows], ltype=c.ltype, validity=v,
                           dict_values=c.dict_values))
    return grp, reps


# ---------------------------------------------------------------------------
def _compute_agg(agg, inp, grp: Groups, extra=(), order_cols=(), rows=None) -> Column:
    f = agg.func
    plen, live = grp.plen, grp.live
    if f == "count_star":
        return Column(data=grp.count(live), ltype=BIGINT)
    c, valid = inp
    data = B.bcast(c.data, plen)
    mask = live if c.validity is None else live & valid  # one tensor: count() reuses
    if f in NESTED_RESULT_AGGS:
        return _nested_result_agg(agg, c, data, valid, grp, extra, order_cols,
                                  live if rows is None else rows)
    if agg.distinct:
        # the aggregate over the first row of each (group, value) run
        from duckdb_tpu_torch.execution.fused_agg import _compute_distinct_agg_mask

        mask = _compute_distinct_agg_mask(c, data, mask, grp.gids, plen)

    if f == "count":
        return Column(data=grp.count(mask), ltype=BIGINT)

    from duckdb_tpu_torch.execution.aggregate_stats import STAT_AGGS, compute_stat_agg

    if f in STAT_AGGS:
        return compute_stat_agg(agg, c, data, mask, grp, extra)

    cnt = grp.count(mask)
    nonempty = cnt > 0
    if f == "fsum":
        d = grp.reduce([torch.where(mask, _float_of(c, data), 0.0)], ["sum"])[0]
        return Column(data=d, ltype=DOUBLE, validity=nonempty)

    if f == "sum":
        if c.ltype.is_float:
            d = grp.reduce([torch.where(mask, data.to(torch.float64), 0.0)], ["sum"])[0]
            return Column(data=d, ltype=DOUBLE, validity=nonempty)
        x = torch.where(mask, data.to(torch.int64), 0)
        if agg._wide and (agg.ltype.id is TypeId.HUGEINT
                          or (c.ltype.id is TypeId.DECIMAL and agg.ltype.width > 18)):
            # exact beyond int64 through 32-bit halves (fused_agg's form);
            # value = hi64·2^64 + uint64(low64)
            hi, lo = _wide_sum(c, x, mask, grp, nonempty)
            return Column(data=lo, ltype=agg.ltype, validity=nonempty, data_hi=hi)
        return Column(data=grp.reduce([x], ["sum"])[0], ltype=agg.ltype, validity=nonempty)

    if f in ("avg", "mean"):
        if c.data_hi is not None:
            # the exact sum, then one rounding to DOUBLE
            w = _wide_sum(c, torch.where(mask, data.to(torch.int64), 0), mask, grp, nonempty)
            scale = 10.0 ** c.ltype.scale if c.ltype.id is TypeId.DECIMAL else 1.0
            d = I128.to_float(w) / (cnt.to(torch.float64) * scale)
            return Column(data=d, ltype=DOUBLE, validity=nonempty)
        if c.ltype.is_float:
            s = grp.reduce([torch.where(mask, _float_of(c, data), 0.0)], ["sum"])[0]
            return Column(data=s / cnt.to(torch.float64), ltype=DOUBLE, validity=nonempty)
        s = grp.reduce([torch.where(mask, data.to(torch.int64), 0)], ["sum"])[0]
        # avg(DECIMAL) as the reference: double(sum) / (double(n)·10^scale)
        scale = 10.0 ** c.ltype.scale if c.ltype.id is TypeId.DECIMAL else 1.0
        d = s.to(torch.float64) / (cnt.to(torch.float64) * scale)
        return Column(data=d, ltype=DOUBLE, validity=nonempty)

    if f in ("min", "max"):
        # VARCHAR codes index a sorted dictionary: their order is the strings'
        if c.ltype.id in UNSORTED_DICT_IDS:
            return _nested_min_max(agg, c, data, mask, grp, nonempty)
        if c.data_hi is not None:
            return _wide_min_max(f, agg, c, data, mask, grp, nonempty)
        if c.ltype.is_float:
            sent = float("inf") if f == "min" else float("-inf")
            x = torch.where(mask, data.to(torch.float64), sent)
        else:
            x = torch.where(mask, data.to(torch.int64), _I64_MAX if f == "min" else _I64_MIN)
        d = grp.reduce([x], [f])[0].to(c.data.dtype)
        return Column(data=d, ltype=agg.ltype, validity=nonempty, dict_values=c.dict_values)

    if f in ("bool_and", "bool_or"):
        x = torch.where(mask, data.to(torch.bool), f == "bool_and").to(torch.int64)
        d = grp.reduce([x], ["min" if f == "bool_and" else "max"])[0] > 0
        return Column(data=d, ltype=agg.ltype, validity=nonempty)

    if f in PICK_AGGS:
        return _pick_agg(agg, c, data, mask, grp, nonempty, extra, order_cols)

    if f == "product":
        d = grp.reduce([torch.where(mask, _float_of(c, data), 1.0)], ["prod"])[0]
        return Column(data=d, ltype=DOUBLE, validity=nonempty)

    if f in QUANTILE_AGGS:
        return _quantile_agg(agg, c, data, mask, grp, cnt, nonempty, extra)

    if f == "mode":
        kd = _key_data(c, plen)
        perm, gid_s, dead_s = grp.sorted_by([torch.where(mask, kd, 0)], mask)
        kd_s = kd[perm]
        change = (gid_s != torch.roll(gid_s, 1)) | (kd_s != torch.roll(kd_s, 1))
        change[0] = True
        my_len = run_lengths(change)  # dead rows (group G) run apart from live ones
        best_len = grp.reduce([torch.where(dead_s, 0, my_len)], ["max"], gid_s)[0]
        is_best = ~dead_s & (my_len == grp.at_rows(best_len, gid_s))
        # the smallest of the most frequent values
        pick = grp.reduce([torch.where(is_best, kd_s, _I64_MAX)], ["min"], gid_s)[0]
        d = (_decode_float_key(pick, c.data.dtype) if c.data.dtype.is_floating_point
             else pick.to(c.data.dtype))
        return Column(data=d, ltype=agg.ltype, validity=nonempty, dict_values=c.dict_values)

    if f in VARIANCE_AGGS:
        # two passes, as DuckDB's Welford update gives: each group's mean,
        # taken as its smallest value plus the mean offset from it (so
        # that equal values have exactly their value as the mean), then
        # the sum of squared deviations from that mean
        x = _float_of(c, data)
        n = cnt.to(torch.float64)
        pivot = grp.reduce([torch.where(mask, x, float("inf"))], ["min"])[0]
        off = grp.reduce([torch.where(mask, x - grp.at_rows(pivot), 0.0)], ["sum"])[0]
        mean = pivot + off / n.clamp(min=1)
        dev = torch.where(mask, x - grp.at_rows(mean), 0.0)
        m2 = grp.reduce([dev * dev], ["sum"])[0]
        pop = f.endswith("_pop")
        var = m2 / (n - (0 if pop else 1)).clamp(min=1)
        d = torch.sqrt(var) if f.startswith("stddev") else var
        return Column(data=d, ltype=DOUBLE, validity=cnt > (0 if pop else 1))

    if f in BITWISE_KINDS:
        d = grouped_bitwise(f, data, mask, lambda vs: grp.reduce(vs, ["sum"] * len(vs)), cnt)
        return Column(data=d.to(c.data.dtype), ltype=agg.ltype, validity=nonempty)

    if f == "approx_count_distinct":
        return _approx_count_distinct(agg, c, data, mask, grp)

    raise not_ported(f"the aggregate {f}()")


def _wide_sum(c: Column, x, mask, grp: Groups, nonempty):
    """The exact per-group sum of c's values (x: the low planes, masked)
    → (hi, lo); a sum that leaves int128 raises DuckDB's
    OutOfRangeException."""
    hi = None
    if c.data_hi is not None:
        hi = torch.where(mask, B.bcast(c.data_hi, x.shape[0]).to(torch.int64), 0)
    vecs = I128.sum_vectors(x, hi)
    w, ovf = I128.sum_finalize(grp.reduce(vecs, ["sum"] * len(vecs)))
    if bool((ovf & nonempty).any()):
        raise OutOfRangeException("Overflow in HUGEINT addition: the sum leaves int128")
    return w


def _wide_min_max(f, agg, c: Column, data, mask, grp: Groups, nonempty) -> Column:
    """min/max of wide values: the (hi, lo) pair compared lexicographically,
    hi signed and lo unsigned, in two passes: each group's extreme high
    half, then the extreme low half among its rows that hold it."""
    hi, lo = I128.limbs(data, c.data_hi, grp.plen)
    sent = _I64_MAX if f == "min" else _I64_MIN
    best_hi = grp.reduce([torch.where(mask, hi, sent)], [f])[0]
    on_best = mask & (hi == grp.at_rows(best_hi))
    ulo = grp.reduce([torch.where(on_best, lo ^ _I64_MIN, sent)], [f])[0]
    return Column(data=ulo ^ _I64_MIN, ltype=agg.ltype, validity=nonempty, data_hi=best_hi)


HLL_MAX_GROUPS = 2048  # above this many groups, the exact count
HLL_P_BITS = 11
HLL_REGISTERS = 1 << HLL_P_BITS


def _approx_count_distinct(agg, c, data, mask, grp: Groups) -> Column:
    """HyperLogLog as the reference computes it (aggregate_exec.py:947-985;
    DuckDB's src/common/types/hyperloglog.cpp): 2,048 registers per group,
    register = the low 11 bits of hash64 of the value's key, rho = leading
    zeros of the other 53 bits plus one, the per-group register max, then
    the raw estimate with the linear-counting correction, rounded. Above
    HLL_MAX_GROUPS groups the exact distinct count stands in. (The
    reference decides by its output capacity, which it learns across runs;
    the port by the group count.) The register max is a scatter_reduce_
    "amax": a max does not depend on the order of the writes."""
    plen = grp.plen
    if grp.n_groups > HLL_MAX_GROUPS:
        from duckdb_tpu_torch.execution.fused_agg import _compute_distinct_agg_mask

        return Column(data=grp.count(_compute_distinct_agg_mask(c, data, mask, grp.gids, plen)),
                      ltype=BIGINT)
    m = HLL_REGISTERS
    nseg = grp.n_groups + 1  # one register row takes the dead rows
    h = hash64(_key_data(c, plen))
    idx = h & (m - 1)
    rho = (clz64(h << HLL_P_BITS) + 1).clamp(max=64 - HLL_P_BITS + 1)
    rho = torch.where(mask, rho, 0)
    regs = torch.zeros(nseg * m, dtype=torch.int64, device=data.device)
    regs.scatter_reduce_(0, grp.gids.clamp(0, nseg - 1) * m + idx, rho, reduce="amax")
    r = regs.view(nseg, m)[:-1].to(torch.float64)
    alpha = 0.7213 / (1.0 + 1.079 / m)
    est = alpha * m * m / torch.pow(2.0, -r).sum(dim=1)
    zeros = (r == 0.0).sum(dim=1)
    linear = m * torch.log(m / zeros.clamp(min=1).to(torch.float64))
    est = torch.where((est <= 2.5 * m) & (zeros > 0), linear, est)
    d = torch.round(est).to(torch.int64)
    return Column(data=torch.cat([d, d.new_zeros(grp.G - grp.n_groups)]), ltype=BIGINT)


def _pick_agg(agg, c, data, mask, grp: Groups, nonempty, extra, order_cols) -> Column:
    """first / last / any_value (optionally ORDER BY inside the aggregate)
    and arg_min / arg_max (_null): the value of one row per group, the
    lowest row index among the candidates."""
    f = agg.func
    plen = grp.plen
    iota = torch.arange(plen, device=data.device)

    def lowest_best(key, cand):
        best = grp.reduce([torch.where(cand, key, _I64_MAX)], ["min"])[0]
        at_best = cand & (key == grp.at_rows(best))
        return grp.reduce([torch.where(at_best, iota, plen)], ["min"])[0]

    if f in ("first", "any_value", "last") and order_cols:
        oc, desc, nf = order_cols[0]
        od = B.bcast(oc.data, plen)
        if oc.ltype.id is TypeId.VARCHAR:
            od = od.to(torch.int64)
        ov = None if oc.validity is None else B.bcast(oc.validity, plen)
        key = S.orderable_int64(od.contiguous(), ov, bool(desc) != (f == "last"),
                                bool(nf) if nf is not None else False)
        pos = lowest_best(key, mask)
    elif f in ("first", "any_value"):
        pos = grp.reduce([torch.where(mask, iota, plen)], ["min"])[0]
    elif f == "last":
        pos = grp.reduce([torch.where(mask, iota, -1)], ["max"])[0]
    else:
        by = extra[0]
        by_data = B.bcast(by.data, plen)
        # arg_min_null / arg_max_null: a NULL argument is a candidate too
        cand = grp.live if f.endswith("_null") else mask
        if by.validity is not None:
            cand = cand & B.bcast(by.validity, plen)
        if by.ltype.id is TypeId.VARCHAR:
            by_data = by_data.to(torch.int64)
        key = S.orderable_int64(by_data.contiguous(), None, f.startswith("arg_max"), False)
        pos = lowest_best(key, cand)
        nonempty = grp.count(cand) > 0
    rows = pos.clamp(0, plen - 1)
    v = nonempty
    if c.validity is not None:
        v = v & B.bcast(c.validity, plen)[rows]
    return Column(data=data[rows], ltype=agg.ltype, validity=v, dict_values=c.dict_values)


def sorted_quantile(kd, mask, grp: Groups, cnt, q: float):
    """(lo, hi, frac) per group: the orderable codes `kd` of the rows in
    `mask` at positions floor and ceil of (n − 1)·q in value order, and the
    fraction between them; `cnt` is the per-group count of `mask`."""
    plen = grp.plen
    perm, gid_s, dead_s = grp.sorted_by([torch.where(mask, kd, 0)], mask)
    kd_s = kd[perm]
    iota = torch.arange(plen, device=kd.device)
    start = grp.reduce([torch.where(dead_s, plen, iota)], ["min"], gid_s)[0].clamp(max=plen)
    fpos = start.to(torch.float64) + (cnt - 1).to(torch.float64) * q
    lo_i = torch.floor(fpos).to(torch.int64).clamp(0, plen - 1)
    hi_i = torch.ceil(fpos).to(torch.int64).clamp(0, plen - 1)
    return kd_s[lo_i], kd_s[hi_i], fpos - torch.floor(fpos)


def _quantile_agg(agg, c, data, mask, grp: Groups, cnt, nonempty, extra) -> Column:
    """median / quantile_cont (interpolated) and quantile_disc: the rows of
    each group sorted by value, the value at start + (n − 1)·q."""
    f = agg.func
    plen = grp.plen
    q = 0.5
    if extra:
        try:
            qv = agg.args[1].const_value()
            at = agg.args[1].ltype
            q = float(qv) / (10 ** at.scale if at.id is TypeId.DECIMAL else 1)
        except (B.BindError, TypeError, ValueError):
            q = 0.5
    interpolate = f in ("median", "quantile_cont") and c.ltype.id is not TypeId.VARCHAR
    if c.data_hi is not None:
        # wide inputs rank as float64 (about 1 ulp at 1e19; the reference too)
        data = _float_of(c, data)
        c = Column(data=data, ltype=DOUBLE, validity=c.validity)
    lo_v, hi_v, frac = sorted_quantile(_key_data(c, plen), mask, grp, cnt, q)
    is_float = c.data.dtype.is_floating_point
    if interpolate:
        if is_float:
            lo_f = _decode_float_key(lo_v, torch.float64)
            hi_f = _decode_float_key(hi_v, torch.float64)
        else:
            # DECIMAL divides by 10^scale after the pick
            scale = 10.0 ** c.ltype.scale if c.ltype.id is TypeId.DECIMAL else 1.0
            lo_f = lo_v.to(torch.float64) / scale
            hi_f = hi_v.to(torch.float64) / scale
        return Column(data=lo_f + (hi_f - lo_f) * frac, ltype=DOUBLE, validity=nonempty)
    pick = torch.where(frac > 0.5, hi_v, lo_v)
    d = _decode_float_key(pick, c.data.dtype) if is_float else pick.to(c.data.dtype)
    return Column(data=d, ltype=agg.ltype, validity=nonempty, dict_values=c.dict_values)


# ---------------------------------------------------------------------------
# nested-result aggregates: one sort, one copy to the host, per-group values
def _nested_min_max(agg, c, data, mask, grp: Groups, nonempty) -> Column:
    """min/max of a nested value: the least/greatest DuckDB rank, mapped
    back to a code of that rank."""
    from duckdb_tpu_torch.blocks.nested import rank_lut

    lut = rank_lut(c.dict_values, c.ltype, data.device)
    rank = lut[data.long().clamp(0, lut.shape[0] - 1)]
    f = agg.func
    x = torch.where(mask, rank, _I64_MAX if f == "min" else _I64_MIN)
    best = grp.reduce([x], [f])[0]
    code_of = torch.zeros(int(lut.max()) + 1, dtype=torch.int64, device=data.device)
    code_of[lut] = torch.arange(lut.shape[0], device=data.device)  # equal ranks: equal values
    d = code_of[best.clamp(0, code_of.shape[0] - 1)].to(c.data.dtype)
    return Column(data=d, ltype=agg.ltype, validity=nonempty, dict_values=c.dict_values)


class _SortedRows:
    """The rows of `mask` sorted by (group, keys...) and stably by row
    otherwise. The boundaries are found on the card and only they come to
    the host: each group's [start, end) among the sorted rows, and, given
    `run_keys` (per row, in the original order), each run of equal
    (group, run keys): its count, group and first row, the first seen."""

    def __init__(self, grp: Groups, keys, mask, run_keys=()):
        perm, gid_s, dead_s = grp.sorted_by(keys, mask)
        n = int((~dead_s).sum())  # the row count, read once
        self.n = n
        self.perm = perm[:n]
        gid_s = gid_s[:n]
        new_group = torch.ones(n, dtype=torch.bool, device=perm.device)
        new_group[1:] = gid_s[1:] != gid_s[:-1]
        at = torch.nonzero(new_group).reshape(-1)
        self.starts = at.cpu().numpy()
        self.ends = np.append(self.starts[1:], n).astype(np.int64)
        self.groups = gid_s[at].cpu().numpy()
        if run_keys:
            new_run = new_group.clone()
            for k in run_keys:
                rk = k[self.perm]
                new_run[1:] |= rk[1:] != rk[:-1]
            rat = torch.nonzero(new_run).reshape(-1)
            self.run_starts = rat.cpu().numpy()
            self.run_counts = np.diff(np.append(self.run_starts, n))
            self.run_gid = gid_s[rat].cpu().numpy()
            self.run_rows = self.perm[rat]  # each run's first row (the sort is stable)

    def values(self, c: Column, data: torch.Tensor) -> list:
        """c's Python values in sorted order."""
        return _values_at(self.perm, c, data)

    def per_group(self, n_groups: int, make, empty):
        """[make(start, end) for each group with rows, `empty` otherwise]."""
        made = list(map(make, self.starts.tolist(), self.ends.tolist()))
        if len(made) == n_groups:  # every group has rows: they come in order
            return made
        out = [empty] * n_groups
        for g, m in zip(self.groups.tolist(), made):
            out[g] = m
        return out


def _group_column(entries, agg, grp: Groups, validity, varchar: bool) -> Column:
    """Per-group values (n_groups of them) → a Column sized G: VARCHAR over
    a sorted dictionary, nested values over a first-seen one."""
    from duckdb_tpu_torch.blocks.nested import encode_objects

    device = grp.live.device
    if varchar:
        uniq, inv = np.unique(np.array([e or "" for e in entries] or [""], dtype=str),
                              return_inverse=True)
        codes, dvals = inv.reshape(-1).astype(np.int32), uniq.astype(object)
    else:
        codes, dvals = encode_objects(entries)
    data = np.zeros(grp.G, dtype=np.int32)
    data[:len(entries)] = codes[:len(entries)]
    return Column(data=torch.from_numpy(data).to(device), ltype=agg.ltype, validity=validity,
                  dict_values=dvals)


def _value_key(c: Column, data: torch.Tensor) -> torch.Tensor:
    """An int64 per row that orders as the values do (nested: by rank)."""
    if c.ltype.id in UNSORTED_DICT_IDS:
        from duckdb_tpu_torch.blocks.nested import order_data

        return order_data(c, data.shape[0])
    return _key_data(c, data.shape[0])


def _const_arg(agg, i, default):
    try:
        v = agg.args[i].const_value() if len(agg.args) > i else None
    except (B.BindError, ValueError):
        v = None
    return default if v is None else v


def _nested_result_agg(agg, c, data, valid, grp: Groups, extra, order_cols, rows) -> Column:
    """list/array_agg, string_agg, histogram, histogram_exact, approx_top_k,
    bitstring_agg and lttb over the rows in `rows` (the live rows, or a
    FILTER's): NULL inputs are listed by list() and skipped by the others."""
    f = agg.func
    plen = grp.plen
    n_groups = grp.n_groups
    mask = rows if c.validity is None else rows & valid
    has_rows = grp.count(rows) > 0
    nonempty = grp.count(mask) > 0

    def order_keys():
        keys = []
        for oc, desc, nf in order_cols:
            od = B.bcast(oc.data, plen)
            if oc.ltype.id in UNSORTED_DICT_IDS:
                from duckdb_tpu_torch.blocks.nested import order_data

                od = order_data(oc, plen)
            ov = None if oc.validity is None else B.bcast(oc.validity, plen)
            keys.append(S.orderable_int64(od.contiguous(), ov, bool(desc),
                                          bool(nf) if nf is not None else False))
        return keys

    if f in ("list", "array_agg"):
        if agg.distinct:
            # each distinct value's first row (NULL is one value), found on
            # the card; then those rows in first-seen order per group
            key = torch.where(B.bcast(valid, plen), _value_key(c, data), 0) \
                if c.validity is not None else _value_key(c, data)
            null = (~B.bcast(valid, plen)).to(torch.int64) if c.validity is not None \
                else torch.zeros(plen, dtype=torch.int64, device=data.device)
            runs = _SortedRows(grp, [null, key], rows, run_keys=[null, key])
            first = torch.zeros(plen, dtype=torch.bool, device=data.device)
            first[runs.run_rows] = True
            rows = rows & first
        sr = _SortedRows(grp, order_keys(), rows)  # NULL elements are listed
        vals = sr.values(c, data)
        entries = sr.per_group(n_groups, lambda a, b: tuple(vals[a:b]), ())
        return _group_column(entries, agg, grp, has_rows, varchar=False)

    if f == "string_agg":
        sep = str(_const_arg(agg, 1, ","))
        sr = _SortedRows(grp, order_keys(), mask)
        vals = sr.values(c, data)
        entries = sr.per_group(n_groups, lambda a, b: sep.join(vals[a:b]), None)
        return _group_column(entries, agg, grp, nonempty, varchar=True)

    if f in ("histogram", "histogram_exact", "approx_top_k"):
        # runs of equal (group, value): each value's count, its first row
        key = torch.where(mask, _value_key(c, data), 0)
        sr = _SortedRows(grp, [key], mask, run_keys=[key])
        counts, run_gid, rep = sr.run_counts, sr.run_gid, sr.run_rows
        run_vals = _values_at(rep, c, data) if sr.n else []
        if f == "approx_top_k":
            k = int(_const_arg(agg, 1, 5))
            first = rep.cpu().numpy()
            order = np.lexsort((first, -counts, run_gid))  # ties: the first seen wins
            g = run_gid[order]
            keep = order[np.arange(len(order)) - np.searchsorted(g, g) < k]  # k per group
            entries = [()] * n_groups
            for part in np.split(keep, np.flatnonzero(np.diff(run_gid[keep])) + 1):
                if len(part):
                    entries[run_gid[part[0]]] = tuple(run_vals[i] for i in part.tolist())
            return _group_column(entries, agg, grp, has_rows, varchar=False)
        per = [dict() for _ in range(n_groups)]
        for g, v, n in zip(run_gid.tolist(), run_vals, counts.tolist()):
            per[g][v] = n
        if f == "histogram":  # keys in value order; a group of NULLs only is NULL
            entries = [tuple(d.items()) for d in per]
            return _group_column(entries, agg, grp, nonempty, varchar=False)
        bins = extra[0]
        bvals = tuple(bins.dict_values[int(bins.data.reshape(-1)[0])]) \
            if bins.dict_values is not None else ()
        entries = [tuple((b, d.get(b, 0)) for b in bvals) for d in per]
        return _group_column(entries, agg, grp, has_rows, varchar=False)

    if f == "bitstring_agg":
        # '1' at each value's offset from the lower bound (the arguments',
        # else the least and greatest value over every group)
        sr = _SortedRows(grp, [], mask)
        vh = data[sr.perm].cpu().numpy().astype(np.int64)
        gid = np.repeat(sr.groups, sr.ends - sr.starts)
        if len(extra) >= 2:
            lo, hi = int(extra[0].data.reshape(-1)[0]), int(extra[1].data.reshape(-1)[0])
        else:
            lo = int(vh.min()) if len(vh) else 0
            hi = int(vh.max()) if len(vh) else 0
        width = max(hi - lo + 1, 1)
        pos = vh - lo
        ok = (pos >= 0) & (pos < width)
        entries = []
        if n_groups * width <= 1 << 24:
            bits = np.zeros((n_groups, width), dtype=np.uint8)
            bits[gid[ok], pos[ok]] = 1
            entries = [bytes(r + 48).decode() for r in bits]
        else:
            for g in range(n_groups):
                sel = ok & (gid == g)
                row = np.zeros(width, dtype=np.uint8)
                row[pos[sel]] = 1
                entries.append(bytes(row + 48).decode())
        return _group_column(entries, agg, grp, has_rows, varchar=True)

    if f == "lttb":
        # largest-triangle-three-buckets over each group's (x, y) points
        sr = _SortedRows(grp, [], mask)
        xs = sr.values(c, data)
        ys = B.bcast(extra[0].data, plen).to(torch.float64)[sr.perm].cpu().tolist()
        n_out = int(_const_arg(agg, 2, 100))
        entries = sr.per_group(
            n_groups, lambda a, b: _lttb(sorted(zip(xs[a:b], ys[a:b])), n_out), ())
        return _group_column(entries, agg, grp, has_rows, varchar=False)

    raise not_ported(f"the aggregate {f}()")


def _values_at(rows: torch.Tensor, c: Column, data: torch.Tensor) -> list:
    """c's Python values at `rows` (one transfer of the data and one of
    the validity)."""
    from duckdb_tpu_torch.blocks.nested import host_pyvals

    d = data[rows].cpu().numpy()
    v = None if c.validity is None else B.bcast(c.validity, data.shape[0])[rows].cpu().numpy()
    hi = None if c.data_hi is None else B.bcast(c.data_hi, data.shape[0])[rows].cpu().numpy()
    return host_pyvals(d, v, c.dict_values, c.ltype, hi)


def _lttb(pts, n_out):
    m = len(pts)
    if m <= n_out or n_out < 3:
        return tuple(pts)
    sel = [pts[0]]
    bucket = (m - 2) / (n_out - 2)
    a_pt = pts[0]
    for bi in range(n_out - 2):
        s_ = int(1 + bi * bucket)
        e = min(int(1 + (bi + 1) * bucket), m - 1)
        ns = min(int(1 + (bi + 1) * bucket), m - 1)
        ne = min(int(1 + (bi + 2) * bucket), m)
        nxt = pts[ns:ne] or [pts[-1]]
        cx = sum(p[0] for p in nxt) / len(nxt)
        cy = sum(p[1] for p in nxt) / len(nxt)
        best, best_area = pts[s_], -1.0
        for p in pts[s_:e]:
            area = abs((a_pt[0] - cx) * (p[1] - a_pt[1]) - (a_pt[0] - p[0]) * (cy - a_pt[1]))
            if area > best_area:
                best, best_area = p, area
        sel.append(best)
        a_pt = best
    sel.append(pts[-1])
    return tuple(sel)
