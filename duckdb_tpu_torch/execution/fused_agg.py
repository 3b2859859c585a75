"""Fused scan→filter→project→aggregate pipeline over dense group slots.

The reference's tightest loop is the morsel-driven scan feeding
GroupedAggregateHashTable::AddChunk
(duckdb/src/execution/aggregate_hashtable.cpp:371). The JAX package
(duckdb_tpu/execution/fused_agg.py) traces the whole pipeline into one
XLA program. This port runs the same pipeline eagerly in torch, in the
JAX package's dense mode: when every group key has a statically bounded
domain (zone-map stats, dictionary length), group keys map to mixed-radix
slot ids — the PerfectAggregateHashTable analog — and every aggregate
becomes pre-masked per-row vectors reduced per slot by ops/grouped (int64
sums through the hand-written grouped-sum kernel).

Not yet ported: fused joins, in-pipeline compaction, the sort-group mode
for unbounded keys, and sharded execution. A plan that needs them makes
build_fused_agg return None.
"""

from __future__ import annotations

import datetime
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from duckdb_tpu_torch.blocks import Column, pad_bucket
from duckdb_tpu_torch.ops.compact import compact_indices
from duckdb_tpu_torch.ops.grouped import grouped_reduce
from duckdb_tpu_torch.planner import bound as B
from duckdb_tpu_torch.planner import plan as P
from duckdb_tpu_torch.types import BIGINT, TypeId

PERFECT_LIMIT = 1 << 23

_FUSABLE_AGGS = {"sum", "count", "count_star", "avg", "mean", "min", "max"}


def max_abs_bound(expr, src) -> Optional[int]:
    """Upper bound on |scaled value| of an int-typed expression, from
    zone-map stats (None = unbounded). Drives the exact->wide sum switch."""
    if isinstance(expr, B.BoundLiteral):
        v = expr.value
        return abs(int(v)) if isinstance(v, (int, np.integer)) else None
    if isinstance(expr, (B.BoundColumnRef, B.BoundAggregateRef)):
        try:
            rng = src.stats_range(expr.key)
        except (KeyError, AttributeError):
            return None
        return None if rng is None else max(abs(rng[0]), abs(rng[1]))
    if isinstance(expr, B.BoundArithmetic):
        lb = max_abs_bound(expr.left, src)
        rb = max_abs_bound(expr.right, src)
        if lb is None or rb is None:
            return None
        lt, rt, t = expr.left.ltype, expr.right.ltype, expr.ltype
        if t.id is TypeId.DECIMAL:
            sl = lt.scale if lt.id is TypeId.DECIMAL else 0
            sr = rt.scale if rt.id is TypeId.DECIMAL else 0
            if expr.op in ("+", "-"):
                return lb * 10 ** (t.scale - sl) + rb * 10 ** (t.scale - sr)
            if expr.op == "*":
                return lb * rb
            return None
        if expr.op in ("+", "-"):
            return lb + rb
        if expr.op == "*":
            return lb * rb
        return None
    if isinstance(expr, B.BoundCast):
        cb = max_abs_bound(expr.child, src)
        if cb is None:
            return None
        st, t = expr.child.ltype, expr.ltype
        if t.id is TypeId.DECIMAL:
            ss = st.scale if st.id is TypeId.DECIMAL else 0
            return cb * 10 ** max(0, t.scale - ss)
        return cb
    if isinstance(expr, B.BoundNegate):
        return max_abs_bound(expr.child, src)
    if isinstance(expr, B.BoundCase):
        # bound = max over result branches (conditional counting stays narrow)
        bounds = [max_abs_bound(r, src) for _, r in expr.whens]
        bounds.append(max_abs_bound(expr.else_expr, src)
                      if expr.else_expr is not None else 0)
        return None if any(b is None for b in bounds) else max(bounds)
    return None


def sum_needs_wide(agg, src, nrows: int) -> bool:
    """True if SUM may exceed int64 → use the hi/lo exact accumulation."""
    if not (agg.func == "sum" and agg.args
            and (agg.args[0].ltype.is_integer
                 or agg.args[0].ltype.id is TypeId.HUGEINT
                 or (agg.args[0].ltype.id is TypeId.DECIMAL
                     and agg.ltype.width > 18))):
        return False
    b = max_abs_bound(agg.args[0], src)
    if b is None:
        return True
    return b * max(1, nrows) >= (1 << 62)


def _expr_lo_hi(expr, lookup) -> Optional[Tuple[int, int]]:
    """Static (lo, hi) bounds of an integer-valued expression; lookup(ref)
    resolves column refs (table stats, dictionary length). Covers the
    date-part family over bounded DATE columns, as the reference sizes its
    perfect aggregate HT from stats
    (duckdb/src/execution/perfect_aggregate_hashtable.cpp)."""
    if isinstance(expr, B.BoundLiteral):
        v = expr.value
        if isinstance(v, (int, np.integer)) and not isinstance(v, bool):
            return (int(v), int(v))
        return None
    if isinstance(expr, (B.BoundColumnRef, B.BoundAggregateRef)):
        return lookup(expr)
    if isinstance(expr, B.BoundCast):
        if expr.ltype.is_integer or expr.ltype.id is TypeId.DATE:
            inner = _expr_lo_hi(expr.child, lookup)
            if inner is not None and (expr.child.ltype.is_integer
                                      or expr.child.ltype.id is TypeId.DATE):
                return inner
        return None
    if isinstance(expr, B.BoundFunction) and len(expr.args) == 1 \
            and isinstance(expr.args[0], (B.BoundColumnRef, B.BoundAggregateRef)) \
            and expr.args[0].ltype.id is TypeId.DATE:
        rng = lookup(expr.args[0])
        if rng is None:
            return None
        epoch = datetime.date(1970, 1, 1)
        try:
            dlo = epoch + datetime.timedelta(days=rng[0])
            dhi = epoch + datetime.timedelta(days=rng[1])
        except OverflowError:
            return None
        part = expr.name
        if part.startswith("extract_"):
            part = part[len("extract_"):]
        if part in ("extract", "date_part") and expr.impl is not None:
            # the part name is baked into the impl closure (functions.py
            # _extract_impl); recover it for bounds derivation
            for cell in (expr.impl.__closure__ or ()):
                if isinstance(cell.cell_contents, str):
                    part = cell.cell_contents
                    break
        return {"year": (dlo.year, dhi.year), "month": (1, 12), "day": (1, 31),
                "quarter": (1, 4)}.get(part)
    if isinstance(expr, B.BoundArithmetic) and expr.op in ("+", "-", "*"):
        lb = _expr_lo_hi(expr.left, lookup)
        rb = _expr_lo_hi(expr.right, lookup)
        if lb is None or rb is None or expr.ltype.id is TypeId.DECIMAL:
            return None
        if expr.op == "+":
            return (lb[0] + rb[0], lb[1] + rb[1])
        if expr.op == "-":
            return (lb[0] - rb[1], lb[1] - rb[0])
        prods = [a * b for a in lb for b in rb]
        return (min(prods), max(prods))
    return None


class FusedAgg:
    """Prepared fused aggregate: base batch + body.

    body(env over the needed base columns) → (cols: key→Column sized
    (total,), occ: int32 (total,)). Slot `i` is live iff occ[i] > 0.
    """

    def __init__(self, base_batch, needed, body, total, out_types):
        self.base_batch = base_batch
        self.needed = needed
        self.body = body
        self.total = total
        self.out_types = out_types  # key → (ltype, dict_values|None)


def build_fused_agg(executor, node: P.Aggregate) -> Optional[FusedAgg]:
    # 1. peel the Filter/Project chain down to a Scan
    chain = []
    base = node.child
    while isinstance(base, (P.Filter, P.Project)):
        chain.append(base)
        base = base.child
    if not isinstance(base, P.Scan):
        return None
    chain.reverse()
    for agg in node.aggs:
        if agg.func not in _FUSABLE_AGGS or agg.distinct or len(agg.args) > 1:
            return None
        if agg.ltype.id is TypeId.VARCHAR:
            return None  # min/max over strings: not yet ported

    # 2. projection overlay
    project_items = {}
    for nd in chain:
        if isinstance(nd, P.Project):
            project_items.update(nd.items)

    def resolve(e):
        while isinstance(e, B.BoundColumnRef) and e.key in project_items:
            e = project_items[e.key]
        return e

    group_resolved = [(gkey, resolve(ge)) for gkey, ge in node.groups]

    # 3. base batch + the base columns the pipeline reads
    base_batch = executor.execute(base)
    entry = executor.catalog.get_table(base.table)
    key2col = {key: col for col, key, _ in base.cols}
    needed: List[str] = []

    def collect(e):
        for nn in B.walk(e):
            if isinstance(nn, B.BoundColumnRef) and nn.key in key2col \
                    and nn.key not in needed:
                needed.append(nn.key)

    for nd in chain:
        if isinstance(nd, P.Filter):
            collect(nd.expr)
    for e in project_items.values():
        collect(e)
    for _, ge in group_resolved:
        collect(ge)
    for agg in node.aggs:
        for a in agg.args:
            collect(a)
    base_cols = {k: base_batch.src[k] for k in needed}

    def ref_bounds(ref):
        """(lo, hi) for a column ref: dictionary length or base-table stats."""
        c = base_cols.get(ref.key)
        if c is None:
            return None
        if c.ltype.id is TypeId.VARCHAR:
            return (0, len(c.dict_values)) if c.dict_values is not None else None
        if c.ltype.is_float:
            return None
        st = entry.stats_for(key2col[ref.key])
        if st.min_val is None or st.max_val is None:
            return None
        return (int(st.min_val), int(st.max_val))

    # 4. dense grouping: every key statically bounded
    mins, domains = [], []
    for _, ge in group_resolved:
        if isinstance(ge, (B.BoundColumnRef, B.BoundAggregateRef)) \
                and ge.key not in base_cols:
            return None  # unresolvable ref
        if ge.ltype.id is TypeId.VARCHAR and not isinstance(
                ge, (B.BoundColumnRef, B.BoundAggregateRef)):
            return None  # computed VARCHAR group key: dict is data-dependent
        b = _expr_lo_hi(ge, ref_bounds)
        if b is None:
            return None  # unbounded key: the sort-group mode is not yet ported
        mins.append(b[0])
        domains.append(b[1] - b[0] + 2)  # +1 slot for NULL
    total = 1
    for d in domains:
        total *= d
    if total > PERFECT_LIMIT:
        return None

    filters = [nd.expr for nd in chain if isinstance(nd, P.Filter)]
    out_types = {}
    for gkey, ge in group_resolved:
        if isinstance(ge, (B.BoundColumnRef, B.BoundAggregateRef)):
            c = base_cols[ge.key]
            out_types[gkey] = (c.ltype, c.dict_values)
        else:
            out_types[gkey] = (ge.ltype, None)
    for agg in node.aggs:
        out_types[agg.key] = (agg.ltype, None)

    strides = []
    stride = 1
    for d in reversed(domains):
        strides.append(stride)
        stride *= d
    strides.reverse()

    for agg in node.aggs:
        agg._wide = sum_needs_wide(agg, base_batch.src, entry.nrows)
    arg_types = [(agg.args[0].ltype if agg.args else BIGINT) for agg in node.aggs]

    def dense_ids(env, live, p):
        dense = torch.zeros(p, dtype=torch.int64, device=live.device)
        for (_, ge), lo, dom in zip(group_resolved, mins, domains):
            c = ge.eval(env)
            off = (B.bcast(c.data, p).to(torch.int64) - lo + 1).clamp(0, dom - 1)
            if c.validity is not None:
                off = torch.where(B.bcast(c.validity, p), off, 0)
            dense = dense * dom + off
        return torch.where(live, dense, total).to(torch.int32)

    def dense_reduce(env, live, p):
        dense = dense_ids(env, live, p)
        vecs, kinds = [], []
        for agg in node.aggs:
            for vec, kind in _slot_agg_partial_vectors(agg, env, live, p):
                vecs.append(vec)
                kinds.append(kind)
        # occupancy counted in int64 (the JAX package uses int32) so that it
        # rides in the grouped-sum kernel's launch instead of a second pass
        vecs.append(live.to(torch.int64))
        kinds.append("sum")
        res = grouped_reduce(dense, vecs, kinds, total)
        return res[:-1], res[-1].to(torch.int32)

    def dense_finalize(occ, flat):
        """Decode group keys, finalize aggregates."""
        if not node.groups:
            # ungrouped aggregate: exactly one output row, live even when
            # no input rows matched (SQL scalar-aggregate semantics)
            occ = torch.clamp(occ, min=1)
        cols: Dict[str, Column] = {}
        slots = torch.arange(total, dtype=torch.int64, device=occ.device)
        for (gkey, _), lo, dom, st in zip(group_resolved, mins, domains, strides):
            t, dvals = out_types[gkey]
            comp = (slots // st) % dom
            vals = comp - 1 + lo
            if not t.is_float:
                vals = vals.to(t.torch_dtype)
            cols[gkey] = Column(data=vals, ltype=t, validity=(comp > 0) & (occ > 0),
                                dict_values=dvals)
        i = 0
        for agg, at in zip(node.aggs, arg_types):
            n_parts = 1 if agg.func in ("count", "count_star") else (
                3 if agg._wide else 2)
            data, valid = _slot_agg_finalize(agg, flat[i:i + n_parts], at)
            i += n_parts
            if isinstance(data, tuple):  # wide sum: (low64, hi64)
                cols[agg.key] = Column(data=data[0], ltype=agg.ltype,
                                       validity=valid, data_hi=data[1])
            else:
                cols[agg.key] = Column(data=data, ltype=agg.ltype, validity=valid)
        return cols, occ

    def body(env):
        p = env.plen
        live = env.live
        env2_overlay = dict(project_items)
        from duckdb_tpu_torch.execution.tracing import TraceEnv

        env2 = TraceEnv({k: env[k] for k in needed}, p, live, overlay=env2_overlay)
        for f in filters:
            c = f.eval(env2)
            keep = B.bcast(c.data.to(torch.bool), p)
            if c.validity is not None:
                keep = keep & B.bcast(c.validity, p)
            live = live & keep
            env2.live = live
        flat, occ = dense_reduce(env2, live, p)
        return dense_finalize(occ, flat)

    return FusedAgg(base_batch, needed, body, total, out_types)


def try_fused_aggregate(executor, node: P.Aggregate):
    """Fused aggregate → Batch (or None when the plan needs what is not yet ported)."""
    from duckdb_tpu_torch.execution.executor import Batch, DictCols
    from duckdb_tpu_torch.execution.tracing import run_jitted

    fa = build_fused_agg(executor, node)
    if fa is None:
        return None
    keyrefs = [B.BoundColumnRef(k, fa.base_batch.src[k].ltype) for k in fa.needed]
    cols, occ = run_jitted(fa.base_batch, keyrefs, fa.body)
    n_groups = int((occ > 0).sum())
    out_plen = max(128, pad_bucket(n_groups))
    slot_idx, out_live = compact_indices(occ > 0, out_plen)
    out = {}
    for k in sorted(fa.out_types):
        t, dvals = fa.out_types[k]
        c = cols[k]
        v = c.validity[slot_idx] & out_live if c.validity is not None else None
        out[k] = Column(data=c.data[slot_idx], ltype=t, validity=v, dict_values=dvals,
                        data_hi=c.data_hi[slot_idx] if c.data_hi is not None else None)
    return Batch(src=DictCols(out), plen=out_plen, live=out_live)


def _slot_agg_partial_vectors(agg, env, live, plen):
    """Per-row vectors + combine kinds for one aggregate."""
    if agg.func == "count_star":
        return [(live.to(torch.int64), "sum")]
    c = agg.args[0].eval(env)
    data = B.bcast(c.data, plen)
    mask = live
    if c.validity is not None:
        mask = mask & B.bcast(c.validity, plen)
    cnt_vec = mask.to(torch.int64)
    if agg.func == "count":
        return [(cnt_vec, "sum")]
    if agg.func in ("sum", "avg", "mean"):
        if c.ltype.is_float:
            return [(torch.where(mask, data.to(torch.float64), 0.0), "sum"),
                    (cnt_vec, "sum")]
        x = torch.where(mask, data.to(torch.int64), 0)
        if (agg.func == "sum" and getattr(agg, "_wide", False)
                and (c.ltype.is_integer
                     or c.ltype.id is TypeId.HUGEINT
                     or (c.ltype.id is TypeId.DECIMAL and agg.ltype.width > 18))):
            return [(x >> 32, "sum"), (x & ((1 << 32) - 1), "sum"), (cnt_vec, "sum")]
        return [(x, "sum"), (cnt_vec, "sum")]
    if agg.func in ("min", "max"):
        if c.ltype.is_float:
            sent = float("inf") if agg.func == "min" else float("-inf")
            x = torch.where(mask, data.to(torch.float64), sent)
        else:
            info = torch.iinfo(torch.int64)
            sent = info.max if agg.func == "min" else info.min
            x = torch.where(mask, data.to(torch.int64), sent)
        return [(x, agg.func), (cnt_vec, "sum")]
    raise AssertionError(agg.func)


def _slot_agg_finalize(agg, parts, arg_type):
    """Combined partials → (data, validity|None)."""
    if agg.func in ("count_star", "count"):
        return (parts[0], None)
    if agg.func == "sum" and len(parts) == 3:
        hi32, lo, cnt = parts
        # value = hi32·2^32 + lo exactly; split into (hi64, low64) planes
        mask32 = (1 << 32) - 1
        mid = hi32 + (lo >> 32)
        low64 = ((mid & mask32) << 32) | (lo & mask32)
        return ((low64, mid >> 32), cnt > 0)
    cnt = parts[1]
    nonempty = cnt > 0
    if agg.func == "sum":
        return (parts[0], nonempty)
    if agg.func in ("avg", "mean"):
        s = parts[0]
        if arg_type.id is TypeId.DECIMAL:
            divisor = cnt.to(torch.float64) * float(10.0 ** arg_type.scale)
            return (s.to(torch.float64) / divisor, nonempty)
        return (s.to(torch.float64) / cnt.to(torch.float64), nonempty)
    if agg.func in ("min", "max"):
        return (parts[0].to(arg_type.torch_dtype), nonempty)
    raise AssertionError(agg.func)
