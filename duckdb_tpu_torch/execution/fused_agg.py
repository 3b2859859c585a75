"""Fused scan→filter→join*→project→aggregate pipeline.

The reference's tightest loops are the morsel-driven scan feeding
GroupedAggregateHashTable::AddChunk
(duckdb/src/execution/aggregate_hashtable.cpp:371) and the hash-join probe
chain (duckdb/src/execution/join_hashtable.cpp:1178). The JAX package
(duckdb_tpu/execution/fused_agg.py) traces the whole pipeline into one XLA
program; this port runs the same pipeline eagerly in torch.

Each inner join above the scan whose build key is proven unique becomes a
probe step: the build side executes eagerly (recursively, through the
executor's join family) and becomes a dense direct-address LUT (packed-key
domain ≤ DENSE_LUT_LIMIT) or a sorted key table probed with
torch.searchsorted; the prepared step is cached on the join node, keyed by
the build's table versions. Build columns the pipeline reads are gathered
lazily by the probe's matched build rows. Filters over the scan and probes
against filtered builds run first; the live count is then read once and
the frame compacted when that halves it; the other probes and filters run
at the compacted length. A join whose build is not proven unique (and
everything below it) executes eagerly, and the pipeline runs over its
output (where the JAX package takes aggregate_exec's general path).

Semi and anti joins (flattened EXISTS, IN and NOT EXISTS) fuse as
membership steps: their probe keeps (semi) or drops (anti) the rows whose
key is in the build, and no build column reaches the pipeline. Without a
residual, duplicate build keys are fine, since only membership is read.
With one, the build must be proven unique, and the residual is evaluated
on the matched build row and folded into the membership (`_extra_found`).
A NULL or out-of-range probe key is never found, so an anti step keeps
its row. NOT IN (null-aware) does not fuse: it runs eagerly.

Grouping:
- dense mixed-radix slot ids when every group key has a statically bounded
  domain (zone-map stats, dictionary length, date parts) — the
  PerfectAggregateHashTable analog — reduced per slot by ops/grouped (int64
  sums through the hand-written grouped-sum kernel);
- otherwise sort-group: a lexicographic sort over the keys (bounded keys
  packed into 62-bit words), group ids from key changes, and the same
  grouped reductions over those ids — the GroupedAggregateHashTable analog.

count, sum and avg DISTINCT take the same reductions over the first row
of each (group, value) run of a stable sort (`_compute_distinct_agg_mask`,
the JAX package's aggregate_exec._compute_distinct_agg), in either mode.

Sharded (`_num_shards`, `_run_sharded`): a dense aggregate whose rows the
executor shards runs the pipeline, its grouping and its per-slot
reductions on each shard's rows on that shard's device (the grouped-sum
kernel once per shard), the slot partials combine by kind on the home
device (sum, min, max), and the finalize runs once there. A join step's
LUT or sorted keys and its build columns are copied once to each device
and kept with the step (`_JoinStep.on`). A sort-group or DISTINCT
aggregate runs on one device, as the JAX package does for the first.

Not carried over (TPU-only, see ROADMAP): the bucket probe mode, the int32
packed-key dtype, learned compaction caps with deferred re-runs and the
probe-result cache.
"""

from __future__ import annotations

import datetime
import itertools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from duckdb_tpu_torch.blocks import Column, pad_bucket
from duckdb_tpu_torch.blocks.nested import UNSORTED_DICT_IDS
from duckdb_tpu_torch.execution.tracing import TraceEnv
from duckdb_tpu_torch.ops import int128 as I128
from duckdb_tpu_torch.ops import sort as S
from duckdb_tpu_torch.ops.compact import packed_indices
from duckdb_tpu_torch.ops.grouped import grouped_reduce
from duckdb_tpu_torch.planner import bound as B
from duckdb_tpu_torch.planner import plan as P
from duckdb_tpu_torch.types import BIGINT, TypeId

PERFECT_LIMIT = 1 << 23
DENSE_LUT_LIMIT = 1 << 27  # direct-address join LUT cap (int64 slots: 1 GiB)
# build-prep cache row bound: cached steps pin build column planes in
# device memory, so very large builds re-prep each run instead
PREP_CACHE_MAX_BUILD = 1 << 25
_I64_MAX = torch.iinfo(torch.int64).max

# a fresh number per unseeded sample a build cache key meets
_DRAWS = itertools.count()

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
    (slots,), occ: int32 (slots,)). Slot `i` is live iff occ[i] > 0.
    """

    def __init__(self, base_batch, needed, body, out_types, dense, head=None, partials=None,
                 finalize=None, distinct=False):
        self.base_batch = base_batch
        self.needed = needed
        self.body = body
        self.out_types = out_types  # key → (ltype, dict_values|None)
        self.dense = dense  # grouping mode: dense slots, else sort-group
        # the body in three steps for shards: head(env, routes) → (state,
        # live count tensor | None) runs the pipeline up to its
        # compaction; partials(state, live count | None, routes) → (occ,
        # per-slot partials, their kinds) runs the rest and the dense
        # reduction (dense only); finalize(occ, partials) → (cols, occ)
        # once the shards' partials are combined
        self.head = head
        self.partials = partials
        self.finalize = finalize
        self.distinct = distinct  # a DISTINCT aggregate (shard partials would double count)


class _JoinStep:
    """One fused probe step: build side prepared eagerly, probed per run.

    mode "dense": lut (size,) int64 — full packed key → build row (-1 none).
    mode "sorted": sk/sp — packed build keys sorted ascending (dead rows
    last, as INT64_MAX) and their build rows, probed by searchsorted.
    Build columns the pipeline touches are gathered by the matched build
    row at the probe's (compacted) length.
    """

    def __init__(self, mode, probe_keys, los, rngs, strides, size, build_plen,
                 build_src, lut=None, sk=None, sp=None, jtype="inner", extra=None):
        self.mode = mode
        self.jtype = jtype  # inner | semi | anti
        self.extra = extra  # semi/anti residual over probe ∪ build columns
        self.probe_keys = probe_keys
        self.los = los
        self.rngs = rngs
        self.strides = strides
        self.size = size
        self.build_plen = build_plen
        self.build_src = build_src  # eager ColSource of the build side
        self.lut, self.sk, self.sp = lut, sk, sp
        self.build_cols: Dict[str, Column] = {}  # key → build-length Column
        self.phase1 = False
        self._copies: Dict[torch.device, "_JoinStep"] = {}  # this step on other devices

    def on(self, device) -> "_JoinStep":
        """This step with its LUT or sorted keys and its build columns on
        `device`, copied there once and kept (a sharded pipeline probes on
        every shard's device)."""
        from duckdb_tpu_torch.parallel.shard import to

        table = self.lut if self.mode == "dense" else self.sk
        if table.device == device:
            return self
        step = self._copies.get(device)
        if step is None:
            step = _JoinStep(self.mode, self.probe_keys, self.los, self.rngs, self.strides,
                             self.size, self.build_plen, None,
                             lut=None if self.lut is None else to(self.lut, device),
                             sk=None if self.sk is None else to(self.sk, device),
                             sp=None if self.sp is None else to(self.sp, device),
                             jtype=self.jtype, extra=self.extra)
            step.build_cols = {k: _column_to(c, device) for k, c in self.build_cols.items()}
            self._copies[device] = step
        return step

    def register_build_col(self, key) -> bool:
        if key in self.build_cols:
            return True
        try:
            self.build_cols[key] = self.build_src[key]
        except KeyError:
            return False
        return True

    def probe(self, env, p):
        """→ (bidx int64 (p,), found bool (p,)): the matched build row (-1
        or a clipped row where not found) and whether the row's key is in
        range, non-NULL and present in the build."""
        device = env.live.device
        packed = torch.zeros(p, dtype=torch.int64, device=device)
        ok = torch.ones(p, dtype=torch.bool, device=device)
        for e, lo, rng, st in zip(self.probe_keys, self.los, self.rngs, self.strides):
            c = e.eval(env)
            v = B.bcast(c.data, p).to(torch.int64)
            okk = (v >= lo) & (v <= lo + rng - 1)
            if c.validity is not None:
                okk = okk & B.bcast(c.validity, p)
            # the digit only needs to be exact where okk holds
            packed = packed + (v - lo).clamp(0, rng - 1) * st
            ok = ok & okk
        if self.mode == "dense":
            bidx = self.lut[packed.clamp(0, self.size - 1)]
        else:
            pos = torch.searchsorted(self.sk, packed).clamp(max=self.sk.shape[0] - 1)
            bidx = torch.where(self.sk[pos] == packed, self.sp[pos], -1)
        return bidx, ok & (bidx >= 0)

    def register_lazy(self, env, bidx):
        """Register this step's build columns into env as lazy providers:
        a column is gathered at probe length only if something reads it."""
        for k in self.build_cols:
            env._overlay[k] = _LazyGatherCol(self, k, bidx)


def _column_to(c: Column, device) -> Column:
    from duckdb_tpu_torch.parallel.shard import to

    def move(x):
        return None if x is None else to(x, device)

    return Column(data=move(c.data), ltype=c.ltype, validity=move(c.validity),
                  dict_values=c.dict_values, data_hi=move(c.data_hi))


def _extra_found(step, env, p, bidx, found):
    """Fold a semi/anti residual into the membership mask: gather the
    (unique) matched build row's columns, evaluate the predicate, AND it
    with `found`. A NULL result is never TRUE (SQL three-valued semi-join
    semantics, the reference's ScanKeyMatches)."""
    step.register_lazy(env, bidx)
    c = step.extra.eval(env)
    ok = B.bcast(c.data.to(torch.bool), p)
    if c.validity is not None:
        ok = ok & B.bcast(c.validity, p)
    return found & ok


class _LazyGatherCol:
    """Overlay provider: gathers one build column by the probe's bidx on
    first access (TraceEnv caches the result)."""

    def __init__(self, step, key, bidx):
        self.step = step
        self.key = key
        self.bidx = bidx

    def eval(self, env):
        step = self.step
        col = step.build_cols[self.key]
        bc = self.bidx.clamp(0, step.build_plen - 1)

        def take(x):
            return None if x is None else B.bcast(x, step.build_plen)[bc]

        return Column(data=take(col.data), ltype=col.ltype, validity=take(col.validity),
                      dict_values=col.dict_values, data_hi=take(col.data_hi))


def _subtree_filters(node) -> bool:
    """True if the build subtree restricts rows (a Filter, Limit or join
    anywhere below) — such probes run BEFORE compaction."""
    stack = [node]
    while stack:
        n = stack.pop()
        if isinstance(n, (P.Filter, P.Limit, P.Join, P.Sample, P.Multiplicity)):
            return True
        stack += _children(n)
    return False


def _children(n) -> list:
    """The plan nodes directly under `n`."""
    out = [c for c in (getattr(n, a, None) for a in ("child", "probe", "build", "left",
                                                      "right")) if c is not None]
    return out + list(getattr(n, "inputs", ()))


def _scan_versions(executor, node):
    """(table, rows, version) for every Scan under `node`: the key of the
    build caches. A sample the session's generator draws is new on every
    run, so it adds a key that never repeats. None when a scan reads a
    chunk of its table (execution/chunked.py): a chunk's state is never
    cached, and no cached whole-table state answers a chunk."""
    out = []
    stack = [node]
    while stack:
        n = stack.pop()
        if isinstance(n, P.Scan):
            if n.table in executor.scan_overrides:
                return None
            ent = executor.catalog.get_table(n.table)
            out.append((n.table, ent.nrows, ent.version))
        elif isinstance(n, P.Sample) and n.seed is None:
            out.append(("", 0, next(_DRAWS)))
        stack += _children(n)
    return tuple(sorted(out))


def _cache_store(node, attr: str) -> dict:
    """Per-plan-node cache dict (the plan lives in the connection's plan
    cache, so warm queries find it), registered with
    execution/cache_registry so that OOM recovery can empty it."""
    from duckdb_tpu_torch.execution.cache_registry import tracked_dict

    store = node.__dict__.get(attr)
    if store is None:
        store = node.__dict__[attr] = tracked_dict()
    return store


def _prep_join_step(executor, j: P.Join) -> Optional[_JoinStep]:
    """Execute the build side eagerly and prepare its probe state, cached on
    the join node keyed by the build subtree's table versions: a warm query
    skips the build side entirely. The reference's hash table lives for one
    query (join_hashtable.cpp); this persists like an index until the data
    changes. None (also cached) when the join cannot fuse."""
    if j.jtype not in ("inner", "semi", "anti") or j.null_aware or not j.probe_keys:
        return None  # keyless joins (inequality, cross) run eagerly
    if j.extra is not None and j.jtype == "inner":
        return None  # an inner residual changes the match itself: eager path
    vkey = _scan_versions(executor, j.build)
    if vkey is None:
        return _prep_join_step_fresh(executor, j)
    cache = _cache_store(j, "_prep_cache")
    if vkey in cache:
        return cache[vkey]
    step = _prep_join_step_fresh(executor, j)
    if step is None or step.build_plen <= PREP_CACHE_MAX_BUILD:
        cache.clear()
        cache[vkey] = step
    return step


def _prep_join_step_fresh(executor, j: P.Join) -> Optional[_JoinStep]:
    bb = executor.execute(j.build)
    if not executor._build_known_unique(j, bb) and (j.jtype == "inner"
                                                    or j.extra is not None):
        # an inner probe needs ≤1 match per row, and a residual must be
        # evaluated on THE matched row; semi/anti membership alone takes
        # duplicate keys (the LUT keeps any one of their rows)
        return None
    env_b = bb.env()
    key_cols = []
    for e in j.build_keys:
        c = e.eval(env_b)
        if c.ltype.id is TypeId.VARCHAR or c.ltype.id in UNSORTED_DICT_IDS or c.ltype.is_float:
            return None  # dictionary-rank alignment / float keys: eager path
        key_cols.append(c)
    device = bb.live.device
    los, rngs = [], []
    for e, c in zip(j.build_keys, key_cols):
        bounds = executor._key_bounds(bb, e)
        if bounds is None:
            # no catalog stats (derived build key): measure the executed
            # build column once; the result rides the build-prep cache
            d = B.bcast(c.data, bb.plen).to(torch.int64)
            lv = bb.live if c.validity is None else bb.live & B.bcast(c.validity, bb.plen)
            if not bool(lv.any()):
                bounds = (0, 0)
            else:
                bounds = (int(torch.where(lv, d, 2**62).min()),
                          int(torch.where(lv, d, -2**62).max()))
        lo, hi = bounds
        los.append(lo)
        rngs.append(max(hi - lo + 1, 1))
    size = 1
    for r in rngs:
        size *= r
        if size > (1 << 62):
            return None
    strides = []
    st = 1
    for r in reversed(rngs):
        strides.append(st)
        st *= r
    strides.reverse()
    # packed build keys + live mask
    packed = torch.zeros(bb.plen, dtype=torch.int64, device=device)
    build_live = bb.live
    for c, lo, rng, st_ in zip(key_cols, los, rngs, strides):
        if c.validity is not None:
            build_live = build_live & B.bcast(c.validity, bb.plen)
        d = B.bcast(c.data, bb.plen).to(torch.int64)
        packed = packed + (d - lo).clamp(0, rng - 1) * st_
    rows = torch.arange(bb.plen, device=device)
    if size <= DENSE_LUT_LIMIT:
        # one live row per slot (any one of a duplicate key's rows, which
        # only a membership step allows); dead rows land in a spare slot
        # that is cut off
        lut = torch.full((size + 1,), -1, dtype=torch.int64, device=device)
        lut[torch.where(build_live, packed, size)] = rows
        step = _JoinStep("dense", list(j.probe_keys), los, rngs, strides, size,
                         bb.plen, bb.src, lut=lut[:size], jtype=j.jtype, extra=j.extra)
    else:
        # the JAX package's bucket mode exists for the TPU's serial gathers;
        # here a wide domain takes the sorted table
        sk, sp = torch.sort(torch.where(build_live, packed, _I64_MAX))
        step = _JoinStep("sorted", list(j.probe_keys), los, rngs, strides, size,
                         bb.plen, bb.src, sk=sk.contiguous(), sp=sp, jtype=j.jtype,
                         extra=j.extra)
    step.phase1 = _subtree_filters(j.build)
    if j.extra is not None:
        # the residual's build-side refs are the step's only build columns
        for nn in B.walk(j.extra):
            if isinstance(nn, B.BoundColumnRef):
                step.register_build_col(nn.key)
    return step


def _plan_keys(node) -> set:
    """Binding keys a plan subtree's batch provides."""
    if isinstance(node, P.Scan):
        return {key for _, key, _ in node.cols}
    if isinstance(node, P.Join):
        return _plan_keys(node.probe) | _plan_keys(node.build)
    if isinstance(node, P.Project):
        return _plan_keys(node.child) | {k for k, _ in node.items}
    if isinstance(node, P.Filter):
        return _plan_keys(node.child)
    if isinstance(node, P.Aggregate):
        return {k for k, _ in node.groups} | {a.key for a in node.aggs}
    if isinstance(node, (P.Order, P.Limit)):
        return _plan_keys(node.child)
    if isinstance(node, P.ListPack):
        return _plan_keys(node.child) | {node.key}
    if isinstance(node, P.Window):
        return _plan_keys(node.child) | {w.key for w in node.windows}
    if isinstance(node, P.Unnest):
        return _plan_keys(node.child) | set(node.keys)
    if isinstance(node, (P.CrossJoin, P.PositionalJoin, P.Sample)):
        return set().union(*[_plan_keys(c) for c in _children(node)])
    if isinstance(node, P.SetOp):
        return {k for k, _ in node.keys}
    if isinstance(node, P.Multiplicity):
        return {k for k, _ in node.child.groups}
    return set()


def build_fused_agg(executor, node: P.Aggregate) -> Optional[FusedAgg]:
    for agg in node.aggs:
        if agg.func not in _FUSABLE_AGGS or len(agg.args) > 1:
            return None
        if agg.ltype.id is TypeId.VARCHAR or agg.ltype.id in UNSORTED_DICT_IDS:
            return None  # min/max over strings or nested values: the general path
        if agg.func in ("min", "max") and agg.ltype.id is TypeId.HUGEINT:
            return None  # a (hi, lo) pair compares in two passes: the general path

    # 1. peel the Filter/Project/Join chain. Each inner, semi or anti join
    #    whose build can be prepared becomes a probe step (outermost first);
    #    the first that cannot (an outer join, a build not proven unique),
    #    or any other node (a scan, an aggregate, a derived table's ORDER BY
    #    or LIMIT), is the base, executed eagerly with everything below.
    #    Filters commute with these joins; the body applies probes and
    #    filters in dependency order.
    chain = []
    join_steps: List[_JoinStep] = []
    base = node.child
    while isinstance(base, (P.Filter, P.Project, P.Join)):
        if isinstance(base, P.Join):
            step = _prep_join_step(executor, base)
            if step is None:
                break
            join_steps.append(step)
            base = base.probe
        else:
            chain.append(base)
            base = base.child
    chain.reverse()
    join_steps.reverse()  # innermost (closest to the base) first

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

    # 3. base batch + column routing (base vs join build sides)
    base_batch = executor.execute(base)
    plen = base_batch.plen
    if isinstance(base, P.Scan):
        entry = executor.get_table(base.table)
        key2col = {key: col for col, key, _ in base.cols}
        base_rows = entry.nrows
    else:
        entry = None
        key2col = {k: None for k in _plan_keys(base)}
        base_rows = plen
    needed: List[str] = []

    def collect(e):
        for nn in B.walk(e):
            # an aggregate ref is a column of an Aggregate base
            if isinstance(nn, (B.BoundColumnRef, B.BoundAggregateRef)):
                if nn.key in key2col:
                    if nn.key not in needed:
                        needed.append(nn.key)
                elif nn.key in project_items:
                    continue  # overlay expr, its refs collected separately
                else:
                    for step in join_steps:
                        if step.jtype == "inner" and step.register_build_col(nn.key):
                            break

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
    for step in join_steps:
        for e in step.probe_keys + ([step.extra] if step.extra is not None else []):
            collect(e)  # a residual's probe-side refs
    base_cols = {k: base_batch.src[k] for k in needed}

    def col_lookup(key):
        if key in base_cols:
            return base_cols[key]
        for step in join_steps:
            if key in step.build_cols:
                return step.build_cols[key]
        return None

    def ref_bounds(ref):
        """(lo, hi) for a column ref: dictionary length, base-table stats,
        or build-side stats through the lazy source chain."""
        c = col_lookup(ref.key)
        if c is None:
            return None
        if c.ltype.id is TypeId.VARCHAR:
            return (0, len(c.dict_values)) if c.dict_values is not None else None
        if c.ltype.is_float:
            return None
        if ref.key in base_cols:
            if entry is None:
                return base_batch.src.stats_range(ref.key)
            st = entry.stats_for(key2col[ref.key])
            if st.min_val is None or st.max_val is None:
                return None
            return (int(st.min_val), int(st.max_val))
        for step in join_steps:
            if ref.key in step.build_cols:
                rng = step.build_src.stats_range(ref.key)
                return (int(rng[0]), int(rng[1])) if rng is not None else None
        return None

    # 4. grouping strategy: dense when every key is statically bounded
    mins, domains = [], []
    dense_mode = True
    for _, ge in group_resolved:
        if isinstance(ge, (B.BoundColumnRef, B.BoundAggregateRef)) \
                and col_lookup(ge.key) is None:
            return None  # unresolvable ref
        if (ge.ltype.id is TypeId.VARCHAR or ge.ltype.id in UNSORTED_DICT_IDS) \
                and not isinstance(ge, (B.BoundColumnRef, B.BoundAggregateRef)):
            # a computed VARCHAR or nested group key (its dictionary is
            # data-dependent): the general path
            return None
        b = _expr_lo_hi(ge, ref_bounds)
        if b is None:
            dense_mode = False
            break
        mins.append(b[0])
        domains.append(b[1] - b[0] + 2)  # +1 slot for NULL
    total = 1
    if dense_mode:
        for d in domains:
            total *= d
            if total > PERFECT_LIMIT:
                dense_mode = False
                break

    filters = [nd.expr for nd in chain if isinstance(nd, P.Filter)]
    proj_list = list(project_items.items())
    out_types = {}
    for gkey, ge in group_resolved:
        if isinstance(ge, (B.BoundColumnRef, B.BoundAggregateRef)):
            c = col_lookup(ge.key)
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

    # static per-key bounds for the sort-group mode: bounded keys pack
    # multiplicatively into few int64 words, so the sort has few keys
    sort_key_bounds = []
    if not dense_mode:
        for _, ge in group_resolved:
            if ge.ltype.is_float or (ge.ltype.id is TypeId.VARCHAR and not isinstance(
                    ge, (B.BoundColumnRef, B.BoundAggregateRef))):
                sort_key_bounds.append(None)
            else:
                sort_key_bounds.append(_expr_lo_hi(ge, ref_bounds))

    for agg in node.aggs:
        agg._wide = sum_needs_wide(agg, base_batch.src, base_rows)
    arg_types = [(agg.args[0].ltype if agg.args else BIGINT) for agg in node.aggs]

    # 5. phase split: probes against RESTRICTIVE builds (filtered subtrees)
    #    run before the compaction, so the compacted length reflects their
    #    selectivity; probes against unfiltered dimension builds run after
    #    it (their masks still apply)
    def _all_refs(e, acc):
        pending = [e]
        seen = set()
        while pending:
            x = pending.pop()
            for nn in B.walk(x):
                if isinstance(nn, (B.BoundColumnRef, B.BoundAggregateRef)):
                    if nn.key in project_items and nn.key not in seen:
                        seen.add(nn.key)
                        pending.append(project_items[nn.key])
                    elif nn.key not in project_items:
                        acc.add(nn.key)

    def step_refs(step):
        """Probe-side columns the step reads (keys, residual)."""
        refs = set()
        for e in step.probe_keys + ([step.extra] if step.extra is not None else []):
            _all_refs(e, refs)
        return refs - set(step.build_cols) if step.jtype != "inner" else refs

    phase1_steps: List[_JoinStep] = []
    phase2_steps: List[_JoinStep] = []
    avail = set(key2col)
    for step in join_steps:
        if step.phase1 and step_refs(step) <= avail:
            phase1_steps.append(step)
            if step.jtype == "inner":
                avail |= set(step.build_cols)
        else:
            phase2_steps.append(step)

    def _refs_build_cols(f):
        refs = set()
        _all_refs(f, refs)
        return not refs <= set(key2col)

    # filters over base columns only run before any probe; anything
    # touching a join's build columns runs after every probe
    filters1 = [f for f in filters if not _refs_build_cols(f)]
    filters2 = [f for f in filters if _refs_build_cols(f)]
    # a compaction only pays when something downstream runs at the shrunken
    # length: more probes, a sort-group, or a wide dense domain
    compact_downstream = bool(phase2_steps or not dense_mode or total > (1 << 10))

    class _LazyBaseCol:
        """Post-compaction base column: one gather from the original plane
        (n rows) through the row selection, evaluated only on access."""

        def __init__(self, col, sel, n):
            self.col = col
            self.sel = sel
            self.n = n

        def eval(self, env):
            c, sel = self.col, self.sel

            def take(x):
                return None if x is None else B.bcast(x, self.n)[sel]

            return Column(data=take(c.data), ltype=c.ltype, validity=take(c.validity),
                          dict_values=c.dict_values, data_hi=take(c.data_hi))

    def apply_filters(fs, env2, p, live):
        for f in fs:
            c = f.eval(env2)
            keep = B.bcast(c.data.to(torch.bool), p)
            if c.validity is not None:
                keep = keep & B.bcast(c.validity, p)
            live = live & keep
            env2.live = live
        return live

    def apply_probes(steps, env2, p, live, bidx_map, routes):
        """Inner steps keep the matched rows and register their build
        columns; semi steps keep the rows found, anti steps those not
        found, and neither registers a column for the pipeline. Each step
        probes on the device of the rows (its copy there)."""
        for step in steps:
            step = step.on(live.device)
            routes["probe_" + step.mode] += 1
            bidx, found = step.probe(env2, p)
            if step.extra is not None:
                found = _extra_found(step, env2, p, bidx, found)
            live = live & ~found if step.jtype == "anti" else live & found
            env2.live = live
            if step.jtype == "inner":
                bidx_map[step] = bidx
                step.register_lazy(env2, bidx)
            else:
                routes["fused_" + step.jtype] += 1
        return live

    def pipeline_head(env, routes):
        """Filters and restrictive probes over env's rows (the base
        batch's, or one shard's) → the state pipeline_tail takes, and the
        live count tensor its compaction needs (None: no compaction)."""
        p = env.plen
        live = env.live
        env2 = TraceEnv({k: env[k] for k in needed}, p, live, overlay=dict(proj_list))
        bidx_map = {}
        live = apply_filters(filters1, env2, p, live)
        live = apply_probes(phase1_steps, env2, p, live, bidx_map, routes)
        count = live.sum() if p > (1 << 16) and compact_downstream else None
        return (env, env2, live, p, bidx_map), count

    def pipeline_tail(state, n_live, routes):
        """One compaction to n_live rows (read from the head's count) where
        it halves the length, then the other probes and filters →
        (env2, live, p)."""
        env, env2, live, p, bidx_map = state
        cap = max(128, pad_bucket(n_live)) if n_live is not None else p
        if cap <= p // 2:
            sel = packed_indices(live, cap)
            live = torch.arange(cap, device=live.device) < n_live
            env2 = TraceEnv({}, cap, live, overlay=dict(proj_list))
            for k in needed:
                env2._overlay[k] = _LazyBaseCol(env[k], sel, env.plen)
            for st, b in list(bidx_map.items()):
                bidx_map[st] = b[sel]
                st.register_lazy(env2, bidx_map[st])
            p = cap
        live = apply_probes(phase2_steps, env2, p, live, bidx_map, routes)
        live = apply_filters(filters2, env2, p, live)
        return env2, live, p

    def run_pipeline(env, routes):
        """The whole pipeline on one device: the live count read once."""
        state, count = pipeline_head(env, routes)
        return pipeline_tail(state, None if count is None else int(count), routes)

    def agg_partial_vectors(env, live, p, gids):
        vecs, kinds = [], []
        for agg in node.aggs:
            for vec, kind in _slot_agg_partial_vectors(agg, env, live, p, gids):
                vecs.append(vec)
                kinds.append(kind)
        return vecs, kinds

    def finalize_aggs(cols, flat):
        i = 0
        for agg, at in zip(node.aggs, arg_types):
            n_parts = 1 if agg.func in ("count", "count_star") else (
                _wide_parts(agg) or 1) + 1
            data, valid = _slot_agg_finalize(agg, flat[i:i + n_parts], at)
            i += n_parts
            if isinstance(data, tuple):  # wide sum: (low64, hi64)
                cols[agg.key] = Column(data=data[0], ltype=agg.ltype,
                                       validity=valid, data_hi=data[1])
            else:
                cols[agg.key] = Column(data=data, ltype=agg.ltype, validity=valid)

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
        """→ (per-slot partials, occupancy, the partials' kinds)."""
        dense = dense_ids(env, live, p)
        vecs, kinds = agg_partial_vectors(env, live, p, dense)
        # occupancy counted in int64 (the JAX package uses int32) so that it
        # rides in the grouped-sum kernel's launch instead of a second pass
        vecs.append(live.to(torch.int64))
        kinds.append("sum")
        res = grouped_reduce(dense, vecs, kinds, total)
        return res[:-1], res[-1].to(torch.int32), kinds[:-1]

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
        finalize_aggs(cols, flat)
        return cols, occ

    def sort_group_reduce(env, live, p):
        """Sort-group at the pipeline's (compacted) length → (cols, occ)."""
        key_cols = [ge.eval(env) for _, ge in group_resolved]
        device = live.device
        keys = []
        # bounded keys pack multiplicatively into 62-bit words (NULL takes
        # the top digit, so it sorts after every value); unbounded keys keep
        # their own (null flag, value) pair
        word = None
        word_dom = 1
        for c, b in zip(key_cols, sort_key_bounds):
            kv = (B.bcast(c.validity, p) if c.validity is not None
                  else torch.ones(p, dtype=torch.bool, device=device))
            kd = S.orderable_int64(B.bcast(c.data, p), None, False, False)
            if b is not None:
                lo, rng = int(b[0]), int(b[1] - b[0] + 1)
                dom = rng + 1
                if word is not None and word_dom * dom > (1 << 62):
                    keys.append(word)
                    word, word_dom = None, 1
                digit = torch.where(kv, (kd - lo).clamp(0, rng - 1), rng)
                word = digit if word is None else word * dom + digit
                word_dom *= dom
            else:
                if word is not None:
                    keys.append(word)
                    word, word_dom = None, 1
                keys.append((~kv).to(torch.int64))
                keys.append(torch.where(kv, kd, 0))
        if word is not None:
            keys.append(word)
        # live rows first, then lexicographic by the key words (stable
        # passes; the JAX sort is unstable, and any row of a group serves as
        # its representative)
        perm = S.sort_permutation(keys, live)
        dead_s = ~live[perm]
        change = torch.zeros(p, dtype=torch.bool, device=device)
        for k in keys:
            ks = k[perm]
            change = change | (ks != torch.roll(ks, 1))
        change = change & ~dead_s
        change[0] = ~dead_s[0]
        cap = max(128, pad_bucket(p))
        gid_sorted = torch.where(dead_s, cap, torch.cumsum(change.to(torch.int64), 0) - 1)
        gids = torch.empty(p, dtype=torch.int64, device=device)
        gids[perm] = gid_sorted
        # per-group reductions over the group ids (dead rows hold id cap,
        # outside the slots): the aggregates' partial vectors, each group's
        # smallest row (its representative) and its occupancy
        vecs, kinds = agg_partial_vectors(env, live, p, gids)
        res = grouped_reduce(gids, vecs + [torch.arange(p, device=device), live.to(torch.int64)],
                             kinds + ["min", "sum"], cap)
        rep_rows = res[-2].clamp(max=p - 1)
        occ = res[-1].to(torch.int32)
        cols: Dict[str, Column] = {}
        for (gkey, _), c in zip(group_resolved, key_cols):
            validity = (B.bcast(c.validity, p)[rep_rows] & (occ > 0)
                        if c.validity is not None else None)
            cols[gkey] = Column(data=B.bcast(c.data, p)[rep_rows], ltype=c.ltype,
                                validity=validity, dict_values=c.dict_values)
        finalize_aggs(cols, res[:-2])
        return cols, occ

    def body(env):
        env2, live, p = run_pipeline(env, executor.routes)
        if dense_mode:
            executor.routes["dense"] += 1
            flat, occ, _ = dense_reduce(env2, live, p)
            return dense_finalize(occ, flat)
        executor.routes["sort_group"] += 1
        return sort_group_reduce(env2, live, p)

    def partials(state, n_live, routes):
        env2, live, p = pipeline_tail(state, n_live, routes)
        flat, occ, kinds = dense_reduce(env2, live, p)
        return occ, flat, kinds

    return FusedAgg(base_batch, needed, body, out_types, dense_mode,
                    head=pipeline_head, partials=partials if dense_mode else None,
                    finalize=dense_finalize if dense_mode else None,
                    distinct=any(agg.distinct for agg in node.aggs))


def try_fused_aggregate(executor, node: P.Aggregate):
    """Fused aggregate → Batch (or None when the plan needs what is not yet ported)."""
    from duckdb_tpu_torch.execution.executor import Batch, DictCols
    from duckdb_tpu_torch.execution.tracing import run_jitted

    fa = build_fused_agg(executor, node)
    if fa is None:
        return None
    n_shards = _num_shards(executor, fa)
    if n_shards > 1:
        cols, occ = _run_sharded(executor, fa, n_shards)
    else:
        keyrefs = [B.BoundColumnRef(k, fa.base_batch.src[k].ltype) for k in fa.needed]
        cols, occ = run_jitted(fa.base_batch, keyrefs, fa.body)
    n_groups = int((occ > 0).sum())
    out_plen = max(128, pad_bucket(n_groups))
    slot_idx = packed_indices(occ > 0, out_plen)
    out_live = torch.arange(out_plen, device=occ.device) < n_groups
    out = {}
    for k in sorted(fa.out_types):
        t, dvals = fa.out_types[k]
        c = cols[k]
        v = c.validity[slot_idx] & out_live if c.validity is not None else None
        # a computed VARCHAR key's dictionary is known only once it is
        # evaluated (the sort-group mode carries it on its key column)
        out[k] = Column(data=c.data[slot_idx], ltype=t, validity=v,
                        dict_values=c.dict_values if dvals is None else dvals,
                        data_hi=c.data_hi[slot_idx] if c.data_hi is not None else None)
    return Batch(src=DictCols(out), plen=out_plen, live=out_live)


def _num_shards(executor, fa: FusedAgg) -> int:
    """How many shards the aggregate runs on: the executor's count over its
    base rows, 1 for a sort-group aggregate (group ids are shard-local, as
    in the JAX package) or a DISTINCT one (a value in two shards would
    count twice); those record their reason in routes."""
    n = executor._join_shards(rows=fa.base_batch.plen)
    if n <= 1:
        return 1
    reason = "sort_group aggregate" if not fa.dense else (
        "distinct aggregate" if fa.distinct else None)
    if reason is not None:
        executor._single_chip(reason)
        return 1
    return n


def _split_column(mesh, c: Column, plen: int) -> List[Column]:
    """A base column's planes cut into the shards' rows; a plane that is
    not row-length (a broadcast constant) is copied whole."""
    from duckdb_tpu_torch.parallel import shard

    def parts(x):
        if x is None:
            return [None] * mesh.n
        if x.dim() == 1 and x.shape[0] == plen:
            return shard.split_rows(mesh, x)
        return shard.replicate(mesh, x)

    return [Column(data=d, ltype=c.ltype, validity=v, dict_values=c.dict_values, data_hi=h)
            for d, v, h in zip(parts(c.data), parts(c.validity), parts(c.data_hi))]


def _run_sharded(executor, fa: FusedAgg, n: int):
    """The dense aggregate over the mesh: each shard runs the pipeline and
    the per-slot reductions over its rows on its device, the slot partials
    combine by kind on the home device (psum, pmin, pmax: DuckDB's
    Combine, physical_operator.hpp's sink contract), and the finalize runs
    once there. → (cols, occ) as the single-device body gives them."""
    import collections

    from duckdb_tpu_torch.parallel import shard

    mesh = executor._mesh(n, "sharded_agg")
    executor.routes["dense"] += 1
    batch = fa.base_batch
    lives = shard.split_rows(mesh, batch.live)
    cols = {k: _split_column(mesh, batch.src[k], batch.plen) for k in fa.needed}
    # the probe routes once per aggregate, as a single-device run has them
    routes = [executor.routes] + [collections.Counter() for _ in lives[1:]]
    heads = [fa.head(TraceEnv({k: cols[k][i] for k in fa.needed}, live.shape[0], live),
                     routes[i]) for i, live in enumerate(lives)]
    # every shard's head is enqueued before the live counts are read, in
    # one transfer, so that no card waits on another's sync
    counts = [c for _, c in heads if c is not None]
    read = iter(shard.host_ints(mesh, counts))
    occs, flats = [], []
    for (state, count), r in zip(heads, routes):
        occ, flat, kinds = fa.partials(state, None if count is None else next(read)[0], r)
        occs.append(occ)
        flats.append(flat)
    combine = {"sum": shard.psum, "min": shard.pmin, "max": shard.pmax}
    flat = [combine[kind](mesh, [f[j] for f in flats]) for j, kind in enumerate(kinds)]
    return fa.finalize(shard.psum(mesh, occs), flat)


def _compute_distinct_agg_mask(c, data, mask, gids, plen):
    """The JAX package's aggregate_exec._compute_distinct_agg as a row mask:
    a stable sort over (dead, group id, value) and, per (group, value) run,
    its first row. Aggregating only those rows gives count/sum/avg
    DISTINCT, and the per-group counts and sums stay the grouped
    reduction's sums (never a scatter whose winner decides); a group with
    no live value counts 0, and its sum and avg are NULL."""
    keys = [gids.to(torch.int64)]
    if c.data_hi is not None:  # a wide value: (hi, lo) compare together
        keys.append(B.bcast(c.data_hi, plen).to(torch.int64))
    keys.append(S.orderable_int64(data, None, False, False))
    perm = S.sort_permutation(keys, mask)
    change = torch.zeros(plen, dtype=torch.bool, device=mask.device)
    for k in keys:
        ks = k[perm]
        change = change | (ks != torch.roll(ks, 1))
    change[0] = True
    first = torch.empty_like(mask)
    first[perm] = change & mask[perm]  # perm is a permutation: one writer per row
    return first


def _slot_agg_partial_vectors(agg, env, live, plen, gids=None):
    """Per-row vectors + combine kinds for one aggregate; `gids`, which a
    DISTINCT aggregate needs, are the rows' slot or group ids (dead rows
    outside the slots)."""
    if agg.func == "count_star":
        return [(live.to(torch.int64), "sum")]
    c = agg.args[0].eval(env)
    data = B.bcast(c.data, plen)
    mask = live
    if c.validity is not None:
        mask = mask & B.bcast(c.validity, plen)
    if agg.distinct:
        mask = _compute_distinct_agg_mask(c, data, mask, gids, plen)
    cnt_vec = mask.to(torch.int64)
    if agg.func == "count":
        return [(cnt_vec, "sum")]
    if agg.func in ("sum", "avg", "mean"):
        if c.ltype.is_float:
            return [(torch.where(mask, data.to(torch.float64), 0.0), "sum"),
                    (cnt_vec, "sum")]
        x = torch.where(mask, data.to(torch.int64), 0)
        wide = _wide_parts(agg)
        if wide:
            hi = None
            if wide == 4:  # HUGEINT: the high planes (sign-extended lows if none)
                hi = torch.where(mask, I128.limbs(c.data, c.data_hi, plen)[0], 0)
            return [(v, "sum") for v in I128.sum_vectors(x, hi)] + [(cnt_vec, "sum")]
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


def _wide_parts(agg) -> int:
    """The exact-sum vectors (ops/int128.sum_vectors) of a sum or avg:
    4 over HUGEINT values, 2 for a sum that may leave int64, else 0."""
    if agg.func not in ("sum", "avg", "mean") or not agg.args:
        return 0
    t = agg.args[0].ltype
    if t.id is TypeId.HUGEINT:
        return 4
    if (agg.func == "sum" and getattr(agg, "_wide", False)
            and (t.is_integer or (t.id is TypeId.DECIMAL and agg.ltype.width > 18))):
        return 2
    return 0


def _slot_agg_finalize(agg, parts, arg_type):
    """Combined partials → (data, validity|None)."""
    if agg.func in ("count_star", "count"):
        return (parts[0], None)
    if len(parts) > 2:  # an exact wide sum: value = hi64·2^64 + uint64(low64)
        cnt = parts[-1]
        (hi, lo), ovf = I128.sum_finalize(parts[:-1])
        if bool((ovf & (cnt > 0)).any()):
            from duckdb_tpu_torch.errors import OutOfRangeException

            raise OutOfRangeException("Overflow in HUGEINT addition: the sum leaves int128")
        if agg.func == "sum":
            return ((lo, hi), cnt > 0)
        scale = 10.0 ** arg_type.scale if arg_type.id is TypeId.DECIMAL else 1.0
        return (I128.to_float((hi, lo)) / (cnt.to(torch.float64) * scale), cnt > 0)
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
