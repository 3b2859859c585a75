"""Out-of-core execution: the largest scan in row chunks, under a memory limit.

As in the JAX package (duckdb_tpu/execution/chunked.py). When the
columns a query reads, times WORKING_SET_FACTOR (live masks, gathered
intermediates, sort payloads), pass the device memory limit
(catalog.set_memory_limit), the device cannot hold them at once. DuckDB
spills operator state to temp files (physical_hash_join.cpp's external
join, temporary_memory_manager.cpp); here host DRAM and temp files are
the spill tier, and the fact table streams through the device in row
chunks:

    for each chunk of the largest scanned table:
        run the plan with that scan reading the chunk (a row slice)
        append the chunk's result to the spill tier (host DRAM and temp files)
    run the query's tail over the concatenated results, with MERGE
    aggregates (avg as a sum and a count)

A plan chunks when it is Limit?(Order?(Project(Filter?(Aggregate(X)))))
with every aggregate mergeable (sum, count, min, max, avg, bool_and,
bool_or, product, first, last, any_value, fsum), or aggregate-free (a
pure select: chunk outputs concatenate, and an ORDER BY over more rows
than the limit holds sorts range partitions of them one at a time). The
chunked scan must reach the root through Filter, Project and the probe
side of joins that emit nothing for an unmatched build row (not FULL
OUTER): each probe row joins in exactly one chunk, and the build side
runs again for each chunk, from the join caches (which never hold a
chunk's state: fused_agg._scan_versions). A chunk's statistics are its
own zone maps, so dense slot domains follow the chunk.

The executor records "out_of_core" and "out_of_core_chunks" (the chunk
count) in its routes, or "out_of_core_fallback" when a plan over the
limit cannot chunk, or a chunk's partial passes 64 bits, and runs in
memory (DuckDB would spill instead); it logs each as the JAX package
does, type out_of_core in duckdb_logs(). Spill files go under the
temp_directory setting (storage/spill.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Dict, List, Tuple

import numpy as np
import torch

from duckdb_tpu_torch.blocks import Column
from duckdb_tpu_torch.blocks.nested import UNSORTED_DICT_IDS
from duckdb_tpu_torch.catalog.catalog import POOL, ColumnDef, TableEntry
from duckdb_tpu_torch.planner import bound as B
from duckdb_tpu_torch.planner import plan as P
from duckdb_tpu_torch.types import BIGINT, DOUBLE, LogicalType, TypeId

# device working set as a multiple of the bytes of the columns scanned
WORKING_SET_FACTOR = 2.5

# aggregate → the aggregate that merges its chunk partials (avg splits)
MERGEABLE = {
    "sum": "sum", "count": "sum", "count_star": "sum",
    "min": "min", "max": "max", "bool_and": "bool_and",
    "bool_or": "bool_or", "product": "product",
    "first": "first", "any_value": "first", "last": "last",
    "fsum": "fsum",
}

_TMP_NAME = "__ooc_partials"

# joins whose output rows each come from one probe row: their probe side
# may stream (a FULL join also emits the build rows no probe row matched,
# which no one chunk can tell)
_STREAMING_JOINS = ("inner", "left", "semi", "anti", "asof", "asof_left")

# chunk outputs the spill tier cannot concatenate: dictionaries that are
# not of sorted strings
_UNSPILLABLE = UNSORTED_DICT_IDS + (TypeId.BLOB,)


def _plan_children(node: P.PlanNode) -> List[Tuple[str, P.PlanNode]]:
    return [(name, c) for name in ("child", "probe", "build", "left", "right")
            if isinstance(c := getattr(node, name, None), P.PlanNode)] + \
        [("input", c) for c in getattr(node, "inputs", ())]


def _used_keys(plan: P.PlanNode) -> set:
    """Every column key an expression of the plan reads."""
    used: set = set()
    stack = [plan]
    while stack:
        n = stack.pop()
        exprs = [e for e in (getattr(n, "expr", None), getattr(n, "extra", None))
                 if e is not None]
        for attr in ("items", "groups"):
            for it in getattr(n, attr, ()) or ():
                exprs.extend(x for x in (it if isinstance(it, tuple) else (it,))
                             if isinstance(x, B.BoundExpr))
        exprs += list(getattr(n, "probe_keys", ()) or ()) + list(getattr(n, "build_keys", ())
                                                                  or ())
        exprs += list(getattr(n, "exprs", ()) or ())
        for agg in getattr(n, "aggs", ()) or ():
            exprs += list(agg.args) + [e for e, _, _ in agg.order_by]
            if agg.filter is not None:
                exprs.append(agg.filter)
        for w in getattr(n, "windows", ()) or ():
            exprs += list(w.args) + list(w.partition_by) + [e for e, _, _ in w.order_by]
            if w.filter is not None:
                exprs.append(w.filter)
        for e in exprs:
            used.update(nn.key for nn in B.walk(e)
                        if isinstance(nn, (B.BoundColumnRef, B.BoundAggregateRef)))
        stack += [c for _, c in _plan_children(n)]
    return used


def scan_bytes(plan: P.PlanNode, executor) -> Dict[str, int]:
    """Table name → the device bytes of the columns the plan reads from it
    (TableEntry.device_bytes: the port's real dtypes), 0 for a table
    scanned more than once (which cannot chunk)."""
    used = _used_keys(plan)
    seen: Dict[str, int] = {}
    stack = [plan]
    while stack:
        n = stack.pop()
        if isinstance(n, P.Scan):
            entry = executor.get_table(n.table)
            b = sum(entry.device_bytes(c) for c, k, _ in n.cols if k in used)
            seen[n.table] = 0 if n.table in seen else b
        stack += [c for _, c in _plan_children(n)]
    return seen


def _streams_to(inner: P.PlanNode, table: str) -> bool:
    """True if the one Scan of `table` reaches `inner` through Filter,
    Project and the probe edges of cross joins and _STREAMING_JOINS only."""
    def contains(n) -> bool:
        return (isinstance(n, P.Scan) and n.table == table) or any(
            contains(c) for _, c in _plan_children(n))

    def ok(n) -> bool:
        if isinstance(n, P.Scan):
            return n.table == table
        kids = [(edge, c) for edge, c in _plan_children(n) if contains(c)]
        if len(kids) != 1:
            return False
        edge, child = kids[0]
        if not (isinstance(n, (P.Filter, P.Project, P.CrossJoin))
                or (isinstance(n, P.Join) and n.jtype in _STREAMING_JOINS)):
            return False
        if isinstance(n, (P.Join, P.CrossJoin)) and edge != "probe":
            return False
        return ok(child)

    return contains(inner) and ok(inner)


def _chunk_entry(entry: TableEntry, lo: int, hi: int) -> TableEntry:
    """Rows [lo, hi) of a table as a table of their own: host columns sliced
    on first use, statistics (zone maps) of the chunk's own rows, VARCHAR
    columns keeping the whole table's dictionary."""
    ce = TableEntry(entry.name, [ColumnDef(c.name, c.ltype) for c in entry.columns])
    ce.nrows = hi - lo
    ce.device = entry.device

    def loader(col):
        values, validity, dvals = entry.host_column(col)
        return values[lo:hi], None if validity is None else validity[lo:hi], dvals

    for c in entry.columns:
        ce.set_lazy_column(c.name, lambda col=c.name: loader(col))
    return ce


def _decompose_aggs(aggs: List[B.BoundAggregate]):
    """→ (chunk aggregates, merge aggregates, finalizers) or None: the
    merge aggregates read the chunk partials by their keys; a finalizer
    recomputes a composite result (avg) from merged parts under its
    original key, so the query's tail runs unchanged."""
    from duckdb_tpu_torch.planner.planner import _agg_result_type

    partial, merge, overlay = [], [], {}
    for a in aggs:
        wide_int_sum = (a.func == "sum" and a.ltype.id is TypeId.HUGEINT
                        and a.args and a.args[0].ltype.is_integer)
        if a.distinct or a.order_by or a.filter is not None or (
                a.ltype.id is TypeId.HUGEINT and not wide_int_sum):
            return None
        if a.func == "avg":
            arg_t = a.args[0].ltype
            s_t = _agg_result_type("sum", a.args)
            if s_t.id is TypeId.HUGEINT:
                s_t = arg_t if arg_t.id is TypeId.DECIMAL else DOUBLE
            ks, kc = a.key + "#s", a.key + "#c"
            partial.append(B.BoundAggregate("sum", a.args, False, s_t, ks))
            partial.append(B.BoundAggregate("count", list(a.args), False, BIGINT, kc))
            merge.append(B.BoundAggregate("sum", [B.BoundColumnRef(ks, s_t)], False, s_t, ks))
            merge.append(B.BoundAggregate("sum", [B.BoundColumnRef(kc, BIGINT)], False,
                                          BIGINT, kc))
            overlay[a.key] = _avg_finalize(ks, kc, s_t, a.ltype)
        elif a.func in MERGEABLE:
            # an integer sum (HUGEINT) and a DECIMAL(38) sum run wide in each
            # chunk, as in memory; the spill tier keeps a partial at 64 bits
            # (one past them sends the query to memory) and the merge sums wide
            partial.append(B.BoundAggregate(a.func, a.args, False, a.ltype, a.key))
            merge.append(B.BoundAggregate(MERGEABLE[a.func], [B.BoundColumnRef(a.key, a.ltype)],
                                          False, a.ltype, a.key))
        else:
            return None
    return partial, merge, overlay


def _avg_finalize(ks: str, kc: str, s_t: LogicalType, out_t: LogicalType) -> B.BoundExpr:
    """avg from its merged sum and count, as the engine computes it:
    double(sum) / (double(count) · 10^scale)."""
    scale = float(10 ** s_t.scale) if s_t.id is TypeId.DECIMAL else 1.0

    def impl(env, cols, node):
        s, c = cols
        sd = B.bcast(s.data, env.plen).to(torch.float64)
        cd = B.bcast(c.data, env.plen).to(torch.float64)
        valid = cd > 0
        if s.validity is not None:
            valid = valid & B.bcast(s.validity, env.plen)
        return Column(data=sd / (cd * scale), ltype=out_t, validity=valid)

    return B.BoundFunction("__avg_merge", [B.BoundColumnRef(ks, s_t),
                                           B.BoundColumnRef(kc, BIGINT)], out_t, impl)


def _tmp_entry(executor, cols_out, cols, nrows) -> TableEntry:
    tmp = TableEntry(_TMP_NAME, [ColumnDef(key, t) for _, key, t in cols_out])
    tmp.nrows = nrows
    tmp.device = executor.catalog.device
    for (_, key, _), (d, v, dv) in zip(cols_out, cols):
        tmp.set_host_column(key, d, v, dv)
    return tmp


def _run(executor, plan, output, overrides):
    """One run of `plan` over `overrides` (table name → TableEntry), on a
    fresh executor that reports to the caller's routes; the entries'
    device columns leave the pool after it."""
    from duckdb_tpu_torch.execution.executor import Executor

    ex = Executor(executor.catalog, executor.routes)
    ex.scan_overrides = overrides
    try:
        return ex.run(plan, output)
    finally:
        for e in overrides.values():
            POOL.release_entry(e)


def try_chunked(executor, plan: P.PlanNode, output):
    """The plan's Result, run in chunks; None when no limit is set, the
    scans fit, or the plan cannot chunk (the caller runs it at once)."""
    budget = POOL.limit
    if budget <= 0:
        return None
    scans = scan_bytes(plan, executor)
    total = sum(scans.values())
    if total * WORKING_SET_FACTOR <= budget:
        return None
    ch = _plan_chunks(plan, scans, total, budget)
    if ch is None:
        executor.routes["out_of_core_fallback"] += 1
        executor._log("WARN", "out_of_core", "plan not chunkable; running in-memory (may "
                      "exceed memory_limit)")
        return None
    executor._log("INFO", "out_of_core",
                  f"scan working set ~{total * WORKING_SET_FACTOR / 1e6:.0f}MB exceeds "
                  f"memory_limit ({budget / 1e6:.0f}MB): processing {ch.table} in {ch.k} "
                  f"chunks of {math.ceil(executor.get_table(ch.table).nrows / ch.k)} rows")
    res = _run_chunks(executor, output, budget, ch)
    if res is None:
        executor.routes["out_of_core_fallback"] += 1
        executor._log("WARN", "out_of_core", "a chunk's partial passes 64 bits; running "
                      "in-memory (may exceed memory_limit)")
    return res


@dataclass
class _Chunking:
    """How a plan runs in chunks: the chunked table and the chunk count,
    the plan each chunk runs and its outputs, and the query's tail."""

    table: str
    k: int
    chunk_plan: P.PlanNode
    chunk_out: list  # [(name, key, type)]
    tail: tuple  # (limit, order, project, filter, aggregate) nodes, None where absent
    order_items: list = None  # a pure select's ORDER BY over the chunk outputs
    merge_aggs: list = None
    overlay: dict = None


def _plan_chunks(plan, scans, total, budget):
    """→ a _Chunking, or None when the plan cannot chunk."""
    node = plan
    limit_node = order_node = filter_node = agg_node = None
    if isinstance(node, P.Limit):
        limit_node, node = node, node.child
    if isinstance(node, P.Order):
        order_node, node = node, node.child
    if not isinstance(node, P.Project):
        return None
    proj, node = node, node.child
    if isinstance(node, P.Filter):
        filter_node, node = node, node.child
    if isinstance(node, P.Aggregate):
        agg_node, node = node, node.child
    elif filter_node is not None:
        node, filter_node = filter_node, None
    # the largest single-scan table that streams into the root (below the
    # root aggregate, which the merge decomposes)
    best, best_bytes = None, 0
    for t, b in scans.items():
        if b > best_bytes and _streams_to(node, t):
            best, best_bytes = t, b
    if best is None:
        return None
    usable = max(budget / WORKING_SET_FACTOR - (total - best_bytes),
                 budget / WORKING_SET_FACTOR * 0.25)
    k = max(2, math.ceil(best_bytes / usable))
    tail = (limit_node, order_node, proj, filter_node, agg_node)
    if agg_node is not None:
        dec = _decompose_aggs(agg_node.aggs)
        if dec is None:
            return None
        partial_aggs, merge_aggs, overlay = dec
        chunk_out = ([(k_, k_, e.ltype) for k_, e in agg_node.groups]
                     + [(a.key, a.key, a.ltype) for a in partial_aggs])
        if any(t.id in _UNSPILLABLE for _, _, t in chunk_out):
            return None
        return _Chunking(best, k, P.Aggregate(child=agg_node.child, groups=agg_node.groups,
                                              aggs=partial_aggs),
                         chunk_out, tail, merge_aggs=merge_aggs, overlay=overlay)
    # a pure select: each chunk runs the projection; a source column ORDER
    # BY reads that the projection does not give passes through under a
    # key of its own
    chunk_items = list(proj.items)
    proj_keys = {k_ for k_, _ in chunk_items}
    order_items = list(order_node.items) if order_node is not None else []
    for i, (e, desc, nf) in enumerate(order_items):
        refs = [nn for nn in B.walk(e) if isinstance(nn, (B.BoundColumnRef, B.BoundAggregateRef))]
        if all(nn.key in proj_keys for nn in refs):
            continue
        if not isinstance(e, (B.BoundColumnRef, B.BoundAggregateRef)):
            return None  # a computed sort key over columns not projected
        pt = e.key + "#pt"
        if pt not in proj_keys:
            proj_keys.add(pt)
            chunk_items.append((pt, e))
        order_items[i] = (B.BoundColumnRef(pt, e.ltype), desc, nf)
    chunk_out = [(k_, k_, e.ltype) for k_, e in chunk_items]
    if any(t.id in _UNSPILLABLE for _, _, t in chunk_out):
        return None
    return _Chunking(best, k, replace(proj, items=chunk_items, child=node), chunk_out, tail,
                     order_items=order_items)


def _run_chunks(executor, output, budget, ch: _Chunking):
    """The chunks' results gather in the spill tier (an aggregate's
    partials, groups × chunks rows, in host memory; a pure select's rows
    move to temp files past spill.HOST_BYTES) for the query's tail; None
    when a wide partial passes 64 bits, and the query runs in memory."""
    from duckdb_tpu_torch.storage.spill import SpillDir, SpillWriter

    entry = executor.get_table(ch.table)
    rows_per = math.ceil(entry.nrows / ch.k)
    spill = SpillDir("ooc", executor.catalog)
    writer = SpillWriter(spill, [t for _, _, t in ch.chunk_out])
    try:
        for ci in range(ch.k):
            lo, hi = ci * rows_per, min((ci + 1) * rows_per, entry.nrows)
            if lo >= hi:
                break
            r = _run(executor, ch.chunk_plan, ch.chunk_out,
                     {ch.table: _chunk_entry(entry, lo, hi)})
            try:
                writer.append(r.columns, r.nrows)
            except OverflowError:
                return None
        executor.routes["out_of_core"] += 1
        executor.routes["out_of_core_chunks"] += ch.k
        tmp = _tmp_entry(executor, ch.chunk_out, writer.finish(), writer.nrows)
        if ch.tail[4] is None and ch.tail[1] is not None and \
                sum(tmp.device_bytes(key) for _, key, _ in ch.chunk_out) \
                * WORKING_SET_FACTOR > budget:
            executor.routes["out_of_core_sort"] += 1
            return _range_partitioned_order(executor, tmp, ch.chunk_out, ch.order_items,
                                             ch.tail[0], output, budget)
        return _run(executor, _merge_plan(ch), output, {_TMP_NAME: tmp})
    finally:
        spill.delete()


def _merge_plan(ch: _Chunking) -> P.PlanNode:
    """The query's tail over the concatenated chunk results."""
    limit_node, order_node, proj, filter_node, agg_node = ch.tail
    chunk_out, overlay = ch.chunk_out, ch.overlay
    if agg_node is not None:
        scan = P.Scan(table=_TMP_NAME, alias=_TMP_NAME,
                      cols=[(key, key, t) for _, key, t in chunk_out])
        groups = [(k_, B.BoundColumnRef(k_, e.ltype)) for k_, e in agg_node.groups]
        merged: P.PlanNode = P.Aggregate(child=scan, groups=groups, aggs=ch.merge_aggs)
        if overlay:
            items = ([(k_, B.BoundColumnRef(k_, e.ltype)) for k_, e in agg_node.groups]
                     + [(a.key, B.BoundAggregateRef(a.key, a.ltype)) for a in ch.merge_aggs
                        if a.key not in overlay]
                     + list(overlay.items()))
            merged = P.Project(child=merged, items=items)
        if filter_node is not None:
            merged = P.Filter(child=merged, expr=filter_node.expr)
        merged = replace(proj, child=merged)
        if order_node is not None:
            merged = replace(order_node, child=merged)
    else:
        # the chunks ran the projection: its outputs pass through, read
        # under prefixed keys (an item of the same key would read itself)
        merged = _passthrough(chunk_out)
        if order_node is not None:
            merged = replace(order_node, child=merged, items=ch.order_items)
    if limit_node is not None:
        merged = replace(limit_node, child=merged)
    return merged


def _passthrough(chunk_out) -> P.PlanNode:
    scan = P.Scan(table=_TMP_NAME, alias=_TMP_NAME,
                  cols=[(key, "__ooc." + key, t) for _, key, t in chunk_out])
    return P.Project(child=scan, items=[(key, B.BoundColumnRef("__ooc." + key, t))
                                        for _, key, t in chunk_out])


def _range_partitioned_order(executor, tmp, chunk_out, order_items, limit_node, output,
                             budget):
    """ORDER BY over more rows than the limit holds: range partitions of
    the leading sort key (edges from a host sample; equal keys share a
    partition, so later keys order inside it), each sorted on the device
    and streamed through the spill tier in partition order. DuckDB merges
    sorted runs from temp files (src/common/sort/); here the device sorts
    every row and the host only routes partitions."""
    from duckdb_tpu_torch.execution.executor import Result
    from duckdb_tpu_torch.storage.spill import SpillDir, SpillWriter

    types = [t for _, _, t in chunk_out]
    n = tmp.nrows
    e0, desc0, nf0 = order_items[0]
    nf0 = bool(nf0)  # DuckDB's default: NULLS LAST
    vals, valid, _ = tmp.host_column(e0.key)
    vals = np.asarray(vals)
    bytes_all = sum(tmp.device_bytes(key) for _, key, _ in chunk_out)
    nparts = max(2, math.ceil(bytes_all * WORKING_SET_FACTOR / max(budget * 0.5, 1)))
    nonnull = np.arange(n) if valid is None else np.flatnonzero(np.asarray(valid))
    null_idx = np.zeros(0, np.int64) if valid is None else np.flatnonzero(~np.asarray(valid))
    sample = vals[nonnull[::max(1, len(nonnull) // 65536)]]
    # edges at even quantiles of the sample; a VARCHAR key's codes follow
    # its sorted dictionary
    edges = np.unique(np.sort(sample)[np.linspace(0, max(len(sample) - 1, 0), nparts - 1)
                                      .astype(np.int64)]) if len(sample) \
        else np.zeros(0, vals.dtype)
    pid = np.searchsorted(edges, vals, side="right")
    executor.routes["out_of_core_sort_partitions"] += len(edges) + 1
    executor._log("INFO", "out_of_core", f"ORDER BY over {bytes_all / 1e6:.0f}MB temp exceeds "
                  f"the device budget: {len(edges) + 1} range partitions")
    cap = None
    if limit_node is not None and limit_node.n is not None:
        cap = limit_node.n + limit_node.offset
    part_plan = P.Order(child=_passthrough(chunk_out), items=order_items)
    order = list(range(len(edges) + 1))
    if desc0:
        order.reverse()
    blocks = ([None] if nf0 and len(null_idx) else []) + order \
        + ([None] if not nf0 and len(null_idx) else [])
    sd = SpillDir("sort", executor.catalog)
    writer = SpillWriter(sd, [t for _, _, t in output])
    try:
        for p in blocks:
            idx = null_idx if p is None else nonnull[pid[nonnull] == p]
            if len(idx) == 0:
                continue
            pe = TableEntry(_TMP_NAME, [ColumnDef(key, t) for _, key, t in chunk_out])
            pe.nrows = len(idx)
            pe.device = tmp.device
            for _, key, _ in chunk_out:
                def loader(key=key, idx=idx):
                    d, v, dv = tmp.host_column(key)
                    return np.asarray(d)[idx], None if v is None else np.asarray(v)[idx], dv
                pe.set_lazy_column(key, loader)
            r = _run(executor, part_plan, output, {_TMP_NAME: pe})
            writer.append(r.columns, r.nrows)
            if cap is not None and writer.nrows >= cap:
                break
        cols = writer.finish()
        total = writer.nrows
        lo = limit_node.offset if limit_node is not None else 0
        hi = min(total, cap) if cap is not None else total
        # the Result's columns are read into memory before the spill
        # directory goes
        cols = [(np.array(d[lo:hi]), None if v is None else np.array(v[lo:hi]), dv)
                for d, v, dv in cols]
        return Result(names=[nm for nm, _, _ in output], types=[t for _, _, t in output],
                      columns=cols, nrows=max(hi - lo, 0))
    finally:
        sd.delete()
