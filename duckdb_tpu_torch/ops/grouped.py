"""Grouped reductions: the replacement for hash-table aggregation.

The reference aggregates through GroupedAggregateHashTable
(duckdb/src/execution/aggregate_hashtable.cpp:399). As in the JAX package,
grouping keys arrive here already turned into dense slot ids, and every
aggregate arrives as pre-masked per-row vectors; this module reduces them
per slot.

Routing follows the JAX package (duckdb_tpu/ops/grouped.py:52-69): int64
SUMs over a small slot domain (nseg ≤ MASKED_REDUCE_LIMIT) go to the
hand-written grouped-sum kernel (ops/grouped_sum.py). Every other
reduction over at most MASKED_SLOTS_LIMIT slots is masked, one slot at a
time, as the reference's masked reduce: over so few slots the atomics of
a scatter collide on a handful of addresses (TPC-H general_agg's 4 groups
over 6M rows: 57 ms of scatter_reduce_ and 27 ms of float index_add_ per
query on an H100 80GB HBM3 at 700 W). Wider domains take one native
index_add_ / scatter_reduce_ over an overflow slot that absorbs dead
rows. All sums are exact: int64 sums stay in int64 and wrap mod 2^64 as
the reference's do; float sums are float64.

`SET pallas_grouped_sum = 'off'` (main/settings.py; KERNEL_MODE while a
statement runs) sends the int64 sums of up to MASKED_REDUCE_LIMIT slots to
the index_add_ route wider domains take, as the JAX package's 'off' leaves
its Pallas kernel; 'auto' and 'on' launch the kernel.
"""

from __future__ import annotations

import contextvars
from typing import List, Sequence

import torch

from duckdb_tpu_torch.ops.grouped_sum import grouped_sum_i64

MASKED_REDUCE_LIMIT = 256
MASKED_SLOTS_LIMIT = 16

# the running statement's pallas_grouped_sum setting (Executor.run sets it)
KERNEL_MODE: contextvars.ContextVar = contextvars.ContextVar("duckdb_tpu_torch_grouped_sum",
                                                             default="auto")


def _sentinel(kind: str, dtype: torch.dtype):
    if kind == "prod":
        return 1
    if dtype.is_floating_point:
        return float("inf") if kind == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if kind == "min" else info.min


def grouped_reduce(dense: torch.Tensor, vectors: Sequence[torch.Tensor],
                   kinds: Sequence[str], nseg: int) -> List[torch.Tensor]:
    """Per-slot reductions of per-row vectors.

    dense: (N,) int slot ids in [0, nseg); rows with id >= nseg (or < 0)
    are dead and contribute to no slot.
    vectors[i]: (N,) values already masked (dead rows hold the identity:
    0 for sum, ±sentinel for min/max, 1 for prod).
    kinds[i] ∈ {"sum", "min", "max", "prod"} (prod: the general aggregate's
    product(), float64).
    Returns per-slot tensors of shape (nseg,), same dtype as each vector.
    """
    results: List = [None] * len(vectors)
    rest = list(range(len(vectors)))
    if nseg <= MASKED_REDUCE_LIMIT:
        i64_sum = [i for i in rest
                   if kinds[i] == "sum" and vectors[i].dtype == torch.int64]
        if i64_sum:
            picked = [vectors[i] for i in i64_sum]
            sums = (_scatter(dense, picked, ["sum"] * len(picked), nseg)
                    if KERNEL_MODE.get() == "off" else grouped_sum_i64(dense, picked, nseg))
            for i, s in zip(i64_sum, sums):
                results[i] = s
            rest = [i for i in rest if i not in i64_sum]
    if rest:
        reduce = _masked if nseg <= MASKED_SLOTS_LIMIT else _scatter
        for i, r in zip(rest, reduce(dense, [vectors[i] for i in rest],
                                     [kinds[i] for i in rest], nseg)):
            results[i] = r
    return results


_TORCH_REDUCE = {"sum": lambda x: x.sum(dim=0), "min": lambda x: x.amin(dim=0),
                 "max": lambda x: x.amax(dim=0), "prod": lambda x: x.prod(dim=0)}


def _masked(dense, vectors, kinds, nseg):
    # vectors of one kind and dtype reduce together as one (N, K) matrix,
    # once per slot over the rows that hold its id
    results = [None] * len(vectors)
    classes = {}
    for i, (v, k) in enumerate(zip(vectors, kinds)):
        classes.setdefault((k, v.dtype), []).append(i)
    for (k, dt), idxs in classes.items():
        mat = torch.stack([vectors[i] for i in idxs], dim=1)
        ident = 0 if k == "sum" else _sentinel(k, dt)
        out = torch.empty((nseg, len(idxs)), dtype=dt, device=mat.device)
        for g in range(nseg):
            out[g] = _TORCH_REDUCE[k](torch.where((dense == g)[:, None], mat, ident))
        for j, i in enumerate(idxs):
            results[i] = out[:, j]
    return results


def _scatter(dense, vectors, kinds, nseg):
    # one overflow slot absorbs dead rows (ids outside [0, nseg) land there);
    # same-dtype sums batch into one (N, K) index_add_
    d = dense.to(torch.int64)
    d = torch.where((d < 0) | (d >= nseg), nseg, d)
    results = [None] * len(vectors)
    sum_groups = {}
    for i, (v, k) in enumerate(zip(vectors, kinds)):
        if k == "sum":
            sum_groups.setdefault(v.dtype, []).append(i)
        else:
            out = torch.full((nseg + 1,), _sentinel(k, v.dtype), dtype=v.dtype,
                             device=v.device)
            out.scatter_reduce_(0, d, v, reduce={"min": "amin", "max": "amax"}.get(k, k))
            results[i] = out[:nseg]
    for dt, idxs in sum_groups.items():
        mat = torch.stack([vectors[i] for i in idxs], dim=1)
        out = torch.zeros((nseg + 1, len(idxs)), dtype=dt, device=mat.device)
        out.index_add_(0, d, mat)
        for j, i in enumerate(idxs):
            results[i] = out[:nseg, j]
    return results
