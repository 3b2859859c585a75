"""Join building blocks over whole padded key columns.

The reference probes a linear-probing pointer table and chases row chains
(duckdb/src/execution/join_hashtable.cpp:1178). As in the JAX package
(duckdb_tpu/ops/join.py), the build side is instead sorted by key once and
probed with a batched binary search, duplicate runs handled as [lo, hi)
ranges:

  build:  sort(keys) → (sorted_keys, row_perm)
  probe:  lo = searchsorted(keys, probe, left); hi = ... right
          count = hi - lo        (0 ⇒ no match)

Inner/left expansion repeats each probe row by its count, padded to a
capacity the caller reads once from the device. A perfect-hash path (the
PerfectHashJoinExecutor analog, duckdb/src/include/duckdb/execution/
operator/join/perfect_hash_join_executor.hpp) indexes a dense array
directly when build keys are unique dense ints.

Where torch differs from jnp: torch raises (or, on CUDA, asserts on the
device) on an out-of-range index where JAX clamps or drops, so every
gather index is clipped and every scatter target is in range;
repeat_interleave needs the exact total, so the expansion runs to the true
total and pads after. Indices are int64 throughout.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

_KEY_SENTINEL = torch.iinfo(torch.int64).max


@dataclass
class SortedBuildTable:
    """Build-side state: keys sorted ascending + permutation to original rows."""

    sorted_keys: torch.Tensor  # (B,) int64, dead rows pushed to the +INF end
    perm: torch.Tensor  # (B,) int64 original row index per sorted slot
    num_rows: torch.Tensor  # scalar: live build rows

    def probe_ranges(self, probe_keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        lo = torch.searchsorted(self.sorted_keys, probe_keys, right=False)
        hi = torch.searchsorted(self.sorted_keys, probe_keys, right=True)
        return lo, hi


def build_sorted(keys: torch.Tensor, live: torch.Tensor) -> SortedBuildTable:
    """Sort build keys; dead rows (padding/filtered/NULL key) go to the end.

    NULL join keys never match (SQL equi-join semantics), so callers must
    fold key-validity into `live`.
    """
    k = torch.where(live, keys.to(torch.int64), _KEY_SENTINEL)
    sorted_keys, perm = torch.sort(k)
    return SortedBuildTable(sorted_keys=sorted_keys.contiguous(), perm=perm,
                            num_rows=live.sum())


def probe_counts(table: SortedBuildTable, probe_keys: torch.Tensor,
                 probe_live: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-probe-row match count and [lo, hi) range. Dead probe rows count 0.

    The engine packs keys so INT64_MAX is never a live key.
    """
    k = torch.where(probe_live, probe_keys.to(torch.int64), _KEY_SENTINEL - 1)
    lo, hi = table.probe_ranges(k)
    counts = torch.where(probe_live, hi - lo, 0)
    return counts, lo, hi


def expand_matches(counts: torch.Tensor, lo: torch.Tensor, perm: torch.Tensor,
                   total: int, left_outer: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Expand probe×build match pairs to flat row indices.

    total: padded output size (>= the true match count, read by the
    caller). Returns (probe_rows, build_rows, out_live), each (total,).
    Rows past the true count repeat the last probe row and are not live.
    For left_outer, probe rows with zero matches emit one row with
    build_rows == -1 (NULL build side).
    """
    n = counts.shape[0]
    device = counts.device
    eff = counts.clamp(min=1) if left_outer else counts
    starts = torch.cumsum(eff, 0) - eff
    true_total = int(eff.sum()) if n else 0
    if true_total > total:
        raise ValueError(f"expand_matches: {true_total} pairs exceed capacity {total}")
    probe_rows = torch.full((total,), max(n - 1, 0), dtype=torch.int64, device=device)
    if true_total:
        probe_rows[:true_total] = torch.repeat_interleave(
            torch.arange(n, device=device), eff, output_size=true_total)
    offs = torch.arange(total, device=device) - starts[probe_rows] if n else \
        torch.zeros(total, dtype=torch.int64, device=device)
    build_pos = (lo[probe_rows] if n else offs) + offs
    if perm.shape[0]:
        build_rows = perm[build_pos.clamp(0, perm.shape[0] - 1)]
    else:
        build_rows = torch.full((total,), -1, dtype=torch.int64, device=device)
    out_live = torch.arange(total, device=device) < true_total
    if left_outer and n:
        build_rows = torch.where(counts[probe_rows] == 0, -1, build_rows)
    return probe_rows, build_rows, out_live


def perfect_build(keys: torch.Tensor, live: torch.Tensor, min_key: int,
                  max_key: int) -> torch.Tensor:
    """Dense direct-address table: slot k-min_key → build row index (or -1).

    Valid when live build keys are unique within [min_key, max_key] (e.g.
    primary keys). Dead rows write to a spare slot that is cut off, so they
    never overwrite a live row's slot (the JAX version leaves that to the
    order of its scatter).
    """
    size = max_key - min_key + 1
    slots = torch.full((size + 1,), -1, dtype=torch.int64, device=keys.device)
    idx = (keys.to(torch.int64) - min_key).clamp(0, size - 1)
    idx = torch.where(live, idx, size)
    slots[idx] = torch.arange(keys.shape[0], device=keys.device)
    return slots[:size]


def perfect_probe(slots: torch.Tensor, probe_keys: torch.Tensor,
                  probe_live: torch.Tensor, min_key: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (build_rows, matched) — one gather per probe row."""
    size = slots.shape[0]
    idx = probe_keys.to(torch.int64) - min_key
    in_range = (idx >= 0) & (idx < size)
    rows = slots[idx.clamp(0, size - 1)]
    matched = in_range & (rows >= 0) & probe_live
    return rows, matched
