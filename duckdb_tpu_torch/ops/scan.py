"""Cumulative scans and the exact grouped bitwise reductions.

The JAX package's duckdb_tpu/ops/scan.py holds `cummax`/`cummin`,
`segment_starts` and `jit_ascan`, a cached `jax.jit` around
`associative_scan` for segmented scans with tuple carries. `jit_ascan` is
a JAX workaround (eager dispatch compiled every level of the scan) and is
not carried over; its one caller, bit_and/bit_or/bit_xor, gets
`grouped_bitwise` below instead.

`grouped_bitwise` is exact and needs neither a sort nor a scan: it counts,
per group, the rows whose bit j is set, for each of the 64 bits. bit_or
is then "count > 0", bit_xor "count is odd" and bit_and "count equals the
group's row count". The counts are int64 sums of 0/1 vectors, two bits to
a vector (bit j in the low 32 bits, bit j + 32 in the high 32: a count
stays below 2^31, so the halves never carry into each other), so 32 sum
vectors go through ops/grouped.grouped_reduce. Over at most 256 groups
that is the grouped-sum kernel, elsewhere one index_add_: additions, in
which no write's order or winner can change the result. The other exact
design, a log-step doubling scan over gid-sorted rows, would take a sort
and about 23 elementwise passes over the rows at SF1 on top.
"""

from __future__ import annotations

from typing import Callable, List

import torch

BITWISE_KINDS = ("bit_and", "bit_or", "bit_xor")
# sum vectors reduced per call (the peak extra memory is this many rows of
# int64s)
_CHUNK = 16


def cummax(x: torch.Tensor) -> torch.Tensor:
    return torch.cummax(x, 0).values


def cummin(x: torch.Tensor) -> torch.Tensor:
    return torch.cummin(x, 0).values


def segment_starts(seg_start: torch.Tensor, n: int) -> torch.Tensor:
    """Index of each row's segment start. seg_start: bool (n,), True at the
    first row of every segment (row 0 must be True)."""
    idx = torch.arange(n, device=seg_start.device)
    return cummax(torch.where(seg_start, idx, 0))


def _bit_pair(x: torch.Tensor, j: int) -> torch.Tensor:
    """Bit j of x in the low half and bit j + 32 in the high half."""
    return ((x >> j) & 1) | (((x >> (j + 32)) & 1) << 32)


def grouped_bitwise(kind: str, x: torch.Tensor, mask: torch.Tensor,
                    reduce: Callable[[List[torch.Tensor]], List[torch.Tensor]],
                    count: torch.Tensor) -> torch.Tensor:
    """Per-group bit_and / bit_or / bit_xor of the int64 values `x` over the
    rows in `mask`. `reduce(vectors)` gives each int64 vector's per-group
    sums; `count` is the per-group count of `mask` (bit_and's full count).
    A group without rows gives 0 (its validity is the caller's)."""
    if kind not in BITWISE_KINDS:
        raise ValueError(f"grouped_bitwise: unknown kind {kind}")
    x = torch.where(mask, x.to(torch.int64), 0)
    out = None
    for lo in range(0, 32, _CHUNK):
        sums = reduce([_bit_pair(x, j) for j in range(lo, lo + _CHUNK)])
        for j, s in zip(range(lo, lo + _CHUNK), sums):
            for bit, n in ((j, s & 0xFFFFFFFF), (j + 32, s >> 32)):
                if kind == "bit_or":
                    on = n > 0
                elif kind == "bit_xor":
                    on = (n & 1) == 1
                else:
                    on = n == count
                term = on.to(torch.int64) << bit
                out = term if out is None else out | term
    return out
