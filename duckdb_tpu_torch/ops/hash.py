"""64-bit hashing: splitmix64's finalizer and a combine step.

The JAX package's duckdb_tpu/ops/hash.py computes these in uint64. Torch
has no `>>` for uint64 on the CPU, so here the bits live in int64:
multiplication wraps mod 2^64 in both, and a right shift is made logical
by masking off the sign bits that the arithmetic shift copies in. The
results are the reference's uint64 bits read as int64 (`hash()` returns
them so, as the reference's BIGINT does).
"""

from __future__ import annotations

import torch

# the reference's uint64 constants as int64 (two's complement)
_M1 = 0xBF58476D1CE4E5B9 - (1 << 64)
_M2 = 0x94D049BB133111EB - (1 << 64)
_GOLDEN = 0x9E3779B97F4A7C15 - (1 << 64)


def lsr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bits by 1 <= k <= 63."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def hash64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer over any integer tensor → int64 hash bits."""
    h = x.to(torch.int64)
    h = (h ^ lsr(h, 30)) * _M1
    h = (h ^ lsr(h, 27)) * _M2
    return h ^ lsr(h, 31)


def hash_combine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Combine two hashes (boost-style with the 64-bit golden ratio)."""
    return a ^ (b + _GOLDEN + (a << 6) + lsr(a, 2))


def clz64(x: torch.Tensor) -> torch.Tensor:
    """Leading zero bits of each int64 (64 for zero), by a six-step binary
    search: torch has no count-leading-zeros."""
    n = torch.zeros_like(x)
    for s in (32, 16, 8, 4, 2, 1):
        top_clear = lsr(x, 64 - s) == 0
        n = n + torch.where(top_clear, s, 0)
        x = torch.where(top_clear, x << s, x)
    return n + (x == 0).to(torch.int64)
