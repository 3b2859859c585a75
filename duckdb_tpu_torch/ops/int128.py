"""HUGEINT arithmetic on (hi, lo) int64 planes.

A HUGEINT value is hi·2^64 + uint64(lo), as `Column.data_hi` and
`Column.data` hold it; a column without a high plane holds int64 values
(hi = lo >> 63). These are elementwise torch ops on the column's device,
the way DuckDB's hugeint_t does it with two 64-bit words
(src/common/types/hugeint.cpp): carries from unsigned compares, products
from 16-bit limbs (every partial product and column sum fits in int64), and
truncated division by shift and subtract over the 128 bits. Each op also
returns where the exact result leaves int128, which the caller turns into
DuckDB's OutOfRangeException.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_MIN = -(1 << 63)
_M16 = (1 << 16) - 1

Wide = Tuple[torch.Tensor, torch.Tensor]  # (hi, lo), both int64


def limbs(data: torch.Tensor, data_hi: Optional[torch.Tensor], plen: int) -> Wide:
    """A column's planes broadcast to plen rows → (hi, lo)."""
    lo = data.to(torch.int64).expand(plen)
    if data_hi is None:
        return lo >> 63, lo
    return data_hi.to(torch.int64).expand(plen), lo


def ult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a < b as unsigned 64-bit words."""
    return (a ^ _MIN) < (b ^ _MIN)


def add(a: Wide, b: Wide):
    """a + b → ((hi, lo), overflow)."""
    (ah, al), (bh, bl) = a, b
    lo = al + bl
    hi = ah + bh + ult(lo, al).to(torch.int64)
    return (hi, lo), ((ah ^ hi) & (bh ^ hi)) < 0


def sub(a: Wide, b: Wide):
    """a - b → ((hi, lo), overflow)."""
    (ah, al), (bh, bl) = a, b
    lo = al - bl
    hi = ah - bh - ult(al, bl).to(torch.int64)
    return (hi, lo), ((ah ^ bh) & (ah ^ hi)) < 0


def neg(a: Wide):
    """-a → ((hi, lo), overflow): only -2^127 has no negation."""
    h, lo = a
    return (~h + (lo == 0).to(torch.int64), -lo), (h == _MIN) & (lo == 0)


def _abs(a: Wide):
    """|a| as an unsigned 128-bit pair (2^127 included) and a's sign."""
    sign = a[0] < 0
    (nh, nl), _ = neg(a)
    return (torch.where(sign, nh, a[0]), torch.where(sign, nl, a[1])), sign


def _signed(mag: Wide, sign: torch.Tensor):
    """An unsigned magnitude with a sign → ((hi, lo), overflow)."""
    (nh, nl), _ = neg(mag)
    hi = torch.where(sign, nh, mag[0])
    lo = torch.where(sign, nl, mag[1])
    # a magnitude of 2^127 or more fits only as -2^127
    big = mag[0] < 0
    return (hi, lo), big & ~(sign & (mag[0] == _MIN) & (mag[1] == 0))


def mul(a: Wide, b: Wide):
    """a · b → ((hi, lo), overflow), from the magnitudes' 16-bit limbs."""
    (ma, sa), (mb, sb) = _abs(a), _abs(b)

    def split(m):
        return torch.stack([(w >> (16 * k)) & _M16 for w in (m[1], m[0]) for k in range(4)])

    la, lb = split(ma), split(mb)  # (8, n) each, least significant first
    n = la.shape[1]
    cols = torch.zeros(16, n, dtype=torch.int64, device=la.device)
    prod = (la.unsqueeze(1) * lb.unsqueeze(0)).reshape(64, n)
    at = (torch.arange(8).unsqueeze(1) + torch.arange(8).unsqueeze(0)).reshape(64)
    cols.index_add_(0, at.to(la.device), prod)
    carry = torch.zeros(n, dtype=torch.int64, device=la.device)
    out = []
    for c in range(16):
        v = cols[c] + carry
        out.append(v & _M16)
        carry = v >> 16
    lo = out[0] | (out[1] << 16) | (out[2] << 32) | (out[3] << 48)
    hi = out[4] | (out[5] << 16) | (out[6] << 32) | (out[7] << 48)
    above = torch.stack(out[8:]).ne(0).any(0)
    res, ovf = _signed((hi, lo), sa ^ sb)
    return res, ovf | above


def divmod_trunc(a: Wide, b: Wide):
    """a // b and a % b truncated toward zero, as DuckDB's integer
    operators → (quotient, remainder, b == 0, overflow). A zero divisor
    gives 0 (the caller makes it NULL)."""
    (ma, sa), (mb, sb) = _abs(a), _abs(b)
    zero = (mb[0] == 0) & (mb[1] == 0)
    dh = torch.where(zero, 0, mb[0])
    dl = torch.where(zero, 1, mb[1])
    qh, ql = torch.zeros_like(dh), torch.zeros_like(dl)
    rh, rl = torch.zeros_like(dh), torch.zeros_like(dl)
    for bit in range(127, -1, -1):
        word, k = (ma[0], bit - 64) if bit >= 64 else (ma[1], bit)
        rh = (rh << 1) | ((rl >> 63) & 1)
        rl = (rl << 1) | ((word >> k) & 1)
        ge = ~(ult(rh, dh) | ((rh == dh) & ult(rl, dl)))
        borrow = ult(rl, dl).to(torch.int64)
        rl = torch.where(ge, rl - dl, rl)
        rh = torch.where(ge, rh - dh - borrow, rh)
        if bit >= 64:
            qh = qh | (ge.to(torch.int64) << k)
        else:
            ql = ql | (ge.to(torch.int64) << k)
    q, q_ovf = _signed((qh, ql), sa ^ sb)
    r, _ = _signed((rh, rl), sa)
    return q, r, zero, q_ovf


def to_float(w: Wide) -> torch.Tensor:
    """The values as float64 (one rounding of hi·2^64 + uint64(lo))."""
    hi, lo = w
    return hi.to(torch.float64) * 2.0 ** 64 + lo.to(torch.float64) \
        + torch.where(lo < 0, 2.0 ** 64, 0.0)


# -- exact sums ------------------------------------------------------------------
_M32 = (1 << 32) - 1


def sum_vectors(lo: torch.Tensor, hi: Optional[torch.Tensor]):
    """Per-row int64 vectors whose per-group sums give the exact sum of the
    rows' values (dead rows hold 0), each within int64 for fewer than 2^31
    rows. int64 values (hi None): their signed upper and unsigned lower 32
    bits. Wide values: hi's signed upper and unsigned lower 32 bits and
    lo's two unsigned halves, so that the high halves are summed as two
    more vectors through the same grouped sum."""
    if hi is None:
        return [lo >> 32, lo & _M32]
    return [hi >> 32, hi & _M32, (lo >> 32) & _M32, lo & _M32]


def sum_finalize(parts):
    """The per-group sums of sum_vectors → ((hi, lo), overflow: the exact
    sum leaves int128)."""
    if len(parts) == 2:
        top, bot = parts
        mid = top + (bot >> 32)
        lo = ((mid & _M32) << 32) | (bot & _M32)
        return (mid >> 32, lo), torch.zeros_like(lo, dtype=torch.bool)
    d, c, b, a = parts
    t1 = b + (a >> 32)
    t2 = c + (t1 >> 32)
    t3 = d + (t2 >> 32)
    lo = ((t1 & _M32) << 32) | (a & _M32)
    hi = (t3 << 32) | (t2 & _M32)
    return (hi, lo), (t3 < -(1 << 31)) | (t3 >= (1 << 31))
