"""Statistics over each row's window frame, for all rows at once.

A window frame is a span [l, r) of positions in window order (one per
row, inside the row's partition). Two structures answer a query for every
row in a fixed number of batched steps, with no loop over rows or
partitions:

- `WaveletMatrix` over small integer keys: the k-th smallest key in a span
  (a frame's quantile, with keys the rank of each row's value inside its
  partition), and the count and weighted sums of the keys below a
  threshold in a span (DISTINCT over a frame: the rows whose previous
  equal value lies before the frame's start). One level per key bit; each
  level is a stable partition by that bit and an int32 prefix count of its
  zeros, built with one cumsum and one scatter. A query reads two prefix
  values per level. Two options serve DISTINCT over a frame whose start
  moves: `moments` keeps a `MomentTree` of each level's zero-bit rows, so
  the rows below a threshold give their (count, pivot, S, Q) with pivots
  taken inside the span (no prefix sum across partitions or far from the
  frame's values); `filter` keeps, per level, a second matrix over a
  filter key of the level's zero-bit rows, so `kth` can pick the k-th key
  among only the span's rows whose filter key is below a threshold (a
  three-sided query: key rank, position, previous equal value).
- `MomentTree`, a segment tree of (count, pivot, S, Q) nodes, where S and Q
  are the sums of (x - pivot) and (x - pivot)^2 over the node's valid
  values and the pivot is its first valid value. Two nodes merge by moving
  one's sums to the other's pivot. Because the pivot is a value of the
  node, the sums stay at the scale of the spread of the values, not of
  their magnitude. (count, mean, M2) nodes merged by Chan's formula carry
  each mean's rounding, a unit in the last place of the magnitude, into
  M2, which values such as 1e9 + 0.1·k expose; the pivoted sums do not
  (tests/test_torch_frame_windows.py). A query combines at most two nodes
  a level, bottom-up, for all rows together.

Both are built only as deep as the longest partition needs, and hold
their tables until the caller drops them.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch


def _prefix(x: torch.Tensor, dtype) -> torch.Tensor:
    """[0, x0, x0 + x1, …]: n + 1 inclusive-exclusive prefix sums."""
    out = torch.zeros(x.shape[0] + 1, dtype=dtype, device=x.device)
    torch.cumsum(x, 0, dtype=dtype, out=out[1:])
    return out


class WaveletMatrix:
    """A wavelet matrix over int64 keys in [0, 2^bits), with optional
    weight vectors (int64 sums wrap mod 2^64, as the engine's sums do;
    float64 sums are prefix differences, so their error is about 1e-16 of
    the weights' absolute sum before the span)."""

    def __init__(self, keys: torch.Tensor, bits: int, weights: Sequence[torch.Tensor] = (),
                 moments: Optional[Tuple[torch.Tensor, torch.Tensor, int]] = None,
                 filter: Optional[Tuple[torch.Tensor, int]] = None):
        """`moments`: (float64 values, validity, tree levels) for
        `moments_below`; `filter`: (int64 filter keys, their bits) for
        `kth` with a threshold t < 2^bits - 1 (a filter key of all ones
        never counts: it marks a level's 1-bit rows)."""
        n = keys.shape[0]
        self.n, self.bits = n, max(1, bits)
        idx = torch.arange(n, device=keys.device)
        self.zeros: List[torch.Tensor] = []  # per level, n + 1 int32 prefix counts of 0 bits
        self.nzero: List[torch.Tensor] = []  # per level, the count of 0 bits (on the device)
        self.wsums: List[List[torch.Tensor]] = []  # per level, prefix sums of 0-bit weights
        self.trees: List[MomentTree] = []  # per level, moments of the 0-bit rows
        self.inner: List[WaveletMatrix] = []  # per level, a matrix of the 0-bit filter keys
        a, ws = keys, list(weights)
        carried = ([] if moments is None else [moments[0], moments[1]]) + \
            ([] if filter is None else [filter[0]])
        for lvl in range(self.bits - 1, -1, -1):
            bit = (a >> lvl) & 1
            zero = bit == 0
            pz = _prefix(zero.to(torch.int32), torch.int32)
            nz = pz[n].to(torch.int64)
            before = pz[:-1].to(torch.int64)
            # stable partition: the 0s keep their order in front, the 1s after
            pos = torch.where(zero, before, nz + idx - before)
            self.zeros.append(pz)
            self.nzero.append(nz)
            self.wsums.append([_prefix(torch.where(zero, w, torch.zeros((), dtype=w.dtype,
                                                                         device=w.device)),
                                       w.dtype) for w in ws])
            if moments is not None:
                self.trees.append(MomentTree(carried[0], carried[1] & zero, moments[2]))
            if filter is not None:
                fbits = filter[1]
                self.inner.append(WaveletMatrix(torch.where(zero, carried[-1],
                                                            (1 << fbits) - 1), fbits))
            if lvl:
                a, ws[:], carried[:] = (_moved(v, pos) for v in (a, ws, carried))

    def kth(self, lo: torch.Tensor, hi: torch.Tensor, k: torch.Tensor,
            t: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The k-th smallest key (k from 0) in each span [lo, hi), or, with
        a threshold t (a matrix built with `filter`), among the span's rows
        whose filter key is below t; a k outside the rows counted gives
        some key of the matrix."""
        out = torch.zeros_like(k)
        for i, pz in enumerate(self.zeros):
            zl, zr = pz[lo].to(torch.int64), pz[hi].to(torch.int64)
            # the 0-bit rows of the span that count: all, or the filtered
            c0 = zr - zl if t is None else self.inner[i].count_below(lo, hi, t)[0]
            go0 = k < c0
            nz = self.nzero[i]
            lo = torch.where(go0, zl, nz + lo - zl)
            hi = torch.where(go0, zr, nz + hi - zr)
            k = torch.where(go0, k, k - c0)
            out = out | ((~go0).to(torch.int64) << (self.bits - 1 - i))
        return out

    def _descend(self, lo: torch.Tensor, hi: torch.Tensor, t: torch.Tensor):
        """Per level, toward the keys below t: (level, where t has a 1 bit,
        the span at this level, its 0-bit rows' prefix counts at lo and hi).
        Where t has a 1, every key of the span with a 0 here is below t."""
        for i, pz in enumerate(self.zeros):
            one = ((t >> (self.bits - 1 - i)) & 1) == 1
            zl, zr = pz[lo].to(torch.int64), pz[hi].to(torch.int64)
            yield i, one, lo, hi, zl, zr
            nz = self.nzero[i]
            lo = torch.where(one, nz + lo - zl, zl)
            hi = torch.where(one, nz + hi - zr, zr)

    def count_below(self, lo: torch.Tensor, hi: torch.Tensor, t: torch.Tensor
                    ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """(count, [weighted sums]) of the keys < t in each span [lo, hi),
        for t in [0, 2^bits)."""
        cnt = torch.zeros_like(lo)
        sums = [torch.zeros(lo.shape[0], dtype=w[0].dtype, device=lo.device)
                for w in self.wsums[0]] if self.wsums and self.wsums[0] else []
        for i, one, lo_i, hi_i, zl, zr in self._descend(lo, hi, t):
            cnt = cnt + torch.where(one, zr - zl, 0)
            for j, ps in enumerate(self.wsums[i]):
                sums[j] = sums[j] + torch.where(one, ps[hi_i] - ps[lo_i],
                                                torch.zeros((), dtype=ps.dtype,
                                                            device=ps.device))
        return cnt, sums

    def moments_below(self, lo: torch.Tensor, hi: torch.Tensor, t: torch.Tensor):
        """(count, S, Q) of the valid values of the keys < t in each span
        [lo, hi) (a matrix built with `moments`), about a value of the
        span: M2 = Q - S²/count. Each level adds its tree's node of the
        span's 0-bit rows where t has a 1."""
        z = torch.zeros(lo.shape[0], dtype=torch.float64, device=lo.device)
        acc = (z, z, z, z)
        for i, one, lo_i, hi_i, _, _ in self._descend(lo, hi, t):
            n, c, s, q = self.trees[i].node(lo_i, hi_i)
            acc = _merge(acc, (torch.where(one, n, 0.0), c, torch.where(one, s, 0.0),
                               torch.where(one, q, 0.0)))
        return acc[0], acc[2], acc[3]


def _moved(v, pos):
    """v (a tensor or a list of them) with element j moved to pos[j]."""
    if isinstance(v, list):
        return [_moved(x, pos) for x in v]
    out = torch.empty_like(v)
    out[pos] = v
    return out


def _merge(a, b):
    """Two (count, pivot, S, Q) nodes → one, at a's pivot (b's where a is
    empty). float64 throughout; an empty node is the identity."""
    na, ca, sa, qa = a
    nb, cb, sb, qb = b
    both = (na > 0) & (nb > 0)
    d = torch.where(both, cb - ca, 0.0)
    return (na + nb, torch.where(na > 0, ca, cb), sa + sb + nb * d,
            qa + qb + 2.0 * d * sb + nb * d * d)


class MomentTree:
    """Count, sum of deviations and sum of squared deviations of the valid
    values over spans of positions, from a segment tree of `levels` levels
    (level j: one node per aligned block of 2^j positions). A span longer
    than 2^levels - 2 positions is not covered."""

    def __init__(self, x: torch.Tensor, valid: torch.Tensor, levels: int):
        zero = torch.zeros((), dtype=torch.float64, device=x.device)
        n = valid.to(torch.float64)
        c = torch.where(valid, x.to(torch.float64), zero)
        node = (n, c, torch.zeros_like(c), torch.zeros_like(c))
        self.levels = [node]
        for _ in range(1, max(1, levels)):
            if node[0].shape[0] % 2:
                node = tuple(torch.cat([v, zero.reshape(1)]) for v in node)
            node = _merge(tuple(v[0::2] for v in node), tuple(v[1::2] for v in node))
            self.levels.append(node)

    def query(self, lo: torch.Tensor, hi: torch.Tensor):
        """(count, S, Q) of each span [lo, hi), about its first valid
        value; M2 = Q - S²/count."""
        acc = self.node(lo, hi)
        return acc[0], acc[2], acc[3]

    def node(self, lo: torch.Tensor, hi: torch.Tensor):
        """The (count, pivot, S, Q) node of each span [lo, hi)."""
        z = torch.zeros(lo.shape[0], dtype=torch.float64, device=lo.device)
        acc = (z, z, z, z)
        for node in self.levels:
            take = (lo < hi) & ((lo & 1) == 1)
            acc = _merge(acc, _node_at(node, lo, take))
            lo = lo + take.to(lo.dtype)
            take = (lo < hi) & ((hi & 1) == 1)
            hi = hi - take.to(hi.dtype)
            acc = _merge(acc, _node_at(node, hi, take))
            lo, hi = lo >> 1, hi >> 1
        return acc


def _node_at(node, p, take):
    """The nodes at indices p of one level, empty where `take` is False."""
    n, c, s, q = (v[p.clamp(0, v.shape[0] - 1)] for v in node)
    return (torch.where(take, n, 0.0), c, torch.where(take, s, 0.0), torch.where(take, q, 0.0))
