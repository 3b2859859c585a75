"""Card-only checks of the port's CUDA kernels against their plain versions.

Imports no jax, so it runs on a GPU host without JAX:
    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
Each test skips itself where no CUDA device is present.
"""

import pytest
import torch

from duckdb_tpu_torch.ops import grouped_sum as GS


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _expected_launches(k, nseg):
    """Launches and launches by regime that the wrapper's plan makes for k vectors."""
    by_regime = {"small": 0, "large": 0}
    while k:
        plan = GS.launch_plan(nseg, k)
        by_regime[plan.regime] += 1
        k -= plan.vectors
    return sum(by_regime.values()), by_regime


@pytest.mark.gpu
@pytest.mark.parametrize("n,k,nseg,ids", [
    (1, 1, 1, None), (1000, 15, 20, None), (1000, 16, 20, None),
    (1 << 20, 24, 256, None), (1 << 20, 40, 256, None), (6_291_456, 15, 20, None),
    (6_291_456, 16, 20, (0, 1, 4, 5, -1)),   # Q1's 4 live slots of 20
    ((1 << 20) + 77, 16, 20, (7,)),          # every row in one slot, ragged tail
    (1 << 20, 16, "max", None),              # last nseg of the small regime
    (1 << 20, 16, "max+1", None),            # first nseg of the large regime
    (1 << 20, 9, 216, (100,)),               # large regime, every row in one slot
    (1 << 20, 25, 20, (3, 9, 21)),           # splits 24 + 1; id 21 is dead
])
def test_grouped_sum_kernel_matches_plain(n, k, nseg, ids):
    """Bit-equal to the plain version: full-range values wrap mod 2^64, and
    where ids are drawn from a few given ones the dead rows keep nonzero
    values, which both versions must ignore."""
    _need_cuda()
    nseg = {"max": GS.SMALL_MAX_NSEG, "max+1": GS.SMALL_MAX_NSEG + 1}.get(nseg, nseg)
    gen = torch.Generator().manual_seed(n + k + nseg)
    if ids is None:
        dense = torch.randint(-1, nseg + 2, (n,), generator=gen, dtype=torch.int32)
    else:
        dense = torch.tensor(ids, dtype=torch.int32)[
            torch.randint(0, len(ids), (n,), generator=gen)]
    dead = (dense < 0) | (dense >= nseg)
    vecs = []
    for _ in range(k):
        v = torch.randint(-(2**63 - 1), 2**63 - 1, (n,), generator=gen, dtype=torch.int64)
        vecs.append((torch.where(dead, 0, v) if ids is None else v).cuda())
    dense = dense.cuda()
    GS.grouped_sum_i64.launches = 0
    GS.grouped_sum_i64.regime_launches = {"small": 0, "large": 0}
    got = GS.grouped_sum_i64(dense, vecs, nseg)
    launches, by_regime = _expected_launches(k, nseg)
    assert GS.grouped_sum_i64.launches == launches
    assert GS.grouped_sum_i64.regime_launches == by_regime
    want = GS.grouped_sum_i64_plain(dense, vecs, nseg)
    torch.cuda.synchronize()
    assert len(got) == k
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_grouped_sum_kernel_takes_unaligned_views():
    """Vectors that start 8 bytes past a 16-byte boundary are copied, not refused."""
    _need_cuda()
    n, nseg = 10_001, 20
    gen = torch.Generator().manual_seed(1)
    dense = torch.randint(0, nseg, (n + 1,), generator=gen, dtype=torch.int32).cuda()[1:]
    base = torch.randint(-1000, 1000, (3, n + 1), generator=gen, dtype=torch.int64).cuda()
    vecs = [base[j, 1:] for j in range(3)]
    got = GS.grouped_sum_i64(dense, vecs, nseg)
    want = GS.grouped_sum_i64_plain(dense, vecs, nseg)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
