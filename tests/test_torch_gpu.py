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


@pytest.mark.gpu
@pytest.mark.parametrize("n,k,nseg", [(1, 1, 1), (1000, 15, 20), (1000, 16, 20),
                                      (1 << 20, 24, 256),
                                      (1 << 20, 40, 256), (6_291_456, 15, 20)])
def test_grouped_sum_kernel_matches_plain(n, k, nseg):
    _need_cuda()
    gen = torch.Generator().manual_seed(n + k + nseg)
    dense = torch.randint(-1, nseg + 2, (n,), generator=gen, dtype=torch.int32)
    dead = (dense < 0) | (dense >= nseg)
    vecs = [torch.where(dead, 0, torch.randint(-(2**63 - 1), 2**63 - 1, (n,), generator=gen,
                                               dtype=torch.int64)).cuda()
            for _ in range(k)]
    dense = dense.cuda()
    GS.grouped_sum_i64.launches = 0
    got = GS.grouped_sum_i64(dense, vecs, nseg)
    assert GS.grouped_sum_i64.launches == -(-k // GS.vectors_per_launch(nseg))
    want = GS.grouped_sum_i64_plain(dense, vecs, nseg)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
