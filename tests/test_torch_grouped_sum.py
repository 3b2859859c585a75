"""Grouped int64 sum: the port against the JAX package's Pallas kernel.

The port's `grouped_sum_i64` (duckdb_tpu_torch/ops/grouped_sum.py) takes
its plain PyTorch version for CPU tensors; the JAX side is
`duckdb_tpu.ops.pallas_agg.grouped_sum_i64`, which runs the Pallas kernel
in interpret mode on the CPU, as tests/test_pallas_agg.py runs it. The two
must agree bit for bit, including sums that wrap mod 2^64. The CUDA kernel
itself is held against the plain version in tests/test_torch_gpu.py and
in chip_smoke.py on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from duckdb_tpu.ops import pallas_agg
from duckdb_tpu_torch.ops import grouped_sum as GS

torch.set_num_threads(1)


def _inputs(n, k, nseg, seed, value_bits):
    rng = np.random.default_rng(seed)
    dense = rng.integers(-1, nseg + 2, n).astype(np.int32)  # -1, nseg, nseg+1 dead
    dead = (dense < 0) | (dense >= nseg)
    vecs = []
    for j in range(k):
        hi = 2**value_bits if value_bits < 63 else 2**63 - 1
        v = rng.integers(-hi, hi, n, dtype=np.int64)
        v[dead] = 0  # the contract: dead rows hold 0
        vecs.append(v)
    return dense, vecs


@pytest.mark.parametrize("n,k,nseg,value_bits", [
    (1000, 1, 1, 40),          # one slot, one vector
    (5000, 3, 7, 55),          # mixed signs
    (20000, 12, 20, 30),       # Q1-like slot count, K > 10 (JAX splits)
    (70000, 2, 256, 63),       # max domain, full-range values that wrap
    (100000, 5, 12, 63),       # crosses two Pallas tiles, wrapping sums
    (4096, 9, 256, 20),        # many slots, few rows each
])
def test_plain_matches_pallas(n, k, nseg, value_bits):
    dense, vecs = _inputs(n, k, nseg, seed=n + k + nseg, value_bits=value_bits)
    want = pallas_agg.grouped_sum_i64(jnp.asarray(dense),
                                      [jnp.asarray(v) for v in vecs], nseg)
    GS.grouped_sum_i64.launches = 0
    got = GS.grouped_sum_i64(torch.from_numpy(dense),
                             [torch.from_numpy(v) for v in vecs], nseg)
    assert GS.grouped_sum_i64.launches == 0  # CPU tensors: plain version
    assert len(got) == k
    for g, w in zip(got, want):
        assert g.dtype == torch.int64 and g.shape == (nseg,)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_wrapping_sum_is_mod_2_64():
    """Four rows of 2^62 sum to 2^64, which wraps to 0 exactly, as int64 adds do."""
    dense = torch.zeros(4, dtype=torch.int32)
    v = torch.full((4,), 2**62, dtype=torch.int64)
    (got,) = GS.grouped_sum_i64(dense, [v], 1)
    assert int(got[0]) == 0
    want = pallas_agg.grouped_sum_i64(jnp.zeros(4, jnp.int32),
                                      [jnp.full((4,), 2**62, jnp.int64)], 1)
    assert int(want[0][0]) == 0


@pytest.mark.parametrize("nseg,k", [
    (1, 1), (1, 24), (20, 16), (20, 3), (20, 40),
    (GS.SMALL_MAX_NSEG, 16), (GS.SMALL_MAX_NSEG + 1, 16),
    (216, 9), (256, 24), (257, 24), (1000, 24), (GS.MAX_NSEG, 1),
])
def test_launch_plan(nseg, k):
    """The regime follows nseg, a launch takes at most MAX_K vectors, and
    every block's tables fit its shared memory: the small regime's with two
    blocks on an SM, the large regime's with as many vectors as fit."""
    plan = GS.launch_plan(nseg, k)
    assert plan.regime == ("small" if nseg <= GS.SMALL_MAX_NSEG else "large")
    assert 1 <= plan.vectors <= min(k, GS.MAX_K)
    assert plan.smem <= GS.SMEM_BLOCK_MAX
    if plan.regime == "small":
        assert plan.vectors == min(k, GS.MAX_K)
        assert plan.group in GS.GROUPS and plan.group <= plan.vectors
        assert plan.smem == GS.WARPS * 32 * 8 * (nseg + 1) * plan.group
        assert 2 * (plan.smem + GS.SMEM_BLOCK_RESERVED) <= GS.SMEM_SM
    else:
        assert plan.group == 0
        assert plan.smem == nseg * (plan.vectors | 1) * 8
        assert (plan.vectors == min(k, GS.MAX_K)
                or nseg * ((plan.vectors + 1) | 1) * 8 > GS.SMEM_BLOCK_MAX)


def test_small_regime_covers_q1():
    """Q1's 16 vectors over 20 slots take the lane-private tables in one launch."""
    assert GS.SMALL_MAX_NSEG >= 20
    assert GS.launch_plan(20, 16) == GS.LaunchPlan("small", 16, 2, 86_016)
    with pytest.raises(ValueError):
        GS.launch_plan(GS.MAX_NSEG + 1, 1)


def test_rejects_mismatched_vectors():
    dense = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        GS.grouped_sum_i64(dense, [torch.zeros(8, dtype=torch.int32)], 2)
    with pytest.raises(ValueError):
        GS.grouped_sum_i64(dense, [torch.zeros(9, dtype=torch.int64)], 2)


def _pallas(dense, vecs, nseg):
    return [np.asarray(w) for w in pallas_agg.grouped_sum_i64(
        jnp.asarray(dense), [jnp.asarray(v) for v in vecs], nseg)]


def _port(dense, vecs, nseg):
    GS.grouped_sum_i64.launches = 0
    got = GS.grouped_sum_i64(torch.from_numpy(dense), [torch.from_numpy(v) for v in vecs],
                             nseg)
    assert GS.grouped_sum_i64.launches == 0  # CPU tensors: plain version
    assert all(g.dtype == torch.int64 and g.shape == (nseg,) for g in got)
    return [g.numpy() for g in got]


def _junk_inputs(n, k, nseg, seed, live_share, id_dtype=np.int32):
    """Ids live with probability live_share, else dead: negative (down to
    int32's least) or past nseg (up to int32's greatest); every row of every
    vector, dead ones too, holds a full-range value."""
    rng = np.random.default_rng(seed)
    live = rng.random(n) < live_share
    dead_ids = np.where(rng.random(n) < 0.5,
                        rng.integers(-2**31, 0, n), rng.integers(nseg, 2**31, n))
    dense = np.where(live, rng.integers(0, nseg, n), dead_ids).astype(id_dtype)
    vecs = [rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64, endpoint=True)
            for _ in range(k)]
    return dense, vecs


@pytest.mark.parametrize("n,k,nseg", [(1000, 1, 7), (5000, 3, 26), (20000, 16, 20),
                                      (4096, 9, 256)])
def test_int64_ids_match_pallas(n, k, nseg):
    """int64 slot ids, dead ones of both signs and past nseg, held to the
    JAX package's kernel: the port takes them as they are (the kernel
    reads 8-byte ids with no conversion)."""
    dense, vecs = _junk_inputs(n, k, nseg, seed=n + k, live_share=0.7, id_dtype=np.int64)
    assert dense.dtype == np.int64 and (dense < 0).any() and (dense >= nseg).any()
    for g, w in zip(_port(dense, vecs, nseg), _pallas(dense, vecs, nseg)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("id_dtype", [np.int32, np.int64])
def test_views_at_row_offsets_match_pallas(offset, id_dtype):
    """Ids and vectors that are views starting 1-3 rows into larger arrays,
    as a chunk of a column is (on the card: off a 16-byte boundary)."""
    n, k, nseg = 10_001, 5, 20
    dense, vecs = _junk_inputs(n + offset, k, nseg, seed=offset, live_share=0.9,
                               id_dtype=id_dtype)
    dense, vecs = dense[offset:], [v[offset:] for v in vecs]
    got = _port(dense, vecs, nseg)
    want = _pallas(np.ascontiguousarray(dense), [np.ascontiguousarray(v) for v in vecs], nseg)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("live_share", [0.01, 0.02])
@pytest.mark.parametrize("k,nseg", [(3, 1), (5, 20)])
def test_sparse_live_rows_with_junk_match_pallas(live_share, k, nseg):
    """1-2% live rows (TPC-H Q6's share) whose dead rows hold full-range
    junk: neither version may add it."""
    dense, vecs = _junk_inputs(60_000, k, nseg, seed=k + nseg, live_share=live_share)
    for g, w in zip(_port(dense, vecs, nseg), _pallas(dense, vecs, nseg)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n", [0, 1, 127, 128, 129])
def test_edge_row_counts_match_pallas(n):
    """Row counts around one warp tile (128 rows) and none at all."""
    k, nseg = 3, 7
    dense, vecs = _junk_inputs(n, k, nseg, seed=n, live_share=0.8)
    got = _port(dense, vecs, nseg)
    if n == 0:
        want = [np.zeros(nseg, np.int64)] * k
    else:
        want = _pallas(dense, vecs, nseg)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("nseg,k", [(1, 1), (7, 2), (20, 19), (26, 1), (216, 9),
                                    (GS.SMALL_MAX_NSEG, 24)])
@pytest.mark.parametrize("delta", [-1, 0, 1])
def test_launch_plan_single_threshold(nseg, k, delta):
    """Inputs of up to SINGLE_MAX_ROWS rows over the small regime's slots
    take its lane-private tables in one block per group of vectors, with the
    persistent grid's tables and groups; one row more the persistent grid.
    Larger domains take the large regime on both sides."""
    n = GS.SINGLE_MAX_ROWS + delta
    plan = GS.launch_plan(nseg, k, n)
    persistent = GS.launch_plan(nseg, k)
    if delta <= 0 and nseg <= GS.SMALL_MAX_NSEG:
        assert plan.regime == "single"
        assert plan == persistent._replace(regime="single")
        assert plan.vectors == min(k, GS.MAX_K)
        assert plan.group in GS.GROUPS and plan.group <= plan.vectors
        assert plan.smem == GS.WARPS * 32 * 8 * (nseg + 1) * plan.group
        assert 2 * (plan.smem + GS.SMEM_BLOCK_RESERVED) <= GS.SMEM_SM
    else:
        assert plan == persistent
        assert plan.regime == ("small" if nseg <= GS.SMALL_MAX_NSEG else "large")


@pytest.mark.parametrize("n", [0, 1, 127, 128, 1_024, 1_025])
def test_launch_plan_single_follows_rows(n):
    """The single regime up to the threshold whatever K is (K 19 over 20
    slots: tables of 2 vectors, 86,016 bytes a block); past it the
    persistent grid with the same tables."""
    plan = GS.launch_plan(20, 19, n)
    regime = "single" if n <= GS.SINGLE_MAX_ROWS else "small"
    assert plan == GS.LaunchPlan(regime, 19, 2, 86_016)
