"""The port's join building blocks against the JAX package's, on the CPU.

Each function of duckdb_tpu_torch/ops/join.py runs on the same seeded
numpy inputs as its counterpart in duckdb_tpu/ops/join.py, and the results
must be equal. The JAX sort is unstable, so where a function's output
depends on the order within a run of equal build keys, the tests compare
per-probe-row sets of matched build rows instead of positions. Also here:
the grouped reductions the sort-group mode runs over its group ids,
against jax.ops.segment_* (empty segments included); its group-key
encoding against the JAX package's `_key_data`; and GatherCols' NULL rows.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import duckdb_tpu  # noqa: F401  (enables x64)
from duckdb_tpu.blocks import Column as JColumn
from duckdb_tpu.execution import aggregate_exec as JA
from duckdb_tpu.execution import executor as JE
from duckdb_tpu.ops import join as JJ
from duckdb_tpu.types import BIGINT as JBIGINT
from duckdb_tpu_torch.blocks import Column as TColumn
from duckdb_tpu_torch.execution import executor as TE
from duckdb_tpu_torch.ops import join as TJ
from duckdb_tpu_torch.ops import sort as TS
from duckdb_tpu_torch.ops.grouped import grouped_reduce
from duckdb_tpu_torch.types import BIGINT as TBIGINT

torch.set_num_threads(1)

# (build rows, probe rows, key range, share of dead build rows, share of
# dead probe rows): duplicates come from a key range below the row count
CASES = {
    "unique": (500, 700, 2000, 0.0, 0.0),
    "duplicates": (800, 600, 50, 0.1, 0.2),
    "dead_rows": (600, 600, 300, 0.5, 0.5),
    "all_build_dead": (256, 300, 100, 1.0, 0.1),
    "one_key": (200, 200, 1, 0.0, 0.0),
}


def _inputs(name):
    nb, npr, rng_, bdead, pdead = CASES[name]
    r = np.random.default_rng(sum(map(ord, name)))
    bkeys = r.integers(0, rng_, nb).astype(np.int64)
    blive = r.random(nb) >= bdead
    # probes reach past the build's range on both sides (out-of-range keys)
    pkeys = r.integers(-rng_ // 4 - 2, rng_ + rng_ // 4 + 2, npr).astype(np.int64)
    plive = r.random(npr) >= pdead  # dead rows stand for NULL-masked keys too
    return bkeys, blive, pkeys, plive


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _n(a):
    return np.asarray(a.cpu().numpy() if isinstance(a, torch.Tensor) else a).astype(np.int64)


def _pairs_by_probe(probe_rows, build_rows, live):
    """{probe row: its sorted matched build rows}, live pairs only."""
    out = {}
    for p, b, lv in zip(_n(probe_rows), _n(build_rows), np.asarray(live)):
        if lv:
            out.setdefault(int(p), []).append(int(b))
    return {p: sorted(bs) for p, bs in out.items()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_build_sorted_and_probe_counts(name):
    bkeys, blive, pkeys, plive = _inputs(name)
    jt = JJ.build_sorted(jnp.asarray(bkeys), jnp.asarray(blive))
    tt = TJ.build_sorted(_t(bkeys), _t(blive))
    np.testing.assert_array_equal(_n(tt.sorted_keys), _n(jt.sorted_keys))
    assert int(tt.num_rows) == int(jt.num_rows)
    # within a run of equal keys the JAX order is unspecified: compare the
    # (key, row) pairs as sets
    assert sorted(zip(_n(tt.sorted_keys), _n(tt.perm))) == \
        sorted(zip(_n(jt.sorted_keys), _n(jt.perm)))
    jc, jlo, jhi = JJ.probe_counts(jt, jnp.asarray(pkeys), jnp.asarray(plive))
    tc, tlo, thi = TJ.probe_counts(tt, _t(pkeys), _t(plive))
    for got, want in ((tc, jc), (tlo, jlo), (thi, jhi)):
        np.testing.assert_array_equal(_n(got), _n(want))
    assert int(tc.sum()) == int(np.sum(
        plive[:, None] & blive[None, :] & (pkeys[:, None] == bkeys[None, :])))


@pytest.mark.parametrize("left_outer", [False, True], ids=["inner", "left_outer"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_expand_matches_same_inputs(name, left_outer):
    """Bit-equal on identical (counts, lo, perm), padding included."""
    bkeys, blive, pkeys, plive = _inputs(name)
    jt = JJ.build_sorted(jnp.asarray(bkeys), jnp.asarray(blive))
    counts, lo, _ = JJ.probe_counts(jt, jnp.asarray(pkeys), jnp.asarray(plive))
    perm = _n(jt.perm)
    true_total = int(np.sum(np.maximum(_n(counts), 1) if left_outer else _n(counts)))
    total = true_total + 37
    want = JJ.expand_matches(counts, lo, jnp.asarray(perm, jnp.int32), total,
                             left_outer=left_outer)
    got = TJ.expand_matches(_t(_n(counts)), _t(_n(lo)), _t(perm), total,
                            left_outer=left_outer)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_n(g), _n(w))


@pytest.mark.parametrize("left_outer", [False, True], ids=["inner", "left_outer"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_sorted_join_pairs(name, left_outer):
    """End to end through each package's own build: the same set of
    matched build rows per probe row, and the same pair count."""
    bkeys, blive, pkeys, plive = _inputs(name)
    jt = JJ.build_sorted(jnp.asarray(bkeys), jnp.asarray(blive))
    jc, jlo, _ = JJ.probe_counts(jt, jnp.asarray(pkeys), jnp.asarray(plive))
    tt = TJ.build_sorted(_t(bkeys), _t(blive))
    tc, tlo, _ = TJ.probe_counts(tt, _t(pkeys), _t(plive))
    total = int(np.sum(np.maximum(_n(jc), 1) if left_outer else _n(jc))) + 5
    jp, jb, jl = JJ.expand_matches(jc, jlo, jt.perm, total, left_outer=left_outer)
    tp, tb, tl = TJ.expand_matches(tc, tlo, tt.perm, total, left_outer=left_outer)
    np.testing.assert_array_equal(_n(tl), _n(jl))
    np.testing.assert_array_equal(_n(tp), _n(jp))
    assert _pairs_by_probe(tp, tb, _n(tl)) == _pairs_by_probe(jp, jb, _n(jl))


def test_expand_matches_empty_build():
    """No live build row: no pairs, and left_outer keeps every probe row
    with a NULL build side."""
    counts = torch.zeros(5, dtype=torch.int64)
    lo = torch.zeros(5, dtype=torch.int64)
    perm = torch.arange(8)
    pr, br, live = TJ.expand_matches(counts, lo, perm, 128)
    assert not live.any()
    pr, br, live = TJ.expand_matches(counts, lo, perm, 128, left_outer=True)
    assert live.sum() == 5 and (br[:5] == -1).all() and pr[:5].tolist() == [0, 1, 2, 3, 4]


@pytest.mark.parametrize("name", ["unique", "dead_rows", "all_build_dead"])
def test_perfect_build_and_probe(name):
    r = np.random.default_rng(len(name))
    n, lo_key, size = 400, 1000, 900
    # unique live keys in [lo_key, lo_key + size); dead rows take keys no
    # live row has (JAX leaves a dead row that shares a live key's slot to
    # its scatter order; the port never lets it overwrite)
    keys = (lo_key + r.permutation(size)[:n]).astype(np.int64)
    frac = {"unique": 0.0, "dead_rows": 0.4, "all_build_dead": 1.0}[name]
    live = r.random(n) >= frac
    jslots = JJ.perfect_build(jnp.asarray(keys), jnp.asarray(live), lo_key, lo_key + size - 1)
    tslots = TJ.perfect_build(_t(keys), _t(live), lo_key, lo_key + size - 1)
    np.testing.assert_array_equal(_n(tslots), _n(jslots))
    probes = r.integers(lo_key - 50, lo_key + size + 50, 1000).astype(np.int64)
    plive = r.random(1000) >= 0.2
    jrows, jm = JJ.perfect_probe(jslots, jnp.asarray(probes), jnp.asarray(plive), lo_key)
    trows, tm = TJ.perfect_probe(tslots, _t(probes), _t(plive), lo_key)
    np.testing.assert_array_equal(_n(trows), _n(jrows))
    np.testing.assert_array_equal(_n(tm), _n(jm))


@pytest.mark.parametrize("dtype", ["int64", "float64"])
@pytest.mark.parametrize("kind", ["sum", "min", "max"])
def test_group_reductions_match_jax_segments(kind, dtype):
    """The sort-group mode's reductions over group ids, with empty groups
    and dead rows (id nseg): an empty group holds the dtype's max for min
    and its min for max, as jax.ops.segment_* give."""
    r = np.random.default_rng(3)
    nseg = 300  # above the grouped sum's kernel routing limit, as sort-group
    ids = r.integers(0, nseg - 10, 1000)  # the last 10 groups stay empty
    if dtype == "int64":
        data = r.integers(-2**62, 2**62, 1000)
    else:
        data = r.standard_normal(1000) * 1e6
    jfn = {"sum": jax.ops.segment_sum, "min": jax.ops.segment_min,
           "max": jax.ops.segment_max}[kind]
    want = np.asarray(jfn(jnp.asarray(data), jnp.asarray(ids), num_segments=nseg))
    dead = np.full(50, nseg)  # rows outside every group
    got = grouped_reduce(_t(np.r_[ids, dead]), [_t(np.r_[data, data[:50]])], [kind],
                         nseg)[0].numpy()
    if dtype == "float64" and kind == "sum":
        np.testing.assert_allclose(got, want, rtol=1e-12)
    else:
        np.testing.assert_array_equal(got, want)


def test_group_key_encoding_matches_jax():
    """Sort-group keys: equal values ↔ equal int64 codes, floats included."""
    vals = np.array([0.0, -0.5, 3.25, -1e300, 1e300, 2.0, -0.5], dtype=np.float64)
    jcol = JColumn(data=jnp.asarray(vals), ltype=None)
    np.testing.assert_array_equal(TS.orderable_int64(_t(vals), None, False, False).numpy(),
                                  np.asarray(JA._key_data(jcol, 7)))


def test_gather_cols_null_rows_match_jax():
    r = np.random.default_rng(5)
    vals = r.integers(-100, 100, 256).astype(np.int64)
    valid = r.random(256) > 0.3
    rows = r.integers(-1, 256, 300).astype(np.int64)
    nulls = r.random(300) > 0.6
    jsrc = JE.DictCols({"k": JColumn(data=jnp.asarray(vals), ltype=JBIGINT,
                                     validity=jnp.asarray(valid))})
    tsrc = TE.DictCols({"k": TColumn(data=_t(vals), ltype=TBIGINT, validity=_t(valid))})
    jg = JE.GatherCols(jsrc, jnp.asarray(rows, jnp.int32), jnp.asarray(nulls))["k"]
    tg = TE.GatherCols(tsrc, _t(rows), _t(nulls))["k"]
    np.testing.assert_array_equal(tg.data.numpy(), np.asarray(jg.data))
    np.testing.assert_array_equal(tg.validity.numpy(), np.asarray(jg.validity))
