"""Grouped reductions and the aggregate partial/finalize pair: port vs JAX.

`grouped_reduce` (both routes: the grouped-sum kernel's domain, nseg ≤ 256,
and the index_add_/scatter_reduce_ route beyond it) and the fused
aggregate's `_slot_agg_partial_vectors` / `_slot_agg_finalize` — including
the hi/lo wide SUM — get the same numpy inputs in both packages. Integer
results must be equal; float64 sums may differ in the last bits because
the two packages add in different orders, so they are held to 1e-12
relative.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from duckdb_tpu.blocks import Column as JColumn
from duckdb_tpu.execution import fused_agg as JF
from duckdb_tpu.ops import grouped as JG
from duckdb_tpu.planner import bound as JB
from duckdb_tpu.types import decimal as jdecimal
from duckdb_tpu_torch.execution import fused_agg as TF
from duckdb_tpu_torch.ops import grouped as TG
from duckdb_tpu_torch.planner import bound as TB
from duckdb_tpu_torch.testing import from_numpy_columns, parse_type_text
from duckdb_tpu_torch.types import decimal as tdecimal

torch.set_num_threads(1)


def jparse(text):
    """The JAX package's LogicalType for a type's SQL text."""
    from duckdb_tpu.planner.binder import resolve_type_name

    if text.startswith("DECIMAL("):
        w, s = text[8:-1].split(",")
        return jdecimal(int(w), int(s))
    return resolve_type_name(text.lower(), ())


def _vectors(n, nseg, seed):
    rng = np.random.default_rng(seed)
    dense = rng.integers(-1, nseg + 1, n).astype(np.int32)
    dead = (dense < 0) | (dense >= nseg)
    i64 = rng.integers(-2**40, 2**40, n)
    f64 = rng.standard_normal(n) * 1e3
    info = np.iinfo(np.int64)
    vecs = [
        (np.where(dead, 0, i64), "sum"),
        (np.where(dead, 0.0, f64), "sum"),
        (np.where(dead, info.max, i64), "min"),
        (np.where(dead, info.min, i64), "max"),
        (np.where(dead, np.inf, f64), "min"),
        (np.where(dead, -np.inf, f64), "max"),
        ((~dead).astype(np.int32), "sum"),
    ]
    return dense, vecs


@pytest.mark.parametrize("n,nseg", [(3000, 1), (20000, 20), (10000, 256),
                                    (20000, 300), (5000, 4000)])
def test_grouped_reduce_matches_jax(n, nseg):
    dense, vecs = _vectors(n, nseg, seed=n + nseg)
    kinds = [k for _, k in vecs]
    want = JG.grouped_reduce(jnp.asarray(dense), [jnp.asarray(v) for v, _ in vecs],
                             kinds, nseg)
    got = TG.grouped_reduce(torch.from_numpy(dense),
                            [torch.from_numpy(v) for v, _ in vecs], kinds, nseg)
    for (v, kind), g, w in zip(vecs, got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == (nseg,) and g.dtype == v.dtype
        if v.dtype == np.float64 and kind == "sum":
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-9)
        else:
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("func,wide", [("sum", True), ("sum", False),
                                       ("avg", False), ("min", False),
                                       ("max", False), ("count", False)])
def test_partial_and_finalize_match_jax(func, wide):
    """The same DECIMAL column state through both packages' partial vectors,
    grouped reduce and finalize (wide: the hi/lo split of sum_needs_wide)."""
    n, nseg = 5000, 6
    rng = np.random.default_rng(11)
    values = rng.integers(-(2**62), 2**62, n) if wide else rng.integers(-10**9, 10**9, n)
    validity = rng.random(n) > 0.1
    live = rng.random(n) > 0.2
    dense = np.where(live, rng.integers(0, nseg, n), nseg).astype(np.int32)
    planes = {"x": (values, validity, None)}
    jt, tt = jdecimal(18, 2), tdecimal(18, 2)
    result_type = {"sum": "DECIMAL(38,2)", "avg": "DOUBLE", "count": "BIGINT"}.get(
        func, "DECIMAL(18,2)")
    jrt = jparse(result_type)
    trt = parse_type_text(result_type)

    # JAX state
    jcol = JColumn.from_numpy(values, jt, validity=validity, pad_to=n)
    jagg = JB.BoundAggregate(func, [JB.BoundColumnRef("x", jt)], False, jrt, "a")
    jagg._wide = wide
    jenv = JB.EvalEnv(cols={"x": jcol}, plen=n, live=jnp.asarray(live))
    jparts = JF._slot_agg_partial_vectors(jagg, jenv, jnp.asarray(live), n)
    jred = JG.grouped_reduce(jnp.asarray(dense), [v for v, _ in jparts],
                             [k for _, k in jparts], nseg)
    jdata, jvalid = JF._slot_agg_finalize(jagg, jred, jt)

    # port state from the same host planes
    tcols = from_numpy_columns(planes, {"x": repr(jt)}, pad_to=n)
    assert tcols["x"].ltype == tt
    tagg = TB.BoundAggregate(func, [TB.BoundColumnRef("x", tt)], False, trt, "a")
    tagg._wide = wide
    tlive = torch.from_numpy(live)
    tenv = TB.EvalEnv(cols=tcols, plen=n, live=tlive)
    tparts = TF._slot_agg_partial_vectors(tagg, tenv, tlive, n)
    assert [k for _, k in tparts] == [k for _, k in jparts]
    for (tv, _), (jv, _) in zip(tparts, jparts):
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    tred = TG.grouped_reduce(torch.from_numpy(dense), [v for v, _ in tparts],
                             [k for _, k in tparts], nseg)
    tdata, tvalid = TF._slot_agg_finalize(tagg, tred, tt)

    if wide:
        assert isinstance(tdata, tuple) and isinstance(jdata, tuple)
        for t_, j_ in zip(tdata, jdata):
            np.testing.assert_array_equal(t_.numpy(), np.asarray(j_))
        # the (low64, hi64) planes recombine to the exact 128-bit sums
        lo, hi = tdata
        for g in range(nseg):
            m = (dense == g) & validity
            exact = sum(int(x) for x in values[m])
            assert int(hi[g]) * 2**64 + (int(lo[g]) & (2**64 - 1)) == exact
    else:
        np.testing.assert_array_equal(tdata.numpy(), np.asarray(jdata))
    if jvalid is None:
        assert tvalid is None
    else:
        np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
