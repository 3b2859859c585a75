"""The port's mesh programs (duckdb_tpu_torch/parallel/shard.py) against the
JAX package's shard_map programs on the conftest's 8 virtual devices.

Inputs come from numpy with a seed and go to both packages. The port runs
8 shards on the CPU (all on one device, as the conftest's 8 XLA devices
are one host). Held bit for bit: q1_local_partial on
`__graft_entry__.entry()`'s inputs, the sharded Q1, `_hash_dest` (so each
shard receives the same rows as in JAX), the replicated probe's counts
and lo. Held as sets: the exchange joins' (probe row, build row) pairs,
with duplicate keys too, and each shard's received rows; the TopN
candidates of each shard. The sharded sort's order is the global stable
order (ties by row id) for ASC, DESC and NULLS FIRST/LAST, as JAX's. The
sharded window equals the single-device window for every kind, and the
JAX program where that is right (W5: its whole-partition sums run to the
end of the shard). Empty and one-row shards pass through every program.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from duckdb_tpu.parallel import shard as JS
from duckdb_tpu_torch.execution import window_exec as WX
from duckdb_tpu_torch.ops import grouped_sum as GS
from duckdb_tpu_torch.ops import sort as S
from duckdb_tpu_torch.parallel import shard as TS

torch.set_num_threads(1)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import __graft_entry__  # noqa: E402  (the JAX package's entry inputs)

N = 8
I64_MAX = np.iinfo(np.int64).max


@pytest.fixture(scope="module")
def jmesh():
    return JMesh(np.array(jax.devices()[:N]), ("dp",))


@pytest.fixture(scope="module")
def tmesh():
    return TS.Mesh(N, "cpu")


def t(x):
    return torch.from_numpy(np.array(x))


def test_mesh_places_shards():
    m = TS.Mesh(N, "cpu")
    assert m.devices == [torch.device("cpu")] * N and m.shared
    assert TS.visible_devices("cpu") == 1
    assert TS.mesh_for(N, "cpu") is TS.mesh_for(N, torch.device("cpu"))


def test_q1_local_partial_bit_for_bit():
    fn, args = __graft_entry__.entry()
    want = [np.asarray(x) for x in jax.jit(fn)(*args)]
    GS.grouped_sum_i64.launches = 0
    got = TS.q1_local_partial(*(t(a) for a in args), 8)
    assert len(got) == 6
    for w, g in zip(want, got):
        assert g.dtype == torch.int64 and np.array_equal(w, g.numpy())


def _q1_inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(1, 50, n) * 100, rng.integers(1000, 100000, n),
            rng.integers(0, 10, n), rng.integers(0, 8, n),
            rng.integers(0, 8, n).astype(np.int32), rng.random(n) < 0.9)


def test_sharded_q1_matches_jax(jmesh, tmesh):
    ins = _q1_inputs(128 * N)
    want = JS.make_sharded_q1(jmesh, 8)(*(jnp.asarray(x) for x in ins))
    got = TS.make_sharded_q1(tmesh, 8)(*(t(x) for x in ins))
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("n", [1, 2, 3, 7, 8])
def test_hash_dest_bit_for_bit(n):
    rng = np.random.default_rng(n)
    keys = np.concatenate([rng.integers(np.iinfo(np.int64).min, I64_MAX, 5000, dtype=np.int64),
                           np.array([-2, -1, 0, 1, I64_MAX, np.iinfo(np.int64).min])])
    want = np.asarray(JS._hash_dest(jnp.asarray(keys), n))
    got = TS._hash_dest(t(keys), n).numpy()
    assert np.array_equal(want, got) and got.min() >= 0 and got.max() < n


def test_replicated_probe_matches_jax(jmesh, tmesh):
    rng = np.random.default_rng(3)
    n = 128 * N
    build = np.sort(rng.integers(0, 1000, 256)).astype(np.int64)
    keys = rng.integers(0, 1000, n).astype(np.int64)
    live = rng.random(n) < 0.8
    wc, wl = JS.make_sharded_join_probe(jmesh)(jnp.asarray(build), jnp.asarray(keys),
                                               jnp.asarray(live))
    gc, gl = TS.make_sharded_join_probe(tmesh)(t(build), t(keys), t(live))
    assert np.array_equal(np.asarray(wc), gc.numpy())
    assert np.array_equal(np.asarray(wl), gl.numpy())


def _join_inputs(dup: bool, seed=5):
    rng = np.random.default_rng(seed)
    n_p, n_b = 256 * N, 128 * N
    if dup:
        bk = rng.integers(0, 300, n_b).astype(np.int64)
    else:
        bk = rng.permutation(1 << 20)[:n_b].astype(np.int64)
    pk = np.where(rng.random(n_p) < 0.6, bk[rng.integers(0, n_b, n_p)],
                  rng.integers(1 << 21, 1 << 22, n_p)).astype(np.int64)
    return pk, rng.random(n_p) < 0.9, bk, rng.random(n_b) < 0.85


def _per_shard(arr, n_shards):
    return np.split(np.asarray(arr), n_shards)


def test_exchange_join_matches_jax(jmesh, tmesh):
    pk, pl, bk, bl = _join_inputs(dup=False)
    n_p, n_b = len(pk), len(bk)
    jstep = JS.make_exchange_join(jmesh, N, n_p // N, n_b // N)
    rp, br, overflow, _, _ = jstep(jnp.asarray(pk), jnp.asarray(pl),
                                   jnp.arange(n_p, dtype=jnp.int32), jnp.asarray(bk),
                                   jnp.asarray(bl), jnp.arange(n_b, dtype=jnp.int32))
    assert int(overflow) == 0
    got = TS.make_exchange_join(tmesh)(t(pk), t(pl), torch.arange(n_p), t(bk), t(bl),
                                       torch.arange(n_b))
    assert len(got.rp) == N
    pairs_t = set()
    for j, (jrp, jbr) in enumerate(zip(_per_shard(rp, N), _per_shard(br, N))):
        keep = jrp >= 0
        want = set(zip(jrp[keep].tolist(), jbr[keep].tolist()))
        have = set(zip(got.rp[j].tolist(), got.br[j].tolist()))
        assert have == want, f"shard {j}"
        assert len(got.rp[j]) == keep.sum()
        pairs_t |= have
    # and against a host oracle: every live probe row once, its match or -1
    where = {int(k): i for i, k in enumerate(bk) if bl[i]}
    assert pairs_t == {(i, where.get(int(pk[i]), -1)) for i in range(n_p) if pl[i]}


def test_exchange_join_dup_matches_jax(jmesh, tmesh):
    pk, pl, bk, bl = _join_inputs(dup=True)
    n_p, n_b = len(pk), len(bk)
    jstep = JS.make_exchange_join_dup(jmesh, N, n_p // N, n_b // N, 1 << 13)
    pr, br, pm, prr, overflow, *_ = jstep(
        jnp.asarray(pk), jnp.asarray(pl), jnp.arange(n_p, dtype=jnp.int32), jnp.asarray(bk),
        jnp.asarray(bl), jnp.arange(n_b, dtype=jnp.int32))
    assert int(overflow) == 0
    got = TS.make_exchange_join_dup(tmesh)(t(pk), t(pl), torch.arange(n_p), t(bk), t(bl),
                                           torch.arange(n_b))
    all_pairs = []
    for j in range(N):
        jpr, jbr = _per_shard(pr, N)[j], _per_shard(br, N)[j]
        jprr, jpm = _per_shard(prr, N)[j], _per_shard(pm, N)[j]
        keep = jpr >= 0
        want = sorted(zip(jpr[keep].tolist(), jbr[keep].tolist()))
        have = sorted(zip(got.pr[j].tolist(), got.br[j].tolist()))
        assert have == want, f"shard {j}"
        routed = jprr >= 0
        assert sorted(zip(got.prr[j].tolist(), got.pm[j].tolist())) == \
            sorted(zip(jprr[routed].tolist(), jpm[routed].tolist()))
        all_pairs += have
    want_all = sorted((i, b) for i in range(n_p) if pl[i]
                      for b in np.flatnonzero(bl & (bk == pk[i])).tolist())
    assert sorted(all_pairs) == want_all


def _sort_keys(order: str, seed=11):
    rng = np.random.default_rng(seed)
    r = 512 * N
    a = rng.integers(0, 300, r)  # many ties: the row id decides
    b = rng.integers(0, 5, r)
    valid = rng.random(r) > 0.1
    live = rng.random(r) < 0.93
    desc, nulls_first = order in ("desc", "desc_nulls_first"), order.endswith("nulls_first")
    k0 = S.orderable_int64(t(a), t(valid), desc, nulls_first)
    k1 = S.orderable_int64(t(b), None, False, False)
    return torch.stack([k0, k1]), live


@pytest.mark.parametrize("order", ["asc", "desc", "nulls_first", "desc_nulls_first"])
def test_sharded_sort_global_stable_order(jmesh, tmesh, order):
    keys, live = _sort_keys(order)
    r = keys.shape[1]
    got = torch.cat(TS.make_sharded_sort(tmesh, 2)(keys, t(live), torch.arange(r))).numpy()
    ks = keys.numpy()
    rows = np.flatnonzero(live)
    want = rows[np.lexsort((rows, ks[1][rows], ks[0][rows]))]
    assert np.array_equal(got, want)
    assert np.array_equal(got, S.sort_permutation(list(keys), t(live))[:len(rows)].numpy())
    if order == "asc":  # the JAX program, once (one compile)
        jrows, jlive, overflow, _ = JS.make_sharded_sort(jmesh, N, r // N, 2)(
            jnp.asarray(ks), jnp.asarray(live), jnp.arange(r, dtype=jnp.int32))
        assert int(overflow) == 0
        assert np.array_equal(np.asarray(jrows)[np.asarray(jlive)], got)


def test_sharded_topn_candidates_match_jax(jmesh, tmesh):
    keys, live = _sort_keys("desc_nulls_first", seed=13)
    r, k = keys.shape[1], 37
    gk, gr = JS.make_sharded_topn(jmesh, N, k, 2)(jnp.asarray(keys.numpy()),
                                                  jnp.asarray(live),
                                                  jnp.arange(r, dtype=jnp.int32))
    cand = TS.make_sharded_topn(tmesh, k, 2)(keys, t(live), torch.arange(r))
    assert cand.rows.shape[0] == N * k
    jr = np.asarray(gr)
    for j in range(N):
        sl = slice(j * k, (j + 1) * k)
        want = jr[sl][jr[sl] >= 0].tolist()
        have = cand.rows[sl][cand.live[sl]].tolist()
        assert have == want, f"shard {j}"
        assert np.array_equal(cand.keys[:, sl].numpy(), np.asarray(gk)[:, sl])
    # the final pick: the single-device stable sort's first k
    perm = S.sort_permutation(list(cand.keys), cand.live)
    top = cand.rows[perm][:k].numpy()
    assert np.array_equal(top, S.sort_permutation(list(keys), t(live))[:k].numpy())


def _window_inputs(seed=17):
    rng = np.random.default_rng(seed)
    r = 256 * N
    g = rng.integers(0, 40, r)  # partitions
    o = rng.integers(0, 30, r)  # order key with peers
    v = rng.integers(-50, 50, r)
    vv = rng.random(r) > 0.15
    live = rng.random(r) < 0.9
    return g, o, v, vv, live


def _single_window(kind, running, g, o, v, vv, live):
    """The single-device window over the same normalized keys: window_exec's
    own order and scans, values back in row order."""
    pk = S.orderable_int64(t(g), None, False, True)
    ok = [S.orderable_int64(t(o), None, False, False)] if running else []
    od = WX.order_from_keys([pk], ok, t(live))
    vals, valid = WX.keyed_window_values(kind, od, t(v)[od.perm], t(vv)[od.perm])
    out = torch.zeros_like(vals)
    out[od.perm] = vals
    ov = torch.ones(len(g), dtype=torch.bool)
    if valid is not None:
        ov[od.perm] = valid
    return out.numpy(), ov.numpy()


@pytest.mark.parametrize("kind,running", [
    ("row_number", True), ("rank", True), ("dense_rank", True), ("count", False),
    ("count", True), ("sum", False), ("sum", True), ("avg", False), ("min", False),
    ("max", False)])
def test_sharded_window_equals_single(tmesh, kind, running):
    g, o, v, vv, live = _window_inputs()
    pk = S.orderable_int64(t(g), None, False, True)
    ok = [S.orderable_int64(t(o), None, False, False)] if running else []
    (res,) = TS.make_sharded_window(tmesh, 1, [len(ok)], [(kind, 0)])(
        pk, t(live), torch.arange(len(g)), [pk], [ok], [(t(v), t(vv), 1.0)])
    rows = res.rows.numpy()
    assert sorted(rows.tolist()) == np.flatnonzero(live).tolist()
    want, wvalid = _single_window(kind, running, g, o, v, vv, live)
    assert np.array_equal(res.values.numpy(), want[rows])
    assert np.array_equal(res.valid.numpy(), wvalid[rows])
    if kind == "count" and not running:
        # a whole-partition count is the partition's size (W5)
        sizes = {x: int(((g == x) & live & vv).sum()) for x in set(g.tolist())}
        assert res.values.tolist() == [sizes[int(g[i])] for i in rows]


def test_sharded_windows_share_one_exchange(tmesh, monkeypatch):
    """Windows of one PARTITION BY: one exchange, one sort per shard for each
    ORDER BY, each window's values those of its own single-device run."""
    g, o, v, vv, live = _window_inputs()
    pk = S.orderable_int64(t(g), None, False, True)
    ok = [S.orderable_int64(t(o), None, False, False)]
    exchanges, orig = [], TS.exchange
    monkeypatch.setattr(TS, "exchange", lambda mesh, sides: exchanges.append(1)
                        or orig(mesh, sides))
    specs = [("row_number", 1), ("count", 0), ("sum", 0), ("sum", 1)]
    args = [(None, None, 1.0), (None, None, 1.0), (t(v), t(vv), 1.0), (t(v), t(vv), 1.0)]
    res = TS.make_sharded_window(tmesh, 1, [0, 1], specs)(
        pk, t(live), torch.arange(len(g)), [pk], [[], ok], args)
    assert len(exchanges) == 1
    ones = np.ones(len(g), bool)
    for (kind, order), (a, _, _), r in zip(specs, args, res):
        rows = r.rows.numpy()
        assert sorted(rows.tolist()) == np.flatnonzero(live).tolist()
        want, wvalid = _single_window(kind, order == 1, g, o, v if a is not None else 0 * v,
                                      vv if a is not None else ones, live)
        assert np.array_equal(r.values.numpy(), want[rows])
        assert np.array_equal(r.valid.numpy(), wvalid[rows])


@pytest.mark.parametrize("kind", ["rank", "min"])
def test_sharded_window_matches_jax(jmesh, tmesh, kind):
    """Where the JAX program is right: rank, and min/max (segment ops).
    (Its row_number breaks ties by the order rows arrived in, which its
    unstable bucketing leaves open; the port's by row id.)"""
    g, o, v, vv, live = _window_inputs(seed=19)
    r = len(g)
    running = kind == "rank"
    pk = S.orderable_int64(t(g), None, False, True)
    ok = [S.orderable_int64(t(o), None, False, False)] if running else []
    jstep = JS.make_sharded_window(jmesh, N, r // N, 1, len(ok), kind, running)
    jr, jv, jvalid, overflow, _ = jstep(
        jnp.asarray(pk.numpy()), jnp.asarray(live), jnp.arange(r, dtype=jnp.int32),
        jnp.asarray(pk.numpy()), *(jnp.asarray(x.numpy()) for x in ok),
        jnp.asarray(v.astype(np.int64)), jnp.asarray(vv))
    assert int(overflow) == 0
    jr, jv, jvalid = np.asarray(jr), np.asarray(jv), np.asarray(jvalid)
    keep = jr >= 0
    want = dict(zip(jr[keep].tolist(), zip(jv[keep].tolist(), jvalid[keep].tolist())))
    (res,) = TS.make_sharded_window(tmesh, 1, [len(ok)], [(kind, 0)])(
        pk, t(live), torch.arange(r), [pk], [ok], [(t(v.astype(np.int64)), t(vv), 1.0)])
    have = dict(zip(res.rows.tolist(), zip(res.values.tolist(), res.valid.tolist())))
    if kind == "rank":  # JAX's validity of a ranking is its liveness
        have = {k: x[0] for k, x in have.items()}
        want = {k: x[0] for k, x in want.items()}
    assert have == want


@pytest.mark.parametrize("rows", [0, 1, 3, 9])
def test_empty_and_one_row_shards(tmesh, rows):
    """Fewer rows than shards, none live: every program still answers."""
    rng = np.random.default_rng(rows)
    live = np.ones(rows, bool)
    keys = rng.integers(0, 4, rows).astype(np.int64)
    # Q1
    ins = _q1_inputs(rows, seed=rows)
    got = TS.make_sharded_q1(tmesh, 8)(*(t(x) for x in ins))
    whole = TS.q1_local_partial(*(t(x) for x in ins), 8)
    assert all(torch.equal(a, b) for a, b in zip(got, whole))
    # probe, exchange joins
    c, lo = TS.make_sharded_join_probe(tmesh)(torch.tensor([1, 2, 2]), t(keys), t(live))
    assert c.tolist() == [int((np.array([1, 2, 2]) == k).sum()) for k in keys]
    ex = TS.make_exchange_join(tmesh)(t(keys), t(live), torch.arange(rows),
                                      torch.tensor([0, 1]), torch.tensor([True, True]),
                                      torch.arange(2))
    assert sorted(zip(torch.cat(ex.rp).tolist(), torch.cat(ex.br).tolist())) == \
        [(i, int(k) if k < 2 else -1) for i, k in enumerate(keys)]
    dup = TS.make_exchange_join_dup(tmesh)(t(keys), t(live), torch.arange(rows), t(keys),
                                           t(live), torch.arange(rows))
    assert sorted(zip(torch.cat(dup.pr).tolist(), torch.cat(dup.br).tolist())) == \
        sorted((i, j) for i in range(rows) for j in range(rows) if keys[i] == keys[j])
    # sort, topn, window, also with no live row
    for lv in (live, np.zeros(rows, bool)):
        k2 = t(keys)[None]
        srt = torch.cat(TS.make_sharded_sort(tmesh, 1)(k2, t(lv), torch.arange(rows)))
        assert srt.tolist() == S.sort_permutation([t(keys)], t(lv))[:int(lv.sum())].tolist()
        cand = TS.make_sharded_topn(tmesh, 2, 1)(k2, t(lv), torch.arange(rows))
        assert int(cand.live.sum()) == min(int(lv.sum()), 2 * N)
        (w,) = TS.make_sharded_window(tmesh, 1, [0], [("count", 0)])(
            t(keys), t(lv), torch.arange(rows), [t(keys)], [[]], [(t(keys), t(lv), 1.0)])
        assert sorted(w.rows.tolist()) == np.flatnonzero(lv).tolist()
        assert w.values.tolist() == [int((keys[lv] == keys[i]).sum()) for i in w.rows.tolist()]


def test_copied_bytes_zero_on_one_device(tmesh):
    TS.COPIED["bytes"] = 0
    TS.make_sharded_q1(tmesh, 8)(*(t(x) for x in _q1_inputs(64)))
    assert TS.COPIED["bytes"] == 0
