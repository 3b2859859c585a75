"""The port's sharded programs over a mesh of two processes: two gloo
ranks × 4 local shards on the CPU, one 8-shard ProcessMesh spanning the
process boundary (duckdb_tpu_torch/parallel/shard.py), the counterpart of
tests/test_multihost.py's two jax.distributed processes × 4 CPU devices.

Each child joins the group with init_process_mesh("gloo", local=4, device="cpu"),
builds tests/test_multihost.py's data (seed 7, NP 4096, NB 1024) and more
from the same generator, passes its half of every input's rows with
global row ids, and saves what it got back. The parent holds the union of
both ranks' parts against a host oracle, against the port's
single-process Mesh of 8 on the whole inputs (each rank's four shards
receive what shards r·4 … r·4 + 3 of the single-process mesh receive), and
for the exchange join and the sort against the JAX package's
single-process 8-device programs on the same inputs (the join as a set of
pairs). The exchange join, the duplicate-key join, the sort, the TopN, a
window and Q1's psum are checked. Each child runs under a timeout.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from duckdb_tpu_torch.ops import sort as S
from duckdb_tpu_torch.parallel import shard as TS

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT = 45
K, N_RANKS = 4, 2
TOPN = 100


def make_inputs():
    """tests/test_multihost.py's join and sort data, then a duplicate-key
    build, Q1-like columns and window columns from the same generator."""
    rng = np.random.default_rng(7)
    NP, NB = 4096, 1024
    d = {}
    d["pk"] = rng.integers(0, 2000, NP).astype(np.int64)
    d["bk"] = rng.permutation(2000)[:NB].astype(np.int64)  # unique build keys
    d["p_live"] = rng.random(NP) < 0.9
    d["b_live"] = rng.random(NB) < 0.9
    d["sort_keys"] = rng.integers(-10_000, 10_000, 4096).astype(np.int64)
    d["sort_live"] = rng.random(4096) < 0.85
    d["dup_bk"] = rng.integers(0, 600, NB).astype(np.int64)  # duplicate build keys
    n = 4096
    d["qty"] = rng.integers(1, 50, n) * 100
    d["price"] = rng.integers(1000, 100000, n)
    d["disc"] = rng.integers(0, 10, n)
    d["tax"] = rng.integers(0, 8, n)
    d["gid"] = rng.integers(0, 8, n).astype(np.int32)
    d["q_live"] = rng.random(n) < 0.9
    d["wg"] = rng.integers(0, 40, n)
    d["wo"] = rng.integers(0, 30, n)
    d["wv"] = rng.integers(-50, 50, n).astype(np.int64)
    d["w_live"] = rng.random(n) < 0.9
    return d


def half(x, rank, world=N_RANKS):
    n = len(x)
    return x[rank * n // world:(rank + 1) * n // world]


def rows_of(x, rank):
    """The global row ids of a rank's half."""
    n = len(x)
    return np.arange(rank * n // N_RANKS, (rank + 1) * n // N_RANKS, dtype=np.int64)


def run_programs(mesh, d, rank):
    """Every program over `mesh` on rank `rank`'s half (rank 0 of a
    one-process mesh: the whole inputs) → a dict of numpy results."""
    world = mesh.world
    t = torch.from_numpy

    def h(x):
        return t(np.ascontiguousarray(half(x, rank, world)))

    def r(x):
        n = len(x)
        return torch.arange(rank * n // world, (rank + 1) * n // world, dtype=torch.int64)

    out = {}
    j = TS.make_exchange_join(mesh)(h(d["pk"]), h(d["p_live"]), r(d["pk"]), h(d["bk"]),
                                    h(d["b_live"]), r(d["bk"]))
    out["join_rp"] = [x.numpy() for x in j.rp]
    out["join_br"] = [x.numpy() for x in j.br]
    dj = TS.make_exchange_join_dup(mesh)(h(d["pk"]), h(d["p_live"]), r(d["pk"]),
                                         h(d["dup_bk"]), h(d["b_live"]), r(d["dup_bk"]))
    out["dup_pr"] = [x.numpy() for x in dj.pr]
    out["dup_br"] = [x.numpy() for x in dj.br]
    keys = S.orderable_int64(h(d["sort_keys"]), None, False, False)[None]
    out["sort"] = [x.numpy() for x in TS.make_sharded_sort(mesh, 1)(
        keys, h(d["sort_live"]), r(d["sort_keys"]))]
    cand = TS.make_sharded_topn(mesh, TOPN, 1)(keys, h(d["sort_live"]), r(d["sort_keys"]))
    out["topn"] = cand.rows[S.sort_permutation(list(cand.keys), cand.live)][:TOPN].numpy()
    pk = S.orderable_int64(h(d["wg"]), None, False, True)
    ok = [S.orderable_int64(h(d["wo"]), None, False, False)]
    (w,) = TS.make_sharded_window(mesh, 1, [1], [("rank", 0)])(
        pk, h(d["w_live"]), r(d["wg"]), [pk], [ok], [(h(d["wv"]), None, 1.0)])
    out["win_rows"], out["win_vals"] = w.rows.numpy(), w.values.numpy()
    q1 = TS.make_sharded_q1(mesh, 8)(*(h(d[k]) for k in ("qty", "price", "disc", "tax",
                                                          "gid", "q_live")))
    out["q1"] = np.stack([x.numpy() for x in q1])
    return out


WORKER = r"""
import sys
sys.path.insert(0, {root!r})
import numpy as np
import torch
torch.set_num_threads(1)
from duckdb_tpu_torch.parallel import shard as TS
sys.path.insert(0, {root!r} + "/tests")
import test_torch_multihost as M  # by its file: another "tests" package may be installed

addr, rank, path = sys.argv[1], int(sys.argv[2]), sys.argv[3]
mesh = TS.init_process_mesh("gloo", local=M.K, init_method="tcp://" + addr,
                            world_size=M.N_RANKS, rank=rank, device="cpu")
assert (mesh.n, mesh.first, mesh.world) == (8, rank * M.K, 2), mesh
out = M.run_programs(mesh, M.make_inputs(), rank)
flat = {{}}
for k, v in out.items():
    if isinstance(v, list):
        for i, x in enumerate(v):
            flat[f"{{k}}.{{i}}"] = x
    else:
        flat[k] = v
np.savez(path, **flat)
print(f"rank {{rank}} OK", flush=True)
"""


def _load(path):
    z = np.load(path)
    out = {}
    for k in z.files:
        if "." in k:
            name, i = k.split(".")
            out.setdefault(name, {})[int(i)] = z[k]
        else:
            out[k] = z[k]
    return {k: [v[i] for i in sorted(v)] if isinstance(v, dict) else v for k, v in out.items()}


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multihost")
    addr = f"127.0.0.1:{_free_port()}"
    script = tmp / "worker.py"
    script.write_text(WORKER.format(root=ROOT))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), addr, str(i), str(tmp / f"r{i}.npz")],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env, cwd=ROOT)
             for i in range(N_RANKS)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=CHILD_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {i} failed:\n{out[-3000:]}"
        assert f"rank {i} OK" in out
    return [_load(tmp / f"r{i}.npz") for i in range(N_RANKS)]


@pytest.fixture(scope="module")
def data():
    return make_inputs()


@pytest.fixture(scope="module")
def single(data):
    """The same programs on one process's Mesh of 8 over the whole inputs."""
    return run_programs(TS.Mesh(8, "cpu"), data, 0)


def _pairs(rp, br):
    return {(int(a), int(b)) for ra, rb in zip(rp, br) for a, b in zip(ra, rb)}


def test_exchange_join(ranks, data, single):
    d = data
    got = set()
    for rank, res in enumerate(ranks):
        assert len(res["join_rp"]) == K
        # this rank's shards received what the one-process mesh's shards
        # rank·K … rank·K + K − 1 received
        for jl in range(K):
            assert sorted(res["join_rp"][jl].tolist()) == \
                sorted(single["join_rp"][rank * K + jl].tolist())
        got |= _pairs(res["join_rp"], res["join_br"])
    lut = {int(k): i for i, (k, lv) in enumerate(zip(d["bk"], d["b_live"])) if lv}
    want = {(i, lut.get(int(k), -1)) for i, (k, lv) in enumerate(zip(d["pk"], d["p_live"]))
            if lv}
    assert got == want == _pairs(single["join_rp"], single["join_br"])


def test_exchange_join_matches_the_jax_package(ranks, data):
    import jax.numpy as jnp

    from duckdb_tpu.parallel import shard as JS

    d = data
    NP, NB = len(d["pk"]), len(d["bk"])
    fn = JS.get_exchange_join(8, 2048, 512)
    rp, br, overflow, _, _ = fn(jnp.asarray(d["pk"]), jnp.asarray(d["p_live"]),
                                jnp.arange(NP, dtype=jnp.int32), jnp.asarray(d["bk"]),
                                jnp.asarray(d["b_live"]), jnp.arange(NB, dtype=jnp.int32))
    assert int(np.asarray(overflow).reshape(-1)[0]) == 0
    rp, br = np.asarray(rp), np.asarray(br)
    keep = rp >= 0
    want = set(zip(rp[keep].tolist(), br[keep].tolist()))
    got = set()
    for res in ranks:
        got |= _pairs(res["join_rp"], res["join_br"])
    assert got == want


def test_duplicate_key_join(ranks, data, single):
    d = data
    got = []
    for res in ranks:
        got += [(int(a), int(b)) for ra, rb in zip(res["dup_pr"], res["dup_br"])
                for a, b in zip(ra, rb)]
    want = sorted((i, int(b)) for i in range(len(d["pk"])) if d["p_live"][i]
                  for b in np.flatnonzero(d["b_live"] & (d["dup_bk"] == d["pk"][i])))
    assert sorted(got) == want
    assert sorted(got) == sorted((int(a), int(b)) for ra, rb in
                                 zip(single["dup_pr"], single["dup_br"])
                                 for a, b in zip(ra, rb))


def test_sharded_sort(ranks, data, single):
    import jax.numpy as jnp

    from duckdb_tpu.parallel import shard as JS

    d = data
    got = np.concatenate([x for res in ranks for x in res["sort"]])
    rows = np.flatnonzero(d["sort_live"])
    want = rows[np.argsort(d["sort_keys"][rows], kind="stable")]
    assert np.array_equal(got, want)
    assert np.array_equal(got, np.concatenate(single["sort"]))
    n = len(d["sort_keys"])
    rr, rl, drop, _ = JS.get_sharded_sort(8, 2048)(
        jnp.asarray(d["sort_keys"])[None], jnp.asarray(d["sort_live"]),
        jnp.arange(n, dtype=jnp.int32))
    assert int(np.asarray(drop).reshape(-1)[0]) == 0
    rr, rl = np.asarray(rr), np.asarray(rl)
    assert np.array_equal(rr[rl & (rr >= 0)], got)


def test_sharded_topn(ranks, data, single):
    d = data
    rows = np.flatnonzero(d["sort_live"])
    want = rows[np.argsort(d["sort_keys"][rows], kind="stable")][:TOPN]
    for res in ranks:  # every rank picks the same global top N
        assert np.array_equal(res["topn"], want)
    assert np.array_equal(single["topn"], want)


def test_sharded_window(ranks, data, single):
    got = {}
    for res in ranks:
        got.update(zip(res["win_rows"].tolist(), res["win_vals"].tolist()))
    want = dict(zip(single["win_rows"].tolist(), single["win_vals"].tolist()))
    assert got == want
    assert sorted(got) == np.flatnonzero(data["w_live"]).tolist()
    # rank within the partition by the order key, peers tied, as SQL's
    d = data
    for i in list(got)[:200]:
        same = d["w_live"] & (d["wg"] == d["wg"][i])
        assert got[i] == 1 + int((same & (d["wo"] < d["wo"][i])).sum())


def test_q1_partial_psum(ranks, data, single):
    d = data
    live = d["q_live"]
    one_minus = d["price"] * (100 - d["disc"])
    vals = [d["qty"], d["price"], one_minus, one_minus * (100 + d["tax"]), d["disc"],
            np.ones_like(d["qty"])]
    want = np.stack([np.bincount(d["gid"][live], weights=None if v is None else v[live],
                                 minlength=8).astype(np.int64) for v in vals])
    for res in ranks:  # the all_reduce gives every rank the global sums
        assert np.array_equal(res["q1"], want)
    assert np.array_equal(single["q1"], want)


def test_process_mesh_refusals():
    with pytest.raises(ValueError, match="backend must be"):
        TS.init_process_mesh("mpi", device="cpu")
    if torch.distributed.is_initialized():
        pytest.skip("a process group exists in this process")
    if not torch.cuda.is_available():  # gloo names no device: the card, and there is none
        try:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                TS.init_process_mesh("gloo", init_method=f"tcp://localhost:{_free_port()}",
                                     world_size=1, rank=0)
        finally:
            if torch.distributed.is_initialized():
                torch.distributed.destroy_process_group()
    if torch.distributed.is_initialized():
        pytest.skip("a process group exists in this process")
    with pytest.raises(RuntimeError, match="init_process_mesh"):
        TS.ProcessMesh(2, "cpu")
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="one card per rank"):
            TS.init_process_mesh("nccl", world_size=2, rank=0)
