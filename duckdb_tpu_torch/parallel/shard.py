"""Multi-device execution: n shards over the visible cards, in one process.

The JAX package (duckdb_tpu/parallel/shard.py) runs shard_map'd programs
over a jax.sharding.Mesh: one Python process drives every device, each
device runs the same program on its shard of the rows, and collectives
(psum, pmin, pmax, all_to_all) combine the shards. That is DuckDB's
morsel parallelism (src/parallel/) with chips for threads: thread-local
partial state becomes a shard's partials, the Combine phase a psum, and
the radix repartitioning of its hash join an all_to_all. The port keeps
the single-controller model and needs no process group:

- a `Mesh` is a list of n torch devices. Shard i is on visible card
  i mod k (k = torch.cuda.device_count()), so with fewer cards than
  shards the cards are shared round-robin (the JAX package runs on one
  chip instead); on the CPU every shard is on the CPU;
- each shard's work is plain torch on its own device. Every shard's work
  is enqueued before anything is read back, and a size the host needs
  (how many rows go to each shard, how many pairs a shard's join makes)
  is read for all shards in one transfer (`host_ints`);
- `psum`, `pmin` and `pmax` bring the small per-shard partials to the
  home device (the connection's) and reduce them there; `all_to_all` is a
  set of peer copies (`Tensor.to(device, non_blocking=True)`);
- exchange buffers are sized exactly: each destination's rows counted by
  one bincount, the rows split by a stable sort on the destination
  (`exchange`). The JAX package's fixed send capacities, its dropped-row
  and demand counters, overflow fallbacks and skew retries exist for
  XLA's static shapes and are not carried over, nor is its rule that a
  block divides into equal shards: torch.tensor_split gives shards within
  one row of each other.

Build-side state that the JAX package replicates (a join's LUT or sorted
keys, its build columns) is copied once to each device; callers that keep
such state cache the copies per device. `COPIED` counts the bytes moved
between two devices.

A `ProcessMesh` spans the processes of one torch.distributed group, the
counterpart of the JAX package's mesh over several jax.distributed
processes (tests/test_multihost.py): each rank holds `local` shards on its
own device (one card per rank under NCCL; the caller's device under gloo),
n = world × local, and rank r's shards are r·local … r·local + local − 1.
The same programs run over it: a rank passes its own rows (with global
row ids) and gets its own part back; what crosses ranks goes through the
group. psum/pmin/pmax become an all_reduce, the sizes an exchange needs
one all_gather of every shard's counts (one host read per step, as
`host_ints` on one process), the exchange an all_to_all_single with
exactly those sizes, and `gather` an all_gather of each rank's rows (the
counterpart of multihost_utils.process_allgather). Under gloo a CUDA
tensor is copied to the host and back around each collective, explicitly;
COPIED["staged"] counts those bytes and COPIED["sent"] the bytes this
rank sent to other ranks. The backend is always the caller's choice.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from duckdb_tpu_torch.ops import sort as S
from duckdb_tpu_torch.ops.hash import hash64, lsr

_I64_MAX = torch.iinfo(torch.int64).max

# bytes copied from one device to another since the last reset; on a
# process mesh, the bytes this rank sent to other ranks and the bytes it
# staged through the host for a gloo collective
COPIED = {"bytes": 0, "sent": 0, "staged": 0}


def _norm(device) -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def visible_devices(home) -> int:
    """The cards the AUTO policy (num_shards = 0) spreads over: every CUDA
    device for a connection on a card, one for the CPU."""
    return torch.cuda.device_count() if _norm(home).type == "cuda" else 1


def to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """t on `device`, counted in COPIED when it moves; a copy between cards
    does not wait for the host."""
    if t.device == device:
        return t
    COPIED["bytes"] += t.numel() * t.element_size()
    return t.to(device, non_blocking=device.type == "cuda")


class Mesh:
    """n shards and the device of each; `home` is where partials combine."""

    def __init__(self, n: int, home):
        self.n = n
        self.home = _norm(home)
        if self.home.type == "cuda":
            k = torch.cuda.device_count()
            self.devices = [torch.device("cuda", i % k) for i in range(n)]
        else:
            self.devices = [self.home] * n
        # more shards than devices: some share one
        self.shared = len(set(self.devices)) < n
        # one process holds every shard
        self.world, self.rank, self.local, self.first = 1, 0, n, 0

    def __repr__(self):
        return f"Mesh({', '.join(f'{i}->{d}' for i, d in enumerate(self.devices))})"


class ProcessMesh:
    """n = world × local shards over the ranks of a torch.distributed
    group; this rank holds shards first … first + local − 1, all on
    `home`. `staged`: collectives copy CUDA tensors through the host (a
    gloo group on a card)."""

    def __init__(self, local: int, device, group=None):
        if not dist.is_initialized():
            raise RuntimeError("ProcessMesh needs torch.distributed's process group: "
                               "call init_process_mesh(backend, ...) first")
        self.group = group if group is not None else dist.group.WORLD
        self.backend = dist.get_backend(self.group)
        self.world = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.local = local
        self.n = self.world * local
        self.first = self.rank * local
        self.home = _norm(device)
        if self.backend == "nccl" and self.home.type != "cuda":
            raise ValueError("an NCCL process mesh needs a CUDA device per rank")
        self.devices = [self.home] * local
        self.shared = local > 1
        self.staged = self.backend == "gloo" and self.home.type == "cuda"

    def __repr__(self):
        return (f"ProcessMesh({self.backend}, rank {self.rank}/{self.world}, shards "
                f"{self.first}..{self.first + self.local - 1} on {self.home})")


def init_process_mesh(backend: str, local: int = 1, *, init_method: Optional[str] = None,
                      world_size: Optional[int] = None, rank: Optional[int] = None,
                      device=None) -> ProcessMesh:
    """Join (or start) the default process group with the caller's backend
    and make this rank's ProcessMesh. NCCL gives each rank its own card,
    cuda:rank, and two ranks on one card are refused here (NCCL itself
    refuses them at the first collective). Gloo runs on `device`, by
    default a card: cuda:(rank mod the visible cards), so ranks beyond the
    cards share them; without CUDA the caller must name `device="cpu"`."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', not {backend!r}")
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise ValueError(f"the process group's backend is {dist.get_backend()}, "
                             f"not {backend}")
        world_size, rank = dist.get_world_size(), dist.get_rank()
    if backend == "nccl":
        cards = torch.cuda.device_count()
        if world_size is None or rank is None:
            raise ValueError("an NCCL process mesh needs world_size and rank")
        if world_size > cards:
            raise ValueError(f"NCCL needs one card per rank: {world_size} ranks, {cards} "
                             f"visible card(s); use gloo to share a card")
        device = torch.device("cuda", rank) if device is None else device
        torch.cuda.set_device(device)
    elif device is None and not torch.cuda.is_available():
        raise RuntimeError("init_process_mesh runs on a CUDA device by default and none "
                           "is visible; pass device='cpu' to run on the host")
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                                rank=rank)
    if device is None:
        device = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    return ProcessMesh(local, device)


# -- the wire of a process mesh ------------------------------------------------------
_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}


def _wire(mesh: ProcessMesh, t: torch.Tensor) -> torch.Tensor:
    """t as the group's collective takes it: contiguous, bool as uint8, on
    the host under a staged (gloo on a card) mesh."""
    t = t.contiguous()
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    if mesh.staged and t.is_cuda:
        COPIED["staged"] += t.numel() * t.element_size()
        t = t.cpu()
    return t


def _unwire(mesh: ProcessMesh, t: torch.Tensor, dtype) -> torch.Tensor:
    if t.device != mesh.home:
        COPIED["staged"] += t.numel() * t.element_size()
        t = t.to(mesh.home)
    return t.to(dtype) if t.dtype != dtype else t


def _all_reduce(mesh: ProcessMesh, t: torch.Tensor, op: str) -> torch.Tensor:
    w = _wire(mesh, t).clone()
    COPIED["sent"] += w.numel() * w.element_size()
    dist.all_reduce(w, op=_OPS[op], group=mesh.group)
    return _unwire(mesh, w, t.dtype)


def _all_gather_equal(mesh: ProcessMesh, t: torch.Tensor) -> List[torch.Tensor]:
    """Every rank's t (all of one shape), in rank order, on home."""
    w = _wire(mesh, t)
    out = [torch.empty_like(w) for _ in range(mesh.world)]
    COPIED["sent"] += w.numel() * w.element_size() * (mesh.world - 1)
    dist.all_gather(out, w, group=mesh.group)
    return [_unwire(mesh, o, t.dtype) for o in out]


_MESHES = {}


def mesh_for(n: int, home) -> Mesh:
    key = (n, _norm(home))
    if key not in _MESHES:
        _MESHES[key] = Mesh(n, home)
    return _MESHES[key]


# -- placement and collectives ---------------------------------------------------
def split_rows(mesh: Mesh, x: torch.Tensor) -> List[torch.Tensor]:
    """x's rows (on a process mesh, this rank's) cut into this process's
    shards, contiguous, each on its shard's device."""
    return [to(p, d) for p, d in zip(torch.tensor_split(x, mesh.local), mesh.devices)]


def replicate(mesh: Mesh, t: torch.Tensor) -> List[torch.Tensor]:
    """t on every shard's device, one copy per distinct device."""
    copies = {}
    return [copies.setdefault(d, to(t, d)) for d in mesh.devices]


def gather_local(mesh: Mesh, parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """This process's shards' tensors concatenated in shard order on the
    home device (on one process: every shard's)."""
    return torch.cat([to(p, mesh.home) for p in parts])


def gather(mesh: Mesh, parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Every shard's tensors concatenated in shard order on the home
    device (rows on dim 0); across ranks an all_gather, its sizes read in
    one host read."""
    mine = gather_local(mesh, parts)
    if mesh.world == 1:
        return mine
    sizes = [r[0] for r in all_host_ints(mesh, [torch.tensor([mine.shape[0]])])]
    pad = max(sizes)
    if mine.shape[0] < pad:
        mine = torch.cat([mine, mine.new_zeros((pad - mine.shape[0],) + mine.shape[1:])])
    got = _all_gather_equal(mesh, mine)
    return torch.cat([g[:k] for g, k in zip(got, sizes)])


def _reduce(mesh: Mesh, parts, op, name: str) -> torch.Tensor:
    out = op(torch.stack([to(p, mesh.home) for p in parts]), 0)
    return out if mesh.world == 1 else _all_reduce(mesh, out, name)


def psum(mesh: Mesh, parts) -> torch.Tensor:
    return _reduce(mesh, parts, torch.sum, "sum")


def pmin(mesh: Mesh, parts) -> torch.Tensor:
    return _reduce(mesh, parts, torch.amin, "min")


def pmax(mesh: Mesh, parts) -> torch.Tensor:
    return _reduce(mesh, parts, torch.amax, "max")


def _split_flat(flat: list, parts) -> List[list]:
    out, at = [], 0
    for p in parts:
        out.append(flat[at:at + p.numel()])
        at += p.numel()
    return out


def host_ints(mesh: Mesh, parts: Sequence[torch.Tensor]) -> List[list]:
    """Small integer tensors of this process's shards read to the host in
    one transfer (one sync for all shards) → a list per part."""
    if not parts:
        return []
    flat = torch.cat([to(p.reshape(-1).to(torch.int64), mesh.home) for p in parts])
    return _split_flat(flat.tolist(), parts)


def all_host_ints(mesh: Mesh, parts: Sequence[torch.Tensor]) -> List[list]:
    """host_ints of every rank's parts, in rank order (each rank passes
    parts of the same shapes): one all_gather, then one host read. On one
    process, host_ints."""
    if mesh.world == 1 or not parts:
        return host_ints(mesh, parts)
    flat = torch.cat([to(p.reshape(-1).to(torch.int64), mesh.home) for p in parts])
    got = torch.cat(_all_gather_equal(mesh, flat)).tolist()
    return _split_flat(got, list(parts) * mesh.world)


def all_to_all(mesh: Mesh, send: Sequence[Sequence[torch.Tensor]],
               sizes: Optional[List[list]] = None) -> List[torch.Tensor]:
    """send[i][j]: what this process's shard i sends global shard j → for
    each of this process's shards, what it received, sources in global
    shard order. On a process mesh `sizes[s][j]`, the rows global shard s
    sends global shard j, sizes the receive buffers exactly."""
    if mesh.world == 1:
        return [torch.cat([to(send[i][j], d) for i in range(mesh.local)])
                for j, d in enumerate(mesh.devices)]
    k, w = mesh.local, mesh.world
    ref = send[0][0]
    # to rank r: for each of its shards, what each of this rank's shards sends it
    pieces = [send[i][r * k + jl] for r in range(w) for jl in range(k) for i in range(k)]
    inp = torch.cat([to(p, mesh.home) for p in pieces])
    in_splits = [sum(send[i][r * k + jl].shape[0] for jl in range(k) for i in range(k))
                 for r in range(w)]
    # from rank s: for each of this rank's shards, what each of s's shards sent it
    recv_sizes = [[sizes[s * k + i][mesh.first + jl] for i in range(k)] for s in range(w)
                  for jl in range(k)]
    out_splits = [sum(sum(recv_sizes[s * k + jl]) for jl in range(k)) for s in range(w)]
    wire_in = _wire(mesh, inp)
    wire_out = torch.empty((sum(out_splits),) + tuple(ref.shape[1:]), dtype=wire_in.dtype,
                           device=wire_in.device)
    COPIED["sent"] += (sum(in_splits) - in_splits[mesh.rank]) * max(1, inp[:1].numel()) \
        * wire_in.element_size()
    dist.all_to_all_single(wire_out, wire_in, out_splits, in_splits, group=mesh.group)
    got = _unwire(mesh, wire_out, ref.dtype)
    flat = torch.split(got, [x for row in recv_sizes for x in row])
    # flat is ordered (source rank, this rank's shard, source shard)
    return [torch.cat([flat[(s * k + jl) * k + i] for s in range(w) for i in range(k)])
            for jl in range(k)]


def exchange(mesh: Mesh, sides):
    """Repartition rows by destination, buffers sized exactly.

    sides: [(dests, payloads)] where dests[i] is shard i's int64
    destination per row (mesh.n for a row that goes nowhere) and
    payloads[i] a list of its per-row tensors. Each shard counts its rows
    per destination with one bincount; the counts of every side and shard
    reach the host in one transfer; each shard's rows are ordered by a
    stable sort on the destination and split by those counts. → per side,
    for each shard j, the list of payloads it received: each source's rows
    in row order, sources in shard order. On a process mesh the shards
    are this rank's, the destinations global, and the counts of every
    rank's shards reach every rank in one all_gather (all_host_ints)."""
    n, k = mesh.n, mesh.local
    counts, orders = [], []
    for dests, _ in sides:
        for d in dests:
            counts.append(torch.bincount(d, minlength=n + 1)[:n])
            orders.append(torch.sort(d, stable=True).indices)
    every = all_host_ints(mesh, counts)  # rank-major: each rank's counts, side-major
    per_rank = len(counts)
    sizes = every[mesh.rank * per_rank:(mesh.rank + 1) * per_rank]
    out, at = [], 0
    for dests, payloads in sides:
        send = []  # send[i][payload] = pieces by destination
        for i, pays in enumerate(payloads):
            sz = sizes[at + i]
            order = orders[at + i][:sum(sz)]
            send.append([torch.split(x[order], sz) for x in pays])
        # sent[s][j]: the rows global shard s sends global shard j on this side
        sent = [every[r * per_rank + at + i] for r in range(mesh.world) for i in range(k)]
        at += len(dests)
        n_pay = len(payloads[0]) if payloads else 0
        recv = [all_to_all(mesh, [[send[i][p][j] for j in range(n)] for i in range(k)], sent)
                for p in range(n_pay)]
        out.append([[recv[p][j] for p in range(n_pay)] for j in range(k)])
    return out


# -- Q1's partial aggregate -----------------------------------------------------------
def q1_partial_inputs(qty, price, disc, tax, gid, live, num_groups: int):
    """The grouped sum's inputs of one shard's Q1 partial → (slot ids, the
    six vectors). Dead rows take the id num_groups, outside the slots."""
    g = torch.where(live, gid.to(torch.int64), num_groups)
    one_minus_disc = price * (100 - disc)  # scaled-int decimal arithmetic
    charge = one_minus_disc * (100 + tax)
    vecs = [torch.where(live, v, 0) for v in (qty, price, one_minus_disc, charge, disc)]
    return g, vecs + [live.to(torch.int64)]


def q1_local_partial(qty, price, disc, tax, gid, live, num_groups: int):
    """One shard's Q1 partial aggregate: the six per-group int64 sums of the
    JAX package's q1_local_partial, in one grouped-sum call (K = 6, nseg =
    num_groups; on the card the hand-written kernel on this shard's
    device)."""
    from duckdb_tpu_torch.ops.grouped_sum import grouped_sum_i64

    g, vecs = q1_partial_inputs(qty, price, disc, tax, gid, live, num_groups)
    return tuple(grouped_sum_i64(g, vecs, num_groups))


def make_sharded_q1(mesh: Mesh, num_groups: int):
    """Q1's aggregation over the mesh: row-sharded inputs, each shard's
    partial sums, psum'd on the home device."""

    def step(qty, price, disc, tax, gid, live):
        parts = [split_rows(mesh, x) for x in (qty, price, disc, tax, gid, live)]
        partials = [q1_local_partial(*(p[i] for p in parts), num_groups)
                    for i in range(mesh.local)]
        return tuple(psum(mesh, [p[j] for p in partials]) for j in range(6))

    return step


# -- joins ---------------------------------------------------------------------------
def make_sharded_join_probe(mesh: Mesh):
    """Replicated-build, sharded-probe equi-join counts: each shard
    binary-searches its probe rows in its copy of the sorted build keys.
    → (counts int32, lo int32) in probe row order on the home device (on a
    process mesh, for this rank's probe rows)."""

    def probe(sorted_build_keys, probe_keys, probe_live):
        builds = replicate(mesh, sorted_build_keys)
        counts, los = [], []
        for sk, k, live in zip(builds, split_rows(mesh, probe_keys), split_rows(mesh, probe_live)):
            k = torch.where(live, k, _I64_MAX - 1)
            lo = torch.searchsorted(sk, k)
            hi = torch.searchsorted(sk, k, right=True)
            counts.append(torch.where(live, hi - lo, 0).to(torch.int32))
            los.append(lo.to(torch.int32))
        return gather_local(mesh, counts), gather_local(mesh, los)

    return probe


def _hash_dest(keys: torch.Tensor, n: int) -> torch.Tensor:
    """The shard that owns a join key: splitmix64's finalizer in uint64
    (ops/hash.hash64, int64 bits), then its unsigned remainder by n,
    taken as (2·(h >>> 1) + (h & 1)) mod n so that no value is negative.
    Both sides of a join agree, and so does the JAX package."""
    h = hash64(keys)
    return ((lsr(h, 1) % n) * 2 + (h & 1)) % n


def _route(keys, live, n: int):
    """Each shard's destination per row: its key's owner, n for a dead row."""
    return [torch.where(lv, _hash_dest(k, n), n) for k, lv in zip(keys, live)]


class ExchangeJoin(NamedTuple):
    """Per shard, on its device: rp the probe rows it received (global row
    ids), br the build row each matched (-1: none)."""

    rp: List[torch.Tensor]
    br: List[torch.Tensor]


class ExchangeJoinDup(NamedTuple):
    """Per shard: pr/br its matched (probe row, build row) pairs; prr the
    probe rows it received and pm whether each matched at least once."""

    pr: List[torch.Tensor]
    br: List[torch.Tensor]
    pm: List[torch.Tensor]
    prr: List[torch.Tensor]


def _exchange_sides(mesh, pk, p_live, p_rows, bk, b_live, b_rows):
    n = mesh.n
    pks, bks = split_rows(mesh, pk), split_rows(mesh, bk)
    p_lives, b_lives = split_rows(mesh, p_live), split_rows(mesh, b_live)
    prs, brs = split_rows(mesh, p_rows), split_rows(mesh, b_rows)
    return exchange(mesh, [
        (_route(pks, p_lives, n), [[k, r] for k, r in zip(pks, prs)]),
        (_route(bks, b_lives, n), [[k, r] for k, r in zip(bks, brs)])])


def make_exchange_join(mesh: Mesh):
    """Hash-repartition probe and build rows over the mesh, then join each
    shard's partition locally (unique build keys: one sorted lookup per
    probe row). DuckDB's radix-partitioned hash join
    (src/execution/radix_partitioned_hashtable.cpp) with shards for
    partitions. Inputs are global (on a process mesh, this rank's rows
    with global row ids): packed keys, live masks and row ids of both
    sides."""

    def step(pk, p_live, p_rows, bk, b_live, b_rows) -> ExchangeJoin:
        recv_p, recv_b = _exchange_sides(mesh, pk, p_live, p_rows, bk, b_live, b_rows)
        rp, br = [], []
        for (rk, rr), (bkj, brj) in zip(recv_p, recv_b):
            if bkj.numel() == 0:
                brow = torch.full_like(rr, -1)
            else:
                sk, sperm = torch.sort(bkj)
                loc = torch.searchsorted(sk, rk).clamp(max=sk.shape[0] - 1)
                brow = torch.where(sk[loc] == rk, brj[sperm][loc], -1)
            rp.append(rr)
            br.append(brow)
        return ExchangeJoin(rp, br)

    return step


def make_exchange_join_dup(mesh: Mesh):
    """The exchange join for duplicate build keys: after the same
    repartitioning each shard probes a sorted build for its key range
    [lo, hi) and expands the pairs. The pair counts of every shard are
    read in one transfer, so each expansion is sized exactly."""

    def step(pk, p_live, p_rows, bk, b_live, b_rows) -> ExchangeJoinDup:
        recv_p, recv_b = _exchange_sides(mesh, pk, p_live, p_rows, bk, b_live, b_rows)
        probes = []
        for (rk, rr), (bkj, brj) in zip(recv_p, recv_b):
            sk, sperm = torch.sort(bkj)
            lo = torch.searchsorted(sk, rk)
            counts = torch.searchsorted(sk, rk, right=True) - lo
            probes.append((rr, brj[sperm], lo, counts))
        totals = host_ints(mesh, [c.sum() for _, _, _, c in probes])
        pr, br, pm, prr = [], [], [], []
        for (rr, srows, lo, counts), (total,) in zip(probes, totals):
            slot = torch.repeat_interleave(torch.arange(rr.shape[0], device=rr.device), counts,
                                           output_size=total)
            k = torch.arange(total, device=rr.device) - (torch.cumsum(counts, 0) - counts)[slot]
            pr.append(rr[slot])
            br.append(srows[lo[slot] + k])
            pm.append(counts > 0)
            prr.append(rr)
        return ExchangeJoinDup(pr, br, pm, prr)

    return step


# -- ORDER BY and TopN ---------------------------------------------------------------
SAMPLES = 64  # splitter samples per shard


def make_sharded_sort(mesh: Mesh, nkeys: int):
    """ORDER BY over the mesh: sample-based range partitioning and a local
    sort. Each shard samples its primary keys at SAMPLES quantiles; the
    n - 1 splitters are quantiles of all samples; every live row goes to
    the shard of its primary key's range (rows of one primary key to one
    shard) and each shard sorts what it received by all keys and then the
    global row id. DuckDB merges per-thread sorted runs instead
    (src/common/sort/sorted_run_merger.cpp). → per shard, row ids in
    global order (shard-major): the single-device stable sort, exactly.
    On a process mesh the samples are gathered from every rank, so every
    rank cuts at the same splitters, and a rank gets its own shards' row
    ids.

    keys: (nkeys, rows) normalized int64 (ops/sort.orderable_int64)."""
    n = mesh.n

    def step(keys, live, rows) -> List[torch.Tensor]:
        key_parts = [split_rows(mesh, keys[i]) for i in range(nkeys)]
        lives, row_parts = split_rows(mesh, live), split_rows(mesh, rows)
        primary = [torch.where(lv, k, _I64_MAX) for k, lv in zip(key_parts[0], lives)]
        samples = []
        for k, lv in zip(primary, lives):
            if k.numel() == 0:
                samples.append(torch.full((SAMPLES,), _I64_MAX, dtype=torch.int64,
                                          device=k.device))
                continue
            ks = torch.sort(k).values
            n_live = lv.sum()
            pos = ((torch.arange(SAMPLES, device=k.device) * n_live) // SAMPLES).clamp(
                0, k.shape[0] - 1)
            samples.append(torch.where(n_live > 0, ks[pos], _I64_MAX))
        ss = torch.sort(gather(mesh, samples)).values
        spl = ss[((torch.arange(1, n, device=ss.device) * (n * SAMPLES)) // n).clamp(
            0, n * SAMPLES - 1)]
        dests = [torch.where(lv, torch.searchsorted(s, k, right=True), n)
                 for s, k, lv in zip(replicate(mesh, spl), primary, lives)]
        payloads = [[kp[i] for kp in key_parts] + [row_parts[i]] for i in range(mesh.local)]
        (recv,) = exchange(mesh, [(dests, payloads)])
        out = []
        for parts in recv:
            perm = S.sort_permutation(parts, torch.ones(parts[-1].shape[0], dtype=torch.bool,
                                                        device=parts[-1].device))
            out.append(parts[-1][perm])
        return out

    return step


class TopNCandidates(NamedTuple):
    """Every shard's first k rows by the keys, concatenated in shard order
    on the home device: keys (nkeys, n·k), row ids and their live flags."""

    keys: torch.Tensor
    rows: torch.Tensor
    live: torch.Tensor


def make_sharded_topn(mesh: Mesh, k: int, nkeys: int):
    """Per-shard top k, gathered to the home device, where the caller makes
    the final small sort (DuckDB's per-thread heaps merged at the sink,
    physical_top_n.cpp). Dead rows sort last and are flagged dead. On a
    process mesh every rank gets every rank's candidates."""

    def step(keys, live, rows) -> TopNCandidates:
        key_parts = [split_rows(mesh, keys[i]) for i in range(nkeys)]
        lives, row_parts = split_rows(mesh, live), split_rows(mesh, rows)
        ck, cr, cl = [], [], []
        for i, (lv, r) in enumerate(zip(lives, row_parts)):
            ks = [kp[i] for kp in key_parts]
            perm = S.sort_permutation(ks, lv)[:k]
            ck.append(torch.stack([x[perm] for x in ks]))
            cr.append(r[perm])
            cl.append(lv[perm])
        keys_t = gather(mesh, [c.t() for c in ck]).t()  # every rank's candidates
        return TopNCandidates(keys_t, gather(mesh, cr), gather(mesh, cl))

    return step


# -- windows -------------------------------------------------------------------------
class WindowOut(NamedTuple):
    """On the home device: the live rows' global ids and, per row, the
    window's value and its validity (on a process mesh, the rows this
    rank's shards received)."""

    rows: torch.Tensor
    values: torch.Tensor
    valid: torch.Tensor


def make_sharded_window(mesh: Mesh, n_pkeys: int, orders: Sequence[int], windows):
    """Windows over one PARTITION BY, in one exchange: each live row goes to
    the owner of its first partition key (rows of a partition to one shard,
    DuckDB's hashed sort, src/common/sort/hashed_sort.cpp); each shard sorts
    what it received once per ORDER BY and computes every window there with
    the single-device code (execution/window_exec), so every value is the
    single-device one. A whole-partition aggregate is over the partition,
    not over the shard (the JAX package's program sums to the end of the
    shard: ROADMAP W5).

    orders: the number of keys of each distinct ORDER BY (0: none).
    windows: (kind, index into orders) per window; kind is row_number |
    rank | dense_rank | count | sum | avg | min | max, over the whole
    partition, or running to the last peer when its ORDER BY has keys.
    step(pk, live, rows, pkeys, okeys, args): the routing key (the first
    normalized partition key), live, global row ids, the normalized
    partition keys, each ORDER BY's normalized keys, and per window
    (argument, its validity, scale): the raw values or None (count(*)),
    the validity or None (all valid), and the divisor of an avg of a
    DECIMAL's scaled integers. → a WindowOut per window."""
    from duckdb_tpu_torch.execution import window_exec as WX

    n = mesh.n

    def step(pk, live, rows, pkeys, okeys, args) -> List[WindowOut]:
        lives = split_rows(mesh, live)
        dests = _route(split_rows(mesh, pk), lives, n)
        sent = [rows, *pkeys, *(k for ks in okeys for k in ks),
                *(x for a, v, _ in args for x in (a, v) if x is not None)]
        parts = [split_rows(mesh, x) for x in sent]
        (recv,) = exchange(mesh, [(dests, [[p[i] for p in parts]
                                           for i in range(mesh.local)])])
        out_rows = [[] for _ in orders]
        outs = [([], []) for _ in windows]
        for got in recv:
            it = iter(got)
            r = next(it)
            pks = [next(it) for _ in range(n_pkeys)]
            oks = [[next(it) for _ in range(m)] for m in orders]
            ones = torch.ones(r.shape[0], dtype=torch.bool, device=r.device)
            ods = [WX.order_from_keys(pks, ks, ones) for ks in oks]
            for od, o_rows in zip(ods, out_rows):
                o_rows.append(r[od.perm])
            for (kind, o), (a, v, scale), (o_vals, o_valid) in zip(windows, args, outs):
                a = torch.zeros_like(r) if a is None else next(it)
                v = ones if v is None else next(it)
                od = ods[o]
                vals, valid = WX.keyed_window_values(kind, od, a[od.perm], v[od.perm], scale)
                o_vals.append(vals)
                o_valid.append(ones if valid is None else valid)
        rows_by_order = [gather_local(mesh, r) for r in out_rows]
        return [WindowOut(rows_by_order[o], gather_local(mesh, vals),
                          gather_local(mesh, valid))
                for (_, o), (vals, valid) in zip(windows, outs)]

    return step
