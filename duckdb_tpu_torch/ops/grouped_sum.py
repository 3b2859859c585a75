"""Exact int64 grouped sums: a hand-written CUDA kernel and its plain version.

Replaces the Pallas kernel `duckdb_tpu/ops/pallas_agg.py:grouped_sum_i64`
(body `_kernel`), which computes the same sums with 8-bit limbs on the TPU's
matrix unit because the v5e has no 64-bit datapath. On Hopper int64 adds
are native, so the kernel (`csrc/grouped_sum.cu`) adds the values into
per-slot tables in shared memory. Wrapping unsigned adds are associative,
so the sums are bit-identical to a sequential int64 sum in any order.

What bounds it on the H100: memory. It reads every slot id (int32 or int64,
taken as they come) once and the K int64 values of live rows once; at 3.35
TB/s that is the least time. A value that only dead rows use is not read.
`launch_plan` picks one of three regimes from n, nseg and K, and every call
of the kernel is one launch that writes its whole output (`torch.empty`, no
fill):

- small (nseg <= SMALL_MAX_NSEG): each warp keeps a lane-private table of
  G vectors, so the row loop has no atomics and no bank conflicts; the
  grid's y dimension walks K in groups of G;
- single (the small regime's domains, n <= SINGLE_MAX_ROWS): the same
  tables in one block per group of G vectors, which stores its cells once:
  nothing to zero, no atomics;
- large: one table per block, shared atomics, with the lanes of a warp
  that share a slot summed first (`__match_any_sync` and a shuffle tree);
  each 64-bit add is two native 32-bit atomics with a carry, because the
  64-bit shared atomicAdd is a compare-and-swap loop on this card.

The small and large regimes run a persistent grid whose block 0 zeroes the
output and raises a flag that the other blocks wait for only before they
flush their tables with global atomics. Neither the tensor cores nor
Triton are used: the work is one int64 add per value, and the lane-private
tables and warp intrinsics need per-lane addressing of shared memory that
Triton does not give.

The kernel is built from the repository's source with nvcc at first use
into build/torch_kernels/ and loaded with ctypes. The wrapper takes the
plain version only for tensors on the CPU; for CUDA tensors it launches the
kernel or raises. It takes int32 and int64 ids and any contiguous view
whose pointers are aligned to their elements, with no conversion or copy.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import threading
from typing import List, NamedTuple, Optional, Sequence

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "grouped_sum.cu")
LIBRARY = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels",
                       "libgrouped_sum.so")

MAX_K = 24  # vector pointers one launch takes (csrc: GS_MAX_K)
WARPS = 8  # warps per block (csrc: GS_WARPS)
SMEM_BLOCK_MAX = 232_448  # shared bytes one block may opt into (csrc: GS_SMEM_MAX)
SMEM_SM = 233_472  # shared bytes of one SM
SMEM_BLOCK_RESERVED = 1_024  # shared bytes the runtime keeps for each block
GROUPS = (4, 2, 1)  # vectors per lane-private table (csrc: launch_small<G>)
# one slot row of one vector across a block's lane-private tables
_SMALL_ROW_BYTES = WARPS * 32 * 8
# the small regime holds two blocks on an SM even with one vector per table
SMALL_MAX_NSEG = (SMEM_SM // 2 - SMEM_BLOCK_RESERVED) // _SMALL_ROW_BYTES - 1
MAX_NSEG = SMEM_BLOCK_MAX // 8  # one vector's (nseg, 1) table in the large regime
# the single regime: inputs of at most SINGLE_MAX_ROWS rows (a tile of 128
# rows for each of a block's 8 warps) over at most SMALL_MAX_NSEG slots,
# where one block per group of vectors beat the persistent grid on an H100
# (tools/grouped_sum_shapes.py --crossover)
SINGLE_MAX_ROWS = 1_024
_REGIME_CODE = {"large": 0, "small": 1, "single": 2}


class LaunchPlan(NamedTuple):
    regime: str  # "single", "small" (lane-private tables) or "large" (shared atomics)
    vectors: int  # vectors one launch sums
    group: int  # vectors per lane-private table (small, single); 0 for large
    smem: int  # dynamic shared bytes per block


_lock = threading.Lock()
_lib = None
build_log = ""  # nvcc's -Xptxas -v report of the last build


def build(force: bool = False) -> ctypes.CDLL:
    """Compile csrc/grouped_sum.cu (unless an up-to-date build exists) and
    load it. Raises with nvcc's output if the build fails."""
    global _lib, build_log
    with _lock:
        if _lib is not None and not force:
            return _lib
        fresh = (os.path.exists(LIBRARY)
                 and os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE))
        if force or not fresh:
            nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
            os.makedirs(os.path.dirname(LIBRARY), exist_ok=True)
            tmp = f"{LIBRARY}.{os.getpid()}.tmp"
            cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                   "-Xptxas", "-v", "-o", tmp, SOURCE]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed to build {SOURCE}:\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, LIBRARY)
            build_log = proc.stdout + proc.stderr
        lib = ctypes.CDLL(LIBRARY)
        lib.grouped_sum_i64.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
        lib.grouped_sum_i64.restype = ctypes.c_int
        _lib = lib
        return lib


@functools.lru_cache(maxsize=4096)
def launch_plan(nseg: int, k: int, n: Optional[int] = None) -> LaunchPlan:
    """How the kernel sums the first of k vectors of n rows over nseg slots.

    Small domains take the lane-private tables: (nseg + 1) rows (one spare
    for dead ids) of G vectors × 32 lanes × 8 warps, with the largest G of
    GROUPS, at most k, that still lets two blocks share an SM; inputs of at
    most SINGLE_MAX_ROWS rows run them in one block per group of G, larger
    inputs (or n None) on a persistent grid. Larger domains take one
    (nseg, K | 1) table per block, with as many vectors as fit one block's
    shared memory. A launch takes up to MAX_K vectors; the wrapper plans the
    rest anew.
    """
    if not 1 <= nseg <= MAX_NSEG:
        raise ValueError(f"grouped_sum_i64: nseg {nseg} outside [1, {MAX_NSEG}]")
    per = min(k, MAX_K)
    if nseg <= SMALL_MAX_NSEG:
        regime = "single" if n is not None and n <= SINGLE_MAX_ROWS else "small"
        for group in GROUPS:
            smem = _SMALL_ROW_BYTES * (nseg + 1) * group
            if group <= per and 2 * (smem + SMEM_BLOCK_RESERVED) <= SMEM_SM:
                return LaunchPlan(regime, per, group, smem)
    while nseg * (per | 1) * 8 > SMEM_BLOCK_MAX:
        per -= 1
    return LaunchPlan("large", per, 0, nseg * (per | 1) * 8)


def grouped_sum_i64_plain(dense: torch.Tensor, vectors: Sequence[torch.Tensor],
                          nseg: int) -> List[torch.Tensor]:
    """Plain PyTorch version: index_add_ into an overflow slot for dead rows."""
    d = dense.to(torch.int64)
    d = torch.where((d < 0) | (d >= nseg), nseg, d)
    mat = torch.stack(list(vectors), dim=1)
    out = torch.zeros((nseg + 1, len(vectors)), dtype=torch.int64,
                      device=dense.device)
    out.index_add_(0, d, mat)
    return [out[:nseg, j] for j in range(len(vectors))]


def _launch(lib, plan: LaunchPlan, dense: torch.Tensor, vecs: Sequence[torch.Tensor],
            nseg: int, out: torch.Tensor, stream: int) -> None:
    """One launch of the kernel by `plan` over contiguous `dense` (int32 or
    int64) and `vecs` into `out` (nseg, len(vecs)); raises on a refused
    launch."""
    ptrs = (ctypes.c_void_p * len(vecs))(*[v.data_ptr() for v in vecs])
    narrow = ctypes.c_int(0)
    err = lib.grouped_sum_i64(
        dense.data_ptr(), dense.element_size(), ptrs, dense.shape[0], len(vecs), nseg,
        out.data_ptr(), _REGIME_CODE[plan.regime], plan.group, dense.device.index, stream,
        ctypes.byref(narrow))
    if err != 0:
        raise RuntimeError(f"grouped_sum_i64 kernel launch failed: CUDA error {err}")
    grouped_sum_i64.launches += 1
    grouped_sum_i64.regime_launches[plan.regime] = \
        grouped_sum_i64.regime_launches.get(plan.regime, 0) + 1
    grouped_sum_i64.narrow_launches += narrow.value


def grouped_sum_i64(dense: torch.Tensor, vectors: Sequence[torch.Tensor],
                    nseg: int) -> List[torch.Tensor]:
    """Exact per-slot int64 sums of K pre-masked vectors.

    dense: (N,) integer slot ids; rows with an id outside [0, nseg) are dead
    and add nothing, whatever their vector entries hold (ops.grouped also
    masks them to 0). vectors: K tensors (N,) int64 on dense's device.
    Returns K tensors (nseg,) int64; sums wrap mod 2^64 like the
    reference's.
    """
    if not vectors:
        return []
    n = dense.shape[0]
    for v in vectors:
        if v.dtype != torch.int64 or v.shape != (n,) or v.device != dense.device:
            raise ValueError(
                "grouped_sum_i64: every vector must be int64 of the ids' "
                f"length and device, got {v.dtype} {tuple(v.shape)} on {v.device}")
    if dense.device.type == "cpu":
        return grouped_sum_i64_plain(dense, vectors, nseg)
    if dense.device.type != "cuda":
        raise ValueError(f"grouped_sum_i64: unsupported device {dense.device}")
    lib = build()
    if dense.dtype not in (torch.int32, torch.int64):
        dense = dense.to(torch.int64)  # narrower or unsigned ids: the kernel reads 4 or 8 bytes
    dense = dense.contiguous()
    vecs = [v.contiguous() for v in vectors]
    results = []
    with torch.cuda.device(dense.device):
        stream = torch.cuda.current_stream().cuda_stream
        start = 0
        while start < len(vecs):
            p = launch_plan(nseg, len(vecs) - start, n)
            chunk = vecs[start:start + p.vectors]
            start += len(chunk)
            out = torch.empty((nseg, len(chunk)), dtype=torch.int64, device=dense.device)
            _launch(lib, p, dense, chunk, nseg, out, stream)
            results.extend(out.unbind(1))
    return results


grouped_sum_i64.launches = 0  # kernel launches since the last reset
# the same, by regime
grouped_sum_i64.regime_launches = {"single": 0, "small": 0, "large": 0}
# launches whose lane-private tables loaded 8 bytes at a time (no row put
# the ids and every vector on a 16-byte boundary)
grouped_sum_i64.narrow_launches = 0
