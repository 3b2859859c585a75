"""Exact int64 grouped sums: a hand-written CUDA kernel and its plain version.

Replaces the Pallas kernel `duckdb_tpu/ops/pallas_agg.py:grouped_sum_i64`
(body `_kernel`), which computes the same sums with 8-bit limbs on the TPU's
matrix unit because the v5e has no 64-bit datapath. On Hopper int64 adds
are native, so the kernel (`csrc/grouped_sum.cu`) keeps an (nseg, K) table
of sums in each block's shared memory (rows padded to an odd word count
so that slots fall on different banks), adds every live row into it with
shared-memory atomics and flushes each block's table with global atomics.
Wrapping unsigned adds are associative, so the sums are bit-identical to a
sequential int64 sum in any order.

What bounds it on the H100: memory. It reads N x (4 + 8K) bytes (int32 slot
ids plus K int64 vectors) once; at 3.35 TB/s that is the least time. Few
live slots make the lanes of a warp collide on a handful of shared
addresses, which serialises the atomics; making that fast is later work.

The kernel is built from the repository's source with nvcc at first use
into build/torch_kernels/ and loaded with ctypes. The wrapper takes the
plain version only for tensors on the CPU; for CUDA tensors it launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import List, Sequence

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "grouped_sum.cu")
LIBRARY = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels",
                       "libgrouped_sum.so")

MAX_K = 24  # vector pointers one launch takes (csrc: GS_MAX_K)
MAX_CELLS = 6144  # nseg·(K | 1) words in 48 KiB of shared memory
THREADS = 256  # csrc: GS_THREADS
BLOCKS_PER_SM = 8

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
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        lib.grouped_sum_i64.restype = ctypes.c_int
        _lib = lib
        return lib


def vectors_per_launch(nseg: int) -> int:
    """Most vectors one launch sums: its shared table holds nseg rows of
    (K | 1) words."""
    per = min(MAX_K, MAX_CELLS // nseg)
    return per - 1 if nseg * (per | 1) > MAX_CELLS else per


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


def grouped_sum_i64(dense: torch.Tensor, vectors: Sequence[torch.Tensor],
                    nseg: int) -> List[torch.Tensor]:
    """Exact per-slot int64 sums of K pre-masked vectors.

    dense: (N,) integer slot ids; rows with an id outside [0, nseg) are dead
    (their vector entries must already hold 0, as ops.grouped guarantees).
    vectors: K tensors (N,) int64 on dense's device. Returns K tensors
    (nseg,) int64; sums wrap mod 2^64 like the reference's.
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
    if not 1 <= nseg <= MAX_CELLS:
        raise ValueError(f"grouped_sum_i64: nseg {nseg} outside [1, {MAX_CELLS}]")
    lib = build()
    if dense.dtype != torch.int32:
        dense = dense.clamp(-1, nseg).to(torch.int32)
    dense = dense.contiguous()
    vecs = [v.contiguous() for v in vectors]
    per = vectors_per_launch(nseg)
    props = torch.cuda.get_device_properties(dense.device)
    grid = max(1, min(-(-n // THREADS), props.multi_processor_count * BLOCKS_PER_SM))
    results = []
    with torch.cuda.device(dense.device):
        stream = torch.cuda.current_stream().cuda_stream
        for start in range(0, len(vecs), per):
            chunk = vecs[start:start + per]
            out = torch.zeros((nseg, len(chunk)), dtype=torch.int64,
                              device=dense.device)
            if n:
                ptrs = (ctypes.c_void_p * len(chunk))(
                    *[v.data_ptr() for v in chunk])
                err = lib.grouped_sum_i64(
                    dense.data_ptr(), ctypes.cast(ptrs, ctypes.c_void_p), n,
                    len(chunk), nseg, out.data_ptr(), grid, stream)
                if err != 0:
                    raise RuntimeError(
                        f"grouped_sum_i64 kernel launch failed: CUDA error {err}")
                grouped_sum_i64.launches += 1
            results.extend(out[:, j] for j in range(len(chunk)))
    return results


grouped_sum_i64.launches = 0  # kernel launches since the last reset
