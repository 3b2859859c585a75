"""The host C++ libraries of the file readers: build, load, and strings.

csrc/csv2col.cpp (the CSV tokenizer and writer) and csrc/parquet_codec.cpp
(Snappy, the RLE / bit-packed hybrid, PLAIN byte arrays) run on the host,
as the JAX package's CSV and Parquet code does. Each is compiled with the
host C++ compiler (`$CXX`, else g++ or c++) at first use into
build/torch_kernels/, beside the grouped-sum kernel, and loaded with
ctypes. As ops/grouped_sum.build does, the compiler writes a temporary
name that is then renamed, so that concurrent processes never load a half
written library. A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")

_locks = {name: threading.Lock() for name in ("csv2col", "parquet_codec")}
_libs: dict = {}


def compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler for the host libraries of the file readers: "
                           "set CXX, or install g++")
    return cxx


def load(name: str, force: bool = False) -> ctypes.CDLL:
    """csrc/<name>.cpp built (unless an up-to-date build exists) and
    loaded as lib<name>.so (each library under a lock of its own, so that
    the two build side by side)."""
    with _locks[name]:
        lib = _libs.get(name)
        if lib is not None and not force:
            return lib
        source = os.path.join(CSRC, f"{name}.cpp")
        deps = [source, os.path.join(CSRC, "host_strings.h")]
        target = os.path.join(BUILD_DIR, f"lib{name}.so")
        fresh = os.path.exists(target) and os.path.getmtime(target) >= max(
            os.path.getmtime(d) for d in deps)
        if force or not fresh:
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{target}.{os.getpid()}.{threading.get_ident()}.tmp"
            cmd = [compiler(), "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
                   "-o", tmp, source]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"{cmd[0]} failed to build {source}:\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, target)
        lib = ctypes.CDLL(target)
        _libs[name] = lib
        return lib


def ptr(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


def decode_strings(blob: bytes, offsets: np.ndarray) -> np.ndarray:
    """UTF-8 values blob[offsets[i]:offsets[i + 1]] → an object array of str
    (one decode of the whole blob when it is ASCII)."""
    n = len(offsets) - 1
    out = np.empty(n, dtype=object)
    if n == 0:
        return out
    starts, ends = offsets[:-1].tolist(), offsets[1:].tolist()
    if blob.isascii():
        text = blob.decode("ascii")
        out[:] = [text[a:b] for a, b in zip(starts, ends)]
    else:
        out[:] = [blob[a:b].decode("utf-8", "replace") for a, b in zip(starts, ends)]
    return out
