"""The C API of the port: capi.cpp and duckdb_tpu_torch.h, with bridge.py.

`library()` builds capi.cpp at first use with the host compiler (`$CXX`,
else g++), as storage/host_lib.py builds the file readers' libraries, into
build/torch_kernels/libduckdb_tpu_torch_capi.so, and loads it with ctypes
into this process: the library then calls the running interpreter, so it
needs Python.h (sysconfig's include directory) to build and no -lpython.
A C program that links libpython can load the same library.
"""

from __future__ import annotations

import ctypes
import os
import sysconfig
import threading

from duckdb_tpu_torch.storage import host_lib

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(HERE, "capi.cpp")
HEADER = os.path.join(HERE, "duckdb_tpu_torch.h")
TARGET = os.path.join(host_lib.BUILD_DIR, "libduckdb_tpu_torch_capi.so")

_lock = threading.Lock()
_lib = None


def library(force: bool = False) -> ctypes.CDLL:
    """libduckdb_tpu_torch_capi.so, built unless an up-to-date build
    exists (`force`: built anyway), loaded once per process."""
    global _lib
    with _lock:
        if _lib is not None and not force:
            return _lib
        include = sysconfig.get_paths()["include"]
        if not os.path.exists(os.path.join(include, "Python.h")):
            raise RuntimeError(f"the C API needs Python.h, which {include} lacks")
        host_lib.build(SOURCE, [HEADER], TARGET,
                       flags=["-O2", f"-I{include}", f"-I{HERE}"], force=force)
        _lib = ctypes.CDLL(TARGET)
        return _lib
