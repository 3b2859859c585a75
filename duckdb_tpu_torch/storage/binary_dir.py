"""Binary columnar table directory reader (dbgen_tbl output format).

Format per table dir: meta.json {rows, columns:[{name,kind}]} with
  kind i64  → <col>.i64 raw int64
  kind i32  → <col>.i32 raw int32
  kind date → <col>.i32 raw int32 (days since 1970-01-01)
  kind str  → <col>.len (u32 lengths) + <col>.bytes (utf8 payload)

Strings are dictionary-encoded on load: device data is int32 codes into a
sorted unique-value array (host-side), so string predicates evaluate once
per distinct value and comparisons/sorts stay integer ops on the device.
The encoding is cached beside the source in the same sidecar files the JAX
package writes, so the two packages share one encoding of a directory.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np


def read_meta(table_dir: str) -> dict:
    with open(os.path.join(table_dir, "meta.json")) as f:
        return json.load(f)


def read_string_column(table_dir: str, name: str) -> np.ndarray:
    lens = np.fromfile(os.path.join(table_dir, f"{name}.len"), dtype=np.uint32)
    blob = np.fromfile(os.path.join(table_dir, f"{name}.bytes"), dtype=np.uint8)
    n = len(lens)
    if n == 0:
        return np.empty(0, dtype=object)
    if int(lens.max()) == 0:  # every value empty (e.g. an all-NULL VARCHAR column)
        out = np.empty(n, dtype=object)
        out[:] = ""
        return out
    # ragged→fixed-width BYTES: dict_encode sorts these with C memcmp
    # (UTF-8 byte order == codepoint order), decoding only the unique values
    return _ragged_to_fixed(blob, lens)


def _ragged_to_fixed(blob: np.ndarray, lens: np.ndarray,
                     offsets: Optional[np.ndarray] = None) -> np.ndarray:
    """(u8 blob, u32 lens) → zero-padded fixed-width 'S' array."""
    n = len(lens)
    if offsets is None:
        offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(lens, out=offsets[1:])
    maxlen = max(int(lens.max()) if n else 0, 1)
    if len(blob) == 0:
        return np.zeros((n, maxlen), dtype=np.uint8).view(f"S{maxlen}").reshape(n)
    col_idx = np.arange(maxlen, dtype=np.int64)
    src = offsets[:-1, None] + col_idx[None, :]
    valid = col_idx[None, :] < lens[:, None]
    padded = np.where(valid, blob[np.minimum(src, max(len(blob) - 1, 0))], 0)
    return padded.astype(np.uint8).view(f"S{maxlen}").reshape(n)


def dict_encode(values: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """→ (codes int32, sorted unique values as object-of-str)."""
    if values.dtype.kind == "S":
        uniq_b, codes = np.unique(values, return_inverse=True)
        uniq = np.char.decode(uniq_b, "utf-8").astype(object)
        _register_plane(uniq, uniq_b, np.char.str_len(uniq_b))
        return codes.astype(np.int32), uniq
    uniq, codes = np.unique(values, return_inverse=True)
    return codes.astype(np.int32), uniq.astype(object)


def _register_plane(uniq: np.ndarray, fixed: np.ndarray, lens: np.ndarray):
    """Hand a decoded dictionary's fixed-width bytes to ops/strings, whose
    byte planes then skip re-encoding the Python strings."""
    if len(uniq):
        from duckdb_tpu_torch.ops import strings as dstr

        dstr.register_plane(uniq, fixed, lens)


def load_string_dict(table_dir: str, name: str) -> Tuple[np.ndarray, np.ndarray]:
    """read_string_column + dict_encode with a sidecar cache: the first
    load writes <name>.codes.i32 / .dict.len / .dict.bytes next to the
    source so later processes read the encoding instead of re-sorting."""
    cpath = os.path.join(table_dir, f"{name}.codes.i32")
    src = os.path.join(table_dir, f"{name}.bytes")
    if os.path.exists(cpath) and os.path.getmtime(cpath) >= os.path.getmtime(src):
        codes = np.fromfile(cpath, dtype=np.int32)
        dlens = np.fromfile(os.path.join(table_dir, f"{name}.dict.len"),
                            dtype=np.uint32)
        dblob = np.fromfile(os.path.join(table_dir, f"{name}.dict.bytes"),
                            dtype=np.uint8)
        fixed = _ragged_to_fixed(dblob, dlens)
        uniq = np.char.decode(fixed, "utf-8").astype(object)
        _register_plane(uniq, fixed, dlens)
        return codes, uniq
    values = read_string_column(table_dir, name)
    codes, uniq = dict_encode(values)
    try:  # best-effort cache (data dir may be read-only)
        enc = [s.encode("utf-8") for s in uniq]
        np.array([len(e) for e in enc], dtype=np.uint32).tofile(
            os.path.join(table_dir, f"{name}.dict.len"))
        with open(os.path.join(table_dir, f"{name}.dict.bytes"), "wb") as f:
            f.write(b"".join(enc))
        codes.tofile(cpath)
    except OSError:
        pass
    return codes, uniq


def read_numeric_column(table_dir: str, name: str, kind: str) -> np.ndarray:
    if kind == "i64":
        return np.fromfile(os.path.join(table_dir, f"{name}.i64"), dtype=np.int64)
    if kind in ("i32", "date"):
        return np.fromfile(os.path.join(table_dir, f"{name}.i32"), dtype=np.int32)
    raise ValueError(f"unknown kind {kind}")
