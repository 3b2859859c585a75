"""Columnar compression of checkpointed columns, on the host in numpy.

The JAX package's format (duckdb_tpu/storage/compression.py), byte for
byte, so that a database directory written by either package opens in the
other. One scheme per column, chosen at CHECKPOINT by encoded size
(smallest wins) and recorded in the column's meta entry:

  integers  : constant | RLE (run values and lengths, each FOR-bitpacked)
              | FOR-bitpack (frame of reference: value - min in w bits)
  floats    : byte shuffle (the 8 byte planes transposed) + a byte codec
  VARCHAR   : the dictionary kept as a dictionary: the unique strings
              through the byte codec, u32 lengths, FOR-bitpacked codes
  validity  : bitpacked

The byte codec is zstd (level 3) where the `zstandard` package imports,
else zlib from the standard library. A meta entry that names no codec
means zstd, which is what the JAX package's files hold; the port writes
"codec": "zlib" when it used zlib. A column whose codec is not installed
raises an error naming the codec: its bytes are never returned undecoded.

Bitpacking is the JAX package's little-endian bitstream (value i in bits
[i·w, (i+1)·w)), built 64 values at a time as w 64-bit words, which is
the same bytes without a (rows × w) bit matrix.
"""

from __future__ import annotations

import zlib
from typing import Optional, Tuple

import numpy as np

try:
    import zstandard as _zstd
except ImportError:  # the card's host may lack it: zlib then
    _zstd = None

# the codec this process writes
CODEC = "zstd" if _zstd is not None else "zlib"
_ZSTD_LEVEL = 3


def _compress_bytes(b: bytes, meta: dict) -> bytes:
    """Compress with the process's codec, naming it in `meta` unless it is
    zstd (the default a meta without a codec means)."""
    if CODEC == "zstd":
        return _zstd.ZstdCompressor(level=_ZSTD_LEVEL).compress(b)
    meta["codec"] = CODEC
    return zlib.compress(b, 6)


def _decompress_bytes(b: bytes, meta: dict) -> bytes:
    codec = meta.get("codec", "zstd")
    if codec == "zstd":
        if _zstd is None:
            raise RuntimeError("the column is compressed with zstd, and the zstandard "
                               "package is not installed")
        return _zstd.ZstdDecompressor().decompress(b)
    if codec == "zlib":
        return zlib.decompress(b)
    raise ValueError(f"the column is compressed with the unknown codec {codec!r}")


def _pack_uint(a: np.ndarray, width: int) -> bytes:
    """Unsigned values (< 2^width) → their little-endian bitstream."""
    n = len(a)
    if width == 0 or n == 0:
        return b""
    m = -(-n // 64)
    v = np.zeros(m * 64, np.uint64)
    v[:n] = a
    vt = np.ascontiguousarray(v.reshape(m, 64).T)  # (64, m): value j of each block
    words = np.zeros((width, m), np.uint64)  # (w, m): word k of each block
    for j in range(64):
        bit = j * width
        k, sh = bit >> 6, bit & 63
        words[k] |= vt[j] << np.uint64(sh)
        if sh + width > 64:
            words[k + 1] |= vt[j] >> np.uint64(64 - sh)
    return np.ascontiguousarray(words.T).astype("<u8").tobytes()[:(n * width + 7) // 8]


def _unpack_uint(buf: bytes, n: int, width: int) -> np.ndarray:
    if width == 0 or n == 0:
        return np.zeros(n, dtype=np.uint64)
    m = -(-n // 64)
    raw = np.zeros(m * width * 8, np.uint8)
    b = np.frombuffer(buf, dtype=np.uint8)[:(n * width + 7) // 8]
    raw[:len(b)] = b
    words = np.ascontiguousarray(raw.view("<u8").reshape(m, width).T)  # (w, m)
    mask = np.uint64((1 << width) - 1)
    out = np.empty((64, m), np.uint64)
    for j in range(64):
        bit = j * width
        k, sh = bit >> 6, bit & 63
        x = words[k] >> np.uint64(sh)
        if sh + width > 64:
            x |= words[k + 1] << np.uint64(64 - sh)
        out[j] = x & mask
    return out.T.reshape(-1)[:n]


def _width_for(a: np.ndarray) -> int:
    return int(a.max(initial=0)).bit_length()


def _for_encode(a: np.ndarray) -> Tuple[dict, bytes]:
    """Frame-of-reference bitpacking of a signed integer array."""
    lo = int(a.min()) if len(a) else 0
    rel = (a.astype(np.int64) - lo).astype(np.uint64)  # wraps to the true distance
    w = _width_for(rel)
    return {"s": "for", "n": len(a), "min": lo, "w": w}, _pack_uint(rel, w)


def _for_decode(meta: dict, buf: bytes) -> np.ndarray:
    rel = _unpack_uint(buf, meta["n"], meta["w"])
    return rel.astype(np.int64) + np.int64(meta["min"])


def compress_ints(a: np.ndarray) -> Tuple[dict, bytes]:
    """An integer plane → (meta, payload); the smallest candidate wins, FOR
    on a tie."""
    a = np.ascontiguousarray(a)
    n = len(a)
    if n == 0:
        return {"s": "const", "n": 0, "v": 0}, b""
    lo, hi = int(a.min()), int(a.max())
    if lo == hi:
        return {"s": "const", "n": n, "v": lo}, b""
    fm, fb = _for_encode(a)
    best = (len(fb), fm, fb)
    change = np.empty(n, dtype=bool)
    change[0] = True
    np.not_equal(a[1:], a[:-1], out=change[1:])
    starts = np.flatnonzero(change)
    if len(starts) * 3 < n:  # runs dominate: (run values, run lengths)
        vm, vb = _for_encode(a[starts])
        lm, lb = _for_encode(np.diff(np.append(starts, n)))
        if len(vb) + len(lb) < best[0]:
            best = (len(vb) + len(lb),
                    {"s": "rle", "n": n, "vals": vm, "lens": lm, "split": len(vb)}, vb + lb)
    return best[1], best[2]


def decompress_ints(meta: dict, buf: bytes) -> np.ndarray:
    s = meta["s"]
    if s == "const":
        return np.full(meta["n"], meta["v"], dtype=np.int64)
    if s == "for":
        return _for_decode(meta, buf)
    if s == "rle":
        vb, lb = buf[:meta["split"]], buf[meta["split"]:]
        return np.repeat(_for_decode(meta["vals"], vb), _for_decode(meta["lens"], lb))
    raise ValueError(f"unknown integer scheme {s!r}")


def compress_floats(a: np.ndarray) -> Tuple[dict, bytes]:
    """Byte shuffle (the 8 byte planes of each value, plane by plane), then
    the byte codec: bit exact for NaN, -0.0 and inf."""
    a = np.ascontiguousarray(a, dtype=np.float64)
    shuf = a.view(np.uint8).reshape(-1, 8).T.copy()
    meta = {"s": "f64z", "n": len(a)}
    return meta, _compress_bytes(shuf.tobytes(), meta)


def decompress_floats(meta: dict, buf: bytes) -> np.ndarray:
    n = meta["n"]
    if n == 0:
        return np.empty(0, dtype=np.float64)
    shuf = np.frombuffer(_decompress_bytes(buf, meta), dtype=np.uint8).reshape(8, n)
    return np.ascontiguousarray(shuf.T).reshape(-1).view(np.float64).copy()


def compress_strings(codes: np.ndarray, dvals: Optional[np.ndarray]) -> Tuple[dict, bytes]:
    """A dictionary column as a dictionary: the unique strings' bytes
    through the codec, their u32 lengths, the codes FOR-bitpacked."""
    dvals = dvals if dvals is not None else np.empty(0, dtype=object)
    enc = [str(s).encode("utf-8") for s in dvals]
    meta = {"s": "dict", "n_dict": len(enc)}
    blob = _compress_bytes(b"".join(enc), meta)
    lens = np.array([len(b) for b in enc], dtype=np.uint32).tobytes()
    cm, cb = _for_encode(np.asarray(codes, dtype=np.int64))
    meta.update({"blob": len(blob), "lens": len(lens), "codes": cm})
    return meta, blob + lens + cb


def decompress_strings(meta: dict, buf: bytes):
    """→ (int32 codes, object array of the strings)."""
    b0 = meta["blob"]
    b1 = b0 + meta["lens"]
    blob = _decompress_bytes(buf[:b0], meta)
    lens = np.frombuffer(buf[b0:b1], dtype=np.uint32)
    codes = _for_decode(meta["codes"], buf[b1:]).astype(np.int32)
    offs = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    dvals = np.array([blob[offs[i]:offs[i + 1]].decode("utf-8") for i in range(len(lens))],
                     dtype=object)
    return codes, dvals


def compress_validity(valid: np.ndarray) -> bytes:
    return np.packbits(np.asarray(valid, dtype=bool), bitorder="little").tobytes()


def decompress_validity(buf: bytes, n: int) -> np.ndarray:
    return np.unpackbits(np.frombuffer(buf, dtype=np.uint8), count=n,
                         bitorder="little").astype(bool)


def decode_column(meta: dict, buf: bytes):
    """A column's payload → its values (ints, floats) or (codes, strings)."""
    s = meta["s"]
    if s in ("const", "for", "rle"):
        return decompress_ints(meta, buf)
    if s == "f64z":
        return decompress_floats(meta, buf)
    if s == "dict":
        return decompress_strings(meta, buf)
    raise ValueError(f"unknown column scheme {s!r}")


def read_column(base: str, meta: dict):
    """Read and decode `<base>.z`."""
    with open(base + ".z", "rb") as f:
        return decode_column(meta, f.read())
