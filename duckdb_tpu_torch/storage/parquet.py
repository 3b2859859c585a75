"""Parquet: the port's own reader and writer, with no pyarrow.

The JAX package reads and writes Parquet through pyarrow
(duckdb_tpu/storage/parquet.py); the machine with the card has none, so
the port owns its codec, as DuckDB does (extension/parquet vendors its
thrift and codecs). Python and numpy parse the footer's FileMetaData and
each PageHeader (thrift's compact protocol, `_Thrift`) and decode the
values; csrc/parquet_codec.cpp, built by storage/host_lib, does Snappy,
the RLE / bit-packed hybrid and PLAIN byte arrays.

The reader takes flat columns, the JAX package's surface: BOOLEAN,
INT32 / INT64 (as TINYINT, SMALLINT, INTEGER or BIGINT by their logical
type; unsigned ones as BIGINT), INT64 timestamps (millis, micros or
nanos) as TIMESTAMP, FLOAT, DOUBLE, DECIMAL (INT32, INT64, or a
big-endian FIXED_LEN_BYTE_ARRAY; a value the port's int64 DECIMAL cannot
hold raises, naming the column), DATE, and BYTE_ARRAY as
VARCHAR; data pages v1 and v2, dictionary pages, PLAIN, PLAIN_DICTIONARY,
RLE_DICTIONARY and RLE booleans; the codecs UNCOMPRESSED, SNAPPY, GZIP and
ZSTD (where the zstandard module imports). A nested column (LIST, STRUCT,
MAP) raises, naming it. `load_column` decodes one column, so that a
file's table (storage/multi_file.py) loads lazily, column by column: a
column no query touches is never decoded.

The writer writes one file with row groups of 122,880 rows (DuckDB's row
group size), every column OPTIONAL, PLAIN values but for VARCHAR, which
gets a dictionary page per row group, and the logical types DuckDB
writes: TIMESTAMP as a TIMESTAMP of micros (the JAX package writes its
int64 as a BIGINT, ROADMAP I4), DECIMAL as INT32, INT64 or a 16-byte
FIXED_LEN_BYTE_ARRAY by its width. The codec is SNAPPY unless COMPRESSION
names another.
"""

from __future__ import annotations

import ctypes
import os
import struct
import zlib
from typing import List, Optional, Tuple

import numpy as np

from duckdb_tpu_torch.errors import ConversionException, IOException
from duckdb_tpu_torch.planner.bound import not_ported
from duckdb_tpu_torch.storage import host_lib
from duckdb_tpu_torch.types import (
    BIGINT, BOOLEAN, DATE, DOUBLE, FLOAT, INTEGER, SMALLINT, TIMESTAMP, TINYINT, VARCHAR,
    LogicalType, TypeId, decimal)

try:
    import zstandard as _zstd
except ImportError:  # the machine with the card has no zstandard
    _zstd = None

ROW_GROUP_ROWS = 122_880
MAGIC = b"PAR1"

# physical types, encodings, codecs and page types of parquet.thrift
BOOL_T, INT32_T, INT64_T, INT96_T, FLOAT_T, DOUBLE_T, BYTES_T, FIXED_T = range(8)
PLAIN, PLAIN_DICT, RLE, RLE_DICT = 0, 2, 3, 8
CODECS = {"uncompressed": 0, "snappy": 1, "gzip": 2, "zstd": 6}
_CODEC_NAMES = {0: "UNCOMPRESSED", 1: "SNAPPY", 2: "GZIP", 3: "LZO", 4: "BROTLI", 5: "LZ4",
                6: "ZSTD", 7: "LZ4_RAW"}
DATA_PAGE, DICT_PAGE, DATA_PAGE_V2 = 0, 2, 3


# -- thrift's compact protocol ----------------------------------------------------------
# a struct reads as {field id: value}; a list as a Python list
_STOP, _TRUE, _FALSE, _BYTE, _I16, _I32, _I64, _DOUBLE, _BINARY, _LIST, _SET, _MAP, \
    _STRUCT = range(13)


class _Thrift:
    def __init__(self, buf: bytes, pos: int = 0):
        self.buf, self.pos = buf, pos

    def varint(self) -> int:
        v = shift = 0
        buf = self.buf
        while True:
            b = buf[self.pos]
            self.pos += 1
            v |= (b & 0x7F) << shift
            if b < 0x80:
                return v
            shift += 7

    def zigzag(self) -> int:
        v = self.varint()
        return (v >> 1) ^ -(v & 1)

    def value(self, t: int):
        if t in (_TRUE, _FALSE):
            return t == _TRUE
        if t == _BYTE:
            b = self.buf[self.pos]
            self.pos += 1
            return b - 256 if b > 127 else b
        if t in (_I16, _I32, _I64):
            return self.zigzag()
        if t == _DOUBLE:
            self.pos += 8
            return struct.unpack_from("<d", self.buf, self.pos - 8)[0]
        if t == _BINARY:
            n = self.varint()
            self.pos += n
            return bytes(self.buf[self.pos - n:self.pos])
        if t in (_LIST, _SET):
            head = self.buf[self.pos]
            self.pos += 1
            n, et = head >> 4, head & 0x0F
            if n == 15:
                n = self.varint()
            if et in (_TRUE, _FALSE):  # a list's booleans are one byte each
                out = [b == 1 for b in self.buf[self.pos:self.pos + n]]
                self.pos += n
                return out
            return [self.value(et) for _ in range(n)]
        if t == _MAP:
            n = self.varint()
            if not n:
                return {}
            kv = self.buf[self.pos]
            self.pos += 1
            return {self.value(kv >> 4): self.value(kv & 0x0F) for _ in range(n)}
        if t == _STRUCT:
            return self.struct()
        raise IOException(f"Parquet: a thrift value of unknown type {t}")

    def struct(self) -> dict:
        out, last = {}, 0
        while True:
            head = self.buf[self.pos]
            self.pos += 1
            if head == _STOP:
                return out
            delta, t = head >> 4, head & 0x0F
            fid = last + delta if delta else self.zigzag()
            out[fid] = self.value(t)
            last = fid


def _w_varint(out: bytearray, v: int):
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def _w_struct(out: bytearray, fields):
    """fields: [(id, type, value)] in id order; a struct value is such a
    list, a list value is (element type, [values])."""
    last = 0
    for fid, t, v in fields:
        if v is None:
            continue
        wt = (_TRUE if v else _FALSE) if t == _TRUE else t
        if 0 < fid - last <= 15:
            out.append(((fid - last) << 4) | wt)
        else:
            out.append(wt)
            _w_varint(out, (fid << 1) ^ (fid >> 63))
        last = fid
        if t != _TRUE:
            _w_value(out, t, v)
    out.append(_STOP)


def _w_value(out: bytearray, t: int, v):
    if t in (_I16, _I32, _I64):
        _w_varint(out, (v << 1) ^ (v >> 63))
    elif t == _BYTE:
        out.append(v & 0xFF)
    elif t == _BINARY:
        b = v.encode() if isinstance(v, str) else v
        _w_varint(out, len(b))
        out += b
    elif t == _STRUCT:
        _w_struct(out, v)
    elif t == _LIST:
        et, items = v
        if len(items) < 15:
            out.append((len(items) << 4) | et)
        else:
            out.append(0xF0 | et)
            _w_varint(out, len(items))
        for item in items:
            _w_value(out, et, item)
    else:
        raise IOException(f"Parquet: cannot write a thrift value of type {t}")


# -- the host library --------------------------------------------------------------------

def _lib():
    lib = host_lib.load("parquet_codec")
    if not getattr(lib, "_typed", False):
        vp, ll = ctypes.c_void_p, ctypes.c_longlong
        for name, args, res in (
                ("snappy_length", [vp, ll], ll),
                ("snappy_decompress", [vp, ll, vp, ll], ll),
                ("snappy_max_compressed", [ll], ll),
                ("snappy_compress", [vp, ll, vp], ll),
                ("rle_hybrid_decode", [vp, ll, ctypes.c_int, ll, vp], ll),
                ("plain_byte_arrays", [vp, ll, ll, vp, vp], ll),
                ("strings_encode", [vp, vp, ll, vp], vp),
                ("strings_dict_size", [vp, ctypes.POINTER(ll)], ll),
                ("strings_dict", [vp, vp, vp], None)):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
        lib._typed = True
    return lib


def _u8(b) -> np.ndarray:
    return np.frombuffer(b, dtype=np.uint8)


def snappy_decompress(data: bytes) -> bytes:
    lib = _lib()
    src = _u8(data)
    n = lib.snappy_length(host_lib.ptr(src), len(src))
    if n < 0:
        raise IOException("Parquet: a Snappy page has no valid length")
    out = np.empty(max(n, 1), dtype=np.uint8)
    got = lib.snappy_decompress(host_lib.ptr(src), len(src), host_lib.ptr(out), n)
    if got != n:
        raise IOException("Parquet: a Snappy page is corrupt")
    return out[:n].tobytes()


def snappy_compress(data: bytes) -> bytes:
    lib = _lib()
    src = _u8(data)
    out = np.empty(lib.snappy_max_compressed(len(src)), dtype=np.uint8)
    n = lib.snappy_compress(host_lib.ptr(src) if len(src) else None, len(src),
                            host_lib.ptr(out))
    return out[:n].tobytes()


def rle_hybrid(buf, bit_width: int, n: int) -> np.ndarray:
    """n values of the RLE / bit-packed hybrid → int32."""
    src = _u8(buf) if not isinstance(buf, np.ndarray) else buf
    out = np.zeros(n, dtype=np.int32)
    if n:
        got = _lib().rle_hybrid_decode(host_lib.ptr(src) if len(src) else None, len(src),
                                       bit_width, n, host_lib.ptr(out))
        if got != n:
            raise IOException(f"Parquet: an RLE run holds {got} of {n} values")
    return out


def _byte_arrays(buf, n: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """n PLAIN BYTE_ARRAY values → (blob, offsets, bytes used)."""
    src = _u8(buf)
    blob = np.empty(max(len(src), 1), dtype=np.uint8)
    offs = np.empty(n + 1, dtype=np.int64)
    used = _lib().plain_byte_arrays(host_lib.ptr(src) if len(src) else None, len(src), n,
                                    host_lib.ptr(blob), host_lib.ptr(offs))
    if used < 0:
        raise IOException("Parquet: a BYTE_ARRAY page ends inside a value")
    return blob[:offs[-1]], offs, used


def strings_dictionary(blob: np.ndarray, offs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Values blob[offs[i]:offs[i + 1]] → (int32 codes, sorted dictionary)."""
    lib = _lib()
    n = len(offs) - 1
    codes = np.empty(max(n, 1), dtype=np.int32)
    blob = np.ascontiguousarray(blob) if len(blob) else np.zeros(1, np.uint8)
    h = lib.strings_encode(host_lib.ptr(blob), host_lib.ptr(offs), n, host_lib.ptr(codes))
    nbytes = ctypes.c_longlong()
    size = lib.strings_dict_size(h, ctypes.byref(nbytes))
    doffs = np.empty(size + 1, dtype=np.int64)
    dblob = np.empty(max(nbytes.value, 1), dtype=np.uint8)
    lib.strings_dict(h, host_lib.ptr(doffs), host_lib.ptr(dblob))
    return codes[:n], host_lib.decode_strings(dblob[:nbytes.value].tobytes(), doffs)


def _decompress(codec: int, data: bytes, size: int, column: str) -> bytes:
    if codec == 0:
        return data
    if codec == 1:
        return snappy_decompress(data)
    if codec == 2:
        return zlib.decompress(data, 47)  # gzip or zlib framing
    if codec == 6:
        if _zstd is None:
            raise RuntimeError(f'Parquet column "{column}" is compressed with ZSTD, and the '
                               "zstandard package is not installed")
        return _zstd.ZstdDecompressor().decompress(data, max_output_size=size)
    raise not_ported(f'reading Parquet column "{column}" compressed with '
                     f"{_CODEC_NAMES.get(codec, codec)}")


def _compress(codec: int, data: bytes) -> bytes:
    if codec == 0:
        return data
    if codec == 1:
        return snappy_compress(data)
    if codec == 2:
        c = zlib.compressobj(6, zlib.DEFLATED, 31)
        return c.compress(data) + c.flush()
    if _zstd is None:
        raise RuntimeError("COPY … (COMPRESSION ZSTD) needs the zstandard package")
    return _zstd.ZstdCompressor(level=3).compress(data)


# -- the footer and the schema ----------------------------------------------------------------

class ParquetFile:
    """A file's footer: its flat columns (name, LogicalType, schema element)
    and row groups."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            if size < 12:
                raise IOException(f'Parquet: "{path}" is too small to be a Parquet file')
            f.seek(size - 8)
            tail = f.read(8)
            if tail[4:] != MAGIC:
                raise IOException(f'Parquet: "{path}" is not a Parquet file (no PAR1 footer)')
            n = struct.unpack("<i", tail[:4])[0]
            f.seek(size - 8 - n)
            meta = _Thrift(f.read(n)).struct()
        self.nrows = int(meta.get(3, 0))
        self.row_groups = meta.get(4, [])
        schema = meta.get(2, [])
        self.columns: List[Tuple[str, LogicalType, dict]] = []
        i = 1
        while i < len(schema):
            el = schema[i]
            name = el[4].decode("utf-8", "replace")
            if el.get(5) or el.get(3) == 2:  # a group, or a repeated field
                raise not_ported(f'reading the nested Parquet column "{name}" (flat columns '
                                 "are ported)")
            self.columns.append((name, _logical(el, name), el))
            i += 1
        self.index = {name: k for k, (name, _, _) in enumerate(self.columns)}

    @property
    def schema(self) -> List[Tuple[str, LogicalType]]:
        return [(n, t) for n, t, _ in self.columns]


def _logical(el: dict, name: str) -> LogicalType:
    """A leaf's LogicalType, as the JAX package maps pyarrow's types."""
    phys, conv, lt = el.get(1), el.get(6), el.get(10) or {}
    if (5 in lt or conv == 5) and phys != BYTES_T:
        dec = lt.get(5, {})
        return decimal(int(dec.get(2, el.get(8, 18))), int(dec.get(1, el.get(7, 0))))
    if 6 in lt or conv == 6:
        return DATE
    if 8 in lt or conv in (9, 10):
        return TIMESTAMP
    if 7 in lt or conv in (7, 8, 21):
        raise not_ported(f'reading the Parquet TIME or INTERVAL column "{name}"')
    if phys == BOOL_T:
        return BOOLEAN
    if phys in (INT32_T, INT64_T):
        it = lt.get(10)
        if it is not None and not it.get(2, True) or conv in (11, 12, 13, 14):
            return BIGINT  # unsigned
        bits = it.get(1) if it is not None else {15: 8, 16: 16}.get(conv)
        if bits == 8:
            return TINYINT
        if bits == 16:
            return SMALLINT
        return INTEGER if phys == INT32_T else BIGINT
    if phys == FLOAT_T:
        return FLOAT
    if phys == DOUBLE_T:
        return DOUBLE
    if phys == BYTES_T and not (5 in lt or conv == 5):
        return VARCHAR
    raise not_ported(f'reading the Parquet column "{name}" of physical type {phys} '
                     f"(logical type {lt or conv})")


# -- decoding a column ------------------------------------------------------------------------

def _plain(buf: bytes, phys: int, n: int, type_length: int):
    """n PLAIN values → numpy values, or (blob, offsets) for byte arrays."""
    if phys == BOOL_T:
        return np.unpackbits(_u8(buf), bitorder="little")[:n].astype(bool)
    if phys == BYTES_T:
        blob, offs, _ = _byte_arrays(buf, n)
        return blob, offs
    if phys == FIXED_T:
        raw = _u8(buf)[:n * type_length].reshape(n, type_length)
        return raw
    dt = {INT32_T: "<i4", INT64_T: "<i8", FLOAT_T: "<f4", DOUBLE_T: "<f8"}.get(phys)
    if dt is not None:
        return np.frombuffer(buf, dtype=dt, count=n)
    raise IOException(f"Parquet: unknown physical type {phys}")


def _take(values, idx: np.ndarray):
    if isinstance(values, tuple):  # byte arrays: gather their spans
        blob, offs = values
        starts, lens = offs[:-1][idx], np.diff(offs)[idx]
        new_offs = np.zeros(len(idx) + 1, dtype=np.int64)
        np.cumsum(lens, out=new_offs[1:])
        pos = np.repeat(starts - new_offs[:-1], lens) + np.arange(new_offs[-1])
        return blob[pos], new_offs
    return values[idx]


def _concat(parts):
    if parts and isinstance(parts[0], tuple):
        blobs = [p[0] for p in parts]
        sizes = np.cumsum([0] + [len(b) for b in blobs[:-1]])
        offs = np.concatenate([parts[0][1][:1]] + [p[1][1:] + s for p, s in zip(parts, sizes)])
        return np.concatenate(blobs) if blobs else np.zeros(0, np.uint8), offs
    return np.concatenate(parts)


def _read_chunk(f, meta: dict, phys: int, type_length: int, optional: bool, column: str):
    """One column chunk → (non-null values, validity|None). Values are a
    numpy array, or (blob, offsets) for byte arrays."""
    codec = meta.get(4, 0)
    total = int(meta.get(5, 0))
    start = meta.get(9)
    if meta.get(11) is not None and meta.get(11) > 0:
        start = min(start, meta[11])
    f.seek(start)
    data = f.read(int(meta.get(7)))
    pos, seen = 0, 0
    dictionary = None
    parts, valids = [], []
    while seen < total and pos < len(data):
        th = _Thrift(data, pos)
        header = th.struct()
        pos = th.pos
        ptype, usize, csize = header[1], header[2], header[3]
        body = data[pos:pos + csize]
        pos += csize
        if ptype == DICT_PAGE:
            dh = header[7]
            page = _decompress(codec, body, usize, column)
            dictionary = _plain(page, phys, dh[1], type_length)
            continue
        if ptype == DATA_PAGE:
            dh = header[5]
            nvals, enc = dh[1], dh[2]
            page = _decompress(codec, body, usize, column)
            at = 0
            if optional:
                n_def = struct.unpack_from("<i", page, 0)[0]
                defs = rle_hybrid(page[4:4 + n_def], 1, nvals)
                at = 4 + n_def
        elif ptype == DATA_PAGE_V2:
            dh = header[8]
            nvals, enc = dh[1], dh[4]
            dlen, rlen = dh.get(5, 0), dh.get(6, 0)
            levels = body[:dlen + rlen]
            rest = body[dlen + rlen:]
            if dh.get(7, True):
                rest = _decompress(codec, rest, usize - dlen - rlen, column)
            page, at = rest, 0
            if optional:
                defs = rle_hybrid(levels[rlen:rlen + dlen], 1, nvals)
        else:
            continue  # an index page
        valid = defs.astype(bool) if optional else None
        nn = int(valid.sum()) if optional else nvals
        if enc in (PLAIN_DICT, RLE_DICT):
            if dictionary is None:
                raise IOException(f'Parquet column "{column}": a dictionary page is missing')
            bw = page[at]
            idx = rle_hybrid(_u8(page)[at + 1:], bw, nn)
            vals = _take(dictionary, idx)
        elif enc == PLAIN:
            vals = _plain(page[at:], phys, nn, type_length)
        elif enc == RLE and phys == BOOL_T:
            # RLE booleans are prefixed with their length (4 bytes)
            vals = rle_hybrid(_u8(page)[at + 4:], 1, nn).astype(bool)
        else:
            raise not_ported(f'reading Parquet column "{column}" with encoding {enc}')
        parts.append(vals)
        valids.append(valid if valid is not None else np.ones(nvals, bool))
        seen += nvals
    if not parts:
        empty = (np.zeros(0, np.uint8), np.zeros(1, np.int64)) if phys == BYTES_T else \
            np.zeros(0, np.int64)
        return empty, None
    validity = np.concatenate(valids)
    return _concat(parts), (None if validity.all() else validity)


def _to_engine(values, ltype: LogicalType, el: dict, column: str):
    """Decoded non-null values of one chunk → the engine's physical values
    (byte arrays stay (blob, offsets) for VARCHAR)."""
    phys = el.get(1)
    lt = el.get(10) or {}
    if ltype.id is TypeId.VARCHAR:
        return values
    if ltype.id is TypeId.DECIMAL:
        if phys == FIXED_T:
            return _be_decimal(values, ltype, column)
        return values.astype(np.int64)
    if ltype.id is TypeId.TIMESTAMP:
        unit = (lt.get(8) or {}).get(2) or {}
        conv = el.get(6)
        v = values.astype(np.int64)
        if 1 in unit or conv == 9:
            return v * 1000
        if 3 in unit:
            return v // 1000
        return v
    if ltype.id is TypeId.BIGINT and phys == INT32_T:
        return values.view(np.uint32).astype(np.int64) if _unsigned(el) else \
            values.astype(np.int64)
    return values


def _unsigned(el: dict) -> bool:
    it = (el.get(10) or {}).get(10)
    return (it is not None and not it.get(2, True)) or el.get(6) in (11, 12, 13, 14)


def _be_decimal(raw: np.ndarray, ltype: LogicalType, column: str) -> np.ndarray:
    """Big-endian two's-complement rows (n, w) → int64, raising where a
    value needs more than 64 bits."""
    n, w = raw.shape
    if w <= 8:
        pad = np.where((raw[:, :1] >= 0x80), 0xFF, 0).astype(np.uint8)
        full = np.concatenate([np.repeat(pad, 8 - w, axis=1), raw], axis=1)
        return full.copy().view(">i8").reshape(-1).astype(np.int64)
    low = raw[:, w - 8:].copy().view(">i8").reshape(-1).astype(np.int64)
    sign = np.where(low < 0, 0xFF, 0).astype(np.uint8)
    if not (raw[:, :w - 8] == sign[:, None]).all():
        raise ConversionException(
            f'Parquet column "{column}" holds a {ltype!r} value past the 18 digits the '
            f"port's DECIMAL keeps in int64")
    return low


def load_column(path: str, name: str, pf: Optional[ParquetFile] = None):
    """One column of the file → (values, validity|None, dictionary|None)."""
    pf = pf or ParquetFile(path)
    k = pf.index[name]
    _, ltype, el = pf.columns[k]
    phys, tlen = el.get(1), el.get(2, 0)
    optional = el.get(3, 1) != 0
    parts, valids = [], []
    with open(path, "rb") as f:
        for rg in pf.row_groups:
            chunk = rg[1][k]
            vals, valid = _read_chunk(f, chunk[3], phys, tlen, optional, name)
            parts.append(_to_engine(vals, ltype, el, name))
            n = int(rg[3])
            valids.append(np.ones(n, bool) if valid is None else valid)
    validity = np.concatenate(valids) if valids else np.zeros(0, bool)
    n = len(validity)
    if ltype.id is TypeId.VARCHAR:
        blob, offs = _concat(parts) if parts else (np.zeros(0, np.uint8), np.zeros(1, np.int64))
        live, dvals = strings_dictionary(blob, offs)
        codes = np.zeros(n, dtype=np.int32)
        codes[validity] = live
        return codes, (None if validity.all() else validity), dvals
    dtype = ltype.np_dtype
    live = np.concatenate(parts).astype(dtype) if parts else np.zeros(0, dtype)
    if validity.all():
        return live, None, None
    values = np.zeros(n, dtype=dtype)
    values[validity] = live
    return values, validity, None


# -- the writer -------------------------------------------------------------------------------

def _bitpacked(values: np.ndarray, bw: int) -> bytes:
    """Values as one bit-packed run of the hybrid (header included)."""
    n = len(values)
    groups = -(-n // 8)
    if not n:
        return b""
    v = np.zeros(groups * 8, dtype=np.uint64)
    v[:n] = values
    bits = ((v[:, None] >> np.arange(bw, dtype=np.uint64)) & 1).astype(np.uint8)
    out = bytearray()
    _w_varint(out, (groups << 1) | 1)
    return bytes(out) + np.packbits(bits.reshape(-1), bitorder="little").tobytes()


def _def_levels(valid: Optional[np.ndarray], n: int) -> bytes:
    """Definition levels (bit width 1) with their v1 4-byte length."""
    if valid is None or valid.all():
        out = bytearray()
        _w_varint(out, n << 1)
        out.append(1)
        body = bytes(out)
    else:
        body = _bitpacked(valid.astype(np.uint64), 1)
    return struct.pack("<i", len(body)) + body


def _element(name: str, t: LogicalType):
    """A column's SchemaElement fields and (physical type, its width)."""
    i32 = lambda bits: [(10, _STRUCT, [(1, _BYTE, bits), (2, _TRUE, True)])]  # noqa: E731
    tid = t.id
    if tid is TypeId.BOOLEAN:
        phys, conv, lt = BOOL_T, None, None
    elif tid is TypeId.TINYINT:
        phys, conv, lt = INT32_T, 15, i32(8)
    elif tid is TypeId.SMALLINT:
        phys, conv, lt = INT32_T, 16, i32(16)
    elif tid is TypeId.INTEGER:
        phys, conv, lt = INT32_T, None, None
    elif tid in (TypeId.BIGINT, TypeId.HUGEINT):
        phys, conv, lt = INT64_T, None, None
    elif tid is TypeId.FLOAT:
        phys, conv, lt = FLOAT_T, None, None
    elif tid is TypeId.DOUBLE:
        phys, conv, lt = DOUBLE_T, None, None
    elif tid is TypeId.DATE:
        phys, conv, lt = INT32_T, 6, [(6, _STRUCT, [])]
    elif tid in (TypeId.TIMESTAMP, TypeId.TIMESTAMPTZ):
        utc = tid is TypeId.TIMESTAMPTZ
        phys, conv = INT64_T, 10
        lt = [(8, _STRUCT, [(1, _TRUE, utc), (2, _STRUCT, [(2, _STRUCT, [])])])]
    elif tid is TypeId.DECIMAL:
        phys = INT32_T if t.width <= 9 else INT64_T if t.width <= 18 else FIXED_T
        conv = 5
        lt = [(5, _STRUCT, [(1, _I32, t.scale), (2, _I32, t.width)])]
    elif tid is TypeId.VARCHAR:
        phys, conv, lt = BYTES_T, 0, [(1, _STRUCT, [])]
    else:
        raise not_ported(f'writing the {t!r} column "{name}" to Parquet (the flat types are '
                         "ported)")
    dec = tid is TypeId.DECIMAL
    fields = [(1, _I32, phys), (2, _I32, 16 if phys == FIXED_T else None), (3, _I32, 1),
              (4, _BINARY, name), (6, _I32, conv), (7, _I32, t.scale if dec else None),
              (8, _I32, t.width if dec else None), (10, _STRUCT, lt)]
    return fields, phys


def _utf8(dvals) -> Tuple[np.ndarray, np.ndarray]:
    """A dictionary's values as (UTF-8 blob, offsets)."""
    enc = [str(v).encode("utf-8") for v in dvals]
    offs = np.zeros(len(enc) + 1, dtype=np.int64)
    np.cumsum([len(e) for e in enc], out=offs[1:])
    return np.frombuffer(b"".join(enc), dtype=np.uint8), offs


def _byte_array_plain(blob: np.ndarray, offs: np.ndarray, idx: np.ndarray) -> bytes:
    """Values idx of (blob, offsets) as PLAIN BYTE_ARRAY: each a 4-byte
    little-endian length, then its bytes."""
    starts = offs[idx]
    lens = offs[idx + 1] - starts
    rec = np.zeros(len(idx) + 1, dtype=np.int64)
    np.cumsum(lens + 4, out=rec[1:])
    out = np.zeros(int(rec[-1]), dtype=np.uint8)
    out[(rec[:-1, None] + np.arange(4)).reshape(-1)] = lens.astype("<u4").view(np.uint8)
    first = np.zeros(len(idx), dtype=np.int64)
    np.cumsum(lens[:-1], out=first[1:])
    within = np.arange(int(lens.sum())) - np.repeat(first, lens)
    out[np.repeat(rec[:-1] + 4, lens) + within] = blob[np.repeat(starts, lens) + within]
    return out.tobytes()


def _plain_bytes(vals: np.ndarray, phys: int) -> bytes:
    if phys == BOOL_T:
        return np.packbits(vals.astype(np.uint8), bitorder="little").tobytes()
    if phys == INT32_T:
        return vals.astype("<i4").tobytes()
    if phys == INT64_T:
        return vals.astype("<i8").tobytes()
    if phys == FLOAT_T:
        return vals.astype("<f4").tobytes()
    if phys == DOUBLE_T:
        return vals.astype("<f8").tobytes()
    if phys == FIXED_T:  # 16-byte big-endian two's complement
        v = vals.astype(np.int64)
        out = np.empty((len(v), 2), dtype=">i8")
        out[:, 0] = np.where(v < 0, -1, 0)
        out[:, 1] = v
        return out.tobytes()
    raise IOException(f"Parquet: no PLAIN writer for physical type {phys}")


def _page(out: bytearray, ptype: int, body: bytes, codec: int, sub) -> Tuple[int, int]:
    """Append one page (header and compressed body) → (uncompressed size,
    compressed size) with the header."""
    comp = _compress(codec, body)
    head = bytearray()
    _w_struct(head, [(1, _I32, ptype), (2, _I32, len(body)), (3, _I32, len(comp)), sub])
    out += head
    out += comp
    return len(head) + len(body), len(head) + len(comp)


def write_parquet(path: str, names, types, columns, nrows: int,
                  compression: str = "snappy"):
    """Write a Result's columns as one Parquet file."""
    codec = CODECS.get(str(compression).lower())
    if codec is None:
        raise not_ported(f"COPY … (COMPRESSION {compression}) (uncompressed, snappy, gzip "
                         "and zstd are ported)")
    elements = [_element(n, t) for n, t in zip(names, types)]
    out = bytearray(MAGIC)
    groups = []
    encoded = {}  # a VARCHAR column's dictionary as UTF-8, once per column
    for lo in range(0, nrows, ROW_GROUP_ROWS):
        hi = min(nrows, lo + ROW_GROUP_ROWS)
        n = hi - lo
        chunks, group_bytes = [], 0
        for (vals, valid, dvals), t, name, (_, phys) in zip(columns, types, names, elements):
            words = encoded.get(name)
            vals = np.asarray(vals)[lo:hi]
            v = None if valid is None else np.asarray(valid)[lo:hi]
            live = vals if v is None or v.all() else vals[v]
            if live.dtype == object:
                raise ConversionException(f'column "{name}" holds {t!r} values past int64, '
                                          "which the Parquet writer does not write")
            defs = _def_levels(v, n)
            start = len(out)
            dict_off = None
            usize = csize = 0
            if t.id is TypeId.VARCHAR:
                if words is None or words[0] is not dvals:
                    words = (dvals, *_utf8(dvals))
                used, idx = np.unique(live.astype(np.int64), return_inverse=True)
                body = _byte_array_plain(words[1], words[2], used)
                encoded[name] = words
                dict_off = len(out)
                u, c = _page(out, DICT_PAGE, body, codec,
                             (7, _STRUCT, [(1, _I32, len(used)), (2, _I32, PLAIN)]))
                usize, csize = usize + u, csize + c
                bw = max(1, int(len(used) - 1).bit_length())
                data = bytes([bw]) + _bitpacked(idx.reshape(-1).astype(np.uint64), bw)
                enc = RLE_DICT
                encodings = [PLAIN, RLE, RLE_DICT]
            else:
                data, enc, encodings = _plain_bytes(live, phys), PLAIN, [PLAIN, RLE]
            data_off = len(out)
            u, c = _page(out, DATA_PAGE, defs + data, codec,
                         (5, _STRUCT, [(1, _I32, n), (2, _I32, enc), (3, _I32, RLE),
                                       (4, _I32, RLE)]))
            usize, csize = usize + u, csize + c
            meta = [(1, _I32, phys), (2, _LIST, (_I32, encodings)),
                    (3, _LIST, (_BINARY, [name])), (4, _I32, codec), (5, _I64, n),
                    (6, _I64, usize), (7, _I64, csize), (9, _I64, data_off),
                    (11, _I64, dict_off)]
            chunks.append([(2, _I64, start), (3, _STRUCT, meta)])
            group_bytes += usize
        groups.append([(1, _LIST, (_STRUCT, chunks)), (2, _I64, group_bytes), (3, _I64, n),
                       (5, _I64, chunks[0][0][2] if chunks else len(out))])
    schema = [[(4, _BINARY, "duckdb_schema"), (5, _I32, len(names))]] + \
        [fields for fields, _ in elements]
    footer = bytearray()
    _w_struct(footer, [(1, _I32, 1), (2, _LIST, (_STRUCT, schema)), (3, _I64, nrows),
                       (4, _LIST, (_STRUCT, groups)), (6, _BINARY, "duckdb_tpu_torch")])
    out += footer
    out += struct.pack("<i", len(footer)) + MAGIC
    with open(path, "wb") as f:
        f.write(out)
