"""Arrow and pandas interop, with no Arrow library: the Arrow C data and
stream interface.

The port of duckdb_tpu/api/arrow_interop.py. The JAX package builds
pyarrow objects; the machine with the card has no pyarrow, so the port
speaks Arrow's C interface instead (its structs ArrowSchema, ArrowArray
and ArrowArrayStream, handed over as PyCapsules by `__arrow_c_schema__`,
`__arrow_c_array__` and `__arrow_c_stream__`), as DuckDB's own
ArrowConverter does (src/common/arrow/). The structs are made, owned and
released by the host C++ library csrc/arrow_c.cpp; this module builds
their buffers from a Result's host planes with numpy, column by column,
and reads a producer's buffers back the same way.

- Export: `Result.arrow()` is an `ArrowTable`, `Result.fetch_record_batch(k)`
  an `ArrowBatchReader` of ceil(n / k) batches. Any consumer of the
  protocol takes them (`pyarrow.table(res.arrow())`, or the port's own
  `from_arrow`). Each type takes the JAX package's Arrow type: the integers
  as themselves, DOUBLE and FLOAT as float64, BOOLEAN bit-packed, VARCHAR
  as dictionary<int32, utf8> over the column's dictionary, DECIMAL as
  decimal128(width, scale) of the unscaled value, HUGEINT as
  decimal128(38, 0), DATE date32, TIMESTAMP timestamp[us], TIME
  time64[us], INTERVAL duration[us]. Beyond the JAX package, as DuckDB
  does: LIST and STRUCT as Arrow list and struct (the JAX package exports
  their dictionary codes), BLOB as binary and TIMESTAMPTZ as
  timestamp[us, UTC]. Another type raises.
- Import: `arrow_columns(obj)` reads any object with `__arrow_c_stream__`
  or `__arrow_c_array__`, every batch of it, into host planes, mapped as
  the JAX package's arrow_to_columns maps them (dictionary codes kept,
  strings dictionary-encoded), except where DuckDB differs: uint64 is
  HUGEINT (the JAX package wraps it), a decimal128 past int64 raises
  naming its column, list and struct are LIST and STRUCT, time and
  duration TIME and INTERVAL, binary BLOB. Another format raises, naming
  it.
- pandas: `result_df`, `df_columns` import pandas inside the call.
"""

from __future__ import annotations

import ctypes
import re
import threading
from typing import List, Optional

import numpy as np

from duckdb_tpu_torch.blocks.nested import (NESTED_IDS, encode_objects, host_pyvals, obj_array,
                                            physical_column)
from duckdb_tpu_torch.errors import ConversionException, InvalidInputException
from duckdb_tpu_torch.planner.bound import not_ported
from duckdb_tpu_torch.storage import host_lib
from duckdb_tpu_torch.types import (BIGINT, BLOB, BOOLEAN, DATE, DOUBLE, HUGEINT, INTEGER,
                                    INTERVAL, SQLNULL, TIME, TIMESTAMP, TIMESTAMPTZ, VARCHAR,
                                    LogicalType, TypeId, decimal, list_of, struct_of)

# -- the structs, as ctypes reads them ---------------------------------------------------


class ArrowSchemaC(ctypes.Structure):
    _fields_ = [("format", ctypes.c_char_p), ("name", ctypes.c_char_p),
                ("metadata", ctypes.c_void_p), ("flags", ctypes.c_int64),
                ("n_children", ctypes.c_int64), ("children", ctypes.POINTER(ctypes.c_void_p)),
                ("dictionary", ctypes.c_void_p), ("release", ctypes.c_void_p),
                ("private_data", ctypes.c_void_p)]


class ArrowArrayC(ctypes.Structure):
    _fields_ = [("length", ctypes.c_int64), ("null_count", ctypes.c_int64),
                ("offset", ctypes.c_int64), ("n_buffers", ctypes.c_int64),
                ("n_children", ctypes.c_int64), ("buffers", ctypes.POINTER(ctypes.c_void_p)),
                ("children", ctypes.POINTER(ctypes.c_void_p)), ("dictionary", ctypes.c_void_p),
                ("release", ctypes.c_void_p), ("private_data", ctypes.c_void_p)]


NULLABLE = 2  # ARROW_FLAG_NULLABLE
_SCHEMA, _ARRAY, _STREAM = 0, 1, 2
_lock = threading.Lock()
_lib_handle = None


def library() -> ctypes.CDLL:
    """csrc/arrow_c.cpp, built at first use and loaded with its signatures."""
    global _lib_handle
    with _lock:
        if _lib_handle is not None:
            return _lib_handle
        lib = host_lib.load("arrow_c")
        vp, i64 = ctypes.c_void_p, ctypes.c_int64
        for name, args, res in (
                ("arrowc_live", [], ctypes.c_long),
                ("arrowc_capsule_name", [ctypes.c_int], vp),
                ("arrowc_capsule_destructor", [ctypes.c_int], vp),
                ("arrowc_schema_new", [ctypes.c_char_p, ctypes.c_char_p, i64, i64], vp),
                ("arrowc_schema_set_child", [vp, i64, vp], None),
                ("arrowc_schema_set_dictionary", [vp, vp], None),
                ("arrowc_array_new", [i64, i64, i64, i64], vp),
                ("arrowc_array_set_buffer", [vp, i64, vp, i64], ctypes.c_int),
                ("arrowc_array_set_child", [vp, i64, vp], None),
                ("arrowc_array_set_dictionary", [vp, vp], None),
                ("arrowc_stream_new", [vp], vp),
                ("arrowc_stream_push", [vp, vp], None),
                ("arrowc_schema_take", [vp], vp),
                ("arrowc_array_take", [vp], vp),
                ("arrowc_stream_take", [vp], vp),
                ("arrowc_stream_get_schema", [vp, ctypes.POINTER(vp)], ctypes.c_int),
                ("arrowc_stream_get_next", [vp, ctypes.POINTER(vp)], ctypes.c_int),
                ("arrowc_stream_error", [vp], ctypes.c_char_p),
                ("arrowc_schema_free", [vp], None),
                ("arrowc_array_free", [vp], None),
                ("arrowc_stream_free", [vp], None)):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
        _lib_handle = lib
        return lib


def live_structs() -> int:
    """The structs this library made and nobody has released yet."""
    return library().arrowc_live()


_py = ctypes.pythonapi
_py.PyCapsule_New.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
_py.PyCapsule_New.restype = ctypes.py_object
_py.PyCapsule_GetPointer.argtypes = [ctypes.py_object, ctypes.c_char_p]
_py.PyCapsule_GetPointer.restype = ctypes.c_void_p
_py.PyCapsule_IsValid.argtypes = [ctypes.py_object, ctypes.c_char_p]
_py.PyCapsule_IsValid.restype = ctypes.c_int


def _capsule(ptr: int, kind: int):
    """A capsule owning a struct of this library: its destructor releases
    the struct unless a consumer moved it out."""
    lib = library()
    return _py.PyCapsule_New(ptr, lib.arrowc_capsule_name(kind),
                             lib.arrowc_capsule_destructor(kind))


_CAPSULE_NAMES = (b"arrow_schema", b"arrow_array", b"arrow_array_stream")


def _capsule_pointer(cap, kind: int) -> int:
    if not _py.PyCapsule_IsValid(cap, _CAPSULE_NAMES[kind]):
        raise InvalidInputException(f"expected an Arrow PyCapsule named "
                                    f"{_CAPSULE_NAMES[kind].decode()}")
    return _py.PyCapsule_GetPointer(cap, _CAPSULE_NAMES[kind])


# -- export ------------------------------------------------------------------------------

class _Node:
    """One Arrow array and its field, on the host: numpy buffers, children
    and a dictionary, to be copied into the C structs."""

    __slots__ = ("format", "name", "length", "null_count", "buffers", "children", "dictionary")

    def __init__(self, fmt: str, name: str, length: int, null_count: int, buffers,
                 children=(), dictionary=None):
        self.format, self.name, self.length = fmt, name, length
        self.null_count, self.buffers = null_count, list(buffers)
        self.children, self.dictionary = list(children), dictionary

    def schema(self) -> int:
        lib = library()
        s = lib.arrowc_schema_new(self.format.encode(), self.name.encode(), NULLABLE,
                                  len(self.children))
        for i, c in enumerate(self.children):
            lib.arrowc_schema_set_child(s, i, c.schema())
        if self.dictionary is not None:
            lib.arrowc_schema_set_dictionary(s, self.dictionary.schema())
        return s

    def array(self) -> int:
        lib = library()
        a = lib.arrowc_array_new(self.length, self.null_count, len(self.buffers),
                                 len(self.children))
        for i, b in enumerate(self.buffers):
            if b is None:
                lib.arrowc_array_set_buffer(a, i, None, 0)
            else:
                b = np.ascontiguousarray(b)
                if lib.arrowc_array_set_buffer(a, i, b.ctypes.data, b.nbytes) != 0:
                    lib.arrowc_array_free(a)
                    raise MemoryError("arrow_c: a buffer could not be allocated")
        for i, c in enumerate(self.children):
            lib.arrowc_array_set_child(a, i, c.array())
        if self.dictionary is not None:
            lib.arrowc_array_set_dictionary(a, self.dictionary.array())
        return a


def _bitmap(valid: Optional[np.ndarray], n: int):
    """(validity buffer or None, null count)."""
    if valid is None:
        return None, 0
    valid = np.asarray(valid, dtype=bool)[:n]
    nulls = int(n - np.count_nonzero(valid))
    if not nulls:
        return None, 0
    return np.packbits(valid, bitorder="little"), nulls


def _utf8(name: str, blobs: List[bytes], valid=None) -> _Node:
    """A utf8 array of already-encoded values."""
    lens = np.fromiter(map(len, blobs), dtype=np.int64, count=len(blobs))
    offs = np.zeros(len(blobs) + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    fmt = "u" if offs[-1] < 2**31 else "U"
    bitmap, nulls = _bitmap(valid, len(blobs))
    return _Node(fmt, name, len(blobs), nulls,
                 [bitmap, offs.astype(np.int32 if fmt == "u" else np.int64),
                  np.frombuffer(b"".join(blobs), dtype=np.uint8)])


def _gathered_utf8(name: str, dvals, codes: np.ndarray, valid, binary: bool = False) -> _Node:
    """A utf8 (or binary) array of dvals[codes]: each distinct value encoded
    once, then every row's bytes gathered with numpy."""
    enc = [bytes(v) if binary else str(v).encode() for v in dvals] or [b""]
    dlens = np.fromiter(map(len, enc), dtype=np.int64, count=len(enc))
    dstart = np.zeros(len(enc) + 1, dtype=np.int64)
    np.cumsum(dlens, out=dstart[1:])
    blob = np.frombuffer(b"".join(enc), dtype=np.uint8)
    codes = np.clip(np.asarray(codes, dtype=np.int64), 0, len(enc) - 1)
    lens = dlens[codes]
    if valid is not None:
        lens = np.where(valid, lens, 0)
    offs = np.zeros(len(codes) + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    pos = np.repeat(dstart[codes] - offs[:-1], lens) + np.arange(offs[-1], dtype=np.int64)
    fmt = ("z" if binary else "u") if offs[-1] < 2**31 else ("Z" if binary else "U")
    bitmap, nulls = _bitmap(valid, len(codes))
    return _Node(fmt, name, len(codes), nulls,
                 [bitmap, offs.astype(np.int32 if fmt in "uz" else np.int64), blob[pos]])


def _decimal128(vals: np.ndarray) -> np.ndarray:
    """Unscaled integers (int64, or Python ints past it) → (n, 2) int64
    little-endian halves of each 128-bit two's complement value."""
    pair = np.empty((len(vals), 2), dtype="<i8")
    if vals.dtype == object:
        ints = [0 if v is None else int(v) for v in vals]
        pair[:, 0] = np.array([v & ((1 << 64) - 1) for v in ints], dtype=np.uint64).view(np.int64)
        pair[:, 1] = np.array([v >> 64 for v in ints], dtype=np.int64)
    else:
        ints = vals.astype(np.int64)
        pair[:, 0] = ints
        pair[:, 1] = ints >> 63
    return pair


_FIXED = {  # flat type id → (Arrow format, numpy dtype of the values buffer)
    TypeId.TINYINT: ("c", np.int8), TypeId.SMALLINT: ("s", np.int16),
    TypeId.INTEGER: ("i", np.int32), TypeId.BIGINT: ("l", np.int64),
    TypeId.FLOAT: ("g", np.float64), TypeId.DOUBLE: ("g", np.float64),
    TypeId.DATE: ("tdD", np.int32), TypeId.TIMESTAMP: ("tsu:", np.int64),
    TypeId.TIMESTAMPTZ: ("tsu:UTC", np.int64), TypeId.TIME: ("ttu", np.int64),
    TypeId.INTERVAL: ("tDu", np.int64),
}


def export_column(vals, valid, dvals, t: LogicalType, name: str) -> _Node:
    """One column's host planes (n rows) → its Arrow node."""
    vals = np.asarray(vals)
    n = len(vals)
    if valid is not None:
        valid = np.asarray(valid, dtype=bool)[:n]
    tid = t.id
    bitmap, nulls = _bitmap(valid, n)
    if tid in _FIXED:
        fmt, dt = _FIXED[tid]
        return _Node(fmt, name, n, nulls, [bitmap, vals.astype(dt)])
    if tid is TypeId.BOOLEAN:
        return _Node("b", name, n, nulls,
                     [bitmap, np.packbits(vals.astype(bool), bitorder="little")])
    if tid in (TypeId.DECIMAL, TypeId.HUGEINT):
        fmt = "d:38,0" if tid is TypeId.HUGEINT else f"d:{max(t.width or 18, 1)},{t.scale or 0}"
        return _Node(fmt, name, n, nulls, [bitmap, _decimal128(vals)])
    if tid is TypeId.VARCHAR:
        # dictionary<int32, utf8> over the column's dictionary, as the JAX
        # package exports it
        if dvals is None or not len(dvals):
            dvals = np.array([""], dtype=object)
        codes = np.clip(vals.astype(np.int32), 0, len(dvals) - 1)
        return _Node("i", name, n, nulls, [bitmap, codes],
                     dictionary=_gathered_utf8("", dvals, np.arange(len(dvals)), None))
    if tid is TypeId.BLOB:
        return _gathered_utf8(name, dvals if dvals is not None else [b""], vals, valid,
                              binary=True)
    if tid is TypeId.SQLNULL:
        return _Node("n", name, n, n, [])
    if tid in (TypeId.LIST, TypeId.STRUCT):
        return _export_nested(vals, valid, dvals, t, name)
    raise not_ported(f"exporting a {t!r} column to Arrow (ROADMAP item 35b exports the flat "
                     "types, LIST and STRUCT)")


def _export_nested(codes, valid, dvals, t: LogicalType, name: str) -> _Node:
    """A LIST or STRUCT column: its entries' elements flattened per row
    (each distinct entry's elements gathered by the row's code)."""
    n = len(codes)
    entries = dvals if dvals is not None and len(dvals) else obj_array([()])
    codes = np.clip(np.asarray(codes, dtype=np.int64), 0, len(entries) - 1)
    ok = np.ones(n, bool) if valid is None else valid
    bitmap, nulls = _bitmap(valid, n)
    if t.id is TypeId.LIST:
        dlens = np.fromiter((0 if e is None else len(e) for e in entries), dtype=np.int64,
                            count=len(entries))
        dstart = np.zeros(len(entries) + 1, dtype=np.int64)
        np.cumsum(dlens, out=dstart[1:])
        flat = obj_array([x for e in entries if e is not None for x in e])
        lens = np.where(ok, dlens[codes], 0)
        offs = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(lens, out=offs[1:])
        pos = np.repeat(dstart[codes] - offs[:-1], lens) + np.arange(offs[-1], dtype=np.int64)
        child = _child_node(list(flat[pos]) if len(pos) else [], t.child, "item")
        fmt = "+l" if offs[-1] < 2**31 else "+L"
        return _Node(fmt, name, n, nulls,
                     [bitmap, offs.astype(np.int32 if fmt == "+l" else np.int64)], [child])
    children = []
    for i, (fname, ft) in enumerate(t.fields or ()):
        per_entry = obj_array([None if e is None or len(e) <= i else e[i] for e in entries])
        vals = per_entry[codes]
        vals[~ok] = None
        children.append(_child_node(list(vals), ft, fname))
    return _Node("+s", name, n, nulls, [bitmap], children)


def _child_node(pyvals: list, t: LogicalType, name: str) -> _Node:
    """A nested column's elements (Python values) → their Arrow node; text
    as plain utf8 (DuckDB's list<varchar>), not a dictionary."""
    if t is None:
        t = VARCHAR
    data, valid, dvals = physical_column(pyvals, t)
    if t.id is TypeId.VARCHAR:
        return _gathered_utf8(name, dvals, data, valid)
    return export_column(data, valid, dvals, t, name)


def _columns_node(res, lo: int, hi: int, schema_only: bool = False) -> _Node:
    """Rows [lo, hi) of a Result as one struct array: a record batch
    (`schema_only`: its fields alone, no dictionary values built)."""
    children = []
    for name, t, (vals, valid, dvals) in zip(res.names, res.types, res.columns):
        v = np.asarray(vals)[lo:hi]
        ok = None if valid is None else np.asarray(valid)[lo:hi]
        if schema_only and t.id in (TypeId.VARCHAR, TypeId.BLOB):
            dvals = None
        children.append(export_column(v, ok, dvals, t, name))
    return _Node("+s", "", hi - lo, 0, [None], children)


class ArrowField:
    """A field of an export's schema: its name and Arrow format string."""

    __slots__ = ("name", "format")

    def __init__(self, name: str, fmt: str):
        self.name, self.format = name, fmt

    def __repr__(self) -> str:
        return f"ArrowField({self.name!r}, {self.format!r})"


class _Export:
    """A Result's rows in batches of `rows_per_batch` (all in one where
    None), exported through the Arrow C stream interface."""

    def __init__(self, res, rows_per_batch: Optional[int]):
        self._res = res
        self.num_rows = int(res.nrows)
        if rows_per_batch is not None and rows_per_batch < 1:
            raise InvalidInputException("rows_per_batch must be at least 1")
        self._step = rows_per_batch
        self.column_names = list(res.names)
        # the schema of an empty slice: each column's type, with no rows
        empty = _columns_node(res, 0, 0, schema_only=True)
        self.schema = [ArrowField(c.name, c.format) for c in empty.children]
        self._schema_node = empty

    def _bounds(self):
        if self._step is None:
            return [(0, self.num_rows)] if self.num_rows else []
        return [(lo, min(lo + self._step, self.num_rows))
                for lo in range(0, self.num_rows, self._step)]

    @property
    def num_batches(self) -> int:
        return len(self._bounds())

    def __arrow_c_schema__(self):
        return _capsule(self._schema_node.schema(), _SCHEMA)

    def __arrow_c_stream__(self, requested_schema=None):
        if requested_schema is not None:
            raise not_ported("an Arrow export cast to a requested schema")
        lib = library()
        stream = lib.arrowc_stream_new(self._schema_node.schema())
        cap = _capsule(stream, _STREAM)  # owns the stream from here on
        for lo, hi in self._bounds():
            lib.arrowc_stream_push(stream, _columns_node(self._res, lo, hi).array())
        return cap


class ArrowTable(_Export):
    """`Result.arrow()`: the result as an Arrow table, through Arrow's C
    stream interface (one batch). `pyarrow.table(t)` and any other consumer
    of the protocol take it; so does `Connection.from_arrow`."""

    def __init__(self, res):
        super().__init__(res, None)

    def __repr__(self) -> str:
        return f"ArrowTable({self.num_rows} rows, {self.schema})"


class ArrowBatchReader(_Export):
    """`Result.fetch_record_batch(k)`: the result as a stream of
    ceil(n / k) record batches of k rows (the last shorter)."""

    def __repr__(self) -> str:
        return f"ArrowBatchReader({self.num_rows} rows in {self.num_batches} batches)"


# -- import ------------------------------------------------------------------------------

def _buf(arr: ArrowArrayC, i: int) -> int:
    return arr.buffers[i] if arr.n_buffers > i else None


def _view(ptr: int, dtype, start: int, count: int) -> np.ndarray:
    """A copy of `count` values of `dtype` from a producer's buffer, from
    element `start`."""
    dt = np.dtype(dtype)
    if count <= 0 or not ptr:
        return np.zeros(max(count, 0), dtype=dt)
    raw = (ctypes.c_char * ((start + count) * dt.itemsize)).from_address(ptr)
    return np.frombuffer(raw, dtype=dt, count=count, offset=start * dt.itemsize).copy()


def _bits(ptr: int, start: int, count: int) -> np.ndarray:
    """`count` bits of a bitmap from bit `start`, as bools."""
    if count <= 0:
        return np.zeros(0, dtype=bool)
    nbytes = (start + count + 7) // 8
    raw = np.frombuffer((ctypes.c_char * nbytes).from_address(ptr), dtype=np.uint8)
    return np.unpackbits(raw, bitorder="little")[start:start + count].astype(bool)


def _validity(arr: ArrowArrayC, start: int, n: int) -> Optional[np.ndarray]:
    if arr.null_count == 0 or not _buf(arr, 0):
        return None
    valid = _bits(_buf(arr, 0), start, n)
    return None if valid.all() else valid


_INT_FORMATS = {"c": np.int8, "C": np.uint8, "s": np.int16, "S": np.uint16, "i": np.int32,
                "I": np.uint32, "l": np.int64, "L": np.uint64}
_UNIT_MICROS = {"s": 1_000_000, "m": 1_000, "u": 1, "n": None}


def _micros(raw: np.ndarray, unit: str) -> np.ndarray:
    v = raw.astype(np.int64)
    if unit == "n":
        return np.floor_divide(v, 1000)
    return v * _UNIT_MICROS[unit]


def _spans(arr: ArrowArrayC, start: int, n: int, large: bool):
    """(blob, int64 offsets from 0) of n variable-length values."""
    offs = _view(_buf(arr, 1), np.int64 if large else np.int32, start, n + 1).astype(np.int64)
    if not n:
        return np.zeros(0, np.uint8), np.zeros(1, np.int64)
    blob = _view(_buf(arr, 2), np.uint8, int(offs[0]), int(offs[-1] - offs[0]))
    return blob, offs - offs[0]


def _import_column(schema: ArrowSchemaC, arr: ArrowArrayC, column: str, start: int = 0,
                   n: Optional[int] = None):
    """One Arrow array (rows [start, start + n) past its offset) → (ltype,
    values, validity|None, dictionary|None) host planes."""
    from duckdb_tpu_torch.storage.parquet import strings_dictionary

    fmt = schema.format.decode()
    n = arr.length - start if n is None else n
    at = arr.offset + start
    valid = _validity(arr, at, n)
    if schema.dictionary:
        return _import_dictionary(schema, arr, column, at, n, valid)
    if fmt in _INT_FORMATS:
        raw = _view(_buf(arr, 1), _INT_FORMATS[fmt], at, n)
        if fmt == "L":  # uint64: HUGEINT holds it exactly
            return HUGEINT, raw.astype(object), valid, None
        if fmt in ("l", "I"):  # int64, and uint32 past INTEGER
            return BIGINT, raw.astype(np.int64), valid, None
        return INTEGER, raw.astype(np.int32), valid, None
    if fmt in ("e", "f", "g"):
        dt = {"e": np.float16, "f": np.float32, "g": np.float64}[fmt]
        return DOUBLE, _view(_buf(arr, 1), dt, at, n).astype(np.float64), valid, None
    if fmt == "b":
        return BOOLEAN, _bits(_buf(arr, 1), at, n), valid, None
    if fmt == "n":
        return SQLNULL, np.zeros(n, np.int32), np.zeros(n, bool), None
    if fmt == "tdD":
        return DATE, _view(_buf(arr, 1), np.int32, at, n), valid, None
    if fmt == "tdm":
        ms = _view(_buf(arr, 1), np.int64, at, n)
        return DATE, np.floor_divide(ms, 86_400_000).astype(np.int32), valid, None
    m = re.fullmatch(r"ts([smun]):(.*)", fmt)
    if m:
        t = TIMESTAMPTZ if m.group(2) else TIMESTAMP
        return t, _micros(_view(_buf(arr, 1), np.int64, at, n), m.group(1)), valid, None
    if fmt in ("tts", "ttm", "ttu", "ttn"):
        dt = np.int32 if fmt in ("tts", "ttm") else np.int64
        return TIME, _micros(_view(_buf(arr, 1), dt, at, n), fmt[2]), valid, None
    if fmt in ("tDs", "tDm", "tDu", "tDn"):
        return INTERVAL, _micros(_view(_buf(arr, 1), np.int64, at, n), fmt[2]), valid, None
    if fmt in ("u", "U", "z", "Z"):
        blob, offs = _spans(arr, at, n, fmt in ("U", "Z"))
        codes, dvals = strings_dictionary(blob, offs, raw=fmt in ("z", "Z"))
        return (VARCHAR if fmt in ("u", "U") else BLOB), codes, valid, dvals
    m = re.fullmatch(r"d:(\d+),(\d+)(,128)?", fmt)
    if m:
        width, scale = int(m.group(1)), int(m.group(2))
        pair = _view(_buf(arr, 1), np.int64, 2 * at, 2 * n).reshape(n, 2)
        lo, hi = pair[:, 0], pair[:, 1]
        bad = (hi != (lo >> 63)) if valid is None else (hi != (lo >> 63)) & valid
        if bad.any():
            raise ConversionException(
                f'Arrow column "{column}" holds a DECIMAL({width},{scale}) value past the 18 '
                "digits the port's DECIMAL keeps in int64")
        return decimal(width, scale), lo.copy(), valid, None
    if fmt in ("+l", "+L"):
        return _import_list(schema, arr, column, at, n, valid, fmt == "+L")
    if fmt == "+s":
        return _import_struct(schema, arr, column, at, n, valid)
    raise not_ported(f'importing the Arrow column "{column}" of format "{fmt}"')


def _pyvals(t: LogicalType, vals, valid, dvals) -> list:
    if t.id is TypeId.HUGEINT and vals.dtype == object:
        out = list(vals)
        if valid is not None:
            out = [None if not ok else v for v, ok in zip(out, valid)]
        return out
    return host_pyvals(vals, valid, dvals, t)


def _import_list(schema, arr, column, at, n, valid, large):
    offs = _view(_buf(arr, 1), np.int64 if large else np.int32, at, n + 1).astype(np.int64)
    cs = ArrowSchemaC.from_address(schema.children[0])
    ca = ArrowArrayC.from_address(arr.children[0])
    lo = int(offs[0]) if n else 0
    total = int(offs[-1] - offs[0]) if n else 0
    ct, cvals, cvalid, cdvals = _import_column(cs, ca, column, lo, total)
    elems = _pyvals(ct, cvals, cvalid, cdvals)
    rel = (offs - lo).tolist()
    entries = [tuple(elems[a:b]) for a, b in zip(rel[:-1], rel[1:])]
    if valid is not None:
        entries = [() if not ok else e for e, ok in zip(entries, valid)]
    codes, dvals = encode_objects(entries)
    return list_of(ct), codes, valid, dvals


def _import_struct(schema, arr, column, at, n, valid):
    fields, cols = [], []
    for i in range(schema.n_children):
        cs = ArrowSchemaC.from_address(schema.children[i])
        ca = ArrowArrayC.from_address(arr.children[i])
        ct, cvals, cvalid, cdvals = _import_column(cs, ca, column, at, n)
        fields.append((cs.name.decode(), ct))
        cols.append(_pyvals(ct, cvals, cvalid, cdvals))
    entries = [tuple(c[r] for c in cols) for r in range(n)]
    if valid is not None:
        entries = [() if not ok else e for e, ok in zip(entries, valid)]
    codes, dvals = encode_objects(entries)
    return struct_of(*fields), codes, valid, dvals


def _import_dictionary(schema, arr, column, at, n, valid):
    """A dictionary-encoded array: text keeps its codes (into a sorted
    dictionary of the values); another value type is gathered by code."""
    ifmt = schema.format.decode()
    if ifmt not in _INT_FORMATS:
        raise not_ported(f'importing the Arrow column "{column}" of dictionary index '
                         f'format "{ifmt}"')
    idx = _view(_buf(arr, 1), _INT_FORMATS[ifmt], at, n).astype(np.int64)
    ds = ArrowSchemaC.from_address(schema.dictionary)
    da = ArrowArrayC.from_address(arr.dictionary)
    dt, dvals_, dvalid, ddict = _import_column(ds, da, column)
    nd = max(len(dvals_), 1)
    idx = np.clip(idx, 0, nd - 1)
    if dvalid is not None and len(dvalid):  # a NULL dictionary entry is a NULL row
        hit = dvalid[idx]
        valid = hit if valid is None else valid & hit
    if dt.id in (TypeId.VARCHAR, TypeId.BLOB) or dt.id in NESTED_IDS:
        codes = dvals_[idx] if len(dvals_) else np.zeros(n, np.int32)
        return dt, codes.astype(np.int32), valid, ddict
    return dt, dvals_[idx] if len(dvals_) else np.zeros(n, dvals_.dtype), valid, None


def _take_stream(obj):
    """A stream of the object's batches (this library's shell owning it)."""
    lib = library()
    if hasattr(obj, "__arrow_c_stream__"):
        cap = obj.__arrow_c_stream__()
        return lib.arrowc_stream_take(_capsule_pointer(cap, _STREAM)), None
    if hasattr(obj, "__arrow_c_array__"):
        scap, acap = obj.__arrow_c_array__()
        return None, (lib.arrowc_schema_take(_capsule_pointer(scap, _SCHEMA)),
                      lib.arrowc_array_take(_capsule_pointer(acap, _ARRAY)))
    raise InvalidInputException(
        f"from_arrow takes an object with __arrow_c_stream__ or __arrow_c_array__ (a table, "
        f"a record batch, a reader), not {type(obj).__name__}")


def arrow_columns(obj):
    """Any Arrow object of the PyCapsule protocol → ([(name, ltype, values,
    validity|None, dictionary|None)], rows), every batch read."""
    from duckdb_tpu_torch.storage.multi_file import concat_parts

    lib = library()
    stream, single = _take_stream(obj)
    batches, schema_ptr = [], None
    try:
        if stream is not None:
            sp = ctypes.c_void_p()
            rc = lib.arrowc_stream_get_schema(stream, ctypes.byref(sp))
            schema_ptr = sp.value
            if rc:
                raise InvalidInputException(f"Arrow stream: get_schema failed ({rc}): "
                                            f"{lib.arrowc_stream_error(stream)}")
            while True:
                ap = ctypes.c_void_p()
                rc = lib.arrowc_stream_get_next(stream, ctypes.byref(ap))
                if rc:
                    lib.arrowc_array_free(ap.value)
                    raise InvalidInputException(f"Arrow stream: get_next failed ({rc}): "
                                                f"{lib.arrowc_stream_error(stream)}")
                if not ArrowArrayC.from_address(ap.value).release:
                    lib.arrowc_array_free(ap.value)
                    break
                batches.append(ap.value)
        else:
            schema_ptr, batch = single
            batches.append(batch)
        schema = ArrowSchemaC.from_address(schema_ptr)
        if schema.format.decode() != "+s":
            raise not_ported(f'importing an Arrow stream of format "{schema.format.decode()}" '
                             "(a record batch is a struct array)")
        names = [ArrowSchemaC.from_address(schema.children[i]).name.decode()
                 for i in range(schema.n_children)]
        parts = [[] for _ in names]
        types: List[Optional[LogicalType]] = [None] * len(names)
        lens = []
        for b in batches:
            arr = ArrowArrayC.from_address(b)
            lens.append(arr.length)
            for i, name in enumerate(names):
                cs = ArrowSchemaC.from_address(schema.children[i])
                ca = ArrowArrayC.from_address(arr.children[i])
                t, vals, valid, dvals = _import_column(cs, ca, name, arr.offset, arr.length)
                types[i] = t
                parts[i].append((vals, valid, dvals))
        if not batches:  # no rows: each column's type from an empty import
            types = [_empty_type(ArrowSchemaC.from_address(schema.children[i]), names[i])
                     for i in range(len(names))]
        out = []
        for name, t, ps in zip(names, types, parts):
            vals, valid, dvals = concat_parts(ps, lens, t) if ps else \
                (np.zeros(0, object if t.id is TypeId.HUGEINT else t.np_dtype), None,
                 np.array([""], dtype=object) if t.id is TypeId.VARCHAR else None)
            out.append((name, t, vals, valid, dvals))
        return out, int(sum(lens))
    finally:
        for b in batches:
            lib.arrowc_array_free(b)
        lib.arrowc_schema_free(schema_ptr)
        if stream is not None:
            lib.arrowc_stream_free(stream)


def _empty_type(schema: ArrowSchemaC, column: str) -> LogicalType:
    """A column's type from its schema alone, through an empty array of it."""
    fmt = schema.format.decode()
    if schema.dictionary:
        return _empty_type(ArrowSchemaC.from_address(schema.dictionary), column)
    empty = ArrowArrayC()
    zeros = (ctypes.c_int64 * 4)()
    bufs = (ctypes.c_void_p * 3)(None, ctypes.addressof(zeros), ctypes.addressof(zeros))
    empty.buffers = ctypes.cast(bufs, ctypes.POINTER(ctypes.c_void_p))
    empty.n_buffers = 3
    if fmt in ("+l", "+L"):
        return list_of(_empty_type(ArrowSchemaC.from_address(schema.children[0]), column))
    if fmt == "+s":
        return struct_of(*[(ArrowSchemaC.from_address(schema.children[i]).name.decode(),
                            _empty_type(ArrowSchemaC.from_address(schema.children[i]), column))
                           for i in range(schema.n_children)])
    return _import_column(schema, empty, column, 0, 0)[0]


# -- pandas ------------------------------------------------------------------------------

def _pandas(what: str):
    try:
        import pandas
    except ImportError:
        raise InvalidInputException(f"{what} needs the pandas package, which is not "
                                    "installed") from None
    return pandas


def result_df(res, what: str = "Result.df()"):
    """A pandas DataFrame of the result's rows, as the JAX package builds it."""
    pd = _pandas(what)
    return pd.DataFrame(res.rows(), columns=res.names)


def df_columns(df):
    """A pandas DataFrame → [(name, ltype, values, validity|None,
    dictionary|None)], mapped as the JAX package's from_df maps dtypes:
    integers BIGINT, floats DOUBLE, bool BOOLEAN, anything else VARCHAR
    text; NaN and None NULL."""
    pd = _pandas("from_df")
    if not isinstance(df, pd.DataFrame):
        raise InvalidInputException(f"from_df takes a pandas DataFrame, not {type(df).__name__}")
    out = []
    for cname in df.columns:
        series = df[cname]
        valid = series.notna().to_numpy()
        kind = series.dtype.kind
        if kind in ("i", "u"):
            t, vals, dvals = BIGINT, series.fillna(0).to_numpy(dtype=np.int64), None
        elif kind == "f":
            t, vals, dvals = DOUBLE, series.fillna(0.0).to_numpy(dtype=np.float64), None
        elif kind == "b":
            t, vals, dvals = BOOLEAN, series.fillna(False).to_numpy(dtype=bool), None
        else:
            strs = np.array([str(v) if ok else "" for v, ok in zip(series.tolist(), valid)],
                            dtype=object)
            uniq, codes = np.unique(strs.astype(str), return_inverse=True)
            t, vals, dvals = VARCHAR, codes.reshape(-1).astype(np.int32), uniq.astype(object)
        out.append((str(cname), t, vals, None if valid.all() else valid, dvals))
    return out, len(df)

