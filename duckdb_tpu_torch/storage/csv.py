"""CSV: the sniffer, the loader and the writer.

The JAX package's duckdb_tpu/storage/csv.py (DuckDB's CSV scanner and
sniffer, src/execution/operator/csv_scanner/): `sniff_csv` picks the
delimiter by field-count consistency over the first 200 lines and the
column types by trial parses over a sample (4 MiB, 2,048 rows), and tells
a header from the types too. It also sniffs TIMESTAMP, as DuckDB does.

The loader runs one tokenizer everywhere, the port's copy of the JAX
package's native csv2col (csrc/csv2col.cpp, built by storage/host_lib),
with DuckDB's NULL rule: an unquoted empty field is NULL, a quoted "" the
empty string. The JAX package's Python loader, which it runs when csv2col
is not built, reads both as NULL (ROADMAP I1). DECIMAL text is parsed
exactly in integer arithmetic, and a value that does not parse as its
column's type raises ConversionException naming its line, column and
type.

The writer formats whole columns in csv2col, not Result.rows() (a Python
loop): the bytes Python's csv.writer gives for the rows, but for the empty
string, which it writes as "" so that it does not read back as NULL
(ROADMAP I2).
"""

from __future__ import annotations

import csv as _csv
import ctypes
import datetime
import io
import os
import re
from typing import Dict, List, Tuple

import numpy as np

from duckdb_tpu_torch.errors import ConversionException
from duckdb_tpu_torch.planner.bound import not_ported
from duckdb_tpu_torch.storage import host_lib
from duckdb_tpu_torch.types import (
    BIGINT, BOOLEAN, DATE, DOUBLE, INTEGER, TIMESTAMP, VARCHAR, LogicalType, TypeId)

_DATE_RE = re.compile(r"^\d{4}-\d{2}-\d{2}$")
_TS_RE = re.compile(r"^\d{4}-\d{2}-\d{2}[ T]\d{2}:\d{2}(:\d{2}(\.\d+)?)?"
                    r"(Z|[+-]\d{2}(:?\d{2})?)?$")


def _is_int(s: str) -> bool:
    if not s:
        return False
    body = s[1:] if s[0] in "+-" else s
    return body.isdigit() and body.isascii() and -2**63 <= int(s) < 2**63


def _is_float(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def _is_date(s: str) -> bool:
    if not _DATE_RE.match(s):
        return False
    try:
        datetime.date.fromisoformat(s)
        return True
    except ValueError:
        return False


def _is_timestamp(s: str) -> bool:
    if not _TS_RE.match(s):
        return False
    try:
        datetime.datetime.fromisoformat(s)
        return True
    except ValueError:
        return False


def sniff_csv(path: str, sample_rows: int = 2048):
    """→ (delimiter, has_header, [(name, LogicalType)]) like DuckDB's
    sniff_csv table function."""
    with open(path, "r", errors="replace", encoding="utf-8-sig") as f:
        sample = f.read(4 << 20)
    lines = sample.splitlines()[: sample_rows + 1]
    # dialect: pick the delimiter with the most consistent field count > 1
    best = (",", -1)
    for delim in (",", "|", "\t", ";"):
        counts = {}
        for ln in lines[:200]:
            n = len(next(_csv.reader([ln], delimiter=delim), []))
            counts[n] = counts.get(n, 0) + 1
        if not counts:
            continue
        n, freq = max(counts.items(), key=lambda kv: kv[1])
        score = freq * (2 if n > 1 else 1)
        if n > 1 and score > best[1]:
            best = (delim, score)
    delim = best[0]
    rows = list(_csv.reader(io.StringIO("\n".join(lines)), delimiter=delim))
    if not rows:
        return delim, False, []
    ncol = max(len(r) for r in rows)

    def col_type(values):
        vals = [v for v in values if v != ""]
        if not vals:
            return VARCHAR
        if all(_is_int(v) for v in vals):
            return BIGINT if any(not -2**31 <= int(v) < 2**31 for v in vals) else INTEGER
        if all(_is_float(v) for v in vals):
            return DOUBLE
        if all(_is_date(v) for v in vals):
            return DATE
        if all(_is_timestamp(v) for v in vals):
            return TIMESTAMP
        if all(v.lower() in ("true", "false") for v in vals):
            return BOOLEAN
        return VARCHAR

    body_types = [col_type([r[i] for r in rows[1:] if i < len(r)]) for i in range(ncol)]
    header_cells = rows[0]
    # header detection: the first row is a header if its cells do NOT parse
    # as the column types inferred from the rest (DuckDB's sniffer heuristic)
    has_header = False
    for i, t in enumerate(body_types):
        cell = header_cells[i] if i < len(header_cells) else ""
        if t.id is not TypeId.VARCHAR and not _matches(cell, t):
            has_header = True
    if not has_header and all(t.id is TypeId.VARCHAR for t in body_types):
        # all-VARCHAR: a header if its cells look like identifiers
        has_header = all(c and not c[0].isdigit() for c in header_cells)
    names = ([c.strip() or f"column{i}" for i, c in enumerate(header_cells)]
             if has_header else [f"column{i:02d}" for i in range(ncol)])
    return delim, has_header, list(zip(names, body_types))


def _matches(cell: str, t: LogicalType) -> bool:
    if cell == "":
        return True
    if t.is_integer:
        return _is_int(cell)
    if t.id is TypeId.DOUBLE:
        return _is_float(cell)
    if t.id is TypeId.DATE:
        return _is_date(cell)
    if t.id is TypeId.TIMESTAMP:
        return _is_timestamp(cell)
    if t.id is TypeId.BOOLEAN:
        return cell.lower() in ("true", "false")
    return True


# csv2col's kinds (csrc/csv2col.cpp: enum Kind) and the numpy dtype each
# comes back in
_KIND = {TypeId.BOOLEAN: (0, np.bool_), TypeId.TINYINT: (1, np.int8),
         TypeId.SMALLINT: (2, np.int16), TypeId.INTEGER: (3, np.int32),
         TypeId.BIGINT: (4, np.int64), TypeId.HUGEINT: (4, np.int64),
         TypeId.FLOAT: (5, np.float32), TypeId.DOUBLE: (6, np.float64),
         TypeId.DATE: (7, np.int32), TypeId.TIMESTAMP: (8, np.int64),
         TypeId.DECIMAL: (9, np.int64), TypeId.VARCHAR: (10, np.int32),
         TypeId.TIMESTAMPTZ: (11, np.int64)}
_STR_KIND = 10


def _kind_of(t: LogicalType, what: str) -> Tuple[int, type]:
    kind = _KIND.get(t.id)
    if kind is None:
        raise not_ported(f"{what} of a {t!r} column (the flat types are ported)")
    return kind


def _lib():
    lib = host_lib.load("csv2col")
    if not getattr(lib, "_typed", False):
        c_ip = ctypes.POINTER(ctypes.c_int)
        lib.csv2col_read.argtypes = [ctypes.c_char_p, ctypes.c_int, c_ip, c_ip, c_ip,
                                     ctypes.c_char, ctypes.c_char, ctypes.c_int, ctypes.c_int]
        lib.csv2col_read.restype = ctypes.c_void_p
        lib.csv2col_error.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong),
                                      ctypes.POINTER(ctypes.c_int)]
        lib.csv2col_error.restype = ctypes.c_char_p
        lib.csv2col_rows.argtypes = [ctypes.c_void_p]
        lib.csv2col_rows.restype = ctypes.c_longlong
        lib.csv2col_nulls.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.csv2col_nulls.restype = ctypes.c_longlong
        lib.csv2col_fetch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                                      ctypes.c_void_p]
        lib.csv2col_dict_size.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                          ctypes.POINTER(ctypes.c_longlong)]
        lib.csv2col_dict_size.restype = ctypes.c_longlong
        lib.csv2col_dict.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                                     ctypes.c_void_p]
        lib.csv2col_free.argtypes = [ctypes.c_void_p]
        c_pp = ctypes.POINTER(ctypes.c_void_p)
        lib.csv2col_write.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_longlong,
                                      ctypes.c_int, c_ip, c_ip, c_pp, c_pp, c_pp, c_pp,
                                      ctypes.c_longlong, ctypes.c_char, ctypes.c_char_p,
                                      ctypes.c_int]
        lib.csv2col_write.restype = ctypes.c_int
        lib._typed = True
    return lib


def _ints(values) -> ctypes.Array:
    return (ctypes.c_int * max(len(values), 1))(*values)


def _one_char(value: str, what: str) -> bytes:
    b = value.encode()
    if len(b) != 1:
        raise ConversionException(f"the CSV {what} must be one byte, not {value!r}")
    return b


def _threads() -> int:
    return max(1, min(os.cpu_count() or 1, 16))


def load_csv(path: str, schema: List[Tuple[str, LogicalType]], delim: str,
             has_header: bool, quote: str = '"') -> Dict[str, tuple]:
    """→ {column: (values, validity|None, dictionary|None)} per `schema`,
    the values in each type's physical dtype."""
    lib = _lib()
    kinds = [_kind_of(t, "reading CSV") for _, t in schema]
    h = lib.csv2col_read(os.fsencode(path), len(schema), _ints([k for k, _ in kinds]),
                         _ints([t.scale for _, t in schema]),
                         _ints([t.width for _, t in schema]), _one_char(delim, "delimiter"),
                         _one_char(quote, "quote"), int(bool(has_header)), _threads())
    try:
        row, col = ctypes.c_longlong(), ctypes.c_int()
        err = lib.csv2col_error(h, ctypes.byref(row), ctypes.byref(col)).decode(
            "utf-8", "replace")
        if col.value >= 0:
            name, t = schema[col.value]
            line = row.value + 1 + int(bool(has_header))
            raise ConversionException(
                f'Could not convert string "{err}" to \'{t!r}\' in column "{name}", at line '
                f"{line} of {path}")
        if err:
            raise OSError(err)
        n = lib.csv2col_rows(h)
        out = {}
        for c, ((name, t), (kind, dtype)) in enumerate(zip(schema, kinds)):
            values = np.empty(n, dtype=dtype)
            valid = np.empty(n, dtype=np.uint8)
            lib.csv2col_fetch(h, c, host_lib.ptr(values), host_lib.ptr(valid))
            validity = valid.view(bool) if lib.csv2col_nulls(h, c) else None
            dvals = None
            if kind == _STR_KIND:
                nbytes = ctypes.c_longlong()
                size = lib.csv2col_dict_size(h, c, ctypes.byref(nbytes))
                offs = np.empty(size + 1, dtype=np.int64)
                blob = ctypes.create_string_buffer(max(nbytes.value, 1))
                lib.csv2col_dict(h, c, host_lib.ptr(offs), blob)
                dvals = host_lib.decode_strings(blob.raw[:nbytes.value], offs)
            else:
                values = values.astype(t.np_dtype, copy=False)
            out[name] = (values, validity, dvals)
        return out
    finally:
        lib.csv2col_free(h)


def parse_decimal_text(c: str, scale: int) -> int:
    """Exact decimal text → scaled int (integer arithmetic, the first
    dropped digit rounding half away from zero), as csv2col parses it."""
    c = c.strip()
    neg = c.startswith("-")
    if c and c[0] in "+-":
        c = c[1:]
    if "e" in c or "E" in c:  # scientific notation: exact via Decimal
        import decimal as pydec

        v = int(pydec.Decimal(c).scaleb(scale).to_integral_value(
            rounding=pydec.ROUND_HALF_UP))
        return -v if neg else v
    whole, _, frac = c.partition(".")
    v = int((whole or "0") + (frac + "0" * scale)[:scale])
    if len(frac) > scale and frac[scale] >= "5":
        v += 1
    return -v if neg else v


# -- the writer -------------------------------------------------------------------------

def _quoted(s: str, delim: str, quote: str) -> str:
    """One field as csv.writer's QUOTE_MINIMAL writes it, but the empty
    string, which is quoted."""
    if s == "" or delim in s or quote in s or "\n" in s or "\r" in s:
        return quote + s.replace(quote, quote * 2) + quote
    return s


def _text_column(vals, valid, dvals, t, n) -> Tuple[np.ndarray, np.ndarray]:
    """A column csv2col does not format: each distinct value as the text
    csv.writer writes for its Python value → (codes, dictionary of str)."""
    from duckdb_tpu_torch.execution.executor import Result

    if dvals is not None:  # a dictionary column: one value a dictionary entry
        vals = np.asarray(vals)
        uniq = Result([""], [t], [(np.arange(len(dvals), dtype=np.int32), None, dvals)],
                      len(dvals)).rows()
        return vals, np.array([str(r[0]) for r in uniq], dtype=object)
    rows = Result([""], [t], [(vals, valid, None)], n).rows()
    texts = np.array(["" if r[0] is None else str(r[0]) for r in rows], dtype=object)
    uniq, codes = np.unique(texts.astype(str), return_inverse=True)
    return codes.astype(np.int32), uniq.astype(object)


def write_csv(path: str, names, types, columns, nrows: int, delim: str = ",",
              header: bool = True, quote: str = '"'):
    """Write a Result's columns as CSV: csv.writer's text for the same rows,
    with "" for the empty string."""
    lib = _lib()
    d, q = _one_char(delim, "delimiter").decode(), _one_char(quote, "quote").decode()
    keep = []  # the arrays the pointers below point into
    kinds, scales, vptrs, valids, doffs, dblobs = [], [], [], [], [], []
    for (vals, valid, dvals), t in zip(columns, types):
        kind = _KIND.get(t.id)
        vals = np.asarray(vals)[:nrows]
        if kind is not None and t.id is not TypeId.VARCHAR and vals.dtype != object:
            kind, dtype = kind
            vals = np.ascontiguousarray(vals, dtype=dtype)
            dp = bp = None
        else:
            if t.id is TypeId.VARCHAR:
                codes, texts = vals, (dvals if dvals is not None else np.array([""], object))
            else:
                codes, texts = _text_column(vals, valid, dvals, t, nrows)
            enc = [_quoted(str(s), d, q).encode("utf-8") for s in texts]
            offs = np.zeros(len(enc) + 1, dtype=np.int64)
            np.cumsum([len(e) for e in enc], out=offs[1:])
            blob = np.frombuffer(b"".join(enc) or b"\0", dtype=np.uint8)
            kind, vals = _STR_KIND, np.ascontiguousarray(codes, dtype=np.int32)
            keep += [offs, blob]
            dp, bp = host_lib.ptr(offs), host_lib.ptr(blob)
        vbytes = None
        if valid is not None:
            vbytes = np.ascontiguousarray(np.asarray(valid)[:nrows], dtype=np.uint8)
            keep.append(vbytes)
        keep.append(vals)
        kinds.append(kind)
        scales.append(t.scale)
        vptrs.append(host_lib.ptr(vals))
        valids.append(None if vbytes is None else host_lib.ptr(vbytes))
        doffs.append(dp)
        dblobs.append(bp)
    head = b""
    if header:
        head = (d.join(_quoted(str(n), d, q) for n in names) + "\r\n").encode("utf-8")
    ncol = len(kinds)
    arr = ctypes.c_void_p * max(ncol, 1)
    err = ctypes.create_string_buffer(512)
    rc = lib.csv2col_write(os.fsencode(path), head, len(head), ncol, _ints(kinds),
                           _ints(scales), arr(*vptrs), arr(*valids), arr(*doffs), arr(*dblobs),
                           nrows, d.encode(), err, len(err))
    if rc != 0:
        raise OSError(err.value.decode("utf-8", "replace"))
