"""Values of the dictionary-coded nested types: LIST, ARRAY, STRUCT, MAP,
UNION and BIT.

A nested column is dictionary-encoded as VARCHAR is: the device holds an
int32 code per row and `Column.dict_values` holds the distinct values on
the host, each a Python value:
- LIST and ARRAY: a tuple of element values;
- STRUCT: a tuple of field values in field order;
- MAP: a tuple of (key, value) pairs;
- UNION: a (tag index, value) pair;
- BIT: a str of '0' and '1'.
An element value is the logical Python value of its type (int, float,
bool, str, decimal.Decimal, datetime.date, datetime.datetime, a nested
tuple), None for NULL.

Unlike a VARCHAR dictionary, which is kept sorted, a nested dictionary is
in first-seen order, so its codes are good for equality only. ORDER BY,
min/max, comparisons and join keys map codes to ranks first
(`rank_lut`, `merged_rank_luts`), which order as DuckDB orders nested
values: element by element, a shorter list before a longer one it
prefixes, and NULL after every value at nested levels.

This module converts between the device's physical values and these
Python values in whole columns (`host_pyvals`, `physical_column`), and
formats a nested value as DuckDB's VARCHAR cast does (`to_text`).
"""

from __future__ import annotations

import datetime
import decimal as pydec
import math
from typing import Optional

import numpy as np
import torch

from duckdb_tpu_torch.types import LogicalType, TypeId

NESTED_IDS = (TypeId.LIST, TypeId.ARRAY, TypeId.STRUCT, TypeId.MAP, TypeId.UNION)
# dictionary-coded types whose dictionary is in first-seen order
UNSORTED_DICT_IDS = NESTED_IDS + (TypeId.BIT,)

_EPOCH_DATE = datetime.date(1970, 1, 1)
_EPOCH = datetime.datetime(1970, 1, 1)
_EPOCH_UTC = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)


def obj_array(entries) -> np.ndarray:
    """An object ndarray of the entries (np.array would splat tuples into 2D)."""
    return np.fromiter(entries, dtype=object, count=len(entries))


def encode_objects(entries):
    """Hashable entries → (int32 codes, object dictionary in first-seen
    order). Entries compare as Python values: NaN != NaN gives separate
    entries, 0.0 == -0.0 (and 1 == 1.0) merge."""
    uniq = dict.fromkeys(entries)  # first-seen order
    index = dict(zip(uniq, range(len(uniq))))
    codes = np.fromiter(map(index.__getitem__, entries), dtype=np.int32, count=len(entries))
    return codes, obj_array(list(uniq))


# -- physical ↔ Python ----------------------------------------------------------
def scalar_py(v, t: LogicalType):
    """The Python value of one non-NULL physical value of a flat type."""
    tid = t.id
    if tid is TypeId.DECIMAL:
        return pydec.Decimal(int(v)).scaleb(-t.scale)
    if tid is TypeId.DATE:
        return _EPOCH_DATE + datetime.timedelta(days=int(v))
    if tid is TypeId.TIMESTAMP:
        return _EPOCH + datetime.timedelta(microseconds=int(v))
    if tid is TypeId.TIMESTAMPTZ:
        return _EPOCH_UTC + datetime.timedelta(microseconds=int(v))
    if tid is TypeId.TIME:
        us = int(v)
        return datetime.time(us // 3_600_000_000, us // 60_000_000 % 60,
                             us // 1_000_000 % 60, us % 1_000_000)
    if tid is TypeId.INTERVAL:
        return datetime.timedelta(microseconds=int(v))
    if tid is TypeId.BOOLEAN:
        return bool(v)
    if t.is_float:
        return float(v)
    return int(v)


def physical_of(v, t: LogicalType):
    """The physical value of one non-NULL Python value of a flat type
    (the inverse of scalar_py; a value already physical passes)."""
    tid = t.id
    if tid is TypeId.DECIMAL:
        return int(pydec.Decimal(v).scaleb(t.scale).to_integral_value(
            rounding=pydec.ROUND_HALF_UP))
    if tid is TypeId.DATE and isinstance(v, datetime.date):
        return (v - _EPOCH_DATE).days
    if tid in (TypeId.TIMESTAMP, TypeId.TIMESTAMPTZ) and isinstance(v, datetime.datetime):
        if v.tzinfo is not None:
            v = v.astimezone(datetime.timezone.utc).replace(tzinfo=None)
        d = v - _EPOCH
        return (d.days * 86_400 + d.seconds) * 1_000_000 + d.microseconds
    if tid is TypeId.TIME and isinstance(v, datetime.time):
        return ((v.hour * 60 + v.minute) * 60 + v.second) * 1_000_000 + v.microsecond
    if tid is TypeId.INTERVAL and isinstance(v, datetime.timedelta):
        return (v.days * 86_400 + v.seconds) * 1_000_000 + v.microseconds
    if tid is TypeId.BOOLEAN:
        return bool(v)
    if t.is_float:
        return float(v)
    return int(v)


def host_pyvals(data: np.ndarray, valid: Optional[np.ndarray], dvals,
                t: LogicalType, hi: Optional[np.ndarray] = None) -> list:
    """Physical values of one column on the host → Python values (None
    where not valid). Dictionary types index their dictionary; the kinds
    whose Python value costs an object each (DECIMAL, dates, times)
    convert once per distinct value. `hi` is a wide value's high plane
    (value = hi·2^64 + uint64(data))."""
    n = len(data)
    tid = t.id
    if hi is not None:
        wide = [int(h) * (1 << 64) + (int(lo) & ((1 << 64) - 1)) for h, lo in zip(hi, data)]
        out = obj_array([scalar_py(v, t) for v in wide])
    elif dvals is not None and (tid in (TypeId.VARCHAR, TypeId.BLOB) or tid in UNSORTED_DICT_IDS):
        out = dvals[np.clip(data, 0, max(len(dvals) - 1, 0))] if len(dvals) \
            else np.empty(n, dtype=object)
    elif tid is TypeId.SQLNULL:
        return [None] * n
    elif t.is_float:
        out = data.astype(np.float64).tolist()
    elif tid is TypeId.BOOLEAN:
        out = data.astype(bool).tolist()
    elif t.is_integer:
        out = data.astype(np.int64).tolist()
    else:
        uniq, inv = np.unique(data, return_inverse=True)
        out = obj_array([scalar_py(u, t) for u in uniq])[inv.reshape(-1)]
    if valid is not None and not valid.all():
        out = np.asarray(out, dtype=object) if isinstance(out, list) else out.astype(object)
        out[~valid] = None
    return out.tolist() if isinstance(out, np.ndarray) else out


def column_values(col, n: int) -> list:
    """The first n rows of a Column as Python values: one transfer of the
    data and one of the validity."""
    data = col.data.expand(n) if col.data.dim() == 0 else col.data
    data = data[:n].cpu().numpy() if data.shape[0] >= n else \
        data.expand(n).cpu().numpy()
    valid = None
    if col.validity is not None:
        v = col.validity
        valid = (v[:n] if v.shape[0] >= n else v.expand(n)).cpu().numpy()
    return host_pyvals(data, valid, col.dict_values, col.ltype)


def physical_column(vals, ct: LogicalType):
    """Python values (None for NULL) of type ct → (physical data, validity,
    dictionary or None) as numpy arrays. VARCHAR and BIT values get a
    sorted dictionary, nested values a first-seen one."""
    n = len(vals)
    tid = ct.id
    if tid in _FAST_IDS and None not in vals:  # no NULL among them: one conversion
        return np.array(vals, dtype=ct.np_dtype), np.ones(n, dtype=bool), None
    valid = np.fromiter((v is not None for v in vals), dtype=bool, count=n)
    if tid in (TypeId.VARCHAR, TypeId.BIT):
        strs = np.array([("" if v is None else str(v)) for v in vals], dtype=object)
        if not n:
            return np.zeros(0, np.int32), valid, np.array([""], dtype=object)
        uniq, inv = np.unique(strs.astype(str), return_inverse=True)
        return inv.reshape(-1).astype(np.int32), valid, uniq.astype(object)
    if tid in NESTED_IDS:
        codes, d = encode_objects([(() if v is None else v) for v in vals])
        return codes, valid, d
    if tid is TypeId.SQLNULL:
        return np.zeros(n, np.int32), valid, None
    data = np.array([0 if v is None else physical_of(v, ct) for v in vals],
                    dtype=ct.np_dtype)
    return data, valid, None


_FAST_IDS = (TypeId.BIGINT, TypeId.INTEGER, TypeId.SMALLINT, TypeId.TINYINT, TypeId.DOUBLE,
             TypeId.FLOAT, TypeId.BOOLEAN)


def lut_column(vals, ct: LogicalType, device):
    """Per-entry Python values → a Column of them on `device` (a LUT that
    a gather by code turns into a column)."""
    from duckdb_tpu_torch.blocks.column import Column

    data, valid, dvals = physical_column(vals, ct)
    if not len(data):
        data, valid = np.zeros(1, dtype=data.dtype), np.zeros(1, dtype=bool)
    return Column(data=torch.from_numpy(np.ascontiguousarray(data)).to(device), ltype=ct,
                  validity=None if valid.all() else torch.from_numpy(valid).to(device),
                  dict_values=dvals)


# -- DuckDB's order -------------------------------------------------------------
def sort_key(v, t: LogicalType):
    """A key whose Python order is DuckDB's order of values of type t:
    nested values element by element, a prefix first, NULL last."""
    if v is None:
        return (1,)
    tid = t.id
    if tid in (TypeId.LIST, TypeId.ARRAY):
        ct = t.child
        return (0, tuple(sort_key(x, ct) for x in v))
    if tid is TypeId.STRUCT:
        return (0, tuple(sort_key(x, ft) for x, (_, ft) in zip(v, t.fields or ())))
    if tid is TypeId.MAP:
        kt, vt = t.fields[0][1], t.fields[1][1]
        return (0, tuple((sort_key(k, kt), sort_key(x, vt)) for k, x in v))
    if tid is TypeId.UNION:
        if not v:
            return (1,)
        tag, x = v
        return (0, (tag, sort_key(x, t.fields[tag][1])))
    if isinstance(v, float) and math.isnan(v):
        return (0, (1,))  # NaN after every number
    if t.is_float:
        return (0, (0, v))
    return (0, v)


def _dense_ranks(keys) -> np.ndarray:
    order = sorted(range(len(keys)), key=keys.__getitem__)
    ranks = np.zeros(len(keys), dtype=np.int64)
    r = 0
    for i, j in enumerate(order):
        if i and keys[j] != keys[order[i - 1]]:
            r += 1
        ranks[j] = r
    return ranks


_RANKS: dict = {}  # id(dict) → (dict, ltype, rank ndarray)
_RANKS_MAX = 64


def rank_lut(dvals: np.ndarray, t: LogicalType, device) -> torch.Tensor:
    """Each dictionary entry's rank in DuckDB's order (equal values share a
    rank), as an int64 tensor on `device`; cached per dictionary."""
    hit = _RANKS.get(id(dvals))
    if hit is None or hit[0] is not dvals or hit[1] != t:
        if len(_RANKS) >= _RANKS_MAX:
            _RANKS.pop(next(iter(_RANKS)))
        hit = (dvals, t, _dense_ranks([sort_key(v, t) for v in dvals]))
        _RANKS[id(dvals)] = hit
    ranks = hit[2]
    return torch.from_numpy(ranks if len(ranks) else np.zeros(1, np.int64)).to(device)


def merged_rank_luts(a, b, device):
    """Rank LUTs of two nested Columns' dictionaries in one common order."""
    if a.dict_values is b.dict_values:
        lut = rank_lut(a.dict_values, a.ltype, device)
        return lut, lut
    ka = [sort_key(v, a.ltype) for v in a.dict_values]
    kb = [sort_key(v, b.ltype) for v in b.dict_values]
    ranks = _dense_ranks(ka + kb)
    ra, rb = ranks[:len(ka)], ranks[len(ka):]
    return (torch.from_numpy(ra if len(ra) else np.zeros(1, np.int64)).to(device),
            torch.from_numpy(rb if len(rb) else np.zeros(1, np.int64)).to(device))


def order_data(col, plen: int) -> torch.Tensor:
    """A nested column's ranks per row (int64), orderable as DuckDB orders."""
    lut = rank_lut(col.dict_values, col.ltype, col.data.device)
    return lut[col.data.expand(plen).long().clamp(0, lut.shape[0] - 1)]


# -- results and text -----------------------------------------------------------
def to_result(v, t: LogicalType):
    """A nested value as DuckDB's Python API gives it, at every depth:
    LIST/ARRAY a list, STRUCT a dict by field name, MAP a dict, UNION its
    member's value, BIT a str."""
    if v is None:
        return None
    tid = t.id
    if tid in (TypeId.LIST, TypeId.ARRAY):
        ct = t.child
        if ct is None or ct.id not in NESTED_IDS:
            return list(v)
        return [to_result(x, ct) for x in v]
    if tid is TypeId.STRUCT:
        return {name: to_result(x, ft) for x, (name, ft) in zip(v, t.fields or ())}
    if tid is TypeId.MAP:
        kt, vt = t.fields[0][1], t.fields[1][1]
        return {_hashable(to_result(k, kt)): to_result(x, vt) for k, x in v}
    if tid is TypeId.UNION:
        if not v:
            return None
        tag, x = v
        return to_result(x, t.fields[tag][1])
    if tid is TypeId.BIT:
        return str(v)
    return v


def _hashable(v):
    if isinstance(v, list):
        return tuple(_hashable(x) for x in v)
    if isinstance(v, dict):
        return tuple(v.items())
    return v


_QUOTE_CHARS = set(",[]{}():='\"\\")


def _text_str(s: str) -> str:
    """A VARCHAR inside a nested value: quoted where the text would be
    ambiguous (DuckDB quotes such strings with ')."""
    if s == "" or s != s.strip() or s.upper() == "NULL" or any(c in _QUOTE_CHARS for c in s):
        return "'" + s.replace("'", "''") + "'"
    return s


def to_text(v, t: LogicalType, top: bool = True) -> str:
    """Format a value as DuckDB's CAST(... AS VARCHAR): [1, 2], {'a': 1},
    {k=v}, NULL inside nested values."""
    from duckdb_tpu_torch.planner.bound import format_varchar

    if v is None:
        return "NULL"
    tid = t.id
    if tid in (TypeId.LIST, TypeId.ARRAY):
        return "[" + ", ".join(to_text(x, t.child, False) for x in v) + "]"
    if tid is TypeId.STRUCT:
        return "{" + ", ".join(f"'{name}': {to_text(x, ft, False)}"
                               for x, (name, ft) in zip(v, t.fields or ())) + "}"
    if tid is TypeId.MAP:
        kt, vt = t.fields[0][1], t.fields[1][1]
        return "{" + ", ".join(f"{to_text(k, kt, False)}={to_text(x, vt, False)}"
                               for k, x in v) + "}"
    if tid is TypeId.UNION:
        if not v:
            return "NULL"
        tag, x = v
        return to_text(x, t.fields[tag][1], top)
    if tid in (TypeId.VARCHAR, TypeId.BIT):
        return str(v) if top or tid is TypeId.BIT else _text_str(str(v))
    if tid is TypeId.SQLNULL:
        return "NULL"
    if tid is TypeId.DECIMAL and isinstance(v, pydec.Decimal):
        return str(v.quantize(pydec.Decimal(1).scaleb(-t.scale))) if t.scale else str(int(v))
    return format_varchar(physical_of(v, t), t)
