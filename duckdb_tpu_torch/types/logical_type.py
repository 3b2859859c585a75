"""Logical SQL type system.

Every logical type resolves to a fixed-width physical
dtype that lives as a padded device tensor (numpy dtype beside its
torch dtype). Variable-width data (VARCHAR)
is dictionary-encoded at ingest so the device only ever sees int32 codes;
the unique string values stay host-side.

Behavior parity reference: duckdb LogicalType
(duckdb/src/include/duckdb/common/types.hpp:193-260). We start
with the analytically load-bearing subset and widen over time.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch


class TypeId(enum.Enum):
    SQLNULL = "null"
    BOOLEAN = "boolean"
    TINYINT = "tinyint"
    SMALLINT = "smallint"
    INTEGER = "integer"
    BIGINT = "bigint"
    HUGEINT = "hugeint"
    FLOAT = "float"
    DOUBLE = "double"
    DECIMAL = "decimal"
    DATE = "date"
    TIME = "time"
    TIMESTAMP = "timestamp"
    INTERVAL = "interval"
    VARCHAR = "varchar"
    BLOB = "blob"
    LIST = "list"
    STRUCT = "struct"
    MAP = "map"
    TIMESTAMPTZ = "timestamptz"
    BIT = "bit"
    UNION = "union"
    ARRAY = "array"


_INT_ORDER = [
    TypeId.TINYINT,
    TypeId.SMALLINT,
    TypeId.INTEGER,
    TypeId.BIGINT,
    TypeId.HUGEINT,
]

# Physical numpy dtype backing each logical type on device.
# DECIMAL is a scaled integer; DATE is days since 1970-01-01 (int32);
# TIMESTAMP is microseconds since epoch (int64); VARCHAR is an int32
# dictionary code. HUGEINT is emulated (not yet backed by a single dtype).
_PHYSICAL = {
    TypeId.SQLNULL: np.int32,
    TypeId.BOOLEAN: np.bool_,
    TypeId.TINYINT: np.int8,
    TypeId.SMALLINT: np.int16,
    TypeId.INTEGER: np.int32,
    TypeId.BIGINT: np.int64,
    TypeId.HUGEINT: np.int64,  # pair-of-int64 emulation planned; single i64 for now
    TypeId.FLOAT: np.float32,
    TypeId.DOUBLE: np.float64,
    TypeId.DATE: np.int32,
    TypeId.TIME: np.int64,
    TypeId.TIMESTAMP: np.int64,
    TypeId.INTERVAL: np.int64,  # micros; months/days components planned
    TypeId.VARCHAR: np.int32,  # dictionary code
    TypeId.BLOB: np.int32,
    # nested values are dictionary-encoded like VARCHAR: the device plane is
    # an int32 code; the distinct tuples/records live host-side
    TypeId.LIST: np.int32,
    TypeId.STRUCT: np.int32,
    TypeId.MAP: np.int32,
    # TIMESTAMPTZ: micros since epoch in UTC (the reference's instant
    # semantics, types.hpp TIMESTAMP_TZ); session TimeZone applies at
    # render/extract only
    TypeId.TIMESTAMPTZ: np.int64,
    # BIT carries a '0'/'1' text bitstring in the dictionary plane
    # (reference bit.cpp stores packed bytes; exact value semantics,
    # different carrier)
    TypeId.BIT: np.int32,
    # UNION values are dict-encoded (tag_index, value) records; ARRAY is
    # LIST with a fixed, type-enforced length (width)
    TypeId.UNION: np.int32,
    TypeId.ARRAY: np.int32,
}


# torch dtype for each numpy physical dtype above
_TORCH = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def torch_dtype_of(np_dtype) -> torch.dtype:
    """torch dtype of a numpy physical dtype."""
    return _TORCH[np.dtype(np_dtype)]


@dataclass(frozen=True)
class LogicalType:
    id: TypeId
    width: int = 0  # decimal precision
    scale: int = 0  # decimal scale
    child: Optional["LogicalType"] = field(default=None)
    # STRUCT field schema: tuple of (name, LogicalType)
    fields: Optional[tuple] = field(default=None)

    def __repr__(self) -> str:
        if self.id is TypeId.DECIMAL:
            return f"DECIMAL({self.width},{self.scale})"
        if self.id is TypeId.LIST:
            return f"{self.child!r}[]"
        if self.id is TypeId.ARRAY:
            return f"{self.child!r}[{self.width}]"
        if self.id is TypeId.TIMESTAMPTZ:
            return "TIMESTAMP WITH TIME ZONE"
        if self.id is TypeId.UNION and self.fields:
            inner = ", ".join(f"{n} {t!r}" for n, t in self.fields)
            return f"UNION({inner})"
        if self.id is TypeId.STRUCT and self.fields:
            inner = ", ".join(f"{n} {t!r}" for n, t in self.fields)
            return f"STRUCT({inner})"
        return self.id.name

    # -- classification helpers ------------------------------------------------
    @property
    def is_numeric(self) -> bool:
        return self.id in (
            TypeId.TINYINT,
            TypeId.SMALLINT,
            TypeId.INTEGER,
            TypeId.BIGINT,
            TypeId.HUGEINT,
            TypeId.FLOAT,
            TypeId.DOUBLE,
            TypeId.DECIMAL,
        )

    @property
    def is_integer(self) -> bool:
        return self.id in (
            TypeId.TINYINT,
            TypeId.SMALLINT,
            TypeId.INTEGER,
            TypeId.BIGINT,
            TypeId.HUGEINT,
        )

    @property
    def is_float(self) -> bool:
        return self.id in (TypeId.FLOAT, TypeId.DOUBLE)

    @property
    def is_temporal(self) -> bool:
        return self.id in (TypeId.DATE, TypeId.TIME, TypeId.TIMESTAMP,
                           TypeId.TIMESTAMPTZ)

    @property
    def np_dtype(self):
        if self.id is TypeId.DECIMAL:
            return np.int64 if self.width > 9 else np.int32
        return _PHYSICAL[self.id]

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype_of(self.np_dtype)

    def __str__(self) -> str:
        return repr(self)


# -- singletons ---------------------------------------------------------------
SQLNULL = LogicalType(TypeId.SQLNULL)
BOOLEAN = LogicalType(TypeId.BOOLEAN)
TINYINT = LogicalType(TypeId.TINYINT)
SMALLINT = LogicalType(TypeId.SMALLINT)
INTEGER = LogicalType(TypeId.INTEGER)
BIGINT = LogicalType(TypeId.BIGINT)
HUGEINT = LogicalType(TypeId.HUGEINT)
FLOAT = LogicalType(TypeId.FLOAT)
DOUBLE = LogicalType(TypeId.DOUBLE)
DATE = LogicalType(TypeId.DATE)
TIME = LogicalType(TypeId.TIME)
TIMESTAMP = LogicalType(TypeId.TIMESTAMP)
INTERVAL = LogicalType(TypeId.INTERVAL)
VARCHAR = LogicalType(TypeId.VARCHAR)
BLOB = LogicalType(TypeId.BLOB)
TIMESTAMPTZ = LogicalType(TypeId.TIMESTAMPTZ)
BIT = LogicalType(TypeId.BIT)


def union_of(*fields) -> LogicalType:
    return LogicalType(TypeId.UNION, fields=tuple(fields))


def array_of(child: LogicalType, n: int) -> LogicalType:
    if n <= 0:
        raise ValueError(f"invalid ARRAY size {n}")
    return LogicalType(TypeId.ARRAY, width=n, child=child)


def decimal(width: int, scale: int) -> LogicalType:
    if not (0 < width <= 38) or not (0 <= scale <= width):
        raise ValueError(f"invalid DECIMAL({width},{scale})")
    return LogicalType(TypeId.DECIMAL, width=width, scale=scale)


# -- implicit cast lattice ----------------------------------------------------
# Mirrors duckdb's implicit-cast cost rules (src/function/cast_rules.cpp):
# smaller ints promote to bigger ints / decimal / double; decimal promotes to
# double; date promotes to timestamp. Returns cost or None if not castable.
def implicit_cast_cost(src: LogicalType, dst: LogicalType) -> Optional[int]:
    if src == dst:
        return 0
    if src.id is TypeId.SQLNULL:
        return 1
    s, d = src.id, dst.id
    if src.is_integer and dst.is_integer:
        si, di = _INT_ORDER.index(s), _INT_ORDER.index(d)
        return (di - si) * 10 if di > si else None
    if src.is_integer and d is TypeId.DECIMAL:
        return 60
    if src.is_integer and dst.is_float:
        return 70 if d is TypeId.DOUBLE else 80
    if s is TypeId.DECIMAL and d is TypeId.DECIMAL:
        if dst.scale >= src.scale and (dst.width - dst.scale) >= (src.width - src.scale):
            return 15
        return None
    if s is TypeId.DECIMAL and dst.is_float:
        return 25 if d is TypeId.DOUBLE else 35
    if s is TypeId.FLOAT and d is TypeId.DOUBLE:
        return 10
    if s is TypeId.DATE and d in (TypeId.TIMESTAMP, TypeId.TIMESTAMPTZ):
        return 10
    if s is TypeId.TIMESTAMP and d is TypeId.TIMESTAMPTZ:
        return 10
    if s is TypeId.TIMESTAMPTZ and d is TypeId.TIMESTAMP:
        return 12
    if s is TypeId.VARCHAR and d in (TypeId.DATE, TypeId.TIMESTAMP,
                                     TypeId.TIMESTAMPTZ, TypeId.BIT):
        # string literals used in temporal/bit comparisons
        return 90
    if s is TypeId.VARCHAR and (dst.is_numeric or d is TypeId.BOOLEAN):
        # reference allows implicit VARCHAR -> anything at highest cost
        # (cast_rules.cpp 149): binding succeeds, unparseable strings
        # raise a Conversion Error at evaluation
        return 149
    if s is TypeId.ARRAY and d is TypeId.LIST:
        return 10  # fixed arrays relax to lists (reference cast_rules)
    if s is TypeId.LIST and d is TypeId.ARRAY:
        return 30
    if s is TypeId.UNION and d is TypeId.UNION:
        # subset-by-name widening
        dnames = {n.lower() for n, _ in (dst.fields or ())}
        if all(n.lower() in dnames for n, _ in (src.fields or ())):
            return 20
        return None
    if d is TypeId.UNION and dst.fields:
        # member type -> union wrap (union_casts.cpp)
        for _, ft in dst.fields:
            c = 0 if ft == src else implicit_cast_cost(src, ft)
            if c is not None:
                return 100 + c
    return None


def max_logical_type(a: LogicalType, b: LogicalType) -> LogicalType:
    """Common comparison/arithmetic supertype (duckdb LogicalType::MaxLogicalType)."""
    if a == b:
        return a
    if a.id is TypeId.SQLNULL:
        return b
    if b.id is TypeId.SQLNULL:
        return a
    if a.id is TypeId.UNION and b.id is TypeId.UNION:
        # merge members by name (reference MaxLogicalType union handling)
        fields = list(a.fields or ())
        names = {n.lower() for n, _ in fields}
        for n, t in (b.fields or ()):
            if n.lower() not in names:
                fields.append((n, t))
        return LogicalType(TypeId.UNION, fields=tuple(fields))
    # decimal/decimal → widen to cover both
    if a.id is TypeId.DECIMAL and b.id is TypeId.DECIMAL:
        scale = max(a.scale, b.scale)
        integral = max(a.width - a.scale, b.width - b.scale)
        return decimal(min(38, integral + scale), scale)
    if a.id is TypeId.DECIMAL and b.is_integer:
        return max_logical_type(a, decimal(min(38, _int_decimal_width(b)), 0))
    if b.id is TypeId.DECIMAL and a.is_integer:
        return max_logical_type(decimal(min(38, _int_decimal_width(a)), 0), b)
    for t in (a, b):
        pass
    if implicit_cast_cost(a, b) is not None and implicit_cast_cost(b, a) is not None:
        return a if implicit_cast_cost(b, a) <= implicit_cast_cost(a, b) else b
    if implicit_cast_cost(a, b) is not None:
        return b
    if implicit_cast_cost(b, a) is not None:
        return a
    # float vs decimal etc fall through above; remaining: typed error
    raise BindTypeError(
        f"Binder Error: Cannot compare values of type {a} and type {b}")


class BindTypeError(TypeError, ValueError):
    """Typed binder error for incomparable types (subclasses ValueError
    so the generic engine-error handling classifies it as a rejection)."""


def _int_decimal_width(t: LogicalType) -> int:
    return {
        TypeId.TINYINT: 3,
        TypeId.SMALLINT: 5,
        TypeId.INTEGER: 10,
        TypeId.BIGINT: 19,
        TypeId.HUGEINT: 38,
    }[t.id]


def list_of(child: LogicalType) -> LogicalType:
    return LogicalType(TypeId.LIST, child=child)


def struct_of(*fields) -> LogicalType:
    """struct_of(("a", BIGINT), ("b", VARCHAR)) → STRUCT type."""
    return LogicalType(TypeId.STRUCT, fields=tuple(fields))


def map_of(key: LogicalType, value: LogicalType) -> LogicalType:
    """MAP type: entries are tuples of (key, value) pairs; `child` holds the
    value type, `fields` the (key type, value type) pair."""
    return LogicalType(TypeId.MAP, child=value,
                       fields=(("key", key), ("value", value)))
