"""Expression binder: parsed AST → typed BoundExpr against a name scope.

Parallels the reference's ExpressionBinder family
(duckdb/src/planner/expression_binder/) collapsed into one dispatcher, as
in the JAX package. Aggregate calls are intercepted via a collector
callback so the select/having binder can split pre- and post-aggregation
computation. This slice binds what the TPC-H Q1 shape needs and the plain
scalar core around it; an expression form or function the JAX package
binds but this port does not yet raises a BindError saying so.
"""

from __future__ import annotations

import datetime
import re
from dataclasses import dataclass
from decimal import Decimal
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from duckdb_tpu_torch.blocks import Column
from duckdb_tpu_torch.ops import strings as dstr
from duckdb_tpu_torch.sql import nodes as N
from duckdb_tpu_torch.planner import bound as B
from duckdb_tpu_torch.planner import functions as F
from duckdb_tpu_torch.planner import functions_parity as FP
from duckdb_tpu_torch.planner import macros as M
from duckdb_tpu_torch.planner.bound import not_ported
from duckdb_tpu_torch.types import (
    BIGINT,
    BLOB,
    BOOLEAN,
    DATE,
    DOUBLE,
    HUGEINT,
    INTEGER,
    INTERVAL,
    SMALLINT,
    SQLNULL,
    TIME,
    TIMESTAMP,
    BIT,
    TIMESTAMPTZ,
    TINYINT,
    VARCHAR,
    LogicalType,
    TypeId,
    array_of,
    decimal,
    list_of,
    max_logical_type,
    struct_of,
    union_of,
)

# every aggregate name the JAX package knows: the parser and the planner
# use it to tell aggregate calls from scalar calls
AGGREGATE_NAMES = {
    "sum", "count", "avg", "mean", "min", "max", "first", "last", "any_value",
    "stddev", "stddev_samp", "stddev_pop", "var_samp", "var_pop", "variance",
    "string_agg", "bool_and", "bool_or", "product", "bit_and", "bit_or", "bit_xor",
    "count_star", "arg_min", "arg_max", "median", "mode", "approx_count_distinct",
    "quantile", "quantile_cont", "quantile_disc", "approx_quantile",
    "group_concat", "listagg", "list", "array_agg", "histogram",
    "corr", "covar_pop", "covar_samp", "regr_slope", "regr_intercept",
    "regr_r2", "regr_count", "regr_avgx", "regr_avgy", "regr_sxx",
    "regr_syy", "regr_sxy", "skewness", "kurtosis", "kurtosis_pop",
    "entropy", "sem", "mad", "count_if", "countif", "arbitrary",
    "argmax", "argmin", "max_by", "min_by", "favg", "fsum", "sumkahan",
    "kahan_sum", "sum_no_overflow", "reservoir_quantile",
    "arg_min_null", "arg_max_null", "arg_min_nulls_last",
    "arg_max_nulls_last", "approx_top_k", "bitstring_agg",
    "histogram_exact", "lttb",
}


_NESTED_IDS = (TypeId.LIST, TypeId.STRUCT, TypeId.MAP, TypeId.ARRAY, TypeId.UNION)


def _check_nested_comparison(left, right) -> None:
    """DuckDB compares a nested value only with a nested value: a LIST
    against an INTEGER needs an explicit cast (its Binder Error)."""
    lt, rt = left.ltype.id, right.ltype.id
    if SQLNULL.id in (lt, rt):
        return
    if (lt in _NESTED_IDS) != (rt in _NESTED_IDS):
        raise BindError(f"Binder Error: Cannot compare values of type {left.ltype!r} and "
                        f"type {right.ltype!r} - an explicit cast is required")


class BindError(B.BindError):
    pass


class ColumnNotFound(BindError):
    """A column name no scope resolves; `parts` is the name as written."""

    def __init__(self, parts: Tuple[str, ...]):
        super().__init__(f'Binder Error: column "{".".join(parts)}" not found')
        self.parts = tuple(parts)


@dataclass
class Binding:
    key: str
    ltype: LogicalType


@dataclass
class KeyRef(N.Expr):
    """A column named by its binding key rather than by name: what `*`
    expands to (two columns of one name stay two columns) and the two
    sides of a USING equality."""

    key: str
    ltype: LogicalType


class Scope:
    """Column name resolution: alias.col and unqualified col → binding."""

    def __init__(self, parent: Optional["Scope"] = None):
        self.parent = parent
        self.by_qual: Dict[Tuple[str, str], Binding] = {}
        self.by_name: Dict[str, List[Binding]] = {}
        self.order: List[Tuple[str, str, Binding]] = []  # (alias, col, binding)
        # USING / NATURAL joins: `*` skips the keys in star_hidden (a USING
        # column's other sides) and reads star_replace[key] in place of a
        # key (a FULL join's COALESCE of both sides)
        self.star_hidden: set = set()
        self.star_replace: Dict[str, Binding] = {}

    def add(self, alias: str, col: str, key: str, ltype: LogicalType):
        b = Binding(key, ltype)
        self.by_qual[(alias.lower(), col.lower())] = b
        self.by_name.setdefault(col.lower(), []).append(b)
        self.order.append((alias, col, b))
        return b

    def resolve(self, parts: Tuple[str, ...]) -> Binding:
        if len(parts) == 1:
            cands = self.by_name.get(parts[0].lower(), [])
            if len(cands) == 1:
                return cands[0]
            if len(cands) > 1:
                raise BindError(f'ambiguous column name "{parts[0]}"')
        elif len(parts) >= 2:
            b = self.by_qual.get((parts[-2].lower(), parts[-1].lower()))
            if b:
                return b
        if self.parent is not None:
            return self.parent.resolve(parts)
        raise ColumnNotFound(parts)

    def try_resolve(self, parts) -> Optional[Binding]:
        try:
            return self.resolve(parts)
        except BindError:
            return None

    def remove_keys(self, keys) -> None:
        """Drop bindings whose key is in `keys` (semi/anti join build
        columns leave scope after the join — reference binder hides the
        right side of SEMI/ANTI syntax joins)."""
        keys = set(keys)
        self.by_qual = {q: b for q, b in self.by_qual.items() if b.key not in keys}
        self.by_name = {n: [b for b in bs if b.key not in keys]
                        for n, bs in self.by_name.items()}
        self.by_name = {n: bs for n, bs in self.by_name.items() if bs}
        self.order = [(a, c, b) for (a, c, b) in self.order if b.key not in keys]

    def merge_using(self, col: str, hidden: List[Binding], shown: Binding,
                    replaces: Binding):
        """A USING column: the unqualified name reads `shown` alone, `*`
        lists it once, as `shown` at the position of `replaces`, and the
        bindings in `hidden` leave `*` (they stay reachable by their
        qualified name)."""
        name = col.lower()
        drop = {b.key for b in hidden} | {replaces.key}
        self.by_name[name] = [b for b in self.by_name.get(name, [])
                              if b.key not in drop] + [shown]
        self.star_hidden |= {b.key for b in hidden}
        if shown.key != replaces.key:
            self.star_replace[replaces.key] = shown

    def columns_of(self, alias: str):
        return [(a, c, b) for (a, c, b) in self.order if a.lower() == alias.lower()]

    def all_columns(self):
        return list(self.order)


def _parse_date(s: str) -> int:
    d = datetime.date.fromisoformat(s.strip())
    return (d - datetime.date(1970, 1, 1)).days


def _parse_timestamptz(s: str) -> int:
    """Text → UTC micros. Accepts an optional ±HH[:MM] offset or Z;
    offset-less text is interpreted in the session TimeZone (UTC)."""
    s = s.strip()
    if s.endswith(("Z", "z")):
        s = s[:-1]
    dt = datetime.datetime.fromisoformat(s)
    if dt.tzinfo is not None:
        dt = dt.astimezone(datetime.timezone.utc).replace(tzinfo=None)
    return int((dt - datetime.datetime(1970, 1, 1)).total_seconds() * 1_000_000)


def _parse_timestamp(s: str) -> int:
    s = s.strip()
    # duckdb rejects a time part with only an hour ('1111-11-11 11');
    # python's fromisoformat accepts it — pre-check the shape
    if len(s) > 10:
        time_part = s[11:]
        if time_part and ":" not in time_part \
                and not time_part.startswith(("+", "-")) \
                and time_part not in ("", "Z"):
            raise ValueError(f"invalid timestamp: {s!r}")
    dt = datetime.datetime.fromisoformat(s)
    return int((dt - datetime.datetime(1970, 1, 1)).total_seconds() * 1_000_000)


def _parse_time_micros(v: str) -> int:
    """'HH:MM:SS[.ffffff]' → microseconds since midnight."""
    hh, mm, rest = v.split(":")
    if "." in rest:
        ss, frac = rest.split(".")
        us = int((frac + "000000")[:6])
    else:
        ss, us = rest, 0
    return (int(hh) * 3600 + int(mm) * 60 + int(ss)) * 1_000_000 + us


_INTERVAL_MULT = {
    "year": ("months", 12), "years": ("months", 12), "y": ("months", 12),
    "month": ("months", 1), "months": ("months", 1), "mon": ("months", 1),
    "day": ("days", 1), "days": ("days", 1), "d": ("days", 1),
    "week": ("days", 7), "weeks": ("days", 7),
    "hour": ("micros", 3600_000_000), "hours": ("micros", 3600_000_000),
    "minute": ("micros", 60_000_000), "minutes": ("micros", 60_000_000),
    "second": ("micros", 1_000_000), "seconds": ("micros", 1_000_000),
}


def bind_interval(val: str, unit: Optional[str]) -> Tuple[int, int, int]:
    """An interval's text → (months, days, micros): '<n> <unit>' pairs, and a
    time of day '[-]HH:MM[:SS[.ffffff]]' as DuckDB reads it ('2 months 3 days
    04:05:06'); a unit of micros (hours and below) may take a fraction."""
    parts = {"months": 0, "days": 0, "micros": 0}
    toks = [val, unit] if unit is not None else val.split()
    i = 0
    while i < len(toks):
        if ":" in toks[i]:
            neg = toks[i].startswith("-")
            h, m, *sec = toks[i].lstrip("+-").split(":")
            us = (int(h) * 3600 + int(m) * 60) * 1_000_000 + (
                round(Decimal(sec[0]) * 1_000_000) if sec else 0)
            parts["micros"] += -us if neg else us
            i += 1
            continue
        if i + 1 >= len(toks):
            break
        n, u = toks[i], toks[i + 1]
        field_, mult = _INTERVAL_MULT[u.lower()]
        parts[field_] += round(Decimal(n) * mult) if field_ == "micros" else int(n) * mult
        i += 2
    return (parts["months"], parts["days"], parts["micros"])


_TYPE_NAMES = {
    "boolean": BOOLEAN, "bool": BOOLEAN, "logical": BOOLEAN,
    "tinyint": TINYINT, "int1": TINYINT,
    "smallint": SMALLINT, "int2": SMALLINT, "short": SMALLINT,
    "integer": INTEGER, "int": INTEGER, "int4": INTEGER, "signed": INTEGER,
    "bigint": BIGINT, "int8": BIGINT, "long": BIGINT,
    "hugeint": HUGEINT, "int128": HUGEINT,
    "real": LogicalType(TypeId.FLOAT), "float4": LogicalType(TypeId.FLOAT),
    "float": DOUBLE, "double": DOUBLE, "float8": DOUBLE,
    "varchar": VARCHAR, "text": VARCHAR, "string": VARCHAR, "char": VARCHAR,
    "bpchar": VARCHAR,
    # JSON is VARCHAR storage in the reference; a UUID is its canonical
    # lowercase text, whose order is the 128-bit value's
    "json": VARCHAR, "uuid": VARCHAR, "guid": VARCHAR,
    "date": DATE, "timestamp": TIMESTAMP, "datetime": TIMESTAMP,
    "time": TIME, "timestamptz": TIMESTAMPTZ, "timetz": TIME,
    "blob": BLOB, "bytea": BLOB, "binary": BLOB, "varbinary": BLOB,
    "bit": BIT, "bitstring": BIT,
}


def _split_fields(body: str):
    """'a int, b struct(c int)' → [(field name, LogicalType), ...], split
    at depth 0."""
    fields, depth, part = [], 0, ""
    for ch in body + ",":
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            fname, _, ftype = part.strip().partition(" ")
            fmods: Tuple[int, ...] = ()
            ftype = ftype.strip()
            if "(" in ftype and ftype.endswith(")") and not ftype.startswith(("struct(",
                                                                               "union(")):
                base, _, rest = ftype.partition("(")
                fmods = tuple(int(x) for x in rest[:-1].split(","))
                ftype = base
            fields.append((fname, resolve_type_name(ftype, fmods)))
            part = ""
        else:
            part += ch
    return fields


def resolve_type_name(name: str, mods: Tuple[int, ...]) -> LogicalType:
    """A type name as the parser spells it: T[] is a LIST, T[N] an ARRAY,
    struct(...)/union(...) carry their fields (DuckDB's type grammar)."""
    n = name.lower()
    if n.endswith("[]"):
        return list_of(resolve_type_name(n[:-2], mods))
    m = re.match(r"^(.*)\[(\d+)\]$", n)
    if m:
        return array_of(resolve_type_name(m.group(1), mods), int(m.group(2)))
    if n.startswith("union(") and n.endswith(")"):
        return union_of(*_split_fields(n[6:-1]))
    if n.startswith("struct(") and n.endswith(")"):
        return struct_of(*_split_fields(n[7:-1]))
    if n in ("decimal", "numeric"):
        w = mods[0] if mods else 18
        s = mods[1] if len(mods) > 1 else 3
        return decimal(w, s)
    if n in _TYPE_NAMES:
        return _TYPE_NAMES[n]
    ut = user_types().get(n)
    if ut is not None:
        if ut.get("kind") == "enum":
            # an ENUM rides the dictionary-coded string plane (DuckDB's enum
            # is a dictionary too: its physical values are the codes)
            return VARCHAR
        return resolve_type_name(ut["base"], tuple(ut.get("mods") or ()))
    raise BindError(f"unknown type name {name}")


def user_types() -> dict:
    """CREATE TYPE's types of the statement's catalog (the session's: two
    connections to two databases never see each other's types)."""
    from duckdb_tpu_torch.planner import session

    cat = getattr(session.current(), "catalog", None)
    return getattr(cat, "user_types", None) or {}


def bind_literal(lit: N.Literal) -> B.BoundExpr:
    v, hint = lit.value, lit.type_hint
    if v is None:
        return B.BoundLiteral(None, SQLNULL)
    if hint == "decimal":
        s = str(v)
        neg = s.startswith("-")
        body = s.lstrip("+-")
        ip, _, fp = body.partition(".")
        scale = len(fp)
        width = max(1, len(ip.lstrip("0")) + scale)
        iv = int(ip + fp) if ip + fp else 0
        return B.BoundLiteral(-iv if neg else iv, decimal(min(width, 38), scale))
    if hint == "date":
        return B.BoundLiteral(_parse_date(v), DATE)
    if hint == "timestamp":
        return B.BoundLiteral(_parse_timestamp(v), TIMESTAMP)
    if hint == "time":
        return B.BoundLiteral(_parse_time_micros(v), TIME)
    if isinstance(v, bool):
        return B.BoundLiteral(v, BOOLEAN)
    if isinstance(v, int):
        if -(2**31) <= v < 2**31:
            t = INTEGER
        elif -(2**63) <= v < 2**63:
            t = BIGINT
        elif -(2**127) <= v < 2**127:
            t = HUGEINT  # reference promotes oversized literals to HUGEINT
        else:
            raise BindError(f"integer literal {v} out of range")
        return B.BoundLiteral(v, t)
    if isinstance(v, float):
        return B.BoundLiteral(v, DOUBLE)
    if isinstance(v, str):
        return B.BoundLiteral(v, VARCHAR)
    raise BindError(f"unsupported literal {v!r}")


def _int_width(t: LogicalType) -> int:
    return {TypeId.TINYINT: 3, TypeId.SMALLINT: 5, TypeId.INTEGER: 10,
            TypeId.BIGINT: 19, TypeId.HUGEINT: 38, TypeId.BOOLEAN: 1}[t.id]


def _arith_result_type(op: str, lt: LogicalType, rt: LogicalType) -> LogicalType:
    if TypeId.SQLNULL in (lt.id, rt.id):
        # NULL op x → typed NULL of the other side
        other = rt if lt.id is TypeId.SQLNULL else lt
        return other if other.id is not TypeId.SQLNULL else lt
    if TypeId.INTERVAL in (lt.id, rt.id):
        return rt if lt.id is TypeId.INTERVAL else lt  # date ± interval → date (folded)
    if lt.id is TypeId.DATE and rt.id is TypeId.DATE and op == "-":
        return BIGINT
    if lt.id is TypeId.DATE and rt.is_integer:
        return DATE
    if rt.id is TypeId.DATE and lt.is_integer and op == "+":
        return DATE
    _temporal = (TypeId.DATE, TypeId.TIME, TypeId.TIMESTAMP, TypeId.TIMESTAMPTZ)
    if lt.id in _temporal and rt.id in _temporal and op == "-":
        return INTERVAL  # timestamp difference
    if not (lt.is_numeric or lt.id is TypeId.BOOLEAN) \
            or not (rt.is_numeric or rt.id is TypeId.BOOLEAN):
        raise BindError(
            f"Binder Error: No function matches '{op}({lt!r}, {rt!r})'. You "
            "might need to add explicit type casts.")
    if lt.is_float or rt.is_float:
        return DOUBLE
    if TypeId.DECIMAL in (lt.id, rt.id):
        dl = lt if lt.id is TypeId.DECIMAL else decimal(_int_width(lt), 0)
        dr = rt if rt.id is TypeId.DECIMAL else decimal(_int_width(rt), 0)
        if op in ("+", "-"):
            s = max(dl.scale, dr.scale)
            intp = max(dl.width - dl.scale, dr.width - dr.scale) + 1
            return decimal(min(38, intp + s), s)
        if op == "*":
            return decimal(min(38, dl.width + dr.width), dl.scale + dr.scale)
        if op == "%":
            # a remainder is no larger than the divisor, at the larger scale
            s = max(dl.scale, dr.scale)
            return decimal(min(38, max(dl.width - dl.scale, dr.width - dr.scale) + s), s)
        if op == "/":
            # duckdb's decimal division falls back to DOUBLE when the width
            # is unbounded (decimal_division.cpp); bind DOUBLE as the JAX
            # package does
            return DOUBLE
        raise BindError(f"unsupported decimal op {op}")
    if op == "/":
        return DOUBLE
    if lt.is_integer and rt.is_integer:
        order = [TypeId.TINYINT, TypeId.SMALLINT, TypeId.INTEGER, TypeId.BIGINT,
                 TypeId.HUGEINT]
        return LogicalType(max(lt.id, rt.id, key=order.index))
    raise BindError(f"cannot apply {op} to {lt} and {rt}")


_REDUCE_NAMES = ("list_reduce", "array_reduce", "reduce")
_LAMBDA_NAMES = ("list_transform", "array_transform", "apply", "list_apply", "array_apply",
                 "list_filter", "array_filter", "filter")

_KEYWORD_FUNCTIONS = {"current_date": "today", "current_time": "now", "localtimestamp": "now",
                      "current_timestamp": "now"}


def _fold_cast(lit: B.BoundLiteral, t: LogicalType) -> B.BoundLiteral:
    """A string literal read as type t, as DuckDB reads a literal for a
    parameter of that type: text that does not read is its Conversion
    Error, raised here."""
    try:
        return B.BoundLiteral(B.BoundCast(lit, t).const_value(), t)
    except (ValueError, KeyError, OverflowError) as err:
        raise B.CastConversionError(f"Conversion Error: Could not convert string "
                                    f"'{lit.value}' to {t!r}") from err


class ExprBinder:
    """Binds AST expressions in a scope.

    agg_collector: callable(FunctionCall ast, binder) → BoundAggregateRef,
    set when binding select/having/order lists of an aggregating query.
    subquery_binder: callable(ast node, binder) → BoundExpr for Scalar/In/
    Exists subqueries (installed by the planner).
    window_collector: callable(WindowFunction ast, binder) → BoundAggregateRef
    to the window's output column, set while binding a SELECT's
    select list and QUALIFY.
    """

    def __init__(self, scope: Scope, agg_collector=None, subquery_binder=None,
                 window_collector=None):
        self.scope = scope
        self.agg_collector = agg_collector
        self.subquery_binder = subquery_binder
        self.window_collector = window_collector

    def bind(self, e: N.Expr) -> B.BoundExpr:
        m = getattr(self, "_bind_" + type(e).__name__, None)
        if m is None:
            raise not_ported(f"the expression form {type(e).__name__}")
        return m(e)

    # -- leaves --------------------------------------------------------------
    def _bind_Literal(self, e: N.Literal):
        return bind_literal(e)

    def _bind_IntervalLiteral(self, e: N.IntervalLiteral):
        return B.BoundLiteral(bind_interval(e.value, e.unit), INTERVAL)

    def _bind_ColumnRef(self, e: N.ColumnRef):
        try:
            b = self.scope.resolve(e.parts)
        except ColumnNotFound:
            # keyword pseudo-columns, which DuckDB binds as functions
            name = e.parts[0].lower() if len(e.parts) == 1 else None
            if name in _KEYWORD_FUNCTIONS:
                return self._bind_FunctionCall(N.FunctionCall(_KEYWORD_FUNCTIONS[name], []))
            raise
        return B.BoundColumnRef(b.key, b.ltype)

    def _bind_KeyRef(self, e: KeyRef):
        return B.BoundColumnRef(e.key, e.ltype)

    # -- operators -----------------------------------------------------------
    # COLLATE names → the function each applies (None: the binary order);
    # the JAX package's table (duckdb_tpu/planner/binder.py)
    _COLLATIONS = {"nocase": "lower", "noaccent": "strip_accents",
                   "nfc": "nfc_normalize", "c": None, "binary": None,
                   "posix": None}

    def _apply_collation(self, b: B.BoundExpr, cname: str) -> B.BoundExpr:
        for part in cname.lower().split("."):
            if part not in self._COLLATIONS:
                raise BindError(f"Catalog Error: Collation with name {part} does not exist!")
            fn = self._COLLATIONS[part]
            if fn is not None:
                rt, impl, args = F.REGISTRY[fn]([b])
                b = B.BoundFunction(fn, args, rt, impl)
        return b

    def _bind_CollateExpr(self, e: N.CollateExpr):
        """expr COLLATE name: the collation's function over expr; a
        comparison applies it to its other side too (NOCASE compares
        lower-cased values)."""
        child = self.bind(e.child)
        b = self._apply_collation(child, e.collation)
        if b is not child:  # C / BINARY / POSIX: the binary order, nothing to apply
            object.__setattr__(b, "collation", e.collation)
        return b

    def _bind_BinaryOp(self, e: N.BinaryOp):
        if e.op in B._CMP_OPS:
            left, right = self.bind(e.left), self.bind(e.right)
            lc, rc = getattr(left, "collation", None), getattr(right, "collation", None)
            if lc and not rc:
                right = self._apply_collation(right, lc)
            elif rc and not lc:
                left = self._apply_collation(left, rc)
            left, right = self._align_comparison(left, right)
            return B.BoundComparison(e.op, left, right)
        if e.op == "||":
            return self._bind_concat(e)
        left = self.bind(e.left)
        right = self.bind(e.right)
        t = _arith_result_type(e.op, left.ltype, right.ltype)
        node = B.BoundArithmetic(e.op, left, right, t)
        if node.is_const():
            try:
                return B.BoundLiteral(node.const_value(), t)
            except (ValueError, BindError):
                pass
        if TypeId.INTERVAL in (left.ltype.id, right.ltype.id):
            return self._bind_interval_arith(e.op, left, right)
        return node

    def _bind_concat(self, e: N.BinaryOp):
        """VARCHAR || VARCHAR (NULL || x is NULL); DuckDB casts any other
        operand to VARCHAR first."""
        args = []
        for side in (e.left, e.right):
            a = self.bind(side)
            if a.ltype.id is not TypeId.VARCHAR:
                a = B.BoundCast(a, VARCHAR)
            args.append(a)

        def impl(env, cols, node):
            return concat_pair(env, cols[0], cols[1])

        return B.BoundFunction("concat", args, VARCHAR, impl)

    def _bind_interval_arith(self, op: str, left: B.BoundExpr,
                             right: B.BoundExpr) -> B.BoundExpr:
        """Runtime temporal ± interval (device intervals are int64 micros):
        DATE ± INTERVAL and TIMESTAMP ± INTERVAL → TIMESTAMP, TIME wraps
        mod 24h, INTERVAL ± INTERVAL → INTERVAL (duckdb/src/common/operator/
        add.cpp). Month-granularity intervals stay bind-time constants; a
        DATE or TIMESTAMP column moves by calendar months on the device
        (`_add_months`)."""
        if op not in ("+", "-"):
            raise BindError(f"cannot apply {op} to interval operands")
        if left.ltype.id is TypeId.INTERVAL and right.ltype.id is not TypeId.INTERVAL:
            if op != "+":
                raise BindError("cannot subtract temporal from interval")
            left, right = right, left  # interval + temporal → temporal + interval
        if (left.ltype.id in (TypeId.DATE, TypeId.TIMESTAMP) and right.is_const()
                and isinstance(right.const_value(), tuple) and right.const_value()[0]):
            return _add_months(left, right.const_value(), 1 if op == "+" else -1)

        def norm(x: B.BoundExpr) -> B.BoundExpr:
            # constant (months, days, micros) literals flatten to pure micros
            if x.ltype.id is TypeId.INTERVAL and x.is_const():
                v = x.const_value()
                if isinstance(v, tuple):
                    months, days, micros = v
                    if months:
                        raise BindError(
                            "month-granularity interval with non-constant "
                            "operand not supported")
                    return B.BoundLiteral(days * 86_400_000_000 + micros, INTERVAL)
            return x

        left, right = norm(left), norm(right)
        base = left.ltype.id
        out_t = {TypeId.DATE: TIMESTAMP, TypeId.TIMESTAMP: TIMESTAMP,
                 TypeId.TIME: TIME, TypeId.INTERVAL: INTERVAL}.get(base)
        if out_t is None:
            raise BindError(f"cannot apply interval arithmetic to {left.ltype}")
        us_day = 86_400_000_000

        def impl(env, cols, node):
            a, b = cols
            x = a.data.to(torch.int64)
            y = b.data.to(torch.int64)
            if base is TypeId.DATE:
                x = x * us_day
            d = x + y if op == "+" else x - y
            if base is TypeId.TIME:
                d = torch.remainder(d, us_day)
            return Column(data=d, ltype=out_t,
                          validity=B._and_validity(a.validity, b.validity))

        return B.BoundFunction(f"__interval_{op}", [left, right], out_t, impl)

    def _align_comparison(self, left: B.BoundExpr, right: B.BoundExpr):
        """Parse a VARCHAR literal compared with a temporal column at bind time."""
        for a, b, swap in ((left, right, False), (right, left, True)):
            if (a.ltype.id is TypeId.VARCHAR and a.is_const()
                    and b.ltype.id in (TypeId.DATE, TypeId.TIMESTAMP)):
                v = a.const_value()
                lit = B.BoundLiteral(
                    None if v is None
                    else _parse_date(v) if b.ltype.id is TypeId.DATE else _parse_timestamp(v),
                    b.ltype)
                return (b, lit) if swap else (lit, b)
        if (left.ltype.id is TypeId.VARCHAR) != (right.ltype.id is TypeId.VARCHAR):
            raise BindError(f"cannot compare {left.ltype} and {right.ltype}")
        _check_nested_comparison(left, right)
        return left, right

    def _bind_UnaryOp(self, e: N.UnaryOp):
        c = self.bind(e.child)
        if e.op == "-":
            node = B.BoundNegate(c, c.ltype)
            if node.is_const():
                return B.BoundLiteral(node.const_value(), c.ltype)
            return node
        if e.op == "+":
            return c
        raise BindError(f"unary {e.op}")

    def _bind_Conjunction(self, e: N.Conjunction):
        return B.BoundConjunction(e.op, [self.bind(c) for c in e.children])

    def _bind_NotExpr(self, e: N.NotExpr):
        return B.BoundNot(self.bind(e.child))

    def _bind_IsNull(self, e: N.IsNull):
        return B.BoundIsNull(self.bind(e.child), e.negated)

    def _bind_Between(self, e: N.Between):
        x = self.bind(e.expr)
        a, lo = self._align_comparison(x, self.bind(e.low))
        a2, hi = self._align_comparison(x, self.bind(e.high))
        node = B.BoundConjunction(
            "and", [B.BoundComparison(">=", a, lo), B.BoundComparison("<=", a2, hi)])
        return B.BoundNot(node) if e.negated else node

    def _bind_LikeExpr(self, e: N.LikeExpr):
        child = self.bind(e.expr)
        pat = self.bind(e.pattern)
        if not pat.is_const():
            raise BindError("non-constant LIKE pattern not supported")
        return B.BoundLike(child, pat.const_value(), e.negated, e.case_insensitive)

    def _bind_InList(self, e: N.InList):
        x, items = self.bind(e.expr), [self.bind(i) for i in e.items]
        for i in items:
            _check_nested_comparison(x, i)
            if x.ltype.id is TypeId.VARCHAR and i.ltype.is_numeric:
                raise BindError(f"cannot compare {x.ltype} and {i.ltype}")
        return B.BoundInList(x, items, e.negated)

    def _bind_CaseExpr(self, e: N.CaseExpr):
        whens = []
        for cond, res in e.whens:
            if e.operand is not None:
                cond = N.BinaryOp("=", e.operand, cond)
            whens.append((self.bind(cond), self.bind(res)))
        else_b = self.bind(e.else_expr) if e.else_expr is not None else None
        t = None
        for r in [r for _, r in whens] + ([else_b] if else_b is not None else []):
            if r.ltype.id is not TypeId.SQLNULL:
                t = r.ltype if t is None else max_logical_type(t, r.ltype)
        return B.BoundCase(whens, else_b, t or SQLNULL)

    def _bind_CastExpr(self, e: N.CastExpr):
        c = self.bind(e.child)
        t = resolve_type_name(e.type_name, e.type_mods)
        node = B.BoundCast(c, t, e.try_cast)
        ut = user_types().get(e.type_name.lower())
        enum_name = e.type_name.lower() if ut and ut.get("kind") == "enum" else None
        if c.is_const():
            try:
                folded = (node.const_value(),)
            except (ValueError, BindError, KeyError):
                folded = None
            if folded is not None:
                v = folded[0]
                if enum_name is not None and v is not None and v not in ut["values"]:
                    if not e.try_cast:
                        raise BindError(f"Conversion Error: Could not convert string '{v}' "
                                        f"to enum {e.type_name}")
                    v = None
                lit = B.BoundLiteral(v, t)
                if enum_name is not None:
                    object.__setattr__(lit, "enum_type", enum_name)
                return lit
        if enum_name is not None:
            object.__setattr__(node, "enum_type", enum_name)
        return node

    def _bind_ExtractExpr(self, e: N.ExtractExpr):
        child = self.bind(e.child)
        name = e.field.lower()
        if name not in F.REGISTRY:
            raise not_ported(f"extract({name})")
        rt, impl, args = F.REGISTRY[name]([child])
        return B.BoundFunction("extract_" + name, args, rt, impl)

    def _bind_FunctionCall(self, e: N.FunctionCall):
        name = e.name.lower()
        mac = M.active_macros().get(name)
        if mac is not None and not mac.is_table:
            pos, named = M.split_args(e.args)
            try:
                expanded = M.expand_call(mac, pos, named)
            except M.MacroError as err:
                raise BindError(str(err))
            with M.expansion_guard(name):
                return self.bind(expanded)
        if name in AGGREGATE_NAMES or (name == "count" and e.is_star):
            if self.agg_collector is None:
                raise BindError(f"aggregate {name}() not allowed here")
            return self.agg_collector(e, self)
        if len(e.args) == 2 and isinstance(e.args[1], N.LambdaExpr):
            if name in _REDUCE_NAMES:
                return self._bind_reduce(name, e)
            if name in _LAMBDA_NAMES:
                return self._bind_lambda(name, e)
        rewrite = _op_function_rewrite(name, e.args)
        if rewrite is not None:
            return self.bind(rewrite)
        if name in FP.MONTH_INTERVAL_FNS:
            return self._bind_month_interval(name, e)
        if name in ("struct_insert", "struct_update") and len(e.args) >= 2:
            return self._bind_struct_named(name, e)
        if name in F.REGISTRY:
            args = []
            for a in e.args:
                if (name in ("struct_pack", "row", "union_value") and isinstance(a, N.BinaryOp)
                        and a.op in (":=", "=>") and isinstance(a.left, N.ColumnRef)):
                    # a named argument: field/tag := value
                    b = self.bind(a.right)
                    b.alias = a.left.parts[-1]
                    args.append(b)
                else:
                    args.append(self.bind(a))
            F.check_arity(name, args)
            args = F.check_params(name, args, _fold_cast)
            try:
                rt, impl, args2 = F.REGISTRY[name](args)
            except (IndexError, KeyError) as err:
                raise BindError(
                    f"Binder Error: invalid arguments to {name} ({err!r})")
            return B.BoundFunction(name, args2, rt, impl)
        raise not_ported(f"the function {name}()")

    def _bind_month_interval(self, name: str, e: N.FunctionCall):
        """to_months … to_millennia(n): a constant n folds to a (months, days,
        micros) literal, as month intervals are bind-time values here (a
        DATE or TIMESTAMP plus one moves by calendar months)."""
        if len(e.args) != 1:
            raise BindError(f"Binder Error: {name} takes 1 argument")
        arg = self.bind(e.args[0])
        if not arg.is_const():
            raise BindError(f"Binder Error: {name} with a non-constant argument is not "
                            "supported (a month interval is a bind-time value)")
        v = arg.const_value()
        if v is None:
            return B.BoundLiteral(None, INTERVAL)
        return B.BoundLiteral((int(v) * FP.MONTH_INTERVAL_FNS[name], 0, 0), INTERVAL)

    def _bind_struct_named(self, name: str, e: N.FunctionCall):
        """struct_insert / struct_update(s, field := value, ...)."""
        base = self.bind(e.args[0])
        pairs = []
        for a in e.args[1:]:
            if not (isinstance(a, N.BinaryOp) and a.op in (":=", "=>", "=", "==")
                    and isinstance(a.left, N.ColumnRef)):
                raise BindError(f"Binder Error: {name} requires named arguments "
                                "(field := value)")
            pairs.append((a.left.parts[-1], self.bind(a.right)))
        rt, impl = FP.bind_struct_insert_update(name, base, pairs)
        return B.BoundFunction(name, [base], rt, impl)

    def _bind_IsDistinctFrom(self, e: N.IsDistinctFrom):
        """a IS [NOT] DISTINCT FROM b: equality where NULL equals NULL; never NULL."""
        left, right = self.bind(e.left), self.bind(e.right)
        if SQLNULL in (left.ltype, right.ltype):
            eq = B.BoundLiteral(False, BOOLEAN)  # decided by the NULLs alone
        else:
            left, right = self._align_comparison(left, right)
            eq = B.BoundComparison("=", left, right)
        args = [eq, B.BoundIsNull(left, False), B.BoundIsNull(right, False)]

        def impl(env, cols, node):
            eq, ln, rn = (B.bcast(c.data, env.plen).to(torch.bool) for c in cols)
            d = torch.where(ln | rn, ln != rn, ~eq)
            return Column(data=~d if e.negated else d, ltype=BOOLEAN)

        return B.BoundFunction("is_distinct_from", args, BOOLEAN, impl)

    # -- lambdas ----------------------------------------------------------------
    def _lambda_binder(self, params) -> "ExprBinder":
        """A binder over the lambda's parameters alone (a body reads no
        column of the query around it, as in the JAX package)."""
        lscope = Scope()
        for pname, key, t in params:
            lscope.add(pname, pname, key, t)
        return ExprBinder(lscope, agg_collector=None, subquery_binder=self.subquery_binder)

    def _bind_reduce(self, name: str, e: N.FunctionCall):
        """list_reduce(l, (acc, x) -> …): a fold (DuckDB's list_reduce.cpp)."""
        from duckdb_tpu_torch.planner.functions_nested import bind_reduce_func

        base = self.bind(e.args[0])
        lam = e.args[1]
        if not lam.index_param:
            raise BindError(f"{name} requires a two-parameter lambda (accumulator, element)")
        child_t = base.ltype.child or SQLNULL
        akey, xkey = f"__lambda_{lam.param}", f"__lambda_{lam.index_param}"
        body = self._lambda_binder([(lam.param, akey, child_t),
                                    (lam.index_param, xkey, child_t)]).bind(lam.body)
        rt, impl = bind_reduce_func(name, base, body, akey, xkey, child_t)
        return B.BoundFunction(name, [base], rt, impl)

    def _bind_lambda(self, name: str, e: N.FunctionCall):
        """list_transform / list_filter with x -> … or (x, i) -> …."""
        from duckdb_tpu_torch.planner.functions_nested import bind_lambda_func

        base = self.bind(e.args[0])
        lam = e.args[1]
        child_t = base.ltype.child or SQLNULL
        pkey = f"__lambda_{lam.param}"
        params = [(lam.param, pkey, child_t)]
        ikey = None
        if lam.index_param:
            ikey = f"__lambda_{lam.index_param}"
            params.append((lam.index_param, ikey, BIGINT))
        body = self._lambda_binder(params).bind(lam.body)
        rt, impl = bind_lambda_func(name, base, body, pkey, child_t, ikey=ikey)
        return B.BoundFunction(name, [base], rt, impl)

    def _bind_WindowFunction(self, e):
        if self.window_collector is None:
            raise BindError("Binder Error: window functions are not allowed here")
        return self.window_collector(e, self)

    # -- subqueries (the planner flattens or evaluates them) -------------------
    def _bind_subquery(self, e):
        if self.subquery_binder is None:
            raise BindError("subqueries not supported in this context")
        return self.subquery_binder(e, self)

    _bind_ScalarSubquery = _bind_subquery
    _bind_InSubquery = _bind_subquery
    _bind_Exists = _bind_subquery


def _add_months(base: B.BoundExpr, interval, sign: int) -> B.BoundExpr:
    """A DATE or TIMESTAMP column ± a constant (months, days, micros)
    interval → TIMESTAMP, as DuckDB's AddOperator: the months move the
    calendar date, whose day is clamped to the new month's last, then the
    days and micros add."""
    from duckdb_tpu_torch.planner.functions_ext import civil_to_days

    months, days, micros = (sign * v for v in interval)
    us_day = 86_400_000_000
    is_date = base.ltype.id is TypeId.DATE

    def impl(env, cols, node):
        a = cols[0]
        us = a.data.to(torch.int64) * us_day if is_date else a.data.to(torch.int64)
        day = torch.div(us, us_day, rounding_mode="floor")
        y, m, d = B.civil_from_days(day)
        total = y * 12 + (m - 1) + months
        ny = torch.div(total, 12, rounding_mode="floor")
        nm = total - ny * 12 + 1
        first = civil_to_days(ny, nm, torch.ones_like(nm))
        last = civil_to_days(ny + (nm == 12).to(torch.int64), torch.remainder(nm, 12) + 1,
                             torch.ones_like(nm)) - first
        out = (first + torch.minimum(d, last) - 1 + days) * us_day + (us - day * us_day) + micros
        return Column(data=out, ltype=TIMESTAMP, validity=a.validity)

    return B.BoundFunction("__add_months", [base], TIMESTAMP, impl)


# operators called as functions ("+"(1, 2), add(a, b), "~~"(s, p)): DuckDB
# registers each operator under its symbol and name (function_list.cpp);
# the call is rewritten to the operator's expression
_ARITH_NAMES = {"+": "+", "-": "-", "*": "*", "/": "/", "//": "//", "%": "%", "add": "+",
                "subtract": "-", "multiply": "*", "divide": "/", "mod": "%", "||": "||"}
_CMP_NAMES = {"=": "=", "==": "=", "!=": "<>", "<>": "<>", "<": "<", "<=": "<=", ">": ">",
              ">=": ">="}
_CALL_NAMES = {"~~~": "glob", "^@": "starts_with", "@>": "list_has_all", "&&": "list_has_any",
               "<->": "list_distance", "<=>": "list_cosine_distance", "^": "power",
               "**": "power"}
OPERATOR_NAMES = (set(_ARITH_NAMES) | set(_CMP_NAMES) | set(_CALL_NAMES)
                  | {"~~", "!~~", "~~*", "!~~*", "<@", "@", "!__postfix", "__between",
                     "IS DISTINCT FROM", "IS NOT DISTINCT FROM", "&", "|", "<<", ">>", "~",
                     "xor"})


def _op_function_rewrite(name: str, args) -> Optional[N.Expr]:
    """The expression an operator's function call stands for, or None."""
    n = len(args)
    if n == 2 and name == "mod":
        return None  # mod() is functions_ext's (exact truncation)
    if n == 2 and name in _ARITH_NAMES:
        return N.BinaryOp(_ARITH_NAMES[name], args[0], args[1])
    if n == 1 and name == "-":
        return N.UnaryOp("-", args[0])
    if n == 2 and name in _CMP_NAMES:
        return N.BinaryOp(_CMP_NAMES[name], args[0], args[1])
    if n == 2 and name in ("~~", "!~~", "~~*", "!~~*"):
        return N.LikeExpr(args[0], args[1], negated=name.startswith("!"),
                          case_insensitive=name.endswith("*"))
    if n == 2 and name in _CALL_NAMES:
        return N.FunctionCall(_CALL_NAMES[name], list(args))
    if n == 2 and name == "<@":
        return N.FunctionCall("list_has_all", [args[1], args[0]])
    if n == 1 and name == "@":
        return N.FunctionCall("abs", list(args))
    if n == 1 and name == "!__postfix":
        return N.FunctionCall("factorial", list(args))
    if n == 2 and name in ("is distinct from", "is not distinct from"):
        return N.IsDistinctFrom(args[0], args[1], negated="not" in name)
    if n == 3 and name == "__between":
        return N.Between(args[0], args[1], args[2])
    return None


# a dictionary product up to this many entries becomes one remap LUT
CONCAT_PRODUCT_LIMIT = 1 << 18


def concat_pair(env, a: Column, b: Column) -> Column:
    """VARCHAR || VARCHAR over dictionary codes. A constant side (a
    one-entry dictionary with no NULL) makes it a transform of the other
    side's dictionary (ops/strings.op_concat_const on the device from
    DEVICE_STR_MIN_DICT values); two small dictionaries concatenate every
    pair once into a LUT indexed by (code_a, code_b); otherwise the rows
    are concatenated on the host and re-encoded. NULL propagates."""
    valid = B._and_validity(a.validity, b.validity)
    na, nb = len(a.dict_values), len(b.dict_values)
    for col, const, const_is_suffix in ((a, b, True), (b, a, False)):
        if len(const.dict_values) != 1 or const.validity is not None:
            continue
        k = str(const.dict_values[0])
        pre, sfx = ("", k) if const_is_suffix else (k, "")
        dev = None
        if k.isascii():
            dev = lambda p, le: dstr.op_concat_const(p, le, pre, sfx)  # noqa: E731
        c = F.dict_transform(col, lambda s: pre + s + sfx, device=dev,
                             device_key=f"concat:{pre!r}:{sfx!r}")
        return Column(data=c.data, ltype=VARCHAR, validity=valid,
                      dict_values=c.dict_values)
    device = env.live.device
    ca = B.bcast(a.data, env.plen).long().clamp(0, max(na - 1, 0))
    cb = B.bcast(b.data, env.plen).long().clamp(0, max(nb - 1, 0))
    if na * nb <= CONCAT_PRODUCT_LIMIT:
        prod = np.array([x + y for x in a.dict_values for y in b.dict_values] or [""],
                        dtype=object)
        uniq, inv = np.unique(prod.astype(str), return_inverse=True)
        lut = torch.from_numpy(inv.reshape(-1).astype(np.int32)).to(device)
        return Column(data=lut[ca * nb + cb], ltype=VARCHAR, validity=valid,
                      dict_values=uniq.astype(object))
    # near-unique dictionaries: per row on the host (one transfer each way)
    strs = np.char.add(a.dict_values[ca.cpu().numpy()].astype(str),
                       b.dict_values[cb.cpu().numpy()].astype(str))
    uniq, inv = np.unique(strs, return_inverse=True)
    return Column(data=torch.from_numpy(inv.reshape(-1).astype(np.int32)).to(device),
                  ltype=VARCHAR, validity=valid, dict_values=uniq.astype(object))
