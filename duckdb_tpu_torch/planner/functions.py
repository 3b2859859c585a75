"""Scalar function registry (the core of the JAX package's registry).

Each entry is bind(arg_exprs) → (result type, impl(env, cols, node) →
Column, bound args). This module carries the date parts, the numeric core
and the string core (substring, upper/lower, trim, length, contains,
prefix, suffix); planner/functions_ext.py registers the extended library.
planner/functions_nested.py registers the nested functions,
planner/functions_more.py and functions_parity.py the rest of the scalar
library, and storage/json_io.py the JSON functions; the binder reports any
function missing here as not yet ported.

A string function runs once per distinct dictionary value, never per row,
and its result is gathered by code. From ops/strings.DEVICE_STR_MIN_DICT
values it runs as a plane op on the column's device (ops/strings); below
that, or over non-ASCII text, as a Python loop over the dictionary. Both
results are cached per dictionary.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from duckdb_tpu_torch.blocks import Column
from duckdb_tpu_torch.blocks.nested import NESTED_IDS, UNSORTED_DICT_IDS
from duckdb_tpu_torch.ops import int128 as I128
from duckdb_tpu_torch.ops import strings as dstr
from duckdb_tpu_torch.planner.bound import (
    BindError,
    BoundLiteral,
    EvalEnv,
    _coerce_to,
    _to_double,
    bcast,
    civil_from_days,
    raise_if_read,
    raise_on_overflow,
    varchar_where,
)
from duckdb_tpu_torch.types import (
    BIGINT,
    BOOLEAN,
    DATE,
    DOUBLE,
    TIME,
    TIMESTAMP,
    VARCHAR,
    TypeId,
    decimal,
    max_logical_type,
)


# -- string functions over dictionaries ----------------------------------------
def _null_column(col: Column, ltype, dict_values=None) -> Column:
    """An all-NULL column of `ltype` shaped like col."""
    return Column(data=torch.zeros(col.data.shape, dtype=ltype.torch_dtype,
                                   device=col.data.device),
                  ltype=ltype,
                  validity=torch.zeros(col.data.shape, dtype=torch.bool,
                                       device=col.data.device),
                  dict_values=dict_values)


def _gather(lut: torch.Tensor, col: Column) -> torch.Tensor:
    return lut[col.data.long().clamp(0, lut.shape[0] - 1)]


def per_value(fn, dvals, fill):
    """fn over each dictionary value; a value fn raises ValueError on gets
    `fill` → (values, {failing index: its error})."""
    out, errs = [], {}
    for i, s in enumerate(dvals):
        try:
            out.append(fn(s))
        except ValueError as e:
            out.append(fill)
            errs[i] = e
    return out, errs


def dict_transform(col: Column, fn: Callable[[str], str],
                   device: Optional[Callable] = None, device_key: str = "",
                   env: Optional[EvalEnv] = None) -> Column:
    """Apply a str → str fn per distinct value and re-encode the codes
    into the sorted dictionary of the results. `device`, a plane op of
    ops/strings, runs the transform on the column's device from
    DEVICE_STR_MIN_DICT values; below that, over non-ASCII text, or
    without one, a host loop runs fn. `device_key` names the transform
    (and keys its cached LUT). A value fn raises ValueError on fails the
    statement only where a row of `env` reads it (raise_if_read)."""
    if col.ltype.id in NESTED_IDS or (col.dict_values is None and col.ltype.id not in (
            TypeId.VARCHAR, TypeId.SQLNULL)):
        # a nested column's dictionary holds tuples, not text (F30)
        raise BindError(f"Binder Error: string function over {col.ltype!r} "
                        "argument (no implicit cast)")
    if col.dict_values is None:
        return _null_column(col, VARCHAR, np.array([""], dtype=object))  # fn(NULL)
    dvals = col.dict_values
    dev = col.data.device
    nd = len(dvals)
    res = None
    if device is not None and nd >= dstr.DEVICE_STR_MIN_DICT:
        lut = dstr.device_transform_lut(dvals, device_key, device, dev)
        res = None if lut is None else lut + ({},)

    def host():
        dstr.note_host_loop(device_key, nd, dstr.DEVICE_STR_MIN_DICT)
        vals, errs = per_value(fn, dvals, "")
        new_vals = np.array(vals or [""], dtype=object)
        uniq, inv = np.unique(new_vals.astype(str), return_inverse=True)
        return (torch.from_numpy(inv.reshape(-1).astype(np.int32)).to(dev), uniq.astype(object),
                errs)

    if res is None:
        res = dstr.cached_lut(dvals, ("t_host", device_key, str(dev)), host)
    remap, uniq, errs = res
    raise_if_read(col, errs, env)
    return Column(data=_gather(remap, col), ltype=VARCHAR, validity=col.validity,
                  dict_values=uniq)


def _dict_lut(col: Column, fn, device, device_key: str, ltype, np_dtype, env=None) -> Column:
    """Per-distinct-value predicate (BOOLEAN) or integer fn (BIGINT) → a
    LUT gathered by code; `device` (a plane op) computes it on the
    column's device from DEVICE_STR_MIN_DICT values; failures as in
    dict_transform."""
    if col.dict_values is None:  # typed-NULL input
        return _null_column(col, ltype)
    dvals = col.dict_values
    dev = col.data.device
    nd = len(dvals)
    res = None
    if device is not None and nd >= dstr.DEVICE_STR_MIN_DICT:
        lut = dstr.device_value_lut(dvals, device_key, device, dev)
        res = None if lut is None else (lut, {})

    def host():
        dstr.note_host_loop(device_key, nd, dstr.DEVICE_STR_MIN_DICT)
        vals, errs = per_value(fn, dvals, 0)
        vals = np.array(vals, dtype=np_dtype) if nd else np.zeros(1, np_dtype)
        return torch.from_numpy(vals).to(dev), errs

    if res is None:
        res = dstr.cached_lut(dvals, ("v_host", device_key, str(dev)), host)
    lut, errs = res
    raise_if_read(col, errs, env)
    return Column(data=_gather(lut, col).to(ltype.torch_dtype), ltype=ltype,
                  validity=col.validity)


def dict_predicate(col: Column, fn, device=None, device_key: str = "", env=None) -> Column:
    return _dict_lut(col, fn, device, device_key, BOOLEAN, np.bool_, env)


def dict_int(col: Column, fn, device=None, device_key: str = "", env=None) -> Column:
    return _dict_lut(col, fn, device, device_key, BIGINT, np.int64, env)


def duckdb_substring(s: str, start: int, length: Optional[int]) -> str:
    """DuckDB's substring (function/scalar/string/substring.cpp,
    SubstringStartEnd): a 1-based start; 0 starts one character before
    the first; a negative start counts from the end (clamped at the
    first character); a negative length takes the characters before the
    start; no length takes the rest."""
    n = len(s)
    if length is None:
        length = (1 << 32) - 1
    if length == 0:
        return ""
    if start > 0:
        lo = min(n, start - 1)
    elif start < 0:
        lo = max(n + start, 0)
    else:
        lo = 0
        length -= 1
        if length <= 0:
            return ""
    if length > 0:
        return s[lo:min(n, lo + length)]
    return s[max(0, lo + length):lo]


# -- date part extraction ----------------------------------------------------
def _extract_impl(part: str):
    def impl(env: EvalEnv, cols, node):
        c = cols[0]
        if c.ltype.id is TypeId.TIME or part in ("hour", "minute", "second",
                                                 "millisecond", "microsecond"):
            us = c.data.to(torch.int64)
            if c.ltype.id is not TypeId.TIME:
                us = torch.remainder(us, 86400_000_000)
            if part == "hour":
                out = us // 3_600_000_000
            elif part == "minute":
                out = us // 60_000_000 % 60
            elif part == "second":
                out = us // 1_000_000 % 60
            elif part == "millisecond":
                out = us // 1_000 % 60_000
            else:
                out = us % 60_000_000
            return Column(data=out, ltype=BIGINT, validity=c.validity)
        if c.ltype.id is TypeId.TIMESTAMP:
            days = c.data // 86400_000_000
        else:
            days = c.data.to(torch.int64)
        y, m, d = civil_from_days(days)
        if part == "year":
            out = y
        elif part == "month":
            out = m
        elif part == "day":
            out = d
        elif part == "quarter":
            out = (m - 1) // 3 + 1
        elif part == "decade":
            out = torch.where(y >= 0, y // 10, -((-y + 9) // 10))
        elif part == "century":
            out = torch.where(y > 0, (y + 99) // 100, -((-y + 100) // 100) + 1)
        elif part in ("dow", "dayofweek"):
            out = torch.remainder(days + 4, 7)  # 1970-01-01 was Thursday; Sunday=0
        elif part in ("doy", "dayofyear"):
            out = d + _days_before_month(y, m)
        else:
            raise BindError(f"unsupported extract part {part}")
        return Column(data=out.to(torch.int64), ltype=BIGINT, validity=c.validity)

    return impl


def _days_before_month(y, m):
    cum = torch.tensor([0, 31, 59, 90, 120, 151, 181, 212, 243, 273, 304, 334],
                       dtype=torch.int64, device=y.device)
    leap = ((y % 4 == 0) & ((y % 100 != 0) | (y % 400 == 0))).to(torch.int64)
    return cum[m - 1] + torch.where(m > 2, leap, 0)


# -- registry ---------------------------------------------------------------
# name → bind(arg_exprs) -> (result_type, impl(env, cols, node) -> Column, args)
REGISTRY = {}


# DuckDB's argument counts of the registered functions that take a fixed
# few: name → the counts it has an overload for. The binder checks a
# call's count against this before it binds the function, so a call with
# an arity DuckDB has no overload for raises its Binder Error and never
# reaches the function's binder or its implementation. A function
# declares its counts here, or where it registers (register(name, arity)),
# never both.
ARITY = {}


def arity_counts(arity):
    """n (exactly n), (lo, hi) (hi None: any number from lo) or a set of
    counts → a container of the counts."""
    if isinstance(arity, int):
        return range(arity, arity + 1)
    if isinstance(arity, tuple):
        lo, hi = arity
        return range(lo, (1 << 31) if hi is None else hi + 1)
    return frozenset(arity)


def _declare(name, arity):
    if name in ARITY:
        raise ValueError(f"{name}'s argument counts are declared twice")
    ARITY[name] = arity_counts(arity)


def _arities():
    for names, lo, hi in [
        ("abs acos ascii asin atan bit_count cardinality cbrt ceil ceiling century "
         "char_length character_length cos cosh day dayname dayofweek dayofyear "
         "decade degrees dow doy epoch even exp factorial floor "
         "gamma hour initcap isfinite isinf isnan isodow json "
         "json_pretty json_quote json_strip_nulls json_structure json_valid "
         "last_day lcase len length lgamma ln log10 log2 lower "
         "map_from_entries map_keys map_values md5 microsecond millisecond minute "
         "month monthname nanosecond normalized_interval ord "
         "quarter radians reverse row_to_json "
         "array_to_json second sign sin sinh sqrt stats strlen tan "
         "tanh to_json ucase unicode upper "
         "uuid_extract_timestamp uuid_extract_version vector_type week weekofyear "
         "year array_unique list_unique", 1, 1),
        ("age array_length list_length json_array_length json_keys json_type "
         "json_typeof log round trim ltrim rtrim trunc",
         1, 2),
        ("grade_up array_grade_up list_grade_up", 1, 3),
        ("atan2 pow power nextafter ifnull nullif left right repeat instr "
         "json_contains in_search_path array_has_all "
         "array_has_any array_intersect array_where array_select "
         "array_cross_product list_has_all list_has_any list_intersect list_where "
         "list_select", 2, 2),
        ("hash concat coalesce least greatest", 1, None),
    ]:
        for n in names.split():
            _declare(n, (lo, hi))
    _declare("make_date", {1, 3})
    for names, arity in [("mod gcd greatest_common_divisor lcm least_common_multiple get_bit "
                          "date_part datepart", 2),
                         ("set_bit", 3), ("range generate_series", (1, 3)),
                         ("path_join", (1, None)), ("json_merge_patch", (2, None))]:
        for n in names.split():
            _declare(n, arity)


_arities()

# DuckDB's parameter types of the functions whose implementation reads an
# argument as one kind of value: name → one kind per position (a position
# past the tuple is not checked). The binder applies them (check_params):
# - a type kind ("int", "double", "date", "time", "timestamp") is the type
#   a VARCHAR string literal is read as, as DuckDB reads a literal: text
#   that does not read raises its Conversion Error. A VARCHAR column or
#   expression has no overload there (DuckDB casts no VARCHAR implicitly):
#   Binder Error. An argument of another type passes to the function;
# - a shape kind ("list", "map", "nested", "str", "interval") is what the
#   argument must be (or NULL): anything else is DuckDB's Binder Error;
# - "any" is not checked.
PARAMS = {}
PARAM_TYPES = {"int": BIGINT, "double": DOUBLE, "date": DATE, "time": TIME,
               "timestamp": TIMESTAMP}
_SHAPES = {
    "list": (TypeId.LIST, TypeId.ARRAY),
    "map": (TypeId.MAP,),
    "nested": (TypeId.LIST, TypeId.ARRAY, TypeId.MAP),
    "str": (TypeId.VARCHAR,),
    "interval": (TypeId.INTERVAL,),
}


def _params():
    for names, kinds in [
        # numbers (F17): a VARCHAR literal reads as DOUBLE
        ("abs acos acosh asin asinh atan atanh cbrt ceil ceiling cos cosh cot degrees even "
         "exp floor gamma isfinite isinf isnan lgamma ln log10 log2 radians sign signbit sin "
         "sinh sqrt tan tanh setseed to_timestamp to_seconds to_milliseconds",
         ("double",)),
        ("atan2 log nextafter pow power", ("double", "double")),
        ("round trunc", ("double", "int")),
        ("bar", ("double", "double", "double", "int")),
        ("equi_width_bins", ("double", "double", "int")),
        ("factorial chr format_bytes formatReadableSize formatreadablesize "
         "formatReadableDecimalSize formatreadabledecimalsize to_days to_hours to_minutes "
         "to_microseconds to_weeks make_timestamp_ms make_timestamp_ns",
         ("int",)),
        ("gcd greatest_common_divisor lcm least_common_multiple", ("int", "int")),
        ("to_base range generate_series", ("int", "int", "int")),
        ("make_date", ("int", "int", "int")),
        ("make_time", ("int", "int", "double")),
        ("make_timestamp", ("int", "int", "int", "int", "int", "double")),
        # the calendar parts
        ("year month day dayofmonth quarter decade century millennium era dayofweek "
         "dayofyear doy dow isodow isoyear week weekofyear weekday yearweek dayname "
         "monthname last_day julian", ("date",)),
        ("hour minute second millisecond microsecond nanosecond", ("timestamp",)),
        # the string functions (F30: a LIST is no string)
        ("reverse strlen lower upper lcase ucase initcap", ("str",)),
        ("translate replace", ("str", "str", "str")),
        ("trim ltrim rtrim", ("str", "str")),
        ("left right left_grapheme right_grapheme", ("str", "int")),
        ("repeat get_bit setval bitstring", ("any", "int")),
        ("set_bit", ("any", "int", "int")),
        ("lpad rpad", ("str", "int", "str")),
        ("substring substr substring_grapheme", ("str", "int", "int")),
        ("split_part regexp_extract regexp_extract_all", ("str", "str", "int")),
        ("split str_split string_split string_to_array", ("str", "str")),
        # the list and map functions (F28)
        ("array_append list_append list_contains array_contains list_has array_has "
         "list_position list_indexof array_position array_indexof list_length array_length "
         "list_unique array_unique list_grade_up array_grade_up grade_up",
         ("list",)),
        ("array_prepend list_prepend", ("any", "list")),
        ("list_has_all list_has_any array_has_all array_has_any list_intersect "
         "array_intersect list_where array_where list_select array_select "
         "array_cross_product map", ("list", "list")),
        ("list_slice array_slice", ("list", "int", "int", "int")),
        ("list_resize array_resize", ("list", "int")),
        ("map_keys map_values map_entries map_contains map_extract map_extract_value",
         ("map",)),
        ("cardinality element_at", ("nested",)),
        ("time_bucket", ("interval",)),
    ]:
        for n in names.split():
            if n in PARAMS:
                raise ValueError(f"{n}'s parameters are declared twice")
            PARAMS[n] = kinds


_params()


def no_match(name: str, args) -> BindError:
    """DuckDB's Binder Error for a call that no overload of name takes."""
    types = ", ".join(repr(a.ltype) for a in args)
    return BindError(f"Binder Error: No function matches the given name and argument "
                     f"types '{name}({types})'. You might need to add explicit type casts.")


def check_params(name: str, args, cast):
    """The arguments of a call to `name` under its PARAMS: a VARCHAR
    string literal in a type kind's position → cast(literal, type); an
    argument that no overload takes raises no_match."""
    kinds = PARAMS.get(name)
    if kinds is None:
        return args
    out = list(args)
    for i, (a, kind) in enumerate(zip(args, kinds)):
        tid = a.ltype.id
        if kind == "any" or tid is TypeId.SQLNULL:
            continue
        if kind in _SHAPES:
            if tid not in _SHAPES[kind]:
                raise no_match(name, args)
        elif tid is TypeId.VARCHAR:
            if not isinstance(a, BoundLiteral):
                raise no_match(name, args)
            out[i] = cast(a, PARAM_TYPES[kind])
    return out


def check_arity(name: str, args) -> None:
    """DuckDB's Binder Error for a call with an argument count that
    ARITY says the function has no overload for."""
    if name in ARITY and len(args) not in ARITY[name]:
        raise no_match(name, args)


def register(name, arity=None):
    """Register a binder under name; arity (as arity_counts takes it), if
    given, is DuckDB's argument counts for it, checked by check_arity."""
    def deco(fn):
        if arity is not None:
            _declare(name, arity)
        REGISTRY[name] = fn
        return fn

    return deco


@register("extract")
@register("date_part")
def _bind_extract(arg_exprs):
    # first arg is the part name literal
    part = arg_exprs[0].const_value()
    return BIGINT, _extract_impl(str(part).lower()), arg_exprs[1:]


def _bind_part(p):
    def bind(arg_exprs):
        return BIGINT, _extract_impl(p), arg_exprs
    return bind


for _p in ("year", "month", "day", "quarter", "decade", "century", "dayofweek",
           "dayofyear", "doy", "dow", "hour", "minute", "second",
           "millisecond", "microsecond"):
    REGISTRY[_p] = _bind_part(_p)


@register("abs")
def _bind_abs(arg_exprs):
    t = arg_exprs[0].ltype

    def impl(env, cols, node):
        c = cols[0]
        if c.data_hi is not None:
            w = I128.limbs(c.data, c.data_hi, env.plen)
            (nh, nl), ovf = I128.neg(w)
            raise_on_overflow(ovf & (w[0] < 0), c.validity, env, "HUGEINT abs")
            neg = w[0] < 0
            return Column(data=torch.where(neg, nl, w[1]), ltype=t, validity=c.validity,
                          data_hi=torch.where(neg, nh, w[0]))
        return Column(data=torch.abs(c.data), ltype=t, validity=c.validity)

    return t, impl, arg_exprs


@register("round")
def _bind_round(arg_exprs):
    t = arg_exprs[0].ltype
    ndv = arg_exprs[1].const_value() if len(arg_exprs) > 1 else 0
    if ndv is None:
        # round(x, NULL) → NULL (reference NULL propagation)
        def impl(env, cols, node):
            c = cols[0]
            return Column(data=torch.zeros(c.data.shape, dtype=torch.float64,
                                           device=c.data.device),
                          ltype=DOUBLE,
                          validity=torch.zeros(c.data.shape, dtype=torch.bool,
                                               device=c.data.device))
        return DOUBLE, impl, arg_exprs[:1]
    pt = arg_exprs[1].ltype if len(arg_exprs) > 1 else None
    if pt is not None and pt.id is TypeId.DECIMAL:  # a scaled integer: its value, rounded
        q, r = divmod(abs(int(ndv)), 10 ** pt.scale)
        nd = (q + (2 * r >= 10 ** pt.scale)) * (1 if ndv >= 0 else -1)
    else:
        nd = int(round(ndv)) if isinstance(ndv, float) else int(ndv)
    # past 400 digits either way a DOUBLE or DECIMAL rounds to itself or to 0
    nd = max(-400, min(400, nd))
    if t.id is TypeId.DECIMAL:
        rt = decimal(t.width, min(t.scale, nd))

        def impl(env, cols, node):
            c = cols[0]
            drop = 10 ** (t.scale - rt.scale)
            if drop == 1:
                return c
            x = c.data.to(torch.int64)
            half = drop // 2
            d = torch.where(x >= 0, (x + half) // drop, -((-x + half) // drop))
            return Column(data=d, ltype=rt, validity=c.validity)

        return rt, impl, arg_exprs[:1]

    def impl(env, cols, node):
        c = cols[0]
        if abs(nd) > 300:  # past DOUBLE's digits: the value itself, or 0
            x = _to_double(c)
            return Column(data=x if nd > 0 else x * 0.0, ltype=DOUBLE, validity=c.validity)
        scale = 10.0**nd
        x = _to_double(c) * scale
        # duckdb rounds half away from zero (not banker's rounding)
        d = torch.sign(x) * torch.floor(torch.abs(x) + 0.5) / scale
        return Column(data=d, ltype=DOUBLE, validity=c.validity)

    return DOUBLE, impl, arg_exprs[:1]


def _bind_double_fn(fn):
    def bind(arg_exprs):
        def impl(env, cols, node):
            return Column(data=fn(_to_double(cols[0])), ltype=DOUBLE,
                          validity=cols[0].validity)
        return DOUBLE, impl, arg_exprs
    return bind


REGISTRY["floor"] = _bind_double_fn(torch.floor)
REGISTRY["ceil"] = REGISTRY["ceiling"] = _bind_double_fn(torch.ceil)
REGISTRY["sqrt"] = _bind_double_fn(torch.sqrt)


@register("coalesce")
def _bind_coalesce(arg_exprs):
    t = arg_exprs[0].ltype
    for a in arg_exprs[1:]:
        if a.ltype.id is not TypeId.SQLNULL:
            t = max_logical_type(t, a.ltype)

    def impl(env, cols, node):
        device = env.live.device

        def valid(c):
            if c.validity is None:
                return torch.ones(env.plen, dtype=torch.bool, device=device)
            return bcast(c.validity, env.plen)

        wide = t.id is TypeId.HUGEINT
        coded = t.id is TypeId.VARCHAR or t.id in UNSORTED_DICT_IDS
        acc = _coerce_to(cols[-1], t, env)
        data = bcast(acc.data, env.plen)
        dvals = acc.dict_values
        hi = I128.limbs(acc.data, acc.data_hi, env.plen)[0] if wide else None
        vmask = valid(acc)
        for c in reversed(cols[:-1]):
            cc = _coerce_to(c, t, env)
            cv = valid(cc)
            if coded:  # codes of two dictionaries: merged first
                data, dvals = varchar_where(cv, cc, Column(data=data, ltype=t,
                                                           dict_values=dvals), env.plen)
            else:
                data = torch.where(cv, bcast(cc.data, env.plen), data)
            if wide:
                hi = torch.where(cv, I128.limbs(cc.data, cc.data_hi, env.plen)[0], hi)
            vmask = cv | vmask
        return Column(data=data, ltype=t, validity=vmask, data_hi=hi, dict_values=dvals)

    return t, impl, arg_exprs


# -- string functions -----------------------------------------------------------
@register("substring")
@register("substr")
def _bind_substring(arg_exprs):
    """substring(s, start[, length]) with constant start and length, by
    DuckDB's rules (`duckdb_substring`). A start ≥ 0 with a length ≥ 0 (or
    none) runs as the plane op; a negative start or length takes the host
    loop. (The JAX package slices Python strings at start - 1, which gives
    '' for a start of 0 and counts a negative start one off: ROADMAP
    Queue 3.)"""
    start = arg_exprs[1].const_value()
    length = arg_exprs[2].const_value() if len(arg_exprs) > 2 else None
    null = start is None or (len(arg_exprs) > 2 and length is None)
    s = None if null else int(start)
    ln = None if length is None else int(length)

    def impl(env, cols, node):
        c = cols[0]
        if null:
            return _null_column(c, VARCHAR, np.array([""], dtype=object))
        dev = None
        if s >= 0 and (ln is None or ln >= 0):
            # a start of 0 begins one character before the first
            s0 = max(s - 1, 0)
            n = ln if s > 0 or ln is None else max(ln - 1, 0)
            dev = lambda p, le: dstr.op_substring(p, le, s0, n)  # noqa: E731
        return dict_transform(c, lambda x: duckdb_substring(x, s, ln), device=dev,
                              device_key=f"substr:{s}:{ln}")

    return VARCHAR, impl, arg_exprs[:1]


def _bind_case(upper: bool):
    def bind(arg_exprs):
        def impl(env, cols, node):
            return dict_transform(cols[0], str.upper if upper else str.lower,
                                  device=lambda p, le: dstr.op_case(p, le, upper),
                                  device_key=f"case:{upper}")
        return VARCHAR, impl, arg_exprs
    return bind


REGISTRY["upper"] = REGISTRY["ucase"] = _bind_case(True)
REGISTRY["lower"] = REGISTRY["lcase"] = _bind_case(False)


def _bind_trim(left: bool, right: bool):
    def bind(arg_exprs):
        chars = " " if len(arg_exprs) < 2 else str(arg_exprs[1].const_value())
        host = {(True, True): str.strip, (True, False): str.lstrip,
                (False, True): str.rstrip}[(left, right)]

        def impl(env, cols, node):
            dev = None
            if chars.isascii():
                cb = chars.encode("ascii")
                dev = lambda p, le: dstr.op_trim(p, le, cb, left, right)  # noqa: E731
            return dict_transform(cols[0], lambda x: host(x, chars), device=dev,
                                  device_key=f"trim:{left}:{right}:{chars}")
        return VARCHAR, impl, arg_exprs[:1]
    return bind


REGISTRY["trim"] = _bind_trim(True, True)
REGISTRY["ltrim"] = _bind_trim(True, False)
REGISTRY["rtrim"] = _bind_trim(False, True)


_NESTED_LENGTH = (TypeId.LIST, TypeId.ARRAY, TypeId.MAP)


@register("length")
@register("len")
@register("strlen")
def _bind_length(arg_exprs):
    if arg_exprs and arg_exprs[0].ltype.id in _NESTED_LENGTH:
        # the length of a list (or a map's entry count), not of a string
        return REGISTRY["array_length"](arg_exprs[:1])

    def impl(env, cols, node):
        return dict_int(cols[0], len, device=lambda p, le: le, device_key="len")

    return BIGINT, impl, arg_exprs


def _bind_str_predicate(name: str, host: Callable[[str, str], bool], op: Callable):
    """contains / prefix / suffix with a constant needle; a NULL needle
    gives NULL."""
    def bind(arg_exprs):
        needle = arg_exprs[1].const_value()

        def impl(env, cols, node):
            if needle is None:
                return _null_column(cols[0], BOOLEAN)
            needle_s = str(needle)
            dev = None
            if needle_s.isascii():
                dev = lambda p, le: op(p, le, needle_s)  # noqa: E731
            return dict_predicate(cols[0], lambda x: host(x, needle_s), device=dev,
                                  device_key=f"{name}:{needle_s}")
        return BOOLEAN, impl, arg_exprs[:1]
    return bind


_bind_str_contains = _bind_str_predicate("contains", lambda s, n: n in s, dstr.op_contains)


@register("contains")
def _bind_contains(arg_exprs):
    if arg_exprs and arg_exprs[0].ltype.id in (TypeId.LIST, TypeId.ARRAY):
        return REGISTRY["list_contains"](arg_exprs)  # contains over a list
    return _bind_str_contains(arg_exprs)


REGISTRY["starts_with"] = REGISTRY["prefix"] = _bind_str_predicate(
    "prefix", str.startswith, dstr.op_prefix)
# the reference registers these in functions_ext.py (ROADMAP item 27)
REGISTRY["ends_with"] = REGISTRY["suffix"] = _bind_str_predicate(
    "suffix", str.endswith, dstr.op_suffix)


# the extended library (math, conditionals, the rest of the strings, dates,
# misc) registers itself in REGISTRY
from duckdb_tpu_torch.planner import functions_ext  # noqa: E402,F401

# the nested functions and lambdas (LIST, STRUCT, MAP, ARRAY, UNION, BIT)
from duckdb_tpu_torch.planner import functions_nested  # noqa: E402,F401

# the rest of the scalar universe: codecs, similarity, dates and system
# functions; the list vector math, structs, maps and meta functions; JSON
from duckdb_tpu_torch.planner import functions_more  # noqa: E402,F401
from duckdb_tpu_torch.planner import functions_parity  # noqa: E402,F401
from duckdb_tpu_torch.storage import json_io  # noqa: E402,F401
