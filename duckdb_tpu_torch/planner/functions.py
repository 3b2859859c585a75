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
from duckdb_tpu_torch.ops import strings as dstr
from duckdb_tpu_torch.planner.bound import (
    BindError,
    EvalEnv,
    _coerce_to,
    _to_double,
    bcast,
    civil_from_days,
    raise_if_read,
)
from duckdb_tpu_torch.types import (
    BIGINT,
    BOOLEAN,
    DOUBLE,
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
    if col.dict_values is None:
        if col.ltype.id not in (TypeId.VARCHAR, TypeId.SQLNULL):
            raise BindError(f"Binder Error: string function over {col.ltype!r} "
                            "argument (no implicit cast)")
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


def register(name):
    def deco(fn):
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
    nd = int(ndv)
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

        acc = _coerce_to(cols[-1], t, env)
        data = bcast(acc.data, env.plen)
        vmask = valid(acc)
        for c in reversed(cols[:-1]):
            cc = _coerce_to(c, t, env)
            cv = valid(cc)
            data = torch.where(cv, bcast(cc.data, env.plen), data)
            vmask = cv | vmask
        return Column(data=data, ltype=t, validity=vmask)

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
