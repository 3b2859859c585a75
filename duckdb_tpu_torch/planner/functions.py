"""Scalar function registry (the core of the JAX package's registry).

Each entry is bind(arg_exprs) → (result type, impl(env, cols, node) →
Column, bound args). This slice carries the date parts and the numeric
core; string and nested functions come with later slices, and the binder
reports any function missing here as not yet ported.
"""

from __future__ import annotations

import torch

from duckdb_tpu_torch.blocks import Column
from duckdb_tpu_torch.planner.bound import (
    BindError,
    EvalEnv,
    _coerce_to,
    _to_double,
    bcast,
    civil_from_days,
)
from duckdb_tpu_torch.types import (
    BIGINT,
    DOUBLE,
    TypeId,
    decimal,
    max_logical_type,
)


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
