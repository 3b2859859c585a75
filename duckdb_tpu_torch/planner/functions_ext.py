"""The extended scalar function library, registered in planner/functions.REGISTRY.

The JAX package's duckdb_tpu/planner/functions_ext.py (the reference's
core_functions extension: math, conditionals, strings, dates, misc) in
torch. Math and dates are elementwise ops on the column's device (the
calendar math floors explicitly, so dates before 1970 come out right).
String functions run once per distinct dictionary value: from
ops/strings.DEVICE_STR_MIN_DICT values as a plane op on the column's
device where ops/strings has one (left, right, reverse, initcap, lpad,
rpad, repeat, strpos, ascii), else, and for functions without one
(regexp_*, levenshtein, replace, ...), as a host loop over the
dictionary. strftime, bar and the VARCHAR cast format each distinct value
once (bound.format_distinct).

Where DuckDB and the reference differ, the port follows DuckDB, and the
parity tests leave those inputs out: greatest/least skip NULL arguments
(the reference raises on a NULL literal), mod truncates exactly (the
reference divides in float64), right() with a negative count drops
characters from the left, to_hex is hex() (the reference returns its
input), time_bucket counts day buckets from 2000-01-03 and takes months,
and uuid()/random() give a value per row. now() and current_date are read
when the query runs, so a cached plan does not freeze them;
REPLAY_TIME_MICROS pins them (tests use it), and so does a file
database's logged statement (`Session.pin`). random() and the uuid family
draw from the connection's torch.Generator on the column's device
(planner/session.py), which setseed() seeds; while a logged statement or
its replay runs they draw on the host from generators its pinned seed
seeds. nextval/currval read the sequences of the statement's catalog
(CREATE SEQUENCE; currval before any nextval raises, as in DuckDB), and
concat_ws over columns, which the reference refuses too, says it is not
ported. format_bytes is planner/functions_more.py's.
"""

from __future__ import annotations

import datetime
import math
import re
import time
import uuid as _uuid
from typing import Optional

import numpy as np
import torch

from duckdb_tpu_torch.blocks import Column
from duckdb_tpu_torch.blocks.nested import UNSORTED_DICT_IDS
from duckdb_tpu_torch.ops import strings as dstr
from duckdb_tpu_torch.ops.hash import hash64, lsr
from duckdb_tpu_torch.planner.bound import (
    BindError,
    BoundCast,
    _and_validity,
    _coerce_to,
    _decimal_align,
    _to_double,
    _trunc_divmod,
    bcast,
    civil_from_days,
    format_distinct,
    format_varchar,
    not_ported,
    varchar_where,
)
from duckdb_tpu_torch.planner import session
from duckdb_tpu_torch.planner.functions import (
    REGISTRY,
    _days_before_month,
    _null_column,
    dict_int,
    dict_predicate,
    dict_transform,
    register,
)
from duckdb_tpu_torch.types import (
    BIGINT,
    BOOLEAN,
    DATE,
    DOUBLE,
    INTEGER,
    SQLNULL,
    TIMESTAMP,
    VARCHAR,
    TypeId,
    max_logical_type,
)

_US_DAY = 86_400_000_000

# pins now()/current_date (micros since the epoch) when set
REPLAY_TIME_MICROS = None


def _pin():
    s = session.current()
    return None if s is None else s.pin


def _pinned_time() -> Optional[int]:
    if REPLAY_TIME_MICROS is not None:
        return int(REPLAY_TIME_MICROS)
    pin = _pin()
    return None if pin is None or pin[0] is None else int(pin[0])


def pinned_generator() -> Optional[torch.Generator]:
    """Under a pinned statement (`Session.pin`), a host generator seeded
    from its Random (one per draw); else None."""
    pin = _pin()
    if pin is None or pin[1] is None:
        return None
    g = torch.Generator()
    g.manual_seed(pin[1].getrandbits(63))
    return g


def _generator(device) -> torch.Generator:
    """The generator a draw for `device` uses: the pinned host one, else
    the running connection's (planner/session.py: setseed() seeds it).
    Draw on its device (`g.device`) and move the values to `device`."""
    return pinned_generator() or session.active().generator(device)


def _valid_of(cols):
    v = None
    for c in cols:
        v = _and_validity(v, c.validity)
    return v


def _full(env, value, dtype) -> torch.Tensor:
    return torch.full((env.plen,), value, dtype=dtype, device=env.live.device)


def _const_varchar(env, text: str) -> Column:
    return Column(data=_full(env, 0, torch.int32), ltype=VARCHAR,
                  dict_values=np.array([text], dtype=object))


# -- math --------------------------------------------------------------------
def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """Real cube root: |x|^(1/3) with x's sign, then one Newton step."""
    y = torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)
    safe = torch.where(y == 0, 1.0, y)
    return torch.where((y == 0) | ~torch.isfinite(y), y, y - (y * y * y - x) / (3 * safe * safe))


def _unary_math(name, fn):
    def bind(arg_exprs):
        def impl(env, cols, node):
            return Column(data=fn(_to_double(cols[0])), ltype=DOUBLE,
                          validity=cols[0].validity)
        return DOUBLE, impl, arg_exprs
    REGISTRY[name] = bind


for _n, _f in [
    ("ln", torch.log), ("log2", torch.log2), ("log10", torch.log10),
    ("log", torch.log10),  # DuckDB's log(x) is log10
    ("exp", torch.exp), ("sin", torch.sin), ("cos", torch.cos), ("tan", torch.tan),
    ("asin", torch.asin), ("acos", torch.acos), ("atan", torch.atan),
    ("sinh", torch.sinh), ("cosh", torch.cosh), ("tanh", torch.tanh),
    ("degrees", torch.rad2deg), ("radians", torch.deg2rad), ("cbrt", _cbrt),
    ("trunc", torch.trunc), ("lgamma", torch.lgamma),
    ("gamma", lambda x: torch.exp(torch.lgamma(x))),
    ("even", lambda x: torch.where(x >= 0, torch.ceil(x / 2) * 2, torch.floor(x / 2) * 2)),
]:
    _unary_math(_n, _f)


def _binary_double(name, fn):
    def bind(arg_exprs):
        def impl(env, cols, node):
            return Column(data=fn(_to_double(cols[0]), _to_double(cols[1])), ltype=DOUBLE,
                          validity=_valid_of(cols))
        return DOUBLE, impl, arg_exprs
    REGISTRY[name] = bind


_binary_double("pow", torch.pow)
_binary_double("power", torch.pow)
_binary_double("atan2", torch.atan2)
_binary_double("nextafter", torch.nextafter)


def _double_predicate(name, fn):
    def bind(arg_exprs):
        def impl(env, cols, node):
            return Column(data=fn(_to_double(cols[0])), ltype=BOOLEAN,
                          validity=cols[0].validity)
        return BOOLEAN, impl, arg_exprs
    REGISTRY[name] = bind


_double_predicate("isfinite", torch.isfinite)
_double_predicate("isnan", torch.isnan)
_double_predicate("isinf", torch.isinf)


@register("pi")
def _bind_pi(arg_exprs):
    def impl(env, cols, node):
        return Column(data=_full(env, math.pi, torch.float64), ltype=DOUBLE)
    return DOUBLE, impl, arg_exprs


@register("sign")
def _bind_sign(arg_exprs):
    t = arg_exprs[0].ltype

    def impl(env, cols, node):
        c = cols[0]
        d = torch.sign(c.data if t.is_float else c.data.to(torch.int64))
        return Column(data=d.to(torch.int32), ltype=INTEGER, validity=c.validity)
    return INTEGER, impl, arg_exprs


def _least_greatest(arg_exprs, op):
    """DuckDB skips NULL arguments; NULL only when every one is NULL."""
    t = None
    for a in arg_exprs:
        if a.ltype.id is not TypeId.SQLNULL:
            t = a.ltype if t is None else max_logical_type(t, a.ltype)
    t = t or SQLNULL

    def impl(env, cols, node):
        ccs = [_coerce_to(c, t, env) for c in cols]
        merged = None
        if t.id is TypeId.VARCHAR:
            # codes into one merged sorted dictionary order as the strings
            merged = ccs[0].dict_values
            for cc in ccs[1:]:
                merged = np.union1d(merged, cc.dict_values).astype(object)
        acc = any_valid = None
        for cc in ccs:
            v = (torch.ones(env.plen, dtype=torch.bool, device=env.live.device)
                 if cc.validity is None else bcast(cc.validity, env.plen))
            d = bcast(cc.data, env.plen)
            if merged is not None:
                rank = np.searchsorted(merged, cc.dict_values).astype(np.int32)
                d = torch.from_numpy(rank).to(d.device)[d.long().clamp(0, len(rank) - 1)]
            if acc is None:
                acc, any_valid = d, v
            else:
                acc = torch.where(any_valid & v, op(acc, d), torch.where(v, d, acc))
                any_valid = any_valid | v
        return Column(data=acc, ltype=t, validity=any_valid, dict_values=merged)
    return t, impl, arg_exprs


REGISTRY["greatest"] = lambda args: _least_greatest(args, torch.maximum)
REGISTRY["least"] = lambda args: _least_greatest(args, torch.minimum)


@register("factorial")
def _bind_factorial(arg_exprs):
    def impl(env, cols, node):
        lut = torch.tensor([math.factorial(i) for i in range(21)], dtype=torch.int64,
                           device=env.live.device)
        return Column(data=lut[cols[0].data.to(torch.int64).clamp(0, 20)], ltype=BIGINT,
                      validity=cols[0].validity)
    return BIGINT, impl, arg_exprs


def _gcd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Euclid's algorithm on |a|, |b|, elementwise, until every pair is
    done (checked every 8 steps, one host sync each)."""
    x, y = a.abs(), b.abs()
    while True:
        for _ in range(8):
            nz = y != 0
            x, y = torch.where(nz, y, x), torch.where(nz, torch.fmod(x, torch.where(nz, y, 1)), 0)
        if not bool((y != 0).any()):
            return x


@register("gcd")
def _bind_gcd(arg_exprs):
    def impl(env, cols, node):
        a, b = (bcast(c.data, env.plen).to(torch.int64) for c in cols)
        return Column(data=_gcd(a, b), ltype=BIGINT, validity=_valid_of(cols))
    return BIGINT, impl, arg_exprs


@register("lcm")
def _bind_lcm(arg_exprs):
    def impl(env, cols, node):
        a, b = (bcast(c.data, env.plen).to(torch.int64).abs() for c in cols)
        g = _gcd(a, b)
        d = torch.where(g > 0, torch.div(a, g.clamp(min=1), rounding_mode="trunc") * b, 0)
        return Column(data=d, ltype=BIGINT, validity=_valid_of(cols))
    return BIGINT, impl, arg_exprs


_POPCOUNT = [bin(i).count("1") for i in range(256)]


@register("bit_count")
def _bind_bit_count(arg_exprs):
    def impl(env, cols, node):
        x = bcast(cols[0].data, env.plen).to(torch.int64)
        lut = torch.tensor(_POPCOUNT, dtype=torch.int64, device=x.device)
        cnt = lut[x & 0xFF]
        for shift in range(8, 64, 8):
            cnt = cnt + lut[lsr(x, shift) & 0xFF]
        return Column(data=cnt, ltype=BIGINT, validity=cols[0].validity)
    return BIGINT, impl, arg_exprs


@register("mod")
def _bind_mod(arg_exprs):
    """The % operator's semantics, exact (the reference divides in
    float64); BIGINT over integers, as the reference types it, else %'s
    type (DECIMAL, or DOUBLE through fmod)."""
    from duckdb_tpu_torch.planner.binder import _arith_result_type

    a, b = arg_exprs
    t = BIGINT if a.ltype.is_integer and b.ltype.is_integer else \
        _arith_result_type("%", a.ltype, b.ltype)

    def impl(env, cols, node):
        v = _valid_of(cols)
        if t.is_float:
            return Column(data=torch.fmod(_to_double(cols[0]), _to_double(cols[1])), ltype=t,
                          validity=v)
        x, y, _ = _decimal_align(cols[0], cols[1])  # integers: scale 0
        d, v = _trunc_divmod(bcast(x, env.plen), bcast(y, env.plen), v, "%")
        return Column(data=d, ltype=t, validity=v)
    return t, impl, arg_exprs


# -- conditionals ------------------------------------------------------------
@register("nullif")
def _bind_nullif(arg_exprs):
    t = arg_exprs[0].ltype

    def impl(env, cols, node):
        a, b = cols
        bb = _coerce_to(b, t, env)
        if t.id is TypeId.VARCHAR:
            from duckdb_tpu_torch.planner.bound import _varchar_rank_luts

            la, lb = _varchar_rank_luts(a, bb, env.live.device)
            eq = la[bcast(a.data, env.plen).long()] == lb[bcast(bb.data, env.plen).long()]
        else:
            eq = bcast(a.data, env.plen) == bcast(bb.data, env.plen)
        if bb.validity is not None:  # x = NULL is not true: x stays
            eq = eq & bcast(bb.validity, env.plen)
        base = (torch.ones(env.plen, dtype=torch.bool, device=env.live.device)
                if a.validity is None else bcast(a.validity, env.plen))
        return Column(data=bcast(a.data, env.plen), ltype=t, validity=base & ~eq,
                      dict_values=a.dict_values)
    return t, impl, arg_exprs


@register("ifnull")
def _bind_ifnull(arg_exprs):
    return REGISTRY["coalesce"](arg_exprs)


@register("if")
@register("iif")
def _bind_if(arg_exprs):
    t = arg_exprs[1].ltype
    if arg_exprs[2].ltype.id is not TypeId.SQLNULL:
        t = arg_exprs[2].ltype if t.id is TypeId.SQLNULL else max_logical_type(
            t, arg_exprs[2].ltype)

    def impl(env, cols, node):
        cond, a, b = cols
        take = bcast(cond.data.to(torch.bool), env.plen)
        if cond.validity is not None:
            take = take & bcast(cond.validity, env.plen)
        ca, cb = _coerce_to(a, t, env), _coerce_to(b, t, env)
        dvals = None
        if t.id is TypeId.VARCHAR or t.id in UNSORTED_DICT_IDS:
            d, dvals = varchar_where(take, ca, cb, env.plen)
        else:
            d = torch.where(take, bcast(ca.data, env.plen), bcast(cb.data, env.plen))
        ones = torch.ones(env.plen, dtype=torch.bool, device=env.live.device)
        va = ones if ca.validity is None else bcast(ca.validity, env.plen)
        vb = ones if cb.validity is None else bcast(cb.validity, env.plen)
        return Column(data=d, ltype=t, validity=torch.where(take, va, vb), dict_values=dvals)
    return t, impl, arg_exprs


# -- strings ---------------------------------------------------------------------
def _str_transform(name, fn_builder, nconst=0, dev_builder=None):
    """A str → str function with `nconst` constant arguments after the
    string: a NULL constant gives NULL; the plane op from dev_builder
    (None for non-ASCII constants) runs from DEVICE_STR_MIN_DICT values."""
    def bind(arg_exprs):
        if len(arg_exprs) < 1 + nconst:
            raise BindError(f"Binder Error: {name} requires {1 + nconst} arguments, "
                            f"{len(arg_exprs)} given")
        consts = [a.const_value() for a in arg_exprs[1:]]
        if any(c is None for c in consts):
            def impl(env, cols, node):
                return _null_column(cols[0], VARCHAR, np.array([""], dtype=object))
            return VARCHAR, impl, arg_exprs[:1]
        fn = fn_builder(*consts)
        dev = None
        if dev_builder is not None and all(str(c).isascii() for c in consts):
            dev = dev_builder(*consts)
        dkey = f"{name}:{consts!r}"

        def impl(env, cols, node):
            return dict_transform(cols[0], fn, device=dev, device_key=dkey)
        return VARCHAR, impl, arg_exprs[:1]
    REGISTRY[name] = bind


def _left(s: str, n: int) -> str:
    return s[:n] if n >= 0 else s[:max(len(s) + n, 0)]


def _right(s: str, n: int) -> str:
    """The last n characters; n <= 0 drops |n| from the left (DuckDB)."""
    return s[max(len(s) - n, 0):] if n > 0 else s[-n:]


def _host_pad(s: str, n: int, p: str, left: bool) -> str:
    """lpad/rpad: cycle the pad string; a longer value is cut to n."""
    if n <= 0:
        return ""
    if len(s) >= n or not p:
        return s[:n]
    fill = (p * n)[:n - len(s)]
    return fill + s if left else s + fill


def _split_part(sep: str, i: int):
    def f(s):
        parts = s.split(sep)
        return parts[i - 1] if 0 < i <= len(parts) else ""
    return f


_str_transform("reverse", lambda: lambda s: s[::-1], dev_builder=lambda: dstr.op_reverse)
_str_transform("initcap", lambda: lambda s: s[:1].upper() + s[1:].lower(),
               dev_builder=lambda: dstr.op_initcap)
_str_transform("left", lambda n: lambda s: _left(s, int(n)), 1,
               dev_builder=lambda n: lambda p, le: dstr.op_left(p, le, int(n)))
_str_transform("right", lambda n: lambda s: _right(s, int(n)), 1,
               dev_builder=lambda n: lambda p, le: dstr.op_right(p, le, int(n)))
_str_transform("lpad", lambda n, p=" ": lambda s: _host_pad(s, int(n), str(p), True), 2,
               dev_builder=lambda n, p=" ": lambda pl, le: dstr.op_pad(pl, le, int(n), str(p),
                                                                    True))
_str_transform("rpad", lambda n, p=" ": lambda s: _host_pad(s, int(n), str(p), False), 2,
               dev_builder=lambda n, p=" ": lambda pl, le: dstr.op_pad(pl, le, int(n), str(p),
                                                                    False))
_str_transform("repeat", lambda n: lambda s: s * int(n), 1,
               dev_builder=lambda n: lambda p, le: dstr.op_repeat(p, le, int(n)))
_str_transform("replace", lambda a, b: lambda s: s.replace(str(a), str(b)), 2)
_str_transform("split_part", lambda sep, i: _split_part(str(sep), int(i)), 2)
_str_transform("md5", lambda: lambda s: __import__("hashlib").md5(s.encode()).hexdigest())
_str_transform("translate",
               lambda frm, to: lambda s: s.translate(str.maketrans(str(frm), str(to))), 2)


@register("hex")
@register("to_hex")
def _bind_hex(arg_exprs):
    if arg_exprs[0].ltype.id is not TypeId.VARCHAR:
        raise not_ported(f"hex() over {arg_exprs[0].ltype!r}, which the JAX package "
                         "refuses too")

    def impl(env, cols, node):
        return dict_transform(cols[0], lambda s: s.encode().hex().upper(), device_key="hex")
    return VARCHAR, impl, arg_exprs


@register("concat_ws")
def _bind_concat_ws(arg_exprs):
    sep = arg_exprs[0].const_value()

    def impl(env, cols, node):
        if all(c.dict_values is not None and len(c.dict_values) == 1 and c.validity is None
               for c in cols):
            return _const_varchar(env, str(sep).join(str(c.dict_values[0]) for c in cols))
        raise not_ported("concat_ws() over non-constant arguments, which the JAX "
                         "package refuses too")
    return VARCHAR, impl, arg_exprs[1:]


@register("strpos")
@register("position")
@register("instr")
def _bind_strpos(arg_exprs):
    needle = arg_exprs[1].const_value()
    if needle is not None and not isinstance(needle, str):
        needle = format_varchar(needle, arg_exprs[1].ltype)

    def impl(env, cols, node):
        if needle is None:
            return _null_column(cols[0], BIGINT)
        dev = None
        if needle.isascii():
            dev = lambda p, le: dstr.op_strpos(p, le, needle)  # noqa: E731
        return dict_int(cols[0], lambda s: s.find(needle) + 1, device=dev,
                        device_key=f"strpos:{needle}")
    return BIGINT, impl, arg_exprs[:1]


@register("ascii")
def _bind_ascii(arg_exprs):
    def impl(env, cols, node):
        return dict_int(cols[0], lambda s: ord(s[0]) if s else 0, device=dstr.op_ascii,
                        device_key="ascii")
    return BIGINT, impl, arg_exprs


def _host_int_fn(name, fn):
    """A str → int function over the dictionary (no plane op)."""
    def bind(arg_exprs):
        def impl(env, cols, node):
            return dict_int(cols[0], fn, device_key=name)
        return BIGINT, impl, arg_exprs
    REGISTRY[name] = bind


_host_int_fn("unicode", lambda s: ord(s[0]) if s else -1)
_host_int_fn("ord", lambda s: ord(s[0]) if s else -1)
_host_int_fn("uuid_extract_version",
             lambda s: int(s.replace("-", "")[12], 16) if len(s.replace("-", "")) == 32 else 0)


@register("chr")
def _bind_chr(arg_exprs):
    code = arg_exprs[0].const_value()

    def impl(env, cols, node):
        return _const_varchar(env, chr(int(code)))
    return VARCHAR, impl, []


@register("regexp_matches")
def _bind_regexp_matches(arg_exprs):
    pat = re.compile(str(arg_exprs[1].const_value()))

    def impl(env, cols, node):
        return dict_predicate(cols[0], lambda s: pat.search(s) is not None,
                              device_key=f"regexp_matches:{pat.pattern}")
    return BOOLEAN, impl, arg_exprs[:1]


@register("regexp_replace")
def _bind_regexp_replace(arg_exprs):
    pat = re.compile(str(arg_exprs[1].const_value()))
    repl = str(arg_exprs[2].const_value())

    def impl(env, cols, node):
        return dict_transform(cols[0], lambda s: pat.sub(repl, s, count=1),
                              device_key=f"regexp_replace:{pat.pattern}:{repl}")
    return VARCHAR, impl, arg_exprs[:1]


@register("regexp_extract")
def _bind_regexp_extract(arg_exprs):
    pat = re.compile(str(arg_exprs[1].const_value()))
    grp = int(arg_exprs[2].const_value()) if len(arg_exprs) > 2 else 0

    def f(s):
        m = pat.search(s)
        return m.group(grp) if m else ""

    def impl(env, cols, node):
        return dict_transform(cols[0], f, device_key=f"regexp_extract:{pat.pattern}:{grp}")
    return VARCHAR, impl, arg_exprs[:1]


def _lev(a: str, b: str) -> int:
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a):
        cur = [i + 1]
        for j, cb in enumerate(b):
            cur.append(min(prev[j + 1] + 1, cur[j] + 1, prev[j] + (ca != cb)))
        prev = cur
    return prev[-1]


def _hamming(s: str, other: str) -> int:
    return -1 if len(s) != len(other) else sum(x != y for x, y in zip(s, other))


@register("levenshtein")
@register("editdist3")
def _bind_levenshtein(arg_exprs):
    other = str(arg_exprs[1].const_value())

    def impl(env, cols, node):
        return dict_int(cols[0], lambda s: _lev(s, other), device_key=f"lev:{other}")
    return BIGINT, impl, arg_exprs[:1]


@register("hamming")
@register("mismatches")
def _bind_hamming(arg_exprs):
    other = str(arg_exprs[1].const_value())

    def impl(env, cols, node):
        return dict_int(cols[0], lambda s: _hamming(s, other), device_key=f"hamming:{other}")
    return BIGINT, impl, arg_exprs[:1]


@register("bar")
def _bind_bar(arg_exprs):
    """A Unicode bar (core_functions/scalar/bar.cpp), the fractional tail in
    1/8 blocks; formatted once per distinct value."""
    lo = float(arg_exprs[1].const_value())
    hi = float(arg_exprs[2].const_value())
    width = float(arg_exprs[3].const_value()) if len(arg_exprs) > 3 else 80.0
    blocks = "▏▎▍▌▋▊▉█"
    t = arg_exprs[0].ltype
    scale = 10.0 ** t.scale if t.id is TypeId.DECIMAL else 1.0

    def fmt(v) -> str:
        f = min(max((float(v) / scale - lo) / max(hi - lo, 1e-300), 0.0), 1.0) * width
        full = int(f)
        rem = int((f - full) * 8)
        return "█" * full + (blocks[rem - 1] if rem else "")

    def impl(env, cols, node):
        return format_distinct(cols[0], env, fmt)
    return VARCHAR, impl, arg_exprs[:1]


def _format_like(pyfmt):
    """format / printf: per row on the host over every argument (the
    reference's way; the rows' tuples have no dictionary)."""
    def bind(arg_exprs):
        fmt = str(arg_exprs[0].const_value())

        def impl(env, cols, node):
            mats = []
            for c in cols:
                d = bcast(c.data, env.plen).cpu().numpy()
                if c.ltype.id is TypeId.VARCHAR:
                    d = c.dict_values[np.clip(d, 0, len(c.dict_values) - 1)]
                elif c.ltype.id is TypeId.DECIMAL:
                    d = d / (10.0 ** c.ltype.scale)
                mats.append(d)
            strs = [pyfmt(fmt, [m[i] for m in mats]) for i in range(env.plen)]
            uniq, codes = np.unique(np.array(strs, dtype=str), return_inverse=True)
            return Column(data=torch.from_numpy(codes.reshape(-1).astype(np.int32)).to(
                env.live.device), ltype=VARCHAR, validity=_valid_of(cols),
                dict_values=uniq.astype(object))
        return VARCHAR, impl, arg_exprs[1:]
    return bind


REGISTRY["format"] = _format_like(lambda f, a: f.format(*a))
REGISTRY["printf"] = _format_like(lambda f, a: f % tuple(a))


@register("concat")
def _bind_concat_nary(arg_exprs):
    """n-ary concat: a NULL argument is '' (where || gives NULL); other
    types are cast to VARCHAR; pairs combine through ||'s concat_pair."""
    wrapped = [a if a.ltype.id is TypeId.VARCHAR else BoundCast(a, VARCHAR)
               for a in arg_exprs]

    def null_to_empty(c: Column) -> Column:
        if c.validity is None:
            return c
        dvals = c.dict_values if c.dict_values is not None else np.empty(0, object)
        ext = np.concatenate([dvals.astype(object), np.array([""], dtype=object)])
        uniq, inv = np.unique(ext.astype(str), return_inverse=True)
        inv = torch.from_numpy(inv.reshape(-1).astype(np.int32)).to(c.data.device)
        codes = inv[c.data.long().clamp(0, max(len(dvals) - 1, 0))] if len(dvals) \
            else torch.zeros_like(c.data)
        return Column(data=torch.where(c.validity, codes, inv[-1]), ltype=VARCHAR,
                      dict_values=uniq.astype(object))

    def impl(env, cols, node):
        from duckdb_tpu_torch.planner.binder import concat_pair

        acc = null_to_empty(cols[0])
        for c in cols[1:]:
            acc = concat_pair(env, acc, null_to_empty(c))
        return acc
    return VARCHAR, impl, wrapped


# -- dates -----------------------------------------------------------------------
def _days(c: Column) -> torch.Tensor:
    """Days since the epoch of a DATE or TIMESTAMP column (floored)."""
    if c.ltype.id in (TypeId.TIMESTAMP, TypeId.TIMESTAMPTZ):
        return torch.div(c.data, _US_DAY, rounding_mode="floor")
    return c.data.to(torch.int64)


def civil_to_days(y: torch.Tensor, m: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Days since 1970-01-01 of a civil date (Howard Hinnant's algorithm,
    floor divisions explicit)."""
    y = torch.where(m <= 2, y - 1, y)
    era = torch.div(torch.where(y >= 0, y, y - 399), 400, rounding_mode="floor")
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = torch.div(153 * mp + 2, 5, rounding_mode="floor") + d - 1
    doe = yoe * 365 + torch.div(yoe, 4, rounding_mode="floor") \
        - torch.div(yoe, 100, rounding_mode="floor") + doy
    return era * 146097 + doe - 719468


@register("date_trunc")
@register("datetrunc")
def _bind_date_trunc(arg_exprs):
    part = str(arg_exprs[0].const_value()).lower()
    if part not in ("year", "quarter", "month", "week", "day"):
        raise BindError(f"date_trunc part {part}")

    def impl(env, cols, node):
        c = cols[0]
        days = _days(c)
        y, m, d = civil_from_days(days)
        if part == "year":
            out = days - (d - 1) - _days_before_month(y, m)
        elif part == "quarter":
            qm = torch.div(m - 1, 3, rounding_mode="floor") * 3 + 1
            out = days - (d - 1) - (_days_before_month(y, m) - _days_before_month(y, qm))
        elif part == "month":
            out = days - (d - 1)
        elif part == "week":
            out = days - torch.remainder(days + 3, 7)  # back to Monday
        else:
            out = days
        # the reference returns a TIMESTAMP
        return Column(data=out * _US_DAY, ltype=TIMESTAMP, validity=c.validity)
    return TIMESTAMP, impl, arg_exprs[1:]


@register("last_day")
def _bind_last_day(arg_exprs):
    def impl(env, cols, node):
        c = cols[0]
        y, m, _ = civil_from_days(_days(c))
        first_next = civil_to_days(torch.where(m == 12, y + 1, y), torch.where(m == 12, 1, m + 1),
                                   torch.ones_like(m))
        return Column(data=(first_next - 1).to(torch.int32), ltype=DATE, validity=c.validity)
    return DATE, impl, arg_exprs


@register("make_date")
def _bind_make_date(arg_exprs):
    def impl(env, cols, node):
        y, m, d = (bcast(c.data, env.plen).to(torch.int64) for c in cols)
        return Column(data=civil_to_days(y, m, d).to(torch.int32), ltype=DATE,
                      validity=_valid_of(cols))
    return DATE, impl, arg_exprs


@register("date_diff")
@register("datediff")
def _bind_date_diff(arg_exprs):
    part = str(arg_exprs[0].const_value()).lower()
    if part not in ("day", "days", "year", "years", "month", "months", "week", "weeks"):
        raise BindError(f"date_diff part {part}")

    def impl(env, cols, node):
        a, b = cols
        da, db = bcast(a.data, env.plen).to(torch.int64), bcast(b.data, env.plen).to(torch.int64)
        if part in ("day", "days"):
            d = db - da
        elif part in ("week", "weeks"):
            d = torch.div(db, 7, rounding_mode="floor") - torch.div(da, 7, rounding_mode="floor")
        else:
            ya, ma, _ = civil_from_days(da)
            yb, mb, _ = civil_from_days(db)
            d = yb - ya if part.startswith("year") else (yb - ya) * 12 + (mb - ma)
        return Column(data=d, ltype=BIGINT, validity=_valid_of(cols))
    return BIGINT, impl, arg_exprs[1:]


def _name_lut(names):
    """(sorted dictionary, index → code) for a list of names."""
    names = np.array(names, dtype=object)
    order = np.argsort(names.astype(str))
    return names[order], np.argsort(order).astype(np.int32)


_DAYNAMES = _name_lut(["Sunday", "Monday", "Tuesday", "Wednesday", "Thursday", "Friday",
                       "Saturday"])
_MONTHNAMES = _name_lut(["January", "February", "March", "April", "May", "June", "July",
                         "August", "September", "October", "November", "December"])


@register("dayname")
def _bind_dayname(arg_exprs):
    def impl(env, cols, node):
        c = cols[0]
        remap = torch.from_numpy(_DAYNAMES[1]).to(c.data.device)
        return Column(data=remap[torch.remainder(_days(c) + 4, 7)], ltype=VARCHAR,
                      validity=c.validity, dict_values=_DAYNAMES[0])
    return VARCHAR, impl, arg_exprs


@register("monthname")
def _bind_monthname(arg_exprs):
    def impl(env, cols, node):
        c = cols[0]
        _, m, _ = civil_from_days(_days(c))
        remap = torch.from_numpy(_MONTHNAMES[1]).to(c.data.device)
        return Column(data=remap[m - 1], ltype=VARCHAR, validity=c.validity,
                      dict_values=_MONTHNAMES[0])
    return VARCHAR, impl, arg_exprs


def _now_micros() -> int:
    pinned = _pinned_time()
    if pinned is not None:
        return pinned
    return int((datetime.datetime.now() - datetime.datetime(1970, 1, 1)).total_seconds() * 1e6)


@register("current_date")
@register("today")
def _bind_current_date(arg_exprs):
    def impl(env, cols, node):
        return Column(data=_full(env, _now_micros() // _US_DAY, torch.int32), ltype=DATE)
    return DATE, impl, []


@register("now")
@register("current_timestamp")
@register("get_current_timestamp")
@register("transaction_timestamp")
def _bind_now(arg_exprs):
    def impl(env, cols, node):
        return Column(data=_full(env, _now_micros(), torch.int64), ltype=TIMESTAMP)
    return TIMESTAMP, impl, []


def _to_datetime(v, t) -> datetime.datetime:
    if t.id in (TypeId.TIMESTAMP, TypeId.TIMESTAMPTZ):
        return datetime.datetime(1970, 1, 1) + datetime.timedelta(microseconds=int(v))
    return datetime.datetime(1970, 1, 1) + datetime.timedelta(days=int(v))


@register("strftime")
def _bind_strftime(arg_exprs):
    """Formats each distinct date or timestamp once (format_distinct); a
    NULL row's value is formatted too and stays NULL, as in the reference."""
    fmt = str(arg_exprs[1].const_value())

    def impl(env, cols, node):
        c = cols[0]
        return format_distinct(c, env, lambda v: _to_datetime(v, c.ltype).strftime(fmt))
    return VARCHAR, impl, arg_exprs[:1]


@register("strptime")
def _bind_strptime(arg_exprs):
    """VARCHAR → TIMESTAMP, parsed once per distinct value (a value that
    does not parse fails only where a row the statement reads holds it)."""
    fmt = str(arg_exprs[1].const_value())
    epoch = datetime.datetime(1970, 1, 1)

    def parse(s):
        return int((datetime.datetime.strptime(str(s), fmt) - epoch).total_seconds() * 1e6)

    def impl(env, cols, node):
        c = dict_int(cols[0], parse, device_key=f"strptime:{fmt}", env=env)
        return Column(data=c.data, ltype=TIMESTAMP, validity=c.validity)
    return TIMESTAMP, impl, arg_exprs[:1]


@register("epoch")
def _bind_epoch(arg_exprs):
    def impl(env, cols, node):
        c = cols[0]
        if c.ltype.id is TypeId.DATE:
            d = c.data.to(torch.int64) * 86400
        else:
            d = torch.div(c.data, 1_000_000, rounding_mode="floor")
        return Column(data=d, ltype=BIGINT, validity=c.validity)
    return BIGINT, impl, arg_exprs


@register("week")
@register("weekofyear")
def _bind_week(arg_exprs):
    """ISO week: the week of the year of the date's Thursday."""
    def impl(env, cols, node):
        c = cols[0]
        days = _days(c)
        thursday = days - torch.remainder(days + 3, 7) + 3
        y, _, _ = civil_from_days(thursday)
        jan1 = civil_to_days(y, torch.ones_like(y), torch.ones_like(y))
        week = torch.div(thursday - jan1, 7, rounding_mode="floor") + 1
        return Column(data=week, ltype=BIGINT, validity=c.validity)
    return BIGINT, impl, arg_exprs


@register("isodow")
def _bind_isodow(arg_exprs):
    def impl(env, cols, node):
        c = cols[0]
        return Column(data=torch.remainder(_days(c) + 3, 7) + 1, ltype=BIGINT,
                      validity=c.validity)
    return BIGINT, impl, arg_exprs


@register("age")
def _bind_age(arg_exprs):
    """Days between two dates (the reference's BIGINT; one argument: from
    today)."""
    def impl(env, cols, node):
        a = bcast(cols[0].data, env.plen).to(torch.int64)
        if len(cols) > 1:
            b = bcast(cols[1].data, env.plen).to(torch.int64)
        else:
            b = _full(env, _now_micros() // _US_DAY, torch.int64)
        return Column(data=a - b, ltype=BIGINT, validity=_valid_of(cols))
    return BIGINT, impl, arg_exprs


# DuckDB's default origins: 2000-01-03 (a Monday) for day and sub-day
# widths, 2000-01-01 for month widths (time_bucket.cpp)
_BUCKET_ORIGIN_DAYS = 10_959
_BUCKET_ORIGIN_MONTHS = 2000 * 12


@register("time_bucket")
def _bind_time_bucket(arg_exprs):
    width = arg_exprs[0].const_value()
    months, days_i, micros = width if isinstance(width, tuple) else (0, 0, int(width))
    t = arg_exprs[1].ltype
    if (months != 0) + (days_i != 0 or micros != 0) != 1 or min(months, days_i, micros) < 0:
        raise BindError("time_bucket: the width must be a positive interval of months, "
                        "or of days and smaller units")

    def impl(env, cols, node):
        c = cols[0]
        if months:
            y, m, _ = civil_from_days(_days(c))
            k = torch.div(y * 12 + m - 1 - _BUCKET_ORIGIN_MONTHS, months, rounding_mode="floor")
            mm = k * months + _BUCKET_ORIGIN_MONTHS
            out_days = civil_to_days(torch.div(mm, 12, rounding_mode="floor"),
                                     torch.remainder(mm, 12) + 1, torch.ones_like(mm))
            out = out_days if t.id is TypeId.DATE else out_days * _US_DAY
        elif t.id is TypeId.DATE:
            if micros:
                raise not_ported("time_bucket of a DATE by a sub-day width")
            off = c.data.to(torch.int64) - _BUCKET_ORIGIN_DAYS
            out = torch.div(off, days_i, rounding_mode="floor") * days_i + _BUCKET_ORIGIN_DAYS
        else:
            w = days_i * _US_DAY + micros
            off = c.data.to(torch.int64) - _BUCKET_ORIGIN_DAYS * _US_DAY
            out = torch.div(off, w, rounding_mode="floor") * w + _BUCKET_ORIGIN_DAYS * _US_DAY
        return Column(data=out.to(c.data.dtype), ltype=t, validity=c.validity)
    return t, impl, arg_exprs[1:]


# -- misc ------------------------------------------------------------------------
@register("typeof")
def _bind_typeof(arg_exprs):
    tname = str(arg_exprs[0].ltype)

    def impl(env, cols, node):
        return _const_varchar(env, tname)
    return VARCHAR, impl, []


@register("hash")
def _bind_hash(arg_exprs):
    def impl(env, cols, node):
        c = cols[0]
        return Column(data=hash64(bcast(c.data, env.plen).to(torch.int64)), ltype=BIGINT,
                      validity=c.validity)
    return BIGINT, impl, arg_exprs


@register("random")
def _bind_random(arg_exprs):
    def impl(env, cols, node):
        dev = env.live.device
        g = _generator(dev)
        return Column(data=torch.rand(env.plen, generator=g, dtype=torch.float64,
                                      device=g.device).to(dev), ltype=DOUBLE)
    return DOUBLE, impl, []


def _random_bits(env, k: int) -> np.ndarray:
    """(plen, k) random 62-bit words per row, drawn on the env's device."""
    g = _generator(env.live.device)
    return torch.randint(0, 1 << 62, (env.plen, k), generator=g, dtype=torch.int64,
                         device=g.device).cpu().numpy()


def _uuid_column(env, make) -> Column:
    strs = np.array([str(make(r)) for r in _random_bits(env, 3).tolist()], dtype=str)
    uniq, codes = np.unique(strs, return_inverse=True)
    return Column(data=torch.from_numpy(codes.reshape(-1).astype(np.int32)).to(env.live.device),
                  ltype=VARCHAR, dict_values=uniq.astype(object))


@register("uuid")
@register("gen_random_uuid")
@register("uuidv4")
def _bind_uuid(arg_exprs):
    def impl(env, cols, node):
        return _uuid_column(env, lambda r: _uuid.UUID(
            int=(r[0] << 66) | (r[1] << 4) | (r[2] & 0xF), version=4))
    return VARCHAR, impl, []


@register("uuidv7")
def _bind_uuidv7(arg_exprs):
    """Time-ordered UUID v7 (duckdb/src/common/types/uuid.cpp UUIDv7): the
    millisecond time in the top 48 bits, then 74 random bits."""
    def impl(env, cols, node):
        pinned = _pinned_time()
        ms = pinned // 1000 if pinned is not None else int(time.time() * 1000)

        def make(r):
            rand = ((r[0] << 12) | (r[1] & 0xFFF)) & ((1 << 74) - 1)
            val = (ms << 80) | (0x7 << 76) | ((rand >> 62) << 64) | (0b10 << 62) \
                | (rand & ((1 << 62) - 1))
            return _uuid.UUID(int=val)
        return _uuid_column(env, make)
    return VARCHAR, impl, []


@register("uuid_extract_timestamp")
def _bind_uuid_extract_timestamp(arg_exprs):
    """The millisecond timestamp in a UUIDv7's top 48 bits."""
    def f(s):
        h = s.replace("-", "")
        return int(h[:12], 16) * 1000 if len(h) == 32 else 0

    def impl(env, cols, node):
        c = dict_int(cols[0], f, device_key="uuid_ts")
        return Column(data=c.data, ltype=TIMESTAMP, validity=c.validity)
    return TIMESTAMP, impl, arg_exprs


def sequence(name: str) -> dict:
    """The state of CREATE SEQUENCE's `name` in the statement's catalog (a
    transaction's snapshot inside BEGIN … COMMIT): {"value": the next
    value, "increment", "last": the last value given}."""
    cat = getattr(session.active(), "catalog", None)
    seq = None if cat is None else cat.sequences.get(name)
    if seq is None:
        raise ValueError(f'Catalog Error: Sequence with name "{name}" does not exist!')
    return seq


@register("nextval")
def _bind_nextval(arg_exprs):
    """One value per live row, in row order (DuckDB's nextval.cpp)."""
    name = str(arg_exprs[0].const_value()).lower()

    def impl(env, cols, node):
        seq = sequence(name)
        inc, start = seq["increment"], seq["value"]
        live = env.live.to(torch.int64)
        offs = torch.cumsum(live, 0) - live  # the live rows before each row
        n = int(live.sum())
        seq["value"] = start + inc * n
        if n:
            seq["last"] = start + inc * (n - 1)
        return Column(data=start + inc * offs, ltype=BIGINT)

    return BIGINT, impl, []


@register("currval")
def _bind_currval(arg_exprs):
    """The last value nextval gave. Before any, DuckDB raises; the JAX
    package gives the start less the increment."""
    name = str(arg_exprs[0].const_value()).lower()

    def impl(env, cols, node):
        seq = sequence(name)
        if "last" not in seq:
            raise ValueError(f'Sequence Error: currval: sequence "{name}" is not yet '
                             "defined in this session")
        return Column(data=_full(env, seq["last"], torch.int64), ltype=BIGINT)

    return BIGINT, impl, []
