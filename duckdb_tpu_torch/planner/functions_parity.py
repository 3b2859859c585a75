"""Function-library parity: the registrations that functions.py,
functions_ext.py, functions_more.py and functions_nested.py leave out.

The JAX package's duckdb_tpu/planner/functions_parity.py in torch, built
on the port's nested values (blocks/nested, planner/functions_nested):
- the bitwise operators as functions ("&", "|", "xor", "<<", ">>", "~")
  and the integer and text forms of get_bit/set_bit/bit_position/bitstring;
- math aliases, equi_width_bins, scalar glob (format_bytes and the
  readable sizes are functions_more's);
- the list vector functions (list_distance, the dot/inner products and
  their negatives, the cosine family): over the distinct pairs of lists
  the live rows hold, as torch ops on the column's device over the
  flattened elements, segment by segment (`index_add_` by pair);
  array_cross_product per distinct pair;
- the rest of the list surface (has_all/has_any, intersect, select,
  where, zip of any number of lists, resize, grade_up);
- the struct and map surfaces, the interval constructors and the
  generic/meta functions, and the array_* alias table.

A function of several nested (or any) columns runs once per distinct
tuple of values the live rows hold (`distinct_rows`: the tuples found
on the device, one transfer of them), never per row, and never over a
dictionary entry that no
live row holds: the JAX package takes every pair of the dictionaries'
entries and so raises over entries no row holds (ROADMAP Queue 3, (j)
and (k)). map_from_entries with a repeated key raises as DuckDB does
(fault (l): the reference keeps the last value). `>>` of a negative
number shifts its sign in, as DuckDB's BitwiseShiftRightOperator (the
reference shifts in zeros). setval sets a sequence of the statement's
catalog. getvariable gives NULL, as the reference does with no variable
set: neither package has SET VARIABLE (the JAX package's parser refuses
it; ROADMAP, "Still refused in both packages").
"""

from __future__ import annotations

import fnmatch
import math
import os

import numpy as np
import torch

from duckdb_tpu_torch.blocks import Column
from duckdb_tpu_torch.blocks.nested import host_pyvals, lut_column, obj_array
from duckdb_tpu_torch.planner.bound import (
    BindError,
    _and_validity,
    _to_double,
    bcast,
    not_ported,
)
from duckdb_tpu_torch.planner.functions import (
    REGISTRY,
    dict_predicate,
    dict_transform,
    register,
)
from duckdb_tpu_torch.planner.functions_ext import _const_varchar, _full, _valid_of
from duckdb_tpu_torch.planner.functions_nested import (
    _codes,
    _const_py,
    _elements,
    _flatten,
    _per_distinct,
    _scalar_per_distinct,
    bind_bit_position_typed,
    bind_bitstring_typed,
    bind_get_bit_typed,
    bind_set_bit_typed,
    map_element,
)
from duckdb_tpu_torch.types import (
    BIGINT,
    BIT,
    BOOLEAN,
    DOUBLE,
    INTEGER,
    INTERVAL,
    SQLNULL,
    VARCHAR,
    LogicalType,
    TypeId,
    list_of,
    map_of,
    struct_of,
)

_LISTS = (TypeId.LIST, TypeId.ARRAY)


# -- distinct tuples of the live rows -------------------------------------------
def distinct_rows(cols, env):
    """The distinct tuples of values that the live rows hold across `cols`
    → (values: one tuple of Python values per distinct tuple, None for
    NULL; held: a bool per tuple, False for the one tuple that stands for
    every row that is not live; inv: each row's tuple index, a tensor on
    the rows' device). The tuples are found on the device (`_unique_rows`)
    and transferred once: the work per tuple that follows is the
    caller's, on the host."""
    plen = env.plen
    live = env.live
    zero = torch.zeros((), dtype=torch.int64, device=live.device)
    keys = [live.to(torch.int64)]
    parts = []  # per column: (data key index, validity key index or None, hi index or None)
    for c in cols:
        d = bcast(c.data, plen)
        d = d.to(torch.float64).view(torch.int64) if d.dtype.is_floating_point \
            else d.to(torch.int64)
        vi = None
        if c.validity is not None:
            v = bcast(c.validity, plen) & live
            vi = len(keys)
            keys.append(v.to(torch.int64))
            d = torch.where(v, d, zero)
        hi = None
        if c.data_hi is not None:
            hi = len(keys) + 1
        parts.append((len(keys), vi, hi))
        keys.append(torch.where(live, d, zero))
        if hi is not None:
            keys.append(torch.where(live, bcast(c.data_hi, plen).to(torch.int64), zero))
    host, inv = _unique_rows(keys)
    columns = []
    for c, (di, vi, hi) in zip(cols, parts):
        data = host[:, di]
        if c.data.dtype.is_floating_point:
            data = data.view(np.float64)
        elif c.ltype.id in (TypeId.VARCHAR, TypeId.BLOB, TypeId.BIT) or c.dict_values is not None:
            data = data.astype(np.int64)
        valid = None if vi is None else host[:, vi].astype(bool)
        if c.dict_values is None and c.ltype.id in (TypeId.VARCHAR, TypeId.BLOB):
            columns.append([None] * len(host))  # a typed NULL
            continue
        columns.append(host_pyvals(data, valid, c.dict_values, c.ltype,
                                   None if hi is None else host[:, hi]))
    values = list(zip(*columns)) if columns else [()] * len(host)
    return values, host[:, 0].astype(bool), inv


def _unique_rows(keys):
    """The distinct rows of parallel int64 key vectors → (host matrix of
    them, one row per distinct tuple in lexicographic order; each row's
    index, on the device). Each key is ranked by a 1-D torch.unique and
    folded into the tuple's rank so far, which is ranked again, so that
    the fold stays below rows x distinct values (a lexicographic unique
    over rows is many times slower)."""
    comb = None
    for k in keys:
        u, r = torch.unique(k, return_inverse=True)
        comb = r if comb is None else comb * len(u) + r
        tuples, comb = torch.unique(comb, return_inverse=True)
    # a row of each tuple (the rows of one tuple hold the same keys)
    rep = torch.zeros(len(tuples), dtype=torch.long, device=comb.device).scatter_(
        0, comb, torch.arange(comb.shape[0], device=comb.device))
    return torch.stack([k[rep] for k in keys], 1).cpu().numpy(), comb


def per_distinct_rows(cols, env, fn, out_t: LogicalType, valid_in=True) -> Column:
    """fn(*values) once per distinct tuple the live rows hold → a column of
    out_t gathered by tuple; NULL where fn gives None (and, with
    `valid_in`, where an argument is NULL)."""
    values, held, inv = distinct_rows(cols, env)
    out = [fn(*v) if h else None for v, h in zip(values, held)]
    if held.any() and not held.all():
        # the rows that are not live take a held tuple's value, so that no
        # dictionary entry stands for them alone
        first = out[int(held.argmax())]
        out = [o if h else first for o, h in zip(out, held)]
    lut = lut_column(out, out_t, env.live.device)
    valid = None if lut.validity is None else lut.validity[inv]
    if valid_in:
        for c in cols:
            if c.validity is not None:
                valid = _and_validity(valid, bcast(c.validity, env.plen))
    return Column(data=lut.data[inv], ltype=out_t, validity=valid,
                  dict_values=lut.dict_values)


def _list_args(name, arg_exprs):
    for a in arg_exprs:
        if a.ltype.id not in _LISTS and a.ltype.id is not TypeId.SQLNULL:
            raise BindError(f"Binder Error: {name} expects LIST arguments, got {a.ltype!r}")


# -- bitwise operators ------------------------------------------------------------
_INTS = (TypeId.TINYINT, TypeId.SMALLINT, TypeId.INTEGER, TypeId.BIGINT, TypeId.HUGEINT,
         TypeId.SQLNULL, TypeId.BOOLEAN)


def _int_args(arg_exprs):
    for a in arg_exprs:
        if a.ltype.id not in _INTS:
            raise BindError("Binder Error: bitwise operators require integer operands")


def _shift_ok(b):
    return (b >= 0) & (b < 64)


def _bitop(name, fn):
    def binder(arg_exprs):
        if len(arg_exprs) != 2:
            raise BindError(f"Binder Error: {name} takes 2 arguments")
        _int_args(arg_exprs)

        def impl(env, cols, node):
            a, b = (bcast(c.data, env.plen).to(torch.int64) for c in cols)
            return Column(data=fn(a, b), ltype=BIGINT, validity=_valid_of(cols))
        return BIGINT, impl, arg_exprs

    REGISTRY[name] = binder


_bitop("&", torch.bitwise_and)
_bitop("|", torch.bitwise_or)
_bitop("xor", torch.bitwise_xor)
_bitop("<<", lambda a, b: torch.where(_shift_ok(b), a << b.clamp(0, 63), 0))
_bitop(">>", lambda a, b: torch.where(_shift_ok(b), a >> b.clamp(0, 63), 0))


@register("~")
def _bind_bitnot(arg_exprs):
    _int_args(arg_exprs[:1])

    def impl(env, cols, node):
        return Column(data=torch.bitwise_not(bcast(cols[0].data, env.plen).to(torch.int64)),
                      ltype=BIGINT, validity=cols[0].validity)
    return BIGINT, impl, arg_exprs


@register("get_bit")
def _bind_get_bit(arg_exprs):
    if arg_exprs[0].ltype.id is TypeId.BIT:
        return bind_get_bit_typed(arg_exprs)

    def impl(env, cols, node):
        a, i = (bcast(c.data, env.plen).to(torch.int64) for c in cols)
        return Column(data=((a >> i.clamp(0, 63)) & 1).to(torch.int32), ltype=INTEGER,
                      validity=_valid_of(cols))
    return INTEGER, impl, arg_exprs


@register("set_bit")
def _bind_set_bit(arg_exprs):
    if arg_exprs[0].ltype.id is TypeId.BIT:
        return bind_set_bit_typed(arg_exprs)

    def impl(env, cols, node):
        a, i, v = (bcast(c.data, env.plen).to(torch.int64) for c in cols)
        i = i.clamp(0, 63)
        one = torch.ones((), dtype=torch.int64, device=a.device)
        return Column(data=(a & ~(one << i)) | ((v & 1) << i), ltype=BIGINT,
                      validity=_valid_of(cols))
    return BIGINT, impl, arg_exprs


@register("bit_position")
def _bind_bit_position(arg_exprs):
    """Over BIT, the position of a bitstring; over an integer, the 1-based
    position of its lowest set bit (0 when none), counted exactly (the
    reference takes a float log2 and comes out one short where it rounds
    down: bit_position(1, 8) gives 3, not 4)."""
    if arg_exprs[-1].ltype.id is TypeId.BIT:
        return bind_bit_position_typed(arg_exprs)

    def impl(env, cols, node):
        a = bcast(cols[-1].data, env.plen).to(torch.int64)
        x = a & -a  # the lowest set bit
        n = torch.zeros_like(x)
        for s in (32, 16, 8, 4, 2, 1):
            big = (x >> s) != 0
            n = n + torch.where(big, s, 0)
            x = torch.where(big, x >> s, x)
        pos = torch.where(a == 0, 0, n + 1)
        return Column(data=pos.to(torch.int32), ltype=INTEGER, validity=_valid_of(cols))
    return INTEGER, impl, arg_exprs


@register("bitstring")
def _bind_bitstring(arg_exprs):
    """bitstring(s, n): s zero-extended to n bits, a BIT (DuckDB's
    bitstring.cpp reads a text s as bits)."""
    if arg_exprs[0].ltype.id is TypeId.BIT:
        return bind_bitstring_typed(arg_exprs)
    n = int(arg_exprs[1].const_value())

    def pad(s):
        if len(s) > n:
            raise ValueError(f"Invalid Input Error: Length must be equal or larger than "
                             f"input string")
        return s.rjust(n, "0")

    def impl(env, cols, node):
        c = dict_transform(cols[0], pad, device_key=f"bitstring:{n}")
        return Column(data=c.data, ltype=BIT, validity=c.validity, dict_values=c.dict_values)
    return BIT, impl, arg_exprs[:1]


# -- math aliases and bins ------------------------------------------------------------
REGISTRY["greatest_common_divisor"] = REGISTRY["gcd"]
REGISTRY["least_common_multiple"] = REGISTRY["lcm"]


@register("equi_width_bins")
def _bind_equi_width_bins(arg_exprs):
    """equi_width_bins(min, max, count, nice) → the bins' upper bounds
    (DuckDB's binning.cpp), computed at bind time."""
    lo, _ = _const_py(arg_exprs[0])
    hi, _ = _const_py(arg_exprs[1])
    n, _ = _const_py(arg_exprs[2])
    nice = bool(_const_py(arg_exprs[3])[0]) if len(arg_exprs) > 3 else False
    lo_f, hi_f, n = float(lo), float(hi), int(n)
    if n <= 0:
        raise BindError("Invalid Input Error: bin count must be positive")
    if hi_f < lo_f:
        raise BindError("Invalid Input Error: upper bound must be greater than lower bound")
    if nice:
        span = (hi_f - lo_f) / n
        mag = 10 ** math.floor(math.log10(span)) if span > 0 else 1
        step = min((s for s in (mag, 2 * mag, 2.5 * mag, 5 * mag, 10 * mag) if s >= span),
                   default=mag)
        bins = []
        b = math.floor(lo_f / step) * step + step
        while b < hi_f - 1e-12:
            bins.append(b)
            b += step
        bins.append(b)
    else:
        bins = [lo_f + (hi_f - lo_f) * (i + 1) / n for i in range(n)]
    is_int = arg_exprs[0].ltype.is_integer and arg_exprs[1].ltype.is_integer
    if is_int and all(float(b).is_integer() for b in bins):
        entry, lt = tuple(int(b) for b in bins), list_of(BIGINT)
    else:
        entry, lt = tuple(float(b) for b in bins), list_of(DOUBLE)

    def impl(env, cols, node):
        return Column(data=_full(env, 0, torch.int32), ltype=lt, dict_values=obj_array([entry]))
    return lt, impl, []


@register("glob")
def _bind_glob(arg_exprs):
    """string ~~~ pattern (DuckDB's GlobPatternFun)."""
    try:
        pat = str(arg_exprs[1].const_value())
    except BindError as exc:
        raise BindError("Binder Error: glob requires a constant pattern") from exc

    def impl(env, cols, node):
        return dict_predicate(cols[0], lambda s: fnmatch.fnmatchcase(s, pat),
                              device_key=f"glob:{pat}")
    return BOOLEAN, impl, arg_exprs[:1]


# -- list vector math ------------------------------------------------------------------
def _held_pairs(a: Column, b: Column, env):
    """The distinct (code of a, code of b) pairs the live rows with both
    lists valid hold → (pa, pb host int64 arrays, held bool array, inv)."""
    na, nb = max(len(a.dict_values), 1), max(len(b.dict_values), 1)
    keep = env.live
    for c in (a, b):
        if c.validity is not None:
            keep = keep & bcast(c.validity, env.plen)
    pair = bcast(_codes(a, na), env.plen) * nb + bcast(_codes(b, nb), env.plen)
    uniq, inv = torch.unique(torch.where(keep, pair, -1), return_inverse=True)
    u = uniq.cpu().numpy()
    held = u >= 0
    u = np.where(held, u, 0)
    return u // nb, u % nb, held, inv


def _vec_reduce(name, a: Column, b: Column, env, finish):
    """finish(dot, |a|², |b|², Σ(a-b)²) per distinct held pair of lists,
    the sums taken on the device over the flattened elements."""
    dev = env.live.device
    if a.dict_values is None or b.dict_values is None or a.ltype.id is TypeId.SQLNULL \
            or b.ltype.id is TypeId.SQLNULL:
        return Column(data=torch.zeros(env.plen, dtype=torch.float64, device=dev), ltype=DOUBLE,
                      validity=torch.zeros(env.plen, dtype=torch.bool, device=dev))
    pa, pb, held, inv = _held_pairs(a, b, env)
    lens_a, offs_a, flat_a = _flatten(a.dict_values)
    lens_b, offs_b, flat_b = _flatten(b.dict_values)
    la, lb = lens_a[pa], lens_b[pb]
    bad = held & (la != lb)
    if bad.any():
        i = int(np.flatnonzero(bad)[0])
        raise ValueError(f"Invalid Input Error: {name}: list dimensions must be equal, got "
                         f"left length '{la[i]}' and right length '{lb[i]}'")
    lens = np.where(held, la, 0)
    total = int(lens.sum())
    npairs = len(pa)
    sums = torch.zeros((4, npairs), dtype=torch.float64, device=dev)
    if total:
        ea = _elements(a.dict_values, a.ltype.child or DOUBLE, flat_a, dev)
        eb = _elements(b.dict_values, b.ltype.child or DOUBLE, flat_b, dev)
        lens_t = torch.from_numpy(lens).to(dev)
        seg = torch.repeat_interleave(torch.arange(npairs, device=dev), lens_t)
        start = torch.cumsum(lens_t, 0) - lens_t
        pos = torch.arange(total, device=dev) - start[seg]
        ia = torch.from_numpy(offs_a[pa]).to(dev)[seg] + pos
        ib = torch.from_numpy(offs_b[pb]).to(dev)[seg] + pos
        for e, idx, side in ((ea, ia, "left"), (eb, ib, "right")):
            if e.validity is not None and not bool(e.validity[idx].all()):
                raise ValueError(f"Invalid Input Error: {name}: {side} argument can not "
                                 f"contain NULL values")
        x, y = _to_double(ea)[ia], _to_double(eb)[ib]
        terms = torch.stack([x * y, x * x, y * y, (x - y) * (x - y)])
        sums.index_add_(1, seg, terms)
    out = finish(sums[0], sums[1], sums[2], sums[3])
    return Column(data=out[inv], ltype=DOUBLE, validity=_valid_of([a, b]))


def _vec_fn(name, finish):
    def binder(arg_exprs):
        if len(arg_exprs) != 2:
            raise BindError(f"Binder Error: {name} takes 2 arguments")
        _list_args(name, arg_exprs)

        def impl(env, cols, node):
            return _vec_reduce(name, cols[0], cols[1], env, finish)
        return DOUBLE, impl, arg_exprs

    for n in (name, name.replace("list_", "array_")):
        REGISTRY[n] = binder


def _cosine(dot, aa, bb):
    return dot / (torch.sqrt(aa) * torch.sqrt(bb))


_vec_fn("list_distance", lambda dot, aa, bb, dd: torch.sqrt(dd))
_vec_fn("list_dot_product", lambda dot, aa, bb, dd: dot)
_vec_fn("list_inner_product", lambda dot, aa, bb, dd: dot)
_vec_fn("list_negative_dot_product", lambda dot, aa, bb, dd: -dot)
_vec_fn("list_negative_inner_product", lambda dot, aa, bb, dd: -dot)
_vec_fn("list_cosine_similarity", lambda dot, aa, bb, dd: _cosine(dot, aa, bb))
_vec_fn("list_cosine_distance", lambda dot, aa, bb, dd: 1.0 - _cosine(dot, aa, bb))


def _pair_fn(name, op, out_t_of):
    """A function of two nested values once per distinct pair the live rows
    hold; out_t_of(arg_exprs) gives its type."""
    def binder(arg_exprs):
        if len(arg_exprs) != 2:
            raise BindError(f"Binder Error: {name} takes 2 arguments")
        out_t = out_t_of(arg_exprs)

        def impl(env, cols, node):
            return per_distinct_rows(cols, env, op, out_t)
        return out_t, impl, arg_exprs

    return binder


def _cross(ta, tb):
    if len(ta) != 3 or len(tb) != 3:
        raise ValueError("Invalid Input Error: array_cross_product requires 3-element arrays")
    a = np.asarray(ta, np.float64)
    b = np.asarray(tb, np.float64)
    return tuple(float(x) for x in np.cross(a, b))


REGISTRY["array_cross_product"] = _pair_fn("array_cross_product", _cross,
                                           lambda a: list_of(DOUBLE))


# -- the rest of the lists ---------------------------------------------------------------
def _members(t):
    return {x for x in t if x is not None}


def _list_pair(name, op, out_t_of, aliases=()):
    for n in (name, *aliases):
        REGISTRY[n] = _pair_fn(name, op, out_t_of)


_list_pair("list_has_all", lambda a, b: _members(b) <= _members(a), lambda e: BOOLEAN,
           ("array_has_all",))
_list_pair("list_has_any", lambda a, b: bool(_members(a) & _members(b)), lambda e: BOOLEAN,
           ("array_has_any",))
_list_pair("list_intersect",
           lambda a, b: tuple(dict.fromkeys(x for x in a if x is not None and x in _members(b))),
           lambda e: e[0].ltype, ("array_intersect",))


def _select(ta, tb):
    """list_select(l, indexes): the elements at the 1-based indexes, NULL
    out of range (DuckDB's list_select.cpp)."""
    return tuple(None if i is None or not 1 <= int(i) <= len(ta) else ta[int(i) - 1]
                 for i in tb)


_list_pair("list_select", _select, lambda e: e[0].ltype, ("array_select",))
_list_pair("list_where", lambda ta, tb: tuple(v for v, m in zip(ta, tb) if m),
           lambda e: e[0].ltype, ("array_where",))


def _zip(*lists):
    k = max((len(t) for t in lists), default=0)
    return tuple(tuple(t[i] if i < len(t) else None for t in lists) for i in range(k))


def _zip_type(arg_exprs):
    return list_of(struct_of(*((f"list_{i + 1}", a.ltype.child or SQLNULL)
                               for i, a in enumerate(arg_exprs))))


@register("list_zip")
@register("array_zip")
def _bind_list_zip(arg_exprs):
    """Zip lists into a list of structs, padded to the longest with NULLs
    (DuckDB's list_zip.cpp, truncate false); any number of lists, once
    per distinct tuple the live rows hold."""
    if not arg_exprs:
        raise BindError("Binder Error: list_zip requires at least one list")
    _list_args("list_zip", arg_exprs)
    out_t = _zip_type(arg_exprs)

    def impl(env, cols, node):
        return per_distinct_rows(cols, env, lambda *ts: _zip(*(t or () for t in ts)), out_t,
                                 valid_in=False)
    return out_t, impl, arg_exprs


@register("list_resize")
@register("array_resize")
def _bind_list_resize(arg_exprs):
    lt = arg_exprs[0].ltype
    n = int(_const_py(arg_exprs[1])[0])
    fill = _const_py(arg_exprs[2])[0] if len(arg_exprs) > 2 else None
    if n < 0:
        raise BindError("Invalid Input Error: list_resize: the size must be non-negative")
    return lt, _per_distinct(lambda t: tuple(t)[:n] + (fill,) * max(0, n - len(t)), lt), \
        arg_exprs[:1]


def grade_up(t):
    """1-based indexes that sort the list ascending, NULLs last, ties in
    order (DuckDB's list_grade_up.cpp)."""
    return tuple(i + 1 for _, i in sorted(((v is None, v if v is not None else 0), i)
                                          for i, v in enumerate(t)))


for _n in ("grade_up", "list_grade_up", "array_grade_up"):
    REGISTRY[_n] = lambda arg_exprs: (list_of(BIGINT), _per_distinct(grade_up, list_of(BIGINT)),
                                      arg_exprs[:1])


@register("unpivot_list")
def _bind_unpivot_list(arg_exprs):
    return REGISTRY["list_value"](arg_exprs)


# -- structs --------------------------------------------------------------------------
def _struct_fields(e):
    if e.ltype.id is not TypeId.STRUCT:
        raise BindError("Binder Error: function expects a STRUCT argument")
    return list(e.ltype.fields or ())


@register("struct_keys")
def _bind_struct_keys(arg_exprs):
    entry = tuple(n for n, _ in _struct_fields(arg_exprs[0]))
    lt = list_of(VARCHAR)

    def impl(env, cols, node):
        return Column(data=_full(env, 0, torch.int32), ltype=lt, validity=cols[0].validity,
                      dict_values=obj_array([entry]))
    return lt, impl, arg_exprs


@register("struct_values")
def _bind_struct_values(arg_exprs):
    fields = _struct_fields(arg_exprs[0])
    lt = list_of(fields[0][1] if fields else SQLNULL)
    return lt, _per_distinct(tuple, lt), arg_exprs


@register("struct_contains")
def _bind_struct_contains(arg_exprs):
    _struct_fields(arg_exprs[0])
    val, _ = _const_py(arg_exprs[1])
    return BOOLEAN, _scalar_per_distinct(lambda t: val in t, BOOLEAN), arg_exprs[:1]


@register("struct_position")
@register("struct_indexof")
def _bind_struct_position(arg_exprs):
    _struct_fields(arg_exprs[0])
    val, _ = _const_py(arg_exprs[1])
    return BIGINT, _scalar_per_distinct(lambda t: next((i + 1 for i, v in enumerate(t)
                                                        if v == val), None), BIGINT), \
        arg_exprs[:1]


@register("struct_has")
def _bind_struct_has(arg_exprs):
    name = str(arg_exprs[1].const_value()).lower()
    present = any(n.lower() == name for n, _ in _struct_fields(arg_exprs[0]))

    def impl(env, cols, node):
        return Column(data=_full(env, present, torch.bool), ltype=BOOLEAN,
                      validity=cols[0].validity)
    return BOOLEAN, impl, arg_exprs[:1]


@register("struct_extract_at")
def _bind_struct_extract_at(arg_exprs):
    fields = _struct_fields(arg_exprs[0])
    idx = int(arg_exprs[1].const_value())
    if not 1 <= idx <= len(fields):
        raise BindError(f"Binder Error: struct_extract_at index {idx} out of range")
    ft = fields[idx - 1][1]
    return ft, _scalar_per_distinct(lambda t: t[idx - 1] if idx - 1 < len(t) else None, ft), \
        arg_exprs[:1]


def bind_struct_insert_update(name, base, named_pairs):
    """struct_insert/struct_update(s, name := value, ...), the pairs bound
    by the binder (DuckDB's struct_insert.cpp / struct_update.cpp) →
    (type, impl) over the struct's column."""
    fields = _struct_fields(base)
    consts = [(nm, *_const_py(b)) for nm, b in named_pairs]
    if name == "struct_insert":
        for nm, _, _ in consts:
            if any(n.lower() == nm.lower() for n, _ in fields):
                raise BindError(f'Binder Error: duplicate struct field name "{nm}"')
        lt = struct_of(*(fields + [(nm, t) for nm, _, t in consts]))
        extra = tuple(v for _, v, _ in consts)
        return lt, _per_distinct(lambda t: tuple(t) + extra, lt)
    updates = {nm.lower(): (v, t) for nm, v, t in consts}
    unknown = set(updates) - {n.lower() for n, _ in fields}
    if unknown:
        raise BindError(f"Binder Error: struct_update: unknown fields {sorted(unknown)}")
    new_fields, at = [], {}
    for i, (n, t) in enumerate(fields):
        if n.lower() in updates:
            v, nt = updates[n.lower()]
            new_fields.append((n, nt))
            at[i] = v
        else:
            new_fields.append((n, t))
    lt = struct_of(*new_fields)
    return lt, _per_distinct(lambda t: tuple(at.get(i, v) for i, v in enumerate(t)), lt)


@register("struct_concat")
def _bind_struct_concat(arg_exprs):
    fields = [f for a in arg_exprs for f in _struct_fields(a)]
    seen = set()
    for n, _ in fields:
        if n.lower() in seen:
            raise BindError(f'Binder Error: duplicate struct field name "{n}"')
        seen.add(n.lower())
    lt = struct_of(*fields)

    def impl(env, cols, node):
        if len(cols) == 1:
            return cols[0]
        return per_distinct_rows(cols, env, lambda *ts: sum((tuple(t) for t in ts), ()), lt)
    return lt, impl, arg_exprs


# -- maps -------------------------------------------------------------------------------
def _map_types(e):
    if e.ltype.id is not TypeId.MAP:
        raise BindError("Binder Error: function expects a MAP argument")
    f = e.ltype.fields or (("key", SQLNULL), ("value", SQLNULL))
    return f[0][1], f[1][1]


@register("map_entries")
def _bind_map_entries(arg_exprs):
    kt, vt = _map_types(arg_exprs[0])
    lt = list_of(struct_of(("key", kt), ("value", vt)))
    return lt, _per_distinct(lambda t: tuple(tuple(p) for p in t), lt), arg_exprs


def _from_entries(t):
    keys = [p[0] for p in t]
    if len(set(keys)) != len(keys):
        raise ValueError("Invalid Input Error: Map keys must be unique.")
    if any(k is None for k in keys):
        raise ValueError("Invalid Input Error: Map keys can not be NULL.")
    return tuple(tuple(p) for p in t)


@register("map_from_entries")
def _bind_map_from_entries(arg_exprs):
    """A MAP from a list of (key, value) structs; a repeated or NULL key
    raises, as DuckDB's map_from_entries.cpp does (fault (l))."""
    base = arg_exprs[0]
    if base.ltype.id not in _LISTS:
        raise BindError("Binder Error: map_from_entries expects a LIST of structs")
    st = base.ltype.child
    kt = vt = SQLNULL
    if st is not None and st.fields:
        kt, vt = st.fields[0][1], st.fields[1][1]
    lt = map_of(kt, vt)

    def impl(env, cols, node):
        return per_distinct_rows(cols, env, _from_entries, lt)
    return lt, impl, arg_exprs


def _concat_maps(*ms):
    merged = {}
    for m in ms:
        merged.update(dict(tuple(p) for p in (m or ())))
    return tuple(merged.items())


@register("map_concat")
def _bind_map_concat(arg_exprs):
    for a in arg_exprs:
        _map_types(a)
    lt = arg_exprs[0].ltype

    def impl(env, cols, node):
        return per_distinct_rows(cols, env, _concat_maps, lt, valid_in=False)
    return lt, impl, arg_exprs


REGISTRY["map_extract_value"] = map_element


@register("map_extract")
def _bind_map_extract(arg_exprs):
    """The value for a key as a one-element list, [] when absent (the
    reference's list-returning form)."""
    _, vt = _map_types(arg_exprs[0])
    key, _ = _const_py(arg_exprs[1])
    lt = list_of(vt)
    return lt, _per_distinct(lambda t: next(((v,) for k, v in t if k == key), ()), lt), \
        arg_exprs[:1]


# -- intervals ------------------------------------------------------------------------
# the month-based constructors fold to (months, days, micros) literals in
# the binder (binder._bind_FunctionCall), as month intervals are bind-time
# values in both packages
MONTH_INTERVAL_FNS = {"to_months": 1, "to_quarters": 3, "to_years": 12, "to_decades": 120,
                      "to_centuries": 1200, "to_millennia": 12000}


@register("nanosecond")
def _bind_nanosecond(arg_exprs):
    """Nanoseconds within the minute (microsecond resolution × 1000)."""
    def impl(env, cols, node):
        c = cols[0]
        x = bcast(c.data, env.plen).to(torch.int64)
        if c.ltype.id is TypeId.DATE:
            x = torch.zeros_like(x)
        return Column(data=torch.remainder(x, 60_000_000) * 1000, ltype=BIGINT,
                      validity=c.validity)
    return BIGINT, impl, arg_exprs


@register("normalized_interval")
def _bind_normalized_interval(arg_exprs):
    """Device intervals are microseconds already."""
    def impl(env, cols, node):
        return cols[0]
    return INTERVAL, impl, arg_exprs


# -- generic and meta -------------------------------------------------------------------
@register("stats")
def _bind_stats(arg_exprs):
    """'[Min: lo, Max: hi]' of the physical values the live rows hold."""
    def impl(env, cols, node):
        c = cols[0]
        d = bcast(c.data, env.plen)
        keep = env.live if c.validity is None else env.live & bcast(c.validity, env.plen)
        vals = d[keep]
        s = (f"[Min: {vals.min().item()}, Max: {vals.max().item()}]" if vals.numel()
             else "[Min: ?, Max: ?]")
        return _const_varchar(env, s)
    return VARCHAR, impl, arg_exprs


@register("vector_type")
def _bind_vector_type(arg_exprs):
    def impl(env, cols, node):
        return _const_varchar(env, "DICTIONARY_VECTOR" if cols[0].dict_values is not None
                              else "FLAT_VECTOR")
    return VARCHAR, impl, arg_exprs


@register("current_query_id")
def _bind_current_query_id(arg_exprs):
    def impl(env, cols, node):
        return Column(data=_full(env, 0, torch.int64), ltype=BIGINT)
    return BIGINT, impl, []


@register("in_search_path")
def _bind_in_search_path(arg_exprs):
    """in_search_path(database, schema): is the schema searched?"""
    def impl(env, cols, node):
        return dict_predicate(cols[-1], lambda s: s in ("main", "temp", "pg_catalog"),
                              device_key="in_search_path")
    return BOOLEAN, impl, arg_exprs


@register("path_join")
def _bind_path_join(arg_exprs):
    rest = ["" if v is None else str(v) for v in (_const_py(a)[0] for a in arg_exprs[1:])]

    def impl(env, cols, node):
        return dict_transform(cols[0], lambda s: os.path.join(s, *rest),
                              device_key=f"path_join:{rest!r}")
    return VARCHAR, impl, arg_exprs[:1]


@register("getvariable")
def _bind_getvariable(arg_exprs):
    """NULL: no variable can be set, in either package (no SET VARIABLE)."""
    def impl(env, cols, node):
        return Column(data=_full(env, 0, torch.int32), ltype=VARCHAR,
                      validity=_full(env, False, torch.bool),
                      dict_values=np.array([""], dtype=object))
    return VARCHAR, impl, []


def _sort_key_bytes(v, t: LogicalType, desc: bool, nulls_first: bool) -> bytes:
    if v is None:
        return b"\x00" if nulls_first else b"\x02"
    if isinstance(v, str):
        enc = v.encode() + b"\x00"
    elif isinstance(v, bool) or isinstance(v, int):
        enc = (int(v) ^ (1 << 63)).to_bytes(8, "big")
    else:
        enc = np.float64(v).tobytes()
    if desc:
        enc = bytes(255 - b for b in enc)
    return b"\x01" + enc


@register("create_sort_key")
def _bind_create_sort_key(arg_exprs):
    """A byte-comparable key of (value, 'asc|desc nulls first|last') pairs,
    hex-rendered, once per distinct tuple of values."""
    exprs = arg_exprs[0::2]
    mods = [str(m.const_value()).lower() for m in arg_exprs[1::2]]
    mods += ["asc nulls last"] * (len(exprs) - len(mods))
    flags = [("desc" in m, "nulls first" in m) for m in mods]
    types = [e.ltype for e in exprs]

    def key(*vals):
        return b"".join(_sort_key_bytes(v, t, d, nf)
                        for v, t, (d, nf) in zip(vals, types, flags)).hex()

    def impl(env, cols, node):
        return per_distinct_rows(cols, env, key, VARCHAR, valid_in=False)
    return VARCHAR, impl, list(exprs)


@register("setval")
def _bind_setval(arg_exprs):
    """setval('seq', v): the next nextval gives v plus the increment
    (DuckDB's nextval.cpp family)."""
    from duckdb_tpu_torch.planner.functions_ext import sequence

    name = str(arg_exprs[0].const_value()).lower()
    val = int(arg_exprs[1].const_value())

    def impl(env, cols, node):
        seq = sequence(name)
        seq["value"] = val + seq["increment"]
        seq["last"] = val
        return Column(data=_full(env, val, torch.int64), ltype=BIGINT)

    return BIGINT, impl, []


@register("is_histogram_other_bin")
def _bind_is_histogram_other_bin(arg_exprs):
    """True for the catch-all bin of a histogram: '' over text, +inf over a
    float (DuckDB's binning.cpp), never over other types."""
    t = arg_exprs[0].ltype

    def impl(env, cols, node):
        c = cols[0]
        if t.id is TypeId.VARCHAR:
            return dict_predicate(c, lambda s: s == "", device_key="other_bin")
        d = bcast(c.data, env.plen)
        out = torch.isposinf(d) if t.is_float else torch.zeros_like(d, dtype=torch.bool)
        return Column(data=out, ltype=BOOLEAN, validity=c.validity)
    return BOOLEAN, impl, arg_exprs


# -- the array_* aliases ---------------------------------------------------------------
_ARRAY_ALIASES = {
    "array_aggr": "list_aggr", "array_aggregate": "list_aggregate", "array_cat": "list_concat",
    "array_distinct": "list_distinct", "array_has": "list_contains",
    "array_indexof": "list_indexof", "array_reverse_sort": "list_reverse_sort",
    "array_sort": "list_sort", "array_unique": "list_unique", "array_value": "list_value",
    "array_slice": "list_slice", "array_position": "list_position",
    "array_reverse": "list_reverse", "array_append": "list_append",
    "array_prepend": "list_prepend", "array_has_all": "list_has_all",
    "array_has_any": "list_has_any",
}

for _alias, _target in _ARRAY_ALIASES.items():
    if _alias not in REGISTRY and _target in REGISTRY:
        REGISTRY[_alias] = REGISTRY[_target]
