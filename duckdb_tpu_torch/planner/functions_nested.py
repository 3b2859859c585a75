"""Nested values: the LIST, STRUCT, MAP, ARRAY, UNION and BIT functions and lambdas.

The JAX package's duckdb_tpu/planner/functions_nested.py (DuckDB's nested
function family, core_functions/scalar/list/*.cpp and
function/scalar/struct/*.cpp) in torch. A nested value is
dictionary-encoded like VARCHAR (blocks/nested.py): the device holds an
int32 code per row and the distinct tuples live on the host. A function
over a nested value runs once per distinct value on the host and reaches
the rows as one gather by code on the column's device (`_lut_gather`).
Constructors over constants make a one-entry dictionary; list_value over
columns is a ListPack plan node (planner.py, execution/executor.py).

Lambdas (list_transform, list_filter, list_reduce) evaluate their bound
body as torch ops on the column's device: transform and filter once over
the flattened elements of all distinct lists, reduce round by round, one
evaluation per element position over the lists still that long.

`len`/`length` over a LIST, ARRAY or MAP give its length (functions.py
dispatches here), and `contains` over a LIST is list_contains. The ENUM
functions read CREATE TYPE's ENUM of their argument.

Where DuckDB and the JAX package differ, the port follows DuckDB: a DECIMAL
or DATE element is a decimal.Decimal or datetime.date (the reference's
ListPack and list() give its physical integer), and the parity tests use
other element types there.
"""

from __future__ import annotations

import decimal as pydec
import itertools
import math
import statistics
from collections import Counter

import numpy as np
import torch

from duckdb_tpu_torch.blocks import Column
from duckdb_tpu_torch.blocks.nested import (
    NESTED_IDS,
    column_values,
    encode_objects,
    lut_column,
    obj_array,
    scalar_py,
)
from duckdb_tpu_torch.ops import strings as dstr
from duckdb_tpu_torch.planner.bound import (
    BindError,
    BoundAggregateRef,
    BoundColumnRef,
    BoundLiteral,
    EvalEnv,
    _and_validity,
    _coerce_to,
    bcast,
    not_ported,
    walk,
)
from duckdb_tpu_torch.planner.functions import REGISTRY, register
from duckdb_tpu_torch.types import (
    BIGINT,
    BIT,
    BOOLEAN,
    DOUBLE,
    INTEGER,
    SQLNULL,
    VARCHAR,
    LogicalType,
    TypeId,
    array_of,
    list_of,
    map_of,
    max_logical_type,
    struct_of,
    union_of,
)

_LISTS = (TypeId.LIST, TypeId.ARRAY)


# -- helpers -----------------------------------------------------------------
def _const_py(e):
    """(Python value, type) of a constant bound expression; a nested
    constant (an inner list literal) is evaluated over one row."""
    if e.ltype.id in NESTED_IDS or e.ltype.id is TypeId.BIT:
        if isinstance(e, BoundLiteral):
            return e.value, e.ltype
        if not _is_const_tree(e):
            raise BindError("nested constructors take constant arguments here; "
                            "list_value over columns is planned as a ListPack")
        c = e.eval(EvalEnv(cols={}, plen=1, live=torch.ones(1, dtype=torch.bool)))
        code = int(c.data.reshape(-1)[0])
        if c.validity is not None and not bool(c.validity.reshape(-1)[0]):
            return None, e.ltype
        return c.dict_values[code], e.ltype
    try:
        v = e.const_value()
    except (BindError, ValueError, KeyError) as exc:
        raise BindError("nested constructors take constant arguments here; "
                        "list_value over columns is planned as a ListPack") from exc
    t = e.ltype
    if v is None:
        return None, SQLNULL if t.id is TypeId.SQLNULL else t
    if t.id is TypeId.VARCHAR:
        return str(v), t
    return scalar_py(v, t), t


def _is_const_tree(e) -> bool:
    """True when no column reference is under e (a nested constructor
    over constants)."""
    return not any(isinstance(n, (BoundColumnRef, BoundAggregateRef)) for n in walk(e))


def _const_column(entry, lt: LogicalType):
    """A constant one-entry dictionary column."""

    def impl(env, cols, node):
        return Column(data=torch.zeros((), dtype=torch.int32, device=env.live.device)
                      .expand(env.plen), ltype=lt, dict_values=obj_array([entry]))

    return impl


def _codes(c: Column, n: int) -> torch.Tensor:
    return c.data.long().clamp(0, max(n - 1, 0))


def _lut_gather(col: Column, vals, ct: LogicalType, key=None) -> Column:
    """Per-distinct host values → the column of them, one gather by code
    on the column's device; NULL where the value or the row is NULL. With
    a `key`, vals is a function that computes them, and the lookup table
    is cached per dictionary under the key (ops/strings.cached_lut)."""
    if key is None:
        lut = lut_column(vals, ct, col.data.device)
    else:
        dev = col.data.device
        lut = dstr.cached_lut(col.dict_values, key + (ct, str(dev)),
                              lambda: lut_column(vals(), ct, dev))
    idx = _codes(col, lut.data.shape[0])
    valid = None if lut.validity is None else lut.validity[idx]
    return Column(data=lut.data[idx], ltype=ct, validity=_and_validity(valid, col.validity),
                  dict_values=lut.dict_values)


def _recode(col: Column, entries, out_t: LogicalType) -> Column:
    """Per-distinct new nested values → codes into their own dictionary."""
    inv, dvals = encode_objects(entries)
    lut = torch.from_numpy(inv if len(inv) else np.zeros(1, np.int32)).to(col.data.device)
    return Column(data=lut[_codes(col, len(inv))], ltype=out_t, validity=col.validity,
                  dict_values=dvals)


def _per_distinct(fn, out_t, ci=0):
    def impl(env, cols, node):
        c = cols[ci]
        return _recode(c, [fn(t) for t in c.dict_values], out_t)

    return impl


def _scalar_per_distinct(fn, out_t, ci=0):
    def impl(env, cols, node):
        c = cols[ci]
        return _lut_gather(c, [fn(t) for t in c.dict_values], out_t)

    return impl


def _require_list(name, t):
    if t.id not in _LISTS and t.id is not TypeId.SQLNULL:
        raise BindError(f"Binder Error: {name} expects a LIST argument, got {t!r}")


# -- constructors ----------------------------------------------------------------
@register("list_value")
@register("list_pack")
def _bind_list_value(arg_exprs):
    vals = []
    child = SQLNULL
    for a in arg_exprs:
        v, t = _const_py(a)
        vals.append(v)
        if child.id is TypeId.SQLNULL:
            child = t
    lt = list_of(child)
    return lt, _const_column(tuple(vals), lt), []


@register("struct_pack_kv")
def _bind_struct_pack_kv(arg_exprs):
    """Interleaved ('name', expr, 'name', expr, ...) from the {..} literal."""
    fields, vals = [], []
    for i in range(0, len(arg_exprs), 2):
        name = str(arg_exprs[i].const_value())
        v, t = _const_py(arg_exprs[i + 1])
        fields.append((name, t))
        vals.append(v)
    lt = struct_of(*fields)
    return lt, _const_column(tuple(vals), lt), []


@register("row")
@register("struct_pack")
def _bind_row(arg_exprs):
    """Positional STRUCT constructor (fields v1..vn, or the arguments' aliases)."""
    fields, vals = [], []
    for i, a in enumerate(arg_exprs):
        v, t = _const_py(a)
        fields.append((getattr(a, "alias", None) or f"v{i + 1}", t))
        vals.append(v)
    lt = struct_of(*fields)
    return lt, _const_column(tuple(vals), lt), []


@register("map_pack_kv")
def _bind_map_pack_kv(arg_exprs):
    """MAP {'k': v, ...}: entries are (key, value) pairs."""
    kt = vt = SQLNULL
    pairs = []
    for i in range(0, len(arg_exprs), 2):
        k, kt_ = _const_py(arg_exprs[i])
        v, vt_ = _const_py(arg_exprs[i + 1])
        if kt.id is TypeId.SQLNULL:
            kt = kt_
        if vt.id is TypeId.SQLNULL:
            vt = vt_
        pairs.append((k, v))
    lt = map_of(kt, vt)
    return lt, _const_column(tuple(pairs), lt), []


@register("map")
def _bind_map(arg_exprs):
    if not arg_exprs:
        lt = map_of(SQLNULL, SQLNULL)
        return lt, _const_column((), lt), []
    ks, kt_l = _const_py(arg_exprs[0])
    vs, vt_l = _const_py(arg_exprs[1])
    lt = map_of(kt_l.child or SQLNULL, vt_l.child or SQLNULL)
    return lt, _const_column(tuple(zip(ks, vs)), lt), []


@register("array_value")
def _bind_array_value(arg_exprs):
    """Fixed-size ARRAY constructor (DuckDB's array_value.cpp)."""
    if not arg_exprs:
        raise BindError("array_value requires at least one element")
    ct = arg_exprs[0].ltype
    for a in arg_exprs[1:]:
        ct = max_logical_type(ct, a.ltype)
    lt = array_of(ct, len(arg_exprs))
    _, lv_impl, lv_args = REGISTRY["list_value"](arg_exprs)

    def impl(env, cols, node):
        c = lv_impl(env, cols, node)
        return Column(data=c.data, ltype=lt, validity=c.validity, dict_values=c.dict_values)

    return lt, impl, lv_args


def _range_binder(name: str, inclusive: bool):
    """range/generate_series as a scalar over constants: range excludes
    the stop bound, generate_series includes it (DuckDB's range.cpp)."""

    def binder(arg_exprs):
        if not all(a.is_const() for a in arg_exprs):
            raise BindError(f"scalar {name}() requires constant arguments")
        vals = [a.const_value() for a in arg_exprs]
        if len(vals) == 1:
            start, stop, step = 0, vals[0], 1
        elif len(vals) == 2:
            (start, stop), step = vals, 1
        else:
            start, stop, step = vals
        if step == 0:
            raise BindError(f"step of {name} cannot be 0")
        end = int(stop) + ((1 if step > 0 else -1) if inclusive else 0)
        lt = list_of(BIGINT)
        return lt, _const_column(tuple(range(int(start), end, int(step))), lt), []

    return binder


REGISTRY["range"] = _range_binder("range", False)
REGISTRY["generate_series"] = _range_binder("generate_series", True)


# -- element access -----------------------------------------------------------
def _pick(t, idx):
    """1-based; negative counts from the end; out of range → NULL."""
    i = idx - 1 if idx > 0 else idx
    if idx == 0 or i >= len(t) or i < -len(t):
        return None
    return t[i]


@register("list_extract")
@register("list_element")
@register("array_extract")
def _bind_list_extract(arg_exprs):
    base = arg_exprs[0]
    if base.ltype.id is TypeId.MAP:
        return map_element(arg_exprs)
    if base.ltype.id is TypeId.STRUCT:
        return _bind_struct_extract(arg_exprs)
    _require_list("list_extract", base.ltype)
    idx = int(arg_exprs[1].const_value())
    ct = base.ltype.child or SQLNULL

    def impl(env, cols, node):
        c = cols[0]

        def vals():
            if idx > 0:
                i = idx - 1
                return [t[i] if len(t) > i else None for t in c.dict_values]
            return [_pick(t, idx) for t in c.dict_values]
        return _lut_gather(c, vals, ct, key=("list_extract", idx))

    return ct, impl, arg_exprs[:1]


@register("struct_extract")
def _bind_struct_extract(arg_exprs):
    base = arg_exprs[0]
    if base.ltype.id is TypeId.MAP:
        return map_element(arg_exprs)
    if base.ltype.id is TypeId.UNION:
        return _bind_union_extract(arg_exprs)
    if base.ltype.id is not TypeId.STRUCT:
        raise BindError(f"struct_extract expects a STRUCT argument, got {base.ltype!r}")
    name = str(arg_exprs[1].const_value()).lower()
    for pos, (fname, ftype) in enumerate(base.ltype.fields or ()):
        if fname.lower() == name:
            break
    else:
        raise BindError(f'struct has no field "{name}"')
    return ftype, _scalar_per_distinct(lambda t: t[pos] if pos < len(t) else None, ftype), \
        arg_exprs[:1]


def map_element(arg_exprs):
    """m[k] / element_at(m, k): the value for key k, NULL when absent."""
    base = arg_exprs[0]
    k, _ = _const_py(arg_exprs[1])
    vt = base.ltype.child or SQLNULL
    return vt, _scalar_per_distinct(lambda t: next((v for kk, v in t if kk == k), None), vt), \
        arg_exprs[:1]


REGISTRY["element_at"] = map_element


# -- predicates and scalars over lists -----------------------------------------
@register("list_contains")
@register("array_contains")
@register("list_has")
def _bind_list_contains(arg_exprs):
    needle, _ = _const_py(arg_exprs[1])
    return BOOLEAN, _scalar_per_distinct(lambda t: needle in t, BOOLEAN), arg_exprs[:1]


@register("list_position")
@register("list_indexof")
@register("array_position")
def _bind_list_position(arg_exprs):
    needle, _ = _const_py(arg_exprs[1])
    return BIGINT, _scalar_per_distinct(
        lambda t: t.index(needle) + 1 if needle in t else None, BIGINT), arg_exprs[:1]


@register("list_unique")
def _bind_list_unique(arg_exprs):
    return BIGINT, _scalar_per_distinct(
        lambda t: len({x for x in t if x is not None}), BIGINT), arg_exprs[:1]


@register("array_length")
@register("list_length")
def _bind_list_length(arg_exprs):
    def impl(env, cols, node):
        c = cols[0]
        lut = _flatten(c.dict_values)[0] if c.ltype.id in _LISTS else \
            np.fromiter(map(len, c.dict_values), dtype=np.int64, count=len(c.dict_values))
        lut = torch.from_numpy(lut if len(lut) else np.zeros(1, np.int64)).to(c.data.device)
        return Column(data=lut[_codes(c, lut.shape[0])], ltype=BIGINT, validity=c.validity)

    return BIGINT, impl, arg_exprs[:1]


@register("cardinality")
def _bind_cardinality(arg_exprs):
    return _bind_list_length(arg_exprs[:1])


@register("map_contains")
def _bind_map_contains(arg_exprs):
    k, _ = _const_py(arg_exprs[1])
    return BOOLEAN, _scalar_per_distinct(lambda t: any(kk == k for kk, _ in t), BOOLEAN), \
        arg_exprs[:1]


@register("map_keys")
def _bind_map_keys(arg_exprs):
    base = arg_exprs[0]
    kt = (base.ltype.fields or (("key", SQLNULL),))[0][1]
    out_t = list_of(kt)
    return out_t, _per_distinct(lambda t: tuple(k for k, _ in t), out_t), arg_exprs[:1]


@register("map_values")
def _bind_map_values(arg_exprs):
    out_t = list_of(arg_exprs[0].ltype.child or SQLNULL)
    return out_t, _per_distinct(lambda t: tuple(v for _, v in t), out_t), arg_exprs[:1]


# -- string_split -----------------------------------------------------------------
@register("string_split")
@register("str_split")
@register("string_to_array")
@register("split")
def _bind_string_split(arg_exprs):
    sep = str(arg_exprs[1].const_value())
    lt = list_of(VARCHAR)

    def impl(env, cols, node):
        c = cols[0]
        dev = c.data.device

        def compute():
            inv, dvals = encode_objects([tuple(str(s).split(sep)) for s in c.dict_values])
            return torch.from_numpy(inv if len(inv) else np.zeros(1, np.int32)).to(dev), dvals

        # the split of a table's dictionary is kept for the next query
        lut, dvals = dstr.cached_lut(c.dict_values, ("string_split", sep, str(dev)), compute)
        return Column(data=lut[_codes(c, lut.shape[0])], ltype=lt, validity=c.validity,
                      dict_values=dvals)

    return lt, impl, arg_exprs[:1]


# -- list → list transforms ---------------------------------------------------------
def _sort_key_fn(descending: bool):
    """Non-NULL elements sorted, NULLs after them."""
    def fn(t):
        if None not in t:
            return tuple(sorted(t, reverse=descending))
        return tuple(sorted((x for x in t if x is not None), reverse=descending)) \
            + tuple(None for x in t if x is None)
    return fn


def _list_transform(name, fn, out_child=None):
    def binder(arg_exprs):
        base = arg_exprs[0]
        if base.ltype.id is not TypeId.LIST:
            raise BindError(f"{name} expects a LIST argument")
        lt = list_of(out_child) if out_child is not None else base.ltype
        return lt, _per_distinct(fn, lt), arg_exprs[:1]

    REGISTRY[name] = binder


_list_transform("list_sort", _sort_key_fn(False))
_list_transform("list_reverse_sort", _sort_key_fn(True))
_list_transform("list_distinct", lambda t: tuple(dict.fromkeys(x for x in t if x is not None)))
_list_transform("list_reverse", lambda t: tuple(reversed(t)))
_list_transform("array_pop_back", lambda t: tuple(t[:-1]))
_list_transform("array_pop_front", lambda t: tuple(t[1:]))


def _pairwise_list_op(a: Column, b: Column, fn, out_t, plen):
    """A host op per distinct PAIR of two nested columns → a LUT gathered
    by the pair code a·|b| + b."""
    na, nb = max(len(a.dict_values), 1), max(len(b.dict_values), 1)
    entries = [fn(ta, tb) for ta in a.dict_values for tb in b.dict_values] or [fn((), ())]
    inv, dvals = encode_objects(entries)
    pair = bcast(_codes(a, na), plen) * nb + bcast(_codes(b, nb), plen)
    lut = torch.from_numpy(inv).to(a.data.device)
    return Column(data=lut[pair.clamp(0, len(inv) - 1)], ltype=out_t,
                  validity=_and_validity(a.validity, b.validity), dict_values=dvals)


@register("list_concat")
@register("list_cat")
@register("array_concat")
def _bind_list_concat(arg_exprs):
    for a in arg_exprs:
        if a.ltype.id not in _LISTS and a.ltype.id is not TypeId.SQLNULL:
            raise BindError("list_concat expects LIST arguments")
    out_t = arg_exprs[0].ltype

    def impl(env, cols, node):
        acc = cols[0]
        for c in cols[1:]:
            acc = _pairwise_list_op(acc, c, lambda x, y: tuple(x) + tuple(y), out_t, env.plen)
        return acc

    return out_t, impl, arg_exprs


@register("list_append")
@register("array_append")
def _bind_list_append(arg_exprs):
    v, _ = _const_py(arg_exprs[1])
    out_t = arg_exprs[0].ltype
    return out_t, _per_distinct(lambda t: tuple(t) + (v,), out_t), arg_exprs[:1]


@register("list_prepend")
@register("array_prepend")
def _bind_list_prepend(arg_exprs):
    v, _ = _const_py(arg_exprs[0])  # list_prepend(value, list)
    out_t = arg_exprs[1].ltype
    return out_t, _per_distinct(lambda t: (v,) + tuple(t), out_t), arg_exprs[1:]


@register("list_slice")
@register("array_slice")
def _bind_list_slice(arg_exprs):
    """1-based inclusive bounds (DuckDB's list_slice.cpp)."""
    a = int(arg_exprs[1].const_value())
    b = int(arg_exprs[2].const_value())
    out_t = arg_exprs[0].ltype

    def sl(t):
        lo = a - 1 if a > 0 else len(t) + a
        hi = b if b > 0 else len(t) + b + 1
        return tuple(t[max(lo, 0):max(hi, 0)])

    return out_t, _per_distinct(sl, out_t), arg_exprs[:1]


@register("flatten")
def _bind_flatten(arg_exprs):
    base = arg_exprs[0]
    if base.ltype.id is not TypeId.LIST or (base.ltype.child or SQLNULL).id is not TypeId.LIST:
        raise BindError("flatten expects a LIST of LISTs")
    out_t = base.ltype.child
    return out_t, _per_distinct(
        lambda t: tuple(x for sub in t if sub is not None for x in sub), out_t), arg_exprs[:1]


# -- lambdas ----------------------------------------------------------------
_FLAT: dict = {}  # id(dictionary) → (dictionary, lengths, offsets, flat elements)


def _flatten(dvals):
    """Distinct lists → (lengths int64, offsets int64, flat element list),
    kept for the dictionary's next function (a query often applies several
    to one list column)."""
    hit = _FLAT.get(id(dvals))
    if hit is None or hit[0] is not dvals:
        lens = np.fromiter(map(len, dvals), dtype=np.int64, count=len(dvals))
        offs = np.cumsum(lens) - lens
        hit = (dvals, lens, offs, list(itertools.chain.from_iterable(dvals)))
        if len(_FLAT) >= 8:
            _FLAT.pop(next(iter(_FLAT)))
        _FLAT[id(dvals)] = hit
    return hit[1:]


_ELEMS: dict = {}  # (id(dictionary), type, device) → (dictionary, element Column)


def _elements(dvals, child_t: LogicalType, flat, device) -> Column:
    """The flattened elements of a dictionary's lists as a Column on
    `device`, kept for the dictionary's next lambda."""
    key = (id(dvals), child_t, str(device))
    hit = _ELEMS.get(key)
    if hit is None or hit[0] is not dvals:
        if len(_ELEMS) >= 8:
            _ELEMS.pop(next(iter(_ELEMS)))
        hit = (dvals, lut_column(flat, child_t, device))
        _ELEMS[key] = hit
    return hit[1]


def _rows_of(c: Column, idx: torch.Tensor) -> Column:
    return Column(data=c.data[idx], ltype=c.ltype,
                  validity=None if c.validity is None else c.validity[idx],
                  dict_values=c.dict_values, data_hi=None if c.data_hi is None
                  else c.data_hi[idx])


def _eval_body(body_b, cols, n, device) -> Column:
    env = EvalEnv(cols=cols, plen=n, live=torch.ones(n, dtype=torch.bool, device=device))
    rc = body_b.eval(env)
    return Column(data=bcast(rc.data, n), ltype=rc.ltype,
                  validity=None if rc.validity is None else bcast(rc.validity, n),
                  dict_values=rc.dict_values)


def bind_lambda_func(name, base, body_b, pkey, child_t, ikey=None):
    """list_transform / list_filter: the body evaluates once over the
    flattened elements of all distinct lists on the column's device (with
    the 1-based position under `ikey` for two-parameter lambdas); the
    results go to the host once and rebuild each distinct list."""
    is_filter = "filter" in name
    out_t = base.ltype if is_filter else list_of(body_b.ltype)

    def impl(env, cols, node):
        c = cols[0]
        dev = c.data.device
        lens, offs, flat = _flatten(c.dict_values)
        n = len(flat)
        if not n:
            return _recode(c, [() for _ in c.dict_values], out_t)
        ecols = {pkey: _elements(c.dict_values, child_t, flat, dev)}
        if ikey is not None:
            pos = np.arange(n, dtype=np.int64) - np.repeat(offs, lens) + 1
            ecols[ikey] = Column(data=torch.from_numpy(pos).to(dev), ltype=BIGINT)
        rc = _eval_body(body_b, ecols, n, dev)
        ends = np.cumsum(lens)
        if is_filter:
            keep = (rc.data.to(torch.bool) if rc.validity is None
                    else rc.data.to(torch.bool) & rc.validity).cpu().numpy()
            kept = list(itertools.compress(flat, keep))
            kend = np.cumsum(keep)[ends - 1] if n else ends
            kend = np.where(lens > 0, kend, np.concatenate([[0], kend[:-1]]) if len(kend) else kend)
            kstart = np.concatenate([[0], kend[:-1]])
            entries = [tuple(kept[a:b]) for a, b in zip(kstart.tolist(), kend.tolist())]
        else:
            res = column_values(rc, n)
            entries = [tuple(res[a:a + k]) for a, k in zip(offs.tolist(), lens.tolist())]
        return _recode(c, entries, out_t)

    return out_t, impl


def bind_reduce_func(name, base, body_b, akey, xkey, child_t):
    """list_reduce(l, (acc, x) -> …): a left fold over each distinct list,
    round by round on the column's device: round k evaluates the body
    once over element k of every distinct list that long, so the lists
    take max-length evaluations, not one per element. An empty list gives
    NULL."""
    out_t = body_b.ltype
    dict_out = out_t.id in (TypeId.VARCHAR, TypeId.BIT, TypeId.BLOB) or out_t.id in NESTED_IDS

    def impl(env, cols, node):
        c = cols[0]
        dev = c.data.device
        lens, offs, flat = _flatten(c.dict_values)
        nd = len(lens)
        if not len(flat):
            return _lut_gather(c, [None] * nd, out_t)
        elem = _elements(c.dict_values, child_t, flat, dev)
        has = np.flatnonzero(lens > 0)
        first = torch.from_numpy(offs[has]).to(dev)
        acc = _rows_of(elem, first)  # one row per non-empty list
        acc_rows = np.arange(len(has))
        for k in range(1, int(lens.max())):
            active = np.flatnonzero(lens[has] > k)
            if not len(active):
                break
            at = torch.from_numpy(active).to(dev)
            x = _rows_of(elem, torch.from_numpy(offs[has][active] + k).to(dev))
            a = _rows_of(acc, at)
            rc = _eval_body(body_b, {akey: a, xkey: x}, len(active), dev)
            if dict_out or k == 1 and rc.ltype.torch_dtype != acc.data.dtype:
                # a dictionary-coded accumulator (or the first round's new
                # type) is rebuilt through host values: codes of one round's
                # dictionary mean nothing in another's
                vals = column_values(acc, len(acc_rows))
                res = column_values(rc, len(active))
                for j, i in enumerate(active.tolist()):
                    vals[i] = res[j]
                acc = lut_column(vals, out_t, dev)
            else:
                data = acc.data.clone()
                data[at] = rc.data.to(data.dtype)
                valid = acc.validity
                if rc.validity is not None or valid is not None:
                    valid = (torch.ones(len(acc_rows), dtype=torch.bool, device=dev)
                             if valid is None else valid.clone())
                    valid[at] = (torch.ones(len(active), dtype=torch.bool, device=dev)
                                 if rc.validity is None else rc.validity)
                acc = Column(data=data, ltype=out_t, validity=valid)
        if acc.ltype != out_t:  # every list had one element: no round ran
            acc = _coerce_to(acc, out_t, EvalEnv(cols={}, plen=len(acc_rows),
                                                 live=torch.ones(len(acc_rows),
                                                                 dtype=torch.bool, device=dev)))
        # the per-list result LUT (an empty list NULL), gathered by code
        slot = np.full(nd, len(has), dtype=np.int64)
        slot[has] = np.arange(len(has))
        pad = torch.zeros(1, dtype=acc.data.dtype, device=dev)
        data = torch.cat([bcast(acc.data, len(has)), pad])
        valid = torch.cat([torch.ones(len(has), dtype=torch.bool, device=dev)
                           if acc.validity is None else bcast(acc.validity, len(has)),
                           torch.zeros(1, dtype=torch.bool, device=dev)])
        idx = torch.from_numpy(slot).to(dev)[_codes(c, nd)]
        return Column(data=data[idx], ltype=out_t, validity=_and_validity(valid[idx], c.validity),
                      dict_values=acc.dict_values)

    return out_t, impl


# -- list_aggregate -----------------------------------------------------------------
def _laggr_compute(fname: str, t, sep: str = ","):
    """Aggregate `fname` over one list's values: NULL elements ignored, an
    empty input NULL (count 0), as DuckDB's list_aggregates.cpp."""
    vs = [x for x in t if x is not None]
    if fname == "count":
        return len(vs)
    if fname in ("bool_and", "bool_or"):
        if not vs:
            return None
        bools = [bool(x) for x in vs]
        return all(bools) if fname == "bool_and" else any(bools)
    if not vs:
        return None
    if fname == "sum":
        return sum(vs)
    if fname == "product":
        p = 1
        for x in vs:
            p *= x
        return p
    if fname in ("avg", "mean"):
        return float(sum(float(x) for x in vs)) / len(vs)
    if fname == "min":
        return min(vs)
    if fname == "max":
        return max(vs)
    if fname in ("first", "any_value"):
        return vs[0]
    if fname == "last":
        return vs[-1]
    if fname == "median":
        return float(statistics.median(float(x) for x in vs))
    if fname == "mode":
        return statistics.mode(vs)
    if fname == "mad":
        med = statistics.median(float(x) for x in vs)
        return float(statistics.median(abs(float(x) - med) for x in vs))
    if fname in ("string_agg", "group_concat", "listagg"):
        return sep.join(str(x) for x in vs)
    if fname in ("approx_count_distinct", "count_distinct"):
        return len(set(vs))
    if fname in ("bit_and", "bit_or", "bit_xor"):
        acc = int(vs[0])
        for x in vs[1:]:
            x = int(x)
            acc = acc & x if fname == "bit_and" else acc | x if fname == "bit_or" else acc ^ x
        return acc
    fs = [float(x) for x in vs]
    n = len(fs)
    mean = sum(fs) / n
    m2 = sum((x - mean) ** 2 for x in fs)
    if fname in ("var_samp", "variance", "var"):
        return m2 / (n - 1) if n > 1 else None
    if fname == "var_pop":
        return m2 / n
    if fname in ("stddev_samp", "stddev", "std"):
        return math.sqrt(m2 / (n - 1)) if n > 1 else None
    if fname == "stddev_pop":
        return math.sqrt(m2 / n)
    if fname == "sem":
        return (math.sqrt(m2 / (n - 1)) / math.sqrt(n)) if n > 1 else None
    if fname == "skewness":
        if n < 3:
            return None
        s = math.sqrt(m2 / (n - 1))
        if s == 0:
            return None
        m3 = sum((x - mean) ** 3 for x in fs)
        return (n * m3) / ((n - 1) * (n - 2) * s ** 3)
    if fname in ("kurtosis", "kurtosis_pop"):
        if m2 == 0:
            return None
        m4 = sum((x - mean) ** 4 for x in fs)
        if fname == "kurtosis_pop":
            return n * m4 / (m2 * m2) - 3.0
        if n < 4:
            return None
        c = (n - 1.0) / ((n - 2.0) * (n - 3.0))
        return c * ((n + 1.0) * n * m4 / (m2 * m2) - 3.0 * (n - 1.0))
    if fname == "entropy":
        counts = Counter(vs)
        tot = float(len(vs))
        return -sum((c / tot) * math.log2(c / tot) for c in counts.values())
    raise BindError(f"list_aggregate: unsupported aggregate function {fname!r}")


_LAGGR_CHILD_TYPED = {"min", "max", "first", "last", "any_value", "mode", "sum", "product"}
_LAGGR_BIGINT = {"count", "approx_count_distinct", "count_distinct", "bit_and", "bit_or",
                 "bit_xor"}
_LAGGR_BOOL = {"bool_and", "bool_or"}
_LAGGR_VARCHAR = {"string_agg", "group_concat", "listagg"}


@register("aggregate")
@register("list_aggr")
@register("list_aggregate")
def _bind_list_aggregate(arg_exprs):
    """list_aggregate(l, 'name'[, sep]): an aggregate over each distinct
    list on the host, gathered by code (DuckDB's list_aggregates.cpp)."""
    lt0 = arg_exprs[0].ltype
    if lt0.id not in (TypeId.LIST, TypeId.SQLNULL):
        raise BindError("Binder Error: No function matches the given name and argument "
                        f"types 'list_aggregate({lt0}, VARCHAR)'. You might need to add "
                        "explicit type casts.")
    fname = str(arg_exprs[1].const_value()).lower()
    child = getattr(lt0, "child", None) or SQLNULL
    sep = (str(arg_exprs[2].const_value())
           if len(arg_exprs) > 2 and fname in _LAGGR_VARCHAR else ",")
    if fname in _LAGGR_BIGINT:
        rt = BIGINT
    elif fname in _LAGGR_BOOL:
        rt = BOOLEAN
    elif fname in _LAGGR_VARCHAR:
        rt = VARCHAR
    elif fname in _LAGGR_CHILD_TYPED:
        rt = child if child.id is not TypeId.SQLNULL else BIGINT
    else:
        rt = DOUBLE
    _laggr_compute(fname, (1,), sep)  # an unknown name fails at bind time

    def fix(r):
        # a DECIMAL sum/product is a Decimal that may carry more digits
        if r is not None and rt.id is TypeId.DECIMAL:
            return pydec.Decimal(r).quantize(pydec.Decimal(1).scaleb(-rt.scale),
                                             rounding=pydec.ROUND_HALF_UP)
        return r

    return rt, _scalar_per_distinct(lambda t: fix(_laggr_compute(fname, t, sep)), rt), \
        arg_exprs[:1]


# -- UNION / BIT ----------------------------------------------------------------
def _union_fields(t: LogicalType):
    if t.id is not TypeId.UNION or not t.fields:
        raise BindError("expected a UNION argument")
    return list(t.fields)


@register("union_value")
def _bind_union_value(arg_exprs):
    if len(arg_exprs) != 1:
        raise BindError("union_value takes exactly one tag := value")
    a = arg_exprs[0]
    tag = getattr(a, "alias", None)
    if tag is None:
        raise BindError("union_value requires a named argument (tag := v)")
    lt = union_of((tag, a.ltype))

    def impl(env, cols, node):
        return _coerce_to(cols[0], lt, env)

    return lt, impl, arg_exprs


@register("union_tag")
def _bind_union_tag(arg_exprs):
    names = [n for n, _ in _union_fields(arg_exprs[0].ltype)]
    return VARCHAR, _scalar_per_distinct(lambda t: names[t[0]] if t else None, VARCHAR), \
        arg_exprs[:1]


@register("union_extract")
def _bind_union_extract(arg_exprs):
    fields = _union_fields(arg_exprs[0].ltype)
    name = str(arg_exprs[1].const_value()).lower()
    for ki, (fname, ftype) in enumerate(fields):
        if fname.lower() == name:
            break
    else:
        raise BindError(f'union has no member "{name}"')
    return ftype, _scalar_per_distinct(lambda t: t[1] if t and t[0] == ki else None, ftype), \
        arg_exprs[:1]


def bind_get_bit_typed(arg_exprs):
    idx = int(arg_exprs[1].const_value())
    return INTEGER, _scalar_per_distinct(
        lambda t: int(str(t)[idx]) if 0 <= idx < len(str(t)) else None, INTEGER), arg_exprs[:1]


def bind_set_bit_typed(arg_exprs):
    idx = int(arg_exprs[1].const_value())
    nv = int(arg_exprs[2].const_value())

    def setb(t):
        s = str(t)
        if not (0 <= idx < len(s)):
            return None
        return s[:idx] + str(nv & 1) + s[idx + 1:]

    return BIT, _scalar_per_distinct(setb, BIT), arg_exprs[:1]


def bind_bit_position_typed(arg_exprs):
    """1-based position of the substring bitstring, 0 when absent."""
    sub = str(arg_exprs[0].const_value())
    return INTEGER, _scalar_per_distinct(lambda t: str(t).find(sub) + 1, INTEGER), arg_exprs[1:]


def bind_bitstring_typed(arg_exprs):
    """bitstring(s, n): zero-extend the bitstring s to length n."""
    n = int(arg_exprs[1].const_value())

    def pad(t):
        s = str(t)
        return None if len(s) > n else "0" * (n - len(s)) + s

    return BIT, _scalar_per_distinct(pad, BIT), arg_exprs[:1]


# -- ENUM metadata functions (DuckDB's core_functions/scalar/enum/): they
# read the ENUM type of their argument, CREATE TYPE's in the statement's
# catalog, at bind time, so all but enum_code fold to constants

def _enum_values_of(b):
    from duckdb_tpu_torch.planner.binder import user_types

    name = getattr(b, "enum_type", None)
    ut = user_types().get(name) if name else None
    if ut is None or ut.get("kind") != "enum":
        raise BindError("this function expects an ENUM-typed argument "
                        "(e.g. enum_range(NULL::mood))")
    return list(ut["values"])


@register("enum_range")
def _bind_enum_range(arg_exprs):
    lt = list_of(VARCHAR)
    return lt, _const_column(tuple(_enum_values_of(arg_exprs[0])), lt), []


@register("enum_first")
def _bind_enum_first(arg_exprs):
    return VARCHAR, _const_column(_enum_values_of(arg_exprs[0])[0], VARCHAR), []


@register("enum_last")
def _bind_enum_last(arg_exprs):
    return VARCHAR, _const_column(_enum_values_of(arg_exprs[0])[-1], VARCHAR), []


@register("enum_code")
def _bind_enum_code(arg_exprs):
    code = {v: i for i, v in enumerate(_enum_values_of(arg_exprs[0]))}

    def impl(env, cols, node):
        c = cols[0]
        lut = torch.tensor([code.get(s, -1) for s in c.dict_values] or [-1],
                           dtype=torch.int64, device=c.data.device)
        d = lut[c.data.to(torch.int64).clamp(0, len(lut) - 1)]
        return Column(data=d, ltype=BIGINT, validity=c.validity)
    return BIGINT, impl, arg_exprs


@register("enum_range_boundary")
def _bind_enum_range_boundary(arg_exprs):
    vals = _enum_values_of(next((a for a in arg_exprs if getattr(a, "enum_type", None)),
                                arg_exprs[0]))
    if len(arg_exprs) != 2:
        raise BindError("enum_range_boundary() takes two ENUM values")
    lo = arg_exprs[0].const_value() if arg_exprs[0].is_const() else None
    hi = arg_exprs[1].const_value() if arg_exprs[1].is_const() else None
    i = vals.index(lo) if lo is not None else 0
    j = vals.index(hi) if hi is not None else len(vals) - 1
    lt = list_of(VARCHAR)
    return lt, _const_column(tuple(vals[i:j + 1]), lt), []
