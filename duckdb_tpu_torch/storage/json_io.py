"""JSON files and the scalar JSON functions.

The JAX package's duckdb_tpu/storage/json_io.py (DuckDB's json extension,
extension/json/). `read_json_file` reads an array document or
newline-delimited JSON with the JAX package's typing: a key whose values
are all booleans is BOOLEAN, all integers BIGINT, all numbers DOUBLE, and
anything else VARCHAR, a nested value as its JSON text (DuckDB gives
STRUCT and LIST there; ROADMAP Facts). A JSON
value is VARCHAR text in a dictionary, so a function of one JSON column
runs once per distinct document on the host and reaches the rows as one
gather of codes on the column's device, its lookup table cached per
dictionary and function (functions.dict_transform and friends), so that
warm runs of a plan read it. A function of several columns
(json_object, json_array, json_merge_patch, json_contains, a path that
is a column) and to_json of a non-text value run once per distinct tuple
of values the live rows hold (functions_parity.distinct_rows), not per
row as the reference's `_host_cols` does.
"""

from __future__ import annotations

import datetime
import decimal as pydec
import json

import numpy as np

from duckdb_tpu_torch.blocks import Column
from duckdb_tpu_torch.blocks.nested import obj_array
from duckdb_tpu_torch.ops import strings as dstr
from duckdb_tpu_torch.planner.bound import BindError, _and_validity
from duckdb_tpu_torch.planner.functions import (
    REGISTRY,
    _null_column,
    dict_predicate,
    dict_transform,
)
from duckdb_tpu_torch.planner.functions_parity import per_distinct_rows
from duckdb_tpu_torch.types import (BIGINT, BOOLEAN, DOUBLE, VARCHAR, LogicalType, TypeId,
                                    list_of)


# -- JSON files -----------------------------------------------------------------
def _infer_type(values) -> LogicalType:
    vals = [v for v in values if v is not None]
    if not vals:
        return VARCHAR
    if all(isinstance(v, bool) for v in vals):
        return BOOLEAN
    if all(isinstance(v, int) and not isinstance(v, bool) for v in vals):
        return BIGINT
    if all(isinstance(v, (int, float)) and not isinstance(v, bool) for v in vals):
        return DOUBLE
    return VARCHAR


def read_json_file(path: str):
    """→ (schema [(name, type)], {name: (values, validity|None, dictionary|None)},
    rows) of an array document or of newline-delimited JSON."""
    with open(path) as f:
        text = f.read().strip()
    if text.startswith("["):
        docs = json.loads(text)
    else:
        docs = [json.loads(line) for line in text.splitlines() if line.strip()]
    keys = {}
    for d in docs:
        for k in d:
            keys.setdefault(k, None)
    schema, cols = [], {}
    for k in keys:
        raw = [d.get(k) for d in docs]
        t = _infer_type(raw)
        validity = np.array([v is not None for v in raw], dtype=bool)
        valid = None if validity.all() else validity
        if t.id is TypeId.VARCHAR:
            strs = np.array(["" if v is None else v if isinstance(v, str)
                             else json.dumps(v, separators=(",", ":")) for v in raw], dtype=str)
            uniq, codes = np.unique(strs, return_inverse=True)
            cols[k] = (codes.reshape(-1).astype(np.int32), valid, uniq.astype(object))
        elif t.id is TypeId.BOOLEAN:
            cols[k] = (np.array([bool(v) for v in raw], dtype=bool), valid, None)
        elif t.id is TypeId.BIGINT:
            cols[k] = (np.array([0 if v is None else v for v in raw], dtype=np.int64), valid,
                       None)
        else:
            cols[k] = (np.array([0.0 if v is None else float(v) for v in raw],
                                dtype=np.float64), valid, None)
        schema.append((k, t))
    return schema, cols, len(docs)


# -- path evaluation ----------------------------------------------------------
class _Missing:
    """A path that is absent (JSON null is a present value)."""


MISSING = _Missing()


def _path_parts(path: str):
    """'$.a.b[0]' / '$[#-1]' (yyjson's last-element syntax), '/a/0' (a JSON
    pointer) or a bare key → its steps."""
    if path.startswith("$"):
        parts, buf, i = [], "", 1
        while i < len(path):
            ch = path[i]
            if ch == ".":
                if buf:
                    parts.append(buf)
                    buf = ""
            elif ch == "[":
                if buf:
                    parts.append(buf)
                    buf = ""
                j = path.index("]", i)
                tok = path[i + 1:j]
                parts.append(("#", int(tok[1:]) if tok[1:] else 0) if tok.startswith("#")
                             else int(tok))
                i = j
            else:
                buf += ch
            i += 1
        if buf:
            parts.append(buf)
        return parts
    if path.startswith("/"):
        return [int(p) if p.lstrip("-").isdigit() else p for p in path.split("/") if p]
    return [path]


def json_path_get(doc: str, path: str):
    """The value at `path` in the document → a Python value, None for JSON
    null, or MISSING when the path is absent (DuckDB's json_extract.cpp)."""
    try:
        v = json.loads(doc)
    except (ValueError, TypeError):
        return MISSING
    for p in _path_parts(path):
        try:
            if isinstance(p, tuple):  # ('#', offset): from the length
                if not isinstance(v, list):
                    return MISSING
                idx = len(v) + p[1]
                if not 0 <= idx < len(v):
                    return MISSING
                v = v[idx]
            elif isinstance(p, int) or isinstance(v, dict):
                v = v[p]
            else:
                return MISSING
        except (KeyError, IndexError, TypeError):
            return MISSING
    return v


def dumps(v) -> str:
    return json.dumps(v, separators=(",", ":"))


def py_to_jsonable(v, lt: LogicalType = None):
    """A Python value of the engine → a value json can write: DECIMAL as a
    number, dates and times as text, a STRUCT as an object (its field
    names from `lt`), a LIST as an array."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, pydec.Decimal):
        f = float(v)
        return int(v) if f.is_integer() else f
    if isinstance(v, (datetime.date, datetime.datetime, datetime.time)):
        return str(v)
    if isinstance(v, tuple):
        if lt is not None and lt.id is TypeId.STRUCT and lt.fields:
            return {fn: py_to_jsonable(x, ft) for (fn, ft), x in zip(lt.fields, v)}
        child = lt.child if lt is not None else None
        return [py_to_jsonable(x, child) for x in v]
    return str(v)


def _json_type(v) -> str:
    # yyjson's scalar types: a non-negative integer is UBIGINT
    if isinstance(v, bool):
        return "BOOLEAN"
    if isinstance(v, int):
        return "UBIGINT" if v >= 0 else "BIGINT"
    if isinstance(v, float):
        return "DOUBLE"
    if isinstance(v, str):
        return "VARCHAR"
    return "NULL"


def _structure(v):
    if isinstance(v, dict):
        return {k: _structure(x) for k, x in v.items()}
    if isinstance(v, list):
        inner = [_structure(x) for x in v]
        first = next((x for x in inner if x != "NULL"), "NULL")
        # NULL unifies with any element type (json_structure.cpp)
        return [first] if all(x in (first, "NULL") for x in inner) else inner
    return _json_type(v)


def merge_patch(*docs):
    """RFC 7386 merge patch, folded left over the documents (DuckDB's
    json_merge_patch.cpp); a NULL patch gives NULL."""
    if len(docs) > 2:
        acc = docs[0]
        for d in docs[1:]:
            acc = merge_patch(acc, d)
        return acc
    a, b = docs
    if b is None:
        return None
    if a is None:
        a = "null"

    def patch(t, p):
        if not isinstance(p, dict):
            return p
        t = t if isinstance(t, dict) else {}
        out = {k: v for k, v in t.items() if k not in p}
        for k, v in p.items():
            if v is not None:
                out[k] = patch(t.get(k), v)
        return out
    try:
        return dumps(patch(json.loads(a), json.loads(b)))
    except (ValueError, TypeError):
        return None


def json_contains(hay, needle):
    """Structural containment anywhere in the document (yyjson: an object
    on a subset of keys, an array on a subset of elements)."""
    if hay is None or needle is None:
        return None
    try:
        h, n = json.loads(hay), json.loads(needle)
    except (ValueError, TypeError):
        return None

    def at(hv, nv):
        if isinstance(hv, dict) and isinstance(nv, dict):
            return all(k in hv and at(hv[k], nv[k]) for k in nv)
        if isinstance(hv, list):
            if isinstance(nv, list):
                return all(any(at(he, ne) for he in hv) for ne in nv)
            return any(at(he, nv) for he in hv)
        return hv == nv

    def walk(v):
        if at(v, n):
            return True
        if isinstance(v, dict):
            return any(walk(x) for x in v.values())
        return isinstance(v, list) and any(walk(x) for x in v)
    return walk(h)


# -- binders --------------------------------------------------------------------
def _doc_lut(col: Column, fn, key: str, ltype: LogicalType) -> Column:
    """fn per distinct document (None → NULL) → a column gathered by code,
    the lookup table cached per dictionary and function."""
    if col.dict_values is None:
        return _null_column(col, ltype, np.array([""], dtype=object)
                            if ltype.id is TypeId.VARCHAR else obj_array([()])
                            if ltype.id is TypeId.LIST else None)
    dev = col.data.device

    def compute():
        from duckdb_tpu_torch.blocks.nested import lut_column

        return lut_column([fn(str(s)) for s in col.dict_values] or [None], ltype, dev)

    lut = dstr.cached_lut(col.dict_values, ("json", key, str(dev)), compute)
    idx = col.data.long().clamp(0, lut.data.shape[0] - 1)
    valid = None if lut.validity is None else lut.validity[idx]
    return Column(data=lut.data[idx], ltype=ltype, validity=_and_validity(valid, col.validity),
                  dict_values=lut.dict_values)


def _path_arg(e):
    """A constant path: its text, an integer index as '$[i]'; a constant
    list of paths as a tuple of them; None when the path is a column."""
    if not e.is_const():
        return None
    v = e.const_value()
    if isinstance(v, (int, np.integer)):
        return f"$[{int(v)}]"
    return v


def _path_binder(name, f2, ret: LogicalType):
    """fn(doc, path) with a constant path (once per distinct document), a
    constant list of paths (a LIST per document) or a path column (once
    per distinct (document, path) pair)."""
    def binder(arg_exprs):
        if len(arg_exprs) != 2:
            raise BindError(f"Binder Error: {name} takes 2 arguments")
        if arg_exprs[1].ltype.id is TypeId.LIST:
            from duckdb_tpu_torch.planner.functions_nested import _const_py

            paths = tuple(str(p) for p in _const_py(arg_exprs[1])[0])
            lt = list_of(ret)

            def impl_list(env, cols, node):
                return _doc_lut(cols[0], lambda s: tuple(f2(s, p) for p in paths),
                                f"{name}:{paths!r}", lt)
            return lt, impl_list, arg_exprs[:1]
        path = _path_arg(arg_exprs[1])
        if path is None:
            def impl_rows(env, cols, node):
                return per_distinct_rows(
                    cols, env, lambda d, p: None if d is None or p is None
                    else f2(d, p if isinstance(p, str) else f"$[{p}]"), ret)
            return ret, impl_rows, arg_exprs

        def impl(env, cols, node):
            return _doc_lut(cols[0], lambda s: f2(s, str(path)), f"{name}:{path}", ret)
        return ret, impl, arg_exprs[:1]

    REGISTRY[name] = binder


def _extract(as_text: bool):
    def f2(s, p):
        v = json_path_get(s, p)
        if v is MISSING:
            return None
        if v is None:
            return None if as_text else "null"
        if as_text and isinstance(v, str):
            return v
        return dumps(v)
    return f2


def _value(s, p):
    """json_value: a scalar's JSON text, NULL for an object or an array."""
    v = json_path_get(s, p)
    if v is MISSING or v is None or isinstance(v, (dict, list)):
        return None
    return dumps(v)


# json_extract gives JSON text (a string stays quoted); the _string forms unquote
_path_binder("json_extract", _extract(False), VARCHAR)
_path_binder("json_extract_path", _extract(False), VARCHAR)
_path_binder("json_extract_string", _extract(True), VARCHAR)
_path_binder("json_extract_path_text", _extract(True), VARCHAR)
_path_binder("json_value", _value, VARCHAR)
_path_binder("json_exists", lambda s, p: json_path_get(s, p) is not MISSING, BOOLEAN)


def _bind_to_json(arg_exprs):
    """to_json / json_quote: any value → JSON text, once per distinct value."""
    lt = arg_exprs[0].ltype

    def impl(env, cols, node):
        return per_distinct_rows(cols, env, lambda v: dumps(py_to_jsonable(v, lt)), VARCHAR)
    return VARCHAR, impl, arg_exprs


for _n in ("to_json", "json_quote", "row_to_json", "array_to_json"):
    REGISTRY[_n] = _bind_to_json


def _rows_fn(name, fn, ret=VARCHAR):
    """fn over several columns, once per distinct tuple of their values."""
    def binder(arg_exprs):
        types = [a.ltype for a in arg_exprs]

        def impl(env, cols, node):
            return per_distinct_rows(cols, env, lambda *vs: fn(types, *vs), ret,
                                     valid_in=False)
        return ret, impl, arg_exprs

    REGISTRY[name] = binder


def _json_object(types, *kv):
    if len(kv) % 2:
        raise ValueError("Invalid Input Error: json_object() requires an even number of "
                         "arguments")
    obj = {}
    for i in range(0, len(kv), 2):
        if kv[i] is None:
            raise ValueError("Invalid Input Error: json_object() keys can not be NULL")
        obj[str(kv[i])] = py_to_jsonable(kv[i + 1], types[i + 1])
    return dumps(obj)


_rows_fn("json_object", _json_object)
_rows_fn("json_array", lambda types, *vs: dumps([py_to_jsonable(v, t)
                                                 for v, t in zip(vs, types)]))
_rows_fn("json_merge_patch", lambda types, *docs: merge_patch(*docs))
_rows_fn("json_contains", lambda types, h, n: json_contains(h, n), BOOLEAN)


def _doc_text_fn(name, fn):
    """A JSON document → text, once per distinct document."""
    def binder(arg_exprs):
        def impl(env, cols, node):
            return dict_transform(cols[0], fn, device_key=f"json:{name}", env=env)
        return VARCHAR, impl, arg_exprs

    REGISTRY[name] = binder


def _pretty(s):
    try:
        return json.dumps(json.loads(s), indent=4)
    except (ValueError, TypeError):
        return s


def _strip_nulls(v):
    if isinstance(v, dict):
        return {k: _strip_nulls(x) for k, x in v.items() if x is not None}
    if isinstance(v, list):
        return [_strip_nulls(x) for x in v]
    return v


def _strip_nulls_text(s):
    try:
        return dumps(_strip_nulls(json.loads(s)))
    except (ValueError, TypeError):
        return s


_doc_text_fn("json", lambda s: dumps(json.loads(s)))  # parse and minify; raises on bad JSON
_doc_text_fn("json_pretty", _pretty)
_doc_text_fn("json_strip_nulls", _strip_nulls_text)
_doc_text_fn("json_structure", lambda s: dumps(_structure(json.loads(s))))


def _valid_json(s) -> bool:
    try:
        json.loads(s)
        return True
    except (ValueError, TypeError):
        return False


REGISTRY["json_valid"] = lambda arg_exprs: (
    BOOLEAN, lambda env, cols, node: dict_predicate(cols[0], _valid_json,
                                                    device_key="json_valid"), arg_exprs)


def _doc_binder(name, fn, ret: LogicalType):
    """fn(the value at the optional constant path, or the whole document)."""
    def binder(arg_exprs):
        path = str(arg_exprs[1].const_value()) if len(arg_exprs) > 1 else None

        def get(s):
            if path is not None:
                return json_path_get(s, path)
            try:
                return json.loads(s)
            except (ValueError, TypeError):
                return MISSING

        def impl(env, cols, node):
            return _doc_lut(cols[0], lambda s: fn(get(s)), f"{name}:{path}", ret)
        return ret, impl, arg_exprs[:1]

    REGISTRY[name] = binder


def _keys(v):
    if v is MISSING:
        return None
    return tuple(v.keys()) if isinstance(v, dict) else ()  # a non-object has no keys


def _type_name(v):
    if v is MISSING:
        return None
    if isinstance(v, dict):
        return "OBJECT"
    if isinstance(v, list):
        return "ARRAY"
    return _json_type(v)


_doc_binder("json_array_length",
            lambda v: None if v is MISSING else len(v) if isinstance(v, list) else 0, BIGINT)
_doc_binder("json_keys", _keys, list_of(VARCHAR))
_doc_binder("json_type", _type_name, VARCHAR)
_doc_binder("json_typeof", _type_name, VARCHAR)
