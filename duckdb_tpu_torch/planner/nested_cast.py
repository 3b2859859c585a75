"""VARCHAR → nested-type casts: parse '[1, 2]' / "{'a': 1}" literals.

Reference: the nested cast kernels in duckdb/src/function/cast/
(list_cast.cpp, struct_cast.cpp, string_cast.cpp VectorStringToList /
VectorStringToStruct). This engine's nested values are host tuples, so the
cast parses host-side and the result rides as a dict-encoded constant (or
a per-distinct LUT for columns).
"""

from __future__ import annotations

import datetime
import decimal as pydec

from duckdb_tpu_torch.types import LogicalType, TypeId


def _split_top(s: str, sep: str = ","):
    """Split on `sep` at nesting depth 0, respecting quotes."""
    parts, depth, buf, i, n = [], 0, [], 0, len(s)
    quote = None
    while i < n:
        ch = s[i]
        if quote is not None:
            if ch == quote:
                if i + 1 < n and s[i + 1] == quote:  # escaped quote
                    buf.append(ch)
                    i += 2
                    continue
                quote = None
            else:
                buf.append(ch)
            i += 1
            continue
        if ch in "'\"":
            quote = ch
        elif ch in "[{(":
            depth += 1
            buf.append(ch)
        elif ch in "]})":
            depth -= 1
            buf.append(ch)
        elif ch == sep and depth == 0:
            parts.append("".join(buf))
            buf = []
        else:
            buf.append(ch)
        i += 1
    parts.append("".join(buf))
    return parts


def _unquote(s: str) -> str:
    s = s.strip()
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
        return s[1:-1].replace(s[0] * 2, s[0])
    return s


def _is_quoted(s: str) -> bool:
    s = s.strip()
    return len(s) >= 2 and s[0] == s[-1] and s[0] in "'\""


def _cast_scalar(s: str, t: LogicalType, quoted: bool):
    raw = s.strip()
    if not quoted and raw.upper() in ("NULL", ""):
        return None
    v = _unquote(raw) if quoted else raw
    if t.id is TypeId.VARCHAR:
        return v
    if t.id is TypeId.BOOLEAN:
        if v.lower() in ("true", "t", "1"):
            return True
        if v.lower() in ("false", "f", "0"):
            return False
        raise ValueError(v)
    if t.is_integer:
        return int(float(v)) if "." in v or "e" in v.lower() else int(v)
    if t.is_float:
        return float(v)
    if t.id is TypeId.DECIMAL:
        return pydec.Decimal(v).quantize(pydec.Decimal(1).scaleb(-t.scale))
    if t.id is TypeId.DATE:
        return datetime.date.fromisoformat(v)
    if t.id is TypeId.TIMESTAMP:
        return datetime.datetime.fromisoformat(v)
    if t.id in (TypeId.LIST, TypeId.STRUCT, TypeId.MAP):
        return cast_str_to_nested(v, t)
    raise ValueError(f"cannot cast element to {t!r}")


def cast_str_to_nested(s: str, t: LogicalType):
    """Parse a string literal into the engine's host value for `t`
    (a tuple of element values; struct = tuple in field order)."""
    s = s.strip()
    if t.id in (TypeId.LIST, TypeId.ARRAY):
        if not (s.startswith("[") and s.endswith("]")):
            raise ValueError(s)
        inner = s[1:-1].strip()
        if not inner:
            out = ()
        else:
            ct = t.child or LogicalType(TypeId.VARCHAR)
            out = tuple(_cast_scalar(p, ct, _is_quoted(p))
                        for p in _split_top(inner))
        if t.id is TypeId.ARRAY and len(out) != t.width:
            raise ValueError(f"array length {len(out)} != {t.width}")
        return out
    if t.id in (TypeId.STRUCT, TypeId.MAP):
        if not (s.startswith("{") and s.endswith("}")):
            raise ValueError(s)
        inner = s[1:-1].strip()
        pairs = {}
        order = []
        if inner:
            for p in _split_top(inner):
                k, sep, v = p.partition(":")
                if not sep:
                    raise ValueError(p)
                key = _unquote(k)
                pairs[key.lower()] = v
                order.append(key)
        if t.id is TypeId.MAP:
            kt = (t.fields[0][1] if t.fields else
                  LogicalType(TypeId.VARCHAR))
            vt = t.child or LogicalType(TypeId.VARCHAR)
            return tuple(
                (_cast_scalar(k, kt, True),
                 _cast_scalar(pairs[k.lower()], vt,
                              _is_quoted(pairs[k.lower()])))
                for k in order)
        out = []
        for fname, ftype in (t.fields or ()):
            if fname.lower() not in pairs:
                out.append(None)
            else:
                raw = pairs[fname.lower()]
                out.append(_cast_scalar(raw, ftype, _is_quoted(raw)))
        unknown = set(pairs) - {n.lower() for n, _ in (t.fields or ())}
        if unknown:
            raise ValueError(f"unknown struct fields {sorted(unknown)}")
        return tuple(out)
    raise ValueError(f"not a nested type: {t!r}")
