"""Bind-time constant folding.

The reference folds constants via ExpressionRewriter's ConstantFoldingRule
(duckdb/src/optimizer/rule/constant_folding.cpp). Here folding is
load-bearing, not just an optimization: DATE ± INTERVAL and decimal literal
arithmetic are computed host-side at bind time so the device only ever sees
resolved physical constants (days / scaled ints).

Physical constant encodings: DECIMAL → scaled int, DATE → days since epoch,
TIMESTAMP → micros, INTERVAL → (months, days, micros), VARCHAR → str.
"""

from __future__ import annotations

import datetime

from duckdb_tpu_torch.types import TypeId


def _add_months(days: int, months: int) -> int:
    d = datetime.date(1970, 1, 1) + datetime.timedelta(days=days)
    y = d.year + (d.month - 1 + months) // 12
    m = (d.month - 1 + months) % 12 + 1
    # clamp to last day of month (duckdb AddOperator date+interval semantics,
    # duckdb/src/common/operator/add.cpp)
    last = [31, 29 if y % 4 == 0 and (y % 100 != 0 or y % 400 == 0) else 28,
            31, 30, 31, 30, 31, 31, 30, 31, 30, 31][m - 1]
    nd = datetime.date(y, m, min(d.day, last))
    return (nd - datetime.date(1970, 1, 1)).days


def fold_arithmetic(node) -> object:
    lt, rt = node.left.ltype, node.right.ltype
    lv, rv = node.left.const_value(), node.right.const_value()
    if lv is None or rv is None:
        return None
    t = node.ltype
    # date/timestamp ± interval
    if TypeId.INTERVAL in (lt.id, rt.id):
        if lt.id is TypeId.INTERVAL:
            iv, other, ot = lv, rv, rt
        else:
            iv, other, ot = rv, lv, lt
        months, days, micros = iv
        sign = 1 if node.op == "+" else -1
        if ot.id is TypeId.DATE:
            d = _add_months(other, sign * months) + sign * days
            if micros:
                raise ValueError("date ± sub-day interval → timestamp (unsupported fold)")
            return d
        if ot.id is TypeId.TIMESTAMP:
            day_part = _add_months(other // 86400_000_000, sign * months)
            return (day_part + sign * days) * 86400_000_000 + other % 86400_000_000 + sign * micros
        raise ValueError(f"cannot fold interval with {ot}")
    if t.id is TypeId.DECIMAL:
        sl = node.left.ltype.scale if lt.id is TypeId.DECIMAL else 0
        sr = node.right.ltype.scale if rt.id is TypeId.DECIMAL else 0
        if node.op in ("+", "-"):
            s = t.scale
            x = lv * 10 ** (s - sl)
            y = rv * 10 ** (s - sr)
            return x + y if node.op == "+" else x - y
        if node.op == "*":
            return lv * rv
        if node.op == "%":
            s = t.scale
            return _trunc_divmod(lv * 10 ** (s - sl), rv * 10 ** (s - sr), "%")
        raise ValueError("decimal division folds to double")
    if t.id in (TypeId.DOUBLE, TypeId.FLOAT):
        import math

        x = lv / 10**lt.scale if lt.id is TypeId.DECIMAL else float(lv)
        y = rv / 10**rt.scale if rt.id is TypeId.DECIMAL else float(rv)
        if node.op == "/":
            # IEEE division: x/0 → ±inf, 0/0 → nan (the reference's double
            # division, src/common/operator/numeric_binary_operators.hpp —
            # never a host ZeroDivisionError)
            if y == 0.0:
                return math.nan if x == 0.0 else math.copysign(math.inf, x)
            return x / y
        if node.op == "%":
            return math.nan if y == 0.0 else math.fmod(x, y)
        if node.op == "//":
            # truncated, as DuckDB's (and torch.div's rounding_mode="trunc")
            if y == 0.0:
                return math.nan
            q = x / y
            return float(math.trunc(q)) if math.isfinite(q) else q
        return {"+": x + y, "-": x - y, "*": x * y}[node.op]
    if node.op in ("%", "//") and rv == 0:
        return None  # integer x % 0 / x // 0 → NULL (reference semantics)
    if node.op == "+":
        out = lv + rv
    elif node.op == "-":
        out = lv - rv
    elif node.op == "*":
        out = lv * rv
    elif node.op in ("%", "//"):
        out = _trunc_divmod(lv, rv, node.op)
    else:
        raise ValueError(f"cannot fold {node.op}")
    if t.is_integer:
        import numpy as np

        from duckdb_tpu_torch.errors import OutOfRangeException, int_type_name

        lo, hi = _int_range(t)
        if not (lo <= out <= hi):
            opname = {"+": "addition", "-": "subtraction",
                      "*": "multiplication", "%": "modulo",
                      "//": "division"}[node.op]
            name = "HUGEINT" if t.id is TypeId.HUGEINT else int_type_name(t.np_dtype)
            raise OutOfRangeException(
                f"Overflow in {opname} of {name} ({lv} {node.op} {rv})!")
    return out


def _int_range(t) -> tuple:
    """The values an integer type holds: HUGEINT's are int128's."""
    if t.id is TypeId.HUGEINT:
        return -(1 << 127), (1 << 127) - 1
    import numpy as np

    info = np.iinfo(t.np_dtype)
    return int(info.min), int(info.max)


def _trunc_divmod(x: int, y: int, op: str):
    """x % y or x // y truncated toward zero, as DuckDB's integer operators
    (-7 % 3 = -1, -7 // 2 = -3); None when y is 0."""
    if y == 0:
        return None
    q = abs(x) // abs(y)
    if (x < 0) != (y < 0):
        q = -q
    return q if op == "//" else x - q * y


def fold_cast(node) -> object:
    v = node.child.const_value()
    if v is None:
        return None
    src, dst = node.child.ltype, node.ltype
    if src == dst:
        return v
    if src.id is TypeId.INTERVAL and dst.id is TypeId.VARCHAR:
        from duckdb_tpu_torch.planner.bound import format_varchar

        return format_varchar(v, src)  # DuckDB's text, months and all
    if dst.id is TypeId.DECIMAL:
        if src.id is TypeId.DECIMAL:
            shift = dst.scale - src.scale
            if shift >= 0:
                out = v * 10**shift
            else:  # round half away from zero, as duckdb's decimal casts do
                q, r = divmod(abs(v), 10**-shift)
                out = q + (1 if 2 * r >= 10**-shift else 0)
                out = out if v >= 0 else -out
        elif src.is_integer or src.id is TypeId.BOOLEAN:
            out = int(v) * 10**dst.scale
        else:
            out = round(float(v) * 10**dst.scale)
        if abs(out) >= 10 ** dst.width:
            if node.try_cast:
                return None
            from duckdb_tpu_torch.errors import ConversionException

            raise ConversionException(
                f"value {v} is out of range for {dst!r}")
        return out
    if src.id is TypeId.VARCHAR and dst.is_float:
        from duckdb_tpu_torch.errors import ConversionException
        from duckdb_tpu_torch.planner.bound import parse_float_text

        try:
            return parse_float_text(str(v), dst)
        except ValueError:
            if node.try_cast:
                return None
            raise ConversionException(
                f"Could not convert string '{v}' to {dst.id.name}") from None
    if src.id is TypeId.VARCHAR and dst.id is TypeId.TIME:
        from duckdb_tpu_torch.planner.binder import _parse_time_micros

        return _parse_time_micros(str(v).strip())
    if dst.id is TypeId.DOUBLE:
        return v / 10**src.scale if src.id is TypeId.DECIMAL else float(v)
    if dst.is_integer:
        if src.id is TypeId.DECIMAL:
            q, r = divmod(abs(v), 10**src.scale)
            out = q + (1 if 2 * r >= 10**src.scale else 0)
            out = out if v >= 0 else -out
        else:
            out = int(v)
        import numpy as np

        from duckdb_tpu_torch.errors import ConversionException, int_type_name

        lo, hi = _int_range(dst)
        if not (lo <= out <= hi):
            if node.try_cast:
                return None
            src_name = "DOUBLE" if src.is_float else src.id.name
            vs = f"{v:g}" if src.is_float else str(v)
            raise ConversionException(
                f"Type {src_name} with value {vs} can't be cast because "
                f"the value is out of range for the destination type "
                f"{int_type_name(dst.np_dtype)}")
        return out
    if src.id is TypeId.VARCHAR and dst.id is TypeId.BIT:
        sv = str(v)
        if sv and all(ch in "01" for ch in sv):
            return sv
        if node.try_cast:
            return None
        from duckdb_tpu_torch.errors import ConversionException

        raise ConversionException(f"Could not convert string '{sv}' to BIT")
    if src.id is TypeId.VARCHAR and dst.id is TypeId.TIMESTAMPTZ:
        from duckdb_tpu_torch.planner.binder import _parse_timestamptz

        try:
            return _parse_timestamptz(str(v))
        except ValueError:
            if node.try_cast:
                return None
            raise
    if src.id is TypeId.LIST and dst.id is TypeId.ARRAY:
        t = tuple(v)
        if len(t) != dst.width:
            if node.try_cast:
                return None
            from duckdb_tpu_torch.errors import ConversionException

            raise ConversionException(
                f"Cannot cast list of length {len(t)} to {dst!r}")
        return t
    if src.id is TypeId.ARRAY and dst.id is TypeId.LIST:
        return tuple(v)
    if src.id is TypeId.VARCHAR and dst.id in (TypeId.LIST, TypeId.STRUCT,
                                               TypeId.MAP, TypeId.ARRAY):
        from duckdb_tpu_torch.planner.nested_cast import cast_str_to_nested

        try:
            return cast_str_to_nested(str(v), dst)
        except (ValueError, ArithmeticError):
            if node.try_cast:
                return None
            from duckdb_tpu_torch.errors import ConversionException

            raise ConversionException(
                f"Could not convert string '{v}' to {dst!r}") from None
    if src.id in (TypeId.TIMESTAMP, TypeId.TIMESTAMPTZ) \
            and dst.id in (TypeId.TIMESTAMP, TypeId.TIMESTAMPTZ):
        return int(v)
    if dst.id is TypeId.TIMESTAMP and src.id is TypeId.DATE:
        return v * 86400_000_000
    if dst.id is TypeId.DATE and src.id is TypeId.TIMESTAMP:
        return v // 86400_000_000
    if src.id is TypeId.VARCHAR and dst.id is TypeId.DATE:
        d = datetime.date.fromisoformat(str(v).strip())
        return (d - datetime.date(1970, 1, 1)).days
    if src.id is TypeId.VARCHAR and dst.id is TypeId.TIMESTAMP:
        dt = datetime.datetime.fromisoformat(str(v).strip())
        return int((dt - datetime.datetime(1970, 1, 1)).total_seconds() * 1_000_000)
    raise ValueError(f"cannot fold cast {src} → {dst}")
