"""Bound (typed, resolved) expressions and their device evaluation.

The reference splits ParsedExpression → BoundExpression → ExpressionExecutor
(duckdb/src/planner/expression/, src/execution/expression_executor.cpp).
As in the JAX package, bound nodes carry their own vectorized evaluation:
``eval(env)`` returns a Column of torch tensors over the padded block, with
SQL three-valued NULL semantics via validity planes. Evaluation is eager:
each node is a handful of torch ops on the env's device.

VARCHAR columns are dictionary codes (sorted dict). String predicates are
evaluated once per distinct value and become a device LUT gather: on the
host dictionary, or for LIKE over a near-unique dictionary on the device
(ops/strings). Nested values (LIST, STRUCT, MAP, ARRAY, UNION, BIT) are
dictionary codes too, in first-seen order (blocks/nested.py): comparisons
over them compare DuckDB's ranks, and their casts run once per distinct
value (`_coerce_nested`).

DECIMAL is scaled int64; arithmetic follows duckdb's bind rules
(duckdb/src/function/scalar/operator/arithmetic.cpp): add/sub rescale to
the max scale, mul adds scales, division binds to DOUBLE.
"""

from __future__ import annotations

import datetime
import decimal as pydec
import math
import re
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from duckdb_tpu_torch.blocks import Column
from duckdb_tpu_torch.blocks.nested import UNSORTED_DICT_IDS, merged_rank_luts
from duckdb_tpu_torch.errors import ConversionException, typed_value_error
from duckdb_tpu_torch.ops import int128 as I128
from duckdb_tpu_torch.types import (
    BOOLEAN,
    DOUBLE,
    HUGEINT,
    SQLNULL,
    VARCHAR,
    LogicalType,
    TypeId,
    nested_widens,
    null_fits,
)


class BindError(ValueError):
    pass


class CastConversionError(BindError, ConversionException):
    """A value a cast cannot convert: DuckDB's ConversionException, and a
    BindError, the JAX package's class for it."""


def not_ported(what: str) -> BindError:
    """The error for SQL the JAX package supports but this port does not yet."""
    return BindError(f"Binder Error: {what} is not yet ported to duckdb_tpu_torch")


@dataclass
class EvalEnv:
    """Evaluation environment: bound column key → Column, over one padded block."""

    cols: dict
    plen: int
    live: torch.Tensor  # (P,) bool — rows alive (not padding / not filtered out)


def _and_validity(a: Optional[torch.Tensor], b: Optional[torch.Tensor]):
    if a is None:
        return b
    if b is None:
        return a
    return a & b


def bcast(x: torch.Tensor, plen: int) -> torch.Tensor:
    """View a scalar (0-d or (1,)) or block-length tensor at block length."""
    return x.expand(plen)


def _const(env, value, dtype: torch.dtype) -> torch.Tensor:
    """A constant at block length on the env's device (a stride-0 view)."""
    return torch.full((), value, dtype=dtype, device=env.live.device).expand(env.plen)


def _valid_or_ones(c: Column, plen: int, device) -> torch.Tensor:
    if c.validity is None:
        return torch.ones(plen, dtype=torch.bool, device=device)
    return bcast(c.validity, plen)


# ---------------------------------------------------------------------------
# date math on device (days since 1970-01-01 → civil fields)
# Branchless civil-from-days (Howard Hinnant's algorithm); the divisions
# floor, as the algorithm needs for days before 1970.
def _fdiv(x: torch.Tensor, k: int) -> torch.Tensor:
    return torch.div(x, k, rounding_mode="floor")


def civil_from_days(days: torch.Tensor):
    z = days.to(torch.int64) + 719468
    era = _fdiv(torch.where(z >= 0, z, z - 146096), 146097)
    doe = z - era * 146097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524) - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = torch.where(m <= 2, y + 1, y)
    return y, m, d


def days_from_civil(y: int, m: int, d: int) -> int:
    y -= m <= 2
    era = (y if y >= 0 else y - 399) // 400
    yoe = y - era * 400
    doy = (153 * (m + (-3 if m > 2 else 9)) + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


# ---------------------------------------------------------------------------
# bound expression nodes
class BoundExpr:
    ltype: LogicalType

    def eval(self, env: EvalEnv) -> Column:
        raise NotImplementedError

    def is_const(self) -> bool:
        return False

    def const_value(self):
        """Python-level value for constant subtrees (folded at bind time).

        DECIMAL → scaled int, DATE → days, VARCHAR → str, NULL → None.
        """
        raise BindError("not a constant expression")

    def children(self) -> List["BoundExpr"]:
        return []


@dataclass
class BoundColumnRef(BoundExpr):
    key: str
    ltype: LogicalType

    def eval(self, env: EvalEnv) -> Column:
        return env.cols[self.key]


@dataclass
class BoundLiteral(BoundExpr):
    value: object  # physical value: scaled int for DECIMAL, days for DATE, str for VARCHAR
    ltype: LogicalType

    def eval(self, env: EvalEnv) -> Column:
        if self.value is None:
            # a typed NULL: a dictionary type still carries a (one-entry)
            # dictionary, as _coerce_to's NULL of that type does
            return _coerce_to(Column(data=_const(env, 0, torch.int32), ltype=SQLNULL,
                                     validity=_const(env, False, torch.bool)), self.ltype, env)
        if self.ltype.id is TypeId.VARCHAR:
            # constant string → single-entry dictionary, code 0
            return Column(data=_const(env, 0, torch.int32), ltype=VARCHAR,
                          dict_values=np.array([self.value], dtype=object))
        if self.ltype.id is TypeId.INTERVAL and isinstance(self.value, (tuple, list)):
            # (months, days, micros) → int64 micros; months use the
            # reference's 30-day comparison convention
            # (duckdb/src/common/types/interval.cpp Interval::GetMicro)
            mo, dd, us = self.value
            return Column(data=_const(env, (mo * 30 + dd) * 86_400_000_000 + us,
                                      torch.int64), ltype=self.ltype)
        if self.ltype.id is TypeId.HUGEINT and not -(2**63) <= int(self.value) < 2**63:
            # oversized literal: (lo, hi) wide planes (int128 carrier)
            v = int(self.value)
            lo = int(np.uint64(v & ((1 << 64) - 1)).astype(np.int64))
            return Column(data=_const(env, lo, torch.int64),
                          data_hi=_const(env, v >> 64, torch.int64),
                          ltype=self.ltype)
        if self.ltype.id in (TypeId.LIST, TypeId.STRUCT, TypeId.MAP,
                             TypeId.ARRAY, TypeId.UNION, TypeId.BIT):
            # a nested constant → a one-entry dictionary, code 0
            d = np.empty(1, dtype=object)
            d[0] = self.value if self.ltype.id is TypeId.BIT else tuple(self.value)
            return Column(data=_const(env, 0, torch.int32), ltype=self.ltype, dict_values=d)
        dtype = self.ltype.torch_dtype
        if isinstance(self.value, (int, float, np.integer, np.floating)) \
                and not isinstance(self.value, bool) and math.isfinite(self.value) \
                and not dtype.is_floating_point and dtype is not torch.bool:
            info = torch.iinfo(dtype)  # a folded value past its carrier
            if not info.min <= int(self.value) <= info.max:
                from duckdb_tpu_torch.errors import OutOfRangeException

                raise OutOfRangeException(f"the value {self.value} is out of range for "
                                          f"{self.ltype!r}")
        return Column(data=_const(env, self.value, dtype), ltype=self.ltype)

    def is_const(self):
        return True

    def const_value(self):
        return self.value


_CMP_OPS = {"=", "==", "<>", "!=", "<", "<=", ">", ">="}


def _varchar_rank_luts(a: Column, b: Column, device):
    """Device LUTs mapping each side's codes to ranks in the merged dictionary."""
    if a.dict_values is b.dict_values:
        lut = torch.arange(len(a.dict_values), dtype=torch.int32, device=device)
        return lut, lut
    merged = np.union1d(a.dict_values, b.dict_values)
    ra = np.searchsorted(merged, a.dict_values).astype(np.int32)
    rb = np.searchsorted(merged, b.dict_values).astype(np.int32)
    return torch.from_numpy(ra).to(device), torch.from_numpy(rb).to(device)


def _cmp(op: str, x, y):
    if op in ("=", "=="):
        return x == y
    if op in ("<>", "!="):
        return x != y
    if op == "<":
        return x < y
    if op == "<=":
        return x <= y
    if op == ">":
        return x > y
    return x >= y


def _from_lt_eq(op: str, lt, eq):
    """Comparison result from the (less-than, equal) pair."""
    if op in ("=", "=="):
        return eq
    if op in ("<>", "!="):
        return ~eq
    if op == "<":
        return lt
    if op == "<=":
        return lt | eq
    if op == ">":
        return ~(lt | eq)
    return ~lt  # >=


@dataclass
class BoundComparison(BoundExpr):
    op: str
    left: BoundExpr
    right: BoundExpr
    ltype: LogicalType = BOOLEAN

    def children(self):
        return [self.left, self.right]

    def eval(self, env: EvalEnv) -> Column:
        lc = self.left.eval(env)
        rc = self.right.eval(env)
        if lc.ltype.id is TypeId.VARCHAR or rc.ltype.id is TypeId.VARCHAR:
            la, lb = _varchar_rank_luts(lc, rc, env.live.device)
            data = _cmp(self.op, la[lc.data.long()], lb[rc.data.long()])
        elif lc.ltype.id in UNSORTED_DICT_IDS or rc.ltype.id in UNSORTED_DICT_IDS:
            # nested codes are in first-seen order: compare DuckDB's ranks
            la, lb = merged_rank_luts(lc, rc, env.live.device)
            data = _cmp(self.op, la[lc.data.long().clamp(0, la.shape[0] - 1)],
                        lb[rc.data.long().clamp(0, lb.shape[0] - 1)])
        elif (lc.data_hi is not None or rc.data_hi is not None) \
                and not (lc.ltype.is_float or rc.ltype.is_float):
            data = _wide_compare(self.op, lc, rc, env.plen)
        elif (TypeId.DECIMAL in (lc.ltype.id, rc.ltype.id)
              and not (lc.ltype.is_float or rc.ltype.is_float)
              and lc.ltype.scale != rc.ltype.scale):
            data = _decimal_compare(self.op, lc, rc)
        else:
            x, y = _common_numeric(lc, rc)
            data = _cmp(self.op, x, y)
        return Column(data=data, ltype=BOOLEAN,
                      validity=_and_validity(lc.validity, rc.validity))


def varchar_where(take, a: Column, b: Column, plen):
    """Elementwise select over two dictionary-coded columns (VARCHAR, or
    nested) with the dictionaries' union: sorted for VARCHAR, first-seen
    for nested values."""
    da, db = bcast(a.data, plen), bcast(b.data, plen)
    if a.dict_values is b.dict_values:
        return torch.where(take, da, db), a.dict_values
    device = da.device
    if a.ltype.id in UNSORTED_DICT_IDS:
        from duckdb_tpu_torch.blocks.nested import encode_objects

        codes, merged = encode_objects(list(a.dict_values) + list(b.dict_values))
        ra = torch.from_numpy(codes[:len(a.dict_values)]).to(device)
        rb = torch.from_numpy(codes[len(a.dict_values):]).to(device)
        return torch.where(take, ra[da.long().clamp(0, len(a.dict_values) - 1)],
                           rb[db.long().clamp(0, len(b.dict_values) - 1)]), merged
    merged = np.union1d(a.dict_values, b.dict_values).astype(object)
    ra = torch.from_numpy(np.searchsorted(merged, a.dict_values).astype(np.int32)).to(device)
    rb = torch.from_numpy(np.searchsorted(merged, b.dict_values).astype(np.int32)).to(device)
    data = torch.where(take,
                       ra[da.long().clamp(0, len(a.dict_values) - 1)],
                       rb[db.long().clamp(0, len(b.dict_values) - 1)])
    return data, merged


def _decimal_compare(op: str, lc: Column, rc: Column):
    """Exact mixed-scale decimal comparison without rescale overflow.

    x·10^d ⋛ y is decided via q = ⌊y/10^d⌋, r = y mod 10^d (both exact in
    int64): x>q ⇒ gt; x==q ⇒ (r==0 ? eq : lt-for-x).
    """
    sl = lc.ltype.scale if lc.ltype.id is TypeId.DECIMAL else 0
    sr = rc.ltype.scale if rc.ltype.id is TypeId.DECIMAL else 0
    x = lc.data.to(torch.int64)
    y = rc.data.to(torch.int64)
    flip = sl > sr
    if flip:
        x, y, sl, sr = y, x, sr, sl
    d = 10 ** (sr - sl)
    q = torch.div(y, d, rounding_mode="floor")
    r = y - q * d  # 0 <= r < d (floor semantics hold for negatives)
    lt = (x < q) | ((x == q) & (r > 0))
    eq = (x == q) & (r == 0)
    if flip:
        lt = ~(lt | eq)  # y·10^d < x ⇔ not (x<=y)
    return _from_lt_eq(op, lt, eq)


def _decimal_align(lc: Column, rc: Column):
    """Rescale two decimal/integer columns to a common scale (int64)."""
    sl = lc.ltype.scale if lc.ltype.id is TypeId.DECIMAL else 0
    sr = rc.ltype.scale if rc.ltype.id is TypeId.DECIMAL else 0
    s = max(sl, sr)
    x = lc.data.to(torch.int64) * (10 ** (s - sl))
    y = rc.data.to(torch.int64) * (10 ** (s - sr))
    return x, y, s


def _wide_compare(op: str, lc: Column, rc: Column, plen: int):
    """int128 comparison via (hi, lo) limbs: hi compares signed, lo
    unsigned (two's complement lexicographic)."""
    def limbs(c):
        lo = bcast(c.data, plen).to(torch.int64)
        hi = (bcast(c.data_hi, plen).to(torch.int64)
              if c.data_hi is not None else lo >> 63)
        return hi, lo ^ -(2**63)  # unsigned ordering key for the low limb

    ha, ua = limbs(lc)
    hb, ub = limbs(rc)
    eq = (ha == hb) & (ua == ub)
    lt = (ha < hb) | ((ha == hb) & (ua < ub))
    return _from_lt_eq(op, lt, eq)


def _common_numeric(lc: Column, rc: Column):
    """Coerce two non-varchar columns to comparable device tensors."""
    if lc.ltype.is_float or rc.ltype.is_float:
        return _to_double(lc), _to_double(rc)
    if TypeId.DECIMAL in (lc.ltype.id, rc.ltype.id):
        x, y, _ = _decimal_align(lc, rc)
        return x, y
    x = lc.data.to(torch.int64)
    y = rc.data.to(torch.int64)
    # DATE (days) vs TIMESTAMP (micros): promote the DATE side, matching
    # the reference's implicit date→timestamp cast in comparisons
    lt, rt = lc.ltype.id, rc.ltype.id
    _ts = (TypeId.TIMESTAMP, TypeId.TIMESTAMPTZ)
    if (lt in _ts or rt in _ts) and TypeId.DATE in (lt, rt):
        if lt is TypeId.DATE:
            x = x * 86_400_000_000
        else:
            y = y * 86_400_000_000
    return x, y


def _to_double(c: Column) -> torch.Tensor:
    if c.ltype.id is TypeId.DECIMAL:
        d = c.data.to(torch.float64) / float(10**c.ltype.scale)
    else:
        d = c.data.to(torch.float64)
    if c.data_hi is not None:
        # wide value = hi·2^64 + uint64(lo): lift the low limb to its
        # unsigned magnitude, then add the high limb's contribution
        scale = float(10**c.ltype.scale if c.ltype.id is TypeId.DECIMAL else 1)
        ulo = d + torch.where(c.data < 0, 2.0**64 / scale, 0.0)
        d = c.data_hi.to(torch.float64) * (2.0**64 / scale) + ulo
    return d


@dataclass
class BoundConjunction(BoundExpr):
    op: str  # 'and' | 'or'
    exprs: List[BoundExpr]
    ltype: LogicalType = BOOLEAN

    def children(self):
        return self.exprs

    def eval(self, env: EvalEnv) -> Column:
        # SQL three-valued logic: NULL and false = false; NULL or true = true
        data = valid = None
        for e in self.exprs:
            c = e.eval(env)
            d = bcast(c.data.to(torch.bool), env.plen)
            cv = _valid_or_ones(c, env.plen, d.device)
            if data is None:
                data, valid = d, cv
            elif self.op == "and":
                valid = (valid & cv) | (valid & ~data) | (cv & ~d)
                data = data & d
            else:
                valid = (valid & cv) | (valid & data) | (cv & d)
                data = data | d
        return Column(data=data, ltype=BOOLEAN, validity=valid)


@dataclass
class BoundNot(BoundExpr):
    child: BoundExpr
    ltype: LogicalType = BOOLEAN

    def children(self):
        return [self.child]

    def eval(self, env):
        c = self.child.eval(env)
        return Column(data=~c.data.to(torch.bool), ltype=BOOLEAN,
                      validity=c.validity)


@dataclass
class BoundIsNull(BoundExpr):
    child: BoundExpr
    negated: bool = False
    ltype: LogicalType = BOOLEAN

    def children(self):
        return [self.child]

    def eval(self, env):
        c = self.child.eval(env)
        if c.validity is None:
            d = _const(env, self.negated, torch.bool)
        else:
            v = bcast(c.validity, env.plen)
            d = v if self.negated else ~v
        return Column(data=d, ltype=BOOLEAN)


@dataclass
class BoundArithmetic(BoundExpr):
    op: str  # + - * / % //
    left: BoundExpr
    right: BoundExpr
    ltype: LogicalType = DOUBLE

    def children(self):
        return [self.left, self.right]

    def eval(self, env: EvalEnv) -> Column:
        lc = self.left.eval(env)
        rc = self.right.eval(env)
        v = _and_validity(lc.validity, rc.validity)
        t = self.ltype
        if TypeId.SQLNULL in (lc.ltype.id, rc.ltype.id):  # NULL of the result's type
            return _coerce_to(Column(data=_const(env, 0, torch.int32), ltype=SQLNULL,
                                     validity=_const(env, False, torch.bool)), t, env)
        if t.is_float:
            x, y = _to_double(lc), _to_double(rc)
            if self.op == "+":
                d = x + y
            elif self.op == "-":
                d = x - y
            elif self.op == "*":
                d = x * y
            elif self.op == "/":
                d = x / y
            elif self.op == "%":
                d = torch.fmod(x, y)  # DuckDB truncates: the dividend's sign
            else:
                d = torch.div(x, y, rounding_mode="trunc")
            return Column(data=d, ltype=t, validity=v)
        if t.id is TypeId.DECIMAL:
            if self.op in ("+", "-"):
                x, y, _ = _decimal_align(lc, rc)
                d = x + y if self.op == "+" else x - y
            elif self.op == "%":
                x, y, _ = _decimal_align(lc, rc)
                d, v = _trunc_divmod(x, y, v, "%")
            elif self.op == "*":
                d = lc.data.to(torch.int64) * rc.data.to(torch.int64)
            else:
                raise BindError(f"decimal op {self.op} should have bound to DOUBLE")
            return Column(data=d, ltype=t, validity=v)
        if t.id is TypeId.INTERVAL or not t.is_integer and t.id is not TypeId.DATE:
            raise not_ported(f"{self.op} over {lc.ltype!r} and {rc.ltype!r}")
        if t.id is TypeId.HUGEINT:
            return _wide_arithmetic(self.op, lc, rc, v, env)
        # integer arithmetic (DATE ± integer days stays int32 days)
        dt = t.torch_dtype
        x = lc.data.to(dt)
        y = rc.data.to(dt)
        if self.op == "+":
            d = x + y
        elif self.op == "-":
            d = x - y
        elif self.op == "*":
            d = x * y
        elif self.op in ("%", "//"):
            d, v = _trunc_divmod(x, y, v, self.op)
        else:
            raise BindError("integer / binds to DOUBLE")
        return Column(data=d, ltype=t, validity=v)

    def is_const(self):
        return self.left.is_const() and self.right.is_const()

    def const_value(self):
        from duckdb_tpu_torch.planner.fold import fold_arithmetic

        return fold_arithmetic(self)


def _trunc_divmod(x: torch.Tensor, y: torch.Tensor, v, op: str):
    """Integer x % y or x // y as DuckDB computes them: truncated toward
    zero, so the remainder takes the dividend's sign (-7 % 3 = -1, -7 // 2
    = -3). x % 0 and x // 0 are NULL; the divisor is masked first, since
    torch raises on an integer division by zero. → (data, validity)."""
    zero = y == 0
    safe = torch.where(zero, torch.ones_like(y), y)
    d = torch.fmod(x, safe) if op == "%" else torch.div(x, safe, rounding_mode="trunc")
    return d, (~zero if v is None else v & ~zero)


def raise_on_overflow(ovf: torch.Tensor, validity, env: EvalEnv, what: str) -> None:
    """DuckDB's OutOfRangeException where a live, valid row overflowed
    (one host read)."""
    hit = ovf & env.live if validity is None else ovf & env.live & bcast(validity, env.plen)
    if bool(hit.any()):
        from duckdb_tpu_torch.errors import OutOfRangeException

        raise OutOfRangeException(f"Overflow in {what}!")


_WIDE_OP_NAMES = {"+": "addition", "-": "subtraction", "*": "multiplication",
                  "%": "modulo", "//": "division"}


def _wide_arithmetic(op: str, lc: Column, rc: Column, v, env: EvalEnv) -> Column:
    """HUGEINT + - * // % exactly over (hi, lo) planes (ops/int128)."""
    a = I128.limbs(lc.data, lc.data_hi, env.plen)
    b = I128.limbs(rc.data, rc.data_hi, env.plen)
    if op in ("+", "-", "*"):
        (hi, lo), ovf = {"+": I128.add, "-": I128.sub, "*": I128.mul}[op](a, b)
    elif op in ("%", "//"):
        q, r, zero, ovf = I128.divmod_trunc(a, b)
        hi, lo = q if op == "//" else r
        ovf = ovf & ~zero if op == "//" else torch.zeros_like(zero)
        v = ~zero if v is None else v & ~zero
    else:
        raise BindError("integer / binds to DOUBLE")
    raise_on_overflow(ovf, v, env, f"HUGEINT {_WIDE_OP_NAMES[op]}")
    return Column(data=lo, ltype=HUGEINT, validity=v, data_hi=hi)


@dataclass
class BoundNegate(BoundExpr):
    child: BoundExpr
    ltype: LogicalType = DOUBLE

    def children(self):
        return [self.child]

    def eval(self, env):
        c = self.child.eval(env)
        if self.ltype.id is TypeId.HUGEINT:
            (hi, lo), ovf = I128.neg(I128.limbs(c.data, c.data_hi, env.plen))
            raise_on_overflow(ovf, c.validity, env, "HUGEINT negation")
            return Column(data=lo, ltype=self.ltype, validity=c.validity, data_hi=hi)
        return Column(data=-c.data, ltype=self.ltype, validity=c.validity)

    def is_const(self):
        return self.child.is_const()

    def const_value(self):
        v = self.child.const_value()
        return None if v is None else -v


@dataclass
class BoundCase(BoundExpr):
    whens: List[Tuple[BoundExpr, BoundExpr]]
    else_expr: Optional[BoundExpr]
    ltype: LogicalType = DOUBLE

    def children(self):
        out = []
        for c, r in self.whens:
            out += [c, r]
        if self.else_expr:
            out.append(self.else_expr)
        return out

    def eval(self, env: EvalEnv) -> Column:
        # evaluate all branches, select backwards (first-match-wins)
        device = env.live.device
        if self.else_expr is not None:
            acc = _coerce_to(self.else_expr.eval(env), self.ltype, env)
        else:
            acc = _coerce_to(Column(data=_const(env, 0, torch.int32), ltype=SQLNULL,
                                    validity=_const(env, False, torch.bool)),
                             self.ltype, env)
        acc_data = bcast(acc.data, env.plen)
        acc_dict = acc.dict_values
        acc_valid = _valid_or_ones(acc, env.plen, device)
        wide = self.ltype.id is TypeId.HUGEINT
        acc_hi = I128.limbs(acc.data, acc.data_hi, env.plen)[0] if wide else None
        for cond, res in reversed(self.whens):
            cc = cond.eval(env)
            take = bcast(cc.data.to(torch.bool), env.plen)
            if cc.validity is not None:
                take = take & cc.validity
            rc = _coerce_to(res.eval(env), self.ltype, env)
            rv = _valid_or_ones(rc, env.plen, device)
            if self.ltype.id is TypeId.VARCHAR or self.ltype.id in UNSORTED_DICT_IDS:
                acc_col = Column(data=acc_data, ltype=self.ltype, dict_values=acc_dict)
                acc_data, acc_dict = varchar_where(take, rc, acc_col, env.plen)
            else:
                acc_data = torch.where(take, bcast(rc.data, env.plen), acc_data)
            if wide:
                acc_hi = torch.where(take, I128.limbs(rc.data, rc.data_hi, env.plen)[0], acc_hi)
            acc_valid = torch.where(take, rv, acc_valid)
        return Column(data=acc_data, ltype=self.ltype, validity=acc_valid,
                      dict_values=acc_dict, data_hi=acc_hi)


def _round_div(x: torch.Tensor, m: int) -> torch.Tensor:
    """x / m rounded half away from zero (integer tensors, m > 0)."""
    half = m // 2
    return torch.where(x >= 0, (x + half) // m, -((-x + half) // m))


def _coerce_to(c: Column, t: LogicalType, env: EvalEnv,
               try_cast: bool = False) -> Column:
    """Cast an evaluated column to the target logical type's physical form."""
    if c.ltype == t:
        return c
    if c.ltype.id is TypeId.SQLNULL:
        # NULL literal → all-null column of the target type
        dv = None
        if t.id in (TypeId.VARCHAR, TypeId.BIT):
            dv = np.array([""], dtype=object)
        elif t.id in UNSORTED_DICT_IDS:
            dv = np.empty(1, dtype=object)
            dv[0] = ()
        return Column(data=_const(env, 0, t.torch_dtype), ltype=t,
                      validity=_const(env, False, torch.bool), dict_values=dv)
    if c.ltype.id is TypeId.VARCHAR and t.id is TypeId.BLOB:
        # a relabel of the dictionary: each distinct value UTF-8 encoded
        # (byte order is code point order, so the dictionary stays sorted),
        # once per dictionary, so that functions of the BLOB find their
        # cached lookup tables on the next run
        from duckdb_tpu_torch.ops.strings import cached_lut

        dv = cached_lut(c.dict_values, ("to_blob",), lambda: np.array(
            [str(x).encode() for x in c.dict_values], dtype=object))
        return Column(data=c.data, ltype=t, validity=c.validity, dict_values=dv)
    if c.ltype.id is TypeId.BLOB and t.id is TypeId.VARCHAR:
        dv = np.array([bytes(x).decode() for x in c.dict_values], dtype=object)
        return Column(data=c.data, ltype=t, validity=c.validity, dict_values=dv)
    nested = _coerce_nested(c, t, env, try_cast)
    if nested is not None:
        return nested
    if c.ltype.id is TypeId.VARCHAR and t.id is not TypeId.VARCHAR:
        # string source: parse per distinct value (must run before the
        # numeric branches, which would otherwise cast the dict CODES)
        return _cast_from_varchar(c, t, env, try_cast=try_cast)
    if t.id is TypeId.DOUBLE:
        return Column(data=_to_double(c), ltype=t, validity=c.validity)
    if t.id is TypeId.DECIMAL:
        if c.ltype.id is TypeId.DECIMAL:
            shift = t.scale - c.ltype.scale
            x = c.data.to(torch.int64)
            # a smaller scale rounds half away from zero, as duckdb's
            # decimal casts do
            d = x * (10**shift) if shift >= 0 else _round_div(x, 10**-shift)
        elif c.ltype.is_integer or c.ltype.id is TypeId.BOOLEAN:
            d = c.data.to(torch.int64) * (10**t.scale)
        else:  # float → decimal: round
            d = torch.round(c.data.to(torch.float64) * (10**t.scale)).to(torch.int64)
        return Column(data=d, ltype=t, validity=c.validity)
    if t.is_integer and c.data_hi is not None and t.id is not TypeId.HUGEINT:
        c = _narrow_wide(c, t, env, try_cast)
    if t.is_integer:
        if c.ltype.id is TypeId.DECIMAL:
            # duckdb decimal→int casts round half away from zero
            d = _round_div(c.data.to(torch.int64), 10**c.ltype.scale).to(t.torch_dtype)
        elif c.ltype.is_float:
            d = torch.round(c.data).to(t.torch_dtype)
        else:
            d = c.data.to(t.torch_dtype)
        return Column(data=d, ltype=t, validity=c.validity)
    if t.id in (TypeId.DATE, TypeId.TIMESTAMP, TypeId.TIMESTAMPTZ) \
            and c.ltype.id in (TypeId.DATE, TypeId.TIMESTAMP, TypeId.TIMESTAMPTZ):
        if t.id in (TypeId.TIMESTAMP, TypeId.TIMESTAMPTZ):
            if c.ltype.id is TypeId.DATE:
                return Column(data=c.data.to(torch.int64) * 86400_000_000,
                              ltype=t, validity=c.validity)
            return Column(data=c.data, ltype=t, validity=c.validity)
        return Column(data=torch.div(c.data, 86400_000_000,
                                     rounding_mode="floor").to(torch.int32),
                      ltype=t, validity=c.validity)
    if t.id is TypeId.VARCHAR:
        return _cast_to_varchar(c, env)
    if t.id is TypeId.BOOLEAN:
        return Column(data=c.data != 0, ltype=t, validity=c.validity)
    if t.is_float:  # FLOAT target
        return Column(data=_to_double(c).to(t.torch_dtype), ltype=t,
                      validity=c.validity)
    raise not_ported(f"the cast {c.ltype!r} → {t!r}")


def _narrow_wide(c: Column, t: LogicalType, env, try_cast: bool) -> Column:
    """A wide column's values as int64 for a cast to a narrower integer: a
    value past 64 bits is NULL under TRY_CAST and DuckDB's
    ConversionException otherwise."""
    plen = env.plen if env is not None else c.data.shape[0]
    hi, lo = I128.limbs(c.data, c.data_hi, plen)
    fits = hi == (lo >> 63)
    valid = fits if c.validity is None else bcast(c.validity, plen) & fits
    if not try_cast:
        live = env.live if env is not None else torch.ones_like(fits)
        if bool((live & ~fits & _valid_or_ones(c, plen, fits.device)).any()):
            from duckdb_tpu_torch.errors import ConversionException

            raise ConversionException(f"Type HUGEINT with a value past 64 bits can't be cast "
                                      f"because the value is out of range for the destination "
                                      f"type {t.id.name}")
        valid = c.validity
    return Column(data=lo, ltype=c.ltype, validity=valid)


def raise_if_read(c: Column, errs: dict, env: Optional[EvalEnv]) -> None:
    """Raise errs[i] for the failing dictionary value i that the first row
    the statement reads holds (live in `env` and valid); without `env`,
    the first valid row of c. A failing value that no such row holds, as
    one only rows a WHERE removed hold, fails nothing. One host sync, and
    none when nothing failed."""
    if not errs:
        return
    dev = c.data.device
    nd = len(c.dict_values)
    failed = torch.zeros(nd, dtype=torch.bool, device=dev)
    failed[torch.tensor(list(errs), dtype=torch.long, device=dev)] = True
    codes = c.data.long().clamp(0, nd - 1)
    if env is None:
        codes = codes.reshape(-1)
        keep = None if c.validity is None else c.validity.expand(c.data.shape).reshape(-1)
    else:
        codes = bcast(codes, env.plen)
        keep = env.live if c.validity is None else env.live & bcast(c.validity, env.plen)
    hit = failed[codes] if keep is None else failed[codes] & keep
    first = int(torch.where(hit.any(), codes[hit.to(torch.int8).argmax()], -1))
    if first >= 0:
        raise typed_value_error(errs[first])


def _with_ok(c: Column, t: LogicalType, ok: np.ndarray, dvals) -> Column:
    """c relabelled as t over `dvals`, NULL where its entry is not ok."""
    validity = c.validity
    if not ok.all():
        okv = torch.from_numpy(ok).to(c.data.device)[c.data.long().clamp(0, len(ok) - 1)]
        validity = okv if validity is None else validity & okv
    return Column(data=c.data, ltype=t, validity=validity, dict_values=dvals)


def _coerce_nested(c: Column, t: LogicalType, env, try_cast: bool) -> Optional[Column]:
    """The casts that involve a nested type or BIT (DuckDB's list_cast.cpp,
    struct_cast.cpp, union_casts.cpp, string_cast.cpp): LIST ↔ ARRAY with
    the length check, UNION ↔ UNION by member name, a member type into a
    UNION, VARCHAR → nested or BIT parsed once per distinct string, and
    nested or BIT → VARCHAR formatted once per distinct value. None when
    neither side is nested."""
    from duckdb_tpu_torch.blocks.nested import NESTED_IDS, encode_objects, obj_array, to_text
    from duckdb_tpu_torch.errors import ConversionException

    src, dst = c.ltype.id, t.id
    if src not in UNSORTED_DICT_IDS and dst not in UNSORTED_DICT_IDS:
        return None
    dv = c.dict_values if c.dict_values is not None else np.empty(0, dtype=object)
    if src in UNSORTED_DICT_IDS and dst is TypeId.VARCHAR:
        strs = [to_text(v, c.ltype) for v in dv] or [""]
        uniq, inv = np.unique(np.array(strs, dtype=str), return_inverse=True)
        lut = torch.from_numpy(inv.reshape(-1).astype(np.int32)).to(c.data.device)
        return Column(data=lut[c.data.long().clamp(0, len(strs) - 1)], ltype=VARCHAR,
                      validity=c.validity, dict_values=uniq.astype(object))
    if src is TypeId.LIST and dst is TypeId.ARRAY:
        ok = np.array([len(e) == t.width for e in dv] or [True])
        if not try_cast:
            raise_if_read(c, {i: ConversionException(
                f"Cannot cast list of length {len(dv[i])} to {t!r}")
                for i in np.flatnonzero(~ok).tolist()}, env)
        return _with_ok(c, t, ok, dv)
    if src is TypeId.ARRAY and dst is TypeId.LIST or null_fits(c.ltype, t):
        # a list of NULLs (SQLNULL[], the empty list literal) or a struct
        # with NULL fields ({'a': NULL}) holds values of every type of its
        # shape: a relabel
        return Column(data=c.data, ltype=t, validity=c.validity, dict_values=dv)
    if src is TypeId.UNION and dst is TypeId.UNION:
        src_names = [n for n, _ in (c.ltype.fields or ())]
        dst_idx = {n.lower(): i for i, (n, _) in enumerate(t.fields or ())}
        out = []
        for e in dv:
            if not e:
                out.append(e)
                continue
            tag, v = e
            name = src_names[tag] if tag < len(src_names) else None
            if name is None or name.lower() not in dst_idx:
                raise BindError(f"union member {name!r} not present in {t!r}")
            out.append((dst_idx[name.lower()], v))
        return Column(data=c.data, ltype=t, validity=c.validity, dict_values=obj_array(out))
    if dst is TypeId.UNION and src is TypeId.VARCHAR:
        for ki, (_, ft) in enumerate(t.fields or ()):
            if ft.id is TypeId.VARCHAR:
                return Column(data=c.data, ltype=t, validity=c.validity,
                              dict_values=obj_array([(ki, str(v)) for v in dv]))
        raise BindError(f"no union member accepts VARCHAR in {t!r}")
    if dst is TypeId.UNION:
        # a member type → the first member that accepts it (union_casts.cpp)
        from duckdb_tpu_torch.blocks.nested import column_values
        from duckdb_tpu_torch.types import implicit_cast_cost

        tag = next((i for i, (_, ft) in enumerate(t.fields or ())
                    if ft == c.ltype or implicit_cast_cost(c.ltype, ft) is not None), None)
        if tag is None:
            raise BindError(f"no union member accepts {c.ltype!r}")
        if c.dict_values is not None:
            codes, d = encode_objects([(tag, v) for v in dv])
            lut = torch.from_numpy(codes if len(codes) else np.zeros(1, np.int32)).to(
                c.data.device)
            return Column(data=lut[c.data.long().clamp(0, max(len(codes) - 1, 0))], ltype=t,
                          validity=c.validity, dict_values=d)
        vals = column_values(Column(data=bcast(c.data, env.plen), ltype=c.ltype), env.plen)
        codes, d = encode_objects([(tag, v) for v in vals])
        return Column(data=torch.from_numpy(codes).to(c.data.device), ltype=t,
                      validity=c.validity, dict_values=d)
    if src is TypeId.VARCHAR and dst is TypeId.BIT:
        ok = np.array([len(str(s_)) > 0 and all(ch in "01" for ch in str(s_)) for s_ in dv]
                      or [True])
        if not try_cast:
            raise_if_read(c, {i: ConversionException(
                f"Could not convert string '{dv[i]}' to BIT")
                for i in np.flatnonzero(~ok).tolist()}, env)
        return _with_ok(c, t, ok, np.array([str(s_) for s_ in dv] or [""], dtype=object))
    if src is TypeId.VARCHAR and dst in NESTED_IDS:
        # parse each distinct string once (nested_cast.py)
        from duckdb_tpu_torch.planner.nested_cast import cast_str_to_nested

        entries, ok = [], np.ones(max(len(dv), 1), dtype=bool)
        for i, s_ in enumerate(dv):
            try:
                entries.append(cast_str_to_nested(str(s_), t))
            except (ValueError, ArithmeticError):
                entries.append(())
                ok[i] = False
        if not try_cast:
            raise_if_read(c, {i: ConversionException(
                f"Could not convert string '{dv[i]}' to {t!r}")
                for i in np.flatnonzero(~ok).tolist()}, env)
        codes, d = encode_objects(entries)
        lut = torch.from_numpy(codes if len(codes) else np.zeros(1, np.int32)).to(c.data.device)
        out = Column(data=lut[c.data.long().clamp(0, max(len(codes) - 1, 0))], ltype=t,
                     validity=c.validity, dict_values=d)
        return _with_ok(out, t, ok, d) if not ok.all() else out
    if src is TypeId.BIT and dst is TypeId.BIT:
        return c
    if nested_widens(c.ltype, t):
        # each distinct value's leaves converted once (list_cast.cpp,
        # struct_cast.cpp): INTEGER[] → DOUBLE[], a STRUCT field's DECIMAL
        # to a wider one
        codes, d = encode_objects([_widen_value(v, c.ltype, t) for v in dv])
        lut = torch.from_numpy(codes if len(codes) else np.zeros(1, np.int32)).to(c.data.device)
        return Column(data=lut[c.data.long().clamp(0, max(len(codes) - 1, 0))], ltype=t,
                      validity=c.validity, dict_values=d)
    raise not_ported(f"the cast {c.ltype!r} → {t!r}")


def _widen_value(v, s: LogicalType, d: LogicalType):
    """One nested value of type s as type d (types.nested_widens); a LIST
    and a STRUCT are tuples (of elements, of field values in order)."""
    if v is None or s == d:
        return v
    if s.id is TypeId.LIST:
        return tuple(_widen_value(x, s.child, d.child) for x in v)
    if s.id is TypeId.STRUCT:
        return tuple(_widen_value(x, st, dt)
                     for x, (_, st), (_, dt) in zip(v, s.fields, d.fields))
    if d.is_float:
        return float(v)
    if d.id is TypeId.DECIMAL:
        return pydec.Decimal(v).quantize(pydec.Decimal(1).scaleb(-d.scale))
    if d.is_integer:
        return int(v)
    if s.id is TypeId.DATE and d.id in (TypeId.TIMESTAMP, TypeId.TIMESTAMPTZ):
        v = datetime.datetime(v.year, v.month, v.day)
        return v if d.id is TypeId.TIMESTAMP else v.replace(tzinfo=datetime.timezone.utc)
    if d.id is TypeId.TIMESTAMPTZ:
        return v.replace(tzinfo=datetime.timezone.utc)
    if d.id is TypeId.TIMESTAMP:
        return v.replace(tzinfo=None)
    return v


def format_varchar(v, t: LogicalType) -> str:
    """Render one non-NULL value as duckdb's VARCHAR cast does
    (duckdb/src/common/operator/string_cast.cpp)."""
    import decimal as pydec

    if t.id is TypeId.BOOLEAN:
        return "true" if v else "false"
    if t.id is TypeId.DECIMAL:
        return str(pydec.Decimal(int(v)).scaleb(-t.scale)) if t.scale else str(int(v))
    if t.id is TypeId.DATE:
        return (datetime.date(1970, 1, 1) + datetime.timedelta(days=int(v))).isoformat()
    if t.id in (TypeId.TIMESTAMP, TypeId.TIMESTAMPTZ):
        dt = datetime.datetime(1970, 1, 1) + datetime.timedelta(microseconds=int(v))
        s = dt.strftime("%Y-%m-%d %H:%M:%S")
        if dt.microsecond:
            s += f".{dt.microsecond:06d}".rstrip("0")
        return s + "+00" if t.id is TypeId.TIMESTAMPTZ else s  # the session is UTC
    if t.id is TypeId.TIME:
        us = int(v)
        s = f"{us // 3_600_000_000:02d}:{us // 60_000_000 % 60:02d}:{us // 1_000_000 % 60:02d}"
        if us % 1_000_000:
            s += f".{us % 1_000_000:06d}".rstrip("0")
        return s
    if t.is_float:
        f = float(v)
        if f != f or f in (float("inf"), float("-inf")):
            return {float("inf"): "inf", float("-inf"): "-inf"}.get(f, "nan")
        if f == int(f) and abs(f) < 1e15:
            return f"{f:.1f}"
        return repr(f)
    if t.is_integer:
        return str(int(v))
    if t.id is TypeId.INTERVAL:
        return interval_text(*_interval_parts(v))
    raise not_ported(f"the cast {t!r} → VARCHAR")


def _interval_parts(v) -> tuple:
    """(months, days, micros) of an interval: a constant's own parts, or a
    column's microseconds as whole days and the rest. A column keeps no
    months (its months were folded to 30 days), so it prints days."""
    if isinstance(v, (tuple, list)):
        return tuple(int(x) for x in v)
    us = int(v)
    days = abs(us) // 86_400_000_000 * (1 if us >= 0 else -1)
    return 0, days, us - days * 86_400_000_000


def interval_text(months: int, days: int, micros: int) -> str:
    """DuckDB's text of an interval (IntervalToStringCast::Format): years,
    months and days, each pluralized, then [-]HH:MM:SS[.ffffff], or
    '00:00:00' when every part is 0."""
    parts = []
    years, months = int(months / 12), months - int(months / 12) * 12
    for n, unit in ((years, "year"), (months, "month"), (days, "day")):
        if n:
            parts.append(f"{n} {unit}" + ("" if n in (1, -1) else "s"))
    if micros:
        sign, us = ("-", -micros) if micros < 0 else ("", micros)
        t = (f"{sign}{us // 3_600_000_000:02d}:{us // 60_000_000 % 60:02d}:"
             f"{us // 1_000_000 % 60:02d}")
        if us % 1_000_000:
            t += f".{us % 1_000_000:06d}".rstrip("0")
        parts.append(t)
    return " ".join(parts) or "00:00:00"


def format_distinct(c: Column, env, fmt: Callable[[object], str],
                    null_text: Optional[str] = None) -> Column:
    """A VARCHAR column of fmt(value) for every row of c, formatted once
    per distinct value: torch.unique on the column's device, one transfer
    of the distinct values, fmt over them on the host, and a gather of the
    inverse. The codes and the sorted dictionary equal those of formatting
    every row and np.unique-ing the strings. A NULL row gives `null_text`
    (its data formatted when None); its validity is kept."""
    device = env.live.device
    data = bcast(c.data, env.plen)
    if c.data_hi is not None:  # a wide value: distinct (hi, lo) pairs
        uniq, inv = torch.unique(torch.stack([bcast(c.data_hi, env.plen), data], 1),
                                 dim=0, return_inverse=True)
        vals = [int(h) * (1 << 64) + (int(lo) & ((1 << 64) - 1))
                for h, lo in uniq.cpu().tolist()]
    elif data.dtype.is_floating_point:
        # distinct bit patterns, so that -0.0 and 0.0 stay apart
        bits = data.view(torch.int64 if data.dtype == torch.float64 else torch.int32)
        uniq, inv = torch.unique(bits, return_inverse=True)
        vals = uniq.view(data.dtype).cpu().numpy()
    else:
        uniq, inv = torch.unique(data, return_inverse=True)
        vals = uniq.cpu().numpy()
    if null_text is not None and c.validity is not None:
        # a value that only NULL rows hold is not formatted; NULL rows take
        # one more entry, null_text
        valid = bcast(c.validity, env.plen)
        used = torch.zeros(len(vals), dtype=torch.bool, device=device)
        used[inv[valid]] = True
        strs = [fmt(v) if u else null_text for v, u in zip(vals, used.cpu().tolist())]
        if not bool(valid.all()):
            inv = torch.where(valid, inv, len(strs))
            strs.append(null_text)
    else:
        strs = [fmt(v) for v in vals]
    d, remap = np.unique(np.array(strs or [""], dtype=str), return_inverse=True)
    remap = torch.from_numpy(remap.reshape(-1).astype(np.int32)).to(device)
    return Column(data=remap[inv], ltype=VARCHAR, validity=c.validity,
                  dict_values=d.astype(object))


def _cast_to_varchar(c: Column, env) -> Column:
    """Non-VARCHAR → VARCHAR: each distinct value formatted once on the
    host (format_varchar), NULL rows as ''."""
    return format_distinct(c, env, lambda v: format_varchar(v, c.ltype), null_text="")


def parse_decimal_text(c: str, scale: int) -> int:
    """Exact decimal text → scaled int (integer arithmetic, round-half-up)."""
    c = c.strip()
    neg = c.startswith("-")
    if c and c[0] in "+-":
        c = c[1:]
    if "e" in c or "E" in c:  # scientific notation: exact via Decimal
        import decimal as pydec

        v = int(pydec.Decimal(c).scaleb(scale).to_integral_value(
            rounding=pydec.ROUND_HALF_UP))
        return -v if neg else v
    whole, _, frac = c.partition(".")
    v = int((whole or "0") + (frac + "0" * scale)[:scale])
    if len(frac) > scale and frac[scale] >= "5":
        v += 1
    return -v if neg else v


def parse_float_text(s: str, t: LogicalType) -> float:
    """Text → DOUBLE / REAL as DuckDB casts it: a value beyond the type's
    range is a conversion error (ValueError), not an infinity; 'inf',
    'infinity' and 'nan' are accepted."""
    f = float(s)
    if math.isinf(f) and s.strip().lstrip("+-").lower() not in ("inf", "infinity"):
        raise ValueError(f"{s!r} is out of range for {t!r}")
    if t.id is TypeId.FLOAT and not math.isinf(f) and abs(f) > np.finfo(np.float32).max:
        raise ValueError(f"{s!r} is out of range for {t!r}")
    return f


def _cast_from_varchar(c: Column, t: LogicalType, env: Optional[EvalEnv],
                       try_cast: bool = False) -> Column:
    """VARCHAR → numeric/date/time/boolean: parse each DISTINCT value once
    into a LUT, gather by code. A value that does not parse fails the cast
    where a row of `env` reads it (raise_if_read), and is NULL under
    TRY_CAST."""
    from duckdb_tpu_torch.planner.binder import (_parse_time_micros, _parse_timestamp,
                                                 _parse_timestamptz)

    def parse(s):
        s = str(s).strip()
        if t.id is TypeId.DATE:
            return (datetime.date.fromisoformat(s) - datetime.date(1970, 1, 1)).days
        if t.id is TypeId.TIMESTAMP:
            return _parse_timestamp(s)
        if t.id is TypeId.TIMESTAMPTZ:
            return _parse_timestamptz(s)
        if t.id is TypeId.TIME:
            return _parse_time_micros(s)
        if t.id is TypeId.DECIMAL:
            return parse_decimal_text(s, t.scale)
        if t.id is TypeId.BOOLEAN:
            if s.lower() in ("true", "t", "1"):
                return 1
            if s.lower() in ("false", "f", "0"):
                return 0
            raise ValueError(s)
        if t.is_float:
            return parse_float_text(s, t)
        if t.is_integer:
            if s.lstrip("+-").isdigit():
                return int(s)
            f = float(s)  # duckdb accepts '1.5'::INT, rounding half away from 0
            r = int(abs(f) + 0.5)
            return r if f >= 0 else -r
        raise not_ported(f"the cast VARCHAR → {t!r}")

    dv = c.dict_values if c.dict_values is not None else []
    ok = np.ones(max(1, len(dv)), dtype=bool)
    vals = np.zeros(max(1, len(dv)), dtype=t.np_dtype)
    errs = {}
    for i, s_ in enumerate(dv):
        try:
            vals[i] = parse(s_)
        except (ValueError, ArithmeticError):  # decimal's InvalidOperation too
            ok[i] = False
            errs[i] = CastConversionError(
                f"Conversion Error: Could not convert string '{s_}' to {t.id.name}")
    if not try_cast:
        raise_if_read(c, errs, env)
    device = c.data.device
    idx = c.data.long().clamp(0, len(vals) - 1)
    validity = c.validity
    if errs:  # TRY_CAST: unparseable values become NULL
        okv = torch.from_numpy(ok).to(device)[idx]
        validity = okv if validity is None else validity & okv
    return Column(data=torch.from_numpy(vals).to(device)[idx], ltype=t,
                  validity=validity)


@dataclass
class BoundCast(BoundExpr):
    child: BoundExpr
    ltype: LogicalType = DOUBLE
    try_cast: bool = False

    def children(self):
        return [self.child]

    def eval(self, env):
        return _coerce_to(self.child.eval(env), self.ltype, env, try_cast=self.try_cast)

    def is_const(self):
        return self.child.is_const()

    def const_value(self):
        from duckdb_tpu_torch.planner.fold import fold_cast

        return fold_cast(self)


@dataclass
class BoundLike(BoundExpr):
    """LIKE over dictionary codes: a boolean LUT over the distinct values
    (ops/strings on the device from DEVICE_LIKE_MIN_DICT values, else a
    host regex), cached per dictionary and kept on the column's device,
    then one gather by code. NULLs pass through in the validity mask."""

    child: BoundExpr
    pattern: str
    negated: bool = False
    case_insensitive: bool = False
    ltype: LogicalType = BOOLEAN

    def children(self):
        return [self.child]

    def eval(self, env: EvalEnv) -> Column:
        c = self.child.eval(env)
        if c.ltype.id is not TypeId.VARCHAR or c.dict_values is None:
            raise not_ported(f"LIKE over {c.ltype!r}")
        lut = like_lut(c.dict_values, self.pattern, self.case_insensitive,
                       c.data.device)
        if self.negated:
            lut = ~lut
        d = lut[c.data.long().clamp(0, lut.shape[0] - 1)]
        return Column(data=d, ltype=BOOLEAN, validity=c.validity)


def like_lut(dvals: np.ndarray, pattern: str, ci: bool, device) -> torch.Tensor:
    """(max(1, n),) bool on `device`: which dictionary values match,
    computed once per (dictionary, pattern, ci, device)."""
    from duckdb_tpu_torch.ops import strings as dstr

    def compute():
        if len(dvals) >= dstr.DEVICE_LIKE_MIN_DICT:
            # near-unique columns: vectorized matching over the packed byte
            # plane instead of a Python loop per distinct value
            lut = dstr.device_like_lut(dvals, pattern, ci, device)
            if lut is not None:
                return lut
            dstr.note_host_loop(f"like:{pattern}", len(dvals))
        # DOTALL: '%' and '_' match a newline too, as the device path does
        prog = re.compile(like_to_regex(pattern),
                          re.DOTALL | (re.IGNORECASE if ci else 0))
        lut = np.fromiter((prog.match(s) is not None for s in dvals),
                          dtype=np.bool_, count=len(dvals))
        if not len(lut):  # an empty dictionary: one slot for the clamped gather
            lut = np.zeros(1, dtype=np.bool_)
        return torch.from_numpy(lut).to(device)

    return dstr.cached_lut(dvals, ("like", pattern, ci, str(device)), compute)


def like_to_regex(pattern: str) -> str:
    out = []
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        elif ch == "\\" and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 1
        else:
            out.append(re.escape(ch))
        i += 1
    return "".join(out) + r"\Z"


@dataclass
class BoundInList(BoundExpr):
    child: BoundExpr
    items: List[BoundExpr]
    negated: bool = False
    ltype: LogicalType = BOOLEAN

    def children(self):
        return [self.child] + self.items

    def eval(self, env: EvalEnv) -> Column:
        c = self.child.eval(env)
        if c.ltype.id is TypeId.VARCHAR:
            vals = {it.const_value() for it in self.items} - {None}
            lut = np.isin(c.dict_values, np.array(sorted(vals), dtype=object))
            if self.negated:
                lut = ~lut
            d = torch.from_numpy(lut).to(c.data.device)[
                c.data.long().clamp(0, len(lut) - 1)]
            return Column(data=d, ltype=BOOLEAN, validity=c.validity)
        d = _const(env, False, torch.bool)
        for it in self.items:
            ic = it.eval(env)
            if (c.data_hi is not None or ic.data_hi is not None) \
                    and not (c.ltype.is_float or ic.ltype.is_float):
                d = d | _wide_compare("=", c, ic, env.plen)
                continue
            x, y = _common_numeric(c, ic)
            d = d | (x == y)
        if self.negated:
            d = ~d
        return Column(data=d, ltype=BOOLEAN, validity=c.validity)


@dataclass
class BoundFunction(BoundExpr):
    name: str
    args: List[BoundExpr]
    ltype: LogicalType = DOUBLE
    impl: Optional[Callable] = None  # (env, arg_columns, node) -> Column

    def children(self):
        return self.args

    def eval(self, env: EvalEnv) -> Column:
        return self.impl(env, [a.eval(env) for a in self.args], self)


@dataclass
class BoundAggregateRef(BoundExpr):
    """Reference to an aggregate's output slot (post-grouping column)."""

    key: str
    ltype: LogicalType = DOUBLE

    def eval(self, env: EvalEnv) -> Column:
        return env.cols[self.key]


@dataclass
class BoundAggregate:
    """One aggregate to compute: func over arg expressions (pre-grouping)."""

    func: str  # sum/count/avg/min/max/count_star
    args: List[BoundExpr]
    distinct: bool
    ltype: LogicalType  # result type
    key: str  # output binding
    order_by: List = field(default_factory=list)  # (BoundExpr, desc, nf)
    # list()/array_agg's FILTER (WHERE …): the rows it drops are not listed
    filter: Optional[BoundExpr] = None


def and_terms(e: BoundExpr) -> List[BoundExpr]:
    """The conjuncts of a bound AND, at any depth ([e] otherwise)."""
    if isinstance(e, BoundConjunction) and e.op == "and":
        return [t for c in e.exprs for t in and_terms(c)]
    return [e]


def walk(expr: BoundExpr):
    yield expr
    for c in expr.children():
        yield from walk(c)

