"""Plan operator tree (the node kinds the port executes).

The reference lowers LogicalOperator → PhysicalOperator
(duckdb/src/execution/physical_plan_generator.cpp). As in the JAX package,
one tree serves both roles: execution/executor.py runs each node as eager
torch ops over whole padded blocks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from duckdb_tpu_torch.planner.bound import BoundAggregate, BoundExpr
from duckdb_tpu_torch.types import LogicalType


class PlanNode:
    pass


@dataclass
class Scan(PlanNode):
    table: str
    alias: str
    cols: List[Tuple[str, str, LogicalType]]  # (colname, key, type)


@dataclass
class Filter(PlanNode):
    child: PlanNode
    expr: BoundExpr


@dataclass
class Project(PlanNode):
    child: PlanNode
    items: List[Tuple[str, BoundExpr]]  # (output key, expr)


@dataclass
class Aggregate(PlanNode):
    child: PlanNode
    groups: List[Tuple[str, BoundExpr]]  # (output key, expr)
    aggs: List[BoundAggregate]


@dataclass
class Join(PlanNode):
    """Join: inner, left (a right join is planned as left with the sides
    swapped), full, semi, anti, asof or asof_left. With no keys, an inner
    or outer join runs as an inequality join (IEJoin) or a cross
    expansion with `extra` as its residual; an ASOF join's `extra` is its
    one inequality."""

    probe: PlanNode  # "left" side of SQL semantics after planner normalization
    build: PlanNode
    jtype: str  # inner | left | full | semi | anti
    probe_keys: List[BoundExpr]
    build_keys: List[BoundExpr]
    # residual ON predicate over combined (probe ∪ build) columns
    extra: Optional[BoundExpr] = None
    # NOT IN semantics (anti joins)
    null_aware: bool = False


@dataclass
class CrossJoin(PlanNode):
    """Every live probe row with every live build row (no condition)."""

    probe: PlanNode
    build: PlanNode


@dataclass
class PositionalJoin(PlanNode):
    """Row-by-row zip of two relations; the shorter side pads with NULLs
    (DuckDB's physical_positional_join.cpp)."""

    left: PlanNode
    right: PlanNode


@dataclass
class Sample(PlanNode):
    """A pseudo-random subset of the child's live rows: `rows` of them,
    or each with probability `percent` / 100 (DuckDB's
    physical_reservoir_sample.cpp, physical_streaming_sample.cpp)."""

    child: PlanNode
    rows: Optional[int] = None
    percent: Optional[float] = None
    method: Optional[str] = None
    seed: Optional[int] = None  # REPEATABLE (seed); None → the session's generator


@dataclass
class SetOp(PlanNode):
    """UNION ALL of the inputs, each a Project onto one output key per
    column (`keys`, with their widened types)."""

    inputs: List[PlanNode]
    keys: List[Tuple[str, LogicalType]]


@dataclass
class Multiplicity(PlanNode):
    """INTERSECT / EXCEPT over grouped rows: the child holds one row per
    distinct tuple with its count on the left (`left_count`) and on the
    right (`right_count`); each row repeats min(l, r) times (INTERSECT
    ALL), max(l - r, 0) times (EXCEPT ALL), or once where INTERSECT or
    EXCEPT keeps it."""

    child: PlanNode
    op: str  # intersect | except
    all: bool
    left_count: str
    right_count: str


class ConstantRow(PlanNode):
    """A SELECT without FROM: one live row, no columns."""


@dataclass
class BoundWindow:
    """One window function call: its output key, function name, bound
    arguments, PARTITION BY and ORDER BY, and frame (None: the default)."""

    key: str
    func: str  # row_number / rank / dense_rank / sum / avg / min / max / lag / …
    args: List[BoundExpr]
    partition_by: List[BoundExpr]
    order_by: List[Tuple[BoundExpr, bool, Optional[bool]]]  # (expr, desc, nulls_first)
    frame: Optional[Tuple[str, tuple, tuple]]  # (mode, start, end) as the parser gives it
    ltype: LogicalType = None
    distinct: bool = False  # count / sum / avg (DISTINCT x) OVER (…)
    filter: Optional[BoundExpr] = None  # FILTER (WHERE …): the rows it is not TRUE for do not count


@dataclass
class Window(PlanNode):
    """The child's rows with one column per window function added (DuckDB's
    physical_window.cpp): every row keeps its place."""

    child: PlanNode
    windows: List[BoundWindow]


@dataclass
class Order(PlanNode):
    child: PlanNode
    items: List[Tuple[BoundExpr, bool, Optional[bool]]]  # (expr, desc, nulls_first)


@dataclass
class Limit(PlanNode):
    child: PlanNode
    n: Optional[int]
    offset: int = 0


@dataclass
class ListPack(PlanNode):
    """Columnar list_value: one LIST value per row from N column
    expressions (DuckDB's list_value.cpp over vectors)."""

    child: PlanNode
    exprs: list  # BoundExprs, one per element position
    key: str
    ltype: LogicalType  # the LIST type


@dataclass
class Unnest(PlanNode):
    """LIST expressions flattened to rows: several unnests zip by position
    with NULL padding, and the other columns repeat (DuckDB's
    physical_unnest.cpp)."""

    child: PlanNode
    exprs: list  # BoundExprs of LIST type
    keys: list  # the output column keys, one per expr
