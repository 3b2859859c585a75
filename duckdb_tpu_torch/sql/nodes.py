"""Parsed AST nodes (parser output, pre-binding).

Parallels the reference's SQLStatement / QueryNode / ParsedExpression /
TableRef hierarchy (duckdb/src/parser/{statement,query_node,
expression,tableref}/), trimmed to a dataclass tree.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple


# ---------------------------------------------------------------------------
# expressions
class Expr:
    pass


@dataclass
class Literal(Expr):
    value: object  # python int/float/str/bool/None/Decimal-as-str
    type_hint: Optional[str] = None  # 'date', 'timestamp', 'decimal', ...


@dataclass
class IntervalLiteral(Expr):
    value: str
    unit: Optional[str]  # 'year', 'month', 'day', ... or None (parse from value)


@dataclass
class ColumnRef(Expr):
    parts: Tuple[str, ...]  # (col,) or (table, col) or (schema, table, col)


@dataclass
class Star(Expr):
    table: Optional[str] = None
    exclude: Tuple[str, ...] = ()


@dataclass
class FunctionCall(Expr):
    name: str
    args: List[Expr]
    distinct: bool = False
    is_star: bool = False  # count(*)
    filter: Optional[Expr] = None
    order_by: List["OrderItem"] = field(default_factory=list)


@dataclass
class WindowSpec:
    partition_by: List[Expr] = field(default_factory=list)
    order_by: List["OrderItem"] = field(default_factory=list)
    # frame: (mode, start, end) — None means default
    frame: Optional[Tuple[str, object, object]] = None


@dataclass
class WindowFunction(Expr):
    func: FunctionCall
    spec: WindowSpec


@dataclass
class UnaryOp(Expr):
    op: str
    child: Expr


@dataclass
class BinaryOp(Expr):
    op: str  # + - * / % // || and comparison ops = <> < <= > >=
    left: Expr
    right: Expr


@dataclass
class Conjunction(Expr):
    op: str  # 'and' | 'or'
    children: List[Expr]


@dataclass
class NotExpr(Expr):
    child: Expr


@dataclass
class IsNull(Expr):
    child: Expr
    negated: bool = False


@dataclass
class IsDistinctFrom(Expr):
    left: Expr
    right: Expr
    negated: bool = False


@dataclass
class Between(Expr):
    expr: Expr
    low: Expr
    high: Expr
    negated: bool = False


@dataclass
class LikeExpr(Expr):
    expr: Expr
    pattern: Expr
    negated: bool = False
    case_insensitive: bool = False


@dataclass
class InList(Expr):
    expr: Expr
    items: List[Expr]
    negated: bool = False


@dataclass
class InSubquery(Expr):
    expr: Expr
    subquery: "SelectStatement"
    negated: bool = False


@dataclass
class Exists(Expr):
    subquery: "SelectStatement"
    negated: bool = False


@dataclass
class ScalarSubquery(Expr):
    subquery: "SelectStatement"


@dataclass
class CaseExpr(Expr):
    operand: Optional[Expr]  # CASE x WHEN ... (None for searched case)
    whens: List[Tuple[Expr, Expr]]
    else_expr: Optional[Expr]


@dataclass
class LambdaExpr(Expr):
    param: str
    body: "Expr"
    index_param: Optional[str] = None  # lambda x, i: ... (1-based index)


@dataclass
class CastExpr(Expr):
    child: Expr
    type_name: str
    type_mods: Tuple[int, ...] = ()
    try_cast: bool = False


@dataclass
class CollateExpr(Expr):
    """expr COLLATE name — e.g. NOCASE, NOACCENT, NFC, or dotted chains."""

    child: Expr
    collation: str


@dataclass
class ExtractExpr(Expr):
    field: str
    child: Expr


@dataclass
class Parameter(Expr):
    index: int


# ---------------------------------------------------------------------------
# table refs
class TableRef:
    pass


@dataclass
class BaseTableRef(TableRef):
    name: str
    schema: Optional[str] = None
    alias: Optional[str] = None
    column_aliases: Tuple[str, ...] = ()
    sample: Optional[tuple] = None  # TABLESAMPLE, applied pre-join


@dataclass
class SubqueryRef(TableRef):
    subquery: "SelectStatement"
    alias: Optional[str] = None
    column_aliases: Tuple[str, ...] = ()


@dataclass
class TableFunctionRef(TableRef):
    name: str
    args: List[Expr]
    alias: Optional[str] = None
    column_aliases: Tuple[str, ...] = ()


@dataclass
class JoinRef(TableRef):
    left: TableRef
    right: TableRef
    join_type: str  # inner/left/right/full/cross/semi/anti
    condition: Optional[Expr] = None
    using: Tuple[str, ...] = ()
    natural: bool = False


# ---------------------------------------------------------------------------
# query nodes / statements
@dataclass
class OrderItem:
    expr: Expr
    descending: bool = False
    nulls_first: Optional[bool] = None  # None = the default_null_order setting
    direction_given: bool = False  # ASC or DESC written (else: default_order)


@dataclass
class SelectNode:
    select_list: List[Tuple[Expr, Optional[str]]] = field(default_factory=list)
    distinct: bool = False
    distinct_on: List[Expr] = field(default_factory=list)
    from_table: Optional[TableRef] = None
    where: Optional[Expr] = None
    group_by: List[Expr] = field(default_factory=list)
    group_by_all: bool = False
    having: Optional[Expr] = None
    qualify: Optional[Expr] = None
    # (amount Expr, unit 'rows'|'percent', method|None, seed|None)
    sample: Optional[tuple] = None


@dataclass
class SetOpNode:
    op: str  # union/except/intersect
    all: bool
    left: object  # SelectNode | SetOpNode
    right: object


@dataclass
class ValuesNode:
    rows: List[List[Expr]]


@dataclass
class CTE:
    name: str
    query: "SelectStatement"
    column_aliases: Tuple[str, ...] = ()
    materialized: Optional[bool] = None
    recursive: bool = False


@dataclass
class SelectStatement:
    node: object  # SelectNode | SetOpNode | ValuesNode
    ctes: List[CTE] = field(default_factory=list)
    order_by: List[OrderItem] = field(default_factory=list)
    limit: Optional[Expr] = None
    offset: Optional[Expr] = None


# -- DDL / DML --------------------------------------------------------------
@dataclass
class ColumnSpec:
    name: str
    type_name: str
    type_mods: Tuple[int, ...] = ()
    not_null: bool = False
    primary_key: bool = False
    default: Optional[Expr] = None
    default_text: Optional[str] = None  # raw SQL of the DEFAULT expr
    unique: bool = False
    check: Optional[str] = None  # original SQL text of the CHECK expression
    references: Optional[tuple] = None  # (ref_table, ref_col|None)


@dataclass
class CreateTable:
    name: str
    columns: List[ColumnSpec] = field(default_factory=list)
    # table-level: ("primary_key"|"unique", [cols]) / ("check", sql_text)
    constraints: List[tuple] = field(default_factory=list)
    as_select: Optional[SelectStatement] = None
    if_not_exists: bool = False
    or_replace: bool = False
    temporary: bool = False


@dataclass
class CreateView:
    name: str
    query: SelectStatement = None
    or_replace: bool = False
    temporary: bool = False


@dataclass
class DropStatement:
    kind: str  # table/view/schema/sequence
    name: str
    if_exists: bool = False
    cascade: bool = False


@dataclass
class CreateSchema:
    name: str
    if_not_exists: bool = False


@dataclass
class CreateIndex:
    """CREATE [UNIQUE] INDEX (reference: create_index_statement). Indexes
    are catalog metadata here: point lookups already ride dense
    direct-address join tables cached per table version, so the entry
    only carries the UNIQUE constraint + introspection surface."""
    name: str
    table: str
    exprs: List[str] = field(default_factory=list)  # column names / texts
    unique: bool = False
    if_not_exists: bool = False


@dataclass
class CommentStatement:
    """COMMENT ON <kind> <name> IS <'text'|NULL>."""
    kind: str  # table / column / view / schema / sequence / macro / index
    name: str  # qualified; for column: table.column
    comment: Optional[str] = None


@dataclass
class PrepareStatement:
    name: str
    sql: str  # statement text with ? / $n placeholders


@dataclass
class ExecuteStatement:
    name: str
    args: List[Expr] = field(default_factory=list)


@dataclass
class DeallocateStatement:
    name: Optional[str] = None  # None = all


@dataclass
class AttachStatement:
    path: str
    alias: Optional[str] = None
    read_only: bool = False
    if_not_exists: bool = False


@dataclass
class DetachStatement:
    name: str
    if_exists: bool = False


@dataclass
class UseStatement:
    name: str


@dataclass
class CreateMacro:
    name: str
    params: Tuple[str, ...]
    defaults: dict                 # param name -> Expr AST
    body: object                   # Expr (scalar) or SelectStatement (table)
    is_table: bool = False
    or_replace: bool = False
    if_not_exists: bool = False


@dataclass
class InsertStatement:
    table: str
    columns: Tuple[str, ...] = ()
    source: Optional[SelectStatement] = None  # includes VALUES via ValuesNode
    # None | ("nothing", cols) | ("update", cols, [(name, Expr)]) |
    # ("replace", ())
    on_conflict: Optional[tuple] = None
    by_name: bool = False  # INSERT INTO t BY NAME: match source col names
    returning: Optional[list] = None  # [(Expr, alias|None)] or [("*", None)]


@dataclass
class DeleteStatement:
    table: str
    alias: Optional[str] = None
    where: Optional[Expr] = None
    using: Optional[list] = None  # extra FROM-like table refs
    returning: Optional[list] = None


@dataclass
class UpdateStatement:
    table: str
    alias: Optional[str] = None
    assignments: List[Tuple[str, Expr]] = field(default_factory=list)
    where: Optional[Expr] = None
    returning: Optional[list] = None
    from_refs: Optional[list] = None  # UPDATE … FROM <table refs>


@dataclass
class MergeAction:
    kind: str  # update / delete / insert / do_nothing
    condition: Optional[Expr] = None
    assignments: List[Tuple[str, Expr]] = field(default_factory=list)
    insert_columns: Tuple[str, ...] = ()
    insert_values: List[Expr] = field(default_factory=list)
    insert_star: bool = False


@dataclass
class MergeStatement:
    target: str
    target_alias: Optional[str]
    source: TableRef
    condition: Expr = None
    matched: List[MergeAction] = field(default_factory=list)
    not_matched: List[MergeAction] = field(default_factory=list)


@dataclass
class AlterStatement:
    table: str
    # add_column / drop_column / rename_column / rename_table /
    # alter_type / set_default / drop_default / set_not_null /
    # drop_not_null
    action: str
    name: str = ""
    new_name: str = ""
    col_type: str = ""
    col_mods: Tuple[int, ...] = ()
    if_exists: bool = False
    default: Optional[Expr] = None  # ADD COLUMN ... DEFAULT / SET DEFAULT
    default_text: Optional[str] = None
    using: Optional[Expr] = None    # ALTER TYPE ... USING expr
    # ADD COLUMN IF NOT EXISTS / DROP COLUMN IF EXISTS
    col_if: bool = False


@dataclass
class CreateType:
    """CREATE TYPE name AS ENUM (...) | CREATE TYPE name AS base_type.

    Reference: src/parser/parsed_data/create_type_info.hpp.
    """

    name: str
    enum_values: tuple = ()   # non-empty for ENUM
    base: str = None          # type-alias form
    base_mods: tuple = ()
    or_replace: bool = False
    if_not_exists: bool = False


@dataclass
class CreateSequence:
    name: str
    start: int = 1
    increment: int = 1
    if_not_exists: bool = False


@dataclass
class PivotStatement:
    table: str
    on_sql: str  # SQL text of the ON expression
    in_values: Optional[list]  # literal values, or None → query DISTINCT
    using_sql: str  # SQL text of the USING aggregate expression
    group_by: Tuple[str, ...] = ()


@dataclass
class UnpivotStatement:
    table: str
    on_cols: Tuple[str, ...] = ()
    name_col: str = "name"
    value_col: str = "value"


@dataclass
class ExportStatement:
    path: str
    fmt: str = "csv"  # csv | parquet


@dataclass
class ImportStatement:
    path: str


@dataclass
class CopyStatement:
    table: Optional[str]  # COPY table TO/FROM; or None for COPY (select) TO
    select: Optional[SelectStatement]
    direction: str  # 'to' | 'from'
    target: str
    options: dict = field(default_factory=dict)


@dataclass
class ExplainStatement:
    query: object
    analyze: bool = False


@dataclass
class SetStatement:
    name: str
    value: object
    is_reset: bool = False


@dataclass
class PragmaStatement:
    name: str
    args: List[Expr] = field(default_factory=list)


@dataclass
class CallStatement:
    name: str
    args: List[Expr] = field(default_factory=list)


@dataclass
class TransactionStatement:
    action: str  # begin/commit/rollback/checkpoint
