"""Statement planner: parsed AST → plan tree (single-table SELECT).

The JAX package's planner (duckdb_tpu/planner/planner.py) flattens FROM
trees into an atom pool, orders joins and flattens subqueries. This slice
plans the TPC-H Q1 shape: one base table, WHERE conjuncts as filters,
GROUP BY with aggregates, HAVING, the projection, DISTINCT, ORDER BY and
LIMIT/OFFSET. It builds the same plan nodes, keys and output names as the
reference for that shape. Joins, subqueries, CTEs, set operations and
windows are not yet ported and say so.
"""

from __future__ import annotations

import itertools
from typing import List, Optional, Tuple

from duckdb_tpu_torch.sql import nodes as N
from duckdb_tpu_torch.planner import bound as B
from duckdb_tpu_torch.planner import plan as P
from duckdb_tpu_torch.planner.binder import (
    AGGREGATE_NAMES,
    BindError,
    ExprBinder,
    Scope,
)
from duckdb_tpu_torch.planner.bound import not_ported
from duckdb_tpu_torch.types import (
    BIGINT,
    DOUBLE,
    HUGEINT,
    SQLNULL,
    LogicalType,
    TypeId,
    decimal,
)

# aggregates the fused pipeline computes (execution/fused_agg.py)
_PORTED_AGGS = {"sum", "count", "count_star", "avg", "min", "max"}


def split_conjuncts(e: Optional[N.Expr]) -> List[N.Expr]:
    if e is None:
        return []
    if isinstance(e, N.Conjunction) and e.op == "and":
        out = []
        for c in e.children:
            out.extend(split_conjuncts(c))
        return out
    return [e]


class Planner:
    def __init__(self, catalog):
        self.catalog = catalog
        self._key_counter = itertools.count()

    def fresh(self, name: str) -> str:
        return f"{name}#{next(self._key_counter)}"

    # -- entry ---------------------------------------------------------------
    def plan_select(self, stmt: N.SelectStatement):
        """→ (plan, output [(name, key, ltype)])."""
        if stmt.ctes:
            raise not_ported("WITH (common table expressions)")
        if not isinstance(stmt.node, N.SelectNode):
            raise not_ported(f"the query form {type(stmt.node).__name__}")
        plan, output, scope = self.plan_select_node(stmt.node)
        if stmt.order_by:
            plan = self._plan_order(plan, stmt.order_by, output, scope)
        if stmt.limit is not None or stmt.offset is not None:
            n = None
            if stmt.limit is not None:
                n = int(ExprBinder(Scope()).bind(stmt.limit).const_value())
            off = (int(ExprBinder(Scope()).bind(stmt.offset).const_value())
                   if stmt.offset is not None else 0)
            plan = P.Limit(plan, n, off)
        return plan, output

    def _plan_base_table(self, ref, scope: Scope) -> P.Scan:
        if not isinstance(ref, N.BaseTableRef):
            raise not_ported(f"FROM {type(ref).__name__} (joins, subqueries, "
                             "table functions)")
        if ref.sample is not None or ref.column_aliases:
            raise not_ported("table samples and column alias lists")
        name = (f"{ref.schema}.{ref.name}" if ref.schema else ref.name).lower()
        if not self.catalog.has_table(name):
            raise BindError(f"Catalog Error: Table with name {ref.name} does not exist!")
        entry = self.catalog.get_table(name)
        alias = (ref.alias or ref.name).lower()
        cols = []
        for cd in entry.columns:
            key = self.fresh(f"{alias}.{cd.name}")
            cols.append((cd.name, key, cd.ltype))
            scope.add(alias, cd.name, key, cd.ltype)
        return P.Scan(entry.name, alias, cols)

    def plan_select_node(self, sel: N.SelectNode):
        if sel.from_table is None:
            raise not_ported("SELECT without FROM")
        if sel.sample is not None or sel.qualify is not None or sel.distinct_on:
            raise not_ported("SAMPLE, QUALIFY and DISTINCT ON")
        scope = Scope()
        plan: P.PlanNode = self._plan_base_table(sel.from_table, scope)
        binder = ExprBinder(scope)
        # single-atom pool: each WHERE conjunct becomes a filter on the scan,
        # in order, as the JAX planner's plan_pool pushes them
        for ast in split_conjuncts(sel.where):
            plan = P.Filter(plan, binder.bind(ast))

        # -- aggregation ------------------------------------------------------
        has_agg = (bool(sel.group_by) or sel.group_by_all or sel.having is not None
                   or any(_contains_aggregate(e) for e, _ in sel.select_list))
        select_aliases = {alias.lower(): e for e, alias in sel.select_list if alias}
        post_binder = binder
        if has_agg:
            plan, post_binder = self._plan_aggregate(plan, sel, scope,
                                                     select_aliases, binder)

        # -- projection -------------------------------------------------------
        items = []
        output = []
        for e, alias in self._expand_stars(sel.select_list, scope):
            be = post_binder.bind(e)
            key = self.fresh("out")
            items.append((key, be))
            output.append((alias or _default_name(e), key, be.ltype))
        if sel.having is not None:
            hb = post_binder.bind(sel.having)
            allowed = {gk for gk, _ in plan.groups} | {a.key for a in plan.aggs}
            for nn in B.walk(hb):
                if isinstance(nn, B.BoundColumnRef) and nn.key not in allowed:
                    raise BindError(
                        "Binder Error: HAVING column must appear in the GROUP "
                        "BY clause or be used in an aggregate function")
            plan = P.Filter(plan, hb)
        plan = P.Project(plan, items)
        if sel.distinct:
            plan = P.Aggregate(plan, [(k, B.BoundColumnRef(k, t))
                                      for _, k, t in output], [])
        out_scope = Scope()
        for nme, key, t in output:
            out_scope.add("", nme, key, t)
        return plan, output, (out_scope, post_binder)

    def _expand_stars(self, select_list, scope: Scope):
        out = []
        for e, alias in select_list:
            if isinstance(e, N.Star):
                cols = (scope.columns_of(e.table) if e.table else scope.all_columns())
                excluded = {x.lower() for x in e.exclude}
                out += [(N.ColumnRef((a, c)), c) for a, c, _ in cols
                        if c.lower() not in excluded]
            else:
                out.append((e, alias))
        return out

    # -- aggregate planning ---------------------------------------------------
    def _plan_aggregate(self, plan, sel: N.SelectNode, scope, select_aliases, binder):
        group_asts = [self._resolve_group_ast(g, sel, select_aliases)
                      for g in sel.group_by]
        if sel.group_by_all:
            group_asts += [e for e, _ in sel.select_list if not _contains_aggregate(e)]
        groups: List[Tuple[str, B.BoundExpr]] = []
        group_lookup: List[Tuple[N.Expr, str, LogicalType]] = []
        for g in group_asts:
            bg = binder.bind(g)
            key = self.fresh("grp")
            groups.append((key, bg))
            group_lookup.append((g, key, bg.ltype))
        aggs: List[B.BoundAggregate] = []

        def collector(fc: N.FunctionCall, b):
            return self._bind_aggregate_call(fc, binder, aggs)

        post = _PostAggBinder(scope, group_lookup, collector)
        return P.Aggregate(plan, groups, aggs), post

    def _resolve_group_ast(self, g, sel, select_aliases):
        if isinstance(g, N.Literal) and isinstance(g.value, int):
            return sel.select_list[g.value - 1][0]
        if isinstance(g, N.ColumnRef) and len(g.parts) == 1:
            a = g.parts[0].lower()
            if a in select_aliases:
                return select_aliases[a]
        return g

    def _bind_aggregate_call(self, fc: N.FunctionCall, binder,
                             aggs: List[B.BoundAggregate]):
        name = fc.name.lower()
        if fc.filter is not None or fc.order_by or fc.distinct:
            raise not_ported("FILTER, ORDER BY and DISTINCT inside an aggregate")
        if name == "count" and fc.is_star:
            func, args = "count_star", []
        else:
            func = {"mean": "avg"}.get(name, name)
            if func not in _PORTED_AGGS:
                raise not_ported(f"the aggregate {name}()")
            if len(fc.args) != 1:
                raise BindError(f"Binder Error: {func} takes exactly one argument")
            args = [binder.bind(a) for a in fc.args]
        t = _agg_result_type(func, args)
        # dedup structurally identical aggregates
        for a in aggs:
            if (a.func == func and len(a.args) == len(args)
                    and all(_bound_eq(x, y) for x, y in zip(a.args, args))):
                return B.BoundAggregateRef(a.key, a.ltype)
        key = self.fresh(f"agg.{func}")
        aggs.append(B.BoundAggregate(func, args, False, t, key))
        return B.BoundAggregateRef(key, t)

    def _plan_order(self, plan, order_items, output, scope_info):
        out_scope, post_binder = scope_info
        items = []
        for it in order_items:
            e = it.expr
            be = None
            if isinstance(e, N.Literal) and isinstance(e.value, int):
                _, key, t = output[e.value - 1]
                be = B.BoundColumnRef(key, t)
            elif isinstance(e, N.ColumnRef) and len(e.parts) == 1:
                b = out_scope.try_resolve(e.parts)
                if b is not None:
                    be = B.BoundColumnRef(b.key, b.ltype)
            if be is None:
                be = post_binder.bind(e)
            items.append((be, it.descending, it.nulls_first))
        return P.Order(plan, items)


def _contains_aggregate(e: N.Expr) -> bool:
    if isinstance(e, N.FunctionCall):
        if e.name.lower() in AGGREGATE_NAMES or e.is_star:
            return True
        return any(_contains_aggregate(a) for a in e.args)
    for f_name in getattr(e, "__dataclass_fields__", {}):
        v = getattr(e, f_name)
        if isinstance(v, N.Expr) and _contains_aggregate(v):
            return True
        if isinstance(v, list):
            for x in v:
                if isinstance(x, N.Expr) and _contains_aggregate(x):
                    return True
                if isinstance(x, tuple) and any(
                        isinstance(y, N.Expr) and _contains_aggregate(y) for y in x):
                    return True
    return False


def _bound_eq(a: B.BoundExpr, b: B.BoundExpr) -> bool:
    if type(a) is not type(b):
        return False
    if isinstance(a, B.BoundColumnRef):
        return a.key == b.key
    if isinstance(a, B.BoundLiteral):
        return a.value == b.value and a.ltype == b.ltype
    ca, cb = a.children(), b.children()
    if len(ca) != len(cb):
        return False
    core_a = {k: v for k, v in a.__dict__.items() if not isinstance(v, (B.BoundExpr, list))}
    core_b = {k: v for k, v in b.__dict__.items() if not isinstance(v, (B.BoundExpr, list))}
    return core_a == core_b and all(_bound_eq(x, y) for x, y in zip(ca, cb))


def _agg_result_type(func: str, args) -> LogicalType:
    if func in ("count", "count_star"):
        return BIGINT
    t = args[0].ltype if args else SQLNULL
    if func == "sum":
        if t.id is TypeId.DECIMAL:
            return decimal(38, t.scale)
        if t.is_float:
            return DOUBLE
        if t.is_integer or t.id is TypeId.BOOLEAN:
            # the reference promotes every integer sum to HUGEINT
            # (core_functions/aggregate/distributive/sum.cpp); the (lo, hi)
            # wide-sum planes carry the value
            return HUGEINT
        return BIGINT
    if func == "avg":
        return DOUBLE
    return t  # min / max


class _PostAggBinder(ExprBinder):
    """Binds select/having/order expressions after aggregation.

    Subtrees matching a GROUP BY expression become refs to the group output;
    aggregate calls route to the collector.
    """

    def __init__(self, scope, group_lookup, collector):
        super().__init__(scope, agg_collector=collector)
        self.group_lookup = group_lookup

    def bind(self, e: N.Expr) -> B.BoundExpr:
        for ast, key, t in self.group_lookup:
            if ast is not None and _ast_eq(ast, e, self.scope):
                return B.BoundColumnRef(key, t)
        return super().bind(e)


def _ast_eq(a: N.Expr, b: N.Expr, scope: Scope) -> bool:
    if isinstance(a, N.ColumnRef) and isinstance(b, N.ColumnRef):
        ba = scope.try_resolve(a.parts)
        bb = scope.try_resolve(b.parts)
        return ba is not None and bb is not None and ba.key == bb.key
    return a == b


def _default_name(e: N.Expr) -> str:
    if isinstance(e, N.ColumnRef):
        return e.parts[-1]
    if isinstance(e, N.FunctionCall):
        return e.name.lower()
    if isinstance(e, N.CastExpr):
        return _default_name(e.child)
    return "expr"


def plan_select(catalog, stmt: N.SelectStatement):
    return Planner(catalog).plan_select(stmt)
