"""Statement planner: parsed AST → plan tree.

As in the JAX package (duckdb_tpu/planner/planner.py), FROM flattens into
a pool of atoms (base tables, derived tables, CTE references, comma lists,
[INNER] JOIN … ON); WHERE and ON conjuncts, with the terms common to every
branch of an OR hoisted out (`hoist_or_common`), over one atom become
filters on it; the joins are ordered by the DP of planner/join_order.py
for three or more atoms, else by the greedy probe spine with its snowflake
collapse, and become inner equi-Join nodes. A LEFT, RIGHT (normalized to
LEFT with the sides swapped), FULL, SEMI or ANTI JOIN plans each side as a
pool of its own and becomes one atom. A CTE referenced once is inlined as
a derived table; one referenced more often is executed once at plan time
into a hidden catalog table on the catalog's device.
WHERE-level subqueries are flattened (`_flatten_conjunct`): EXISTS, NOT
EXISTS, IN and NOT IN become semi/anti (null-aware for NOT IN) Join nodes
stacked on the pool, a correlated scalar aggregate becomes a grouped
aggregate atom joined on its correlation keys (a LEFT join stacked on the
pool where its value over no rows is not NULL), and an uncorrelated
scalar subquery becomes a constant computed once (`BoundScalarSubquery`).
IN and EXISTS anywhere else (the SELECT list, CASE, OR) are MARK joins
(`BoundMarkSubquery`): the build runs once, the membership on the device.
No FROM (SELECT 1, IN (SELECT 1)) is one constant row (`ConstantRow`).
On top come GROUP BY with aggregates, HAVING, the projection, DISTINCT,
ORDER BY and LIMIT/OFFSET. Keys, output names and join orders match the
reference's for these shapes, as do its aggregate aliases and the FILTER
clause's rewrite into CASE WHEN. Set operations concatenate their inputs
(`SetOp`); UNION dedups by grouping, and INTERSECT / EXCEPT group both
sides together and keep each tuple as often as SQL's multiset rules say
(`Multiplicity`). VALUES is a UNION ALL of constant rows, and the
parser's GROUPING SETS / ROLLUP / CUBE desugar to UNION ALL. WITH
RECURSIVE iterates to a fixpoint at plan time through hidden tables.
Atoms that no equality connects join by an inequality join (a keyless
Join) or a CrossJoin; ASOF, POSITIONAL, USING and NATURAL joins are
planned here too, USING to DuckDB's rules for every join type. The table
functions range, generate_series and repeat, duckdb_functions() and the
catalog functions become hidden tables that live as long as the plan
(range's column made on the device); a plan that snapshots the catalog
is `uncacheable`. Window functions, with their ORDER BY, PARTITION BY
and ROWS or RANGE frame, become one Window node over the aggregate's
output; QUALIFY is a filter over it and reads select aliases, and
DISTINCT ON keeps the rows that row_number() over the ON keys, in the
statement's ORDER BY order, numbers 1. LATERAL is not yet ported and says
so.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from duckdb_tpu_torch.blocks import Column, pad_bucket
from duckdb_tpu_torch.blocks.nested import UNSORTED_DICT_IDS
from duckdb_tpu_torch.sql import nodes as N
from duckdb_tpu_torch.catalog.catalog import qualify
from duckdb_tpu_torch.planner import bound as B
from duckdb_tpu_torch.planner import macros as M
from duckdb_tpu_torch.planner import plan as P
from duckdb_tpu_torch.planner.binder import (
    AGGREGATE_NAMES,
    BindError,
    Binding,
    ColumnNotFound,
    ExprBinder,
    KeyRef,
    Scope,
)
from duckdb_tpu_torch.execution.aggregate_exec import NESTED_RESULT_AGGS, VARIANCE_AGGS
from duckdb_tpu_torch.execution.aggregate_stats import STAT_AGGS
from duckdb_tpu_torch.planner.bound import not_ported
from duckdb_tpu_torch.types import (
    BIGINT,
    BOOLEAN,
    DOUBLE,
    HUGEINT,
    INTEGER,
    SQLNULL,
    VARCHAR,
    LogicalType,
    TypeId,
    decimal,
    list_of,
    map_of,
    max_logical_type,
    struct_of,
)

# aggregates the port computes: sum, count, avg and min/max over numbers
# fuse (execution/fused_agg.py), every other takes the general path
# (execution/aggregate_exec.py, aggregate_stats.py)
_PORTED_AGGS = {
    "sum", "count", "count_star", "avg", "min", "max", "fsum", "bool_and", "bool_or",
    "first", "last", "any_value", "arg_min", "arg_max", "arg_min_null", "arg_max_null",
    "product", "median", "quantile_cont", "quantile_disc", "mode", "stddev",
    "stddev_samp", "stddev_pop", "var_samp", "var_pop", "variance",
    "bit_and", "bit_or", "bit_xor", "approx_count_distinct",
} | STAT_AGGS | NESTED_RESULT_AGGS

# window functions over the whole partition only: with an ORDER BY or a
# frame they wait for ROADMAP item 44
_HOLISTIC_WINDOWS = ("median", "quantile_cont", "stddev", "stddev_samp", "stddev_pop",
                     "var_samp", "var_pop", "variance")
# window functions that take DISTINCT and FILTER, and those over HUGEINT
# values (a hi/lo pair; window_exec carries both halves)
_FILTER_WINDOWS = ("count", "sum", "avg", "min", "max") + _HOLISTIC_WINDOWS
_WIDE_WINDOWS = ("count", "sum", "avg", "min", "max", "lag", "lead", "first_value",
                 "last_value", "nth_value")

# the reference's aggregate aliases (duckdb_tpu/planner/planner.py)
_AGG_ALIASES = {
    "mean": "avg", "group_concat": "string_agg", "listagg": "string_agg",
    "quantile": "quantile_disc", "approx_quantile": "quantile_cont",
    "arbitrary": "first", "argmax": "arg_max", "argmin": "arg_min", "max_by": "arg_max",
    "min_by": "arg_min", "favg": "avg", "sumkahan": "fsum", "kahan_sum": "fsum",
    "sum_no_overflow": "sum", "reservoir_quantile": "quantile_disc",
    # NULL by-values sort last, as the base arg_min/arg_max already do
    "arg_max_nulls_last": "arg_max", "arg_min_nulls_last": "arg_min",
}

_AGG_ARITY = {"arg_min": 2, "arg_max": 2, "arg_min_null": 2, "arg_max_null": 2,
              "corr": 2, "covar_pop": 2, "covar_samp": 2, "regr_slope": 2,
              "regr_intercept": 2, "regr_r2": 2, "regr_count": 2, "regr_avgx": 2,
              "regr_avgy": 2, "regr_sxx": 2, "regr_syy": 2, "regr_sxy": 2}


@dataclass
class BoundScalarSubquery(B.BoundExpr):
    """Uncorrelated scalar subquery: executed once, on first eval, by a
    nested executor on the catalog's device. The value stays on the bound
    node, so a plan served from the plan cache reuses it."""

    planner: "Planner"
    plan: P.PlanNode
    out_key: str
    ltype: LogicalType

    def eval(self, env):
        return B.BoundLiteral(self.const_value(), self.ltype).eval(env)

    def is_const(self):
        return True

    def const_value(self):
        if not hasattr(self, "_value"):
            from duckdb_tpu_torch.execution.executor import Executor

            ex = Executor(self.planner.catalog, self.planner.routes)
            res = ex.run(self.plan, [("v", self.out_key, self.ltype)])
            self._value = None
            if res.nrows:
                vals, valid, dvals = res.columns[0]
                if valid is not None and not valid[0]:
                    self._value = None
                elif self.ltype.id is TypeId.VARCHAR:
                    self._value = str(dvals[vals[0]])
                elif self.ltype.is_float:
                    self._value = float(vals[0])
                else:
                    self._value = int(vals[0])
        return self._value


@dataclass
class BoundMarkSubquery(B.BoundExpr):
    """A MARK join as an expression: `x IN (subquery)` or `EXISTS
    (subquery)` anywhere an expression may stand (DuckDB's MARK join,
    join_hashtable.cpp). The mark is TRUE on a match; FALSE against a
    build without NULLs; NULL where the probe value is NULL or the build
    holds a NULL (and the build is not empty). A correlated EXISTS
    rewritten as membership (`exists_semantics`) is two-valued. The build
    runs once, on first eval, on the catalog's device; the membership
    test runs there too."""

    planner: "Planner"
    expr: Optional[B.BoundExpr]  # None: EXISTS, an emptiness test
    plan: P.PlanNode
    out_key: str
    out_type: LogicalType
    negated: bool
    exists_semantics: bool = False
    ltype: LogicalType = BOOLEAN

    def children(self):
        return [self.expr] if self.expr is not None else []

    def _build(self):
        """→ ((the build's Column, the mask of its live valid rows),
        whether a live build value is NULL, whether the build is empty)."""
        if not hasattr(self, "_vals"):
            from duckdb_tpu_torch.execution.executor import Executor

            ex = Executor(self.planner.catalog, self.planner.routes)
            self.planner.routes["mark_build"] += 1
            n, cols = ex.materialize(self.plan, [("v", self.out_key, self.out_type)])
            c = cols[0]
            live = torch.arange(c.data.shape[0], device=c.data.device) < n
            valid = live if c.validity is None else live & c.validity
            self._vals = (c, valid)
            self._has_null = bool((live & ~valid).any())
            self._empty = n == 0
        return self._vals, self._has_null, self._empty

    def eval(self, env):
        (bc, bvalid), has_null, empty = self._build()
        plen = env.plen
        device = env.live.device
        if self.expr is None:  # EXISTS
            return Column(data=torch.full((plen,), empty == self.negated, dtype=torch.bool,
                                          device=device), ltype=BOOLEAN)
        c = self.expr.eval(env)
        x = B.bcast(c.data, plen)
        if c.ltype.id is TypeId.VARCHAR:
            # each distinct probe string against the build's string set
            probe_d = c.dict_values if c.dict_values is not None else np.empty(0, object)
            codes = bc.data[bvalid].long().unique().cpu().numpy()
            bset = set() if bc.dict_values is None else \
                set(np.asarray(bc.dict_values)[codes].astype(str).tolist())
            lut = torch.tensor([str(v) in bset for v in probe_d] or [False],
                               dtype=torch.bool, device=device)
            match = lut[x.long().clamp(0, lut.shape[0] - 1)]
        else:
            s1 = c.ltype.scale if c.ltype.id is TypeId.DECIMAL else 0
            s2 = self.out_type.scale if self.out_type.id is TypeId.DECIMAL else 0
            if c.ltype.is_float or self.out_type.is_float:
                xv = x.to(torch.float64) / 10.0 ** s1
                bv = bc.data[bvalid].to(torch.float64) / 10.0 ** s2
            else:
                # the integer families at one DECIMAL scale (exact)
                sm = max(s1, s2)
                xv = x.to(torch.int64) * 10 ** (sm - s1)
                bv = bc.data[bvalid].to(torch.int64) * 10 ** (sm - s2)
            # the build lives on the catalog's device; a shard's rows may not
            match = torch.isin(xv, torch.unique(bv).to(device))
        x_valid = None if c.validity is None else B.bcast(c.validity, plen)
        if self.exists_semantics:
            # EXISTS as membership: a NULL probe matches nothing
            if x_valid is not None:
                match = match & x_valid
            return Column(data=match ^ self.negated, ltype=BOOLEAN)
        if empty:
            # IN over no rows is FALSE for every probe, NULL included
            return Column(data=torch.full((plen,), self.negated, dtype=torch.bool,
                                          device=device), ltype=BOOLEAN)
        x_null = torch.zeros(plen, dtype=torch.bool, device=device) if x_valid is None \
            else ~x_valid
        unknown = ~match & (x_null | has_null)
        return Column(data=match ^ self.negated, ltype=BOOLEAN, validity=~unknown)


@dataclass
class SemiSpec:
    jtype: str  # semi | anti | left (a correlated scalar subquery's)
    build_plan: P.PlanNode
    probe_keys: List[B.BoundExpr]  # over outer columns
    build_keys: List[B.BoundExpr]  # over subquery columns
    extra: Optional[B.BoundExpr]  # residual over combined columns
    null_aware: bool = False  # NOT IN semantics
    # the conjunct that reads the left join's build columns, applied on top
    post_filter: Optional[B.BoundExpr] = None


def split_conjuncts(e: Optional[N.Expr]) -> List[N.Expr]:
    if e is None:
        return []
    if isinstance(e, N.Conjunction) and e.op == "and":
        out = []
        for c in e.children:
            out.extend(split_conjuncts(c))
        return out
    return [e]


def hoist_or_common(ast: N.Expr) -> List[N.Expr]:
    """OR(A∧X, A∧Y) → [A, OR(X, Y)] — exposes join edges hidden inside OR
    branches (Q19 shape; the reference's filter-combiner does the same,
    src/optimizer/filter_combiner.cpp)."""
    if not (isinstance(ast, N.Conjunction) and ast.op == "or"):
        return [ast]
    branch_lists = [split_conjuncts(b) for b in ast.children]
    common = [c for c in branch_lists[0]
              if all(any(c == d for d in bl) for bl in branch_lists[1:])]
    implied = _implied_in_filters(branch_lists)
    if not common:
        return implied + [ast]
    rest_branches = []
    for bl in branch_lists:
        rest = [c for c in bl if not any(c == d for d in common)]
        if not rest:
            return common  # one branch is exactly the common set → OR is implied
        rest_branches.append(rest[0] if len(rest) == 1
                             else N.Conjunction("and", rest))
    return implied + common + [N.Conjunction("or", rest_branches)]


def _implied_in_filters(branch_lists) -> List[N.Expr]:
    """Derive redundant single-column filters implied by an OR of
    conjunctions: if EVERY branch pins column c to a literal (c = v, or
    c IN (vs)), then `c IN (union of values)` holds whenever the OR does.
    The derived filter pushes into c's atom — turning the q07 nation-pair
    OR into restrictive dimension builds — while the original OR stays
    for exactness (reference filter_combiner derives the same class)."""
    def eq_map(conj):
        out = {}
        for c in conj:
            if (isinstance(c, N.BinaryOp) and c.op == "="
                    and isinstance(c.left, N.ColumnRef)
                    and isinstance(c.right, N.Literal)):
                ref, vals = c.left, [c.right]
            elif (isinstance(c, N.BinaryOp) and c.op == "="
                    and isinstance(c.right, N.ColumnRef)
                    and isinstance(c.left, N.Literal)):
                ref, vals = c.right, [c.left]
            elif (isinstance(c, N.InList) and not c.negated
                    and isinstance(c.expr, N.ColumnRef)
                    and all(isinstance(i, N.Literal) for i in c.items)):
                ref, vals = c.expr, list(c.items)
            else:
                continue
            key = tuple(p.lower() for p in ref.parts)
            out.setdefault(key, (ref, []))[1].extend(vals)
        return out
    maps = [eq_map(bl) for bl in branch_lists]
    derived = []
    for colkey, (ref, vals) in maps[0].items():
        seen, items = set(), []
        for m in maps:
            if colkey not in m:
                items = None
                break
            for v in m[colkey][1]:
                if repr(v.value) not in seen:
                    seen.add(repr(v.value))
                    items.append(v)
        if items:
            derived.append(N.InList(ref, items) if len(items) > 1
                           else N.BinaryOp("=", ref, items[0]))
    return derived


def _hoisted(asts: List[N.Expr]) -> List[N.Expr]:
    return [h for p in asts for h in hoist_or_common(p)]


@dataclass
class Atom:
    id: int
    plan: P.PlanNode
    rows: int  # cardinality estimate (table rows, scaled by pushed filters)
    keys: Set[str]  # binding keys this atom provides
    # key → (catalog table, column) for base-scan atoms; drives the
    # fanout estimate in the greedy join order (PK edge ⇒ fanout 1)
    col_of: Dict[str, Tuple[str, str]] = field(default_factory=dict)
    # UNFILTERED base-table rows: pushed filters scale `rows` down, but
    # probe-spine orientation follows the base table size (a filtered fact
    # side as BUILD = duplicate keys = no fused pipeline)
    base_rows: int = 0

    def __post_init__(self):
        if not self.base_rows:
            self.base_rows = self.rows



def _requalify(node, alias: str, catalog):
    """An attached view's body with each unqualified table name that the
    attached database holds qualified by its alias (the view binds in its
    own database's catalog)."""
    if isinstance(node, N.BaseTableRef) and not node.schema:
        q = f"{alias}.{node.name.lower()}"
        if q in catalog.tables or q in catalog.views:
            return dataclasses.replace(node, schema=alias)
        return node
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        kw = {f.name: _requalify(getattr(node, f.name), alias, catalog)
              for f in dataclasses.fields(node)}
        if all(kw[f.name] is getattr(node, f.name) for f in dataclasses.fields(node)):
            return node
        return dataclasses.replace(node, **kw)
    if isinstance(node, list):
        return [_requalify(v, alias, catalog) for v in node]
    if isinstance(node, tuple):
        return tuple(_requalify(v, alias, catalog) for v in node)
    return node

class Planner:
    def __init__(self, catalog, routes=None, temp_views=None, default_schema: str = "main"):
        self.catalog = catalog
        # the connection's TEMPORARY views (name → SELECT statement) and its
        # USE schema, searched first for an unqualified name
        self.temp_views = temp_views or {}
        self.default_schema = default_schema
        # the Counter that plan-time executions (scalar subqueries,
        # materialized CTEs) report routes to: the connection's
        self.routes = collections.Counter() if routes is None else routes
        self._key_counter = itertools.count()
        self._cte_use_count: Dict[str, int] = {}
        # the hidden tables this planner's materialized CTEs created: their
        # lifetime is the plan's, so the owner of the plan drops them
        self.hidden_tables: List[str] = []
        # set when the plan snapshots the catalog (duckdb_tables() and
        # the like): the connection must not cache it
        self.uncacheable = False
        # [(arguments, Catalog.file_key, table)] of each file read the plan
        # makes: the connection runs a cached plan only while each key still
        # holds and the catalog still has the table
        self.file_reads: List[tuple] = []

    def fresh(self, name: str) -> str:
        return f"{name}#{next(self._key_counter)}"

    # -- entry ---------------------------------------------------------------
    def plan_select(self, stmt: N.SelectStatement, outer_scope=None,
                    cte_scope: Optional[dict] = None):
        """→ (plan, output [(name, key, ltype)])."""
        ctes = dict(cte_scope or {})
        for cte in stmt.ctes:
            ctes[cte.name.lower()] = cte
            self._cte_use_count[cte.name.lower()] = self._count_cte_refs(
                stmt, cte.name.lower())
        plan, output, scope = self.plan_query_node(stmt.node, outer_scope, ctes,
                                                   order_by=stmt.order_by)
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

    # -- set operations --------------------------------------------------------
    def plan_query_node(self, node, outer_scope, ctes, order_by=()):
        """A SELECT, a set operation or VALUES → (plan, output, scope info).
        `order_by` is the statement's ORDER BY, which a SELECT's DISTINCT ON
        reads."""
        if isinstance(node, N.ValuesNode):
            # VALUES (…), (…): a UNION ALL of one-row SELECTs, its columns
            # named col0, col1, … as DuckDB names them
            widths = {len(r) for r in node.rows}
            if len(widths) != 1:
                raise BindError("Binder Error: VALUES lists must all be the same length")
            branches = [N.SelectNode(select_list=[(e, f"col{i}") for i, e in enumerate(r)])
                        for r in node.rows]
            return self._plan_setop_inputs("union", True, [
                self.plan_select_node(b, outer_scope, ctes)[:2] for b in branches])
        if isinstance(node, N.SelectNode):
            return self.plan_select_node(node, outer_scope, ctes, order_by)
        if isinstance(node, N.SetOpNode):
            if node.op == "union" and node.all:
                # a chain of UNION ALL is one n-ary concatenation
                leaves = []

                def flatten(n):
                    if isinstance(n, N.SetOpNode) and n.op == "union" and n.all:
                        flatten(n.left)
                        flatten(n.right)
                    else:
                        leaves.append(n)

                flatten(node)
            else:
                leaves = [node.left, node.right]
            return self._plan_setop_inputs(node.op, node.all, [
                self.plan_query_node(n, outer_scope, ctes)[:2] for n in leaves])
        raise not_ported(f"the query form {type(node).__name__}")

    def _plan_setop_inputs(self, op: str, all_: bool, inputs):
        """UNION / INTERSECT / EXCEPT [ALL] of planned inputs [(plan,
        output)]: names from the first input, each column's type the widest
        of its inputs'. INTERSECT and EXCEPT match NULL to NULL and keep
        SQL's multiplicities (`Multiplicity`)."""
        width = len(inputs[0][1])
        if any(len(o) != width for _, o in inputs):
            raise BindError("Binder Error: Set operations can only apply to expressions "
                            "with the same number of result columns")
        types = []
        for i in range(width):
            t = SQLNULL
            for _, o in inputs:
                t = max_logical_type(t, o[i][2])
            types.append(t)
        keys = [self.fresh("setop") for _ in range(width)]
        tags = []
        if op in ("intersect", "except"):
            # each side counts its rows in a column of its own
            tags = [self.fresh("setop_left"), self.fresh("setop_right")]
        projected = []
        for side, (plan, out) in enumerate(inputs):
            items = []
            for key, (_, k, t), want in zip(keys, out, types):
                e: B.BoundExpr = B.BoundColumnRef(k, t)
                if t != want:
                    e = B.BoundCast(e, want)
                items.append((key, e))
            for ti, tag in enumerate(tags):
                items.append((tag, B.BoundLiteral(1 if ti == side else None, INTEGER)))
            projected.append(P.Project(plan, items))
        set_keys = [(k, t) for k, t in zip(keys, types)] + [(t, INTEGER) for t in tags]
        plan: P.PlanNode = P.SetOp(projected, set_keys)
        groups = [(k, B.BoundColumnRef(k, t)) for k, t in zip(keys, types)]
        if op == "union" and not all_:
            plan = P.Aggregate(plan, groups, [])
        elif op in ("intersect", "except"):
            counts = [self.fresh("setop_count") for _ in tags]
            aggs = [B.BoundAggregate("count", [B.BoundColumnRef(tag, INTEGER)], False, BIGINT,
                                     ck) for tag, ck in zip(tags, counts)]
            plan = P.Multiplicity(P.Aggregate(plan, groups, aggs), op, all_, *counts)
        output = [(nm, k, t) for (nm, _, _), k, t in zip(inputs[0][1], keys, types)]
        out_scope = Scope()
        for nm, k, t in output:
            out_scope.add("", nm, k, t)
        return plan, output, (out_scope, ExprBinder(out_scope))

    # -- FROM planning -------------------------------------------------------
    def _count_cte_refs(self, obj, name: str) -> int:
        """Count table references to `name` in an AST subtree."""
        n = 0
        if isinstance(obj, N.BaseTableRef) and obj.name.lower() == name:
            n += 1
        if hasattr(obj, "__dataclass_fields__"):
            for f in obj.__dataclass_fields__:
                v = getattr(obj, f)
                if isinstance(v, (list, tuple)):
                    for x in v:
                        n += self._count_cte_refs(x, name)
                        if isinstance(x, tuple):
                            for y in x:
                                n += self._count_cte_refs(y, name)
                elif hasattr(v, "__dataclass_fields__"):
                    n += self._count_cte_refs(v, name)
        return n

    def _plan_base_table(self, ref: N.BaseTableRef, ctes):
        """→ (plan, scope additions [(alias, col, key, type)], rows, catalog
        table or None). `FROM t a(x, y)` alias column lists rename the
        visible columns (reference: binder table alias handling,
        src/planner/binder/tableref/bind_basetableref.cpp)."""
        plan, scope_adds, nrows, table = self._plan_base_table_inner(ref, ctes)
        if ref.sample is not None:
            # TABLESAMPLE samples the scan; zone maps no longer bound it
            plan, table = self._plan_sample(plan, ref.sample), None
        if ref.column_aliases:
            scope_adds = [
                (a, ref.column_aliases[i] if i < len(ref.column_aliases) else c, k, t)
                for i, (a, c, k, t) in enumerate(scope_adds)]
        return plan, scope_adds, nrows, table

    def _plan_base_table_inner(self, ref: N.BaseTableRef, ctes):
        name = ref.name.lower()
        alias = (ref.alias or ref.name).lower()
        if ref.schema is None and name in ctes:
            cte = ctes[name]
            sub_ctes = {k: v for k, v in ctes.items() if k != name}
            # a CTE referenced more than once is executed once (the
            # reference's materialized CTE, src/execution/physical_plan/
            # plan_cte.cpp); its hidden table is remembered on the CTE node
            # for the statement's other references
            if getattr(cte, "_mat_table", None):
                return self._scan_of(cte._mat_table, alias) + (None,)
            if cte.recursive and isinstance(cte.query.node, N.SetOpNode) \
                    and cte.query.node.op == "union":
                cte._mat_table = self._materialize_recursive_cte(name, cte, sub_ctes)
                return self._scan_of(cte._mat_table, alias) + (None,)
            if cte.materialized is not False and self._cte_use_count.get(name, 0) > 1:
                plan, output = self.plan_select(cte.query, None, sub_ctes)
                cte._mat_table = self._materialize_plan(
                    f"__cte_{name}", plan, output, list(cte.column_aliases) or None)
                return self._scan_of(cte._mat_table, alias) + (None,)
            plan, output = self.plan_select(cte.query, None, sub_ctes)
            return self._subquery_atom(plan, output, alias,
                                       list(cte.column_aliases) or None) + (None,)
        qname = (f"{ref.schema}.{ref.name}" if ref.schema else ref.name).lower()
        if ref.schema is None and self.default_schema != "main":
            q = f"{self.default_schema}.{name}"
            if self.catalog.has_table(q) or qualify(q) in self.catalog.views:
                qname = q
        if self.catalog.has_table(qname):
            plan, scope_adds, nrows = self._scan_of(qname, alias)
            return plan, scope_adds, nrows, plan.table
        view = self.temp_views.get(qname) if ref.schema is None else None
        if view is None:
            view = self.catalog.views.get(qualify(qname))
        if view is not None:
            # a view is planned anew at every use, from a copy of its
            # statement (planning marks CTE nodes), with the macros expanded;
            # its body does not see the caller's CTEs
            body = copy.deepcopy(view)
            head = (ref.schema or "").lower()
            if head in getattr(self.catalog, "attached", {}):
                # an attached database's view names the tables of its own
                # database: qualify them with the alias
                body = _requalify(body, head, self.catalog)
            body = M.expand_macros(body, self.macros())
            plan, output = self.plan_select(body, None, {})
            return self._subquery_atom(plan, output, alias, None) + (None,)
        raise BindError(f"Catalog Error: Table with name {ref.name} does not exist!")

    def macros(self) -> dict:
        """The default macros and the catalog's CREATE MACRO ones."""
        user = getattr(self.catalog, "macros", None)
        return {**M.default_macros(), **user} if user else M.default_macros()

    def _scan_of(self, tname: str, alias: str):
        entry = self.catalog.get_table(tname)
        cols = []
        scope_adds = []
        for cd in entry.columns:
            key = self.fresh(f"{alias}.{cd.name}")
            cols.append((cd.name, key, cd.ltype))
            scope_adds.append((alias, cd.name, key, cd.ltype))
        return P.Scan(entry.name, alias, cols), scope_adds, entry.nrows

    def _materialize_plan(self, base_name, plan, output, col_aliases) -> str:
        """Execute a plan now, on the catalog's device, and register its
        rows as a hidden table whose columns stay there."""
        from duckdb_tpu_torch.execution.executor import Executor

        nrows, columns = Executor(self.catalog, self.routes).materialize(plan, output)
        # the alias where there is one, else the output name, as the inlined
        # path (_subquery_atom) names them
        names = [col_aliases[i] if col_aliases and i < len(col_aliases) else nm
                 for i, (nm, _, _) in enumerate(output)]
        name = self._register_rows(base_name, names, [t for _, _, t in output], nrows,
                                   columns)
        self.hidden_tables.append(name)
        self.routes["cte_materialized"] += 1
        return name

    def _register_rows(self, base_name, names, types, nrows, columns) -> str:
        """Register device columns (packed, padded as a table's are) as the
        catalog table `{base_name}_{n}`, the first n free → its name."""
        from duckdb_tpu_torch.catalog.catalog import ColumnDef, TableEntry

        n = 0
        while self.catalog.has_table(f"{base_name}_{n}"):
            n += 1
        entry = TableEntry(f"{base_name}_{n}", [ColumnDef(nm, t) for nm, t in zip(names, types)])
        entry.nrows = nrows
        self.catalog.create_table(entry)
        for cd, col in zip(entry.columns, columns):
            entry.set_device_column(cd.name, col)
        return entry.name

    def _materialize_recursive_cte(self, name: str, cte, sub_ctes) -> str:
        """WITH RECURSIVE to its fixpoint, at plan time (DuckDB's
        physical_recursive_cte.cpp): the anchor's rows, then round after
        round of the recursive term over the last round's rows (the
        working table, a hidden table), until a round adds none. Under
        UNION (not ALL) a round keeps only rows no earlier round gave, so
        a cycle ends. → the hidden table of every round's rows."""
        from duckdb_tpu_torch.execution.executor import Executor, concat_packed

        node = cte.query.node
        distinct = not node.all
        anchor, a_out = self.plan_query_node(node.left, None, sub_ctes)[:2]
        names = (list(cte.column_aliases) + [nm for nm, _, _ in a_out][len(cte.column_aliases):]
                 if cte.column_aliases else [nm for nm, _, _ in a_out])
        types = [t for _, _, t in a_out]
        if distinct:
            anchor = P.Aggregate(anchor, [(k, B.BoundColumnRef(k, t)) for _, k, t in a_out], [])
        n, cols = Executor(self.catalog, self.routes).materialize(anchor, a_out)
        parts = [(n, cols)]
        work_tables = []
        try:
            rounds = 0
            while n and rounds < self.RECURSION_LIMIT:
                rounds += 1
                work = self._register_rows(f"__recursive_{name}", names, types, n, cols)
                work_tables.append(work)
                rec = N.CTE(name, None, tuple(names))
                rec._mat_table = work
                plan, out = self.plan_query_node(node.right, None, {**sub_ctes, name: rec})[:2]
                if len(out) != len(types):
                    raise BindError("Binder Error: the recursive term of a recursive CTE must "
                                    "give as many columns as its anchor")
                keys = [self.fresh("rec") for _ in types]
                plan = P.Project(plan, [(k, B.BoundColumnRef(ok, ot) if ot == t
                                         else B.BoundCast(B.BoundColumnRef(ok, ot), t))
                                        for k, (_, ok, ot), t in zip(keys, out, types)])
                r_out = [(nm, k, t) for nm, k, t in zip(names, keys, types)]
                if distinct:
                    # only the rows that no earlier round gave, once each
                    seen = self._register_rows(f"__recursive_{name}", names, types,
                                               *concat_packed(parts, types))
                    work_tables.append(seen)
                    scan, adds, _ = self._scan_of(seen, "__seen")
                    plan, r_out, _ = self._plan_setop_inputs(
                        "except", False, [(plan, r_out),
                                          (scan, [(nm, k, t) for (_, nm, k, t) in adds])])
                n, cols = Executor(self.catalog, self.routes).materialize(plan, r_out)
                if n:
                    parts.append((n, cols))
                for t in work_tables:
                    self.catalog.drop_table(t)
                work_tables = []
        finally:
            for t in work_tables:
                self.catalog.drop_table(t)
        table = self._register_rows(f"__cte_{name}", names, types, *concat_packed(parts, types))
        self.hidden_tables.append(table)
        self.routes["cte_recursive"] += 1
        return table

    # the most rounds a recursive CTE runs (the JAX package's bound)
    RECURSION_LIMIT = 10_000

    def _subquery_atom(self, plan, output, alias, col_aliases):
        scope_adds = []
        for i, (n, key, t) in enumerate(output):
            cn = col_aliases[i] if col_aliases and i < len(col_aliases) else n
            scope_adds.append((alias, cn, key, t))
        nrows = 10_000  # unknown; middle-of-road estimate
        return plan, scope_adds, nrows

    def _plan_derived(self, sub: N.SelectStatement, ctes, scope: Scope):
        """Plan a derived table (FROM subquery or inlined CTE) with no outer
        scope. One that reads a column of the query around it is LATERAL."""
        try:
            return self.plan_select(sub, None, ctes)
        except ColumnNotFound as err:
            if scope.try_resolve(err.parts) is not None:
                raise not_ported("a correlated derived table (LATERAL)") from err
            raise

    def _plan_sample(self, plan, sample) -> P.Sample:
        """USING SAMPLE / TABLESAMPLE (amount, unit, method, seed) → Sample."""
        amount_ast, unit, method, seed = sample
        be = ExprBinder(Scope()).bind(amount_ast)
        v = be.const_value()
        if be.ltype.id is TypeId.DECIMAL:
            v = v / 10 ** be.ltype.scale
        if unit == "percent":
            if not 0 <= float(v) <= 100:
                raise BindError("Binder Error: Sample rate must be between 0 and 100")
            return P.Sample(plan, percent=float(v), method=method, seed=seed)
        return P.Sample(plan, rows=int(v), method=method, seed=seed)

    def collect_atoms(self, ref: N.TableRef, ctes, scope: Scope, atoms: List[Atom],
                      pred_asts: List[N.Expr]):
        """Flatten a FROM tree into atoms + predicate ASTs. Outer, semi and
        anti joins plan both sides as pools of their own and become one
        atom. No FROM (SELECT 1, IN (SELECT 1)) is one constant live row
        with no columns, as the reference's bind_emptytableref.cpp."""
        if ref is None:
            atoms.append(Atom(len(atoms) + 20_000, P.ConstantRow(), 1, set()))
            return
        if isinstance(ref, N.BaseTableRef):
            plan, scope_adds, nrows, table = self._plan_base_table(ref, ctes)
            self._add_atom(plan, scope_adds, nrows, scope, atoms, table)
            return
        if isinstance(ref, N.SubqueryRef):
            alias = (ref.alias or f"subq{len(atoms)}").lower()
            plan, output = self._plan_derived(ref.subquery, ctes, scope)
            plan2, scope_adds, nrows = self._subquery_atom(
                plan, output, alias, list(ref.column_aliases) or None)
            self._add_atom(plan2, scope_adds, nrows, scope, atoms, None)
            return
        if isinstance(ref, N.JoinRef) and ref.join_type in ("inner", "cross"):
            n0 = len(atoms)
            self.collect_atoms(ref.left, ctes, scope, atoms, pred_asts)
            n1 = len(atoms)
            self.collect_atoms(ref.right, ctes, scope, atoms, pred_asts)
            if ref.condition is not None:
                pred_asts.extend(split_conjuncts(ref.condition))
            lkeys = set().union(*[a.keys for a in atoms[n0:n1]])
            rkeys = set().union(*[a.keys for a in atoms[n1:]])
            for _, lb, rb in self._using_pairs(ref, scope, lkeys, rkeys):
                pred_asts.append(N.BinaryOp("=", KeyRef(lb.key, lb.ltype),
                                            KeyRef(rb.key, rb.ltype)))
            return
        if isinstance(ref, N.JoinRef) and ref.join_type == "positional":
            sides = []
            for side in (ref.left, ref.right):
                side_atoms: List[Atom] = []
                side_preds: List[N.Expr] = []
                self.collect_atoms(side, ctes, scope, side_atoms, side_preds)
                binder = self._pred_binder(scope, ctes)
                sides.append((self.plan_pool(side_atoms, [binder.bind(c) for c in
                                                          _hoisted(side_preds)]),
                              side_atoms))
            keys = set().union(*[a.keys for _, side_atoms in sides for a in side_atoms])
            rows = max(sum(a.rows for a in side_atoms) for _, side_atoms in sides)
            atoms.append(Atom(len(atoms) + 30_000, P.PositionalJoin(sides[0][0], sides[1][0]),
                              max(rows, 1), keys))
            return
        if isinstance(ref, N.JoinRef) and ref.join_type in ("left", "right", "full", "semi",
                                                            "anti", "asof", "asof_left"):
            self._plan_outer_join(ref, ctes, scope, atoms)
            return
        if isinstance(ref, N.JoinRef):
            raise not_ported(f"{ref.join_type.upper()} JOIN")
        if isinstance(ref, N.TableFunctionRef):
            mac = getattr(self.catalog, "table_macros", {}).get(ref.name.lower())
            if mac is not None:
                # a table macro: its arguments go into a copy of its SELECT,
                # planned as a derived table (DuckDB's
                # src/function/table_macro_function.cpp)
                pos, named = M.split_args(ref.args)
                try:
                    body = M.expand_macros(M.expand_call(mac, pos, named), self.macros())
                except M.MacroError as err:
                    raise BindError(str(err)) from None
                sref = N.SubqueryRef(body, alias=ref.alias or ref.name,
                                     column_aliases=ref.column_aliases)
                with M.expansion_guard(ref.name):
                    self.collect_atoms(sref, ctes, scope, atoms, pred_asts)
                return
            plan, scope_adds, nrows = self._plan_table_function(ref)
            self._add_atom(plan, scope_adds, nrows, scope, atoms, plan.table)
            return
        raise not_ported(f"FROM {type(ref).__name__}")

    # the file readers (storage/multi_file.py; __file_scan is FROM 'file')
    # and the named parameters they take
    FILE_FUNCTIONS = ("read_csv", "read_csv_auto", "read_parquet", "parquet_scan", "read_json",
                      "read_json_auto", "read_ndjson", "__file_scan")
    FILE_PARAMETERS = ("filename", "hive_partitioning", "union_by_name")

    def _plan_file_function(self, ref: N.TableFunctionRef):
        """A file reader: the files' hidden table, registered in the
        catalog's file registry (Catalog.ensure_file_table), which owns it.
        The plan records what each read saw (`file_reads`), so that a cached
        plan is not run once a file has changed. → (Scan, scope additions,
        rows)."""
        name = ref.name.lower()
        binder = ExprBinder(Scope())

        def const(a):
            if isinstance(a, N.FunctionCall) and a.name == "list_value":
                return [const(x) for x in a.args]  # ['a.csv', 'b.csv']
            b = binder.bind(a)
            if not b.is_const():
                raise BindError(f"Binder Error: the arguments of {name}() must be constants")
            return b.const_value()

        named, pos = {}, []
        for a in ref.args:
            if isinstance(a, N.BinaryOp) and a.op in (":=", "=>", "=", "==") \
                    and isinstance(a.left, N.ColumnRef):
                named[a.left.parts[-1].lower()] = const(a.right)
            else:
                pos.append(a)
        for pname in named:
            if pname not in self.FILE_PARAMETERS:
                raise BindError(f'Binder Error: Invalid named parameter "{pname}" for function '
                                f"{name}; accepted: {', '.join(self.FILE_PARAMETERS)}")
        if len(pos) != 1:
            raise BindError(f"Binder Error: {name}() takes one path, a glob or a list of them")
        paths = const(pos[0])
        if not isinstance(paths, (list, tuple)):
            paths = str(paths)
        args = (paths, bool(named.get("union_by_name", False)),
                named.get("hive_partitioning"), bool(named.get("filename", False)))
        tname, key = self.catalog.ensure_file_table(*args)
        self.file_reads.append((args, key, tname))
        plan, scope_adds, nrows = self._scan_of(tname, (ref.alias or name).lower())
        if ref.column_aliases:
            scope_adds = [(a, ref.column_aliases[i] if i < len(ref.column_aliases) else c, k, t)
                          for i, (a, c, k, t) in enumerate(scope_adds)]
        return plan, scope_adds, nrows

    def _plan_table_function(self, ref: N.TableFunctionRef):
        """range, generate_series and repeat (DuckDB's src/function/table/
        range.cpp, repeat.cpp), duckdb_functions() and the catalog
        functions, as a hidden table that lives as long as the plan →
        (Scan, scope additions, rows)."""
        from duckdb_tpu_torch.catalog.catalog import ColumnDef, ColumnStats, TableEntry

        name = ref.name.lower()
        if name in self.FILE_FUNCTIONS:
            return self._plan_file_function(ref)
        binder = ExprBinder(Scope())
        args = []
        for a in ref.args:
            if isinstance(a, N.BinaryOp) and a.op in (":=", "=>"):
                raise BindError(f"Binder Error: Invalid named parameter for function {name}")
            b = binder.bind(a)
            if not b.is_const():
                raise BindError(f"Binder Error: the arguments of {name}() must be constants")
            args.append(b)
        n = 0
        while self.catalog.has_table(f"__{name}_{n}"):
            n += 1
        tname = f"__{name}_{n}"
        device = self.catalog.device
        if name in ("range", "generate_series"):
            if not 1 <= len(args) <= 3 or not all(a.ltype.is_integer for a in args):
                raise not_ported(f"{name}() over {[str(a.ltype) for a in args]} "
                                 "(the integer forms are ported)")
            vals = [int(a.const_value()) for a in args]
            lo, hi, step = (0, vals[0], 1) if len(vals) == 1 else \
                (vals[0], vals[1], vals[2] if len(vals) > 2 else 1)
            if step == 0:
                raise BindError("Binder Error: the step of range() cannot be 0")
            if name == "generate_series":
                hi += 1 if step > 0 else -1  # an inclusive end
            count = max(0, -(-(hi - lo) // step))
            entry = TableEntry(tname, [ColumnDef(name, BIGINT)])
            entry.nrows = count
            self.catalog.create_table(entry)
            # the column is made on the card: arange, padded
            data = torch.zeros(pad_bucket(count), dtype=torch.int64, device=device)
            data[:count] = torch.arange(lo, lo + count * step, step, dtype=torch.int64,
                                        device=device)
            last = lo + (count - 1) * step
            entry.set_generated_column(name, Column(data=data, ltype=BIGINT), ColumnStats(
                min_val=min(lo, last) if count else None,
                max_val=max(lo, last) if count else None, n_unique=count))
        elif name == "repeat":
            if len(args) != 2:
                raise BindError("Binder Error: repeat() takes a value and a count")
            value, t = args[0].const_value(), args[0].ltype
            count = max(0, int(args[1].const_value()))
            if t.id is TypeId.SQLNULL:
                t = INTEGER
            entry = TableEntry(tname, [ColumnDef("repeat", t)])
            entry.nrows = count
            self.catalog.create_table(entry)
            validity = None if value is not None else np.zeros(count, dtype=bool)
            if t.id is TypeId.VARCHAR:
                entry.set_host_column("repeat", np.zeros(count, np.int32), validity,
                                      np.array(["" if value is None else str(value)],
                                               dtype=object))
            elif t.id in (TypeId.LIST, TypeId.STRUCT, TypeId.MAP, TypeId.ARRAY):
                raise not_ported(f"repeat() of a {t}")
            else:
                entry.set_host_column("repeat", np.full(count, 0 if value is None else value,
                                                        dtype=t.np_dtype), validity)
        elif name in self._CATALOG_FUNCTIONS:
            self._catalog_table_function(tname, name, args)
        elif name == "duckdb_functions":
            if args:
                raise BindError("Binder Error: duckdb_functions() takes no arguments")
            from duckdb_tpu_torch.planner.function_catalog import function_types

            rows = sorted(function_types().items())
            entry = TableEntry(tname, [ColumnDef("function_name", VARCHAR),
                                       ColumnDef("function_type", VARCHAR)])
            entry.nrows = len(rows)
            self.catalog.create_table(entry)
            for ci, cname in enumerate(("function_name", "function_type")):
                uniq, codes = np.unique(np.array([r[ci] for r in rows], dtype=str),
                                        return_inverse=True)
                entry.set_host_column(cname, codes.reshape(-1).astype(np.int32),
                                      dict_values=uniq.astype(object))
        else:
            raise BindError(f"Catalog Error: Table Function with name {ref.name} does not "
                            "exist!")
        self.hidden_tables.append(tname)
        alias = (ref.alias or name).lower()
        plan, scope_adds, nrows = self._scan_of(tname, alias)
        if ref.column_aliases:
            scope_adds = [(a, ref.column_aliases[i] if i < len(ref.column_aliases) else c, k, t)
                          for i, (a, c, k, t) in enumerate(scope_adds)]
        return plan, scope_adds, nrows

    _CATALOG_FUNCTIONS = ("duckdb_tables", "duckdb_columns", "duckdb_types",
                          "pragma_table_info", "duckdb_views", "duckdb_indexes",
                          "duckdb_settings", "duckdb_logs")

    def _catalog_table_function(self, tname: str, name: str, args):
        """duckdb_tables(), duckdb_columns(), duckdb_types(),
        duckdb_views(), duckdb_indexes(), duckdb_settings(), duckdb_logs()
        and pragma_table_info(t), with the JAX package's columns (DuckDB's
        src/function/table/system/): a snapshot of the catalog, the
        database's settings or its log taken now, so the plan is
        `uncacheable`. Hidden tables (names starting "__") are left out."""
        from duckdb_tpu_torch.catalog.catalog import ColumnDef, TableEntry
        from duckdb_tpu_torch.planner.binder import _TYPE_NAMES

        self.uncacheable = True
        user_tables = [(n, e) for n, e in sorted(self.catalog.tables.items())
                       if not n.startswith("__")]
        comments = getattr(self.catalog, "comments", {})
        if name in ("duckdb_views", "duckdb_indexes", "duckdb_settings", "duckdb_logs") and args:
            raise BindError(f"Binder Error: {name}() takes no arguments")
        if name == "duckdb_settings":
            from duckdb_tpu_torch.main.settings import SettingsManager

            cols = [("name", VARCHAR), ("value", VARCHAR), ("description", VARCHAR),
                    ("input_type", VARCHAR), ("scope", VARCHAR)]
            rows = (getattr(self.catalog, "settings", None) or SettingsManager()).rows()
        elif name == "duckdb_logs":
            cols = [("timestamp", VARCHAR), ("log_level", VARCHAR), ("type", VARCHAR),
                    ("message", VARCHAR)]
            log = getattr(self.catalog, "log", None)
            rows = log.rows() if log is not None else []
        elif name == "duckdb_views":
            cols = [("view_name", VARCHAR), ("schema_name", VARCHAR), ("comment", VARCHAR)]
            rows = [(n, "main", comments.get(("view", n))) for n in sorted(self.catalog.views)]
        elif name == "duckdb_indexes":
            cols = [("index_name", VARCHAR), ("table_name", VARCHAR), ("is_unique", BOOLEAN),
                    ("expressions", VARCHAR), ("comment", VARCHAR)]
            rows = [(n, info["table"], bool(info.get("unique")), ", ".join(info["exprs"]),
                     comments.get(("index", n)))
                    for n, info in sorted(self.catalog.indexes.items())]
        elif name == "duckdb_tables":
            if args:
                raise BindError("Binder Error: duckdb_tables() takes no arguments")
            cols = [("name", VARCHAR), ("schema_name", VARCHAR), ("estimated_size", BIGINT),
                    ("column_count", BIGINT), ("comment", VARCHAR)]
            rows = [(n.split(".")[-1], n.split(".")[0] if "." in n else "main", e.nrows,
                     len(e.columns), comments.get(("table", n))) for n, e in user_tables]
        elif name == "duckdb_columns":
            if args:
                raise BindError("Binder Error: duckdb_columns() takes no arguments")
            cols = [("table_name", VARCHAR), ("column_name", VARCHAR),
                    ("column_index", BIGINT), ("data_type", VARCHAR), ("comment", VARCHAR)]
            rows = [(n, cd.name, i, str(cd.ltype), comments.get(("column", n, cd.name.lower())))
                    for n, e in user_tables for i, cd in enumerate(e.columns)]
        elif name == "duckdb_types":
            if args:
                raise BindError("Binder Error: duckdb_types() takes no arguments")
            cols = [("logical_type", VARCHAR), ("sql_name", VARCHAR)]
            rows = sorted({(str(t), n) for n, t in _TYPE_NAMES.items()})
        else:
            if len(args) != 1 or args[0].ltype.id is not TypeId.VARCHAR:
                raise BindError("Binder Error: pragma_table_info() takes one table name")
            table = str(args[0].const_value())
            if not self.catalog.has_table(table):
                raise BindError(f"Catalog Error: Table with name {table} does not exist!")
            cols = [("cid", BIGINT), ("name", VARCHAR), ("type", VARCHAR),
                    ("notnull", BOOLEAN), ("dflt_value", VARCHAR), ("pk", BOOLEAN)]
            rows = [(i, cd.name, str(cd.ltype), False, "", False)
                    for i, cd in enumerate(self.catalog.get_table(table).columns)]
        entry = TableEntry(tname, [ColumnDef(c, t) for c, t in cols])
        entry.nrows = len(rows)
        self.catalog.create_table(entry)
        for ci, (cname, t) in enumerate(cols):
            vals = [r[ci] for r in rows]
            valid = np.array([v is not None for v in vals], dtype=bool)
            validity = None if valid.all() else valid
            if t.id is TypeId.VARCHAR:
                uniq, codes = np.unique(np.array(["" if v is None else str(v) for v in vals]
                                                 + [""], dtype=str), return_inverse=True)
                entry.set_host_column(cname, codes.reshape(-1)[:-1].astype(np.int32), validity,
                                      uniq.astype(object))
            else:
                entry.set_host_column(cname, np.array([0 if v is None else v for v in vals],
                                                      dtype=t.np_dtype), validity)

    # the sides a join keeps every row of: an ON conjunct over one of them
    # must not filter it, so it stays in the residual
    _PRESERVED = {"left": "l", "right": "r", "full": "lr", "anti": "l", "semi": "",
                  "asof": "", "asof_left": "l"}

    def _using_pairs(self, ref: N.JoinRef, scope: Scope, lkeys, rkeys):
        """The (left, right) bindings a USING list or NATURAL join equates,
        and the scope's view of each such column (DuckDB's
        bind_joinref.cpp): its unqualified name reads the left side's value
        in INNER, LEFT, SEMI and ANTI joins, the right side's in RIGHT
        joins, and COALESCE of both in FULL joins (the caller plans that
        one); `*` lists it once."""
        if ref.natural:
            rnames = {c.lower() for _, c, b in scope.order if b.key in rkeys}
            seen, cols = set(), []
            for _, c, b in scope.order:
                if b.key in lkeys and c.lower() in rnames and c.lower() not in seen:
                    seen.add(c.lower())
                    cols.append(c)
        else:
            cols = list(ref.using)
        pairs = []
        for col in cols:
            found = []
            for keys, side in ((lkeys, "left"), (rkeys, "right")):
                bs = [b for b in scope.by_name.get(col.lower(), []) if b.key in keys]
                if len(bs) != 1:
                    raise BindError(f'Binder Error: column "{col}" '
                                    + ("does not exist on the " + side + " side of the join"
                                       if not bs else "is ambiguous") + " (USING)")
                found.append(bs[0])
            lb, rb = found
            if ref.join_type != "full":
                scope.merge_using(col, [rb], rb if ref.join_type == "right" else lb, lb)
            pairs.append((col, lb, rb))
        return pairs

    def _plan_outer_join(self, ref: N.JoinRef, ctes, scope: Scope, atoms: List[Atom]):
        """LEFT / RIGHT / FULL / SEMI / ANTI / ASOF JOIN … ON or USING:
        each side becomes a pool of its own; a RIGHT join is a LEFT join
        with the sides swapped. An ON conjunct over the side that is not
        preserved filters that side's pool; one over a preserved side, or
        over both sides without being an equality between them, is the
        join's residual. A join with no equality runs as an inequality
        join or a cross expansion; an ASOF join's residual is its one
        inequality."""
        jt = ref.join_type
        left_atoms: List[Atom] = []
        right_atoms: List[Atom] = []
        lpreds: List[N.Expr] = []
        rpreds: List[N.Expr] = []
        self.collect_atoms(ref.left, ctes, scope, left_atoms, lpreds)
        self.collect_atoms(ref.right, ctes, scope, right_atoms, rpreds)
        binder = self._pred_binder(scope, ctes)
        lkeys = set().union(*[a.keys for a in left_atoms])
        rkeys = set().union(*[a.keys for a in right_atoms])
        lpool, rpool, across, kept = [], [], [], []
        using = self._using_pairs(ref, scope, lkeys, rkeys)
        for _, lb, rb in using:
            across.append(binder.bind(N.BinaryOp("=", KeyRef(lb.key, lb.ltype),
                                                 KeyRef(rb.key, rb.ltype))))
        for c in _hoisted(split_conjuncts(ref.condition)):
            bc = binder.bind(c)
            ks = self._keys_of(bc)
            if ks <= lkeys:
                (kept if "l" in self._PRESERVED[jt] else lpool).append(bc)
            elif ks <= rkeys:
                (kept if "r" in self._PRESERVED[jt] else rpool).append(bc)
            else:
                across.append(bc)
        lpool += [binder.bind(c) for c in _hoisted(lpreds)]
        rpool += [binder.bind(c) for c in _hoisted(rpreds)]
        lplan = self.plan_pool(left_atoms, lpool)
        rplan = self.plan_pool(right_atoms, rpool)
        pk, bk, residual = self._split_join_conds(across, lkeys, rkeys)
        residual += kept
        if jt in ("asof", "asof_left") and len(residual) != 1:
            raise BindError("Binder Error: ASOF JOIN requires an inequality condition"
                            if not residual else
                            "Binder Error: ASOF JOIN takes equalities and one inequality")
        extra = (None if not residual else residual[0] if len(residual) == 1
                 else B.BoundConjunction("and", residual))
        if jt == "right":
            plan = P.Join(rplan, lplan, "left", bk, pk, extra)
        else:
            plan = P.Join(lplan, rplan, jt, pk, bk, extra)
        if jt in ("semi", "anti"):
            # the build columns leave scope: SELECT t2.y after a SEMI JOIN
            # is a binder error
            scope.remove_keys(rkeys)
        keys = lkeys | rkeys
        if jt == "full" and using:
            # an unqualified USING column of a FULL join is COALESCE(l, r)
            items = []
            for col, lb, rb in using:
                ckey = self.fresh(f"using.{col}")
                be = ExprBinder(scope).bind(N.FunctionCall(
                    "coalesce", [KeyRef(lb.key, lb.ltype), KeyRef(rb.key, rb.ltype)]))
                items.append((ckey, be))
                scope.merge_using(col, [rb], Binding(ckey, be.ltype), lb)
                keys.add(ckey)
            plan = P.Project(plan, items)
        atoms.append(Atom(len(atoms) + 10_000, plan, 100_000, keys))

    def _split_join_conds(self, conds, lkeys, rkeys):
        """Partition cross-side conditions into equi keys + residual list."""
        pk, bk, residual = [], [], []
        for c in conds:
            if isinstance(c, B.BoundComparison) and c.op in ("=", "=="):
                ks_l, ks_r = self._keys_of(c.left), self._keys_of(c.right)
                if ks_l <= lkeys and ks_r <= rkeys:
                    pk.append(c.left)
                    bk.append(c.right)
                    continue
                if ks_l <= rkeys and ks_r <= lkeys:
                    pk.append(c.right)
                    bk.append(c.left)
                    continue
            residual.append(c)
        return pk, bk, residual

    def _add_atom(self, plan, scope_adds, nrows, scope: Scope, atoms: List[Atom],
                  table: Optional[str]):
        """`table`: the catalog table a base-table Scan reads, whose column
        statistics drive the join-order estimates (None for other atoms)."""
        keys = set()
        col_of = {}
        if table is not None:
            col_of = {key: (table, col) for col, key, _ in plan.cols}
        for alias, col, key, t in scope_adds:
            scope.add(alias, col, key, t)
            keys.add(key)
        atoms.append(Atom(len(atoms), plan, nrows, keys, col_of))

    def _keys_of(self, e: B.BoundExpr) -> Set[str]:
        return {n.key for n in B.walk(e) if isinstance(n, B.BoundColumnRef)}

    def _atoms_of(self, e: B.BoundExpr, key2atom) -> Set[int]:
        return {key2atom[k] for k in self._keys_of(e) if k in key2atom}

    # -- pool join ordering ---------------------------------------------------
    def plan_pool(self, atoms: List[Atom], preds: List[B.BoundExpr]) -> P.PlanNode:
        """Join all atoms; apply predicates as soon as their support is joined."""
        key2atom = {}
        for a in atoms:
            for k in a.keys:
                key2atom[k] = a.id
        by_id = {a.id: a for a in atoms}

        # push single-atom predicates (scaling the atom's row estimate —
        # feeds both the DP cost model and the greedy spine choice)
        from duckdb_tpu_torch.planner.join_order import (dp_join_order,
                                                         estimate_selectivity)

        multi = []
        for p in preds:
            sup = self._atoms_of(p, key2atom)
            if len(sup) <= 1:
                aid = next(iter(sup)) if sup else atoms[0].id
                a = by_id[aid]
                a.plan = P.Filter(a.plan, p)
                a.rows = max(1, int(a.rows * estimate_selectivity(self, p, a)))
            else:
                multi.append(p)

        # DP join ordering over the query graph (reference:
        # duckdb/src/optimizer/join_order/), unless SET join_order = 'greedy'.
        # Greedy below takes oversized and disconnected graphs too.
        if len(by_id) >= 3 and self._setting("join_order", "dp") == "dp":
            dp_plan = dp_join_order(self, by_id, multi)
            if dp_plan is not None:
                return dp_plan

        # snowflake collapse: pre-join fanout-1 dimension chains into their
        # parent atom, bottom-up, so the fact spine probes each chain ONCE
        # (joining customer into orders first costs O(orders) instead of
        # O(lineitem)); the bushy special case that matters for
        # star/snowflake schemas (TPC-H Q3/Q5/Q7-Q10).
        if len(by_id) > 2:
            spine_id = max(by_id.values(),
                           key=lambda a: (a.base_rows or a.rows, a.rows)).id
            changed = True
            while changed and len(by_id) > 2:
                changed = False
                for a in sorted(by_id.values(), key=lambda x: x.rows):
                    if a.id == spine_id:
                        continue
                    for b in sorted(by_id.values(), key=lambda x: x.rows):
                        if b.id in (a.id, spine_id) or b.rows > a.rows:
                            continue
                        edges = self._edges_between(multi, a.keys, b.keys)
                        if not edges or self._fanout_estimate(b, edges) > 1.01:
                            continue
                        pk = [e[1] for e in edges]
                        bk = [e[2] for e in edges]
                        used = [e[0] for e in edges]
                        multi = [p for p in multi
                                 if not any(p is u for u in used)]
                        a.plan = P.Join(a.plan, b.plan, "inner", pk, bk, None)
                        a.keys = set(a.keys) | set(b.keys)
                        a.col_of.update(b.col_of)
                        del by_id[b.id]
                        for k in b.keys:
                            key2atom[k] = a.id
                        # predicates now fully inside the merged atom
                        rest = []
                        for p in multi:
                            if self._keys_of(p) <= a.keys:
                                a.plan = P.Filter(a.plan, p)
                            else:
                                rest.append(p)
                        multi = rest
                        changed = True
                        break
                    if changed:
                        break

        remaining = dict(by_id)
        # start from the largest atom (fact-table probe spine) by BASE
        # table size: filtered estimates can flip a fact below a dimension,
        # making the fact the duplicate-key BUILD
        cur = max(remaining.values(), key=lambda a: (a.base_rows or a.rows, a.rows))
        del remaining[cur.id]
        joined_keys = set(cur.keys)
        plan = cur.plan
        pending = list(multi)

        def try_apply_pending(plan):
            nonlocal pending
            rest = []
            for p in pending:
                if self._keys_of(p) <= joined_keys:
                    plan = P.Filter(plan, p)
                else:
                    rest.append(p)
            pending = rest
            return plan

        while remaining:
            # candidate atoms connected by at least one equi edge, scored by
            # estimated join fanout (PK-range edge ⇒ 1) then size
            best = None
            best_score = None
            for a in remaining.values():
                edges = self._edges_between(pending, joined_keys, a.keys)
                if edges:
                    score = (self._fanout_estimate(a, edges), a.rows)
                    if best is None or score < best_score:
                        best = (a, edges)
                        best_score = score
            if best is None:
                # no equality reaches the pool: the atom that inequalities
                # connect (the smallest) joins by a keyless Join, which the
                # executor runs as an inequality join; with none, the
                # smallest atom is a cross product
                pick = None
                for a in remaining.values():
                    conds = self._ineq_conds_between(pending, joined_keys, a.keys)
                    if conds and (pick is None or a.rows < pick[0].rows):
                        pick = (a, conds)
                if pick is not None:
                    a, conds = pick
                    pending = [p for p in pending if not any(p is c for c in conds)]
                    plan = P.Join(plan, a.plan, "inner", [], [],
                                  conds[0] if len(conds) == 1
                                  else B.BoundConjunction("and", conds))
                else:
                    a = min(remaining.values(), key=lambda x: x.rows)
                    plan = P.CrossJoin(plan, a.plan)
                del remaining[a.id]
                joined_keys |= a.keys
                plan = try_apply_pending(plan)
                continue
            a, edges = best
            del remaining[a.id]
            pk, bk, used = [], [], []
            for p, probe_side, build_side in edges:
                pk.append(probe_side)
                bk.append(build_side)
                used.append(p)
            pending = [p for p in pending if not any(p is u for u in used)]
            plan = P.Join(plan, a.plan, "inner", pk, bk, None)
            joined_keys |= a.keys
            plan = try_apply_pending(plan)
        for p in pending:
            plan = P.Filter(plan, p)
        return plan

    def _fanout_estimate(self, atom: Atom, edges) -> float:
        """Rows matched per probe row: build_rows / Π per-edge key ranges."""
        denom = 1.0
        for _, probe_side, build_side in edges:
            rng = None
            if isinstance(build_side, B.BoundColumnRef):
                tc = atom.col_of.get(build_side.key)
                if tc is not None:
                    st = self.catalog.get_table(tc[0]).stats_for(tc[1])
                    if st.min_val is not None and st.max_val is not None:
                        rng = max(1, int(st.max_val) - int(st.min_val) + 1)
                    if st.n_unique is not None:
                        rng = max(rng or 1, st.n_unique)
            if rng is not None:
                denom *= rng
        return max(1.0, atom.rows / denom)

    def _ineq_conds_between(self, preds, lkeys: Set[str], rkeys: Set[str]):
        """The predicates that span both key sets, when one of them (or a
        conjunct of one, as BETWEEN binds) compares a left expression with
        a right one by <, <=, > or >= (the inequality join's sort
        predicate); they all ride along as its residual. [] otherwise."""
        spanning, has_ineq = [], False
        for p in preds:
            ks = self._keys_of(p)
            if not (ks and ks <= lkeys | rkeys and ks & lkeys and ks & rkeys):
                continue
            spanning.append(p)
            for c in B.and_terms(p):
                if isinstance(c, B.BoundComparison) and c.op in ("<", "<=", ">", ">="):
                    kl, kr = self._keys_of(c.left), self._keys_of(c.right)
                    if (kl <= lkeys and kr <= rkeys) or (kl <= rkeys and kr <= lkeys):
                        has_ineq = True
        return spanning if has_ineq else []

    def _edges_between(self, preds, joined_keys: Set[str], atom_keys: Set[str]):
        out = []
        for p in preds:
            if not isinstance(p, B.BoundComparison) or p.op not in ("=", "=="):
                continue
            kl, kr = self._keys_of(p.left), self._keys_of(p.right)
            if kl and kr:
                if kl <= joined_keys and kr <= atom_keys:
                    out.append((p, p.left, p.right))
                elif kr <= joined_keys and kl <= atom_keys:
                    out.append((p, p.right, p.left))
        return out

    def plan_select_node(self, sel: N.SelectNode, outer_scope, ctes, order_by=()):
        scope = Scope(parent=outer_scope)
        atoms: List[Atom] = []
        pred_asts: List[N.Expr] = []
        self.collect_atoms(sel.from_table, ctes, scope, atoms, pred_asts)
        binder = self._pred_binder(scope, ctes)
        bound_preds: List[B.BoundExpr] = []
        semis: List[SemiSpec] = []
        local_keys = set().union(*[a.keys for a in atoms])
        for ast in _hoisted(pred_asts + split_conjuncts(sel.where)):
            if not self._flatten_conjunct(ast, scope, ctes, local_keys, bound_preds,
                                          semis, atoms):
                bound_preds.append(binder.bind(ast))
        plan = self._stack_semis(self.plan_pool(atoms, bound_preds), semis)
        if sel.sample is not None:
            # USING SAMPLE samples what FROM and WHERE give
            plan = self._plan_sample(plan, sel.sample)

        # -- aggregation ------------------------------------------------------
        has_agg = (bool(sel.group_by) or sel.group_by_all or sel.having is not None
                   or any(_contains_aggregate(e) for e, _ in sel.select_list))
        select_aliases = {alias.lower(): e for e, alias in sel.select_list if alias}
        post_binder = binder
        if has_agg:
            plan, post_binder = self._plan_aggregate(plan, sel, scope,
                                                     select_aliases, binder, ctes)

        # -- windows: each call in the select list, QUALIFY or DISTINCT ON
        # adds a column to one Window node over the aggregate's output
        windows: List[P.BoundWindow] = []
        window_refs = {}  # id(WindowFunction ast) → its column, bound once

        def window_collector(wf, b):
            if id(wf) not in window_refs:
                window_refs[id(wf)] = self._bind_window_call(wf, b, windows)
            return window_refs[id(wf)]

        post_binder.window_collector = window_collector

        # -- projection -------------------------------------------------------
        # list_value over columns becomes a ListPack node (below the
        # aggregate when it feeds one), unnest() at the top of a select
        # item an Unnest node
        post_packs = []
        unnests = []  # (key, LIST expr)
        items = []
        output = []
        for e, alias in self._expand_stars(sel.select_list, scope):
            e2 = self._hoist_listpacks(e, post_binder, scope,
                                       lambda key, args, lt: post_packs.append((key, args, lt)),
                                       below_aggs=False)
            if isinstance(e2, N.FunctionCall) and e2.name.lower() == "unnest" \
                    and len(e2.args) == 1:
                arg = post_binder.bind(e2.args[0])
                if arg.ltype.id not in (TypeId.LIST, TypeId.ARRAY):
                    raise BindError(f"Binder Error: unnest() expects a LIST, got {arg.ltype!r}")
                ukey = self.fresh("unnest")
                unnests.append((ukey, arg))
                be = B.BoundColumnRef(ukey, arg.ltype.child or SQLNULL)
            else:
                be = post_binder.bind(e2)
            key = self.fresh("out")
            items.append((key, be))
            output.append((alias or _default_name(e), key, be.ltype))
        if has_agg:
            # a column of FROM that is neither grouped nor aggregated
            allowed = {gk for gk, _ in plan.groups} | {a.key for a in plan.aggs}
            names = {b.key: c for _, c, b in scope.order}
            for _, be in items:
                for nn in B.walk(be):
                    if isinstance(nn, B.BoundColumnRef) and nn.key in local_keys \
                            and nn.key not in allowed:
                        raise BindError(
                            f'Binder Error: column "{names.get(nn.key, nn.key)}" must appear '
                            "in the GROUP BY clause or must be part of an aggregate function")
        if sel.having is not None:
            # HAVING filters before the windows run: no window in it
            post_binder.window_collector = None
            hb = post_binder.bind(sel.having)
            post_binder.window_collector = window_collector
            allowed = {gk for gk, _ in plan.groups} | {a.key for a in plan.aggs}
            for nn in B.walk(hb):
                if isinstance(nn, B.BoundColumnRef) and nn.key not in allowed:
                    raise BindError(
                        "Binder Error: HAVING column must appear in the GROUP "
                        "BY clause or be used in an aggregate function")
            plan = P.Filter(plan, hb)
        qualify = None
        if sel.qualify is not None:
            # QUALIFY reads a select alias where no column has its name, as
            # DuckDB does (the reference raises "column not found": W2)
            qualify = post_binder.bind(_subst_aliases(sel.qualify, select_aliases, scope))
        first_on = None
        if sel.distinct_on:
            first_on = self._distinct_on_window(sel, order_by, select_aliases, post_binder,
                                                windows)
        post_binder.window_collector = None
        if windows:
            plan = P.Window(plan, windows)
        if qualify is not None:
            plan = P.Filter(plan, qualify)
        if first_on is not None:
            plan = P.Filter(plan, first_on)
        for key, args, lt in post_packs:
            plan = P.ListPack(plan, args, key, lt)
        if unnests:
            plan = P.Unnest(plan, [a for _, a in unnests], [k for k, _ in unnests])
        plan = P.Project(plan, items)
        if sel.distinct and not sel.distinct_on:
            plan = P.Aggregate(plan, [(k, B.BoundColumnRef(k, t))
                                      for _, k, t in output], [])
        out_scope = Scope()
        for nme, key, t in output:
            out_scope.add("", nme, key, t)
        return plan, output, (out_scope, post_binder)

    def _expand_stars(self, select_list, scope: Scope):
        """`*` and `t.*` → one item per binding, named by the column and
        bound by its key (so two columns of one name stay two). A bare `*`
        lists a USING column once (Scope.merge_using)."""
        out = []
        for e, alias in select_list:
            if isinstance(e, N.Star):
                cols = (scope.columns_of(e.table) if e.table else scope.all_columns())
                excluded = {x.lower() for x in e.exclude}
                for _, c, b in cols:
                    if c.lower() in excluded:
                        continue
                    if not e.table:
                        if b.key in scope.star_replace:
                            b = scope.star_replace[b.key]
                        elif b.key in scope.star_hidden:
                            continue
                    out.append((KeyRef(b.key, b.ltype), c))
            else:
                out.append((e, alias))
        return out

    # -- columnar list_value --------------------------------------------------
    def _hoist_listpacks(self, e, binder, scope: Scope, add_pack, below_aggs=True):
        """e with each list_value over columns replaced by a reference to a
        ListPack's output (add_pack(key, bound args, LIST type) plans it);
        list_value over constants binds in place. Lambda bodies and
        subqueries are left alone, and so are aggregate calls unless
        `below_aggs`."""
        if not isinstance(e, N.Expr) or isinstance(e, N.LambdaExpr):
            return e
        if not below_aggs and isinstance(e, N.FunctionCall) \
                and (e.name.lower() in AGGREGATE_NAMES or e.is_star):
            return e  # the aggregate's collector hoists its arguments below it
        if isinstance(e, N.FunctionCall) and e.name.lower() in ("list_value", "list_pack") \
                and e.args:
            e2 = N.FunctionCall(e.name, [
                self._hoist_listpacks(a, binder, scope, add_pack, below_aggs) for a in e.args])
            try:
                binder.bind(e2)
                return e2
            except B.BindError:
                args = [binder.bind(a) for a in e2.args]
                child = SQLNULL
                for a in args:
                    child = max_logical_type(child, a.ltype)
                key = self.fresh("listpack")
                ph = f"__lp_{key}"
                lt = list_of(child)
                scope.add(ph, ph, key, lt)
                add_pack(key, args, lt)
                return N.ColumnRef((ph, ph))
        if not dataclasses.is_dataclass(e):
            return e
        changes = {}
        for f in dataclasses.fields(e):
            v = getattr(e, f.name)
            if isinstance(v, N.Expr):
                nv = self._hoist_listpacks(v, binder, scope, add_pack, below_aggs)
            elif isinstance(v, list):
                nv = [tuple(self._hoist_listpacks(y, binder, scope, add_pack, below_aggs)
                            for y in x) if isinstance(x, tuple)
                      else self._hoist_listpacks(x, binder, scope, add_pack, below_aggs)
                      for x in v]
            else:
                continue
            if (any(a is not b for a, b in zip(nv, v)) if isinstance(v, list)
                    else nv is not v):
                changes[f.name] = nv
        return dataclasses.replace(e, **changes) if changes else e

    # -- aggregate planning ---------------------------------------------------
    def _plan_aggregate(self, plan, sel: N.SelectNode, scope, select_aliases, binder,
                        ctes):
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
        node = P.Aggregate(plan, groups, aggs)

        def below(key, args, lt):
            # a ListPack that feeds an aggregate's argument runs below it
            node.child = P.ListPack(node.child, args, key, lt)

        def collector(fc: N.FunctionCall, b):
            fc = self._hoist_listpacks(fc, binder, scope, below)
            return self._bind_aggregate_call(fc, binder, aggs)

        post = _PostAggBinder(scope, group_lookup, collector,
                              lambda e, b: self._bind_subquery_expr(e, b, ctes))
        return node, post

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
        agg_filter = None
        if fc.filter is not None and _AGG_ALIASES.get(name, name) in ("list", "array_agg"):
            # list() keeps NULL elements, so a FILTER drops rows rather than
            # nulling them as the CASE form below would
            agg_filter = binder.bind(fc.filter)
        elif fc.filter is not None:
            # agg(x) FILTER (WHERE p) ≡ agg(CASE WHEN p THEN x END): every
            # aggregate but count(*) ignores NULL inputs, and count(*)
            # becomes count(CASE WHEN p THEN 1 END)
            def case(a):
                return N.CaseExpr(None, [(fc.filter, a)], None)

            args = [case(N.Literal(1))] if fc.is_star or not fc.args \
                else [case(fc.args[0])] + list(fc.args[1:])
            fc = N.FunctionCall("count" if fc.is_star or not fc.args else fc.name, args,
                                distinct=fc.distinct, order_by=fc.order_by)
            name = fc.name.lower()
        if name == "count" and fc.is_star:
            func, args = "count_star", []
        else:
            func = _AGG_ALIASES.get(name, name)
            if func not in _PORTED_AGGS:
                raise not_ported(f"the aggregate {name}()")
            if fc.distinct and func in NESTED_RESULT_AGGS - {"list", "array_agg"}:
                raise BindError(f"distinct aggregate {func}")  # as the JAX package refuses
            args = [binder.bind(a) for a in fc.args]
            if func == "string_agg" and args and args[0].ltype.id is not TypeId.VARCHAR:
                args[0] = B.BoundCast(args[0], VARCHAR)  # DuckDB's string_agg.cpp
        arity = _AGG_ARITY.get(func)
        if arity is not None and len(args) != arity:
            raise BindError(f"Binder Error: {func} requires {arity} arguments, "
                            f"{len(args)} given")
        if not args and func != "count_star":
            raise BindError(f"Binder Error: {func} requires at least one argument")
        t = _agg_result_type(func, args)
        order_by = [(binder.bind(it.expr),) + self._direction(it)
                    for it in fc.order_by]
        distinct = fc.distinct and func not in ("min", "max")  # the same either way
        # dedup structurally identical aggregates
        for a in aggs:
            if (a.func == func and a.distinct == distinct and not a.order_by
                    and not order_by and a.filter is None and agg_filter is None
                    and len(a.args) == len(args)
                    and all(_bound_eq(x, y) for x, y in zip(a.args, args))):
                return B.BoundAggregateRef(a.key, a.ltype)
        key = self.fresh(f"agg.{func}")
        aggs.append(B.BoundAggregate(func, args, distinct, t, key, order_by=order_by,
                                     filter=agg_filter))
        return B.BoundAggregateRef(key, t)

    # -- subqueries -------------------------------------------------------------
    def _pred_binder(self, scope: Scope, ctes) -> ExprBinder:
        return ExprBinder(scope,
                          subquery_binder=lambda e, b: self._bind_subquery_expr(e, b, ctes))

    def _bind_subquery_expr(self, e, binder: ExprBinder, ctes):
        """A subquery that no WHERE conjunct flattened: an uncorrelated
        scalar subquery becomes a lazy constant; IN and EXISTS become MARK
        joins (an EXISTS correlated by one equality, `_correlated_mark`)."""
        if isinstance(e, N.ScalarSubquery):
            plan, output = self.plan_select(e.subquery, None, ctes)
            _, key, t = output[0]
            return BoundScalarSubquery(self, plan, key, t)
        if isinstance(e, N.InSubquery):
            child = binder.bind(e.expr)
            plan, output = self.plan_select(e.subquery, None, ctes)
            if len(output) != 1:
                raise BindError("Binder Error: Subquery returns "
                                f"{len(output)} columns - expected 1")
            _, key, t = output[0]
            return BoundMarkSubquery(self, child, plan, key, t, e.negated)
        if isinstance(e, N.Exists):
            try:
                plan, output = self.plan_select(e.subquery, None, ctes)
            except ColumnNotFound as err:
                if binder.scope.try_resolve(err.parts) is None:
                    raise
                mark = self._correlated_mark(e.subquery, binder.scope, ctes, e.negated)
                if mark is None:
                    raise not_ported("EXISTS outside a WHERE conjunct correlated by other "
                                     "than one equality")
                return mark
            _, key, t = output[0]
            return BoundMarkSubquery(self, None, plan, key, t, e.negated)
        raise not_ported(f"the subquery form {type(e).__name__}")

    def _correlated_mark(self, sub, scope, ctes, negated):
        """A correlated EXISTS in any expression position: `EXISTS (SELECT …
        WHERE inner.k = outer.k AND local)` is `outer.k IN (SELECT inner.k
        … WHERE local)` with EXISTS's two values (DuckDB's correlated MARK
        join, flatten_dependent_join.cpp). One correlation equality; None
        for other shapes."""
        outer_keys = set()
        s_ = scope
        while s_ is not None:
            outer_keys |= {b.key for _, _, b in s_.order}
            s_ = s_.parent
        try:
            (sub_atoms, local_bound, corr_eqs, corr_extra, _, _,
             sub_semis) = self._plan_sub_pool(sub, scope, ctes, outer_keys)
        except BindError:
            return None
        if len(corr_eqs) != 1 or corr_extra:
            return None
        build = self._stack_semis(self.plan_pool(sub_atoms, local_bound), sub_semis)
        outer_e, inner_e = corr_eqs[0]
        out_key = self.fresh("corrmark")
        return BoundMarkSubquery(self, outer_e, P.Project(build, [(out_key, inner_e)]),
                                 out_key, inner_e.ltype, negated, exists_semantics=True)

    @staticmethod
    def _stack_semis(plan, semis: List[SemiSpec]):
        for s in semis:
            plan = P.Join(plan, s.build_plan, s.jtype, s.probe_keys, s.build_keys,
                          s.extra, null_aware=s.null_aware)
            if s.post_filter is not None:
                plan = P.Filter(plan, s.post_filter)
        return plan

    def _flatten_conjunct(self, ast, scope, ctes, local_keys, bound_preds, semis,
                          atoms) -> bool:
        """Handle EXISTS / IN-subquery / correlated scalar-agg conjuncts."""
        neg = False
        inner = ast
        if isinstance(inner, N.NotExpr):
            neg = True
            inner = inner.child
        if isinstance(inner, N.Exists):
            self._plan_semijoin_exists(inner.subquery, None, neg != inner.negated,
                                       scope, ctes, local_keys, semis)
            return True
        if isinstance(inner, N.InSubquery):
            self._plan_semijoin_exists(inner.subquery, inner.expr, neg != inner.negated,
                                       scope, ctes, local_keys, semis)
            return True
        if isinstance(inner, N.BinaryOp) and inner.op in B._CMP_OPS and not neg:
            for e_side, other, flip in ((inner.right, inner.left, False),
                                        (inner.left, inner.right, True)):
                subs = _find_scalar_subqueries(e_side)
                if len(subs) == 1 and not _find_scalar_subqueries(other):
                    sa = self._correlated_scalar_agg(subs[0].subquery, scope, ctes,
                                                     local_keys)
                    if sa is None:
                        return False  # uncorrelated → normal binding path
                    self._plan_scalar_conjunct(inner.op, subs[0], e_side, other, flip,
                                               sa, scope, ctes, bound_preds, semis,
                                               atoms)
                    return True
        return False

    def _plan_scalar_conjunct(self, op, sq, e_side, other, flip, sa: "_ScalarAgg",
                              scope, ctes, bound_preds, semis, atoms):
        """`other op f((SELECT agg … WHERE corr))`, with the subquery planned
        as the grouped aggregate `sa`. When the conjunct is NULL wherever the
        subquery has no rows, an inner join on the correlation keys drops
        exactly the right outer rows, and the aggregate is an atom of the
        pool (the JAX package's plan). Otherwise (count, coalesce, or an
        expression that is not NULL when the subquery is) a LEFT join is
        stacked on the pool, and the subquery's value is its value over no
        rows where the join found no group."""

        def bind_side(value):
            # the containing expression with the subquery node replaced by
            # `value` (e.g. `price > 1.2 * (SELECT avg(...) WHERE corr)`)
            def sq_binder(e, b):
                if e is sq:
                    return value
                return self._bind_subquery_expr(e, b, ctes)

            return ExprBinder(scope, subquery_binder=sq_binder).bind(e_side)

        side_b = bind_side(sa.ref)
        other_b = self._pred_binder(scope, ctes).bind(other)
        outer_keys = [o for o, _ in sa.corr_eqs]
        build_keys = [B.BoundColumnRef(gk, ge.ltype) for gk, ge in sa.groups]
        if sa.no_rows is None and _null_if_null(side_b, sa.ref.key):
            keys = {sa.ref.key} | {gk for gk, _ in sa.groups}
            atoms.append(Atom(50_000 + len(atoms), sa.plan, 10_000, keys))
            for o, b in zip(outer_keys, build_keys):
                bound_preds.append(B.BoundComparison("=", o, b))
        else:
            if sa.no_rows is not None:
                # no group matched ⟺ the (never NULL when matched) group key
                # is NULL-extended
                side_b = bind_side(B.BoundCase(
                    [(B.BoundIsNull(build_keys[0]), sa.no_rows)], sa.ref,
                    sa.ref.ltype))
            lhs, rhs = (side_b, other_b) if flip else (other_b, side_b)
            semis.append(SemiSpec("left", sa.plan, outer_keys, build_keys, None,
                                  post_filter=B.BoundComparison(op, lhs, rhs)))
            return
        lhs, rhs = (side_b, other_b) if flip else (other_b, side_b)
        bound_preds.append(B.BoundComparison(op, lhs, rhs))

    def _plan_sub_pool(self, sub: N.SelectStatement, scope, ctes, local_keys):
        """Plan a subquery's FROM/WHERE with correlation extraction.

        → (pool atoms, local predicates, correlated equalities [(outer_e,
        inner_e)], other correlated predicates, sub scope, select node,
        the subquery's own semi/anti specs).
        """
        if sub.ctes or sub.order_by or sub.limit:
            raise BindError("complex subquery (ctes/order/limit) unsupported")
        sel = sub.node
        if not isinstance(sel, N.SelectNode):
            raise BindError("set-op subquery unsupported")
        sub_scope = Scope(parent=scope)
        sub_atoms: List[Atom] = []
        pred_asts: List[N.Expr] = []
        self.collect_atoms(sel.from_table, ctes, sub_scope, sub_atoms, pred_asts)
        sub_keys = set().union(*[a.keys for a in sub_atoms])
        binder = self._pred_binder(sub_scope, ctes)
        local_bound, corr_eqs, corr_extra = [], [], []
        sub_semis: List[SemiSpec] = []
        for ast in _hoisted(pred_asts + split_conjuncts(sel.where)):
            if self._flatten_conjunct(ast, sub_scope, ctes, sub_keys, local_bound,
                                      sub_semis, sub_atoms):
                continue
            bp = binder.bind(ast)
            if self._keys_of(bp) <= sub_keys:
                local_bound.append(bp)
                continue
            # correlated: an equality with one side wholly outer?
            if isinstance(bp, B.BoundComparison) and bp.op in ("=", "=="):
                kl, kr = self._keys_of(bp.left), self._keys_of(bp.right)
                if kl <= sub_keys and kr <= local_keys:
                    corr_eqs.append((bp.right, bp.left))
                    continue
                if kr <= sub_keys and kl <= local_keys:
                    corr_eqs.append((bp.left, bp.right))
                    continue
            corr_extra.append(bp)
        return sub_atoms, local_bound, corr_eqs, corr_extra, sub_scope, sel, sub_semis

    def _plan_semijoin_exists(self, sub, in_expr, negated, scope, ctes, local_keys,
                              semis):
        jtype = "anti" if negated else "semi"
        # grouped/complex subquery (Q18's IN … GROUP BY … HAVING): plan it as
        # a standalone query and semi-join against its output column
        sel0 = sub.node
        complex_sub = (
            not isinstance(sel0, N.SelectNode)
            or sel0.group_by or sel0.group_by_all or sel0.having is not None
            or sel0.distinct or sub.ctes or sub.order_by or sub.limit
            or any(_contains_aggregate(e) for e, _ in sel0.select_list))
        if complex_sub and in_expr is not None:
            build, output = self.plan_select(sub, None, ctes)
            _, okey, ot = output[0]
            outer_b = self._pred_binder(scope, ctes).bind(in_expr)
            semis.append(SemiSpec(jtype, build, [outer_b], [B.BoundColumnRef(okey, ot)],
                                  None, null_aware=negated))
            return
        (sub_atoms, local_bound, corr_eqs, corr_extra, sub_scope, sel,
         sub_semis) = self._plan_sub_pool(sub, scope, ctes, local_keys)
        build = self._stack_semis(self.plan_pool(sub_atoms, local_bound), sub_semis)
        probe_keys = [o for o, _ in corr_eqs]
        build_keys = [i for _, i in corr_eqs]
        if in_expr is not None:
            # IN: add the expr = select-item equality
            if len(sel.select_list) != 1:
                raise BindError("IN subquery must select one column")
            inner_b = self._pred_binder(sub_scope, ctes).bind(sel.select_list[0][0])
            outer_b = self._pred_binder(scope, ctes).bind(in_expr)
            if inner_b.ltype != outer_b.ltype:
                # mixed-type IN: both sides coerce to the common type
                mt = max_logical_type(outer_b.ltype, inner_b.ltype)
                if outer_b.ltype != mt:
                    outer_b = B.BoundCast(outer_b, mt)
                if inner_b.ltype != mt:
                    inner_b = B.BoundCast(inner_b, mt)
            probe_keys.append(outer_b)
            build_keys.append(inner_b)
        else:
            spec = self._try_neq_exists_rewrite(build, corr_eqs, corr_extra, negated,
                                                local_keys)
            if spec is not None:
                semis.append(spec)
                return
        extra = B.BoundConjunction("and", corr_extra) if corr_extra else None
        if not probe_keys:
            # uncorrelated EXISTS: a semi/anti join on a constant key, so
            # every probe row matches iff the build side is non-empty
            probe_keys.append(B.BoundLiteral(1, BIGINT))
            build_keys.append(B.BoundLiteral(1, BIGINT))
        semis.append(SemiSpec(jtype, build, probe_keys, build_keys, extra,
                              null_aware=negated and in_expr is not None))

    def _try_neq_exists_rewrite(self, build, corr_eqs, corr_extra, negated, local_keys):
        """EXISTS(… k = outer.k AND c <> outer.c) → semi/anti join against
        GROUP BY k: min(c), max(c) with the residual (min <> outer.c OR
        max <> outer.c).

        A row of the group with c ≠ a exists ⟺ min(c) ≠ a or max(c) ≠ a
        (min/max skip NULL c exactly as `c <> a` is never TRUE for it). The
        aggregate build has unique keys by construction, so the probe fuses
        into the aggregate pipeline: the TPC-H Q21 shape.
        """
        if not corr_eqs or len(corr_extra) != 1:
            return None
        bp = corr_extra[0]
        if not (isinstance(bp, B.BoundComparison) and bp.op in ("<>", "!=")):
            return None
        kl, kr = self._keys_of(bp.left), self._keys_of(bp.right)
        if kl and not (kl & local_keys):
            inner_c, outer_c = bp.left, bp.right
        elif kr and not (kr & local_keys):
            inner_c, outer_c = bp.right, bp.left
        else:
            return None
        if self._keys_of(outer_c) & self._keys_of(inner_c):
            return None
        groups, build_keys = [], []
        for _, i in corr_eqs:
            gk = self.fresh("neqg")
            groups.append((gk, i))
            build_keys.append(B.BoundColumnRef(gk, i.ltype))
        kmin, kmax = self.fresh("neqmin"), self.fresh("neqmax")
        aggs = [B.BoundAggregate("min", [inner_c], False, inner_c.ltype, kmin),
                B.BoundAggregate("max", [inner_c], False, inner_c.ltype, kmax)]
        mn = B.BoundColumnRef(kmin, inner_c.ltype)
        mx = B.BoundColumnRef(kmax, inner_c.ltype)
        extra = B.BoundConjunction("or", [B.BoundComparison("<>", mn, outer_c),
                                          B.BoundComparison("<>", mx, outer_c)])
        return SemiSpec("anti" if negated else "semi", P.Aggregate(build, groups, aggs),
                        [o for o, _ in corr_eqs], build_keys, extra)

    def _correlated_scalar_agg(self, sub, scope, ctes, local_keys) -> Optional["_ScalarAgg"]:
        """`(SELECT agg-expr FROM … WHERE corr)` → its grouped aggregate over
        the inner correlation expressions (None when the subquery is not a
        flattenable correlated scalar aggregate). Reference:
        FlattenDependentJoins, duckdb/src/planner/subquery/
        flatten_dependent_join.cpp."""
        try:
            (sub_atoms, local_bound, corr_eqs, corr_extra, sub_scope, sel,
             sub_semis) = self._plan_sub_pool(sub, scope, ctes, local_keys)
        except BindError:
            return None
        if not corr_eqs or corr_extra:
            return None
        if len(sel.select_list) != 1 or sel.group_by or sel.having:
            return None
        item_ast = sel.select_list[0][0]
        if not _contains_aggregate(item_ast):
            return None
        subplan = self._stack_semis(self.plan_pool(sub_atoms, local_bound), sub_semis)
        sub_binder = self._pred_binder(sub_scope, ctes)
        groups = [(self.fresh("corr"), inner_e) for _, inner_e in corr_eqs]
        aggs: List[B.BoundAggregate] = []

        def collector(fc, b):
            return self._bind_aggregate_call(fc, sub_binder, aggs)

        post = ExprBinder(sub_scope, agg_collector=collector,
                          subquery_binder=lambda e, b: self._bind_subquery_expr(e, b, ctes))
        item_b = post.bind(item_ast)
        agg_funcs = {a.key: a.func for a in aggs}
        out_key = self.fresh("subagg")
        plan = P.Project(P.Aggregate(subplan, groups, aggs), [(out_key, item_b)])
        no_rows = (None if _null_on_no_rows(item_b, agg_funcs)
                   else _fold_aggregates(item_b, agg_funcs))
        return _ScalarAgg(plan, corr_eqs, groups, B.BoundColumnRef(out_key, item_b.ltype),
                          no_rows)

    # -- windows ---------------------------------------------------------------
    def _bind_window_call(self, wf: N.WindowFunction, binder, windows: List[P.BoundWindow]):
        """A window call → a reference to its output column, its BoundWindow
        appended to `windows` (result types as the JAX package gives them).
        DISTINCT and FILTER follow SQL: the JAX package ignores both (W8,
        W10); median over VARCHAR is DuckDB's quantile_disc (W9)."""
        fc, spec = wf.func, wf.spec
        name = fc.name.lower()
        name = {"rank_dense": "dense_rank", "mean": "avg"}.get(name, name)
        if fc.order_by:
            raise not_ported(f"{name}() with ORDER BY inside the call over a window")
        args = [binder.bind(a) for a in fc.args]
        part = [binder.bind(e) for e in spec.partition_by]
        order = [(binder.bind(it.expr),) + self._direction(it)
                 for it in spec.order_by]
        if (fc.distinct or fc.filter is not None) and name not in _FILTER_WINDOWS:
            raise BindError(f"Binder Error: DISTINCT and FILTER need an aggregate, not {name}()")
        if fc.distinct and (spec.frame is not None or name in _HOLISTIC_WINDOWS):
            raise not_ported(f"{name}(DISTINCT …) over a frame or of a holistic aggregate")
        if name in ("row_number", "rank", "dense_rank", "ntile", "count"):
            t = BIGINT
        elif name == "sum":
            t = _agg_result_type("sum", args)
        elif name in ("avg", "percent_rank", "cume_dist"):
            t = DOUBLE
        elif name in ("min", "max", "lag", "lead", "first_value", "last_value",
                      "nth_value", "fill"):
            t = args[0].ltype if args else SQLNULL
        elif name in _HOLISTIC_WINDOWS:
            if order or spec.frame is not None:
                # the JAX package ignores both and answers over the whole
                # partition (W3)
                raise not_ported(f"{name}() over an ORDER BY or a frame (ROADMAP item 44)")
            t = DOUBLE
            if args and args[0].ltype.id is TypeId.VARCHAR:
                if name != "median":
                    raise BindError(f"Binder Error: {name}() over a window takes a number, "
                                    "not VARCHAR")
                t = VARCHAR
        else:
            raise BindError(f"Binder Error: window function {name} is not supported")
        if name in ("sum", "avg", "min", "max", "lag", "lead", "first_value", "last_value",
                    "nth_value", "fill") + _HOLISTIC_WINDOWS and not args:
            raise BindError(f"Binder Error: {name}() over a window needs an argument")
        if args and (args[0].ltype.id in UNSORTED_DICT_IDS
                     or args[0].ltype.id is TypeId.HUGEINT and name not in _WIDE_WINDOWS):
            raise not_ported(f"{name}() over a window of {args[0].ltype!r} values")
        filt = binder.bind(fc.filter) if fc.filter is not None else None
        key = self.fresh(f"win.{name}")
        windows.append(P.BoundWindow(key, name, args, part, order, spec.frame, t,
                                     distinct=fc.distinct and name not in ("min", "max"),
                                     filter=filt))
        return B.BoundAggregateRef(key, t)

    def _distinct_on_window(self, sel, order_by, select_aliases, binder, windows):
        """DISTINCT ON (keys): row_number() over the keys in the statement's
        ORDER BY order, and the predicate that keeps its first row (DuckDB's
        first row of each key in ORDER BY order; any one row without an
        ORDER BY). Keys and ORDER BY items may name a select alias or a
        select-list position."""
        def resolve(e):
            if isinstance(e, N.Literal) and isinstance(e.value, int) \
                    and not isinstance(e.value, bool):
                return sel.select_list[e.value - 1][0]
            if isinstance(e, N.ColumnRef) and len(e.parts) == 1 \
                    and e.parts[0].lower() in select_aliases:
                return select_aliases[e.parts[0].lower()]
            return e

        part = [binder.bind(resolve(e)) for e in sel.distinct_on]
        order = [(binder.bind(resolve(it.expr)),) + self._direction(it)
                 for it in order_by]
        key = self.fresh("win.row_number")
        windows.append(P.BoundWindow(key, "row_number", [], part, order, None, BIGINT))
        return B.BoundComparison("=", B.BoundAggregateRef(key, BIGINT),
                                 B.BoundLiteral(1, BIGINT))

    def _setting(self, name: str, default):
        settings = getattr(self.catalog, "settings", None)
        return default if settings is None else settings.get(name, default)

    def _direction(self, it: N.OrderItem) -> tuple:
        """(descending, nulls_first) of an ORDER BY term: what it names,
        else the default_order and default_null_order settings, as DuckDB
        resolves ORDER_DEFAULT and ORDER_NULLS_DEFAULT (None: NULLS LAST)."""
        desc = it.descending if it.direction_given \
            else self._setting("default_order", "asc") == "desc"
        nf = it.nulls_first
        if nf is None:
            nf = {"nulls_first": True, "nulls_first_on_asc_last_on_desc": not desc,
                  "nulls_last_on_asc_first_on_desc": desc}.get(
                self._setting("default_null_order", "nulls_last"))
        return desc, nf

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
            items.append((be,) + self._direction(it))
        return P.Order(plan, items)


_STRICT = (B.BoundArithmetic, B.BoundNegate, B.BoundCast)


def _null_if_null(e: B.BoundExpr, key: str) -> bool:
    """True if e is NULL whenever the column `key` is (NULL passes through
    arithmetic, negation and casts; other forms are not relied on)."""
    if isinstance(e, B.BoundColumnRef):
        return e.key == key
    return isinstance(e, _STRICT) and any(_null_if_null(c, key) for c in e.children())


def _null_on_no_rows(e: B.BoundExpr, agg_funcs) -> bool:
    """True if the aggregate expression e is NULL over no input rows: it
    reaches a sum/avg/min/max through arithmetic, negation and casts
    (count is 0 over no rows; other forms are not relied on)."""
    if isinstance(e, B.BoundAggregateRef):
        return agg_funcs.get(e.key) not in (None, "count", "count_star")
    return isinstance(e, _STRICT) and any(_null_on_no_rows(c, agg_funcs)
                                          for c in e.children())


def _fold_aggregates(e: B.BoundExpr, agg_funcs) -> B.BoundExpr:
    """The aggregate expression e over no input rows: count folds to 0 and
    every other aggregate to NULL (of its own type)."""
    if isinstance(e, B.BoundAggregateRef):
        zero = agg_funcs.get(e.key) in ("count", "count_star")
        return B.BoundLiteral(0 if zero else None, e.ltype)
    changes = {}
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        if isinstance(v, B.BoundExpr):
            changes[f.name] = _fold_aggregates(v, agg_funcs)
        elif isinstance(v, list):
            changes[f.name] = [
                tuple(_fold_aggregates(y, agg_funcs) if isinstance(y, B.BoundExpr) else y
                      for y in x) if isinstance(x, tuple)
                else _fold_aggregates(x, agg_funcs) if isinstance(x, B.BoundExpr) else x
                for x in v]
    return dataclasses.replace(e, **changes)


@dataclass
class _ScalarAgg:
    """A correlated scalar subquery planned as a grouped aggregate."""

    plan: P.PlanNode  # Project(Aggregate(pool, groups), [(ref.key, value)])
    corr_eqs: list  # [(outer expr, inner expr)]
    groups: list  # [(group key, inner expr)], one per correlation equality
    ref: B.BoundColumnRef  # the subquery's value
    no_rows: Optional[B.BoundExpr]  # its value over no rows, where not NULL


def _find_scalar_subqueries(e) -> list:
    """The ScalarSubquery nodes in an expression (not descending into the
    subqueries themselves)."""
    if isinstance(e, N.ScalarSubquery):
        return [e]
    out = []
    if dataclasses.is_dataclass(e) and not isinstance(e, type):
        for f in dataclasses.fields(e):
            v = getattr(e, f.name)
            if isinstance(v, N.Expr):
                out += _find_scalar_subqueries(v)
            elif isinstance(v, (list, tuple)):
                out += [s for x in v if isinstance(x, N.Expr)
                        for s in _find_scalar_subqueries(x)]
    return out


def _contains_aggregate(e: N.Expr) -> bool:
    if isinstance(e, N.WindowFunction):
        # a windowed aggregate is not a GROUP BY aggregate, but an aggregate
        # in its arguments is (sum(sum(x)) OVER ())
        return any(_contains_aggregate(a) for a in e.func.args)
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


def _subst_aliases(e, aliases: Dict[str, N.Expr], scope: Scope):
    """e with each one-part column name that no column of `scope` answers
    to replaced by the select-list expression it aliases (not inside
    subqueries or window specifications)."""
    if isinstance(e, N.ColumnRef):
        if len(e.parts) == 1 and e.parts[0].lower() in aliases \
                and scope.try_resolve(e.parts) is None:
            return aliases[e.parts[0].lower()]
        return e
    if not isinstance(e, N.Expr) or not dataclasses.is_dataclass(e):
        return e
    changes = {}
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        if isinstance(v, N.Expr):
            nv = _subst_aliases(v, aliases, scope)
        elif isinstance(v, list):
            nv = [tuple(_subst_aliases(y, aliases, scope) for y in x) if isinstance(x, tuple)
                  else _subst_aliases(x, aliases, scope) for x in v]
        else:
            continue
        changes[f.name] = nv
    return dataclasses.replace(e, **changes) if changes else e


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
    """The reference's result types (duckdb_tpu/planner/planner.py)."""
    if func in ("count", "count_star", "regr_count", "count_if", "countif",
                "approx_count_distinct"):
        return BIGINT
    if func in STAT_AGGS or func in ("fsum", "product") or func in VARIANCE_AGGS:
        return DOUBLE
    if func in ("bool_and", "bool_or"):
        return BOOLEAN
    t = args[0].ltype if args else SQLNULL
    if func in ("median", "quantile_cont"):
        return t if t.id is TypeId.VARCHAR else DOUBLE
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
    if func in ("bit_and", "bit_or", "bit_xor") and t.id is TypeId.VARCHAR:
        # DuckDB's are over integers and BIT: no overload takes text
        raise B.BindError(f"Binder Error: No function matches the given name and argument "
                          f"types '{func}(VARCHAR)'. You might need to add explicit type casts.")
    if func in ("list", "array_agg", "approx_top_k"):
        return list_of(t)
    if func in ("histogram", "histogram_exact"):
        return map_of(t, BIGINT)
    if func in ("string_agg", "bitstring_agg"):
        return VARCHAR  # bitstring_agg's '0'/'1' text, as in the JAX package
    if func == "lttb":
        return list_of(struct_of(("x", t), ("y", DOUBLE)))
    return t  # min / max / first / last / any_value / arg_* / mode / quantile_disc


class _PostAggBinder(ExprBinder):
    """Binds select/having/order expressions after aggregation.

    Subtrees matching a GROUP BY expression become refs to the group output;
    aggregate calls route to the collector.
    """

    def __init__(self, scope, group_lookup, collector, subquery_binder):
        super().__init__(scope, agg_collector=collector, subquery_binder=subquery_binder)
        self.group_lookup = group_lookup

    def bind(self, e: N.Expr) -> B.BoundExpr:
        for ast, key, t in self.group_lookup:
            if ast is not None and _ast_eq(ast, e, self.scope):
                return B.BoundColumnRef(key, t)
        return super().bind(e)


def _ast_eq(a: N.Expr, b: N.Expr, scope: Scope) -> bool:
    """Two expressions are one: a column named or expanded from `*` by its
    binding, anything else by its syntax."""
    def key(e):
        if isinstance(e, KeyRef):
            return e.key
        if isinstance(e, N.ColumnRef):
            bd = scope.try_resolve(e.parts)
            return None if bd is None else bd.key
        return None

    if isinstance(a, (N.ColumnRef, KeyRef)) and isinstance(b, (N.ColumnRef, KeyRef)):
        ka = key(a)
        return ka is not None and ka == key(b)
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
