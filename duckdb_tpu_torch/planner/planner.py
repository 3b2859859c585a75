"""Statement planner: parsed AST → plan tree.

As in the JAX package (duckdb_tpu/planner/planner.py), FROM flattens into
a pool of atoms (base tables, comma lists, [INNER] JOIN … ON); WHERE and ON
conjuncts over one atom become filters on it; the joins are ordered by the
DP of planner/join_order.py for three or more atoms, else by the greedy
probe spine with its snowflake collapse, and become inner equi-Join nodes.
WHERE-level subqueries are flattened (`_flatten_conjunct`): EXISTS, NOT
EXISTS, IN and NOT IN become semi/anti (null-aware for NOT IN) Join nodes
stacked on the pool, a correlated scalar aggregate becomes a grouped
aggregate atom joined on its correlation keys, and an uncorrelated scalar
subquery becomes a constant computed once (`BoundScalarSubquery`). On top
come GROUP BY with aggregates, HAVING, the projection, DISTINCT, ORDER BY
and LIMIT/OFFSET. Keys, output names and join orders match the reference's
for these shapes. IN/EXISTS outside a WHERE conjunct (MARK joins),
subqueries in FROM, outer joins, USING and NATURAL joins, table functions,
joins without an equi-join condition, CTEs, set operations and windows are
not yet ported and say so.
"""

from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

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
    max_logical_type,
)

# aggregates the fused pipeline computes (execution/fused_agg.py)
_PORTED_AGGS = {"sum", "count", "count_star", "avg", "min", "max"}


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
class SemiSpec:
    jtype: str  # semi | anti
    build_plan: P.PlanNode
    probe_keys: List[B.BoundExpr]  # over outer columns
    build_keys: List[B.BoundExpr]  # over subquery columns
    extra: Optional[B.BoundExpr]  # residual over combined columns
    null_aware: bool = False  # NOT IN semantics


def split_conjuncts(e: Optional[N.Expr]) -> List[N.Expr]:
    if e is None:
        return []
    if isinstance(e, N.Conjunction) and e.op == "and":
        out = []
        for c in e.children:
            out.extend(split_conjuncts(c))
        return out
    return [e]


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


class Planner:
    def __init__(self, catalog, routes=None):
        self.catalog = catalog
        # the Counter the executors of scalar subqueries report routes to
        # (the connection's); None gives each its own
        self.routes = routes
        self._key_counter = itertools.count()

    def fresh(self, name: str) -> str:
        return f"{name}#{next(self._key_counter)}"

    # -- entry ---------------------------------------------------------------
    def plan_select(self, stmt: N.SelectStatement, outer_scope=None):
        """→ (plan, output [(name, key, ltype)])."""
        if stmt.ctes:
            raise not_ported("WITH (common table expressions)")
        if not isinstance(stmt.node, N.SelectNode):
            raise not_ported(f"the query form {type(stmt.node).__name__}")
        plan, output, scope = self.plan_select_node(stmt.node, outer_scope)
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

    def _plan_base_table(self, ref: N.BaseTableRef):
        """→ (Scan, scope additions [(alias, col, key, type)], table rows)."""
        if ref.sample is not None or ref.column_aliases:
            raise not_ported("table samples and column alias lists")
        name = (f"{ref.schema}.{ref.name}" if ref.schema else ref.name).lower()
        if not self.catalog.has_table(name):
            raise BindError(f"Catalog Error: Table with name {ref.name} does not exist!")
        entry = self.catalog.get_table(name)
        alias = (ref.alias or ref.name).lower()
        cols = []
        scope_adds = []
        for cd in entry.columns:
            key = self.fresh(f"{alias}.{cd.name}")
            cols.append((cd.name, key, cd.ltype))
            scope_adds.append((alias, cd.name, key, cd.ltype))
        return P.Scan(entry.name, alias, cols), scope_adds, entry.nrows

    def collect_atoms(self, ref: N.TableRef, scope: Scope, atoms: List[Atom],
                      pred_asts: List[N.Expr]):
        """Flatten a FROM tree into atoms + predicate ASTs (inner joins only)."""
        if isinstance(ref, N.BaseTableRef):
            plan, scope_adds, nrows = self._plan_base_table(ref)
            self._add_atom(plan, scope_adds, nrows, scope, atoms, plan.table)
            return
        if isinstance(ref, N.JoinRef) and ref.join_type in ("inner", "cross"):
            if ref.using or ref.natural:
                raise not_ported("JOIN … USING and NATURAL JOIN")
            self.collect_atoms(ref.left, scope, atoms, pred_asts)
            self.collect_atoms(ref.right, scope, atoms, pred_asts)
            if ref.condition is not None:
                pred_asts.extend(split_conjuncts(ref.condition))
            return
        if isinstance(ref, N.JoinRef):
            raise not_ported(f"{ref.join_type.upper()} JOIN")
        raise not_ported(f"FROM {type(ref).__name__} (subqueries, table functions)")

    def _add_atom(self, plan, scope_adds, nrows, scope: Scope, atoms: List[Atom],
                  table: str):
        keys = set()
        col_of = {}
        for alias, col, key, t in scope_adds:
            scope.add(alias, col, key, t)
            keys.add(key)
            col_of[key] = (table, col)
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
        # duckdb/src/optimizer/join_order/); the JAX package's default, which
        # this port has no setting to turn off. Greedy below takes oversized
        # and disconnected graphs.
        if len(by_id) >= 3:
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
                # the JAX package plans a keyless Join (its IEJoin path) or a
                # CrossJoin here
                raise not_ported("joins without an equi-join condition")
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

    def plan_select_node(self, sel: N.SelectNode, outer_scope=None):
        if sel.from_table is None:
            raise not_ported("SELECT without FROM")
        if sel.sample is not None or sel.qualify is not None or sel.distinct_on:
            raise not_ported("SAMPLE, QUALIFY and DISTINCT ON")
        scope = Scope(parent=outer_scope)
        atoms: List[Atom] = []
        pred_asts: List[N.Expr] = []
        self.collect_atoms(sel.from_table, scope, atoms, pred_asts)
        binder = self._pred_binder(scope)
        bound_preds: List[B.BoundExpr] = []
        semis: List[SemiSpec] = []
        local_keys = set().union(*[a.keys for a in atoms])
        for ast in pred_asts + split_conjuncts(sel.where):
            if not self._flatten_conjunct(ast, scope, local_keys, bound_preds,
                                          semis, atoms):
                bound_preds.append(binder.bind(ast))
        plan = self._stack_semis(self.plan_pool(atoms, bound_preds), semis)

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

        post = _PostAggBinder(scope, group_lookup, collector, self._bind_subquery_expr)
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

    # -- subqueries -------------------------------------------------------------
    def _pred_binder(self, scope: Scope) -> ExprBinder:
        return ExprBinder(scope, subquery_binder=self._bind_subquery_expr)

    def _bind_subquery_expr(self, e, binder: ExprBinder):
        """A subquery that no WHERE conjunct flattened: an uncorrelated
        scalar subquery becomes a lazy constant. IN and EXISTS here need
        the reference's MARK join (BoundMarkSubquery), not yet ported."""
        if isinstance(e, N.ScalarSubquery):
            plan, output = self.plan_select(e.subquery)
            _, key, t = output[0]
            return BoundScalarSubquery(self, plan, key, t)
        raise not_ported(f"{type(e).__name__} outside a WHERE conjunct (MARK joins)")

    @staticmethod
    def _stack_semis(plan, semis: List[SemiSpec]):
        for s in semis:
            plan = P.Join(plan, s.build_plan, s.jtype, s.probe_keys, s.build_keys,
                          s.extra, null_aware=s.null_aware)
        return plan

    def _flatten_conjunct(self, ast, scope, local_keys, bound_preds, semis,
                          atoms) -> bool:
        """Handle EXISTS / IN-subquery / correlated scalar-agg conjuncts."""
        neg = False
        inner = ast
        if isinstance(inner, N.NotExpr):
            neg = True
            inner = inner.child
        if isinstance(inner, N.Exists):
            self._plan_semijoin_exists(inner.subquery, None, neg != inner.negated,
                                       scope, local_keys, semis)
            return True
        if isinstance(inner, N.InSubquery):
            self._plan_semijoin_exists(inner.subquery, inner.expr,
                                       neg != inner.negated, scope, local_keys, semis)
            return True
        if isinstance(inner, N.BinaryOp) and inner.op in B._CMP_OPS and not neg:
            for e_side, other, flip in ((inner.right, inner.left, False),
                                        (inner.left, inner.right, True)):
                subs = _find_scalar_subqueries(e_side)
                if len(subs) == 1 and not _find_scalar_subqueries(other):
                    sq = subs[0]
                    sub_ref = self._correlated_scalar_ref(
                        sq.subquery, scope, local_keys, bound_preds, atoms)
                    if sub_ref is None:
                        return False  # uncorrelated → normal binding path

                    # bind the containing expression with the subquery node
                    # replaced by the grouped-aggregate output column (e.g.
                    # `price > 1.2 * (SELECT avg(...) WHERE corr)`)
                    def sq_binder(e, b, _sq=sq, _ref=sub_ref):
                        if e is _sq:
                            return _ref
                        return self._bind_subquery_expr(e, b)

                    side_b = ExprBinder(scope, subquery_binder=sq_binder).bind(e_side)
                    if not _null_if_null(side_b, sub_ref.key):
                        raise not_ported(
                            "a correlated scalar subquery inside an expression that "
                            "is not NULL when the subquery is (it needs an outer join)")
                    other_b = self._pred_binder(scope).bind(other)
                    lhs, rhs = (side_b, other_b) if flip else (other_b, side_b)
                    bound_preds.append(B.BoundComparison(inner.op, lhs, rhs))
                    return True
        return False

    def _plan_sub_pool(self, sub: N.SelectStatement, scope, local_keys):
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
        if sel.from_table is None:
            raise not_ported("a subquery without FROM")
        sub_scope = Scope(parent=scope)
        sub_atoms: List[Atom] = []
        pred_asts: List[N.Expr] = []
        self.collect_atoms(sel.from_table, sub_scope, sub_atoms, pred_asts)
        sub_keys = set().union(*[a.keys for a in sub_atoms])
        binder = self._pred_binder(sub_scope)
        local_bound, corr_eqs, corr_extra = [], [], []
        sub_semis: List[SemiSpec] = []
        for ast in pred_asts + split_conjuncts(sel.where):
            if self._flatten_conjunct(ast, sub_scope, sub_keys, local_bound,
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

    def _plan_semijoin_exists(self, sub, in_expr, negated, scope, local_keys, semis):
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
            build, output = self.plan_select(sub)
            _, okey, ot = output[0]
            outer_b = self._pred_binder(scope).bind(in_expr)
            semis.append(SemiSpec(jtype, build, [outer_b], [B.BoundColumnRef(okey, ot)],
                                  None, null_aware=negated))
            return
        (sub_atoms, local_bound, corr_eqs, corr_extra, sub_scope, sel,
         sub_semis) = self._plan_sub_pool(sub, scope, local_keys)
        build = self._stack_semis(self.plan_pool(sub_atoms, local_bound), sub_semis)
        probe_keys = [o for o, _ in corr_eqs]
        build_keys = [i for _, i in corr_eqs]
        if in_expr is not None:
            # IN: add the expr = select-item equality
            if len(sel.select_list) != 1:
                raise BindError("IN subquery must select one column")
            inner_b = self._pred_binder(sub_scope).bind(sel.select_list[0][0])
            outer_b = self._pred_binder(scope).bind(in_expr)
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
        if negated and in_expr is not None and extra is not None:
            # NOT IN's NULL cases read the build rows the correlation selects;
            # the eager anti join finds them through equalities only
            raise not_ported("NOT IN over a subquery correlated by more than equalities")
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

    def _correlated_scalar_ref(self, sub, scope, local_keys, bound_preds, atoms):
        """`(SELECT agg-expr FROM … WHERE corr)` → a grouped-aggregate atom
        equi-joined on the correlation keys; returns a BoundColumnRef over
        its output (None when the subquery is not a flattenable correlated
        scalar aggregate). Reference: FlattenDependentJoins,
        duckdb/src/planner/subquery/flatten_dependent_join.cpp."""
        try:
            (sub_atoms, local_bound, corr_eqs, corr_extra, sub_scope, sel,
             sub_semis) = self._plan_sub_pool(sub, scope, local_keys)
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
        sub_binder = self._pred_binder(sub_scope)
        # group by the inner correlation expressions
        groups = [(self.fresh("corr"), inner_e) for _, inner_e in corr_eqs]
        aggs: List[B.BoundAggregate] = []

        def collector(fc, b):
            return self._bind_aggregate_call(fc, sub_binder, aggs)

        post = ExprBinder(sub_scope, agg_collector=collector,
                          subquery_binder=self._bind_subquery_expr)
        item_b = post.bind(item_ast)
        if not _null_on_no_rows(item_b, {a.key: a.func for a in aggs}):
            # the inner join drops the outer rows that no subquery row
            # matches, which is right only when the value over no rows is
            # NULL (the JAX package flattens count(*) here too and loses
            # those rows)
            raise not_ported("a correlated scalar subquery whose value over no rows "
                             "is not NULL, such as count or coalesce (it needs an "
                             "outer join)")
        out_key = self.fresh("subagg")
        agg_plan = P.Project(P.Aggregate(subplan, groups, aggs), [(out_key, item_b)])
        # an atom of the pool, joined on the correlation keys
        keys = {out_key} | {k for k, _ in groups}
        atoms.append(Atom(50_000 + len(atoms), agg_plan, 10_000, keys))
        for (outer_e, inner_e), (gkey, _) in zip(corr_eqs, groups):
            bound_preds.append(B.BoundComparison(
                "=", outer_e, B.BoundColumnRef(gkey, inner_e.ltype)))
        return B.BoundColumnRef(out_key, item_b.ltype)

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

    def __init__(self, scope, group_lookup, collector, subquery_binder):
        super().__init__(scope, agg_collector=collector, subquery_binder=subquery_binder)
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
