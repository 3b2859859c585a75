"""PIVOT and UNPIVOT, desugared over the data as the JAX package does
(duckdb_tpu/api/connection.py `_pivot`, `_unpivot`; DuckDB's
transform_pivot_stmt.cpp binds the same shapes).

PIVOT t ON e [IN (v, …)] USING agg(x) [GROUP BY g, …] is one SELECT: the
other columns, then one FILTERed aggregate per ON value, `agg(x) FILTER
(e = v)`, grouped and ordered by the other columns. The values are the
IN list, or the distinct non-NULL values of e, sorted. The SELECT is built
as a parse tree with each value a typed constant (CAST of its text to
e's type), and each column is named by the value cast to VARCHAR, as
DuckDB names it; the JAX package writes the values into SQL text (a quote
in a string breaks it, a DATE is read as arithmetic, a BOOLEAN column is
named 'True'): ROADMAP P1. Without GROUP BY the other columns are those
that neither e nor the USING aggregate names (their column references, not
a regex over their text).

UNPIVOT t ON c1, c2, … INTO NAME n VALUE v is a UNION ALL of one SELECT
per column: the other columns, the column's name and its value, NULLs left
out, as DuckDB does by default. The value column takes the ON columns'
common type, since the port's UNION ALL casts each input to the widest
type of its column (ROADMAP R5); the JAX package's casts the later inputs
to the first one's and truncates them (P2).
"""

from __future__ import annotations

import copy

from duckdb_tpu_torch.planner import macros as M
from duckdb_tpu_torch.planner.bound import BindError, not_ported
from duckdb_tpu_torch.sql import nodes as N
from duckdb_tpu_torch.sql.parser import Parser
from duckdb_tpu_torch.sql.walk import column_refs, table_ref
from duckdb_tpu_torch.types import VARCHAR


def _cast_to(e: N.Expr, t) -> N.Expr:
    """`CAST(e AS t)` as a parse tree."""
    name, mods = Parser(repr(t)).parse_type_name()
    return N.CastExpr(e, name, tuple(mods or ()))


class PivotMixin:
    """PIVOT and UNPIVOT of `Connection` (api/connection.py)."""

    def _output_of(self, table: str):
        """The (name, type) of each column `SELECT * FROM table` gives."""
        planner = self._planner()
        stmt = N.SelectStatement(node=N.SelectNode(select_list=[(N.Star(), None)],
                                                   from_table=table_ref(table)))
        try:
            _, output = planner.plan_select(M.expand_macros(stmt, planner.macros()))
        finally:
            self._drop_tables(planner.hidden_tables)
        return [(name, t) for name, _, t in output]

    def _pivot(self, s: N.PivotStatement):
        table = self._resolve_default(s.table)
        columns = self._output_of(table)

        def on():
            return Parser(s.on_sql).parse_expr()

        using = Parser(s.using_sql).parse_expr()
        if not isinstance(using, N.FunctionCall):
            raise not_ported("PIVOT … USING of an expression other than one aggregate call")
        if s.in_values is not None:
            # each value as it is written, named by its cast to VARCHAR
            names = self._select(N.SelectStatement(node=N.SelectNode(select_list=[
                (N.CastExpr(copy.deepcopy(v), "varchar"), f"c{i}")
                for i, v in enumerate(s.in_values)]))).rows()[0]
            values = list(zip(s.in_values, names))
        else:
            # the distinct ON values, sorted, with their VARCHAR names
            stmt = N.SelectStatement(
                node=N.SelectNode(select_list=[(on(), "v"), (N.CastExpr(on(), "varchar"), "s")],
                                  distinct=True, from_table=table_ref(table),
                                  where=N.IsNull(on(), negated=True)),
                order_by=[N.OrderItem(N.ColumnRef(("v",)))])
            res = self._select(stmt)
            on_type = res.types[0]
            values = [(N.Literal(text) if on_type == VARCHAR else _cast_to(N.Literal(text),
                                                                             on_type), text)
                      for _, text in res.rows()]
        names = [name for name, _ in columns]
        if s.group_by:
            groups = [self._pivot_column(names, g) for g in s.group_by]
        else:
            used = {r.parts[-1].lower() for r in column_refs([on(), using])}
            groups = [name for name in names if name.lower() not in used]
        aggs = []
        for const, text in values:
            agg = copy.deepcopy(using)
            match = N.BinaryOp("=", on(), const)
            agg.filter = match if agg.filter is None else N.Conjunction("and",
                                                                        [agg.filter, match])
            aggs.append((agg, text))
        refs = [N.ColumnRef((g,)) for g in groups]
        stmt = N.SelectStatement(
            node=N.SelectNode(select_list=[(r, None) for r in refs] + aggs,
                              from_table=table_ref(table), group_by=list(refs)),
            order_by=[N.OrderItem(N.ColumnRef((g,))) for g in groups])
        return self._select(stmt)

    @staticmethod
    def _pivot_column(names, name: str) -> str:
        for n in names:
            if n.lower() == name.lower():
                return n
        raise BindError(f'Binder Error: Referenced column "{name}" not found in FROM clause!')

    def _unpivot(self, s: N.UnpivotStatement):
        table = self._resolve_default(s.table)
        columns = self._output_of(table)
        names = [name for name, _ in columns]
        on = [self._pivot_column(names, c) for c in s.on_cols]
        others = [name for name in names if name not in on]
        node = None
        for c in on:
            part = N.SelectNode(
                select_list=[(N.ColumnRef((o,)), o) for o in others] + [
                    (N.Literal(c), s.name_col), (N.ColumnRef((c,)), s.value_col)],
                from_table=table_ref(table), where=N.IsNull(N.ColumnRef((c,)), negated=True))
            node = part if node is None else N.SetOpNode("union", True, node, part)
        return self._select(N.SelectStatement(node=node))
