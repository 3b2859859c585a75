"""Recursive-descent SQL parser (Pratt expressions).

Surface parity target: the reference's SQL dialect (SELECT with CTEs,
subqueries, window functions, set ops, DDL/DML, COPY, PRAGMA/SET/CALL).
Grammar reference: duckdb/src/parser/peg/grammar/statements/.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from duckdb_tpu_torch.sql.lexer import LexError, Token, TokType, tokenize
from duckdb_tpu_torch.sql.nodes import *  # noqa: F401,F403
from duckdb_tpu_torch.sql import nodes as N


class ParserError(ValueError):
    pass


# keywords that terminate an expression / cannot start a primary
_STOP_KEYWORDS = {
    "from", "where", "group", "having", "order", "limit", "offset", "union",
    "except", "intersect", "on", "using", "join", "inner", "left", "right",
    "full", "cross", "when", "then", "else", "end", "as", "asc", "desc",
    "nulls", "and", "or", "not", "between", "in", "like", "ilike", "is",
    "escape", "qualify", "window", "partition", "rows", "range", "semi",
    "anti", "natural", "fetch", "for",
}

_JOIN_TYPES = {"inner", "left", "right", "full", "cross", "semi", "anti", "outer"}

_TYPE_NAME_WORDS = {
    "int", "integer", "int4", "bigint", "int8", "smallint", "int2", "tinyint",
    "int1", "hugeint", "boolean", "bool", "float", "real", "float4", "double",
    "float8", "decimal", "numeric", "varchar", "text", "string", "char",
    "date", "time", "timestamp", "datetime", "interval", "blob", "bytea",
    "uinteger", "ubigint", "usmallint", "utinyint", "json",
}


class Parser:
    def __init__(self, sql: str):
        self.sql = sql
        self.toks = tokenize(sql)
        self.i = 0
        self.param_count = 0

    # -- token helpers --------------------------------------------------------
    def peek(self, off: int = 0) -> Token:
        return self.toks[min(self.i + off, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        if t.type != TokType.EOF:
            self.i += 1
        return t

    def kw(self, off: int = 0) -> str:
        """lowercased keyword view of the token at offset."""
        t = self.peek(off)
        return t.value.lower() if t.type == TokType.IDENT else ""

    def accept_kw(self, *words: str) -> bool:
        for j, w in enumerate(words):
            if self.kw(j) != w:
                return False
        self.i += len(words)
        return True

    def expect_kw(self, word: str):
        if not self.accept_kw(word):
            raise ParserError(f"expected {word.upper()} near {self.peek().value!r} (pos {self.peek().pos})")

    def accept_op(self, op: str) -> bool:
        t = self.peek()
        if t.type == TokType.OP and t.value == op:
            self.i += 1
            return True
        return False

    def expect_op(self, op: str):
        if not self.accept_op(op):
            raise ParserError(f"expected {op!r} near {self.peek().value!r} (pos {self.peek().pos})")

    def expect_ident(self) -> str:
        t = self.peek()
        if t.type != TokType.IDENT:
            raise ParserError(f"expected identifier near {t.value!r} (pos {t.pos})")
        self.i += 1
        return t.value

    # -- entry ----------------------------------------------------------------
    def parse_statements(self) -> List[object]:
        stmts = []
        while self.peek().type != TokType.EOF:
            if self.accept_op(";"):
                continue
            stmts.append(self.parse_statement())
            if not self.accept_op(";"):
                break
        if self.peek().type != TokType.EOF:
            raise ParserError(f"unexpected input near {self.peek().value!r} (pos {self.peek().pos})")
        return stmts

    def parse_statement(self):
        k = self.kw()
        if k in ("select", "with", "values") or self.peek().value == "(":
            return self.parse_select_statement()
        if k == "from":
            return self.parse_from_first()
        if k == "create":
            return self.parse_create()
        if k == "drop":
            return self.parse_drop()
        if k == "insert":
            return self.parse_insert()
        if k == "delete":
            return self.parse_delete()
        if k == "update":
            return self.parse_update()
        if k == "copy":
            return self.parse_copy()
        if k == "alter":
            return self.parse_alter()
        if k == "pivot":
            return self.parse_pivot()
        if k == "unpivot":
            return self.parse_unpivot()
        if k in ("export", "import"):
            self.next()
            self.expect_kw("database")
            path = self.next().value
            if k == "import":
                return N.ImportStatement(path)
            fmt = "csv"
            if self.accept_op("("):
                if self.accept_kw("format"):
                    fmt = self.next().value.lower()
                self.expect_op(")")
            return N.ExportStatement(path, fmt)
        if k == "merge":
            return self.parse_merge()
        if k == "attach":
            # ATTACH [DATABASE] [IF NOT EXISTS] 'path' [AS alias]
            # [(READ_ONLY)] (reference: src/parser/statement/attach_statement)
            self.next()
            self.accept_kw("database")
            if_not_exists = bool(self.accept_kw("if", "not", "exists"))
            path = self.next().value
            alias = None
            if self.accept_kw("as"):
                alias = self.expect_ident()
            read_only = False
            if self.accept_op("("):
                while self.peek().value != ")":
                    opt = self.next().value.lower()
                    if opt == "read_only":
                        read_only = True
                    self.accept_op(",")
                self.expect_op(")")
            return N.AttachStatement(path, alias, read_only=read_only,
                                     if_not_exists=if_not_exists)
        if k == "use":
            self.next()
            return N.UseStatement(self.parse_qualified_ident())
        if k == "detach":
            self.next()
            self.accept_kw("database")
            if_exists = bool(self.accept_kw("if", "exists"))
            return N.DetachStatement(self.expect_ident(),
                                     if_exists=if_exists)
        if k == "explain":
            self.next()
            analyze = self.accept_kw("analyze")
            return N.ExplainStatement(self.parse_statement(), analyze=analyze)
        if k in ("set", "reset"):
            return self.parse_set(k)
        if k == "pragma":
            return self.parse_pragma()
        if k == "call":
            return self.parse_call()
        if k in ("begin", "commit", "rollback", "abort", "checkpoint"):
            self.next()
            if k == "begin":
                self.accept_kw("transaction")
            return N.TransactionStatement("rollback" if k == "abort" else k)
        if k in ("describe", "show"):
            self.next()
            name = self.expect_ident()
            return N.PragmaStatement("show", [N.Literal(name)])
        if k == "prepare":
            # PREPARE name AS <statement>: keep the raw text so EXECUTE
            # re-parses with parameters substituted (reference:
            # src/parser/statement/prepare_statement.cpp)
            self.next()
            name = self.expect_ident()
            self.expect_kw("as")
            start = self.peek().pos
            self.parse_statement()  # validate + advance
            end = (self.peek().pos if self.peek().type != TokType.EOF
                   else len(self.sql))
            return N.PrepareStatement(name, self.sql[start:end].rstrip("; "))
        if k == "execute":
            self.next()
            name = self.expect_ident()
            args = []
            if self.accept_op("("):
                if self.peek().value != ")":
                    args.append(self.parse_expr())
                    while self.accept_op(","):
                        args.append(self.parse_expr())
                self.expect_op(")")
            return N.ExecuteStatement(name, args)
        if k == "deallocate":
            self.next()
            self.accept_kw("prepare")
            nm = None
            if self.kw() != "" and self.peek().value != ";":
                nm = self.expect_ident()
            return N.DeallocateStatement(nm)
        if k == "comment":
            self.next()
            self.expect_kw("on")
            kind = self.next().value.lower()
            if kind == "materialized":  # MATERIALIZED VIEW
                self.expect_kw("view")
                kind = "view"
            name = self.parse_qualified_ident()
            self.expect_kw("is")
            if self.accept_kw("null"):
                comment = None
            else:
                tok = self.next()
                comment = tok.value
            return N.CommentStatement(kind, name, comment)
        if k in ("vacuum", "analyze"):
            # VACUUM/ANALYZE recompute stats; stats here are maintained on
            # every column mutation, so these accept-and-succeed
            self.next()
            while (self.peek().type != TokType.EOF
                   and self.peek().value != ";"):
                self.next()
            return N.PragmaStatement("vacuum", [])
        if k == "truncate":
            self.next()
            self.accept_kw("table")
            name = self.parse_qualified_ident()
            return N.DeleteStatement(name, None, None)
        raise ParserError(f"unsupported statement start {self.peek().value!r}")

    # -- SELECT ---------------------------------------------------------------
    def parse_select_statement(self) -> N.SelectStatement:
        ctes: List[N.CTE] = []
        if self.accept_kw("with"):
            recursive = self.accept_kw("recursive")
            while True:
                name = self.expect_ident()
                col_aliases: Tuple[str, ...] = ()
                if self.accept_op("("):
                    cols = [self.expect_ident()]
                    while self.accept_op(","):
                        cols.append(self.expect_ident())
                    self.expect_op(")")
                    col_aliases = tuple(cols)
                self.expect_kw("as")
                materialized = None
                if self.accept_kw("materialized"):
                    materialized = True
                elif self.accept_kw("not", "materialized"):
                    materialized = False
                self.expect_op("(")
                sub = self.parse_select_statement()
                self.expect_op(")")
                if any(c.name.lower() == name.lower() for c in ctes):
                    raise ParserError(
                        f'Binder Error: Duplicate CTE name "{name}"')
                ctes.append(
                    N.CTE(name, sub, col_aliases, materialized, recursive=recursive)
                )
                if not self.accept_op(","):
                    break
        node = self.parse_set_op_tree()
        order_by, limit, offset = self.parse_order_limit()
        gb = getattr(node, "_grouping_branches", None)
        if gb and any(self._contains_grouping(oi.expr) for oi in order_by):
            # ORDER BY over GROUPING(): fold per desugared branch via hidden
            # select columns, order an outer wrapper by them, EXCLUDE them
            import copy as _copy

            hidden = []
            for idx, oi in enumerate(order_by):
                if not self._contains_grouping(oi.expr):
                    continue
                al = f"__grp_ord_{idx}"
                for b, absent in gb:
                    b.select_list.append(
                        (self._rewrite_grouping(_copy.deepcopy(oi.expr),
                                                absent), al))
                order_by[idx] = N.OrderItem(N.ColumnRef((al,)),
                                            oi.descending, oi.nulls_first)
                hidden.append(al)
            inner = N.SelectStatement(node, ctes=ctes)
            wrap = N.SelectNode(
                select_list=[(N.Star(exclude=tuple(hidden)), None)],
                from_table=N.SubqueryRef(inner, alias="__grp_wrap"))
            return N.SelectStatement(wrap, order_by=order_by, limit=limit,
                                     offset=offset)
        return N.SelectStatement(node, ctes=ctes, order_by=order_by, limit=limit, offset=offset)

    def parse_from_first(self):
        """FROM-first syntax (reference PEG grammar: `FROM tbl [SELECT ...]`
        with an implicit SELECT *)."""
        self.expect_kw("from")
        node = N.SelectNode()
        node.from_table = self.parse_table_ref()
        if self.accept_kw("using", "sample"):
            node.sample = self.parse_sample_clause()
        if self.accept_kw("where"):
            node.where = self.parse_expr()
        grouping_sets = None
        if self.accept_kw("group", "by"):
            if self.accept_kw("all"):
                node.group_by_all = True
            else:
                grouping_sets = self._parse_group_by_elements(node)
        if self.accept_kw("having"):
            node.having = self.parse_expr()
        if self.accept_kw("select"):
            while True:
                node.select_list.append(self.parse_select_item())
                if not self.accept_op(","):
                    break
        else:
            node.select_list.append((N.Star(), None))
        if self.accept_kw("qualify"):
            node.qualify = self.parse_expr()
        out = node
        order_by, limit, offset = self.parse_order_limit()
        if grouping_sets is not None:
            # ORDER BY expressions over GROUPING() must fold per branch:
            # materialize them as hidden select columns before the desugar,
            # then order an outer wrapper by those columns and EXCLUDE them
            hidden = []
            for idx, oi in enumerate(order_by):
                if self._contains_grouping(oi.expr):
                    al = f"__grp_ord_{idx}"
                    node.select_list.append((oi.expr, al))
                    order_by[idx] = N.OrderItem(
                        N.ColumnRef((al,)), oi.descending, oi.nulls_first)
                    hidden.append(al)
            out = self._desugar_grouping_sets(node, grouping_sets)
            if hidden:
                inner = N.SelectStatement(out)
                wrap = N.SelectNode(
                    select_list=[(N.Star(exclude=tuple(hidden)), None)],
                    from_table=N.SubqueryRef(inner, alias="__grp_wrap"))
                return N.SelectStatement(wrap, order_by=order_by,
                                         limit=limit, offset=offset)
        return N.SelectStatement(out, order_by=order_by, limit=limit,
                                 offset=offset)

    def _contains_grouping(self, e) -> bool:
        import dataclasses

        if isinstance(e, N.FunctionCall) and e.name.lower() in (
                "grouping", "grouping_id"):
            return True
        if dataclasses.is_dataclass(e) and not isinstance(e, type):
            return any(self._contains_grouping(getattr(e, f.name))
                       for f in dataclasses.fields(e))
        if isinstance(e, (list, tuple)):
            return any(self._contains_grouping(x) for x in e)
        return False

    def parse_order_limit(self):
        order_by: List[N.OrderItem] = []
        limit = offset = None
        if self.accept_kw("order", "by"):
            order_by.append(self.parse_order_item())
            while self.accept_op(","):
                order_by.append(self.parse_order_item())
        while True:
            if self.kw() == "limit":
                self.next()
                limit = self.parse_expr()
            elif self.kw() == "offset":
                self.next()
                offset = self.parse_expr()
            else:
                break
        return order_by, limit, offset

    def parse_order_item(self) -> N.OrderItem:
        e = self.parse_expr()
        desc = False
        if self.accept_kw("desc"):
            desc = True
        elif self.accept_kw("asc"):
            pass
        nulls_first = None
        if self.accept_kw("nulls", "first"):
            nulls_first = True
        elif self.accept_kw("nulls", "last"):
            nulls_first = False
        return N.OrderItem(e, descending=desc, nulls_first=nulls_first)

    def parse_set_op_tree(self):
        left = self.parse_query_term()
        while True:
            k = self.kw()
            if k in ("union", "except", "intersect"):
                self.next()
                is_all = self.accept_kw("all")
                if not is_all:
                    self.accept_kw("distinct")
                right = self.parse_query_term()
                left = N.SetOpNode(k, is_all, left, right)
            else:
                return left

    def parse_query_term(self):
        if self.accept_op("("):
            inner = self.parse_select_statement()
            self.expect_op(")")
            # a parenthesized select with its own order/limit stays a statement
            if inner.order_by or inner.limit is not None or inner.ctes:
                return inner
            return inner.node
        if self.kw() == "values":
            self.next()
            rows = []
            while True:
                self.expect_op("(")
                row = [self.parse_expr()]
                while self.accept_op(","):
                    row.append(self.parse_expr())
                self.expect_op(")")
                rows.append(row)
                if not self.accept_op(","):
                    break
            return N.ValuesNode(rows)
        return self.parse_select_node()

    def parse_select_node(self) -> N.SelectNode:
        self.expect_kw("select")
        node = N.SelectNode()
        if self.accept_kw("distinct"):
            if self.accept_kw("on"):
                self.expect_op("(")
                node.distinct_on.append(self.parse_expr())
                while self.accept_op(","):
                    node.distinct_on.append(self.parse_expr())
                self.expect_op(")")
            node.distinct = True
        elif self.accept_kw("all"):
            pass
        # select list
        while True:
            node.select_list.append(self.parse_select_item())
            if not self.accept_op(","):
                break
        if self.accept_kw("from"):
            node.from_table = self.parse_table_ref()
            if self.accept_kw("using", "sample"):
                node.sample = self.parse_sample_clause()
        if self.accept_kw("where"):
            node.where = self.parse_expr()
        if self.accept_kw("using", "sample"):  # also legal after WHERE
            node.sample = self.parse_sample_clause()
        grouping_sets = None
        if self.accept_kw("group", "by"):
            if self.accept_kw("all"):
                node.group_by_all = True
            else:
                grouping_sets = self._parse_group_by_elements(node)
        if self.accept_kw("having"):
            node.having = self.parse_expr()
        if self.accept_kw("qualify"):
            node.qualify = self.parse_expr()
        if grouping_sets is not None:
            return self._desugar_grouping_sets(node, grouping_sets)
        return node

    def _parse_group_by_elements(self, node):
        """GROUP BY list with GROUPING SETS / ROLLUP / CUBE elements.

        Returns None for a plain list (stored on node.group_by), else the
        combined list of grouping sets (cross-product across elements, as in
        the reference's Transformer::TransformGroupBy,
        src/parser/transform/statement/transform_select_node.cpp).
        """
        elems = []  # each element: list of alternative key-lists
        while True:
            if self.accept_kw("grouping", "sets"):
                self.expect_op("(")
                gs = [self._parse_grouping_set()]
                while self.accept_op(","):
                    gs.append(self._parse_grouping_set())
                self.expect_op(")")
                elems.append(gs)
            elif self.accept_kw("rollup"):
                es = self._parse_paren_exprs()
                elems.append([es[:i] for i in range(len(es), -1, -1)])
            elif self.accept_kw("cube"):
                es = self._parse_paren_exprs()
                subs = [[es[i] for i in range(len(es)) if (mask >> i) & 1]
                        for mask in range(1 << len(es))]
                subs.sort(key=len, reverse=True)
                elems.append(subs)
            else:
                elems.append([[self.parse_expr()]])
            if not self.accept_op(","):
                break
        if all(len(g) == 1 for g in elems):
            node.group_by = [e for g in elems for e in g[0]]
            return None
        sets = [[]]
        for g in elems:
            sets = [s + alt for s in sets for alt in g]
        return sets

    def _parse_paren_exprs(self):
        self.expect_op("(")
        es = [self.parse_expr()]
        while self.accept_op(","):
            es.append(self.parse_expr())
        self.expect_op(")")
        return es

    def _parse_grouping_set(self):
        if self.accept_op("("):
            if self.accept_op(")"):
                return []
            es = [self.parse_expr()]
            while self.accept_op(","):
                es.append(self.parse_expr())
            self.expect_op(")")
            return es
        return [self.parse_expr()]

    def _desugar_grouping_sets(self, node, sets):
        """Desugar to UNION ALL: one aggregate branch per grouping set, with
        rolled-up keys replaced by NULL literals and GROUPING() calls folded
        to constants. Each branch then rides the existing fused single-set
        aggregate pipeline (the TPU-friendly shape: N independent dense
        aggregations instead of the reference's shared multi-set hash table,
        src/execution/operator/aggregate/physical_hash_aggregate.cpp)."""
        import copy

        all_keys = []
        for s_ in sets:
            for e in s_:
                if e not in all_keys:
                    all_keys.append(e)
        branches = []
        for s_ in sets:
            b = copy.deepcopy(node)
            b.group_by = copy.deepcopy(s_)
            absent = [k for k in all_keys if k not in s_]
            b.select_list = [(self._rewrite_grouping(e, absent), a)
                             for (e, a) in b.select_list]
            if b.having is not None:
                b.having = self._rewrite_grouping(b.having, absent)
            branches.append(b)
        out = branches[0]
        for b in branches[1:]:
            out = N.SetOpNode("union", True, out, b)
        # remember branch → rolled-up-keys pairs so statement-level ORDER BY
        # expressions over GROUPING() can be folded per branch later
        out._grouping_branches = [
            (b, [k for k in all_keys if k not in s_])
            for b, s_ in zip(branches, sets)]
        return out

    def _rewrite_grouping(self, e, absent):
        """Replace rolled-up key references with NULL and GROUPING(...) with
        its constant bitmask; aggregate arguments are left untouched (they
        still see the raw column)."""
        import dataclasses

        if not (isinstance(e, N.Expr)
                or (dataclasses.is_dataclass(e)
                    and not isinstance(e, type))):
            return e
        if isinstance(e, N.Expr) and any(e == k for k in absent):
            return N.Literal(None)
        if isinstance(e, N.FunctionCall):
            name = e.name.lower()
            if name in ("grouping", "grouping_id"):
                val = 0
                for a in e.args:
                    val = val * 2 + (1 if any(a == k for k in absent) else 0)
                return N.Literal(val)
            from duckdb_tpu_torch.planner.binder import AGGREGATE_NAMES

            if name in AGGREGATE_NAMES:
                return e
        if not dataclasses.is_dataclass(e):
            return e

        def walk(v):
            # recurse into nested dataclasses too (WindowSpec, OrderItem —
            # GROUPING() is legal inside OVER(PARTITION BY ...))
            if isinstance(v, N.Expr) or (dataclasses.is_dataclass(v)
                                         and not isinstance(v, type)):
                return self._rewrite_grouping(v, absent)
            if isinstance(v, list):
                return [walk(x) for x in v]
            if isinstance(v, tuple):
                return tuple(walk(x) for x in v)
            return v

        kw = {f.name: walk(getattr(e, f.name)) for f in dataclasses.fields(e)}
        return type(e)(**kw)

    def parse_sample_clause(self):
        """USING SAMPLE <n> [% | PERCENT | ROWS] [(method [, seed])]
        [REPEATABLE (seed)] — reference grammar in
        src/parser/transform/helpers/transform_sample.cpp."""
        method = None
        # method-first form: USING SAMPLE reservoir(10 ROWS)
        if (self.peek().type == TokType.IDENT
                and self.kw() in ("reservoir", "bernoulli", "system")
                and self.peek(1).value == "("):
            method = self.next().value.lower()
            self.expect_op("(")
            amount = self.parse_unary()  # bare literal: '%' must stay a unit
            unit = "percent"
            if self.accept_kw("rows"):
                unit = "rows"
            elif self.accept_kw("percent") or self.accept_op("%"):
                unit = "percent"
            self.expect_op(")")
        else:
            amount = self.parse_unary()  # bare literal: '%' must stay a unit
            unit = "rows"
            if self.accept_op("%") or self.accept_kw("percent"):
                unit = "percent"
            elif self.accept_kw("rows"):
                unit = "rows"
        seed = None
        if self.accept_op("("):
            method = self.expect_ident().lower()
            if self.accept_op(","):
                seed = int(self.next().value)
            self.expect_op(")")
        if self.accept_kw("repeatable"):
            self.expect_op("(")
            seed = int(self.next().value)
            self.expect_op(")")
        return (amount, unit, method, seed)

    def parse_select_item(self) -> Tuple[N.Expr, Optional[str]]:
        # [table.]* [EXCLUDE(...)]
        if self.peek().value == "*" and self.peek().type == TokType.OP:
            self.next()
            exclude = self._parse_star_modifiers()
            return (N.Star(exclude=exclude), None)
        if (
            self.peek().type == TokType.IDENT
            and self.peek(1).value == "."
            and self.peek(2).value == "*"
        ):
            tname = self.next().value
            self.next()
            self.next()
            exclude = self._parse_star_modifiers()
            return (N.Star(table=tname, exclude=exclude), None)
        e = self.parse_expr()
        alias = None
        if self.accept_kw("as"):
            alias = self.expect_ident()
        elif self.peek().type == TokType.IDENT and self.kw() not in _STOP_KEYWORDS:
            alias = self.next().value
        elif self.peek().type == TokType.STRING:
            alias = self.next().value
        return (e, alias)

    def _parse_star_modifiers(self) -> Tuple[str, ...]:
        exclude: Tuple[str, ...] = ()
        if self.accept_kw("exclude"):
            self.expect_op("(")
            cols = [self.expect_ident()]
            while self.accept_op(","):
                cols.append(self.expect_ident())
            self.expect_op(")")
            exclude = tuple(cols)
        return exclude

    # -- FROM / joins ----------------------------------------------------------
    def parse_table_ref(self) -> N.TableRef:
        left = self.parse_join_operand()
        while True:
            if self.accept_op(","):
                right = self.parse_join_operand()
                left = N.JoinRef(left, right, "cross")
                continue
            natural = False
            save = self.i
            if self.accept_kw("natural"):
                natural = True
            jt = None
            k = self.kw()
            if k == "positional":
                self.next()
                self.expect_kw("join")
                right = self.parse_join_operand()
                left = N.JoinRef(left, right, "positional")
                continue
            if k == "asof":
                self.next()
                if self.accept_kw("left"):
                    self.accept_kw("outer")
                    jt = "asof_left"
                else:
                    jt = "asof"
                self.expect_kw("join")
            elif k in _JOIN_TYPES:
                self.next()
                if k in ("left", "right", "full"):
                    self.accept_kw("outer")
                jt = "inner" if k == "outer" else k
                self.expect_kw("join")
            elif k == "join":
                self.next()
                jt = "inner"
            else:
                self.i = save
                return left
            right = self.parse_join_operand()
            cond = None
            using: Tuple[str, ...] = ()
            if jt != "cross" and not natural:
                if self.accept_kw("on"):
                    cond = self.parse_expr()
                elif self.accept_kw("using"):
                    self.expect_op("(")
                    cols = [self.expect_ident()]
                    while self.accept_op(","):
                        cols.append(self.expect_ident())
                    self.expect_op(")")
                    using = tuple(cols)
            left = N.JoinRef(left, right, jt, condition=cond, using=using, natural=natural)

    def parse_join_operand(self) -> N.TableRef:
        if self.accept_op("("):
            # subquery (possibly a parenthesized set-op tree) or nested join
            if self.kw() in ("select", "with", "values") or self.peek().value == "(":
                save = self.i
                try:
                    sub = self.parse_select_statement()
                    self.expect_op(")")
                except ParserError:
                    self.i = save
                    inner = self.parse_table_ref()
                    self.expect_op(")")
                    return inner
                alias, col_aliases = self.parse_alias()
                return N.SubqueryRef(sub, alias, col_aliases)
            inner = self.parse_table_ref()
            self.expect_op(")")
            return inner
        if self.peek().type == TokType.STRING:
            # file path scan: FROM 'foo.csv'
            path = self.next().value
            alias, col_aliases = self.parse_alias()
            return N.TableFunctionRef("__file_scan", [N.Literal(path)], alias, col_aliases)
        name = self.expect_ident()
        schema = None
        if self.accept_op("."):
            schema = name
            name = self.expect_ident()
        if self.peek().value == "(" and self.peek().type == TokType.OP:
            # table function
            self.next()
            args = []
            if self.peek().value != ")":
                args.append(self.parse_tf_arg())
                while self.accept_op(","):
                    args.append(self.parse_tf_arg())
            self.expect_op(")")
            alias, col_aliases = self.parse_alias()
            return N.TableFunctionRef(name.lower(), args, alias, col_aliases)
        alias, col_aliases = self.parse_alias()
        sample = None
        if self.accept_kw("tablesample"):
            sample = self.parse_sample_clause()
        return N.BaseTableRef(name, schema=schema, alias=alias,
                              column_aliases=col_aliases, sample=sample)

    def parse_tf_arg(self) -> N.Expr:
        # named arg: ident := expr  or  ident => expr
        if (self.peek().type == TokType.IDENT
                and self.peek(1).type == TokType.OP
                and self.peek(1).value in (":=", "=>")):
            name = self.next().value
            self.next()
            return N.BinaryOp(":=", N.ColumnRef((name,)), self.parse_expr())
        return self.parse_expr()

    def parse_alias(self) -> Tuple[Optional[str], Tuple[str, ...]]:
        alias = None
        if self.accept_kw("as"):
            alias = self.expect_ident()
        elif (
            self.peek().type == TokType.IDENT
            and self.kw() not in _STOP_KEYWORDS
            and self.kw() not in ("join", "asof", "tablesample",
                                  "positional", "select")
        ):
            alias = self.next().value
        col_aliases: Tuple[str, ...] = ()
        if alias is not None and self.peek().value == "(" and self._looks_like_col_alias_list():
            self.next()
            cols = [self.expect_ident()]
            while self.accept_op(","):
                cols.append(self.expect_ident())
            self.expect_op(")")
            col_aliases = tuple(cols)
        return alias, col_aliases

    def _looks_like_col_alias_list(self) -> bool:
        # "(ident[, ident]*)" strictly
        j = 1
        if self.peek(j).type != TokType.IDENT:
            return False
        j += 1
        while self.peek(j).value == ",":
            j += 1
            if self.peek(j).type != TokType.IDENT:
                return False
            j += 1
        return self.peek(j).value == ")"

    def _at_paren_lambda(self) -> bool:
        """At `( ident [, ident]* ) ->`?"""
        if not (self.peek().type == TokType.OP and self.peek().value == "("):
            return False
        j = 1
        while True:
            if self.peek(j).type != TokType.IDENT:
                return False
            j += 1
            if self.peek(j).value == ",":
                j += 1
                continue
            return (self.peek(j).value == ")" and self.peek(j + 1).type == TokType.OP
                    and self.peek(j + 1).value == "->")

    # -- expressions (Pratt) ----------------------------------------------------
    def parse_expr(self) -> N.Expr:
        # lambdas (list_transform/list_filter args): `x -> expr` (legacy
        # single-arrow) and `lambda x: expr` (current reference syntax)
        if (self.peek().type == TokType.IDENT
                and self.kw() not in _STOP_KEYWORDS
                and self.peek(1).type == TokType.OP
                and self.peek(1).value == "->"
                # `x -> 'key'` / `x -> 0` is the JSON extract operator, not
                # a lambda (the reference deprecated single-arrow lambdas
                # over exactly this ambiguity); constant-body lambdas must
                # use `lambda x: 'const'`
                and self.peek(2).type not in (TokType.STRING,
                                              TokType.NUMBER)
                and self.peek(2).value != ">"):
            param = self.next().value
            self.next()
            return N.LambdaExpr(param, self.parse_expr())
        if self._at_paren_lambda():
            # (a, x) -> expr: DuckDB's two-parameter arrow form (without this
            # the parenthesized list parses as a row and -> as JSON extract)
            self.next()
            params = [self.expect_ident()]
            while self.accept_op(","):
                params.append(self.expect_ident())
            self.expect_op(")")
            self.expect_op("->")
            if len(params) > 2:
                raise ParserError("at most two lambda parameters (x, i)")
            return N.LambdaExpr(params[0], self.parse_expr(),
                                index_param=(params[1] if len(params) > 1 else None))
        if (self.kw() == "lambda" and self.peek(1).type == TokType.IDENT
                and self.peek(2).value in (":", ",")):
            self.next()
            params = [self.expect_ident()]
            while self.accept_op(","):
                params.append(self.expect_ident())
            self.expect_op(":")
            if len(params) > 2:
                raise ParserError("at most two lambda parameters (x, i)")
            return N.LambdaExpr(params[0], self.parse_expr(),
                                index_param=(params[1] if len(params) > 1
                                             else None))
        return self.parse_or()

    def parse_or(self) -> N.Expr:
        left = self.parse_and()
        if self.kw() != "or":
            return left
        children = [left]
        while self.accept_kw("or"):
            children.append(self.parse_and())
        return N.Conjunction("or", children)

    def parse_and(self) -> N.Expr:
        left = self.parse_not()
        if self.kw() != "and":
            return left
        children = [left]
        while self.accept_kw("and"):
            children.append(self.parse_not())
        return N.Conjunction("and", children)

    def parse_not(self) -> N.Expr:
        if self.accept_kw("not"):
            return N.NotExpr(self.parse_not())
        return self.parse_is()

    def parse_is(self) -> N.Expr:
        left = self.parse_comparison()
        while self.kw() == "is":
            self.next()
            negated = self.accept_kw("not")
            if self.accept_kw("distinct", "from"):
                right = self.parse_comparison()
                left = N.IsDistinctFrom(left, right, negated=negated)
            elif self.accept_kw("null"):
                left = N.IsNull(left, negated=negated)
            elif self.accept_kw("true"):
                cmpe = N.BinaryOp("=", left, N.Literal(True))
                left = N.NotExpr(cmpe) if negated else cmpe
            elif self.accept_kw("false"):
                cmpe = N.BinaryOp("=", left, N.Literal(False))
                left = N.NotExpr(cmpe) if negated else cmpe
            else:
                raise ParserError(f"unexpected IS clause near {self.peek().value!r}")
        return left

    _CMP_OPS = {"=", "<>", "!=", "<", "<=", ">", ">="}

    # operator → equivalent function-call rewrite at the comparison level
    # (reference: these are registered operator aliases — ~~ = like,
    # ^@ = starts_with, @>/<@ = list_has_all, && = list_has_any,
    # <-> = list_distance, <=> = list_cosine_distance, ~ = regexp)
    _LIKEISH_OPS = {"~~", "!~~", "~~*", "!~~*", "~~~", "^@", "<@", "@>",
                    "&&", "<->", "<=>", "~", "!~"}

    def parse_comparison(self) -> N.Expr:
        left = self.parse_additive_chain()
        while True:
            t = self.peek()
            if t.type == TokType.OP and t.value in self._LIKEISH_OPS:
                self.next()
                right = self.parse_additive_chain()
                v = t.value
                if v in ("~~", "!~~", "~~*", "!~~*"):
                    left = N.LikeExpr(left, right, negated=v.startswith("!"),
                                      case_insensitive=v.endswith("*"))
                elif v == "~~~":
                    left = N.FunctionCall("glob", [left, right])
                elif v == "^@":
                    left = N.FunctionCall("starts_with", [left, right])
                elif v == "@>":
                    left = N.FunctionCall("list_has_all", [left, right])
                elif v == "<@":
                    left = N.FunctionCall("list_has_all", [right, left])
                elif v == "&&":
                    left = N.FunctionCall("list_has_any", [left, right])
                elif v == "<->":
                    left = N.FunctionCall("list_distance", [left, right])
                elif v == "<=>":
                    left = N.FunctionCall("list_cosine_distance",
                                          [left, right])
                elif v == "~":
                    left = N.FunctionCall("regexp_full_match", [left, right])
                else:  # !~
                    left = N.NotExpr(
                        N.FunctionCall("regexp_full_match", [left, right]))
                continue
            if t.type == TokType.OP and t.value in self._CMP_OPS:
                self.next()
                op = "<>" if t.value == "!=" else t.value
                # quantified subquery: = ANY(...), > ALL(...)
                if self.kw() in ("any", "all", "some") and self.peek(1).value == "(":
                    raise ParserError("ANY/ALL subqueries not yet supported")
                right = self.parse_additive_chain()
                left = N.BinaryOp(op, left, right)
                continue
            negated = False
            save = self.i
            if self.kw() == "not" and self.kw(1) in ("between", "in", "like", "ilike"):
                self.next()
                negated = True
            k = self.kw()
            if k == "between":
                self.next()
                low = self.parse_additive_chain()
                self.expect_kw("and")
                high = self.parse_additive_chain()
                left = N.Between(left, low, high, negated=negated)
                continue
            if k in ("like", "ilike"):
                self.next()
                pattern = self.parse_additive_chain()
                if self.accept_kw("escape"):
                    self.parse_additive_chain()  # only default escape supported
                left = N.LikeExpr(left, pattern, negated=negated, case_insensitive=(k == "ilike"))
                continue
            if k == "in":
                self.next()
                self.expect_op("(")
                if self.kw() in ("select", "with", "values"):
                    sub = self.parse_select_statement()
                    self.expect_op(")")
                    left = N.InSubquery(left, sub, negated=negated)
                else:
                    items = [self.parse_expr()]
                    while self.accept_op(","):
                        items.append(self.parse_expr())
                    self.expect_op(")")
                    left = N.InList(left, items, negated=negated)
                continue
            self.i = save
            return left

    def parse_additive_chain(self) -> N.Expr:
        left = self.parse_bitops()
        while self.accept_op("||"):
            left = N.BinaryOp("||", left, self.parse_bitops())
        return left

    def parse_bitops(self) -> N.Expr:
        """Bitwise &, |, <<, >> (one level, left-assoc — the reference
        groups "other operators" at a single precedence below +/-,
        src/parser/peg/grammar expression rules / PostgreSQL operator
        precedence)."""
        left = self.parse_additive()
        while True:
            t = self.peek()
            if t.type == TokType.OP and t.value in ("&", "|", "<<", ">>"):
                self.next()
                left = N.FunctionCall(t.value, [left, self.parse_additive()])
            else:
                return left

    def parse_additive(self) -> N.Expr:
        left = self.parse_multiplicative()
        while True:
            t = self.peek()
            if t.type == TokType.OP and t.value in ("+", "-"):
                self.next()
                left = N.BinaryOp(t.value, left, self.parse_multiplicative())
            else:
                return left

    def parse_multiplicative(self) -> N.Expr:
        left = self.parse_unary()
        while True:
            t = self.peek()
            if t.type == TokType.OP and t.value in ("*", "/", "%", "//"):
                self.next()
                left = N.BinaryOp(t.value, left, self.parse_unary())
            else:
                return left

    def parse_unary(self) -> N.Expr:
        t = self.peek()
        if t.type == TokType.OP and t.value in ("-", "+"):
            self.next()
            child = self.parse_unary()
            if t.value == "-":
                if isinstance(child, N.Literal) and isinstance(child.value, (int, float)):
                    return N.Literal(-child.value, child.type_hint)
                return N.UnaryOp("-", child)
            return child
        if t.type == TokType.OP and t.value == "~":
            self.next()
            return N.FunctionCall("~", [self.parse_unary()])
        if t.type == TokType.OP and t.value == "@":
            self.next()
            return N.FunctionCall("abs", [self.parse_unary()])
        return self.parse_power()

    def parse_power(self) -> N.Expr:
        """`^` / `**` exponentiation: binds tighter than unary minus,
        right-associative (PostgreSQL semantics, kept by the reference:
        -2^2 = -4, 2^3^2 = 2^(3^2))."""
        left = self.parse_postfix()
        t = self.peek()
        if t.type == TokType.OP and t.value in ("^", "**"):
            self.next()
            return N.FunctionCall("power", [left, self.parse_unary()])
        return left

    def parse_postfix(self) -> N.Expr:
        e = self.parse_primary()
        while True:
            if self.accept_op("::"):
                tname, mods = self.parse_type_name()
                e = N.CastExpr(e, tname, mods)
            elif self.accept_kw("collate"):
                # expr COLLATE name[.name...] (reference grammar: a_expr
                # COLLATE any_name, src/parser/transform/expression/)
                cname = self.expect_ident().lower()
                while self.peek().value == "." and self.peek(1).type == \
                        TokType.IDENT:
                    self.next()
                    cname += "." + self.expect_ident().lower()
                e = N.CollateExpr(e, cname)
            elif self.peek().value == "[" and self.peek().type == TokType.OP:
                # 1-based list index / struct field access (reference grammar:
                # a_expr indirection in the PEG expression rules)
                self.next()
                idx = self.parse_expr()
                if self.accept_op(":"):  # slice e[a:b], 1-based inclusive
                    hi = self.parse_expr()
                    self.expect_op("]")
                    e = N.FunctionCall("list_slice", [e, idx, hi])
                    continue
                self.expect_op("]")
                if isinstance(idx, N.Literal) and isinstance(idx.value, str):
                    e = N.FunctionCall("struct_extract", [e, idx])
                else:
                    e = N.FunctionCall("list_extract", [e, idx])
            elif self.peek().value == "." and self.peek().type == TokType.OP:
                # struct field access or qualified ref handled in primary; here
                # only allow ident chaining on ColumnRef
                if isinstance(e, N.ColumnRef) and self.peek(1).type == TokType.IDENT:
                    self.next()
                    pos = self.peek().pos
                    e = N.ColumnRef(e.parts + (self.expect_ident(),))
                    e._pos = pos  # where its last part starts (api/alter.py)
                elif self.peek(1).type == TokType.IDENT:
                    # non-column expression: {'a':1}.a is struct field
                    # access; ('x').upper() is dot function chaining
                    # (reference: transform_columnref.cpp dot resolution)
                    self.next()
                    name = self.expect_ident()
                    if self.peek().value == "(" and \
                            self.peek().type == TokType.OP:
                        self.next()
                        args = [e]
                        if not self.accept_op(")"):
                            args.append(self.parse_expr())
                            while self.accept_op(","):
                                args.append(self.parse_expr())
                            self.expect_op(")")
                        e = N.FunctionCall(name, args)
                    else:
                        e = N.FunctionCall("struct_extract",
                                           [e, N.Literal(name)])
                else:
                    break
            elif self.peek().value in ("->", "->>") \
                    and self.peek().type == TokType.OP:
                # JSON extract operators: doc -> path (JSON), doc ->> path
                # (text). Reference: json extension operator registration.
                fn = ("json_extract" if self.peek().value == "->"
                      else "json_extract_string")
                self.next()
                # rhs is a primary so chains stay left-associative:
                # d -> 'a' -> 0 == (d -> 'a') -> 0
                e = N.FunctionCall(fn, [e, self.parse_primary()])
            elif (self.peek().value == "!" and self.peek().type == TokType.OP
                  and self.peek(1).value != "="):
                # postfix factorial (reference: "!__postfix" operator)
                self.next()
                e = N.FunctionCall("factorial", [e])
            else:
                break
        return e

    def parse_type_name(self) -> Tuple[str, Tuple[int, ...]]:
        name = self.expect_ident().lower()
        # two-word types
        if name == "double" and self.kw() == "precision":
            self.next()
            name = "double"
        if name == "struct" and self.peek().value == "(":
            # STRUCT(a INT, b VARCHAR) → canonical name string, re-parsed by
            # resolve_type_name (keeps the (name, mods) plumbing unchanged)
            self.next()
            fields = []
            while True:
                fname = self.expect_ident()
                ftype, fmods = self.parse_type_name()
                if fmods:
                    ftype += "(" + ",".join(str(m) for m in fmods) + ")"
                fields.append(f"{fname} {ftype}")
                if not self.accept_op(","):
                    break
            self.expect_op(")")
            name = "struct(" + ", ".join(fields) + ")"
            while (self.peek().value == "[" and self.peek(1).value == "]"):
                self.next(); self.next()
                name += "[]"
            return name, ()
        if name == "union" and self.peek().value == "(":
            # UNION(num INT, str VARCHAR) → canonical name, mirrors STRUCT
            self.next()
            fields = []
            while True:
                fname = self.expect_ident()
                ftype, fmods = self.parse_type_name()
                if fmods:
                    ftype += "(" + ",".join(str(m) for m in fmods) + ")"
                fields.append(f"{fname} {ftype}")
                if not self.accept_op(","):
                    break
            self.expect_op(")")
            return "union(" + ", ".join(fields) + ")", ()
        if name in ("timestamp", "time") and self.kw() in ("with", "without"):
            tz = self.kw() == "with"
            self.accept_kw("with", "time", "zone") or self.accept_kw("without", "time", "zone")
            if tz and name == "timestamp":
                name = "timestamptz"
        mods: Tuple[int, ...] = ()
        if self.peek().value == "(":
            self.next()
            nums = [int(self.next().value)]
            while self.accept_op(","):
                nums.append(int(self.next().value))
            self.expect_op(")")
            mods = tuple(nums)
        while (self.peek().value == "[" and self.peek().type == TokType.OP
               and self.peek(1).value in ("]",)
               or (self.peek().value == "["
                   and self.peek(1).type == TokType.NUMBER
                   and self.peek(2).value == "]")):
            self.next()
            if self.peek().type == TokType.NUMBER:
                n = int(self.next().value)
                name += f"[{n}]"  # fixed-size ARRAY (reference types.hpp)
            else:
                name += "[]"
            self.expect_op("]")
        return name, mods

    def parse_primary(self) -> N.Expr:
        t = self.peek()
        if t.type == TokType.OP and t.value == "[":
            # list literal [e1, e2, ...]
            self.next()
            args = []
            if self.peek().value != "]":
                args.append(self.parse_expr())
                while self.accept_op(","):
                    args.append(self.parse_expr())
            self.expect_op("]")
            return N.FunctionCall("list_value", args)
        if (t.type == TokType.IDENT and t.value.lower() == "map"
                and self.peek(1).value == "{"):
            self.next()
            e = self.parse_primary()  # the {..} literal
            e.name = "map_pack_kv"
            return e
        if t.type == TokType.OP and t.value == "{":
            # struct literal {'name': expr, ...}
            self.next()
            args = []
            while True:
                ktok = self.next()
                kv = (int(ktok.value)
                      if ktok.type == TokType.NUMBER and "." not in ktok.value
                      else str(ktok.value))
                self.expect_op(":")
                args.append(N.Literal(kv))
                args.append(self.parse_expr())
                if not self.accept_op(","):
                    break
            self.expect_op("}")
            return N.FunctionCall("struct_pack_kv", args)
        if t.type == TokType.NUMBER:
            self.next()
            v = t.value
            if "." in v or "e" in v or "E" in v:
                if "e" in v or "E" in v:
                    return N.Literal(float(v))
                return N.Literal(v, type_hint="decimal")
            return N.Literal(int(v))
        if t.type == TokType.STRING:
            self.next()
            return N.Literal(t.value)
        if t.type == TokType.OP:
            if t.value == "(":
                self.next()
                if self.kw() in ("select", "with", "values"):
                    sub = self.parse_select_statement()
                    self.expect_op(")")
                    return N.ScalarSubquery(sub)
                e = self.parse_expr()
                if self.peek().value == ",":  # row constructor → function row()
                    args = [e]
                    while self.accept_op(","):
                        args.append(self.parse_expr())
                    self.expect_op(")")
                    return N.FunctionCall("row", args)
                self.expect_op(")")
                return e
            if t.value == "?":
                self.next()
                self.param_count += 1
                return N.Parameter(self.param_count)
            if t.value.startswith("$") and t.value[1:].isdigit():
                self.next()
                self.param_count = max(self.param_count, int(t.value[1:]))
                return N.Parameter(int(t.value[1:]))
            if t.value == "*":
                self.next()
                return N.Star()
            raise ParserError(f"unexpected token {t.value!r} (pos {t.pos})")
        k = t.value.lower()
        # keyword-literals
        if k in ("true", "false"):
            self.next()
            return N.Literal(k == "true")
        if k == "null":
            self.next()
            return N.Literal(None)
        if k in ("date", "timestamp", "time") and self.peek(1).type == TokType.STRING:
            self.next()
            return N.Literal(self.next().value, type_hint=k)
        if k in ("timestamptz", "bit", "bitstring") \
                and self.peek(1).type == TokType.STRING:
            self.next()
            return N.CastExpr(N.Literal(self.next().value),
                              "timestamptz" if k == "timestamptz" else "bit",
                              ())
        if (k in ("timestamp", "time")
                and self.kw(1) in ("with", "without")
                and self.peek(4).type == TokType.STRING):
            # TIMESTAMP WITH TIME ZONE '...' typed literal
            tz = self.kw(1) == "with"
            base = k
            for _ in range(4):
                self.next()
            name = ("timestamptz" if tz and base == "timestamp" else base)
            return N.CastExpr(N.Literal(self.next().value), name, ())
        if k == "interval":
            self.next()
            if self.peek().type == TokType.STRING:
                val = self.next().value
                unit = None
                if self.peek().type == TokType.IDENT and self.kw() in _INTERVAL_UNITS:
                    unit = self.next().value.lower()
                return N.IntervalLiteral(val, unit)
            if self.peek().type == TokType.NUMBER \
                    and self.peek(1).type == TokType.IDENT:
                val = self.next().value
                unit = self.next().value.lower()
                return N.IntervalLiteral(val, unit)
            if self.peek().value == "(" or \
                    self.peek().type in (TokType.NUMBER, TokType.IDENT):
                # INTERVAL (expr) unit — expression intervals bind to the
                # to_<unit> constructors (reference transform_interval.cpp)
                e = self.parse_unary()
                unit = self.expect_ident().lower()
                fn = {
                    "year": "to_years", "years": "to_years",
                    "month": "to_months", "months": "to_months",
                    "week": "to_weeks", "weeks": "to_weeks",
                    "day": "to_days", "days": "to_days",
                    "hour": "to_hours", "hours": "to_hours",
                    "minute": "to_minutes", "minutes": "to_minutes",
                    "second": "to_seconds", "seconds": "to_seconds",
                    "millisecond": "to_milliseconds",
                    "milliseconds": "to_milliseconds",
                    "microsecond": "to_microseconds",
                    "microseconds": "to_microseconds",
                }.get(unit)
                if fn is None:
                    raise ParserError(f"bad INTERVAL unit {unit}")
                return N.FunctionCall(fn, [e])
            raise ParserError("bad INTERVAL literal")
        if k == "case":
            return self.parse_case()
        if k == "cast" or k == "try_cast":
            self.next()
            self.expect_op("(")
            child = self.parse_expr()
            self.expect_kw("as")
            tname, mods = self.parse_type_name()
            self.expect_op(")")
            return N.CastExpr(child, tname, mods, try_cast=(k == "try_cast"))
        if k == "extract":
            self.next()
            self.expect_op("(")
            fld = self.expect_ident().lower()
            self.expect_kw("from")
            child = self.parse_expr()
            self.expect_op(")")
            return N.ExtractExpr(fld, child)
        if k == "substring" and self.peek(1).value == "(":
            # substring(x FROM a FOR b) or substring(x, a, b)
            self.next()
            self.expect_op("(")
            x = self.parse_expr()
            if self.accept_kw("from"):
                a = self.parse_expr()
                b = None
                if self.accept_kw("for"):
                    b = self.parse_expr()
                self.expect_op(")")
                args = [x, a] + ([b] if b is not None else [])
                return N.FunctionCall("substring", args)
            args = [x]
            while self.accept_op(","):
                args.append(self.parse_expr())
            self.expect_op(")")
            return N.FunctionCall("substring", args)
        if k == "overlay" and self.peek(1).value == "(":
            # overlay(x PLACING y FROM a [FOR b]) — standard SQL form only
            self.next()
            self.expect_op("(")
            x = self.parse_expr()
            self.expect_kw("placing")
            y = self.parse_expr()
            self.expect_kw("from")
            a = self.parse_expr()
            b = None
            if self.accept_kw("for"):
                b = self.parse_expr()
            self.expect_op(")")
            args = [x, y, a] + ([b] if b is not None else [])
            return N.FunctionCall("overlay", args)
        if k == "exists" and self.peek(1).value == "(":
            self.next()
            self.next()
            sub = self.parse_select_statement()
            self.expect_op(")")
            return N.Exists(sub)
        if k == "not":
            self.next()
            return N.NotExpr(self.parse_not())
        if t.type == TokType.IDENT:
            # function call?
            if self.peek(1).value == "(" and self.peek(1).type == TokType.OP:
                return self.parse_function_call()
            # column ref (possibly qualified — qualification chained in postfix)
            self.next()
            ref = N.ColumnRef((t.value,))
            ref._pos = t.pos  # where its name starts (api/alter.py)
            return ref
        raise ParserError(f"unexpected token {t.value!r} (pos {t.pos})")

    def parse_case(self) -> N.Expr:
        self.expect_kw("case")
        operand = None
        if self.kw() != "when":
            operand = self.parse_expr()
        whens = []
        while self.accept_kw("when"):
            cond = self.parse_expr()
            self.expect_kw("then")
            val = self.parse_expr()
            whens.append((cond, val))
        else_expr = None
        if self.accept_kw("else"):
            else_expr = self.parse_expr()
        self.expect_kw("end")
        return N.CaseExpr(operand, whens, else_expr)

    def parse_function_call(self) -> N.Expr:
        name = self.next().value.lower()
        self.expect_op("(")
        distinct = False
        is_star = False
        args: List[N.Expr] = []
        order_by: List[N.OrderItem] = []
        if self.peek().value == ")":
            self.next()
        else:
            if self.accept_kw("distinct"):
                distinct = True
            if self.peek().value == "*":
                if distinct:
                    raise ParserError(
                        "Binder Error: DISTINCT is not implemented for *")
                self.next()
                is_star = True
            else:
                args.append(self.parse_tf_arg())
                while self.accept_op(","):
                    args.append(self.parse_tf_arg())
            if self.accept_kw("order", "by"):
                order_by.append(self.parse_order_item())
                while self.accept_op(","):
                    order_by.append(self.parse_order_item())
            self.expect_op(")")
        fc = N.FunctionCall(name, args, distinct=distinct, is_star=is_star, order_by=order_by)
        if self.accept_kw("within", "group"):
            # ordered-set syntax: percentile_cont(q) WITHIN GROUP (ORDER BY e)
            # rewrites to the regular two-argument aggregate form
            self.expect_op("(")
            self.expect_kw("order")
            self.expect_kw("by")
            oe = self.parse_order_item()
            self.expect_op(")")
            lname = fc.name.lower()
            mapped = {"percentile_cont": "quantile_cont",
                      "percentile_disc": "quantile_disc",
                      "mode": "mode"}.get(lname, lname)
            if lname == "mode":
                fc = N.FunctionCall("mode", [oe.expr], distinct=distinct)
            else:
                fc = N.FunctionCall(mapped, [oe.expr] + args,
                                    distinct=distinct)
        if self.accept_kw("filter"):
            self.expect_op("(")
            self.accept_kw("where")  # FILTER (expr) and FILTER (WHERE expr)
            fc.filter = self.parse_expr()
            self.expect_op(")")
        if self.kw() == "over":
            self.next()
            spec = N.WindowSpec()
            self.expect_op("(")
            if self.accept_kw("partition", "by"):
                spec.partition_by.append(self.parse_expr())
                while self.accept_op(","):
                    spec.partition_by.append(self.parse_expr())
            if self.accept_kw("order", "by"):
                spec.order_by.append(self.parse_order_item())
                while self.accept_op(","):
                    spec.order_by.append(self.parse_order_item())
            if self.kw() in ("rows", "range"):
                mode = self.next().value.lower()
                spec.frame = self.parse_frame(mode)
            self.expect_op(")")
            return N.WindowFunction(fc, spec)
        return fc

    def parse_frame(self, mode: str):
        def bound():
            if self.accept_kw("unbounded", "preceding"):
                return ("unbounded_preceding", None)
            if self.accept_kw("unbounded", "following"):
                return ("unbounded_following", None)
            if self.accept_kw("current", "row"):
                return ("current", None)
            e = self.parse_expr()
            if self.accept_kw("preceding"):
                return ("preceding", e)
            self.expect_kw("following")
            return ("following", e)

        if self.accept_kw("between"):
            start = bound()
            self.expect_kw("and")
            end = bound()
        else:
            start = bound()
            end = ("current", None)
        return (mode, start, end)

    # -- DDL/DML ----------------------------------------------------------------
    def parse_qualified_ident(self):
        """ident[.ident] → dot-joined catalog name (schema qualification).

        A '.' INSIDE a (quoted) identifier is data, not structure: it is
        escaped as \x02 so the catalog can tell `"a.b"` (one table named
        a.b) from `a.b` (table b in schema a); catalog.qualify unescapes."""
        name = self.expect_ident().replace(".", "\x02")
        if self.accept_op("."):
            name = name + "." + self.expect_ident().replace(".", "\x02")
        return name

    def parse_create(self):
        self.expect_kw("create")
        or_replace = False
        if self.accept_kw("or", "replace"):
            or_replace = True
        temporary = self.accept_kw("temporary") or self.accept_kw("temp")
        if self.accept_kw("schema"):
            if_not_exists = bool(self.accept_kw("if", "not", "exists"))
            return N.CreateSchema(self.parse_qualified_ident(),
                                  if_not_exists=if_not_exists)
        if (self.kw() == "unique" and self.kw(1) == "index") \
                or self.kw() == "index":
            unique = bool(self.accept_kw("unique"))
            self.expect_kw("index")
            if_not_exists = bool(self.accept_kw("if", "not", "exists"))
            name = self.expect_ident()
            self.expect_kw("on")
            table = self.parse_qualified_ident()
            if self.accept_kw("using"):
                self.next()  # index type (art etc.) — metadata only
            self.expect_op("(")
            exprs = []
            depth = 0
            start = self.peek().pos
            # index key expressions are stored as TEXT (arbitrary exprs
            # allowed); split on top-level commas
            while not (depth == 0 and self.peek().value == ")"):
                v = self.peek().value
                if v == "(":
                    depth += 1
                elif v == ")":
                    depth -= 1
                elif v == "," and depth == 0:
                    exprs.append(self.sql[start:self.peek().pos].strip())
                    start = self.peek().pos + 1
                self.next()
            exprs.append(self.sql[start:self.peek().pos].strip())
            self.expect_op(")")
            return N.CreateIndex(name, table, exprs, unique=unique,
                                 if_not_exists=if_not_exists)
        if self.accept_kw("macro") or self.accept_kw("function"):
            return self.parse_create_macro(or_replace)
        if self.accept_kw("table"):
            if_not_exists = bool(self.accept_kw("if", "not", "exists"))
            name = self.parse_qualified_ident()
            if self.accept_kw("as"):
                if self.kw() == "from":  # CTAS over FROM-first syntax
                    sel = self.parse_from_first()
                else:
                    sel = self.parse_select_statement()
                return N.CreateTable(name, as_select=sel, if_not_exists=if_not_exists,
                                     or_replace=or_replace, temporary=temporary)
            self.expect_op("(")
            cols = []
            constraints = []
            while True:
                if self.kw() in ("primary", "unique", "check", "foreign",
                                 "constraint"):
                    constraints.extend(self.parse_table_constraint())
                else:
                    cname = self.expect_ident()
                    tname, mods = self.parse_type_name()
                    spec = N.ColumnSpec(cname, tname, mods)
                    while True:
                        if self.accept_kw("not", "null"):
                            spec.not_null = True
                        elif self.accept_kw("null"):
                            pass
                        elif self.accept_kw("primary", "key"):
                            spec.primary_key = True
                            spec.not_null = True
                        elif self.accept_kw("default"):
                            _d0 = self.peek().pos
                            spec.default = self.parse_expr()
                            spec.default_text = \
                                self.sql[_d0:self.peek().pos].strip()
                        elif self.accept_kw("unique"):
                            spec.unique = True
                        elif self.accept_kw("check"):
                            spec.check = self._parse_check_text()
                        elif self.accept_kw("references"):
                            rt = self.parse_qualified_ident()
                            rc = None
                            if self.accept_op("("):
                                rc = self.expect_ident()
                                self.expect_op(")")
                            spec.references = (rt, rc)
                        else:
                            break
                    cols.append(spec)
                if not self.accept_op(","):
                    break
            self.expect_op(")")
            return N.CreateTable(name, columns=cols, constraints=constraints,
                                 if_not_exists=if_not_exists,
                                 or_replace=or_replace, temporary=temporary)
        if self.accept_kw("view"):
            name = self.parse_qualified_ident()
            self.expect_kw("as")
            return N.CreateView(name, self.parse_select_statement(),
                                or_replace=or_replace, temporary=temporary)
        if self.accept_kw("sequence"):
            if_not_exists = bool(self.accept_kw("if", "not", "exists"))
            name = self.expect_ident()
            start, inc = 1, 1
            while True:
                if self.accept_kw("start"):
                    self.accept_kw("with")
                    start = int(self.next().value)
                elif self.accept_kw("increment"):
                    self.accept_kw("by")
                    inc = int(self.next().value)
                else:
                    break
            return N.CreateSequence(name, start, inc, if_not_exists)
        if self.accept_kw("type"):
            if_not_exists = bool(self.accept_kw("if", "not", "exists"))
            name = self.expect_ident()
            self.expect_kw("as")
            if self.accept_kw("enum"):
                self.expect_op("(")
                vals = []
                while True:
                    vals.append(str(self.next().value))
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
                return N.CreateType(name, enum_values=tuple(vals),
                                    or_replace=or_replace,
                                    if_not_exists=if_not_exists)
            base, mods = self.parse_type_name()
            return N.CreateType(name, base=base, base_mods=tuple(mods or ()),
                                or_replace=or_replace,
                                if_not_exists=if_not_exists)
        raise ParserError("unsupported CREATE")

    def _expr_text(self, parse=None) -> str:
        """Parse an expression, returning its original SQL text slice."""
        p0 = self.peek().pos
        (parse or self.parse_expr)()
        return self.sql[p0:self.peek().pos].strip().rstrip(",")

    def parse_pivot(self):
        """PIVOT tbl ON expr [IN (v,...)] USING agg [GROUP BY cols]
        (reference grammar: src/parser/transform/statement/transform_pivot_
        stmt.cpp; desugared over the data by the connection)."""
        self.expect_kw("pivot")
        table = self.expect_ident()
        self.expect_kw("on")
        # additive level only: a trailing IN (...) is the pivot value list
        on_sql = self._expr_text(self.parse_additive_chain)
        in_values = None
        if self.accept_kw("in"):
            self.expect_op("(")
            in_values = [self.parse_expr()]
            while self.accept_op(","):
                in_values.append(self.parse_expr())
            self.expect_op(")")
        self.expect_kw("using")
        using_sql = self._expr_text()
        if self.accept_kw("as"):
            self.expect_ident()  # alias folded into generated names
        group_by = ()
        if self.accept_kw("group", "by"):
            cols = [self.expect_ident()]
            while self.accept_op(","):
                cols.append(self.expect_ident())
            group_by = tuple(cols)
        return N.PivotStatement(table, on_sql, in_values, using_sql,
                                group_by)

    def parse_unpivot(self):
        self.expect_kw("unpivot")
        table = self.expect_ident()
        self.expect_kw("on")
        cols = [self.expect_ident()]
        while self.accept_op(","):
            cols.append(self.expect_ident())
        name_col, value_col = "name", "value"
        if self.accept_kw("into"):
            self.expect_kw("name")
            name_col = self.expect_ident()
            self.expect_kw("value")
            value_col = self.expect_ident()
        return N.UnpivotStatement(table, tuple(cols), name_col, value_col)

    def parse_table_constraint(self):
        if self.accept_kw("constraint"):
            self.expect_ident()  # constraint name (unused)
        if self.accept_kw("primary", "key"):
            return [("primary_key", self._parse_ident_list())]
        if self.accept_kw("unique"):
            return [("unique", self._parse_ident_list())]
        if self.accept_kw("check"):
            return [("check", self._parse_check_text())]
        if self.accept_kw("foreign", "key"):
            cols = self._parse_ident_list()
            self.expect_kw("references")
            ref_table = self.parse_qualified_ident()
            ref_cols = []
            if self.accept_op("("):
                ref_cols.append(self.expect_ident())
                while self.accept_op(","):
                    ref_cols.append(self.expect_ident())
                self.expect_op(")")
            return [("foreign_key", cols, ref_table, ref_cols)]
        raise ParserError(f"unsupported constraint near {self.peek().value!r}")

    def _parse_ident_list(self):
        self.expect_op("(")
        cols = [self.expect_ident()]
        while self.accept_op(","):
            cols.append(self.expect_ident())
        self.expect_op(")")
        return cols

    def _parse_check_text(self) -> str:
        """CHECK ( expr ) — returns the original SQL text of expr, so the
        catalog can persist and re-bind it at enforcement time."""
        self.expect_op("(")
        p0 = self.peek().pos
        # parse to validate, but keep the raw source slice
        self.parse_expr()
        p1 = self.peek().pos
        self.expect_op(")")
        return self.sql[p0:p1].strip()

    def parse_create_macro(self, or_replace: bool):
        """CREATE [OR REPLACE] MACRO name(p1, p2 := default, ...) AS
        expr | TABLE select (reference: CREATE MACRO,
        src/parser/parsed_data/create_macro_info.hpp)."""
        if_not_exists = bool(self.accept_kw("if", "not", "exists"))
        name = self.parse_qualified_ident()
        self.expect_op("(")
        params, defaults = [], {}
        if self.peek().value != ")":
            while True:
                pname = self.expect_ident().lower()
                if self.peek().value == ":=":
                    self.next()
                    defaults[pname] = self.parse_expr()
                elif (self.peek().value == ":"
                        and self.peek(1).value == "="):
                    self.next()
                    self.next()
                    defaults[pname] = self.parse_expr()
                params.append(pname)
                if not self.accept_op(","):
                    break
        self.expect_op(")")
        self.expect_kw("as")
        if self.accept_kw("table"):
            return N.CreateMacro(name, tuple(params), defaults,
                                 self.parse_select_statement(), is_table=True,
                                 or_replace=or_replace,
                                 if_not_exists=if_not_exists)
        return N.CreateMacro(name, tuple(params), defaults, self.parse_expr(),
                             is_table=False, or_replace=or_replace,
                             if_not_exists=if_not_exists)

    def parse_alter(self):
        self.expect_kw("alter")
        self.expect_kw("table")
        if_exists = bool(self.accept_kw("if", "exists"))
        table = self.parse_qualified_ident()
        if self.accept_kw("add"):
            self.accept_kw("column")
            col_if = bool(self.accept_kw("if", "not", "exists"))
            name = self.expect_ident()
            tname, mods = self.parse_type_name()
            default = None
            default_text = None
            while True:
                if self.accept_kw("default"):
                    _d0 = self.peek().pos
                    default = self.parse_expr()
                    default_text = self.sql[_d0:self.peek().pos].strip()
                elif self.accept_kw("not", "null") or self.accept_kw("null"):
                    pass  # accepted; NOT NULL on a new column of an empty
                    # default is only meaningful with DEFAULT (checked on
                    # later appends)
                else:
                    break
            return N.AlterStatement(table, "add_column", name=name,
                                    col_type=tname, col_mods=mods,
                                    if_exists=if_exists, default=default,
                                    default_text=default_text, col_if=col_if)
        if self.accept_kw("drop"):
            self.accept_kw("column")
            col_if = bool(self.accept_kw("if", "exists"))
            name = self.expect_ident()
            return N.AlterStatement(table, "drop_column", name=name,
                                    if_exists=if_exists, col_if=col_if)
        if self.accept_kw("rename"):
            if self.accept_kw("to"):
                return N.AlterStatement(table, "rename_table",
                                        new_name=self.expect_ident(),
                                        if_exists=if_exists)
            self.accept_kw("column")
            name = self.expect_ident()
            self.expect_kw("to")
            return N.AlterStatement(table, "rename_column", name=name,
                                    new_name=self.expect_ident(),
                                    if_exists=if_exists)
        if self.accept_kw("alter"):
            # ALTER [COLUMN] name {SET DATA TYPE t | TYPE t} [USING expr]
            #   | SET DEFAULT expr | DROP DEFAULT
            #   | SET NOT NULL | DROP NOT NULL
            # (reference: src/parser/statement/alter_statement.cpp)
            self.accept_kw("column")
            name = self.expect_ident()
            if self.accept_kw("set", "data", "type") \
                    or self.accept_kw("type"):
                tname, mods = self.parse_type_name()
                using = None
                if self.accept_kw("using"):
                    _u0 = self.peek().pos
                    using = self.parse_expr()
                    using._sql_text = self.sql[_u0:self.peek().pos].strip()
                return N.AlterStatement(table, "alter_type", name=name,
                                        col_type=tname, col_mods=mods,
                                        if_exists=if_exists, using=using)
            if self.accept_kw("set", "default"):
                _d0 = self.peek().pos
                de = self.parse_expr()
                return N.AlterStatement(
                    table, "set_default", name=name, if_exists=if_exists,
                    default=de,
                    default_text=self.sql[_d0:self.peek().pos].strip())
            if self.accept_kw("drop", "default"):
                return N.AlterStatement(table, "drop_default", name=name,
                                        if_exists=if_exists)
            if self.accept_kw("set", "not", "null"):
                return N.AlterStatement(table, "set_not_null", name=name,
                                        if_exists=if_exists)
            if self.accept_kw("drop", "not", "null"):
                return N.AlterStatement(table, "drop_not_null", name=name,
                                        if_exists=if_exists)
        raise ParserError("unsupported ALTER TABLE action")

    def parse_drop(self):
        self.expect_kw("drop")
        kind = self.expect_ident().lower()
        if kind in ("macro", "function") and self.accept_kw("table"):
            kind = "macro table"  # table macros live in their own registry
        elif kind == "function":
            kind = "macro"
        if_exists = bool(self.accept_kw("if", "exists"))
        name = self.parse_qualified_ident()
        cascade = bool(self.accept_kw("cascade"))
        self.accept_kw("restrict")
        return N.DropStatement(kind, name, if_exists=if_exists,
                               cascade=cascade)

    def parse_insert(self):
        self.expect_kw("insert")
        conflict_short = None
        if self.accept_kw("or", "replace"):
            conflict_short = ("replace", ())
        elif self.accept_kw("or", "ignore"):
            conflict_short = ("nothing", ())
        self.expect_kw("into")
        table = self.parse_qualified_ident()
        cols: Tuple[str, ...] = ()
        if self.peek().value == "(" and self._looks_like_col_alias_list():
            self.next()
            names = [self.expect_ident()]
            while self.accept_op(","):
                names.append(self.expect_ident())
            self.expect_op(")")
            cols = tuple(names)
        by_name = False
        if self.accept_kw("by", "name"):
            by_name = True
        elif self.accept_kw("by", "position"):
            pass  # the default
        if self.accept_kw("default", "values"):
            # INSERT INTO t DEFAULT VALUES — one all-defaults row
            # (source=None; the insert handler default-fills every column)
            source = None
        elif self.kw() == "from":
            source = self.parse_from_first()
        else:
            source = self.parse_select_statement()
        on_conflict = conflict_short
        if self.accept_kw("on", "conflict"):
            tcols = ()
            if self.peek().value == "(":
                tcols = tuple(self._parse_ident_list())
            self.expect_kw("do")
            if self.accept_kw("nothing"):
                on_conflict = ("nothing", tcols)
            else:
                self.expect_kw("update")
                self.expect_kw("set")
                assigns = [(self.expect_ident(), None)]
                self.expect_op("=")
                assigns[0] = (assigns[0][0], self.parse_expr())
                while self.accept_op(","):
                    nm = self.expect_ident()
                    self.expect_op("=")
                    assigns.append((nm, self.parse_expr()))
                on_conflict = ("update", tcols, assigns)
        returning = self._parse_returning()
        return N.InsertStatement(table, cols, source,
                                 on_conflict=on_conflict, by_name=by_name,
                                 returning=returning)

    def _parse_returning(self):
        if not self.accept_kw("returning"):
            return None
        items = []
        while True:
            if self.peek().value == "*":
                self.next()
                items.append(("*", None))
            else:
                start = self.peek().pos
                e = self.parse_expr()
                # stash the raw text: RETURNING re-plans through an
                # ordinary SELECT over the affected rows
                e._sql_text = self.sql[start:self.peek().pos].strip()
                alias = None
                if self.accept_kw("as"):
                    alias = self.expect_ident()
                items.append((e, alias))
            if not self.accept_op(","):
                break
        return items

    def parse_delete(self):
        self.expect_kw("delete")
        self.expect_kw("from")
        table = self.parse_qualified_ident()
        alias = None
        if self.accept_kw("as"):
            alias = self.expect_ident()
        elif (self.peek().type == TokType.IDENT
              and self.kw() not in ("where", "using", "returning")):
            alias = self.next().value
        using = None
        if self.accept_kw("using"):
            # DELETE FROM t USING <table refs>: rows of t with a match in
            # the joined USING set under WHERE are deleted (reference:
            # src/parser/statement/delete_statement.cpp)
            using = [self.parse_join_operand()]
            while self.accept_op(","):
                using.append(self.parse_join_operand())
        where = None
        if self.accept_kw("where"):
            where = self.parse_expr()
        returning = self._parse_returning()
        return N.DeleteStatement(table, alias, where, using=using,
                                 returning=returning)

    def parse_update(self):
        self.expect_kw("update")
        table = self.parse_qualified_ident()
        alias = None
        if self.kw() != "set" and self.peek().type == TokType.IDENT:
            alias = self.next().value
        self.expect_kw("set")
        assigns = []
        while True:
            col = self.expect_ident()
            self.expect_op("=")
            assigns.append((col, self.parse_expr()))
            if not self.accept_op(","):
                break
        from_refs = None
        if self.accept_kw("from"):
            # UPDATE t SET … FROM <table refs>: a row of t takes its new
            # values from a match in the joined refs under WHERE
            from_refs = [self.parse_join_operand()]
            while self.accept_op(","):
                from_refs.append(self.parse_join_operand())
        where = None
        if self.accept_kw("where"):
            where = self.parse_expr()
        returning = self._parse_returning()
        return N.UpdateStatement(table, alias, assigns, where,
                                 returning=returning, from_refs=from_refs)

    def parse_merge(self):
        self.expect_kw("merge")
        self.expect_kw("into")
        target = self.expect_ident()
        t_alias, _ = self.parse_alias()
        self.expect_kw("using")
        source = self.parse_join_operand()
        self.expect_kw("on")
        cond = self.parse_expr()
        matched, not_matched = [], []
        while self.kw() == "when":
            self.next()
            is_matched = not self.accept_kw("not")
            self.expect_kw("matched")
            act_cond = None
            if self.accept_kw("and"):
                act_cond = self.parse_expr()
            self.expect_kw("then")
            if self.accept_kw("update"):
                self.expect_kw("set")
                assigns = []
                while True:
                    cname = self.expect_ident()
                    self.expect_op("=")
                    assigns.append((cname, self.parse_expr()))
                    if not self.accept_op(","):
                        break
                act = N.MergeAction("update", act_cond, assignments=assigns)
            elif self.accept_kw("delete"):
                act = N.MergeAction("delete", act_cond)
            elif self.accept_kw("insert"):
                cols: Tuple[str, ...] = ()
                star = False
                vals = []
                if self.accept_op("*") or (self.peek().value == "*"):
                    self.accept_op("*")
                    star = True
                else:
                    if self.peek().value == "(":
                        self.next()
                        cl = [self.expect_ident()]
                        while self.accept_op(","):
                            cl.append(self.expect_ident())
                        self.expect_op(")")
                        cols = tuple(cl)
                    if self.accept_kw("values"):
                        self.expect_op("(")
                        vals = [self.parse_expr()]
                        while self.accept_op(","):
                            vals.append(self.parse_expr())
                        self.expect_op(")")
                    else:
                        star = True
                act = N.MergeAction("insert", act_cond, insert_columns=cols,
                                    insert_values=vals, insert_star=star)
            else:
                self.expect_kw("do")
                self.expect_kw("nothing")
                act = N.MergeAction("do_nothing", act_cond)
            (matched if is_matched else not_matched).append(act)
        return N.MergeStatement(target, t_alias, source, cond, matched,
                                not_matched)

    def parse_copy(self):
        self.expect_kw("copy")
        table = None
        select = None
        if self.peek().value == "(":
            self.next()
            select = self.parse_select_statement()
            self.expect_op(")")
        else:
            table = self.expect_ident()
        if self.accept_kw("to"):
            direction = "to"
        else:
            self.expect_kw("from")
            direction = "from"
        target = self.next().value
        options = {}
        if self.peek().value == "(":
            self.next()
            while self.peek().value != ")":
                key = self.expect_ident().lower()
                if self.peek().value not in (",", ")"):
                    options[key] = self.next().value
                else:
                    options[key] = True
                self.accept_op(",")
            self.expect_op(")")
        return N.CopyStatement(table, select, direction, target, options)

    def parse_set(self, kind: str):
        self.next()
        if kind == "reset":
            name = self.expect_ident()
            return N.SetStatement(name, None, is_reset=True)
        self.accept_kw("session") or self.accept_kw("global") or self.accept_kw("local")
        name = self.expect_ident()
        if not self.accept_op("="):
            self.expect_kw("to")
        t = self.next()
        val: object = t.value
        if t.type == TokType.NUMBER:
            val = float(t.value) if "." in t.value else int(t.value)
        elif t.type == TokType.IDENT and t.value.lower() in ("true", "false"):
            val = t.value.lower() == "true"
        return N.SetStatement(name, val)

    def parse_pragma(self):
        self.expect_kw("pragma")
        name = self.expect_ident().lower()
        args: List[N.Expr] = []
        if self.accept_op("("):
            if self.peek().value != ")":
                args.append(self.parse_expr())
                while self.accept_op(","):
                    args.append(self.parse_expr())
            self.expect_op(")")
        elif self.accept_op("="):
            args.append(self.parse_expr())
        return N.PragmaStatement(name, args)

    def parse_call(self):
        self.expect_kw("call")
        name = self.expect_ident().lower()
        args: List[N.Expr] = []
        self.expect_op("(")
        if self.peek().value != ")":
            args.append(self.parse_tf_arg())
            while self.accept_op(","):
                args.append(self.parse_tf_arg())
        self.expect_op(")")
        return N.CallStatement(name, args)


_INTERVAL_UNITS = {
    "year", "years", "month", "months", "day", "days", "hour", "hours",
    "minute", "minutes", "second", "seconds", "millisecond", "milliseconds",
    "microsecond", "microseconds", "week", "weeks", "quarter", "quarters",
    "decade", "decades", "century", "centuries",
}


def parse_sql(sql: str) -> List[object]:
    return Parser(sql).parse_statements()
