"""The relation API and prepared statements.

The JAX package's (duckdb_tpu/api/relation.py; DuckDB's relation.hpp and
prepared_statement.cpp): a Relation is SQL text that each method wraps in
one more query, planned and run only when it is materialized
(`execute`, `fetchall`, `fetchone`, `count`, `columns`, `create`, …).
A PreparedStatement substitutes its parameters (`?` in order, or `$n`)
as SQL literals, found by the lexer, so a `?` inside a string stays.
`Relation.df` needs pandas and waits for ROADMAP item 35b.
"""

from __future__ import annotations

import datetime
from typing import List

from duckdb_tpu_torch.planner.bound import not_ported
from duckdb_tpu_torch.sql.lexer import tokenize


class RawSQL:
    """A parameter whose text is substituted as it is (an INTERVAL literal,
    say)."""

    def __init__(self, sql: str):
        self.sql = sql


def render_box(names: List[str], rows: List[tuple], max_rows: int = 40) -> str:
    """Rows as a box of text, the way DuckDB's shell prints a result."""
    cells = [[("NULL" if v is None else str(v)) for v in r] for r in rows[:max_rows]]
    widths = [max([len(n)] + [len(r[i]) for r in cells]) for i, n in enumerate(names)]

    def line(vals):
        return "│ " + " │ ".join(v.ljust(w) for v, w in zip(vals, widths)) + " │"

    rule = "─┼─".join("─" * w for w in widths)
    out = ["┌─" + "─┬─".join("─" * w for w in widths) + "─┐", line(names),
           "├─" + rule + "─┤"] + [line(r) for r in cells]
    if len(rows) > max_rows:
        out.append(f"│ … {len(rows) - max_rows} more rows")
    out.append("└─" + "─┴─".join("─" * w for w in widths) + "─┘")
    return "\n".join(out)


class Relation:
    def __init__(self, con, sql: str, alias: str = "rel"):
        self._con = con
        self._sql = sql
        self.alias = alias

    # -- composition ------------------------------------------------------------
    def _wrap(self, select="*", where=None, group=None, order=None, limit=None):
        q = f"SELECT {select} FROM ({self._sql}) AS {self.alias}"
        if where:
            q += f" WHERE {where}"
        if group:
            q += f" GROUP BY {group}"
        if order:
            q += f" ORDER BY {order}"
        if limit is not None:
            q += f" LIMIT {limit}"
        return Relation(self._con, q, self.alias)

    def filter(self, condition: str) -> "Relation":
        return self._wrap(where=condition)

    def project(self, *exprs: str) -> "Relation":
        return self._wrap(select=", ".join(exprs))

    select = project

    def aggregate(self, aggr: str, group_expr: str = "") -> "Relation":
        if group_expr:
            return self._wrap(select=f"{group_expr}, {aggr}", group=group_expr)
        return self._wrap(select=aggr)

    def order(self, order_expr: str) -> "Relation":
        return self._wrap(order=order_expr)

    sort = order

    def limit(self, n: int, offset: int = 0) -> "Relation":
        return self._wrap(limit=f"{int(n)}" + (f" OFFSET {int(offset)}" if offset else ""))

    def join(self, other: "Relation", condition: str, how: str = "inner") -> "Relation":
        jt = {"inner": "JOIN", "left": "LEFT JOIN", "right": "RIGHT JOIN",
              "semi": "SEMI JOIN", "anti": "ANTI JOIN"}[how]
        return Relation(self._con, f"SELECT * FROM ({self._sql}) AS {self.alias} {jt} "
                                   f"({other._sql}) AS {other.alias} ON {condition}", self.alias)

    def _setop(self, op: str, other: "Relation") -> "Relation":
        return Relation(self._con, f"({self._sql}) {op} ({other._sql})", self.alias)

    def union(self, other: "Relation") -> "Relation":
        return self._setop("UNION ALL", other)

    def except_(self, other: "Relation") -> "Relation":
        return self._setop("EXCEPT", other)

    def intersect(self, other: "Relation") -> "Relation":
        return self._setop("INTERSECT", other)

    def distinct(self) -> "Relation":
        return self._wrap(select="DISTINCT *")

    def set_alias(self, alias: str) -> "Relation":
        return Relation(self._con, self._sql, alias)

    # -- materialization --------------------------------------------------------
    def execute(self):
        return self._con.sql(self._sql)

    def fetchall(self):
        return self.execute().rows()

    def fetchone(self):
        rows = self.execute().rows()
        return rows[0] if rows else None

    def df(self):
        """The rows as a pandas DataFrame (pandas imported here)."""
        from duckdb_tpu_torch.api.arrow_interop import result_df

        return result_df(self.execute(), "Relation.df()")

    def count(self) -> int:
        return self.aggregate("count(*) AS cnt").fetchone()[0]

    def create(self, table_name: str):
        self._con.sql(f"CREATE TABLE {table_name} AS {self._sql}")

    def create_view(self, view_name: str):
        self._con.sql(f"CREATE VIEW {view_name} AS {self._sql}")

    def to_csv(self, path: str):
        self._con.sql(f"COPY ({self._sql}) TO {_quote(path)}")

    def to_parquet(self, path: str):
        self._con.sql(f"COPY ({self._sql}) TO {_quote(path)} (FORMAT PARQUET)")

    @property
    def columns(self) -> List[str]:
        return self.execute().names

    def explain(self) -> str:
        return self._con.sql(f"EXPLAIN {self._sql}").rows()[0][0]

    def __repr__(self):
        res = self._con.sql(f"SELECT * FROM ({self._sql}) AS r LIMIT 5")
        return render_box(res.names, res.rows())


def _quote(s: str) -> str:
    return "'" + s.replace("'", "''") + "'"


def literal(p) -> str:
    """A Python value as a SQL literal."""
    if p is None:
        return "NULL"
    if isinstance(p, bool):
        return "true" if p else "false"
    if isinstance(p, str):
        return _quote(p)
    if isinstance(p, datetime.datetime):
        return f"TIMESTAMP '{p}'"
    if isinstance(p, datetime.date):
        return f"DATE '{p}'"
    if isinstance(p, datetime.time):
        return f"TIME '{p}'"
    if isinstance(p, (bytes, bytearray)):
        return "'" + "".join(f"\\x{b:02X}" for b in p) + "'::BLOB"
    if isinstance(p, RawSQL):
        return p.sql
    return str(p)


def _param_tokens(sql: str):
    """The placeholder tokens of a text (the lexer skips string literals
    and comments, so a `?` there stays data)."""
    return [t for t in tokenize(sql) if t.type == "OP" and (
        t.value == "?" or (t.value.startswith("$") and t.value[1:].isdigit()))]


def param_count(sql: str) -> int:
    """How many values a text's placeholders take: its `?`s, or its
    highest `$n`."""
    toks = _param_tokens(sql)
    return (sum(1 for t in toks if t.value == "?")
            or max((int(t.value[1:]) for t in toks if t.value != "?"), default=0))


def bind_params(sql: str, params) -> str:
    """The text with each placeholder replaced by its value's literal (`?`
    in order, `$n` the n-th; NULL past the values given)."""
    pieces, last, i = [], 0, 0
    for t in _param_tokens(sql):
        if t.value == "?":
            n, i = i, i + 1
        else:
            n = int(t.value[1:]) - 1
        pieces.append(sql[last:t.pos])
        pieces.append(literal(params[n] if n < len(params) else None))
        last = t.pos + len(t.value)
    pieces.append(sql[last:])
    return "".join(pieces)


class PreparedStatement:
    """A statement with `?` or `$n` placeholders, bound at each execute."""

    def __init__(self, con, sql: str):
        self._con = con
        self._sql = sql

    @property
    def nparams(self) -> int:
        return param_count(self._sql)

    def execute(self, *params):
        return self._con.sql(bind_params(self._sql, params))
