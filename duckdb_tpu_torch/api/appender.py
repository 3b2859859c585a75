"""Appender: rows from Python, buffered and appended in bulk.

The JAX package's Appender (duckdb_tpu/api/appender.py; DuckDB's
appender.cpp): `append_row(*values)` and `append_rows(rows)` buffer rows,
and every 262,144 rows, `flush()`, `close()` and the end of a `with`
block convert the buffer to one host column per table column and append
them through `Connection._appender_flush`. That runs the flush as a
statement of its own: it checks the table's constraints like an INSERT
(`_append_rows`; the JAX package checks none, ROADMAP N1), commits on
its own outside BEGIN and joins the transaction inside one, and in a file
database makes the rows durable by a checkpoint at that commit (the WAL
logs statement texts, and a flush has none: N2).
"""

from __future__ import annotations

import decimal

from duckdb_tpu_torch.blocks.nested import UNSORTED_DICT_IDS, physical_column
from duckdb_tpu_torch.errors import ConversionException, InvalidInputException
from duckdb_tpu_torch.planner.bound import not_ported
from duckdb_tpu_torch.types import TypeId


def to_columns(entry, rows) -> dict:
    """Buffered rows → {column: (values, validity|None, dictionary|None)}
    in the columns' physical types (blocks/nested.physical_column)."""
    out = {}
    for j, cd in enumerate(entry.columns):
        if cd.ltype.id in UNSORTED_DICT_IDS or cd.ltype.id is TypeId.BLOB:
            raise not_ported(f"appending {cd.ltype!r} values")
        try:
            vals, valid, dvals = physical_column([r[j] for r in rows], cd.ltype)
        except (OverflowError, TypeError, ValueError, AttributeError,
                decimal.InvalidOperation) as err:
            raise ConversionException(f"Could not convert an appended value to {cd.ltype!r} "
                                      f"for column {cd.name}: {err}") from None
        out[cd.name] = (vals, None if valid.all() else valid, dvals)
    return out


class Appender:
    """Buffered appends into one table of a connection."""

    FLUSH_EVERY = 1 << 18  # rows buffered before a flush, as the JAX package's

    def __init__(self, con, table: str):
        self._con = con
        self._table = table
        self._ncols = len(con.catalog.get_table(table).columns)
        self._rows = []

    def append_row(self, *values):
        if len(values) != self._ncols:
            raise InvalidInputException(f"the appender of {self._table} takes {self._ncols} "
                                        f"values a row, not {len(values)}")
        self._rows.append(values)
        if len(self._rows) >= self.FLUSH_EVERY:
            self.flush()

    def append_rows(self, rows):
        for r in rows:
            self.append_row(*r)

    def flush(self):
        """Append the buffered rows (all or none: a violation keeps none)."""
        if not self._rows:
            return
        rows, self._rows = self._rows, []
        self._con._appender_flush(self._table, rows)

    def close(self):
        self.flush()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.flush()
        return False
