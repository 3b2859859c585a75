"""Run SQL scripts through the JAX package and the port and compare what
each statement gives: rows (DECIMAL, integer, string, date and NULL
exactly, DOUBLE within 1e-9 relative; in order where ORDER BY fixes it),
DML Counts, and the class of an exception (the port's class of the same
name, or a subclass of it)."""

from __future__ import annotations

import math
import re

import duckdb_tpu
import duckdb_tpu_torch
from duckdb_tpu_torch import errors as T_ERRORS
from duckdb_tpu_torch.planner import binder as T_BINDER
from duckdb_tpu_torch.planner import bound as T_BOUND
from duckdb_tpu_torch.sql import parser as T_PARSER


def connect_both():
    return duckdb_tpu.connect(), duckdb_tpu_torch.connect(device="cpu")


def _port_class(cls):
    for mod in (T_ERRORS, T_BOUND, T_BINDER, T_PARSER):
        c = getattr(mod, cls.__name__, None)
        if isinstance(c, type):
            return c
    return cls  # a builtin (ValueError, KeyError, ...)


def outcome(con, sql):
    """→ ("rows", rows) / ("none", None) / ("error", exception)."""
    try:
        res = con.sql(sql)
    except Exception as err:  # noqa: BLE001 — the class is what is compared
        return "error", err
    if res is None or not res.names:  # a statement; SET gives no columns
        return "none", None
    return "rows", res.rows()


def _key(row):
    return tuple((v is None, repr(type(v)), v if v is not None else 0) for v in row)


def _close(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return a == b or abs(a - b) <= 1e-9 * max(abs(a), abs(b))
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    return a == b and type(a) is type(b) or (isinstance(a, (int, float)) and a == b
                                                 and not isinstance(a, bool))


def same(sql, j, t):
    """Assert the port's outcome `t` equals the JAX package's `j`."""
    assert j[0] == t[0] or (j[0] == "none" and t[0] == "none"), (sql, j, t)
    if j[0] == "error":
        want = _port_class(type(j[1]))
        assert isinstance(t[1], want), (sql, type(j[1]), type(t[1]), j[1], t[1])
        return
    if j[0] == "none":
        return
    jr, tr = j[1], t[1]
    if not re.search(r"\border\s+by\b", sql, re.IGNORECASE):
        jr, tr = sorted(jr, key=_key), sorted(tr, key=_key)
    assert len(jr) == len(tr), (sql, jr, tr)
    for a, b in zip(jr, tr):
        assert len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b)), (sql, a, b)


def run_both(script, cons=None, duckdb=None):
    """Run each statement of `script` (a list of SQL texts) on both
    packages, comparing as it goes → the two connections. `duckdb` maps a
    statement to the rows DuckDB gives where the JAX package's differ (a
    fault of ROADMAP Queue 3): the port is held to those."""
    jcon, tcon = cons or connect_both()
    for sql in script:
        j, t = outcome(jcon, sql), outcome(tcon, sql)
        if duckdb and sql in duckdb:
            assert j[0] == "rows" and j[1] != duckdb[sql], (sql, j)  # still the fault
            j = ("rows", duckdb[sql])
        same(sql, j, t)
    return jcon, tcon
