"""The appender of duckdb_tpu_torch (device="cpu") against the JAX package.

The cases of tests/test_appender.py run through both packages and their
tables must hold the same rows. Where the JAX package is wrong the port is
held to DuckDB: N1, a flush checks the table's constraints (the JAX
package appends a duplicate key and a NULL under NOT NULL); N2, rows
flushed in a file database survive a crash (the JAX package's flush never
reaches the WAL). Then the flush's transaction: a flush every 262,144
rows, a flush inside BEGIN that rolls back, and the conversion of each
type.
"""

import datetime
import decimal
import os
import sys

import pytest
import torch

import duckdb_tpu
import duckdb_tpu_torch
from duckdb_tpu_torch.errors import (ConstraintException, ConversionException,
                                     InvalidInputException)

sys.path.insert(0, os.path.dirname(__file__))
from _torch_parity import FilePackage, connect_both, outcome, same  # noqa: E402

torch.set_num_threads(1)


def _both(fn, checks):
    """fn(con) on each package, then each check query compared."""
    jcon, tcon = connect_both()
    fn(jcon)
    fn(tcon)
    for sql in checks:
        same(sql, outcome(jcon, sql), outcome(tcon, sql))
    return jcon, tcon


def _bulk(con):
    con.sql("CREATE TABLE t (a INT, b VARCHAR, c DECIMAL(10,2))")
    with con.appender("t") as app:
        for i in range(5000):
            app.append_row(i, f"s{i % 100}", i * 0.25)


def _incremental(con):
    con.sql("CREATE TABLE t (a INT, b VARCHAR)")
    app = con.appender("t")
    app.append_row(1, "x")
    app.append_row(None, None)
    app.flush()
    app.append_row(3, "y")
    app.close()


CASES = {
    # tests/test_appender.py
    "bulk": (_bulk, ["SELECT count(*), sum(a), count(DISTINCT b) FROM t",
                     "SELECT c FROM t WHERE a = 7", "SELECT sum(c), min(b), max(b) FROM t"]),
    "nulls_and_incremental": (_incremental, ["SELECT * FROM t ORDER BY a NULLS LAST"]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_appender_matches_jax(name):
    _both(*CASES[name])


def test_n1_flush_checks_constraints():
    """On k(id PRIMARY KEY, v NOT NULL) holding (1, 'a'), appending (1, None)
    and (2, 'b'): DuckDB's appender raises a ConstraintException; the JAX
    package keeps both rows."""
    def fill(con):
        con.sql("CREATE TABLE k (id INTEGER PRIMARY KEY, v VARCHAR NOT NULL)")
        con.sql("INSERT INTO k VALUES (1, 'a')")
        app = con.appender("k")
        app.append_row(1, None)
        app.append_row(2, "b")
        try:
            app.close()
        except ConstraintException:
            return "raised"
        return "kept"

    jcon, tcon = connect_both()
    assert fill(jcon) == "kept" and jcon.sql("SELECT count(*) FROM k").rows() == [(3,)]
    assert fill(tcon) == "raised"
    assert tcon.sql("SELECT * FROM k").rows() == [(1, "a")]
    app = tcon.appender("k")
    app.append_row(1, "dup")
    with pytest.raises(ConstraintException):
        app.flush()
    app.append_row(2, "b")
    app.close()
    assert tcon.sql("SELECT * FROM k ORDER BY id").rows() == [(1, "a"), (2, "b")]


def _n2(side: FilePackage):
    con = side.connect("db")
    con.sql("CREATE TABLE f (a INT)")
    con.sql("CHECKPOINT")
    app = con.appender("f")
    app.append_row(1)
    app.append_row(2)
    app.close()
    con.sql("INSERT INTO f VALUES (3)")
    before = con.sql("SELECT count(*) FROM f").rows()
    side.crash()
    return before, side.connect("db").sql("SELECT a FROM f ORDER BY a").rows()


def test_n2_flushed_rows_survive_a_crash(tmp_path):
    """The flush commits with a checkpoint (it has no text for the WAL):
    after a crash the reopened database holds rows 1, 2 and 3; the JAX
    package's holds only 3."""
    assert _n2(FilePackage("jax", tmp_path)) == ([(3,)], [(3,)])
    assert _n2(FilePackage("torch", tmp_path)) == ([(3,)], [(1,), (2,), (3,)])


def test_flush_every_262144_rows_and_transactions():
    con = duckdb_tpu_torch.connect(device="cpu")
    con.sql("CREATE TABLE t (a BIGINT)")
    other = con.cursor()
    app = con.appender("t")
    app.append_rows((i,) for i in range(262_145))
    # the first 262,144 rows flushed and committed on their own
    assert other.sql("SELECT count(*), max(a) FROM t").rows() == [(262_144, 262_143)]
    app.close()
    assert other.sql("SELECT count(*) FROM t").rows() == [(262_145,)]
    con.sql("BEGIN")
    with con.appender("t") as app:
        app.append_row(-1)
    assert con.sql("SELECT count(*) FROM t").rows() == [(262_146,)]
    assert other.sql("SELECT count(*) FROM t").rows() == [(262_145,)]
    con.sql("ROLLBACK")
    assert con.sql("SELECT min(a) FROM t").rows() == [(0,)]


def test_types_and_bad_rows():
    con = duckdb_tpu_torch.connect(device="cpu")
    con.sql("CREATE TABLE ty (b BOOLEAN, i TINYINT, d DATE, ts TIMESTAMP, x DOUBLE, "
            "m DECIMAL(18,3), s VARCHAR)")
    row = (True, -5, datetime.date(2024, 2, 29), datetime.datetime(2024, 1, 2, 3, 4, 5, 6),
           1.5, decimal.Decimal("12.345"), "é")
    with con.appender("ty") as app:
        app.append_row(*row)
        app.append_row(*[None] * 7)
    assert con.sql("SELECT * FROM ty ORDER BY b NULLS LAST").rows() == [row, (None,) * 7]
    app = con.appender("ty")
    with pytest.raises(InvalidInputException):
        app.append_row(1, 2)
    app.append_row(None, 300, None, None, None, None, None)
    with pytest.raises(ConversionException):
        app.flush()
    assert con.sql("SELECT count(*) FROM ty").rows() == [(2,)]
    with pytest.raises(ValueError):
        con.appender("nope")


def test_jax_package_still_has_no_constraint_check():
    """The reference the port differs from (N1), checked on its own."""
    con = duckdb_tpu.connect()
    con.sql("CREATE TABLE k (id INTEGER PRIMARY KEY)")
    with con.appender("k") as app:
        app.append_row(1)
        app.append_row(1)
    assert con.sql("SELECT count(*) FROM k").rows() == [(2,)]
