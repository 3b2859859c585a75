"""COPY, EXPORT DATABASE and IMPORT DATABASE in duckdb_tpu_torch
(device="cpu"; api/files.py) against duckdb_tpu, and the reference faults
of this surface held to DuckDB: I5 (EXPORT loses constraints, defaults,
sequences and macros), I6 (a cached plan over a file outlives the file)
and F12 (recovery replays COPY FROM by reading the file again). Each
asserts that the JAX package still differs. COPY FROM goes through
INSERT's append path: constraints and transactions apply.
"""

import datetime
import decimal
import os
import subprocess
import sys

import pytest
import torch

import duckdb_tpu_torch
from duckdb_tpu_torch.api import connection as TC
from duckdb_tpu_torch.errors import ConstraintException

from _torch_parity import FilePackage, connect_both, run_both

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tcon():
    return duckdb_tpu_torch.connect(device="cpu")


def _touch_later(path, seconds=2):
    st = os.stat(path)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + seconds * 10**9))


@pytest.mark.parametrize("fmt", ["csv", "parquet"])
def test_export_import_database(tmp_path, fmt):
    """tests/test_io.py's case, in both formats: each package imports what
    it exported."""
    opts = " (FORMAT PARQUET)" if fmt == "parquet" else ""
    jcon, tcon = connect_both()
    script = ["CREATE TABLE t (a INT, b VARCHAR, d DECIMAL(6,2))",
              "INSERT INTO t VALUES (1,'x',1.25),(2,'y',3.50)",
              "CREATE TABLE u (k DATE)", "INSERT INTO u VALUES ('2024-01-05')"]
    run_both(script, cons=(jcon, tcon))
    for side, con in (("j", jcon), ("t", tcon)):
        con.sql(f"EXPORT DATABASE '{tmp_path}/{side}'{opts}")
    ext = "parquet" if fmt == "parquet" else "csv"
    assert sorted(os.listdir(tmp_path / "t")) == ["load.sql", "schema.sql", f"t.{ext}",
                                                  f"u.{ext}"]
    j2, t2 = connect_both()
    j2.sql(f"IMPORT DATABASE '{tmp_path}/j'")
    t2.sql(f"IMPORT DATABASE '{tmp_path}/t'")
    run_both(["SELECT * FROM t ORDER BY a", "SELECT * FROM u"], cons=(j2, t2))
    assert t2.sql("SELECT * FROM t ORDER BY a").rows() == [
        (1, "x", decimal.Decimal("1.25")), (2, "y", decimal.Decimal("3.50"))]
    assert t2.sql("SELECT * FROM u").rows() == [(datetime.date(2024, 1, 5),)]
    # the port imports the JAX package's export too
    t3 = _tcon()
    t3.sql(f"IMPORT DATABASE '{tmp_path}/j'")
    assert t3.sql("SELECT * FROM t ORDER BY a").rows() == t2.sql(
        "SELECT * FROM t ORDER BY a").rows()


I5_SETUP = ["CREATE TABLE k (id INTEGER PRIMARY KEY, v DECIMAL(15,2), s VARCHAR DEFAULT 'z')",
            "INSERT INTO k VALUES (1, 1.50, ''), (2, NULL, 'w')",
            "CREATE SEQUENCE sq", "SELECT nextval('sq')", "SELECT nextval('sq')",
            "CREATE MACRO m(x) AS x + 1", "CREATE VIEW kv AS SELECT id, s FROM k",
            "CREATE TABLE child (id INTEGER REFERENCES k(id), n INTEGER CHECK (n > 0))",
            "INSERT INTO child VALUES (1, 5)", "CREATE UNIQUE INDEX kv_idx ON child (n)"]


def test_i5_export_keeps_constraints_defaults_sequences_and_macros(tmp_path):
    """I5: schema.sql recreates the PRIMARY KEY, the DEFAULT, the sequence
    at its value, the macro, the view, the foreign key, the CHECK and the
    index; the empty string stays ''. The JAX package loses all but the
    view, and the '' too (through I2)."""
    jcon, tcon = connect_both()
    for con in (jcon, tcon):
        for sql in I5_SETUP:
            con.sql(sql)
    for side, con in (("j", jcon), ("t", tcon)):
        con.sql(f"EXPORT DATABASE '{tmp_path}/{side}'")
    schema = (tmp_path / "t" / "schema.sql").read_text()
    assert schema.index("CREATE SEQUENCE sq START WITH 3") < schema.index("CREATE TABLE k")
    assert schema.index("CREATE TABLE k") < schema.index("CREATE TABLE child")
    j2, t2 = connect_both()
    j2.sql(f"IMPORT DATABASE '{tmp_path}/j'")
    t2.sql(f"IMPORT DATABASE '{tmp_path}/t'")
    assert j2.sql("SELECT s FROM k WHERE id = 1").rows() == [(None,)]  # '' became NULL
    with pytest.raises(ConstraintException):
        t2.sql("INSERT INTO k VALUES (1, 2, 'dup')")
    assert j2.sql("INSERT INTO k VALUES (1, 2, 'dup')").rows() == [(1,)]  # still the fault
    assert t2.sql("SELECT nextval('sq')").rows() == [(3,)]
    with pytest.raises(Exception, match="sq"):
        j2.sql("SELECT nextval('sq')")
    assert t2.sql("SELECT m(1)").rows() == [(2,)]
    with pytest.raises(Exception):
        j2.sql("SELECT m(1)")
    t2.sql("INSERT INTO k (id) VALUES (3)")
    assert t2.sql("SELECT id, v, s FROM k ORDER BY id").rows() == [
        (1, decimal.Decimal("1.50"), ""), (2, None, "w"), (3, None, "z")]
    assert t2.sql("SELECT * FROM kv ORDER BY id").rows() == [(1, ""), (2, "w"), (3, "z")]
    with pytest.raises(ConstraintException):
        t2.sql("INSERT INTO child VALUES (9, 1)")  # the foreign key
    with pytest.raises(ConstraintException):
        t2.sql("INSERT INTO child VALUES (2, 0)")  # the CHECK
    with pytest.raises(ConstraintException):
        t2.sql("INSERT INTO child VALUES (2, 5)")  # the UNIQUE index
    assert "kv_idx" in [r[0] for r in t2.sql("SELECT index_name FROM duckdb_indexes()").rows()]


def test_i6_a_cached_plan_over_a_file_sees_the_new_file(tmp_path):
    """I6: the same SQL text after the file changed reads the new file
    (DuckDB reads files on every query); the JAX package's plan cache
    keeps the old rows."""
    p = tmp_path / "r.csv"
    p.write_text("a\n1\n2\n")
    jcon, tcon = connect_both()
    sql = f"SELECT count(*), sum(a) FROM '{p}'"
    run_both([sql], cons=(jcon, tcon))
    p.write_text("a\n1\n2\n3\n4\n")
    _touch_later(p)
    run_both([sql], cons=(jcon, tcon), duckdb={sql: [(4, 10)]})
    assert tcon.sql(sql).rows() == [(4, 10)]
    os.remove(p)
    with pytest.raises(ValueError, match="No files found"):
        tcon.sql(sql)


def test_copy_from_checks_keys_and_rolls_back(tmp_path):
    """COPY FROM appends through INSERT's path: a duplicate key raises
    ConstraintException and leaves the table as it was (the JAX package's
    _append_columns appends without checking); ROLLBACK undoes a COPY."""
    p = tmp_path / "dup.csv"
    p.write_text("id,s\n3,c\n1,again\n")
    ok = tmp_path / "ok.csv"
    ok.write_text("id,s\n7,g\n8,h\n")
    jcon, tcon = connect_both()
    for con in (jcon, tcon):
        con.sql("CREATE TABLE t (id INTEGER PRIMARY KEY, s VARCHAR)")
        con.sql("INSERT INTO t VALUES (1, 'a'), (2, 'b')")
    with pytest.raises(ConstraintException):
        tcon.sql(f"COPY t FROM '{p}' (HEADER)")
    assert tcon.sql("SELECT * FROM t ORDER BY id").rows() == [(1, "a"), (2, "b")]
    jcon.sql(f"COPY t FROM '{p}' (HEADER)")
    assert jcon.sql("SELECT count(*) FROM t").rows() == [(4,)]  # the duplicate went in
    tcon.sql("BEGIN")
    assert tcon.sql(f"COPY t FROM '{ok}' (HEADER)").rows() == [(2,)]
    assert tcon.sql("SELECT count(*) FROM t").rows() == [(4,)]
    tcon.sql("ROLLBACK")
    assert tcon.sql("SELECT count(*) FROM t").rows() == [(2,)]


def test_copy_from_parquet_casts_by_position(tmp_path):
    """A Parquet file's columns are taken by position, cast where their
    types differ from the table's."""
    con = _tcon()
    con.sql(f"COPY (SELECT range AS a, CAST(range AS DOUBLE) / 4 AS b, 'v' || range AS c "
            f"FROM range(5)) TO '{tmp_path}/src.parquet'")
    con.sql("CREATE TABLE t (x INTEGER, y DECIMAL(10,2), z VARCHAR)")
    assert con.sql(f"COPY t FROM '{tmp_path}/src.parquet'").rows() == [(5,)]
    assert con.sql("SELECT * FROM t ORDER BY x").rows()[1] == (1, decimal.Decimal("0.25"), "v1")


# -- F12: a committed COPY FROM survives the source file -------------------------------

F12_CHILD = """
import os, sys
sys.path.insert(0, {root!r})
import duckdb_tpu_torch
con = duckdb_tpu_torch.connect({db!r}, device="cpu")
con.sql("CREATE TABLE t (k INTEGER, s VARCHAR)")
con.sql("CHECKPOINT")
con.sql("COPY t FROM {src!r} (HEADER)")
print(con.sql("SELECT count(*) FROM t").rows()[0][0], flush=True)
os._exit(0)  # killed right after the commit: no close(), no checkpoint of its own
"""


def test_f12_a_killed_process_keeps_its_copy_from(tmp_path):
    """F12: a child commits COPY FROM in a file database and is killed; the
    file is then rewritten, then deleted; the committed rows are there
    after each reopen."""
    src = tmp_path / "in.csv"
    src.write_text("k,s\n1,x\n2,y\n")
    db = str(tmp_path / "db")
    out = subprocess.run([sys.executable, "-c", F12_CHILD.format(root=ROOT, db=db,
                                                                 src=str(src))],
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0 and out.stdout.strip() == "2", out.stderr[-2000:]
    src.write_text("k,s\n7,q\n")
    _touch_later(src)
    want = [(1, "x"), (2, "y")]
    con = duckdb_tpu_torch.connect(db, device="cpu")
    assert con.sql("SELECT * FROM t ORDER BY k").rows() == want
    del con
    TC._OPEN_DBS.clear()
    os.remove(src)
    con = duckdb_tpu_torch.connect(db, device="cpu")
    assert con.sql("SELECT * FROM t ORDER BY k").rows() == want
    con.close()


def test_f12_recovery_does_not_read_the_file_again(tmp_path):
    """The same crash in-process, through both packages: the JAX package
    replays COPY FROM from the WAL and reads the rewritten file."""
    src = tmp_path / "in.csv"

    def scenario(side):
        src.write_text("k,s\n1,x\n2,y\n")
        con = side.connect("db")
        out = [(q, side.sql(con, q)) for q in (
            "CREATE TABLE t (k INTEGER, s VARCHAR)", "CHECKPOINT",
            f"COPY t FROM '{src}' (HEADER)")]
        side.crash()
        src.write_text("k,s\n7,q\n")
        _touch_later(src)
        con = side.connect("db")
        got = side.sql(con, "SELECT * FROM t ORDER BY k")
        side.crash()
        return out + [("SELECT * FROM t ORDER BY k", got)]

    j = scenario(FilePackage("jax", tmp_path))
    t = scenario(FilePackage("torch", tmp_path))
    assert t[-1][1] == ("rows", [(1, "x"), (2, "y")])
    assert j[-1][1] == ("rows", [(7, "q")])  # still the fault


def test_f12_import_and_file_reads_checkpoint(tmp_path):
    """IMPORT DATABASE and an INSERT … SELECT over a file reader into a
    file database are made durable by a checkpoint: the WAL holds no
    statement that reads a file."""
    from duckdb_tpu_torch.storage import persist

    mem = _tcon()
    mem.sql("CREATE TABLE e (a INTEGER PRIMARY KEY); INSERT INTO e VALUES (1), (2)")
    mem.sql(f"EXPORT DATABASE '{tmp_path}/exp'")
    src = tmp_path / "more.csv"
    src.write_text("a\n5\n6\n")
    db = str(tmp_path / "db")
    con = duckdb_tpu_torch.connect(db, device="cpu")
    con.sql(f"IMPORT DATABASE '{tmp_path}/exp'")
    con.sql(f"INSERT INTO e SELECT a FROM read_csv('{src}')")
    con.sql("CREATE VIEW fv AS SELECT a FROM read_csv_auto('" + str(src) + "')")
    con.sql("INSERT INTO e SELECT a + 10 FROM fv")  # a file read through a view
    wal = os.path.join(db, persist.WAL_NAME)
    text = open(wal).read() if os.path.exists(wal) else ""
    assert "read_csv" not in text.replace("CREATE VIEW fv", "") and "IMPORT" not in text
    del con
    TC._OPEN_DBS.clear()
    import shutil

    shutil.rmtree(tmp_path / "exp")
    os.remove(src)
    con = duckdb_tpu_torch.connect(db, device="cpu")
    assert con.sql("SELECT a FROM e ORDER BY a").rows() == [(1,), (2,), (5,), (6,), (15,),
                                                            (16,)]
    with pytest.raises(ConstraintException):
        con.sql("INSERT INTO e VALUES (5)")
    con.close()


def test_copy_to_from_a_query_and_a_view(tmp_path):
    con = _tcon()
    con.sql("CREATE TABLE t (a INTEGER, s VARCHAR); INSERT INTO t VALUES (2, 'b'), (1, 'a')")
    con.sql("CREATE VIEW v AS SELECT a * 10 AS a10 FROM t")
    con.sql(f"COPY v TO '{tmp_path}/v.csv'")
    assert sorted((tmp_path / "v.csv").read_text().split()) == ["10", "20", "a10"]
    con.sql(f"COPY (SELECT s, a FROM t ORDER BY a) TO '{tmp_path}/q.parquet' "
            "(FORMAT PARQUET, COMPRESSION gzip)")
    assert con.sql(f"SELECT * FROM '{tmp_path}/q.parquet'").rows() == [("a", 1), ("b", 2)]


def test_a_file_read_inside_a_transaction_and_after_it(tmp_path):
    """A plan cached inside BEGIN reads a file table registered in the
    transaction's snapshot; after COMMIT the same text plans again against
    the published catalog."""
    p = tmp_path / "f.csv"
    p.write_text("a\n1\n2\n")
    con = _tcon()
    sql = f"SELECT sum(a) FROM '{p}'"
    con.sql("BEGIN")
    assert con.sql(sql).rows() == [(3,)]
    con.sql("COMMIT")
    assert con.sql(sql).rows() == [(3,)]
    con.sql("BEGIN")
    assert con.sql(sql).rows() == [(3,)]
    con.sql("ROLLBACK")
    assert con.sql(sql).rows() == [(3,)]
