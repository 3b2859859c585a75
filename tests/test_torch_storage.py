"""File databases of the port (duckdb_tpu_torch.connect(path),
storage/persist.py) against the JAX package, and the durability faults
F7-F11 held to DuckDB.

- The cases of tests/test_persistence.py (but the two CSV cases, which
  wait for ROADMAP item 33b), and the cases of tests/test_mvcc.py,
  test_constraints.py, test_enum_uuid.py, test_foreign_keys.py,
  test_ddl_ext.py, test_macros.py and test_nested.py that reopen a
  database, each through both packages in folders of their own
  (tests/_torch_parity.run_both_files): the same outcome at every step.
- A directory written by either package opens in the other with equal
  rows, over every persisted type and object.
- F7 (a torn WAL tail replayed), F8 (an automatic checkpoint partway
  through a commit applies rows twice), F9 (a transaction's statements
  not one unit) and F11 (nothing fsynced): the port gives DuckDB's
  outcome and the JAX package still differs. F10 is in
  tests/test_torch_attach.py.
- A real crash: a child process killed by os._exit right after COMMIT.
- Entropy pinned per statement, sequences after recovery, the registry of
  open databases, the last close, and what close() leaves on the device.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import duckdb_tpu
import duckdb_tpu_torch
from duckdb_tpu_torch.api import connection as TC
from duckdb_tpu_torch.catalog import catalog as TCAT

sys.path.insert(0, os.path.dirname(__file__))
from _torch_parity import FilePackage, run_both_files, same  # noqa: E402

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _steps(side, steps, db="db"):
    """Run SQL steps on `db`; "@crash" forgets the open database (a dead
    process), "@close" closes the connection (which checkpoints); both
    then open the database again."""
    con, out = side.connect(db), []
    for st in steps:
        if st in ("@crash", "@close"):
            if st == "@close":
                con.close()
            side.crash()
            con = side.connect(db)
        else:
            out.append((st, side.sql(con, st)))
    return out


# the cases of tests/test_persistence.py and the reopen cases of the other
# files, as steps
SCENARIOS = {
    "wal_replay": [
        "CREATE TABLE t (a INT, b VARCHAR, c DECIMAL(10,2))",
        "INSERT INTO t VALUES (1,'x',1.50),(2,NULL,2.25),(3,'z',NULL)", "@crash",
        "SELECT * FROM t ORDER BY a"],
    "checkpoint_truncates_wal": [
        "CREATE TABLE t (a INT)", "INSERT INTO t VALUES (42)", "CHECKPOINT", "@crash",
        "SELECT a FROM t"],
    "checkpoint_plus_wal": [
        "CREATE TABLE t (a INT)", "INSERT INTO t VALUES (1)", "CHECKPOINT",
        "INSERT INTO t VALUES (2)", "@crash", "SELECT count(*) FROM t"],
    "views_persist": [
        "CREATE TABLE t (a INT)", "INSERT INTO t VALUES (5)",
        "CREATE VIEW v AS SELECT a*2 AS a2 FROM t", "CHECKPOINT", "@crash", "SELECT a2 FROM v",
        "CREATE VIEW w AS SELECT a + 1 AS b FROM t", "@crash", "SELECT b FROM w"],
    "wal_not_resurrected_after_rollback": [
        "CREATE TABLE t (a INT)", "INSERT INTO t VALUES (1)", "BEGIN",
        "INSERT INTO t VALUES (99)", "ROLLBACK", "@crash", "SELECT a FROM t ORDER BY a"],
    "wal_commit_flushes": [
        "CREATE TABLE t (a INT)", "BEGIN", "INSERT INTO t VALUES (7)", "COMMIT", "@crash",
        "SELECT a FROM t"],
    "sequences_persist": [
        "CREATE SEQUENCE seq START 10", "SELECT nextval('seq')", "SELECT nextval('seq')",
        "@close", "SELECT nextval('seq')"],
    "multi_statement_text": [
        "CREATE TABLE t (a INT); INSERT INTO t VALUES (1); INSERT INTO t VALUES (2)",
        "BEGIN; UPDATE t SET a = a * 10; COMMIT", "@crash", "SELECT a FROM t ORDER BY a"],
    "dml_between_checkpoints": [
        "CREATE TABLE t (i BIGINT, s VARCHAR)",
        "INSERT INTO t VALUES (1,'a'), (2,'b'), (3,'c'), (4,'d')", "CHECKPOINT",
        "DELETE FROM t WHERE i = 2", "UPDATE t SET s = 'q' WHERE i > 2",
        "INSERT INTO t SELECT i + 10, s FROM t", "@crash", "SELECT i, s FROM t ORDER BY i",
        "@close", "SELECT i, s FROM t ORDER BY i"],
    # tests/test_mvcc.py::test_same_file_connects_share is its own test below
    "constraints_survive_reopen": [
        "CREATE TABLE t (id INT PRIMARY KEY, v INT CHECK (v > 0))",
        "INSERT INTO t VALUES (1, 5)", "@close", "INSERT INTO t VALUES (1, 5)",
        "INSERT INTO t VALUES (2, -1)", "INSERT INTO t VALUES (2, 9)",
        "SELECT count(*) FROM t"],
    "enum_persistence": [
        "CREATE TYPE mood AS ENUM ('sad', 'ok')", "CREATE TABLE t (m mood)",
        "INSERT INTO t VALUES ('ok')", "@close", "SELECT enum_range(NULL::mood)",
        "SELECT * FROM t"],
    "fk_persists": [
        "CREATE TABLE p (id INT PRIMARY KEY)", "CREATE TABLE c (pid INT REFERENCES p (id))",
        "INSERT INTO p VALUES (1)", "@close", "INSERT INTO c VALUES (1)",
        "INSERT INTO c VALUES (7)", "SELECT * FROM c"],
    "schema_persistence": [
        "CREATE SCHEMA app", "CREATE TABLE app.users (id INT)",
        "INSERT INTO app.users VALUES (7)", "CHECKPOINT", "@crash",
        "SELECT id FROM app.users"],
    "macro_persistence": [
        "CREATE MACRO plus2(a) AS a + 2",
        "CREATE MACRO nums(n) AS TABLE SELECT * FROM range(n)", "CHECKPOINT", "@crash",
        "SELECT plus2(40)", "SELECT count(*) FROM nums(3)"],
    "ddl_list_columns": [
        "CREATE TABLE p (id INT, v INT[])", "INSERT INTO p VALUES (1, [1,2]), (2, [3])",
        "@close", "SELECT * FROM p ORDER BY id", "INSERT INTO p VALUES (3, [9])",
        "SELECT id, len(v) FROM p ORDER BY id"],
    "struct_ddl_columns": [
        "CREATE TABLE sp (s STRUCT(x INT, y DECIMAL(4,1)))",
        "INSERT INTO sp VALUES ({'x': 1, 'y': 2.5::DECIMAL(4,1)})", "@close",
        "SELECT s['y'] FROM sp"],
    "defaults_and_not_null": [
        "CREATE TABLE d (a INT NOT NULL, b VARCHAR DEFAULT 'dflt', c INT DEFAULT 7)",
        "INSERT INTO d (a) VALUES (1)", "@close", "INSERT INTO d (a) VALUES (2)",
        "INSERT INTO d (b) VALUES ('x')", "SELECT * FROM d ORDER BY a"],
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_file_database_matches_jax(tmp_path, name):
    run_both_files(tmp_path, lambda side: _steps(side, SCENARIOS[name]))


def test_checkpoint_removes_the_wal(tmp_path):
    db = str(tmp_path / "db")
    con = duckdb_tpu_torch.connect(db, device="cpu")
    con.sql("CREATE TABLE t (a INT)")
    assert os.path.exists(os.path.join(db, "wal.sql"))
    con.sql("CHECKPOINT")
    assert not os.path.exists(os.path.join(db, "wal.sql"))
    assert sorted(os.listdir(db)) == ["catalog.json", "data.g1"]
    con.close()


# -- in-memory cases of tests/test_persistence.py --------------------------------------

@pytest.mark.parametrize("script", [
    ["CREATE TABLE t (a INT)", "INSERT INTO t VALUES (1)", "BEGIN", "DROP TABLE t",
     "ROLLBACK", "SELECT count(*) FROM t"],
    ["COMMIT"],
    ["CREATE TABLE t (a INT, b VARCHAR)", "INSERT INTO t VALUES (1,'x'),(2,'y')", "BEGIN",
     "INSERT INTO t VALUES (3,'z')", "UPDATE t SET b = 'updated' WHERE a = 1",
     "DELETE FROM t WHERE a = 2", "SELECT count(*) FROM t", "ROLLBACK",
     "SELECT a, b FROM t ORDER BY a"],
    ["CREATE TABLE t (a INT)", "BEGIN", "INSERT INTO t VALUES (1),(2)", "COMMIT",
     "SELECT count(*) FROM t"],
    ["CREATE TABLE t1 (a INT, b VARCHAR)", "SELECT name FROM duckdb_tables()",
     "SELECT column_name, data_type FROM duckdb_columns() ORDER BY 1"],
], ids=["rollback", "commit_without_begin", "rollback_undoes_dml", "rollback_commit_dml",
        "system_functions"])
def test_in_memory_cases_match_jax(tmp_path, script):
    def scenario(side):
        con = side.connect()
        return [(q, side.sql(con, q)) for q in script]
    run_both_files(tmp_path, scenario)


def test_now_not_frozen_by_plan_cache():
    import time

    con = duckdb_tpu_torch.connect(device="cpu")
    a = con.sql("SELECT now()").rows()[0][0]
    time.sleep(0.01)
    assert con.sql("SELECT now()").rows()[0][0] > a


def test_alter_waits_for_item_34b(tmp_path):
    """ALTER came with item 34b (api/alter.py): in a file database it is
    logged, and the statements after it replay against the new schema once
    the process dies, and again after a CHECKPOINT."""
    db = str(tmp_path / "db")
    con = duckdb_tpu_torch.connect(db, device="cpu")
    con.sql("CREATE TABLE t (a INT)")
    con.sql("ALTER TABLE t ADD COLUMN b VARCHAR")
    con.sql("INSERT INTO t VALUES (1, 'one')")
    TC._OPEN_DBS.clear()
    con = duckdb_tpu_torch.connect(db, device="cpu")
    assert con.sql("SELECT * FROM t").rows() == [(1, "one")]
    con.sql("CHECKPOINT")
    TC._OPEN_DBS.clear()
    assert duckdb_tpu_torch.connect(db, device="cpu").sql("SELECT * FROM t").rows() == [
        (1, "one")]


@pytest.mark.parametrize("sql", ["COPY t TO 'x.csv'", "EXPORT DATABASE 'x'",
                                 "IMPORT DATABASE 'x'", "SELECT * FROM read_csv('x.csv')"])
def test_file_readers_wait_for_item_33b(sql, tmp_path, monkeypatch):
    """The file readers of item 33b are ported: each statement runs, or
    raises as the JAX package does where its file is not there."""
    monkeypatch.chdir(tmp_path)
    con = duckdb_tpu_torch.connect(device="cpu")
    con.sql("CREATE TABLE t (a INT)")
    if sql.startswith(("COPY", "EXPORT")):
        assert con.sql(sql) is None
        assert os.path.exists(tmp_path / "x.csv") or os.path.isdir(tmp_path / "x")
        return
    with pytest.raises(Exception, match="not found|No files found"):
        con.sql(sql)
    with pytest.raises(Exception, match="not found|No such file"):
        duckdb_tpu.connect().sql(sql).rows()


def test_use_and_temporary_views_on_replay(tmp_path):
    """A statement logged after USE replays in that schema; a TEMPORARY
    view is the connection's own and is not logged."""
    db = str(tmp_path / "db")
    con = duckdb_tpu_torch.connect(db, device="cpu")
    con.sql("CREATE SCHEMA app")
    con.sql("USE app")
    con.sql("CREATE TABLE t (a INT)")
    con.sql("INSERT INTO t VALUES (4)")
    con.sql("CREATE TEMPORARY VIEW tv AS SELECT 1 AS one")
    TC._OPEN_DBS.clear()
    con2 = duckdb_tpu_torch.connect(db, device="cpu")
    assert con2.sql("SELECT a FROM app.t").rows() == [(4,)]
    assert not con2.catalog.has_table("t")
    with pytest.raises(Exception, match="does not exist"):
        con2.sql("SELECT * FROM tv")


def test_wide_integers_refused_at_checkpoint(tmp_path):
    """A HUGEINT value past 64 bits has no room in the file format: the
    checkpoint says so and leaves the database as it was (the WAL holds
    the table)."""
    from duckdb_tpu_torch.errors import OutOfRangeException

    db = str(tmp_path / "db")
    con = duckdb_tpu_torch.connect(db, device="cpu")
    con.sql("CREATE TABLE w AS SELECT 170141183460469231731687303715884105727::HUGEINT AS h")
    with pytest.raises(OutOfRangeException, match="wider than 64 bits"):
        con.sql("CHECKPOINT")
    TC._OPEN_DBS.clear()
    con2 = duckdb_tpu_torch.connect(db, device="cpu")
    assert con2.sql("SELECT h FROM w").rows() == [(170141183460469231731687303715884105727,)]


# -- entropy and sequences ------------------------------------------------------------------

def test_wal_replay_deterministic_expressions(tmp_path):
    """now(), current_date, random() and the uuids of a logged statement
    replay to the values it stored (both packages, each against itself)."""
    for which in ("jax", "torch"):
        side = FilePackage(which, tmp_path)
        con = side.connect("db")
        con.sql("CREATE TABLE t (ts TIMESTAMP, d DATE, r DOUBLE, u VARCHAR)")
        con.sql("INSERT INTO t VALUES (now(), current_date, random(), uuid())")
        con.sql("INSERT INTO t SELECT now(), current_date, random(), gen_random_uuid() "
                "FROM range(5)")
        before = con.sql("SELECT * FROM t ORDER BY r").rows()
        side.crash()
        assert side.connect("db").sql("SELECT * FROM t ORDER BY r").rows() == before, which
        side.crash()
        if which == "torch":  # a value per row (the JAX package's uuid is one per statement)
            assert len({r[2] for r in before}) == 6 and len({r[3] for r in before}) == 6


def test_logged_sample_replays_its_rows(tmp_path):
    """A sample without REPEATABLE in a logged statement draws from the
    pinned seed: the recovered table holds the rows the statement stored."""
    db = str(tmp_path / "db")
    con = duckdb_tpu_torch.connect(db, device="cpu")
    con.sql("CREATE TABLE s AS SELECT range AS a FROM range(1000) USING SAMPLE 25 ROWS")
    con.sql("INSERT INTO s SELECT range + 1000 FROM range(1000) USING SAMPLE 10%")
    before = con.sql("SELECT a FROM s ORDER BY a").rows()
    assert len(before) > 25
    TC._OPEN_DBS.clear()
    assert duckdb_tpu_torch.connect(db, device="cpu").sql(
        "SELECT a FROM s ORDER BY a").rows() == before


def test_setseed_then_logged_random_is_repeatable(tmp_path):
    """Under setseed() a logged statement's seed comes from the seeded
    generator: two databases given the same statements store the same."""
    out = []
    for k in range(2):
        con = duckdb_tpu_torch.connect(str(tmp_path / f"db{k}"), device="cpu")
        con.sql("SELECT setseed(0.25)")
        con.sql("CREATE TABLE t AS SELECT random() AS r FROM range(4)")
        out.append(con.sql("SELECT r FROM t").rows())
        TC._OPEN_DBS.clear()
        assert duckdb_tpu_torch.connect(str(tmp_path / f"db{k}"), device="cpu").sql(
            "SELECT r FROM t").rows() == out[-1]
    assert out[0] == out[1]


def test_sequences_after_recovery(tmp_path):
    """A sequence's counter is logged at each commit that advanced it, and
    each logged statement replays from the counter it began at: after
    recovery the rows hold what they held, and nextval gives no value a
    committed row holds (a SELECT nextval's value too, as DuckDB logs it)."""
    db = str(tmp_path / "db")
    con = duckdb_tpu_torch.connect(db, device="cpu")
    con.sql("CREATE SEQUENCE s")
    con.sql("CREATE TABLE t (a BIGINT)")
    con.sql("INSERT INTO t SELECT nextval('s') FROM range(3)")
    (v,), = con.sql("SELECT nextval('s')").rows()
    con.sql(f"INSERT INTO t VALUES ({v})")
    con.sql("BEGIN")
    con.sql("INSERT INTO t VALUES (nextval('s'))")
    con.sql("ROLLBACK")  # the value it took is not given again (D5)
    con.sql("INSERT INTO t VALUES (nextval('s'))")
    rows = con.sql("SELECT a FROM t ORDER BY a").rows()
    assert rows == [(1,), (2,), (3,), (4,), (6,)]
    TC._OPEN_DBS.clear()
    con2 = duckdb_tpu_torch.connect(db, device="cpu")
    assert con2.sql("SELECT a FROM t ORDER BY a").rows() == rows
    (n,), = con2.sql("SELECT nextval('s')").rows()
    assert n > max(r[0] for r in rows)
    con2.close()
    con3 = duckdb_tpu_torch.connect(db, device="cpu")
    (m,), = con3.sql("SELECT nextval('s')").rows()
    assert m > n


# -- cross-opening ----------------------------------------------------------------------------

CROSS_SETUP = [
    "CREATE SCHEMA app",
    "CREATE TYPE mood AS ENUM ('sad', 'ok', 'happy')",
    "CREATE SEQUENCE seq START 100 INCREMENT BY 5",
    "CREATE TABLE kinds (id INT PRIMARY KEY, big BIGINT, small SMALLINT, flag BOOLEAN, "
    "price DECIMAL(15,2), tiny DECIMAL(4,1), d DATE, ts TIMESTAMP, x DOUBLE, "
    "s VARCHAR DEFAULT 'none', m mood, li INT[], st STRUCT(a INT, b VARCHAR) )",
    "INSERT INTO kinds VALUES "
    "(1, 9000000000, -3, true, 12.34, 1.5, DATE '1995-03-01', "
    "TIMESTAMP '2001-02-03 04:05:06', 2.5, 'alpha', 'ok', [1, 2], {'a': 1, 'b': 'x'}), "
    "(2, NULL, 7, false, -0.01, NULL, DATE '1969-12-31', NULL, -0.0, NULL, 'sad', [3, 4, 5], NULL), "
    "(3, -1, NULL, NULL, NULL, -9.9, NULL, TIMESTAMP '1970-01-01 00:00:00', NULL, 'ñ', "
    "NULL, NULL, {'a': 0, 'b': 'y'})",
    "INSERT INTO kinds (id) VALUES (4)",
    "CREATE TABLE app.child (pid INT REFERENCES kinds (id), v INT NOT NULL CHECK (v > 0))",
    "INSERT INTO app.child VALUES (1, 5), (3, 6)",
    "CREATE VIEW pricey AS SELECT id, price FROM kinds WHERE price > 0",
    "CREATE MACRO twice(x) AS x * 2",
    "SELECT nextval('seq')",
]
CROSS_CHECKS = [
    "SELECT * EXCLUDE (li, st) FROM kinds ORDER BY id",
    "SELECT id, li FROM kinds ORDER BY id", "SELECT id, st FROM kinds ORDER BY id",
    "SELECT * FROM app.child ORDER BY pid", "SELECT * FROM pricey ORDER BY id",
    "SELECT twice(21)", "SELECT nextval('seq')", "SELECT enum_range(NULL::mood)",
    "INSERT INTO kinds (id) VALUES (1)", "INSERT INTO app.child VALUES (2, 0)",
    "INSERT INTO app.child VALUES (9, 1)", "INSERT INTO kinds (id) VALUES (5)",
    "SELECT id, s FROM kinds WHERE id = 5",
]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_directory_opens_in_the_other_package(tmp_path, writer):
    """A directory one package wrote (checkpointed by close) opens in the
    other with equal rows, objects, constraints and defaults."""
    reader = "torch" if writer == "jax" else "jax"
    w = FilePackage(writer, tmp_path)
    con = w.connect("db")
    for q in CROSS_SETUP:
        con.sql(q)
    con.close()
    w.crash()
    import shutil

    shutil.copytree(w.path("db"), FilePackage(reader, tmp_path).path("db_copy"))
    results = {}
    for which in (writer, reader):
        side = FilePackage(which, tmp_path)
        c = side.connect("db" if which == writer else "db_copy")
        results[which] = [(q, side.sql(c, q)) for q in CROSS_CHECKS]
        side.crash()
    for (q, a), (_, b) in zip(results["jax"], results["torch"]):
        same(q, a, b)
    got = dict(results["torch"])
    assert got["SELECT nextval('seq')"] == ("rows", [(105,)])
    assert got["SELECT id, s FROM kinds WHERE id = 5"] == ("rows", [(5, "none")])


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_wal_opens_in_the_other_package(tmp_path, writer):
    """A directory left with a WAL (no checkpoint since its writes) by one
    package recovers in the other: the JAX package reads the port's
    `--WAL_COMMIT` records as comments, the port reads each JAX entry as a
    unit of its own."""
    import shutil

    reader = "torch" if writer == "jax" else "jax"
    w = FilePackage(writer, tmp_path)
    con = w.connect("db")
    for q in ("CREATE TABLE t (a INT, s VARCHAR, d DECIMAL(9,2))", "CHECKPOINT",
              "INSERT INTO t VALUES (1, 'x', 1.25), (2, NULL, NULL)", "BEGIN",
              "UPDATE t SET s = 'y' WHERE a = 2", "INSERT INTO t VALUES (3, 'z', -0.5)",
              "COMMIT", "DELETE FROM t WHERE a = 1", "CREATE VIEW v AS SELECT a FROM t"):
        con.sql(q)
    want = con.sql("SELECT * FROM t ORDER BY a").rows()
    w.crash()
    r = FilePackage(reader, tmp_path)
    shutil.copytree(w.path("db"), r.path("db"))
    got = r.connect("db")
    assert got.sql("SELECT * FROM t ORDER BY a").rows() == want
    assert got.sql("SELECT a FROM v ORDER BY a").rows() == [(2,), (3,)]
    r.crash()


def test_reads_the_jax_packages_raw_kinds_and_wal(tmp_path):
    """An old-format JAX directory: generation 0 (`data/`) of raw column
    files and a WAL of `--WAL_ENTRY` records with no commit records."""
    db = tmp_path / "db"
    tdir = db / "data" / "t"
    tdir.mkdir(parents=True)
    np.array([1, 2, 3], dtype=np.int64).tofile(tdir / "a.i64")
    np.array([0.5, 1.5, 2.5]).tofile(tdir / "x.f64")
    (tdir / "meta.json").write_text(json.dumps({"rows": 3, "columns": [
        {"name": "a", "kind": "i64"}, {"name": "x", "kind": "f64"}]}))
    (db / "catalog.json").write_text(json.dumps({"tables": [{
        "name": "t", "rows": 3, "columns": [{"name": "a", "type": {"id": "bigint"}},
                                            {"name": "x", "type": {"id": "double"}}]}],
        "views": {}, "schemas": []}))
    (db / "wal.sql").write_text("INSERT INTO t VALUES (4, 3.5);\n--WAL_ENTRY {\"q\": 1}\n")
    con = duckdb_tpu_torch.connect(str(db), device="cpu")
    assert con.sql("SELECT sum(a), sum(x) FROM t").rows() == [(10, 8.0)]
    assert con._db.wal_seq == 1


# -- F7, F8, F9, F11 ---------------------------------------------------------------------------

def _checkpointed_three(side):
    con = side.connect("db")
    con.sql("CREATE TABLE t (x INT)")
    con.sql("INSERT INTO t VALUES (1), (2), (3)")
    con.sql("CHECKPOINT")
    side.crash()
    return side.path("db")


def test_f7_torn_wal_tail_is_not_replayed(tmp_path):
    """F7: a WAL whose last entry was cut while it was written (no
    `--WAL_ENTRY` line) is a commit that never returned: DuckDB, and the
    port, drop it; the JAX package replays it."""
    counts = {}
    for which in ("jax", "torch"):
        side = FilePackage(which, tmp_path)
        db = _checkpointed_three(side)
        with open(os.path.join(db, "wal.sql"), "w") as f:
            f.write("DELETE FROM t")  # `DELETE FROM t WHERE x = 1` cut short
        counts[which] = side.connect("db").sql("SELECT count(*) FROM t").rows()
        side.crash()
    assert counts == {"torch": [(3,)], "jax": [(0,)]}


def test_f7_torn_commit_record(tmp_path):
    """The port's own unit cut inside its commit record is dropped too, and
    every unit before it is applied."""
    db = str(tmp_path / "db")
    con = duckdb_tpu_torch.connect(db, device="cpu")
    con.sql("CREATE TABLE t (x INT)")
    con.sql("INSERT INTO t VALUES (1)")
    con.sql("INSERT INTO t VALUES (2)")
    wal = os.path.join(db, "wal.sql")
    text = open(wal).read()
    cut = text.rindex('"n": 1}')  # inside the last commit record
    for keep in (text[:cut], text[:-1]):  # the record's JSON cut, its newline cut
        TC._OPEN_DBS.clear()
        with open(wal, "w") as f:
            f.write(keep)
        con2 = duckdb_tpu_torch.connect(db, device="cpu")
        assert con2.sql("SELECT x FROM t").rows() == [(1,)]
        assert con2._db.wal_seq == 2


@pytest.mark.parametrize("cut", ["inside_a_line", "at_a_line_end"])
def test_commits_after_a_torn_unit_survive_the_next_crash(tmp_path, cut):
    """Recovery cuts a torn unit off the WAL (as DuckDB truncates it at the
    last valid commit), so that the next commit is appended after a whole
    unit: a commit made after the recovery, then a crash, is there on the
    next reopen, and so is every commit before the torn one. A READ_ONLY
    ATTACH of the torn directory leaves the WAL as it is."""
    db = str(tmp_path / "db")
    wal = os.path.join(db, "wal.sql")
    con = duckdb_tpu_torch.connect(db, device="cpu")
    con.sql("CREATE TABLE t (x INT)")
    con.sql("INSERT INTO t VALUES (1)")
    whole = os.path.getsize(wal)
    for q in ("BEGIN", "INSERT INTO t VALUES (2)", "INSERT INTO t VALUES (3)", "COMMIT"):
        con.sql(q)
    unit = open(wal, "rb").read()[whole:]
    lines = unit.split(b"\n")
    # a statement's line cut in half, or the unit's entries whole and its
    # commit record missing
    torn = whole + (len(lines[0]) // 2 if cut == "inside_a_line"
                    else len(unit) - len(lines[-2]) - 1)
    TC._OPEN_DBS.clear()
    with open(wal, "r+b") as f:
        f.truncate(torn)
    ro = duckdb_tpu_torch.connect(device="cpu")
    ro.sql(f"ATTACH '{db}' AS ext (READ_ONLY)")
    assert ro.sql("SELECT x FROM ext.t").rows() == [(1,)]
    ro.sql("DETACH ext")
    assert os.path.getsize(wal) == torn
    con2 = duckdb_tpu_torch.connect(db, device="cpu")
    assert con2.sql("SELECT x FROM t").rows() == [(1,)]
    assert os.path.getsize(wal) == whole
    con2.sql("INSERT INTO t VALUES (4)")
    for q in ("BEGIN", "DELETE FROM t WHERE x = 1", "INSERT INTO t VALUES (5)", "COMMIT"):
        con2.sql(q)
    TC._OPEN_DBS.clear()
    con3 = duckdb_tpu_torch.connect(db, device="cpu")
    assert con3.sql("SELECT x FROM t ORDER BY x").rows() == [(4,), (5,)]
    assert con3._db.wal_seq == 4
    con3.close()


def test_temporary_objects_do_not_break_recovery(tmp_path):
    """A TEMPORARY table is an ordinary table in both packages: its CREATE
    is logged like its INSERTs. A statement that read a TEMPORARY view
    cannot be replayed by another connection, so its commit checkpoints;
    the view's CREATE and DROP are the connection's own. After a crash the
    directory opens in both packages with the same rows."""
    script = ["CREATE TEMP TABLE tt (a INT)", "INSERT INTO tt VALUES (1), (2)", "@crash",
              "CREATE TABLE t (a INT)",
              "CREATE TEMPORARY VIEW tv AS SELECT a * 10 AS a FROM tt",
              "INSERT INTO t SELECT * FROM tv",
              "CREATE TABLE t2 AS SELECT * FROM tv WHERE a > 10",
              "BEGIN", "INSERT INTO t SELECT a + 1 FROM tv", "UPDATE t2 SET a = a + 1", "COMMIT",
              "UPDATE t SET a = a + 100 WHERE a IN (SELECT a FROM tv)",
              "DROP VIEW tv", "INSERT INTO tt VALUES (3)", "@crash"]
    out = {}
    for which in ("jax", "torch"):
        side = FilePackage(which, tmp_path)
        con, out[which] = side.connect("db"), []
        for q in script:
            if q != "@crash":
                con.sql(q)
                continue
            side.crash()
            con = side.connect("db")
            out[which].append([con.sql(f"SELECT a FROM {t} ORDER BY a").rows()
                               for t in ("tt", "t", "t2") if con.catalog.has_table(t)])
        side.crash()
    assert out["torch"] == out["jax"] == [
        [[(1,), (2,)]], [[(1,), (2,), (3,)], [(11,), (21,), (110,), (120,)], [(21,)]]]


def test_tables_load_tpch_registered_reach_the_directory_at_the_next_commit(tmp_path):
    """load_tpch's tables are not logged: the next commit checkpoints
    instead of logging, so a statement on them recovers after a crash."""
    from duckdb_tpu_torch.testing.tpch_gen import write_tables

    data = str(tmp_path / "tpch")
    write_tables(data, 0.01, 7)
    db = str(tmp_path / "db")
    con = duckdb_tpu_torch.connect(db, device="cpu")
    con.load_tpch(data, tables=["nation"])
    con.sql("DELETE FROM nation WHERE n_nationkey > 20")
    con.sql("INSERT INTO nation SELECT n_nationkey + 100, n_name, n_regionkey, n_comment "
            "FROM nation WHERE n_nationkey < 2")
    TC._OPEN_DBS.clear()
    con2 = duckdb_tpu_torch.connect(db, device="cpu")
    assert con2.sql("SELECT count(*), sum(n_nationkey) FROM nation").rows() == [(23, 411)]
    con2.close()


def test_f9_a_transaction_is_one_unit(tmp_path):
    """F9: a crash while a commit's WAL records are written. Cut the WAL at
    every line the commit appended and reopen: DuckDB and the port give
    the whole transaction or none of it; the JAX package, which logs each
    statement as an entry of its own, gives half of it at some cut."""
    outcomes = {}
    for which in ("jax", "torch"):
        side = FilePackage(which, tmp_path)
        db = _checkpointed_three(side)
        wal = os.path.join(db, "wal.sql")
        con = side.connect("db")
        con.sql("BEGIN")
        con.sql("INSERT INTO t VALUES (10)")
        con.sql("DELETE FROM t WHERE x = 1")
        con.sql("COMMIT")
        side.crash()
        lines = open(wal).read().split("\n")[:-1]
        seen = set()
        for cut in range(len(lines) + 1):
            with open(wal, "w") as f:
                f.write("".join(line + "\n" for line in lines[:cut]))
            seen.add(tuple(r[0] for r in side.connect("db").sql(
                "SELECT x FROM t ORDER BY x").rows()))
            side.crash()
        outcomes[which] = seen
    none, whole, half = (1, 2, 3), (2, 3, 10), (1, 2, 3, 10)
    assert outcomes["torch"] == {none, whole}
    assert half in outcomes["jax"]


def test_every_cut_of_the_wal_recovers_a_prefix_of_commits(tmp_path):
    """A seeded mix of commits (single statements and BEGIN … COMMIT of
    several), then the WAL cut at every line and inside each commit
    record: the reopened table always equals the state after the commits
    whose records the cut kept whole, never anything between."""
    rng = np.random.default_rng(16)
    db = str(tmp_path / "db")
    con = duckdb_tpu_torch.connect(db, device="cpu")
    con.sql("CREATE TABLE t (k INT, v VARCHAR)")
    con.sql("INSERT INTO t SELECT range, 'v' || range FROM range(20)")
    con.sql("CHECKPOINT")
    states = [con.sql("SELECT * FROM t ORDER BY k, v").rows()]
    for c in range(10):
        stmts = []
        for _ in range(int(rng.integers(1, 4))):
            kind, k = int(rng.integers(0, 3)), int(rng.integers(0, 30))
            stmts.append([f"INSERT INTO t VALUES ({k}, 'c{c}')",
                          f"UPDATE t SET v = v || '{c}' WHERE k % 3 = {k % 3}",
                          f"DELETE FROM t WHERE k = {k}"][kind])
        if len(stmts) > 1:
            stmts = ["BEGIN"] + stmts + ["COMMIT"]
        for q in stmts:
            con.sql(q)
        states.append(con.sql("SELECT * FROM t ORDER BY k, v").rows())
    wal = os.path.join(db, "wal.sql")
    text = open(wal).read()
    TC._OPEN_DBS.clear()
    cuts = {i + 1 for i, ch in enumerate(text) if ch == "\n"}
    cuts |= {text.index('"n":', i) for i in range(len(text)) if text.startswith("--WAL_COMMIT", i)}
    for cut in sorted(cuts | {0}):
        with open(wal, "w") as f:
            f.write(text[:cut])
        whole = text[:cut].count("--WAL_COMMIT") - (0 if text[:cut].endswith("\n") or not cut
                                                     else text[:cut].rsplit("\n", 1)[-1]
                                                     .startswith("--WAL_COMMIT"))
        got = duckdb_tpu_torch.connect(db, device="cpu").sql("SELECT * FROM t ORDER BY k, v")
        assert got.rows() == states[whole], cut
        TC._OPEN_DBS.clear()


def test_f8_auto_checkpoint_after_the_whole_unit(tmp_path):
    """F8: a transaction whose first statement takes the WAL past 16 MiB.
    The JAX package checkpoints after that first entry and then logs the
    others above it, so recovery applies them twice; DuckDB and the port
    checkpoint after the whole unit: 1, 2, 3."""
    big = "y" * (17 << 20)
    got = {}
    for which in ("jax", "torch"):
        side = FilePackage(which, tmp_path)
        con = side.connect("db")
        con.sql("CREATE TABLE t (x INT, s VARCHAR)")
        con.sql("BEGIN")
        con.sql(f"INSERT INTO t VALUES (1, '{big}')")
        con.sql("INSERT INTO t VALUES (2, 'a')")
        con.sql("INSERT INTO t VALUES (3, 'b')")
        con.sql("COMMIT")
        side.crash()
        got[which] = side.connect("db").sql("SELECT x FROM t ORDER BY x").rows()
        side.crash()
    assert got == {"torch": [(1,), (2,), (3,)], "jax": [(1,), (2,), (2,), (3,), (3,)]}


def test_checkpoint_threshold_is_read(tmp_path):
    """The port checkpoints once the WAL passes checkpoint_threshold (the
    JAX package's 16 MiB is fixed), after the commit's whole unit."""
    db = str(tmp_path / "db")
    con = duckdb_tpu_torch.connect(db, device="cpu")
    con.sql("SET checkpoint_threshold = '1KB'")
    con.sql("CREATE TABLE t (x INT, s VARCHAR)")
    wal = os.path.join(db, "wal.sql")
    con.sql("BEGIN")
    for k in range(40):
        con.sql(f"INSERT INTO t VALUES ({k}, '{'z' * 40}')")
    assert os.path.getsize(wal) < 1024  # nothing of the open transaction yet
    con.sql("COMMIT")
    assert not os.path.exists(wal)  # past 1 KB: checkpointed after the unit
    con.sql("INSERT INTO t VALUES (99, 'w')")
    TC._OPEN_DBS.clear()
    assert duckdb_tpu_torch.connect(db, device="cpu").sql(
        "SELECT count(*), sum(x) FROM t").rows() == [(41, 879)]


def _record_durability(monkeypatch):
    """os.fsync and os.replace calls as [(op, path)]."""
    calls = []
    real_fsync, real_replace = os.fsync, os.replace

    def fsync(fd):
        calls.append(("fsync", os.readlink(f"/proc/self/fd/{fd}")))
        return real_fsync(fd)

    def replace(a, b, **kw):
        calls.append(("replace", str(b)))
        return real_replace(a, b, **kw)

    monkeypatch.setattr(os, "fsync", fsync)
    monkeypatch.setattr(os, "replace", replace)
    return calls


def test_f11_commit_and_checkpoint_fsync(tmp_path, monkeypatch):
    """F11: the port fsyncs the WAL before a commit returns, and a
    checkpoint fsyncs every data file, its directories and the new header
    before the header replace and the database directory after it; the
    JAX package fsyncs nothing."""
    calls = _record_durability(monkeypatch)
    jdb = str(tmp_path / "jax_db")
    jcon = duckdb_tpu.connect(jdb)
    jcon.sql("CREATE TABLE t (a INT, s VARCHAR)")
    jcon.sql("INSERT INTO t VALUES (1, 'x')")
    jcon.sql("CHECKPOINT")
    assert not [c for c in calls if c[0] == "fsync"]
    calls.clear()

    db = str(tmp_path / "db")
    con = duckdb_tpu_torch.connect(db, device="cpu")
    con.sql("CREATE TABLE t (a INT, s VARCHAR)")
    wal = os.path.join(db, "wal.sql")
    assert ("fsync", wal) in calls and ("fsync", db) in calls  # a new WAL: its directory too
    calls.clear()
    con.sql("INSERT INTO t VALUES (1, 'x')")
    assert calls == [("fsync", wal)]
    calls.clear()
    con.sql("CHECKPOINT")
    at = calls.index(("replace", os.path.join(db, "catalog.json")))
    before, after = calls[:at], calls[at + 1:]
    gen = os.path.join(db, "data.g1")
    for f in ("a.z", "s.z", "meta.json"):
        assert ("fsync", os.path.join(gen, "t", f)) in before
    for d in (os.path.join(gen, "t"), gen, db):
        assert ("fsync", d) in before
    assert ("fsync", os.path.join(db, "catalog.json.tmp")) in before
    assert ("fsync", db) in after
    con.close()


# -- a real crash ------------------------------------------------------------------------------

def test_killed_child_process_recovers(tmp_path):
    """A child process commits a transaction and calls os._exit right after
    COMMIT returns (no close, no checkpoint); the parent reopens and finds
    it whole, and a transaction left open at the kill is not there."""
    db = str(tmp_path / "db")
    child = textwrap.dedent(f"""
        import os, sys
        sys.path.insert(0, {ROOT!r})
        import torch
        torch.set_num_threads(1)
        import duckdb_tpu_torch
        con = duckdb_tpu_torch.connect({db!r}, device="cpu")
        con.sql("CREATE TABLE t (a INT, s VARCHAR)")
        con.sql("INSERT INTO t SELECT range, 'r' || range FROM range(1000)")
        con.sql("BEGIN")
        con.sql("DELETE FROM t WHERE a % 2 = 0")
        con.sql("UPDATE t SET s = 'odd' WHERE a < 10")
        con.sql("COMMIT")
        other = con.cursor()
        other.sql("BEGIN")
        other.sql("DELETE FROM t")
        os._exit(0)
    """)
    subprocess.run([sys.executable, "-c", child], check=True, timeout=300,
                   env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert not os.path.exists(os.path.join(db, "catalog.json"))  # nothing but the WAL
    con = duckdb_tpu_torch.connect(db, device="cpu")
    assert con.sql("SELECT count(*), sum(a), count(*) FILTER (WHERE s = 'odd') FROM t"
                   ).rows() == [(500, 250000, 5)]
    con.close()


Q1 = """
SELECT l_returnflag, l_linestatus, sum(l_quantity) AS sum_qty,
  sum(l_extendedprice) AS sum_base_price,
  sum(l_extendedprice * (1 - l_discount)) AS sum_disc_price,
  sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) AS sum_charge,
  avg(l_quantity) AS avg_qty, avg(l_extendedprice) AS avg_price,
  avg(l_discount) AS avg_disc, count(*) AS count_order
FROM lineitem
WHERE l_shipdate <= CAST('1998-09-02' AS date)
GROUP BY l_returnflag, l_linestatus
ORDER BY l_returnflag, l_linestatus
"""


# -- the registry, the last close and the device ------------------------------------------------

def test_same_file_connects_share(tmp_path):
    """tests/test_mvcc.py's case: two connects of one path in a process
    share the database; it stays open until its last connection closes."""
    db = str(tmp_path / "shared_db")
    a = duckdb_tpu_torch.connect(db, device="cpu")
    a.sql("CREATE TABLE s (v INT)")
    a.sql("INSERT INTO s VALUES (9)")
    b = duckdb_tpu_torch.connect(db, device="cpu")
    assert b._db is a._db
    assert b.sql("SELECT v FROM s").rows() == [(9,)]
    b.sql("INSERT INTO s VALUES (10)")
    assert a.sql("SELECT count(*) FROM s").rows() == [(2,)]
    a.close()
    # the reference checkpoints and leaves the registry at the first close;
    # the database stays open for b, its WAL whole
    assert TC._OPEN_DBS.get(os.path.abspath(db)) is b._db
    assert os.path.exists(os.path.join(db, "wal.sql"))
    b.sql("INSERT INTO s VALUES (11)")
    b.close()
    assert os.path.abspath(db) not in TC._OPEN_DBS
    assert not os.path.exists(os.path.join(db, "wal.sql"))
    c = duckdb_tpu_torch.connect(db, device="cpu")
    assert c.sql("SELECT sum(v) FROM s").rows() == [(30,)]
    c.close()


def test_open_on_another_device_raises(tmp_path):
    db = str(tmp_path / "db")
    a = duckdb_tpu_torch.connect(db, device="cpu")
    with pytest.raises(Exception, match="is open on cpu"):
        duckdb_tpu_torch.connect(db, device="meta")
    assert duckdb_tpu_torch.connect(db).device.type == "cpu"  # joins the open one
    a.close()


def test_close_leaves_nothing_on_the_device(tmp_path, monkeypatch):
    """The last close lets the pool forget the database's tables and the
    string caches drop its dictionaries; a reopen gives new dictionary
    arrays (the caches key on their ids) and new table versions."""
    from duckdb_tpu_torch.ops import strings as S

    monkeypatch.setattr(S, "DEVICE_STR_MIN_DICT", 1)
    db = str(tmp_path / "db")
    con = duckdb_tpu_torch.connect(db, device="cpu")
    con.sql("CREATE TABLE t AS SELECT range AS a, 'w' || (range % 7) AS s FROM range(100)")
    q = "SELECT count(*) FROM t WHERE s LIKE '%3%' AND upper(s) = 'W3'"
    assert con.sql(q).rows() == [(14,)]
    entry = con.catalog.get_table("t")
    dvals = entry.host_column("s")[2]
    assert TCAT.POOL.holds(entry)
    con.close()
    assert not TCAT.POOL.holds(entry) and not entry._device
    from duckdb_tpu_torch.execution import cache_registry as CR

    assert not any(isinstance(v, tuple) and v and v[0] is dvals
                   for store in list(CR._STORES) for v in store.values())
    con2 = duckdb_tpu_torch.connect(db, device="cpu")
    entry2 = con2.catalog.get_table("t")
    assert entry2.host_column("s")[2] is not dvals and entry2.version != entry.version
    assert con2.sql(q).rows() == [(14,)]
    con2.close()


def test_reopened_q1_through_the_grouped_sum(tmp_path, monkeypatch):
    """Q1 over a checkpointed, then WAL-recovered lineitem: the rows equal
    the in-memory run's, and the grouped sum (the kernel's plain version on
    the CPU) runs."""
    from duckdb_tpu_torch.ops import grouped as grouped_mod
    from duckdb_tpu_torch.ops import grouped_sum as GS
    from duckdb_tpu_torch.testing.tpch_gen import write_tables

    data = str(tmp_path / "tpch")
    write_tables(data, 0.01, 7)
    mem = duckdb_tpu_torch.connect(device="cpu")
    mem.load_tpch(data)
    want = mem.sql(Q1).rows()
    db = str(tmp_path / "db")
    con = duckdb_tpu_torch.connect(db, device="cpu")
    con.load_tpch(data, tables=["lineitem"])
    con.sql("CHECKPOINT")
    con.sql("DELETE FROM lineitem WHERE l_orderkey % 5 = 0")
    mem.sql("DELETE FROM lineitem WHERE l_orderkey % 5 = 0")
    want2 = mem.sql(Q1).rows()
    TC._OPEN_DBS.clear()
    calls = []

    def counting(dense, vecs, nseg):
        calls.append(len(vecs))
        return GS.grouped_sum_i64(dense, vecs, nseg)

    monkeypatch.setattr(grouped_mod, "grouped_sum_i64", counting)
    con2 = duckdb_tpu_torch.connect(db, device="cpu")
    assert con2.sql(Q1).rows() == want2 != want and calls
    con2.close()
