"""ALTER TABLE of duckdb_tpu_torch (device="cpu") against the JAX package.

Each script runs statement by statement through both packages
(tests/_torch_parity.py): the ALTER cases of tests/test_ddl_ext.py,
tests/test_ddl_dml_features.py and tests/test_plan_cache.py, type changes
between DECIMAL scales, to DOUBLE and a narrowing one that overflows, and
every action inside a rolled-back transaction. Where the JAX package is
wrong the port is held to DuckDB: A1, RENAME COLUMN renames
the column in the table's constraints, defaults, indexes and the FOREIGN
KEYs of other tables; A2, DROP COLUMN refuses a column a key, an index, a
FOREIGN KEY or a CHECK over several columns depends on, and drops a CHECK
or NOT NULL over it alone; A3, ADD COLUMN … DEFAULT nextval() advances the
sequence; A4, a DECIMAL column cast to a smaller scale keeps its value.
Then what a rename or drop means for the rest:
the published table after ROLLBACK, the first committer winning, a file
database killed and reopened, the device pool, prepared statements and
views, and TPC-H Q1 through the grouped sum after each ALTER.
"""

import decimal
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import duckdb_tpu_torch
from duckdb_tpu_torch.api import connection as TC
from duckdb_tpu_torch.api.alter import referenced_columns, rename_refs
from duckdb_tpu_torch.catalog import catalog as C
from duckdb_tpu_torch.errors import CatalogException, ConstraintException, TransactionException
from duckdb_tpu_torch.ops import grouped as grouped_mod
from duckdb_tpu_torch.planner.bound import BindError
from duckdb_tpu_torch.testing.tpch_gen import write_tables

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from _torch_parity import run_both, run_both_files  # noqa: E402
import chip_smoke  # noqa: E402  (Q1's text and its numpy answer)

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

T2 = ["CREATE TABLE t (a INT)", "INSERT INTO t VALUES (1),(2)"]

SCRIPTS = {
    # tests/test_ddl_ext.py
    "add_column_nulls": T2 + ["ALTER TABLE t ADD COLUMN b VARCHAR",
                              "SELECT * FROM t ORDER BY a"],
    "rename_column_and_update": T2 + [
        "ALTER TABLE t ADD COLUMN b VARCHAR", "ALTER TABLE t RENAME COLUMN b TO label",
        "UPDATE t SET label = 'x' WHERE a = 1", "SELECT label FROM t ORDER BY a"],
    "drop_column": T2 + ["ALTER TABLE t ADD COLUMN b INT", "ALTER TABLE t DROP COLUMN b",
                         "SELECT * FROM t ORDER BY a"],
    "rename_table": T2 + ["ALTER TABLE t RENAME TO t2", "SELECT count(*) FROM t2",
                          "SELECT * FROM t"],
    # tests/test_ddl_dml_features.py
    "column_type_default_not_null": [
        "CREATE TABLE t(i INT, j INT)", "INSERT INTO t VALUES (1, 10), (2, 20)",
        "ALTER TABLE t ALTER COLUMN j SET DATA TYPE VARCHAR",
        "SELECT j FROM t ORDER BY i",
        "ALTER TABLE t ALTER i SET DEFAULT 99", "INSERT INTO t(j) VALUES ('z')",
        "SELECT i FROM t WHERE j='z'",
        "ALTER TABLE t ALTER i DROP DEFAULT",
        "ALTER TABLE t ALTER COLUMN i SET NOT NULL",
        "INSERT INTO t(j) VALUES ('w')",
        "ALTER TABLE t ALTER COLUMN i DROP NOT NULL",
        "INSERT INTO t(j) VALUES ('w')",
        "ALTER TABLE t ADD COLUMN k INT DEFAULT 5",
        "SELECT DISTINCT k FROM t",
        "SELECT * FROM t ORDER BY j"],
    "type_using": [
        "CREATE TABLE t(v INT)", "INSERT INTO t VALUES (1), (2)",
        "ALTER TABLE t ALTER v TYPE VARCHAR USING 'n' || CAST(v AS VARCHAR)",
        "SELECT v FROM t ORDER BY v", "SELECT upper(v), v LIKE 'n%' FROM t ORDER BY v"],
    # tests/test_plan_cache.py: the cached plan of a query sees the new column
    "plan_cache": [
        "CREATE TABLE t (a INT, b VARCHAR)", "INSERT INTO t VALUES (1, 'x'), (2, 'y')",
        "SELECT * FROM t ORDER BY a", "ALTER TABLE t ADD COLUMN c INT",
        "SELECT * FROM t ORDER BY a"],
    # the JAX package's cast semantics: DECIMAL scales, DOUBLE, overflow
    "decimal_types": [
        "CREATE TABLE d (k INT, x DECIMAL(9,2), y DECIMAL(15,4), z INT)",
        "INSERT INTO d VALUES (1, 1.25, 2.0005, 100), (2, -3.5, -0.0001, 300), (3, NULL, 7, 5)",
        "ALTER TABLE d ALTER x TYPE DECIMAL(18,4)", "SELECT x FROM d ORDER BY k",
        "ALTER TABLE d ALTER y TYPE DECIMAL(15,2)", "SELECT y FROM d ORDER BY k",
        "ALTER TABLE d ALTER x TYPE DOUBLE", "SELECT x, x * 2 FROM d ORDER BY k",
        "ALTER TABLE d ALTER z TYPE TINYINT", "SELECT z FROM d ORDER BY k",
        "ALTER TABLE d ALTER z TYPE VARCHAR", "ALTER TABLE d ALTER z TYPE INTEGER",
        "SELECT sum(z) FROM d"],
    # SET NOT NULL over a NULL raises; IF EXISTS
    "not_null_and_if_exists": T2 + [
        "INSERT INTO t VALUES (NULL)", "ALTER TABLE t ALTER a SET NOT NULL",
        "ALTER TABLE IF EXISTS nope ADD COLUMN x INT", "SELECT count(*) FROM t"],
    # a default evaluated once a row (nextval)
    "add_column_nextval": T2 + [
        "CREATE SEQUENCE s START 10",
        "ALTER TABLE t ADD COLUMN n BIGINT DEFAULT nextval('s')",
        "SELECT a, n FROM t ORDER BY a", "INSERT INTO t (a) VALUES (3)",
        "SELECT * FROM t ORDER BY a"],
    # every action inside a transaction that rolls back
    "rollback": T2 + [
        "BEGIN", "ALTER TABLE t ADD COLUMN b INT DEFAULT 4", "SELECT * FROM t ORDER BY a",
        "ROLLBACK", "SELECT * FROM t ORDER BY a",
        "BEGIN", "ALTER TABLE t RENAME COLUMN a TO z", "SELECT z FROM t ORDER BY z",
        "ROLLBACK", "SELECT a FROM t ORDER BY a",
        "BEGIN", "ALTER TABLE t ALTER a TYPE VARCHAR", "ROLLBACK",
        "SELECT a + 1 FROM t ORDER BY a",
        "BEGIN", "ALTER TABLE t RENAME TO u", "ROLLBACK", "SELECT count(*) FROM t",
        "BEGIN", "ALTER TABLE t ALTER a SET DEFAULT 8", "ROLLBACK",
        "INSERT INTO t DEFAULT VALUES", "SELECT * FROM t ORDER BY a"],
}


# where the JAX package is wrong, DuckDB's answer: A3, ADD COLUMN … DEFAULT
# nextval() leaves the sequence where it was, so the next INSERT repeats a
# value; A4, a DECIMAL column cast to a smaller scale gives 0 (a constant
# casts right)
DUCKDB = {
    "add_column_nextval": {"SELECT * FROM t ORDER BY a": [(1, 10), (2, 11), (3, 12)]},
    "decimal_types": {"SELECT y FROM d ORDER BY k": [(decimal.Decimal("2.00"),),
                                                     (decimal.Decimal("0.00"),),
                                                     (decimal.Decimal("7.00"),)]},
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_alter_matches_jax(name):
    run_both(SCRIPTS[name], duckdb=DUCKDB.get(name))


A1_SETUP = ["CREATE TABLE r (id INTEGER PRIMARY KEY, v INTEGER CHECK (v > 0), "
            "d INTEGER DEFAULT 3)"]
A1 = {
    "check": ("ALTER TABLE r RENAME COLUMN v TO w", "INSERT INTO r VALUES (1, 5, 1)"),
    "primary_key": ("ALTER TABLE r RENAME COLUMN id TO k", "INSERT INTO r VALUES (1, 5, 1)"),
    "default": ("ALTER TABLE r RENAME COLUMN d TO e", "INSERT INTO r (id, v) VALUES (1, 5)"),
}


@pytest.mark.parametrize("kind", sorted(A1))
def test_a1_rename_column_keeps_the_table_usable(kind):
    """DuckDB renames the column inside every constraint and default: the
    INSERT after the rename works there (the JAX package raises Binder
    Error or NOT NULL for the first two and loses the default in the third),
    and the renamed constraint still holds."""
    rename, insert = A1[kind]
    check = "SELECT * FROM r"
    want = {check: [(1, 5, 3)]} if kind == "default" else {insert: [(1,)],
                                                             check: [(1, 5, 1)]}
    _, tcon = run_both(A1_SETUP + [rename, insert, check], duckdb=want)
    with pytest.raises(ConstraintException):
        tcon.sql("INSERT INTO r VALUES (2, -1, 1)")  # the CHECK
    with pytest.raises(ConstraintException):
        tcon.sql("INSERT INTO r VALUES (1, 7, 1)")  # the key


def test_a1_rename_reaches_foreign_keys_indexes_and_comments():
    tcon = duckdb_tpu_torch.connect(device="cpu")
    tcon.sql("CREATE TABLE par (id INTEGER PRIMARY KEY, tag VARCHAR)")
    tcon.sql("CREATE TABLE chi (pid INTEGER REFERENCES par(id), "
             "CHECK (pid > 0 AND 'pid' <> ''))")
    tcon.sql("CREATE UNIQUE INDEX par_tag ON par (tag)")
    tcon.sql("COMMENT ON COLUMN par.tag IS 'the tag'")
    tcon.sql("INSERT INTO par VALUES (1, 'x'); INSERT INTO chi VALUES (1)")
    tcon.sql("ALTER TABLE par RENAME COLUMN id TO pk")
    tcon.sql("ALTER TABLE par RENAME COLUMN tag TO label")
    tcon.sql("ALTER TABLE chi RENAME COLUMN pid TO parent")
    chi = tcon.catalog.get_table("chi")
    assert ("foreign_key", ["parent"], "par", ["pk"]) in chi.constraints
    assert ("check", "\"parent\" > 0 AND 'pid' <> ''") in chi.constraints
    assert tcon.catalog.indexes["par_tag"]["exprs"] == ['"label"']
    assert tcon.catalog.comments[("column", "par", "label")] == "the tag"
    tcon.sql("INSERT INTO chi VALUES (1)")
    with pytest.raises(ConstraintException):
        tcon.sql("INSERT INTO chi VALUES (9)")
    with pytest.raises(ConstraintException):
        tcon.sql("INSERT INTO par VALUES (2, 'x')")  # the unique index on label
    with pytest.raises(ConstraintException):
        tcon.sql("DELETE FROM par WHERE pk = 1")
    tcon.sql("ALTER TABLE par RENAME TO parent_t")
    assert ("foreign_key", ["parent"], "parent_t", ["pk"]) in \
        tcon.catalog.get_table("chi").constraints
    with pytest.raises(ConstraintException):
        tcon.sql("INSERT INTO chi VALUES (9)")


def test_a1_rename_leaves_a_child_tables_own_columns():
    """A child whose own column has the renamed column's name: DuckDB
    renames only the columns its FOREIGN KEY references, and the child's
    PRIMARY KEY, NOT NULL and CHECK on its own `id` hold as before (the JAX
    package's FOREIGN KEY still names par(id), so the child takes no row)."""
    chi = "SELECT * FROM chi ORDER BY id"
    _, tcon = run_both(
        ["CREATE TABLE par (id INTEGER PRIMARY KEY)",
         "CREATE TABLE chi (id INTEGER NOT NULL PRIMARY KEY CHECK (id > 0), "
         "pid INTEGER REFERENCES par(id))",
         "INSERT INTO par VALUES (1), (2)", "INSERT INTO chi VALUES (5, 1)",
         "ALTER TABLE par RENAME COLUMN id TO pk", "INSERT INTO chi VALUES (6, 2)", chi],
        duckdb={"INSERT INTO chi VALUES (6, 2)": [(1,)], chi: [(5, 1), (6, 2)]})
    assert tcon.catalog.get_table("chi").constraints == [
        ("not_null", "id"), ("primary_key", ["id"]), ("check", "id > 0"),
        ("foreign_key", ["pid"], "par", ["pk"])]
    for row in ("(6, 1)", "(NULL, 1)", "(-1, 1)", "(7, 9)"):  # key, NOT NULL, CHECK, FK
        with pytest.raises(ConstraintException):
            tcon.sql(f"INSERT INTO chi VALUES {row}")
    assert tcon.sql(chi).rows() == [(5, 1), (6, 2)]


def test_rename_refs_rewrites_column_nodes_only():
    text = "v > 0 AND lower('v') <> \"V\" AND t.v < 100 AND vv = 1"
    assert rename_refs(text, "v", "w") == \
        "\"w\" > 0 AND lower('v') <> \"w\" AND t.\"w\" < 100 AND vv = 1"
    assert referenced_columns("a + b > coalesce(c, 'a')") == {"a", "b", "c"}


A2_SETUP = ["CREATE TABLE k (id INTEGER PRIMARY KEY, c INTEGER CHECK (c > 0), "
            "n INTEGER NOT NULL)",
            "INSERT INTO k VALUES (1, 1, 1)"]


A2_DROPS = {
    # a CHECK over the dropped column alone goes with it: the JAX package
    # keeps it, and every INSERT afterwards raises
    "check_alone": ["ALTER TABLE k DROP COLUMN c", "INSERT INTO k VALUES (2, 2)",
                    "SELECT * FROM k ORDER BY id"],
    # a NOT NULL over it goes too (the JAX package keeps it)
    "not_null_alone": ["ALTER TABLE k DROP COLUMN n", "INSERT INTO k VALUES (2, 2)",
                       "SELECT * FROM k ORDER BY id"],
    # a PRIMARY KEY column stays: the JAX package drops it
    "primary_key": ["ALTER TABLE k DROP COLUMN id", "SELECT * FROM k ORDER BY id"],
}
A2_WANT = {
    "check_alone": {"INSERT INTO k VALUES (2, 2)": [(1,)],
                    "SELECT * FROM k ORDER BY id": [(1, 1), (2, 2)]},
    "not_null_alone": {"INSERT INTO k VALUES (2, 2)": [(1,)],
                       "SELECT * FROM k ORDER BY id": [(1, 1), (2, 2)]},
    "primary_key": {"ALTER TABLE k DROP COLUMN id": CatalogException,
                    "SELECT * FROM k ORDER BY id": [(1, 1, 1)]},
}


@pytest.mark.parametrize("kind", sorted(A2_DROPS))
def test_a2_drop_column_follows_duckdb(kind):
    """DuckDB's RemoveColumn: a CHECK or NOT NULL over the dropped column
    alone is dropped with it; a key column is refused."""
    _, tcon = run_both(A2_SETUP + A2_DROPS[kind], duckdb=A2_WANT[kind])
    if kind == "not_null_alone":
        assert ("not_null", "n") not in tcon.catalog.get_table("k").constraints


A2_REFUSED = {
    "unique": ["CREATE TABLE m (a INT UNIQUE, b INT)", "ALTER TABLE m DROP COLUMN a"],
    "check_over_two": ["CREATE TABLE m (a INT, b INT, CHECK (a < b))",
                       "ALTER TABLE m DROP COLUMN a"],
    "index": ["CREATE TABLE m (a INT, b INT)", "CREATE INDEX m_b ON m (b)",
              "ALTER TABLE m DROP COLUMN b"],
    "foreign_key_child": ["CREATE TABLE p (id INT PRIMARY KEY)",
                          "CREATE TABLE m (a INT REFERENCES p(id), b INT)",
                          "ALTER TABLE m DROP COLUMN a"],
    "foreign_key_parent": ["CREATE TABLE m (a INT UNIQUE, b INT)",
                           "CREATE TABLE c (x INT REFERENCES m(a))",
                           "ALTER TABLE m DROP COLUMN a"],
}


@pytest.mark.parametrize("kind", sorted(A2_REFUSED))
def test_a2_drop_column_refuses_what_depends_on_it(kind):
    *setup, drop = A2_REFUSED[kind]
    check = "SELECT * FROM m"
    child = kind == "foreign_key_child"
    run_both(setup + ["INSERT INTO p VALUES (1)" if child else "INSERT INTO m VALUES (1, 2)",
                      drop, check],
             duckdb={drop: CatalogException, **({} if child else {check: [(1, 2)]})})


def test_drop_last_column_and_missing_columns():
    tcon = duckdb_tpu_torch.connect(device="cpu")
    tcon.sql("CREATE TABLE t (a INT)")
    with pytest.raises(CatalogException, match="only has one column"):
        tcon.sql("ALTER TABLE t DROP COLUMN a")
    with pytest.raises(CatalogException, match="does not have a column"):
        tcon.sql("ALTER TABLE t DROP COLUMN zz")
    tcon.sql("ALTER TABLE t DROP COLUMN IF EXISTS zz")
    tcon.sql("ALTER TABLE t ADD COLUMN b INT")
    with pytest.raises(CatalogException, match="already exists"):
        tcon.sql("ALTER TABLE t ADD COLUMN b INT")
    tcon.sql("ALTER TABLE t ADD COLUMN IF NOT EXISTS b INT")
    with pytest.raises(CatalogException, match="already exists"):
        tcon.sql("ALTER TABLE t RENAME COLUMN a TO b")
    assert [c.name for c in tcon.catalog.get_table("t").columns] == ["a", "b"]


def _state(con, name):
    e = con.catalog.get_table(name)
    return ([(c.name, repr(c.ltype)) for c in e.columns], list(e.constraints),
            dict(e.defaults), e.nrows)


ROLLBACK_ACTIONS = [
    "ALTER TABLE t ADD COLUMN x INT DEFAULT 1",
    "ALTER TABLE t DROP COLUMN s",
    "ALTER TABLE t RENAME COLUMN v TO w",
    "ALTER TABLE t ALTER v TYPE BIGINT",
    "ALTER TABLE t ALTER s SET DEFAULT 'q'",
    "ALTER TABLE t ALTER d DROP DEFAULT",
    "ALTER TABLE t ALTER s SET NOT NULL",
    "ALTER TABLE t ALTER v DROP NOT NULL",
    "ALTER TABLE t RENAME TO t9",
]


@pytest.mark.parametrize("action", ROLLBACK_ACTIONS)
def test_rollback_restores_the_published_table(action):
    """The published table is unchanged after each action rolls back: its
    columns, constraints, defaults, indexes and rows."""
    con = duckdb_tpu_torch.connect(device="cpu")
    con.sql("CREATE TABLE t (id INT PRIMARY KEY, v INT NOT NULL CHECK (v > 0), s VARCHAR, "
            "d INT DEFAULT 2)")
    con.sql("CREATE INDEX t_v ON t (v)")
    con.sql("INSERT INTO t VALUES (1, 5, 'a', 1), (2, 6, 'b', 2)")
    before = _state(con, "t")
    rows = con.sql("SELECT * FROM t ORDER BY id").rows()
    published = con._db.catalog.tables["t"]
    con.sql("BEGIN")
    con.sql(action)
    con.sql("ROLLBACK")
    assert con._db.catalog.tables["t"] is published
    assert _state(con, "t") == before
    assert con.catalog.indexes["t_v"] == {"table": "t", "exprs": ["v"], "unique": False}
    assert con.sql("SELECT * FROM t ORDER BY id").rows() == rows
    with pytest.raises(ConstraintException):
        con.sql("INSERT INTO t VALUES (3, -1, 'c', 3)")


@pytest.mark.parametrize("first", ["write_old_name", "create_new_name", "alter"])
def test_first_committer_wins(first):
    a = duckdb_tpu_torch.connect(device="cpu")
    a.sql("CREATE TABLE t (x INT); INSERT INTO t VALUES (1)")
    b = a.cursor()
    a.sql("BEGIN")
    b.sql("BEGIN")
    a.sql("ALTER TABLE t RENAME TO u" if first != "alter" else "ALTER TABLE t ADD COLUMN y INT")
    b.sql({"write_old_name": "INSERT INTO t VALUES (2)",
           "create_new_name": "CREATE TABLE u (z INT)",
           "alter": "ALTER TABLE t RENAME COLUMN x TO w"}[first])
    b.sql("COMMIT")
    with pytest.raises(TransactionException):
        a.sql("COMMIT")
    assert a.catalog.has_table("t")


def test_pool_releases_a_dropped_column():
    """DROP COLUMN and a type change let the old column's device bytes go
    once the old version of the table is no longer published."""
    con = duckdb_tpu_torch.connect(device="cpu")
    con.sql("CREATE TABLE t AS SELECT range AS a, range * 2 AS b FROM range(100000)")
    con.sql("SELECT sum(a), sum(b) FROM t").rows()
    b_col = con.catalog.get_table("t")._device["b"]
    used = C.POOL.used
    con.sql("ALTER TABLE t DROP COLUMN b")
    assert id(b_col) not in C.POOL._columns and C.POOL.used < used
    a_col = con.catalog.get_table("t")._device["a"]
    con.sql("ALTER TABLE t ALTER a TYPE DOUBLE")
    assert id(a_col) not in C.POOL._columns
    assert con.sql("SELECT sum(a) FROM t").rows() == [(4999950000.0,)]


def test_prepared_statements_and_views_over_changed_columns():
    """A PREPAREd SELECT and a view plan again after an ALTER: a renamed or
    dropped column is a binder error at query time, in both packages."""
    script = ["CREATE TABLE t (a INT, b INT)", "INSERT INTO t VALUES (1, 2)",
              "PREPARE q AS SELECT b FROM t WHERE a = ?", "EXECUTE q(1)",
              "CREATE VIEW vb AS SELECT b FROM t", "SELECT * FROM vb",
              "ALTER TABLE t RENAME COLUMN b TO c", "EXECUTE q(1)", "SELECT * FROM vb",
              "PREPARE q2 AS SELECT c FROM t WHERE a = ?", "EXECUTE q2(1)",
              "ALTER TABLE t DROP COLUMN c", "EXECUTE q2(1)", "SELECT * FROM t"]
    _, tcon = run_both(script)
    with pytest.raises(BindError):
        tcon.sql("SELECT * FROM vb")


def test_alter_is_wal_logged(tmp_path):
    """tests/test_persistence.py::test_alter_is_wal_logged on both packages:
    ALTER is logged, and replay after a crash sees the new schema."""
    def scenario(side):
        con = side.connect("db")
        out = [(sql, side.sql(con, sql)) for sql in [
            "CREATE TABLE t (a INT)", "INSERT INTO t VALUES (1)",
            "ALTER TABLE t ADD COLUMN b VARCHAR", "INSERT INTO t VALUES (2, 'two')"]]
        side.crash()
        con2 = side.connect("db")
        return out + [("SELECT a, b FROM t ORDER BY a",
                       side.sql(con2, "SELECT a, b FROM t ORDER BY a"))]

    run_both_files(tmp_path, scenario)


CHILD = """
import os, sys
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(1)
import duckdb_tpu_torch
con = duckdb_tpu_torch.connect({db!r}, device="cpu")
con.sql("CREATE TABLE par (id INTEGER PRIMARY KEY, tag VARCHAR)")
con.sql("CREATE TABLE chi (pid INTEGER REFERENCES par(id), v INTEGER CHECK (v > 0), "
        "drop_me INTEGER, n INTEGER DEFAULT 4)")
con.sql("INSERT INTO par VALUES (1, 'a'), (2, 'b'), (3, 'c')")
con.sql("INSERT INTO chi VALUES (1, 10, 0, 1), (2, 20, 0, 2)")
con.sql("CHECKPOINT")
con.sql("ALTER TABLE par RENAME COLUMN id TO pk")
con.sql("ALTER TABLE chi RENAME COLUMN v TO w")
con.sql("ALTER TABLE chi DROP COLUMN drop_me")
con.sql("ALTER TABLE chi ADD COLUMN extra DOUBLE DEFAULT 0.5")
con.sql("ALTER TABLE chi ALTER n TYPE BIGINT")
con.sql("ALTER TABLE chi ALTER n SET DEFAULT 40")
con.sql("ALTER TABLE par ALTER tag SET NOT NULL")
con.sql("ALTER TABLE par RENAME TO parent")
con.sql("MERGE INTO chi USING (SELECT 2 AS pid, 25 AS w UNION ALL SELECT 3, 30) s "
        "ON chi.pid = s.pid WHEN MATCHED THEN UPDATE SET w = s.w "
        "WHEN NOT MATCHED THEN INSERT (pid, w) VALUES (s.pid, s.w)")
with con.appender("parent") as app:
    app.append_row(4, "d")
    app.append_row(5, "e")
con.sql("INSERT INTO chi (pid, w) VALUES (5, 50)")
os._exit(0)
"""


def test_killed_child_keeps_alter_merge_and_appends(tmp_path):
    """A child process ALTERs every way, MERGEs and appends in a file
    database and dies by os._exit; the reopened database has the schema and
    the rows, and again after a CHECKPOINT, the renames inside constraints
    and foreign keys included."""
    db = str(tmp_path / "db")
    subprocess.run([sys.executable, "-c", textwrap.dedent(CHILD.format(root=ROOT, db=db))],
                   check=True, timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    for _ in range(2):
        con = duckdb_tpu_torch.connect(db, device="cpu")
        chi = con.catalog.get_table("chi")
        assert [(c.name, repr(c.ltype)) for c in chi.columns] == [
            ("pid", "INTEGER"), ("w", "INTEGER"), ("n", "BIGINT"), ("extra", "DOUBLE")]
        assert ("foreign_key", ["pid"], "parent", ["pk"]) in chi.constraints
        assert ("check", '"w" > 0') in chi.constraints
        assert chi.defaults["n"] == "40"
        assert con.sql("SELECT * FROM chi ORDER BY pid").rows() == [
            (1, 10, 1, 0.5), (2, 25, 2, 0.5), (3, 30, 40, 0.5), (5, 50, 40, 0.5)]
        assert con.sql("SELECT * FROM parent ORDER BY pk").rows() == [
            (1, "a"), (2, "b"), (3, "c"), (4, "d"), (5, "e")]
        with pytest.raises(ConstraintException):
            con.sql("INSERT INTO chi (pid, w) VALUES (9, 1)")
        with pytest.raises(ConstraintException):
            con.sql("INSERT INTO parent VALUES (6, NULL)")
        con.sql("CHECKPOINT")
        TC._OPEN_DBS.clear()


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("tpch_gen_alter")
    write_tables(str(root), 0.01, seed=7)
    return str(root)


def test_q1_after_alter_reaches_the_kernel(data_dir, monkeypatch):
    """Phase 21's ALTERs at SF 0.01, then Q1 written with the new name:
    equal to numpy, through the grouped sum (its plain version here); a
    rolled-back DROP COLUMN changes nothing."""
    tcon = duckdb_tpu_torch.connect(device="cpu")
    tcon.load_tpch(data_dir)
    tcon.sql("CREATE TABLE li AS SELECT * FROM lineitem")
    for sql in chip_smoke.ALTERS:
        tcon.sql(sql)
    calls = []
    orig = grouped_mod.grouped_sum_i64

    def recording(dense, vectors, nseg):
        calls.append(nseg)
        return orig(dense, vectors, nseg)

    monkeypatch.setattr(grouped_mod, "grouped_sum_i64", recording)
    q1 = chip_smoke.Q1_ALTERED
    want = chip_smoke.numpy_q1_of(chip_smoke.lineitem_numpy(data_dir))
    assert chip_smoke.rows_match(tcon.sql(q1).rows(), want) == ""
    assert len(calls) == 1
    tcon.sql("BEGIN")
    tcon.sql("ALTER TABLE li DROP COLUMN l_tax")
    tcon.sql("ROLLBACK")
    assert chip_smoke.rows_match(tcon.sql(q1).rows(), want) == ""
    assert tcon.sql("SELECT DISTINCT l_batch FROM li").rows() == [(7,)]
    li = tcon.catalog.get_table("li")
    assert repr(li.col_types["l_linenumber"]) == "BIGINT" and "l_comment" not in li.col_types
    assert np.array_equal(li.host_column("l_linenumber")[0],
                          chip_smoke.lineitem_numpy(data_dir)["l_linenumber"])
