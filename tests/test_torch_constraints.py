"""Constraints of duckdb_tpu_torch (device="cpu") against the JAX package.

The counterparts of tests/test_constraints.py and tests/test_foreign_keys.py:
NOT NULL, PRIMARY KEY, UNIQUE (NULLs never collide), CHECK, composite and
table-level keys, FOREIGN KEY on insert and delete (and to the parent's
primary key), the UPDATE checks on the post-update state, INSERT … ON
CONFLICT DO NOTHING / DO UPDATE, INSERT OR REPLACE / OR IGNORE, and the
unique-key index advanced by each append and rebuilt after a ROLLBACK.
Rows, Counts and exception classes must agree (tests/_torch_parity.py);
a violation is DuckDB's ConstraintException in the port, which is also
the JAX package's ConnectionException. F5 (an UPDATE of a referenced
parent key) and F6 (DROP TABLE of a referenced parent) are held to DuckDB,
and the JAX package still differs. The cases that reopen a database file
are in tests/test_torch_storage.py.
"""

import os
import sys

import pytest
import torch

import duckdb_tpu
import duckdb_tpu_torch
from duckdb_tpu_torch.errors import ConnectionException, ConstraintException

sys.path.insert(0, os.path.dirname(__file__))
from _torch_parity import run_both  # noqa: E402

torch.set_num_threads(1)

P = ["CREATE TABLE p (id INT PRIMARY KEY, name VARCHAR NOT NULL, age INT CHECK (age >= 0), "
     "email VARCHAR UNIQUE)",
     "INSERT INTO p VALUES (1, 'alice', 30, 'a@x.com')"]
PARENT = ["CREATE TABLE parent (id INT PRIMARY KEY, name VARCHAR)",
          "INSERT INTO parent VALUES (1, 'a'), (2, 'b')"]

SCRIPTS = {
    "primary_key": P + ["INSERT INTO p VALUES (1,'b',1,'b@x')", "SELECT count(*) FROM p"],
    "not_null": P + ["INSERT INTO p VALUES (2, NULL, 1, 'b@x')",
                     "INSERT INTO p (id, age) VALUES (2, 1)", "SELECT count(*) FROM p"],
    "check": P + ["INSERT INTO p VALUES (2,'b',-5,'b@x')", "INSERT INTO p VALUES (2,'b',NULL,'c')",
                  "SELECT id, age FROM p ORDER BY id"],
    "unique_and_nulls": P + ["INSERT INTO p VALUES (2,'b',1,'a@x.com')",
                             "INSERT INTO p VALUES (2,'b',1,NULL), (3,'c',1,NULL)",
                             "SELECT count(*) FROM p"],
    "failed_insert_appends_nothing": P + ["INSERT INTO p VALUES (9,'z',1,'z@x'),(9,'y',1,'y@x')",
                                          "SELECT count(*) FROM p"],
    "table_level_composite": [
        "CREATE TABLE c2 (a INT, b INT, PRIMARY KEY (a, b), CHECK (a < b))",
        "INSERT INTO c2 VALUES (1, 2), (1, 3)", "INSERT INTO c2 VALUES (1, 2)",
        "INSERT INTO c2 VALUES (5, 4)", "INSERT INTO c2 VALUES (NULL, 4)",
        "SELECT * FROM c2 ORDER BY a, b"],
    "composite_unique_varchar": [
        "CREATE TABLE u (a VARCHAR, b INT, UNIQUE (a, b))",
        "INSERT INTO u VALUES ('x', 1), ('x', 2), ('y', 1)", "INSERT INTO u VALUES ('x', 1)",
        "INSERT INTO u VALUES ('x', NULL), ('x', NULL)", "SELECT count(*) FROM u"],
    "update_constraints": P + [
        "INSERT INTO p VALUES (2, 'b', 20, 'b@x')", "UPDATE p SET id = 1 WHERE id = 2",
        "UPDATE p SET name = NULL WHERE id = 1", "UPDATE p SET age = -5 WHERE id = 2",
        "UPDATE p SET age = age + 1, id = 1 WHERE id = 2", "SELECT age FROM p WHERE id = 2",
        "UPDATE p SET id = 3 WHERE id = 2", "SELECT id FROM p ORDER BY id",
        "UPDATE p SET email = 'a@x.com' WHERE id = 3", "UPDATE p SET id = id + 1",
        "SELECT id, email FROM p ORDER BY id"],
    "fk_parses_and_enforces": P + [
        "CREATE TABLE c3 (x INT REFERENCES p (id), FOREIGN KEY (x) REFERENCES p (id))",
        "INSERT INTO c3 VALUES (99)", "INSERT INTO c3 VALUES (1)", "SELECT * FROM c3"],
    "fk_insert_ok_and_violation": PARENT + [
        "CREATE TABLE child (cid INT, pid INT REFERENCES parent (id))",
        "INSERT INTO child VALUES (10, 1), (11, NULL)", "SELECT count(*) FROM child",
        "INSERT INTO child VALUES (12, 99)", "SELECT count(*) FROM child"],
    "fk_delete_blocked_then_allowed": PARENT + [
        "CREATE TABLE child (cid INT, pid INT REFERENCES parent (id))",
        "INSERT INTO child VALUES (10, 1)", "DELETE FROM parent WHERE id = 1",
        "DELETE FROM parent WHERE id = 2", "DELETE FROM child WHERE pid = 1",
        "DELETE FROM parent WHERE id = 1", "SELECT count(*) FROM parent"],
    "fk_table_level_defaults_to_parent_pk": PARENT + [
        "CREATE TABLE c2 (x INT, y INT, FOREIGN KEY (y) REFERENCES parent)",
        "INSERT INTO c2 VALUES (1, 1)", "INSERT INTO c2 VALUES (1, 42)",
        "SELECT * FROM c2"],
    "fk_update_of_child": PARENT + [
        "CREATE TABLE child (cid INT, pid INT REFERENCES parent (id))",
        "INSERT INTO child VALUES (10, 1)", "UPDATE child SET pid = 2",
        "SELECT * FROM child"],
    "on_conflict_upsert": [
        "CREATE TABLE t (id INT PRIMARY KEY, v INT, s VARCHAR)",
        "INSERT INTO t VALUES (1, 10, 'a')",
        "INSERT INTO t VALUES (1, 99, 'z') ON CONFLICT DO NOTHING",
        "SELECT * FROM t",
        "INSERT INTO t VALUES (1, 99, 'z'), (2, 5, 'b') ON CONFLICT DO UPDATE SET v = excluded.v",
        "SELECT * FROM t ORDER BY id",
        "INSERT OR REPLACE INTO t VALUES (2, 77, 'B')",
        "SELECT * FROM t ORDER BY id",
        "INSERT OR IGNORE INTO t VALUES (2, 0, 'x'), (3, 1, 'c')",
        "SELECT count(*) FROM t",
        "INSERT INTO t VALUES (3, 0, 'k') ON CONFLICT (id) DO UPDATE SET s = 'fixed'",
        "SELECT * FROM t ORDER BY id",
        "INSERT INTO t VALUES (4, 1, 'd'), (4, 2, 'e') ON CONFLICT DO NOTHING",
        "SELECT * FROM t ORDER BY id",
        "INSERT INTO t SELECT range + 1, range * 100, 'r' FROM range(6) "
        "ON CONFLICT DO UPDATE SET v = excluded.v",
        "SELECT * FROM t ORDER BY id",
    ],
    "unique_index_after_rollback": [
        "CREATE TABLE t (a INT PRIMARY KEY)", "INSERT INTO t VALUES (1), (2)",
        "INSERT INTO t VALUES (3)", "BEGIN", "INSERT INTO t VALUES (4)", "ROLLBACK",
        "INSERT INTO t VALUES (4)", "INSERT INTO t VALUES (2)", "SELECT count(*) FROM t"],
}


# D10: DuckDB's Count of an upsert adds the rows it updated to the rows it
# appended (PhysicalInsert); the JAX package counts the appended rows only
DUCKDB_COUNTS = {
    "on_conflict_upsert": {
        "INSERT INTO t VALUES (1, 99, 'z'), (2, 5, 'b') ON CONFLICT DO UPDATE SET v = excluded.v":
            [(2,)],
        "INSERT OR REPLACE INTO t VALUES (2, 77, 'B')": [(1,)],
        "INSERT INTO t VALUES (3, 0, 'k') ON CONFLICT (id) DO UPDATE SET s = 'fixed'": [(1,)],
        "INSERT INTO t SELECT range + 1, range * 100, 'r' FROM range(6) "
        "ON CONFLICT DO UPDATE SET v = excluded.v": [(6,)],
    },
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_script_matches_jax(name):
    run_both(SCRIPTS[name], duckdb=DUCKDB_COUNTS.get(name))


def test_violations_raise_constraint_exception():
    """DuckDB's class; the JAX package's ConnectionException is a base."""
    con = duckdb_tpu_torch.connect(device="cpu")
    for sql in P:
        con.sql(sql)
    for sql, frag in [("INSERT INTO p VALUES (1,'b',1,'b@x')", "PRIMARY KEY"),
                      ("INSERT INTO p VALUES (2, NULL, 1, 'b@x')", "NOT NULL"),
                      ("INSERT INTO p VALUES (2,'b',-5,'b@x')", "CHECK"),
                      ("INSERT INTO p VALUES (2,'b',1,'a@x.com')", "UNIQUE")]:
        with pytest.raises(ConstraintException, match=f"Constraint Error: .*{frag}") as info:
            con.sql(sql)
        assert isinstance(info.value, ConnectionException)


def test_fk_update_of_child_held_to_duckdb():
    """D4: the JAX package lets UPDATE point a child row at a key its
    parent lacks; DuckDB (and the port) check the new key."""
    jcon = duckdb_tpu.connect()
    tcon = duckdb_tpu_torch.connect(device="cpu")
    for con in (jcon, tcon):
        for sql in PARENT + ["CREATE TABLE child (cid INT, pid INT REFERENCES parent (id))",
                             "INSERT INTO child VALUES (10, 1)"]:
            con.sql(sql)
    assert jcon.sql("UPDATE child SET pid = 7").rows() == [(1,)]
    with pytest.raises(ConstraintException, match='key "7" does not exist'):
        tcon.sql("UPDATE child SET pid = 7")
    assert tcon.sql("SELECT * FROM child").rows() == [(10, 1)]


def test_unique_index_advances_in_place():
    """The unique-key index must advance across appends (checks in O(new
    rows)) and outlive each statement's publish; after a ROLLBACK its
    version is stale and the next insert rebuilds it."""
    con = duckdb_tpu_torch.connect(device="cpu")
    con.sql("CREATE TABLE t (a INT PRIMARY KEY)")
    con.sql("INSERT INTO t VALUES (1), (2)")
    con.sql("INSERT INTO t VALUES (3)")
    entry = con.catalog.get_table("t")
    assert entry.key_set(["a"]) == {1, 2, 3}
    con.sql("BEGIN")
    con.sql("INSERT INTO t VALUES (4)")
    con.sql("ROLLBACK")
    # the rolled-back clone advanced the shared index past this version
    assert entry._key_sets[("a",)][0] != entry.version and entry.key_set(["a"]) is None
    con.sql("INSERT INTO t VALUES (4)")
    with pytest.raises(ConstraintException, match="PRIMARY KEY"):
        con.sql("INSERT INTO t VALUES (2)")
    assert con.sql("SELECT count(*) FROM t").rows() == [(4,)]


def test_on_conflict_counts_appended_rows():
    """D10: an upsert's Count is the rows it appended plus the rows it
    updated, as DuckDB's PhysicalInsert counts them; the JAX package
    counts the appended rows only. DO NOTHING counts the appended rows."""
    upsert = ("INSERT INTO t SELECT range, 1 FROM range(990, 1010) "
              "ON CONFLICT DO UPDATE SET v = excluded.v")
    jcon = duckdb_tpu.connect()
    con = duckdb_tpu_torch.connect(device="cpu")
    for c in (jcon, con):
        c.sql("CREATE TABLE t (id INT PRIMARY KEY, v INT)")
        c.sql("INSERT INTO t SELECT range, 0 FROM range(1000)")
    assert jcon.sql(upsert).rows() == [(10,)]
    assert con.sql(upsert).rows() == [(20,)]
    assert con.sql("SELECT count(*), sum(v) FROM t").rows() == \
        jcon.sql("SELECT count(*), sum(v) FROM t").rows() == [(1010, 20)]
    assert con.sql("INSERT INTO t SELECT range, 2 FROM range(1005, 1015) "
                   "ON CONFLICT DO NOTHING").rows() == [(5,)]


FK_PAIR = ["CREATE TABLE par (id INTEGER PRIMARY KEY)",
           "CREATE TABLE chi (pid INTEGER REFERENCES par (id))",
           "INSERT INTO par VALUES (1), (2)", "INSERT INTO chi VALUES (1)"]

# F5 and F6 (ROADMAP Queue 3): DuckDB raises where the JAX package runs the
# statement, and then the tables are as they were
DUCKDB_FK = {
    "f5_update_of_referenced_key": (FK_PAIR + [
        "UPDATE par SET id = 3 WHERE id = 1", "SELECT * FROM par ORDER BY id",
        "SELECT c.pid, p.id FROM chi c LEFT JOIN par p ON c.pid = p.id",
        "UPDATE par SET id = 4 WHERE id = 2", "UPDATE par SET id = id WHERE id = 1",
        "SELECT id FROM par ORDER BY id"], {
        "UPDATE par SET id = 3 WHERE id = 1": ConstraintException,
        "SELECT * FROM par ORDER BY id": [(1,), (2,)],
        "UPDATE par SET id = id WHERE id = 1": [(1,)],
        "SELECT id FROM par ORDER BY id": [(1,), (4,)],
        "SELECT c.pid, p.id FROM chi c LEFT JOIN par p ON c.pid = p.id": [(1, 1)]}),
    "f6_drop_of_referenced_table": (FK_PAIR + [
        "DROP TABLE par", "SELECT * FROM par ORDER BY id", "SELECT * FROM chi",
        "DROP TABLE chi", "DROP TABLE par", "SELECT count(*) FROM duckdb_tables()"], {
        "DROP TABLE par": ConnectionException,
        "SELECT * FROM par ORDER BY id": [(1,), (2,)]}),
}


@pytest.mark.parametrize("name", sorted(DUCKDB_FK))
def test_fk_parent_held_to_duckdb(name):
    """F5: an UPDATE that changes a parent key a child row still references
    raises ConstraintException, and one that leaves it (or changes an
    unreferenced key) succeeds; F6: DROP TABLE of the parent raises
    DuckDB's Catalog Error until the child is dropped. The JAX package runs
    both statements (asserted by run_both)."""
    script, duckdb = DUCKDB_FK[name]
    if name.startswith("f6"):
        # after the refused DROP the tables differ: DuckDB's second DROP
        # TABLE par (after chi's) succeeds in both
        jcon, tcon = run_both(script[:7], duckdb=duckdb)
        for sql in script[7:]:
            tcon.sql(sql)
        assert tcon.sql("SELECT count(*) FROM duckdb_tables()").rows() == [(0,)]
        return
    run_both(script, duckdb=duckdb)


def test_f5_message_and_rows():
    con = duckdb_tpu_torch.connect(device="cpu")
    for sql in FK_PAIR:
        con.sql(sql)
    with pytest.raises(ConstraintException, match='key "1" is still referenced'):
        con.sql("UPDATE par SET id = 3 WHERE id = 1")
    assert con.sql("SELECT * FROM par ORDER BY id").rows() == [(1,), (2,)]
    assert con.sql("SELECT * FROM chi").rows() == [(1,)]
    with pytest.raises(ConnectionException, match='main key table of the table "chi"'):
        con.sql("DROP TABLE par")
