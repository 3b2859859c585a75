"""Transactions of duckdb_tpu_torch (device="cpu") against the JAX package.

The counterparts of tests/test_mvcc.py: two cursors of one database run
the same interleaved statements in both packages, and every statement's
rows, Count and exception class agree (tests/_torch_parity.py): no dirty
reads, snapshot reads, read-your-writes, first committer wins at table
granularity (write-write, create-create, drop against a write), disjoint
tables commit, a failed statement leaves nothing. Then the port's own
points: table versions unique across the process (two cursors writing
one table in turn never alias a cached join build), a failed statement
inside BEGIN rolled back alone, the snapshot reading the database's
settings, sequences and views published at COMMIT and dropped at
ROLLBACK. The cases that reopen a database file wait for ROADMAP item 33.
"""

import os
import sys

import pytest
import torch

import duckdb_tpu
import duckdb_tpu_torch
from duckdb_tpu_torch.api.connection import TransactionException

sys.path.insert(0, os.path.dirname(__file__))
from _torch_parity import outcome, same  # noqa: E402

torch.set_num_threads(1)

SETUP = ["CREATE TABLE t (a INT, b VARCHAR)", "INSERT INTO t VALUES (1,'x'),(2,'y')"]

# (cursor 0 or 1, statement)
SCENARIOS = {
    "cursor_shares_database": [
        (1, "SELECT count(*) FROM t"), (1, "INSERT INTO t VALUES (3,'z')"),
        (0, "SELECT count(*) FROM t")],
    "uncommitted_writes_invisible": [
        (0, "BEGIN"), (0, "INSERT INTO t VALUES (3,'z')"),
        (0, "UPDATE t SET b = 'dirty' WHERE a = 1"), (0, "SELECT count(*) FROM t"),
        (1, "SELECT count(*) FROM t"), (1, "SELECT b FROM t WHERE a = 1"), (0, "COMMIT"),
        (1, "SELECT count(*) FROM t"), (1, "SELECT b FROM t WHERE a = 1")],
    "snapshot_reads": [
        (1, "BEGIN"), (1, "SELECT count(*) FROM t"), (0, "INSERT INTO t VALUES (3,'z')"),
        (0, "SELECT count(*) FROM t"), (1, "SELECT count(*) FROM t"), (1, "COMMIT"),
        (1, "SELECT count(*) FROM t")],
    "write_write_conflict": [
        (0, "BEGIN"), (1, "BEGIN"), (0, "UPDATE t SET b = 'first' WHERE a = 1"),
        (1, "UPDATE t SET b = 'second' WHERE a = 2"), (0, "COMMIT"), (1, "COMMIT"),
        (0, "SELECT a, b FROM t ORDER BY a"), (1, "UPDATE t SET b = 'retry' WHERE a = 2"),
        (0, "SELECT b FROM t WHERE a = 2")],
    "disjoint_tables": [
        (0, "CREATE TABLE u (x INT)"), (0, "BEGIN"), (1, "BEGIN"),
        (0, "INSERT INTO t VALUES (3,'z')"), (1, "INSERT INTO u VALUES (42)"), (0, "COMMIT"),
        (1, "COMMIT"), (0, "SELECT count(*) FROM t"), (0, "SELECT x FROM u")],
    "create_create_conflict": [
        (0, "BEGIN"), (1, "BEGIN"), (0, "CREATE TABLE fresh (a INT)"),
        (1, "CREATE TABLE fresh (a INT)"), (0, "COMMIT"), (1, "COMMIT"),
        (1, "SELECT count(*) FROM fresh")],
    "drop_vs_write_conflict": [
        (0, "BEGIN"), (1, "BEGIN"), (0, "DROP TABLE t"), (1, "INSERT INTO t VALUES (3,'z')"),
        (0, "COMMIT"), (1, "COMMIT"), (1, "SELECT * FROM t")],
    "read_your_writes": [
        (0, "BEGIN"), (0, "INSERT INTO t VALUES (3,'z')"),
        (0, "UPDATE t SET b = 'w' WHERE a = 3"), (0, "SELECT b FROM t WHERE a = 3"),
        (0, "ROLLBACK"), (0, "SELECT count(*) FROM t")],
    "failed_statement_is_atomic": [
        (0, "CREATE TABLE pk (a INT PRIMARY KEY)"), (0, "INSERT INTO pk VALUES (1)"),
        (0, "INSERT INTO pk VALUES (2), (2)"), (0, "SELECT count(*) FROM pk")],
    "implicit_and_explicit_interleave": [
        (1, "BEGIN"), (1, "UPDATE t SET b = 'txn' WHERE a = 1"),
        (0, "UPDATE t SET b = 'auto' WHERE a = 2"), (1, "COMMIT"),
        (0, "SELECT b FROM t ORDER BY a")],
    "delete_rollback": [
        (0, "BEGIN"), (0, "DELETE FROM t WHERE a = 1"), (0, "SELECT count(*) FROM t"),
        (1, "SELECT count(*) FROM t"), (0, "ROLLBACK"), (0, "SELECT * FROM t ORDER BY a")],
    "ddl_in_a_transaction": [
        (0, "BEGIN"), (0, "CREATE VIEW v AS SELECT a FROM t"), (0, "SELECT count(*) FROM v"),
        (1, "SELECT count(*) FROM v"), (0, "CREATE TABLE w (x INT)"), (0, "ROLLBACK"),
        (0, "SELECT count(*) FROM v"), (0, "SELECT count(*) FROM w"), (0, "BEGIN"),
        (0, "CREATE VIEW v AS SELECT a FROM t"), (0, "COMMIT"), (1, "SELECT count(*) FROM v")],
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax(name):
    j0 = duckdb_tpu.connect()
    t0 = duckdb_tpu_torch.connect(device="cpu")
    for sql in SETUP:
        same(sql, outcome(j0, sql), outcome(t0, sql))
    jcons, tcons = (j0, j0.cursor()), (t0, t0.cursor())
    for who, sql in SCENARIOS[name]:
        same(sql, outcome(jcons[who], sql), outcome(tcons[who], sql))


def test_conflict_raises_transaction_exception():
    con = duckdb_tpu_torch.connect(device="cpu")
    for sql in SETUP:
        con.sql(sql)
    c2 = con.cursor()
    con.sql("BEGIN")
    c2.sql("BEGIN")
    con.sql("UPDATE t SET b = 'first' WHERE a = 1")
    c2.sql("UPDATE t SET b = 'second' WHERE a = 2")
    con.sql("COMMIT")
    with pytest.raises(TransactionException, match="conflict"):
        c2.sql("COMMIT")
    assert c2._txn is None  # rolled back; the cursor is usable again


def test_versions_stay_unique_across_cursors():
    """Clones carry their table's version: two cursors that each write a
    clone in turn must not reach one version, or a join build cached on a
    warm plan (keyed by table, rows and version) answers for the other's
    data. Two cursors update one table in turn, then both SELECT."""
    c1 = duckdb_tpu_torch.connect(device="cpu")
    c2 = c1.cursor()
    c1.sql("CREATE TABLE dim (k BIGINT, v BIGINT)")
    c1.sql("INSERT INTO dim SELECT range, range * 10 FROM range(100)")
    c1.sql("CREATE TABLE fact (fk BIGINT)")
    c1.sql("INSERT INTO fact SELECT range % 100 FROM range(1000)")
    q = "SELECT sum(v) FROM fact JOIN dim ON fk = k"
    base = c1.sql(q).rows()[0][0]
    assert c2.sql(q).rows()[0][0] == base
    versions = set()
    c1.sql("BEGIN")
    c1.sql("UPDATE dim SET v = v + 1 WHERE k = 5")
    versions.add(c1.catalog.get_table("dim").version)
    c1.sql("COMMIT")
    c2.sql("BEGIN")
    c2.sql("UPDATE dim SET v = v + 2 WHERE k = 6")
    versions.add(c2.catalog.get_table("dim").version)
    c2.sql("COMMIT")
    assert len(versions) == 2
    want = base + 10 * 1 + 10 * 2
    assert c1.sql(q).rows()[0][0] == want and c2.sql(q).rows()[0][0] == want


def test_failed_statement_inside_a_transaction_is_rolled_back_alone():
    con = duckdb_tpu_torch.connect(device="cpu")
    con.sql("CREATE TABLE t (a INT CHECK (a > 0), b INT)")
    con.sql("BEGIN")
    con.sql("INSERT INTO t VALUES (1, 1)")
    with pytest.raises(Exception, match="CHECK"):
        con.sql("INSERT INTO t VALUES (2, 2), (-1, 3)")
    with pytest.raises(Exception, match="does not exist"):
        con.sql("UPDATE t SET nope = 1")
    con.sql("INSERT INTO t VALUES (5, 5)")
    assert con.sql("SELECT * FROM t ORDER BY a").rows() == [(1, 1), (5, 5)]
    con.sql("COMMIT")
    assert con.sql("SELECT count(*) FROM t").rows() == [(2,)]


def test_snapshot_reads_the_database_settings():
    """A transaction's catalog carries the settings: SET num_shards inside
    BEGIN reaches the executor, and the cursor sees the same settings."""
    con = duckdb_tpu_torch.connect(device="cpu")
    con.sql("CREATE TABLE t (g INT, v BIGINT)")
    con.sql("INSERT INTO t SELECT range % 4, range FROM range(40000)")
    con.sql("BEGIN")
    assert con.catalog is not con._db.catalog
    assert con.catalog.settings is con.settings is con.cursor().settings
    con.sql("SET num_shards = 4")
    con.routes.clear()
    assert con.sql("SELECT g, sum(v) FROM t GROUP BY g ORDER BY g").rows() == [
        (g, sum(range(g, 40000, 4))) for g in range(4)]
    assert con.routes["sharded_agg"] == 1
    con.sql("ROLLBACK")
    con.sql("RESET num_shards")


def test_sequences_publish_at_commit():
    """D9: CREATE SEQUENCE is published at COMMIT and dropped at ROLLBACK,
    but a sequence's counter is not transactional, as in DuckDB: nextval
    inside BEGIN advances it for every connection at once, and ROLLBACK
    gives no value back. The JAX package puts its snapshot's counter back
    at ROLLBACK and COMMIT, so nextval hands one value out twice."""
    jcon = duckdb_tpu.connect()
    jcon.sql("CREATE SEQUENCE s")
    jcon.sql("BEGIN")
    jcon.sql("SELECT nextval('s')")
    jcon.sql("ROLLBACK")
    assert jcon.sql("SELECT nextval('s')").rows() == [(1,)]  # 1 again
    con = duckdb_tpu_torch.connect(device="cpu")
    c2 = con.cursor()
    con.sql("CREATE SEQUENCE s")
    con.sql("BEGIN")
    assert con.sql("SELECT nextval('s')").rows() == [(1,)]
    assert c2.sql("SELECT nextval('s')").rows() == [(2,)]
    con.sql("ROLLBACK")
    assert con.sql("SELECT nextval('s')").rows() == [(3,)]
    con.sql("BEGIN")
    con.sql("CREATE SEQUENCE s2")
    assert con.sql("SELECT nextval('s2')").rows() == [(1,)]
    with pytest.raises(ValueError, match="does not exist"):
        c2.sql("SELECT nextval('s2')")
    con.sql("ROLLBACK")
    with pytest.raises(ValueError, match="does not exist"):
        con.sql("SELECT nextval('s2')")
    con.sql("BEGIN")
    con.sql("CREATE SEQUENCE s2")
    con.sql("COMMIT")
    assert c2.sql("SELECT nextval('s2'), currval('s')").rows() == [(1, 3)]


def test_multi_statement_text_runs_in_order():
    con = duckdb_tpu_torch.connect(device="cpu")
    res = con.sql("CREATE TABLE t (a INT); INSERT INTO t VALUES (1), (2); BEGIN; "
                  "INSERT INTO t VALUES (3); SELECT count(*) FROM t")
    assert res.rows() == [(3,)] and con._txn is not None
    con.sql("ROLLBACK")
    assert con.sql("SELECT count(*) FROM t").rows() == [(2,)]


CACHED = {
    # an uncorrelated scalar subquery: its value is kept on the plan
    "scalar_subquery": "SELECT count(*) FROM t WHERE a > (SELECT avg(a) FROM t)",
    # a CTE referenced twice is materialized into a table the plan owns
    "materialized_cte": "WITH m AS (SELECT max(a) AS mx FROM t) "
                        "SELECT (SELECT mx FROM m), (SELECT mx FROM m) + 1",
}


@pytest.mark.parametrize("name", sorted(CACHED))
def test_cached_plan_sees_another_cursors_commit(name):
    """D8: a cursor's warm plan keeps what its tables held when it was made.
    After another cursor commits an UPDATE, the same text must read the new
    rows, as DuckDB's does (here: what a fresh cursor answers). The JAX
    package's cache is cleared only by its own connection's statements, so
    it answers from the old rows."""
    q = CACHED[name]
    answers = []
    for con in (duckdb_tpu.connect(), duckdb_tpu_torch.connect(device="cpu")):
        c2 = con.cursor()
        con.sql("CREATE TABLE t (a INT)")
        con.sql("INSERT INTO t SELECT range FROM range(10)")
        before = c2.sql(q).rows()
        assert c2.sql(q).rows() == before
        con.sql("UPDATE t SET a = a * 10 WHERE a >= 8")
        answers.append((before, c2.sql(q).rows(), con.cursor().sql(q).rows()))
    (jbefore, jafter, jfresh), (tbefore, tafter, tfresh) = answers
    assert jbefore == tbefore and jfresh == tfresh != tbefore
    assert jafter == jbefore  # the JAX package's stale answer
    assert tafter == tfresh
    # inside BEGIN the cursor keeps reading its snapshot, cached or not
    con = duckdb_tpu_torch.connect(device="cpu")
    c2 = con.cursor()
    con.sql("CREATE TABLE t (a INT)")
    con.sql("INSERT INTO t SELECT range FROM range(10)")
    c2.sql("BEGIN")
    snap = c2.sql(q).rows()
    con.sql("UPDATE t SET a = a * 10 WHERE a >= 8")
    assert c2.sql(q).rows() == snap
    c2.sql("COMMIT")
    assert c2.sql(q).rows() == con.sql(q).rows() != snap


def test_commit_keeps_what_other_cursors_committed():
    """D9: COMMIT merges the catalog's objects key by key against what the
    transaction saw at BEGIN, so a macro, schema, type, index, comment,
    view and sequence that another cursor committed meanwhile stay, and
    what this transaction dropped goes. The JAX package puts its whole
    snapshot back: even a read-only COMMIT deletes them."""
    ddl = ["CREATE MACRO m1(x) AS x + 1", "CREATE SCHEMA s1", "CREATE TYPE e1 AS ENUM ('a')",
           "CREATE TABLE t (a INT)", "CREATE INDEX i1 ON t (a)",
           "COMMENT ON TABLE t IS 'kept'", "CREATE VIEW v1 AS SELECT 1 AS one",
           "CREATE SEQUENCE sq"]
    probes = ["SELECT m1(1)", "CREATE TABLE s1.x (a INT)", "SELECT 'a'::e1",
              "SELECT count(*) FROM duckdb_indexes() WHERE index_name = 'i1'",
              "SELECT comment FROM duckdb_tables() WHERE name = 't'",
              "SELECT one FROM v1", "SELECT nextval('sq')"]
    jcon = duckdb_tpu.connect()
    jc2 = jcon.cursor()
    jcon.sql("CREATE MACRO gone(x) AS x")
    jcon.sql("BEGIN")
    jc2.sql("CREATE MACRO m1(x) AS x + 1")
    jcon.sql("COMMIT")
    with pytest.raises(Exception):
        jc2.sql("SELECT m1(1)")  # the JAX package lost it
    con = duckdb_tpu_torch.connect(device="cpu")
    c2 = con.cursor()
    con.sql("CREATE MACRO gone(x) AS x")
    con.sql("CREATE SCHEMA s_gone")
    con.sql("BEGIN")
    for sql in ddl:
        c2.sql(sql)
    con.sql("DROP MACRO gone")
    con.sql("DROP SCHEMA s_gone")
    con.sql("COMMIT")
    got = [c2.sql(p) for p in probes]
    assert [r.rows() for r in got if r is not None] == [
        [(2,)], [("a",)], [(1,)], [("kept",)], [(1,)], [(1,)]]
    for sql in ("SELECT gone(1)", "CREATE TABLE s_gone.y (a INT)"):
        with pytest.raises(Exception):
            c2.sql(sql)
    con.sql("BEGIN")
    con.sql("SELECT 1")
    c2.sql("DROP MACRO m1")
    con.sql("COMMIT")  # read-only: changes nothing
    with pytest.raises(Exception):
        c2.sql("SELECT m1(1)")
    assert con.sql("SELECT one FROM v1").rows() == [(1,)]


def test_sequence_values_survive_a_failed_statement():
    """D9: a statement that fails leaves no row behind, but the values its
    nextval handed out stay used, as in DuckDB."""
    con = duckdb_tpu_torch.connect(device="cpu")
    con.sql("CREATE SEQUENCE sq")
    con.sql("CREATE TABLE t (id BIGINT DEFAULT nextval('sq'), v INT CHECK (v > 0))")
    con.sql("INSERT INTO t (v) VALUES (1), (2)")
    with pytest.raises(Exception, match="CHECK"):
        con.sql("INSERT INTO t (v) VALUES (3), (-1)")
    con.sql("INSERT INTO t (v) VALUES (4)")
    assert con.sql("SELECT id, v FROM t ORDER BY id").rows() == [(1, 1), (2, 2), (5, 4)]


def test_a_write_clones_only_the_table_it_writes():
    """A transaction's snapshot holds the published tables by reference;
    a statement that writes one clones that one alone, inside BEGIN and
    in the transaction of its own that a statement outside BEGIN runs in."""
    con = duckdb_tpu_torch.connect(device="cpu")
    for name in ("a", "b", "c"):
        con.sql(f"CREATE TABLE {name} (x INT)")
        con.sql(f"INSERT INTO {name} VALUES (1)")
    published = dict(con._db.catalog.tables)
    con.sql("BEGIN")
    con.sql("UPDATE a SET x = 2")
    snap = con.catalog.tables
    assert snap["a"] is not published["a"]
    assert snap["b"] is published["b"] and snap["c"] is published["c"]
    con.sql("UPDATE a SET x = 3")
    con.sql("INSERT INTO b VALUES (5)")
    assert con.catalog.tables["c"] is published["c"]
    con.sql("COMMIT")
    now = con._db.catalog.tables
    assert now["c"] is published["c"] and now["a"] is not published["a"]
    con.sql("INSERT INTO c VALUES (7)")
    assert con._db.catalog.tables["a"] is now["a"] and con._db.catalog.tables["b"] is now["b"]
    assert con.sql("SELECT (SELECT sum(x) FROM a), (SELECT sum(x) FROM b), "
                   "(SELECT sum(x) FROM c)").rows() == [(3, 6, 8)]
