"""DDL and DML of duckdb_tpu_torch (device="cpu") against the JAX package.

Each script runs statement by statement through `duckdb_tpu.connect()`
and `duckdb_tpu_torch.connect(device="cpu")`; after every statement the
rows, the DML Count and the exception class must agree
(tests/_torch_parity.py). The scripts are the counterparts of
tests/test_ddl_dml_features.py, tests/test_ddl_ext.py (its cases outside
ALTER) and the view, macro and schema cases of the JAX package's tests.
Where the JAX package is wrong the port is held to DuckDB's answer
(ROADMAP Queue 3): D1, a DECIMAL UPDATE by a product of two scales; D2
and D3, INSERT column errors; D6 and D7, LIST and STRUCT columns.

Then the points where the port's storage could go wrong: an int64 column
narrowed to int32 on the device and widened past 2^31 by UPDATE or
INSERT, a VARCHAR INSERT that must build a new dictionary, the distinct
count of CREATE TABLE … AS SELECT and of a DELETE, the device pool's
count of a column clones share, a dropped table's bytes, the chunked and
sharded routes reading an edited table, and TPC-H Q1 and an INSERT …
SELECT … GROUP BY reaching the grouped-sum kernel on an edited table.
Statements of later items say so, naming the item.
"""

import os
import sys

import numpy as np
import pytest
import torch

import duckdb_tpu
import duckdb_tpu_torch
from duckdb_tpu_torch.catalog import catalog as C
from duckdb_tpu_torch.ops import grouped as grouped_mod
from duckdb_tpu_torch.ops import strings as dstr
from duckdb_tpu_torch.testing.tpch_gen import write_tables

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from _torch_parity import connect_both, outcome, run_both, same  # noqa: E402
import chip_smoke  # noqa: E402  (Q1's text and its numpy answer)

torch.set_num_threads(1)

SCRIPTS = {
    "basic": [
        "CREATE TABLE t (a INT, b VARCHAR)",
        "INSERT INTO t VALUES (1,'x'),(2,'y')",
        "SELECT * FROM t ORDER BY a",
        "UPDATE t SET b = 'dirty' WHERE a = 1",
        "SELECT a, b FROM t ORDER BY a",
        "DELETE FROM t WHERE a = 9",
        "INSERT INTO t VALUES (3, NULL)",
        "UPDATE t SET a = a + 10",
        "SELECT * FROM t ORDER BY a",
        "DELETE FROM t",
        "SELECT count(*) FROM t",
    ],
    "catalog_errors": [
        "CREATE TABLE t (x INT)",
        "CREATE TABLE t (x INT)",
        "CREATE TABLE IF NOT EXISTS t (x INT)",
        "DROP TABLE nope",
        "DROP TABLE IF EXISTS nope",
        "INSERT INTO nope VALUES (1)",
        "SELECT * FROM t",
    ],
    "types": [
        "CREATE TABLE t (i INT, d DECIMAL(10,2), dt DATE, ts TIMESTAMP, f DOUBLE, s VARCHAR, "
        "b BOOLEAN, big BIGINT)",
        "INSERT INTO t VALUES (1, 1.25, '2024-01-02', '2024-01-02 03:04:05', 1.5, 'a', true, "
        "5000000000)",
        "INSERT INTO t VALUES (2, 3, DATE '2020-02-29', TIMESTAMP '2020-02-29 00:00:00', 2, 'b', "
        "false, -1), (NULL, NULL, NULL, NULL, NULL, NULL, NULL, NULL)",
        "SELECT * FROM t ORDER BY i NULLS LAST",
        "INSERT INTO t SELECT i + 10, d * 2, dt + 1, ts, f / 3, s || 'z', NOT b, big * 2 "
        "FROM t WHERE i IS NOT NULL",
        "SELECT * FROM t ORDER BY i NULLS LAST",
        "UPDATE t SET d = d + 0.01, s = upper(s) WHERE i > 10",
        "UPDATE t SET f = NULL WHERE s = 'a'",
        "SELECT i, d, s, f FROM t ORDER BY i NULLS LAST",
        "DELETE FROM t WHERE i IN (SELECT i FROM t WHERE i > 11)",
        "UPDATE t SET big = (SELECT max(big) FROM t) WHERE i = 1",
        "SELECT i, big FROM t ORDER BY i NULLS LAST",
        "DELETE FROM t WHERE i IS NULL",
        "SELECT count(*), sum(d), min(dt), max(s) FROM t",
    ],
    "more_types": [
        "CREATE TABLE b (k INT, f BOOLEAN, d DATE, t TIME, h HUGEINT, r REAL, si SMALLINT, "
        "ts TIMESTAMP, iv INTERVAL, bl BLOB)",
        "INSERT INTO b VALUES (1, true, '2020-01-01', '12:34:56', 12345678901234, 1.5, 7, "
        "'2021-03-04 05:06:07', INTERVAL 3 DAY, 'ab')",
        "INSERT INTO b VALUES (2, NULL, NULL, NULL, NULL, NULL, NULL, NULL, NULL, NULL)",
        "UPDATE b SET d = d + INTERVAL 1 DAY, f = NOT f, si = si * 2, t = t + INTERVAL 1 HOUR, "
        "ts = ts + INTERVAL 1 MINUTE WHERE k = 1",
        "SELECT * FROM b ORDER BY k",
        "INSERT INTO b SELECT k + 2, f, d, t, h * 2, r, si, ts, iv, bl FROM b",
        "SELECT k, h, iv, bl FROM b ORDER BY k",
        "INSERT INTO b (k, h) VALUES (9, 170141183460469231731687303715884105727)",
    ],
    "create_table_as": [
        "CREATE TABLE t (i INT, s VARCHAR, d DECIMAL(10,2))",
        "INSERT INTO t VALUES (1, 'a', 1.5), (2, 'b', 2.5), (3, 'a', NULL)",
        "CREATE TABLE t2 AS SELECT i, s, d FROM t WHERE i < 3",
        "SELECT * FROM t2 ORDER BY i",
        "CREATE TABLE t3 AS SELECT s, count(*) AS n, sum(d) AS sd FROM t GROUP BY s",
        "INSERT INTO t3 SELECT s, n + 1, sd FROM t3",
        "SELECT * FROM t3 ORDER BY s, n",
        "CREATE TABLE t2 AS SELECT 1 AS x",
        "CREATE OR REPLACE TABLE t2 AS SELECT 1 AS x",
        "INSERT INTO t2 VALUES ('5')",
        "INSERT INTO t2 VALUES ('abc')",
        "INSERT INTO t2 SELECT 7 UNION ALL SELECT 8",
        "SELECT * FROM t2 ORDER BY x",
    ],
    "strings": [
        "CREATE TABLE w (k INT, v VARCHAR)",
        "INSERT INTO w SELECT range, CASE WHEN range % 3 = 0 THEN 'fizz' ELSE 'n' || range END "
        "FROM range(30)",
        "SELECT count(*) FROM w WHERE v LIKE 'n%'",
        "UPDATE w SET v = 'buzz' WHERE k % 5 = 0",
        "SELECT v, count(*) FROM w GROUP BY v HAVING count(*) > 1 ORDER BY v",
        "DELETE FROM w WHERE v LIKE '%zz'",
        "SELECT count(*), count(DISTINCT v) FROM w",
        "INSERT INTO w VALUES (100, 'fizz'), (101, 'new')",
        "SELECT count(DISTINCT v) FROM w",
        "SELECT a.k, b.k FROM w a JOIN w b ON a.v = b.v WHERE a.k < b.k ORDER BY 1, 2",
    ],
    "defaults": [
        "CREATE TABLE t(i INT, j INT DEFAULT 42, s VARCHAR DEFAULT 'x')",
        "INSERT INTO t(i) VALUES (1)",
        "SELECT * FROM t",
        "INSERT INTO t DEFAULT VALUES",
        "SELECT count(*) FROM t WHERE j = 42",
        "CREATE SEQUENCE sq",
        "CREATE TABLE t2(id INT DEFAULT nextval('sq'), v INT)",
        "INSERT INTO t2(v) VALUES (10), (20), (30)",
        "SELECT id FROM t2 ORDER BY v",
    ],
    "returning": [
        "CREATE TABLE t3(i INT, j INT DEFAULT 7)",
        "INSERT INTO t3(i) VALUES (1), (2) RETURNING i + j AS k",
        "UPDATE t3 SET j = 100 WHERE i = 2 RETURNING *",
        "DELETE FROM t3 WHERE i = 1 RETURNING i, j",
        "INSERT INTO t3 VALUES (6, 1) RETURNING *",
        "SELECT * FROM t3 ORDER BY i",
    ],
    "using_by_name_from": [
        "CREATE TABLE a(x INT)",
        "INSERT INTO a VALUES (1), (2), (3)",
        "DELETE FROM a USING (VALUES (2), (3)) v(y) WHERE a.x = v.y",
        "SELECT * FROM a",
        "CREATE TABLE b(y INT, z INT)",
        "INSERT INTO b BY NAME (SELECT 4 AS z, 9 AS y)",
        "SELECT y, z FROM b",
        "CREATE TABLE c(v BIGINT)",
        "INSERT INTO c FROM range(3)",
        "SELECT count(*), sum(v) FROM c",
    ],
    "indexes_comments": [
        "CREATE TABLE t(i INT, j INT)",
        "INSERT INTO t VALUES (1, 1), (2, 1)",
        "CREATE INDEX plain ON t(j)",
        "CREATE UNIQUE INDEX u ON t(i)",
        "SELECT index_name, is_unique FROM duckdb_indexes() ORDER BY 1",
        "INSERT INTO t VALUES (1, 5)",
        "DROP INDEX u",
        "INSERT INTO t VALUES (1, 5)",
        "DROP INDEX nope",
        "DROP INDEX IF EXISTS nope",
        "CREATE UNIQUE INDEX u2 ON t(i)",
        "COMMENT ON TABLE t IS 'tbl comment'",
        "COMMENT ON COLUMN t.i IS 'col comment'",
        "SELECT comment FROM duckdb_tables() WHERE name='t'",
        "SELECT comment FROM duckdb_columns() WHERE column_name='i'",
        "COMMENT ON TABLE t IS NULL",
        "SELECT comment FROM duckdb_tables() WHERE name='t'",
    ],
    "prepare_explain_pragma": [
        "CREATE TABLE t(i INT); INSERT INTO t VALUES (1), (2), (3)",
        "PREPARE q AS SELECT count(*) FROM t WHERE i >= ?",
        "EXECUTE q(2)",
        "PREPARE q2 AS SELECT $1 + $2",
        "EXECUTE q2(3, 4)",
        "DEALLOCATE q",
        "EXECUTE q(1)",
        "EXPLAIN SELECT i FROM t WHERE i > 1",
        "PRAGMA show_tables",
        "VACUUM",
        "ANALYZE",
        "TRUNCATE t",
        "SELECT count(*) FROM t",
    ],
    "schemas": [
        "CREATE SCHEMA s1",
        "CREATE SCHEMA s1",
        "CREATE SCHEMA IF NOT EXISTS s1",
        "CREATE TABLE s1.t (a INT)",
        "INSERT INTO s1.t VALUES (1), (2)",
        "SELECT sum(a) FROM s1.t",
        "CREATE TABLE t (a INT)",
        "INSERT INTO t VALUES (10)",
        "SELECT sum(a) FROM main.t",
        "SELECT name, schema_name FROM duckdb_tables() ORDER BY schema_name, name",
        "CREATE TABLE nope.t2 (a INT)",
        "DROP SCHEMA s1",
        "DROP SCHEMA s1 CASCADE",
        "UPDATE t SET a = 11",
        "DELETE FROM main.t WHERE a = 11",
        "SELECT count(*) FROM t",
        "CREATE SCHEMA s2",
        "USE s2",
        "CREATE TABLE u (a INT)",
        "INSERT INTO u VALUES (5)",
        "SELECT * FROM s2.u",
        "USE main",
        "SELECT count(*) FROM u",
        "USE nope",
    ],
    "views": [
        "CREATE TABLE t (a INT, b VARCHAR)",
        "INSERT INTO t VALUES (1, 'x'), (2, 'y')",
        "CREATE VIEW v AS SELECT a * 2 AS d, b FROM t",
        "SELECT * FROM v ORDER BY d",
        "CREATE VIEW v AS SELECT 1",
        "CREATE OR REPLACE VIEW v AS SELECT a FROM t WHERE a > 1",
        "SELECT * FROM v",
        "INSERT INTO t VALUES (3, 'z')",
        "SELECT * FROM v ORDER BY a",
        "SELECT view_name FROM duckdb_views()",
        "SELECT v.a, t.b FROM v JOIN t ON v.a = t.a ORDER BY 1",
        "DROP VIEW v",
        "DROP VIEW v",
        "DROP VIEW IF EXISTS v",
        "SELECT * FROM v",
        "CREATE TEMPORARY VIEW tv AS SELECT b FROM t",
        "SELECT * FROM tv ORDER BY b",
    ],
    "macros": [
        "CREATE TABLE t (x INT, y INT)",
        "INSERT INTO t VALUES (1, 10), (2, 20), (3, 30)",
        "CREATE MACRO add(a, b) AS a + b",
        "SELECT add(1, 2), add(x, y) FROM t ORDER BY x",
        "CREATE MACRO ifelse(a, b, c) AS CASE WHEN a THEN b ELSE c END",
        "SELECT ifelse(1 < 2, 'y', 'n')",
        "CREATE MACRO add_default(a, b := 5) AS a + b",
        "SELECT add_default(37), add_default(37, b := 100)",
        "SELECT add_default(1, c := 2)",
        "CREATE MACRO sumxy() AS sum(x + y)",
        "SELECT sumxy() FROM t",
        "SELECT x, sumxy() FROM t GROUP BY x ORDER BY x",
        "CREATE MACRO twice(v) AS add(v, v)",
        "SELECT twice(x) FROM t ORDER BY x",
        "CREATE MACRO double_it(v) AS 2 * v",
        "CREATE VIEW dv AS SELECT double_it(x) AS dx FROM t",
        "SELECT max(dx) FROM dv",
        "CREATE MACRO topx(n) AS TABLE SELECT x FROM t ORDER BY x DESC LIMIT n",
        "SELECT * FROM topx(2)",
        "SELECT a.x FROM topx(1) a",
        "CREATE MACRO m(a) AS a + 1",
        "CREATE MACRO m(a) AS a + 2",
        "CREATE OR REPLACE MACRO m(a) AS a + 2",
        "SELECT m(1)",
        "DROP MACRO m",
        "SELECT m(1)",
        "DROP MACRO m",
        "DROP MACRO IF EXISTS m",
        "UPDATE t SET y = add(x, 100) WHERE x = 1",
        "SELECT * FROM t ORDER BY x",
    ],
    "mixed": [
        "CREATE TABLE t (a INT, b VARCHAR, c DOUBLE)",
        "INSERT INTO t (c, a) VALUES (1.5, 1), (2.5, 2)",
        "INSERT INTO t (b, a) SELECT 'k' || range, range + 10 FROM range(3) "
        "ORDER BY range DESC LIMIT 2",
        "SELECT * FROM t ORDER BY a",
        "CREATE MACRO dbl(x) AS x * 2",
        "UPDATE t SET c = dbl(a) WHERE b IS NOT NULL",
        "DELETE FROM t WHERE dbl(a) = 4",
        "SELECT * FROM t ORDER BY a",
        "CREATE VIEW v AS WITH w AS (SELECT a, c FROM t WHERE a > 1) SELECT a, c FROM w",
        "SELECT * FROM v ORDER BY a",
        "CREATE TABLE t2 AS SELECT * FROM v",
        "SELECT * FROM t2 ORDER BY a",
        "INSERT INTO t2 SELECT a * 100, c FROM v WHERE a IN (SELECT a FROM t WHERE b = 'k12')",
        "SELECT * FROM t2 ORDER BY a",
        "UPDATE t SET b = upper(b) || '!' WHERE a IN (SELECT a FROM t2) RETURNING a, b",
        "DELETE FROM t WHERE a NOT IN (SELECT a FROM t2 WHERE a IS NOT NULL) RETURNING *",
        "SELECT * FROM t ORDER BY a",
        "UPDATE t SET a = NULL",
        "SELECT count(a), count(*) FROM t",
        "INSERT INTO t VALUES (now() IS NOT NULL, 'x', random() * 0)",
        "SELECT a, b, c FROM t WHERE b = 'x'",
    ],
    "transaction_blocks": [
        "CREATE TABLE a (id INT PRIMARY KEY, v INT)",
        "CREATE TABLE b (id INT PRIMARY KEY, v INT)",
        "INSERT INTO a VALUES (1, 1), (2, 2)",
        "BEGIN",
        "INSERT INTO a VALUES (3, 3)",
        "INSERT INTO a VALUES (3, 4)",
        "SELECT count(*) FROM a",
        "INSERT INTO b SELECT * FROM a",
        "COMMIT",
        "SELECT * FROM b ORDER BY id",
        "BEGIN",
        "DROP TABLE a",
        "SELECT * FROM a",
        "ROLLBACK",
        "SELECT count(*) FROM a",
        "BEGIN",
        "CREATE TABLE c (x INT)",
        "INSERT INTO c VALUES (1)",
        "CREATE SEQUENCE sq",
        "SELECT nextval('sq')",
        "COMMIT",
        "SELECT * FROM c",
        "SELECT nextval('sq')",
        "EXPLAIN SELECT * FROM a JOIN b ON a.id = b.id",
    ],
    "transactions_errors": [
        "COMMIT",
        "ROLLBACK",
        "BEGIN",
        "BEGIN",
        "COMMIT",
        "BEGIN TRANSACTION",
        "ROLLBACK",
    ],
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_script_matches_jax(name):
    run_both(SCRIPTS[name])


def test_decimal_update_by_product_held_to_duckdb():
    """D1: `SET sal = sal * 1.1` over a DECIMAL(8,2) stores 0.00 in the JAX
    package; DuckDB (and the port) store the product rounded to the
    column's scale."""
    jcon, tcon = connect_both()
    for con in (jcon, tcon):
        con.sql("CREATE TABLE e (id INTEGER, sal DECIMAL(8,2))")
        con.sql("INSERT INTO e VALUES (1, 100.00), (2, 90.50), (3, 70.25)")
        con.sql("UPDATE e SET sal = sal * 1.1 WHERE id < 3")
    import decimal

    assert jcon.sql("SELECT sal FROM e ORDER BY id").rows()[0] == (decimal.Decimal("0.00"),)
    assert tcon.sql("SELECT sal FROM e ORDER BY id").rows() == [
        (decimal.Decimal("110.00"),), (decimal.Decimal("99.55"),), (decimal.Decimal("70.25"),)]


def test_nested_columns_held_to_duckdb():
    """D6: an UPDATE of a LIST column writes another row's list in the JAX
    package; D7: INSERT … SELECT of a STRUCT column stores its field names
    as its values. DuckDB (and the port) keep each row's own value."""
    jcon, tcon = connect_both()
    for con in (jcon, tcon):
        con.sql("CREATE TABLE n (id INT, l INTEGER[], s STRUCT(a INT, b VARCHAR))")
        con.sql("INSERT INTO n VALUES (1, [1, 2], {'a': 1, 'b': 'x'}), (2, NULL, NULL)")
        con.sql("INSERT INTO n SELECT id + 10, l, s FROM n")
        con.sql("UPDATE n SET l = [9] WHERE id = 2")
    q = "SELECT * FROM n ORDER BY id"
    assert jcon.sql(q).rows()[1:3] == [(2, [1, 2], None), (11, [1, 2], {"a": "a", "b": "b"})]
    assert tcon.sql(q).rows() == [(1, [1, 2], {"a": 1, "b": "x"}), (2, [9], None),
                                  (11, [1, 2], {"a": 1, "b": "x"}), (12, None, None)]


def test_insert_column_errors_held_to_duckdb():
    """D2: the JAX package inserts the first value of `VALUES (1, 2, 3)`
    into a one-column table and drops the rest; D3: it raises KeyError for
    a column list naming no column. DuckDB (and the port) raise a Binder
    Error and insert nothing."""
    from duckdb_tpu_torch.planner.bound import BindError

    jcon, tcon = connect_both()
    for con in (jcon, tcon):
        con.sql("CREATE TABLE t (x INT)")
    assert jcon.sql("INSERT INTO t VALUES (1, 2, 3)").rows() == [(1,)]
    with pytest.raises(BindError, match="1 columns but 3 values"):
        tcon.sql("INSERT INTO t VALUES (1, 2, 3)")
    with pytest.raises(BindError, match="1 columns but 2 values"):
        tcon.sql("INSERT INTO t SELECT 1, 2")
    with pytest.raises(KeyError):
        jcon.sql("INSERT INTO t (zz) VALUES (1)")
    with pytest.raises(BindError, match='Column "zz" does not exist'):
        tcon.sql("INSERT INTO t (zz) VALUES (1)")
    assert tcon.sql("SELECT count(*) FROM t").rows() == [(0,)]


def test_update_from_against_sql():
    """UPDATE … FROM (the JAX package's parser has no FROM there): a row
    takes its new value from its match; a row without one keeps its own."""
    tcon = duckdb_tpu_torch.connect(device="cpu")
    tcon.sql("CREATE TABLE t (k INT, v VARCHAR); CREATE TABLE s (k INT, w VARCHAR)")
    tcon.sql("INSERT INTO t VALUES (1, 'a'), (2, 'b'), (3, 'c')")
    tcon.sql("INSERT INTO s VALUES (2, 'B'), (3, 'C'), (4, 'D')")
    assert tcon.sql("UPDATE t SET v = s.w FROM s WHERE t.k = s.k").rows() == [(2,)]
    assert tcon.sql("SELECT * FROM t ORDER BY k").rows() == [(1, "a"), (2, "B"), (3, "C")]


@pytest.mark.parametrize("sql,item", [
    ("MERGE INTO t USING s ON t.a = s.a WHEN MATCHED THEN DELETE", "34b"),
    ("ALTER TABLE t ADD COLUMN c INT", "34b"),
    ("PIVOT t ON a USING sum(a)", "34b"),
    ("IMPORT DATABASE 'x'", "33b"),
    ("COPY t TO 'x.csv'", "33b"),
    ("EXPORT DATABASE 'x'", "33b"),
])
def test_later_statements_name_their_item(sql, item, tmp_path, monkeypatch):
    """The statements that named items 33b and 34b now run: MERGE
    (api/merge.py) returns its Count and deletes the matched row, ALTER
    (api/alter.py) adds the column, PIVOT (api/pivot.py) gives one column
    per value (tests/test_torch_merge.py, test_torch_alter.py and
    test_torch_pivot.py hold them to the JAX package); COPY TO and EXPORT
    (api/files.py) write their files, IMPORT of a directory that is not
    there raises as the JAX package does."""
    monkeypatch.chdir(tmp_path)
    tcon = duckdb_tpu_torch.connect(device="cpu")
    tcon.sql("CREATE TABLE t (a INT); CREATE TABLE s (a INT); INSERT INTO t VALUES (4); "
             "INSERT INTO s VALUES (4)")
    if sql.startswith("MERGE"):
        assert tcon.sql(sql).rows() == [(1,)]
        assert tcon.sql("SELECT count(*) FROM t").rows() == [(0,)]
    elif sql.startswith("ALTER"):
        assert tcon.sql(sql) is None
        assert tcon.sql("SELECT * FROM t").rows() == [(4, None)]
    elif sql.startswith("PIVOT"):
        res = tcon.sql(sql)
        assert res.names == ["4"] and res.rows() == [(4,)]
    elif sql.startswith("IMPORT"):
        with pytest.raises(duckdb_tpu_torch.errors.ConnectionException, match="not found"):
            tcon.sql(sql)
        with pytest.raises(Exception, match="not found"):
            duckdb_tpu.connect().sql(sql)
    else:
        assert tcon.sql(sql) is None
        if sql.startswith("COPY"):
            assert (tmp_path / "x.csv").read_text().split() == ["a", "4"]
        else:
            assert sorted(os.listdir(tmp_path / "x")) == ["load.sql", "s.csv", "schema.sql",
                                                          "t.csv"]


def test_file_database_names_item_33(tmp_path):
    """File databases came with item 33 (tests/test_torch_storage.py), the
    file readers with 33b: COPY FROM into a file database is durable by a
    checkpoint, so the rows survive the file."""
    src = tmp_path / "x.csv"
    src.write_text("a\n1\n2\n")
    con = duckdb_tpu_torch.connect(str(tmp_path / "db"), device="cpu")
    con.sql("CREATE TABLE t (a INT)")
    assert os.path.isdir(str(tmp_path / "db"))
    assert con.sql(f"COPY t FROM '{src}'").rows() == [(2,)]
    con.close()
    os.remove(src)
    con = duckdb_tpu_torch.connect(str(tmp_path / "db"), device="cpu")
    assert con.sql("SELECT sum(a) FROM t").rows() == [(3,)]
    con.close()


# -- the storage under DML --------------------------------------------------------------

def test_int64_widened_past_int32_is_promoted_again():
    """A BIGINT column is narrowed to int32 on the device while its values
    fit; an UPDATE and an INSERT past 2^31 must promote it at int64."""
    tcon = duckdb_tpu_torch.connect(device="cpu")
    tcon.sql("CREATE TABLE t (k INT, v BIGINT)")
    tcon.sql("INSERT INTO t SELECT range, range * 3 FROM range(1000)")
    assert tcon.sql("SELECT sum(v) FROM t").rows() == [(3 * 999 * 1000 // 2,)]
    assert tcon.catalog.get_table("t").device_column("v").data.dtype == torch.int32
    tcon.sql("UPDATE t SET v = v + 3000000000 WHERE k = 7")
    assert tcon.catalog.get_table("t").device_column("v").data.dtype == torch.int64
    assert tcon.sql("SELECT v FROM t WHERE k = 7").rows() == [(3000000021,)]
    tcon.sql("DELETE FROM t WHERE k = 7")
    assert tcon.catalog.get_table("t").device_column("v").data.dtype == torch.int32
    tcon.sql("INSERT INTO t VALUES (7, -5000000000)")
    assert tcon.catalog.get_table("t").device_column("v").data.dtype == torch.int64
    assert tcon.sql("SELECT sum(v), max(v), min(v) FROM t").rows() == [
        (3 * 999 * 1000 // 2 - 21 - 5000000000, 2997, -5000000000)]


def test_varchar_insert_builds_a_new_dictionary():
    """The LIKE LUT cache keys on the dictionary's id: an INSERT of a new
    value must make a new dictionary array, never extend the old one, so
    the LIKE after it sees the new value."""
    jcon, tcon = connect_both()
    script = ["CREATE TABLE t (s VARCHAR)",
              "INSERT INTO t VALUES ('apple'), ('banana'), ('cherry')",
              "SELECT count(*) FROM t WHERE s LIKE '%an%'"]
    run_both(script, (jcon, tcon))
    old = tcon.catalog.get_table("t").host_column("s")[2]
    old_copy = old.copy()
    run_both(["INSERT INTO t VALUES ('mango'), ('apple')",
              "SELECT count(*) FROM t WHERE s LIKE '%an%'",
              "SELECT s, count(*) FROM t GROUP BY s ORDER BY s"], (jcon, tcon))
    new = tcon.catalog.get_table("t").host_column("s")[2]
    assert new is not old and list(old) == list(old_copy)
    assert list(new) == ["apple", "banana", "cherry", "mango"]


def test_varchar_insert_from_the_same_dictionary_keeps_it():
    """Rows copied from a table keep its dictionary object (no merge)."""
    tcon = duckdb_tpu_torch.connect(device="cpu")
    tcon.sql("CREATE TABLE t (s VARCHAR); INSERT INTO t VALUES ('a'), ('b')")
    tcon.sql("CREATE TABLE u AS SELECT * FROM t")
    d = tcon.catalog.get_table("u").host_column("s")[2]
    assert d is tcon.catalog.get_table("t").host_column("s")[2]
    tcon.sql("INSERT INTO u SELECT * FROM t")
    assert tcon.catalog.get_table("u").host_column("s")[2] is d
    assert tcon.sql("SELECT s, count(*) FROM u GROUP BY s ORDER BY s").rows() == [
        ("a", 2), ("b", 2)]


def test_distinct_counts_after_ctas_and_delete():
    """F1 under DML: CREATE TABLE … AS SELECT of a VARCHAR column counts the
    codes it holds, not its source's dictionary; after a DELETE the kept
    dictionary is no distinct count, so a duplicated key is never trusted
    as unique."""
    tcon = duckdb_tpu_torch.connect(device="cpu")
    tcon.sql("CREATE TABLE src (s VARCHAR)")
    tcon.sql("INSERT INTO src VALUES ('a'), ('b'), ('c'), ('d')")
    tcon.sql("CREATE TABLE c AS SELECT s FROM src WHERE s < 'c' UNION ALL SELECT 'a'")
    e = tcon.catalog.get_table("c")
    assert e.nrows == 3 and e.distinct_count("s") == 2
    tcon.sql("CREATE TABLE d (s VARCHAR); INSERT INTO d VALUES ('a'), ('a'), ('b'), ('c')")
    tcon.sql("DELETE FROM d WHERE s = 'c'")
    e = tcon.catalog.get_table("d")
    assert e.nrows == 3 and e.distinct_count("s") == 2
    assert tcon.sql("SELECT count(*) FROM src JOIN d ON src.s = d.s").rows() == [(3,)]


def test_pool_counts_a_shared_column_once_and_frees_dropped_tables():
    """A snapshot holds the published table until a statement writes it;
    the clone then shares the columns it did not write: the pool counts
    each once, keeps it while any holder does, a new holder leaves its
    last use as it was, and a dropped table's bytes leave with it."""
    C.set_memory_limit(0)
    tcon = duckdb_tpu_torch.connect(device="cpu")
    c2 = tcon.cursor()
    tcon.sql("CREATE TABLE t (a BIGINT, b BIGINT)")
    tcon.sql("INSERT INTO t SELECT range, range * 2 FROM range(5000)")
    tcon.sql("SELECT sum(a), sum(b) FROM t").rows()
    entry = tcon.catalog.get_table("t")
    cids = [id(entry._device[c]) for c in ("a", "b")]
    tcon.sql("BEGIN")
    c2.sql("BEGIN")
    assert tcon.sql("SELECT sum(a), sum(b) FROM t").rows() == \
        c2.sql("SELECT sum(a), sum(b) FROM t").rows()
    assert tcon.catalog.get_table("t") is entry is c2.catalog.get_table("t")
    for cid in cids:
        nbytes, last, holders = C.POOL._columns[cid]
        assert len(holders) == 1 and nbytes == 5120 * 4
    clone = entry.clone()
    for cid in cids:
        nbytes, last2, holders = C.POOL._columns[cid]
        assert len(holders) == 2 and last2 == last or cid != cids[-1]
    del clone
    tcon.sql("UPDATE t SET b = b + 1 WHERE a = 7")
    mine = tcon.catalog.get_table("t")
    assert mine is not entry and mine._device["a"] is entry._device["a"]
    assert "b" not in mine._device
    nbytes, _, holders = C.POOL._columns[cids[0]]
    assert len(holders) == 2 and nbytes == 5120 * 4  # two holders, one count
    assert c2.sql("SELECT sum(b) FROM t").rows() == [(2 * 12497500,)]
    assert tcon.sql("SELECT sum(b) FROM t").rows() == [(2 * 12497500 + 1,)]
    tcon.sql("ROLLBACK")
    c2.sql("ROLLBACK")
    del mine
    assert C.POOL.holds(entry)
    tcon.sql("DROP TABLE t")
    assert not C.POOL.holds(entry) and not any(cid in C.POOL._columns for cid in cids)


def test_pool_eviction_frees_a_shared_column_from_every_holder():
    tcon = duckdb_tpu_torch.connect(device="cpu")
    tcon.sql("CREATE TABLE t (a BIGINT, b BIGINT)")
    tcon.sql("INSERT INTO t SELECT range, range FROM range(5000)")
    tcon.sql("SELECT sum(a) FROM t").rows()
    tcon.sql("BEGIN")
    tcon.sql("UPDATE t SET b = b WHERE a = 1")  # the snapshot's clone holds a too
    tcon.sql("SELECT sum(a) FROM t").rows()
    snap = tcon.catalog.get_table("t")
    shared = tcon._db.catalog.get_table("t")
    assert snap is not shared and snap._device["a"] is shared._device["a"]
    try:
        C.set_memory_limit(1)  # below one column: the pool keeps at most one
        assert "a" not in snap._device or "a" not in shared._device or \
            snap._device.get("a") is shared._device.get("a")
        tcon.sql("SELECT sum(b) FROM t").rows()
        assert "a" not in snap._device and "a" not in shared._device
    finally:
        C.set_memory_limit(0)
        tcon.sql("ROLLBACK")


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("tpch_gen_dml")
    write_tables(str(root), 0.01, seed=7)
    return str(root)


EDITS = [
    "CREATE TABLE li AS SELECT * FROM lineitem",
    "DELETE FROM li WHERE l_shipdate < DATE '1993-01-01'",
    "UPDATE li SET l_discount = l_discount + 0.01 WHERE l_returnflag = 'R' AND "
    "l_discount < 0.10",
    "INSERT INTO li SELECT * FROM lineitem WHERE l_orderkey % 7 = 0",
]
Q1_LI = chip_smoke.Q1.replace("FROM lineitem", "FROM li")


def _edited(data_dir, **settings):
    tcon = duckdb_tpu_torch.connect(device="cpu")
    tcon.load_tpch(data_dir)
    for k, v in settings.items():
        tcon.sql(f"SET {k} = {v}")
    tcon.sql(EDITS[0])
    return tcon, [tcon.sql(s).rows() for s in EDITS[1:]]


def test_tpch_edits_match_jax(data_dir):
    """Phase 18's edits at SF 0.01: each Count and Q1 over the edited table
    equal the JAX package's."""
    jcon = duckdb_tpu.connect()
    jcon.load_tpch(data_dir)
    tcon = duckdb_tpu_torch.connect(device="cpu")
    tcon.load_tpch(data_dir)
    run_both(EDITS + [Q1_LI, "SELECT count(*), sum(l_quantity) FROM li"], (jcon, tcon))


def test_q1_over_edited_table_reaches_the_kernel(data_dir, monkeypatch):
    calls = []
    orig = grouped_mod.grouped_sum_i64

    def recording(dense, vectors, nseg):
        calls.append(nseg)
        return orig(dense, vectors, nseg)

    tcon, _ = _edited(data_dir)
    monkeypatch.setattr(grouped_mod, "grouped_sum_i64", recording)
    tcon.sql(Q1_LI).rows()
    assert calls == [calls[0]] and calls[0] >= 4
    tcon.sql("CREATE TABLE agg (f VARCHAR, s VARCHAR, q DECIMAL(38,2))")
    calls.clear()
    assert tcon.sql("INSERT INTO agg SELECT l_returnflag, l_linestatus, sum(l_quantity) "
                    "FROM li GROUP BY l_returnflag, l_linestatus").rows() == [(4,)]
    assert len(calls) == 1
    want = tcon.sql("SELECT l_returnflag, l_linestatus, sum(l_quantity) FROM li "
                    "GROUP BY 1, 2 ORDER BY 1, 2").rows()
    assert tcon.sql("SELECT * FROM agg ORDER BY 1, 2").rows() == want


def test_chunked_and_sharded_routes_read_the_edited_table(data_dir):
    """Under SET memory_limit (chunks) and SET num_shards = 4 the edited
    table gives the single-device, in-memory answers."""
    base, counts = _edited(data_dir)
    want = base.sql(Q1_LI).rows()
    try:
        chunked, counts2 = _edited(data_dir, memory_limit="'1MB'")
        assert counts2 == counts
        chunked.routes.clear()
        assert chunked.sql(Q1_LI).rows() == want
        assert chunked.routes["out_of_core"] == 1
    finally:
        C.set_memory_limit(0)
    sharded, counts3 = _edited(data_dir, num_shards=4)
    assert counts3 == counts
    sharded.routes.clear()
    assert sharded.sql(Q1_LI).rows() == want
    assert sharded.routes["sharded_agg"] == 1


def test_plain_index_and_explain_text():
    tcon = duckdb_tpu_torch.connect(device="cpu")
    tcon.sql("CREATE TABLE t (a INT); INSERT INTO t VALUES (1)")
    text, = tcon.sql("EXPLAIN SELECT a FROM t WHERE a > 0").rows()[0]
    assert "Scan t [1 cols]" in text and "Filter" in text


def test_like_cache_sees_updated_strings():
    """An UPDATE of a VARCHAR column gives a new dictionary: the LIKE LUT
    cached for the old one is not reused."""
    tcon = duckdb_tpu_torch.connect(device="cpu")
    tcon.sql("CREATE TABLE t (s VARCHAR); INSERT INTO t VALUES ('xa'), ('xb'), ('y')")
    assert tcon.sql("SELECT count(*) FROM t WHERE s LIKE 'x%'").rows() == [(2,)]
    tcon.sql("UPDATE t SET s = 'xz' WHERE s = 'y'")
    assert tcon.sql("SELECT count(*) FROM t WHERE s LIKE 'x%'").rows() == [(3,)]
    assert dstr._LUT_CACHE is not None
