"""MERGE INTO of duckdb_tpu_torch (device="cpu") against the JAX package.

Each script runs statement by statement through both packages
(tests/_torch_parity.py): the cases of tests/test_merge.py, keys over one
and two columns, every clause form, the first applicable clause winning,
and the statement inside a transaction. The JAX package's MERGE returns
nothing; the port returns DuckDB's one-row Count of the rows it inserted,
updated and deleted (ROADMAP M4), so every MERGE here is held to that
Count. Where the JAX package is wrong the port is held to DuckDB or SQL:
M1, a target row two source rows match raises; M2, MERGE's UPDATE checks
NOT NULL, CHECK and keys; M3, MERGE's DELETE checks the FOREIGN KEYs that
reference the target. Last, TPC-H Q1 over a merged lineitem reaches the
grouped-sum kernel's plain version and equals numpy.
"""

import os
import sys

import numpy as np
import pytest
import torch

import duckdb_tpu_torch
from duckdb_tpu_torch.errors import ConstraintException, InvalidInputException
from duckdb_tpu_torch.ops import grouped as grouped_mod
from duckdb_tpu_torch.testing.tpch_gen import write_tables

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from _torch_parity import connect_both, run_both  # noqa: E402
import chip_smoke  # noqa: E402  (Q1's text and its numpy answer)

torch.set_num_threads(1)

SETUP = ["CREATE TABLE tgt (id INT, v VARCHAR, amt INT)",
         "CREATE TABLE src (id INT, v VARCHAR, amt INT)",
         "INSERT INTO tgt VALUES (1,'a',10),(2,'b',20),(3,'c',30)",
         "INSERT INTO src VALUES (2,'B',200),(3,'C',-1),(4,'d',40)"]
CHECK = "SELECT * FROM tgt ORDER BY id"

FULL = ("MERGE INTO tgt USING src ON tgt.id = src.id "
        "WHEN MATCHED AND src.amt < 0 THEN DELETE "
        "WHEN MATCHED THEN UPDATE SET v = src.v, amt = src.amt "
        "WHEN NOT MATCHED THEN INSERT VALUES (src.id, src.v, src.amt)")
UPDATE_ONLY = ("MERGE INTO tgt USING src ON tgt.id = src.id "
               "WHEN MATCHED THEN UPDATE SET amt = tgt.amt + src.amt")
INSERT_ONLY = ("MERGE INTO tgt USING src ON tgt.id = src.id "
               "WHEN NOT MATCHED THEN INSERT VALUES (src.id, src.v, src.amt)")

CLAUSES = ("MERGE INTO tgt USING src ON tgt.id = src.id "
           "WHEN MATCHED AND src.amt > 100 THEN UPDATE SET v = 'big' "
           "WHEN MATCHED AND src.amt > 0 THEN DELETE "
           "WHEN MATCHED THEN UPDATE SET amt = 0 "
           "WHEN NOT MATCHED AND src.amt > 0 THEN INSERT VALUES (src.id, upper(src.v), "
           "src.amt * 3)")
NOT_MATCHED_FIRST = ("MERGE INTO tgt USING src ON tgt.id = src.id "
                     "WHEN NOT MATCHED AND src.amt < 0 THEN DO NOTHING "
                     "WHEN NOT MATCHED AND src.amt > 0 THEN INSERT VALUES (src.id, 'first', 1) "
                     "WHEN NOT MATCHED THEN INSERT VALUES (src.id, 'second', 2)")

# script, {MERGE statement: its Count}
CASES = {
    # tests/test_merge.py
    "full": (SETUP + [FULL, CHECK], {FULL: 3}),
    "update_only": (SETUP + [UPDATE_ONLY, "SELECT sum(amt) FROM tgt", CHECK],
                    {UPDATE_ONLY: 2}),
    "insert_only": (SETUP + [INSERT_ONLY, "SELECT count(*) FROM tgt", CHECK],
                    {INSERT_ONLY: 1}),
    # two key columns, a source subquery, INSERT with a column list
    "two_keys": ([
        "CREATE TABLE g (a INT, b VARCHAR, x DOUBLE, d DATE)",
        "INSERT INTO g VALUES (1,'p',1.5,DATE '2020-01-01'),(1,'q',2.5,NULL),"
        "(2,'p',3.5,DATE '2021-06-30')",
        "MERGE INTO g USING (SELECT 1 AS a, 'q' AS b, 9.25 AS x UNION ALL "
        "SELECT 2, 'q', 7.0) s ON g.a = s.a AND g.b = s.b "
        "WHEN MATCHED THEN UPDATE SET x = s.x * 2, d = DATE '1999-12-31' "
        "WHEN NOT MATCHED THEN INSERT (a, b, x) VALUES (s.a, s.b, s.x)",
        "SELECT * FROM g ORDER BY a, b",
    ], {"MERGE INTO g USING (SELECT 1 AS a, 'q' AS b, 9.25 AS x UNION ALL "
        "SELECT 2, 'q', 7.0) s ON g.a = s.a AND g.b = s.b "
        "WHEN MATCHED THEN UPDATE SET x = s.x * 2, d = DATE '1999-12-31' "
        "WHEN NOT MATCHED THEN INSERT (a, b, x) VALUES (s.a, s.b, s.x)": 2}),
    # the first applicable WHEN MATCHED clause wins; a NOT MATCHED condition
    "clauses": (SETUP + [
        "INSERT INTO src VALUES (5,'e',-5),(1,'A',1)",
        CLAUSES,
        CHECK,
    ], {CLAUSES: 4}),
    # INSERT * and an alias on the target; a VARCHAR update makes a new dictionary
    "insert_star": (SETUP + [
        "MERGE INTO tgt AS t USING src ON t.id = src.id "
        "WHEN MATCHED THEN UPDATE SET v = t.v || src.v WHEN NOT MATCHED THEN INSERT *",
        CHECK,
        "SELECT upper(v), v LIKE '%C' FROM tgt ORDER BY id",
    ], {"MERGE INTO tgt AS t USING src ON t.id = src.id "
        "WHEN MATCHED THEN UPDATE SET v = t.v || src.v WHEN NOT MATCHED THEN INSERT *": 3}),
    # inside a transaction, rolled back and then committed
    "transaction": (SETUP + [
        "BEGIN", FULL, CHECK, "ROLLBACK", CHECK,
        "BEGIN", UPDATE_ONLY, "COMMIT", CHECK,
    ], {FULL: 3, UPDATE_ONLY: 2}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_merge_matches_jax(name):
    script, counts = CASES[name]
    run_both(script, duckdb={sql: [(n,)] for sql, n in counts.items()})


# M1: the setup of ROADMAP's M1 and M2
FAULT_SETUP = ["CREATE TABLE t (id INTEGER PRIMARY KEY, v INTEGER NOT NULL, s VARCHAR)",
               "INSERT INTO t VALUES (1,10,'a'),(2,20,'b'),(3,30,NULL)",
               "CREATE TABLE src (id INTEGER, v INTEGER, s VARCHAR)",
               "INSERT INTO src VALUES (1,11,'x'),(4,40,'y'),(1,12,'z')"]
T_ROWS = [(1, 10, "a"), (2, 20, "b"), (3, 30, None)]
M1 = ("MERGE INTO t USING src ON t.id = src.id WHEN MATCHED THEN UPDATE SET v = src.v "
      "WHEN NOT MATCHED THEN INSERT VALUES (src.id, src.v, src.s)")


def test_m1_two_source_rows_for_one_target_row_raise():
    """SQL's cardinality violation: the JAX package updates row 1 from one of
    the two (and inserts 4); the port raises and leaves t as it was."""
    _, tcon = run_both(FAULT_SETUP + [M1, "SELECT * FROM t ORDER BY id"],
                       duckdb={M1: InvalidInputException,
                               "SELECT * FROM t ORDER BY id": T_ROWS})
    # with only NOT MATCHED clauses there is nothing to do twice
    assert tcon.sql("MERGE INTO t USING src ON t.id = src.id WHEN NOT MATCHED THEN "
                    "INSERT VALUES (src.id, src.v, src.s)").rows() == [(1,)]
    assert tcon.sql("SELECT count(*) FROM t").rows() == [(4,)]


M2 = {
    "not_null": ("MERGE INTO t USING (SELECT 2 AS id, NULL::INTEGER AS v) s2 "
                 "ON t.id = s2.id WHEN MATCHED THEN UPDATE SET v = s2.v"),
    "check": ("MERGE INTO mm USING (SELECT 1 AS id) s ON mm.id = s.id "
              "WHEN MATCHED THEN UPDATE SET v = -5"),
    "primary_key": ("MERGE INTO mm USING (SELECT 2 AS id) s ON mm.id = s.id "
                    "WHEN MATCHED THEN UPDATE SET id = 1"),
}


@pytest.mark.parametrize("kind", sorted(M2))
def test_m2_merge_update_checks_constraints(kind):
    """DuckDB raises a ConstraintException; the JAX package writes the host
    planes directly, storing a NULL under NOT NULL, a -5 under CHECK (v >
    0), and a second row with key 1."""
    script = FAULT_SETUP[:2] + [
        "CREATE TABLE mm (id INTEGER PRIMARY KEY, v INTEGER CHECK (v > 0))",
        "INSERT INTO mm VALUES (1, 1), (2, 2)"]
    check = "SELECT * FROM t ORDER BY id" if kind == "not_null" else \
        "SELECT * FROM mm ORDER BY id"
    run_both(script + [M2[kind], check],
             duckdb={M2[kind]: ConstraintException,
                     check: T_ROWS if kind == "not_null" else [(1, 1), (2, 2)]})


M3 = ("MERGE INTO par USING (SELECT 1 AS id) s ON par.id = s.id "
      "WHEN MATCHED THEN DELETE")


def test_m3_merge_delete_checks_foreign_keys():
    """The JAX package deletes par's 1 and leaves chi's 1 an orphan; DuckDB
    raises, as the port's DELETE does."""
    _, tcon = run_both(["CREATE TABLE par (id INTEGER PRIMARY KEY)",
                        "CREATE TABLE chi (pid INTEGER REFERENCES par(id))",
                        "INSERT INTO par VALUES (1), (2)", "INSERT INTO chi VALUES (1)",
                        M3, "SELECT * FROM par ORDER BY id"],
                       duckdb={M3: ConstraintException,
                               "SELECT * FROM par ORDER BY id": [(1,), (2,)]})
    # a key nothing references goes
    assert tcon.sql(M3.replace("1 AS id", "2 AS id")).rows() == [(1,)]


def test_m5_first_not_matched_clause_wins():
    """SQL: of the WHEN NOT MATCHED clauses the first whose condition holds
    acts, DO NOTHING included. The JAX package skips DO NOTHING and lets
    every INSERT whose condition holds insert the row again."""
    want = [(1, "a", 10), (2, "b", 20), (3, "c", 30), (4, "first", 1), (6, "second", 2)]
    run_both(SETUP + ["INSERT INTO src VALUES (5,'e',-5),(6,'f',NULL)",
                      NOT_MATCHED_FIRST, CHECK],
             duckdb={NOT_MATCHED_FIRST: [(2,)], CHECK: want})


def test_m4_merge_returns_its_count():
    """DuckDB's MERGE returns one row: inserted + updated + deleted."""
    jcon, tcon = connect_both()
    for con in (jcon, tcon):
        for sql in SETUP:
            con.sql(sql)
    assert jcon.sql(FULL) is None
    res = tcon.sql(FULL)
    assert res.names == ["Count"] and res.rows() == [(3,)]


def test_merge_is_atomic():
    """An insert that breaks the key after an update and a delete leaves the
    table as it was."""
    tcon = duckdb_tpu_torch.connect(device="cpu")
    for sql in FAULT_SETUP[:2]:
        tcon.sql(sql)
    with pytest.raises(ConstraintException):
        tcon.sql("MERGE INTO t USING (SELECT 2 AS id, 5 AS v UNION ALL SELECT 3, 6 "
                 "UNION ALL SELECT 9, NULL) s ON t.id = s.id "
                 "WHEN MATCHED AND s.id = 2 THEN UPDATE SET v = s.v "
                 "WHEN MATCHED THEN DELETE WHEN NOT MATCHED THEN INSERT VALUES (s.id, s.v, 'n')")
    assert tcon.sql("SELECT * FROM t ORDER BY id").rows() == T_ROWS


def test_merge_defaults_and_null_keys():
    """INSERT with a column list takes the other columns' DEFAULTs; a source
    row with a NULL key matches nothing and is inserted (SQL)."""
    tcon = duckdb_tpu_torch.connect(device="cpu")
    tcon.sql("CREATE SEQUENCE q START 100")
    tcon.sql("CREATE TABLE d (k INT, n INT DEFAULT nextval('q'), s VARCHAR DEFAULT 'dflt')")
    tcon.sql("INSERT INTO d (k) VALUES (1)")
    assert tcon.sql("MERGE INTO d USING (SELECT 1 AS k UNION ALL SELECT 2 UNION ALL "
                    "SELECT NULL) s ON d.k = s.k WHEN NOT MATCHED THEN INSERT (k) "
                    "VALUES (s.k)").rows() == [(2,)]
    assert tcon.sql("SELECT * FROM d ORDER BY n").rows() == [
        (1, 100, "dflt"), (2, 101, "dflt"), (None, 102, "dflt")]


def test_merge_write_conflict_first_committer_wins():
    """Two connections MERGE into one table inside BEGIN: the second COMMIT
    raises and its MERGE is gone."""
    from duckdb_tpu_torch.errors import TransactionException

    a = duckdb_tpu_torch.connect(device="cpu")
    for sql in SETUP:
        a.sql(sql)
    b = a.cursor()
    a.sql("BEGIN")
    b.sql("BEGIN")
    a.sql(UPDATE_ONLY)
    b.sql(FULL)
    a.sql("COMMIT")
    with pytest.raises(TransactionException):
        b.sql("COMMIT")
    assert b.sql("SELECT sum(amt) FROM tgt").rows() == [(259,)]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("tpch_gen_merge")
    write_tables(str(root), 0.01, seed=7)
    return str(root)


def test_q1_over_merged_lineitem_reaches_the_kernel(data_dir, monkeypatch):
    """Phase 21's MERGE at SF 0.01: its Count and Q1 over the merged table
    equal numpy's, Q1 through the grouped sum (its plain version here)."""
    tcon = duckdb_tpu_torch.connect(device="cpu")
    tcon.load_tpch(data_dir)
    tcon.sql("CREATE TABLE li AS SELECT * FROM lineitem")
    tcon.sql("CREATE TABLE stg AS SELECT * FROM lineitem WHERE l_orderkey % 50 = 0")
    tcon.sql("UPDATE stg SET l_orderkey = l_orderkey + 6000000 WHERE l_orderkey % 100 = 50")
    li = chip_smoke.lineitem_numpy(data_dir)
    stg = {k: v[li["l_orderkey"] % 50 == 0] for k, v in li.items()}
    moved = stg["l_orderkey"] % 100 == 50
    stg["l_orderkey"] = np.where(moved, stg["l_orderkey"] + 6000000, stg["l_orderkey"])
    want_li = chip_smoke.merge_numpy(li, stg)
    calls = []
    orig = grouped_mod.grouped_sum_i64

    def recording(dense, vectors, nseg):
        calls.append(nseg)
        return orig(dense, vectors, nseg)

    count = tcon.sql(chip_smoke.MERGE_LI).rows()
    assert count == [(want_li["count"],)]
    monkeypatch.setattr(grouped_mod, "grouped_sum_i64", recording)
    rows = tcon.sql(chip_smoke.Q1.replace("FROM lineitem", "FROM li")).rows()
    assert chip_smoke.rows_match(rows, chip_smoke.numpy_q1_of(want_li["cols"])) == ""
    assert len(calls) == 1
