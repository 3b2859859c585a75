"""Fault injection in the port's file databases against the JAX package's
(the counterpart of tests/test_fault_injection.py).

Every debug_checkpoint_abort point (before_data, before_header,
before_truncate) leaves a database that reopens to exactly the committed
rows, after inserts and after deletes and updates; writes after a failed
checkpoint land once; the WAL records a checkpoint holds are not applied
twice; generations do not pile up; debug_force_commit_failure rolls the
transaction back. Each scenario runs through both packages
(tests/_torch_parity.run_both_files) and the outcomes must agree.
"""

import glob
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from _torch_parity import run_both_files  # noqa: E402

torch.set_num_threads(1)

POINTS = ["before_data", "before_header", "before_truncate"]


def _run(side, con, script):
    return [(q, side.sql(con, q)) for q in script]


@pytest.mark.parametrize("point", POINTS)
def test_checkpoint_abort_recovers(tmp_path, point):
    def scenario(side):
        con = side.connect("db")
        out = _run(side, con, ["CREATE TABLE t (i BIGINT, s VARCHAR)",
                               "INSERT INTO t VALUES (1, 'a'), (2, 'b')", "CHECKPOINT",
                               "INSERT INTO t VALUES (3, 'c')",
                               f"SET debug_checkpoint_abort = '{point}'", "CHECKPOINT"])
        assert out[-1][1][0] == "error" and "checkpoint aborted" in str(out[-1][1][1])
        side.crash()
        con2 = side.connect("db")
        out += _run(side, con2, ["SELECT i, s FROM t ORDER BY i"])
        con2.close()
        return out

    _, t = run_both_files(tmp_path, scenario)
    assert t[-1][1] == ("rows", [(1, "a"), (2, "b"), (3, "c")])


def test_checkpoint_abort_then_more_writes(tmp_path):
    def scenario(side):
        con = side.connect("db")
        out = _run(side, con, ["CREATE TABLE t (i BIGINT)", "INSERT INTO t VALUES (1)",
                               "SET debug_checkpoint_abort = 'before_truncate'", "CHECKPOINT",
                               "RESET debug_checkpoint_abort", "INSERT INTO t VALUES (2)"])
        con.close()
        con2 = side.connect("db")
        out += _run(side, con2, ["SELECT sum(i), count(*) FROM t"])
        con2.close()
        return out

    _, t = run_both_files(tmp_path, scenario)
    assert t[-1][1] == ("rows", [(3, 2)])


def test_wal_epoch_no_double_apply(tmp_path):
    """The header swapped, the WAL not yet removed: replay skips what the
    checkpoint holds."""
    def scenario(side):
        con = side.connect("db")
        out = _run(side, con, ["CREATE TABLE t (i BIGINT)", "INSERT INTO t VALUES (10)",
                               "INSERT INTO t VALUES (20)",
                               "SET debug_checkpoint_abort = 'before_truncate'", "CHECKPOINT"])
        side.crash()
        assert os.path.exists(os.path.join(side.path("db"), "wal.sql"))
        con2 = side.connect("db")
        out += _run(side, con2, ["SELECT sum(i), count(*) FROM t"])
        con2.close()
        return out

    _, t = run_both_files(tmp_path, scenario)
    assert t[-1][1] == ("rows", [(30, 2)])


@pytest.mark.parametrize("point", POINTS)
def test_checkpoint_abort_with_deletes_updates(tmp_path, point):
    def scenario(side):
        con = side.connect("db")
        out = _run(side, con, [
            "CREATE TABLE t (i BIGINT, s VARCHAR)",
            "INSERT INTO t VALUES (1,'a'), (2,'b'), (3,'c'), (4,'d'), (5,'e')", "CHECKPOINT",
            "DELETE FROM t WHERE i IN (2, 4)", "UPDATE t SET s = 'z' WHERE i = 5",
            f"SET debug_checkpoint_abort = '{point}'", "CHECKPOINT"])
        side.crash()
        con2 = side.connect("db")
        out += _run(side, con2, ["SELECT i, s FROM t ORDER BY i", "DELETE FROM t WHERE i = 1",
                                 "CHECKPOINT"])
        con2.close()
        con3 = side.connect("db")
        out += _run(side, con3, ["SELECT i, s FROM t ORDER BY i"])
        con3.close()
        return out

    _, t = run_both_files(tmp_path, scenario)
    assert t[-4][1] == ("rows", [(1, "a"), (3, "c"), (5, "z")])
    assert t[-1][1] == ("rows", [(3, "c"), (5, "z")])


def test_checkpoint_generation_cleanup(tmp_path):
    def scenario(side):
        con = side.connect("db")
        out = _run(side, con, ["CREATE TABLE t (i BIGINT)"])
        for k in range(3):
            out += _run(side, con, [f"INSERT INTO t VALUES ({k})", "CHECKPOINT"])
        gens = glob.glob(os.path.join(side.path("db"), "data*"))
        assert len(gens) == 1, gens
        con.close()
        con2 = side.connect("db")
        out += _run(side, con2, ["SELECT count(*) FROM t"])
        con2.close()
        return out

    _, t = run_both_files(tmp_path, scenario)
    assert t[-1][1] == ("rows", [(3,)])


def test_forced_commit_failure_rolls_back(tmp_path):
    def scenario(side):
        con = side.connect("db")
        out = _run(side, con, [
            "CREATE TABLE t (i BIGINT)", "INSERT INTO t VALUES (1)",
            "SET debug_force_commit_failure = true", "BEGIN", "INSERT INTO t VALUES (99)",
            "COMMIT", "SELECT count(*) FROM t", "SET debug_force_commit_failure = false",
            "BEGIN", "INSERT INTO t VALUES (2)", "COMMIT", "SELECT sum(i) FROM t"])
        assert "forced commit failure" in str(out[5][1][1])
        con.close()
        con2 = side.connect("db")
        out += _run(side, con2, ["SELECT sum(i) FROM t"])
        con2.close()
        return out

    _, t = run_both_files(tmp_path, scenario)
    assert t[6][1] == ("rows", [(1,)]) and t[-1][1] == ("rows", [(3,)])


def test_abort_setting_values():
    import duckdb_tpu_torch

    con = duckdb_tpu_torch.connect(device="cpu")
    con.sql("SET debug_checkpoint_abort = 'BEFORE_HEADER'")
    assert con.settings.get("debug_checkpoint_abort") == "before_header"
    with pytest.raises(ValueError, match="debug_checkpoint_abort takes"):
        con.sql("SET debug_checkpoint_abort = 'sometime'")
    con.sql("SET wal_autocheckpoint = '1KB'")
    assert con.settings.get("checkpoint_threshold") == "1KB"
    with pytest.raises(ValueError, match="Failed to parse"):
        con.sql("SET checkpoint_threshold = 'lots'")
