"""The port's sqllogictest runner (duckdb_tpu_torch/testing/sqllogic.py).

The counterparts of tests/test_sqllogic.py: the vendored scripts
(tests/sqllogic/*.test: basic aggregates, NULL joins, WITH RECURSIVE,
each starting with CREATE TABLE and INSERT) pass on the port at
device="cpu", and so they do on the JAX package's runner; a hashed result
block; statement error matching; loops. `load` and `restart` need a
database file and raise, naming ROADMAP item 33.
"""

import glob
import hashlib
import os

import pytest
import torch

import duckdb_tpu_torch
from duckdb_tpu_torch.testing.sqllogic import SqlLogicRunner

torch.set_num_threads(1)

HERE = os.path.dirname(__file__)
SCRIPTS = sorted(glob.glob(os.path.join(HERE, "sqllogic", "*.test")))


def _runner():
    return SqlLogicRunner(lambda *args: duckdb_tpu_torch.connect(device="cpu"))


@pytest.mark.parametrize("path", SCRIPTS, ids=[os.path.basename(p) for p in SCRIPTS])
def test_sqllogic_file(path):
    from duckdb_tpu.testing.sqllogic import SqlLogicRunner as JaxRunner

    res = _runner().run_file(path)
    assert res.ok, "\n".join(res.errors)
    jres = JaxRunner().run_file(path)
    assert res.passed == jres.passed > 0 and jres.failed == 0


def test_sqllogic_hashed_result():
    vals = [str(v) for v in range(10)]
    digest = hashlib.md5("".join(v + "\n" for v in vals).encode()).hexdigest()
    res = _runner().run_text(f"""
query I rowsort
SELECT * FROM range(10)
----
10 values hashing to {digest}
""")
    assert res.failed == 0 and res.passed == 1, res.errors


def test_sqllogic_dml_errors_and_loops():
    res = _runner().run_text("""
statement ok
CREATE TABLE t (a INTEGER PRIMARY KEY, b VARCHAR)

loop i 0 3

statement ok
INSERT INTO t VALUES (${i}, 'v${i}')

endloop

statement error
INSERT INTO t VALUES (1, 'dup')
----
PRIMARY KEY

query IT
SELECT a, b FROM t ORDER BY a
----
0	v0
1	v1
2	v2

statement ok
UPDATE t SET b = NULL WHERE a = 1

query I
SELECT count(b) FROM t
----
2
""")
    assert res.failed == 0, res.errors
    assert res.passed == 8


def test_sqllogic_load_and_restart_name_item_33():
    for directive in ("load __TEST_DIR__/roundtrip_db", "restart"):
        with pytest.raises(ValueError, match="ROADMAP item 33"):
            _runner().run_text(f"""
statement ok
CREATE TABLE t (a INTEGER)

{directive}
""")
