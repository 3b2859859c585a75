"""The plan cache of duckdb_tpu_torch (device="cpu") under DDL and DML.

The counterparts of tests/test_plan_cache.py: a repeated query reuses
its plan, every statement but a SELECT empties the cache (with the
hidden tables its plans own), a text of several statements is never
cached, and a join's build state cached on a warm plan is keyed by the
versions of the tables under it, so DML on either side is seen. The
answers are held to the JAX package's. The SET case uses num_shards, a
setting the port honours; the DDL
case uses CREATE OR REPLACE TABLE (tests/test_torch_alter.py holds the
ALTER case of tests/test_plan_cache.py). The JAX
package leaves a plan with random() uncached; the port evaluates random()
when the plan runs (ROADMAP Queue 3, "Behaviours to know"), so a cached
plan gives new values on each run.
"""

import os
import sys

import pytest
import torch

import duckdb_tpu
import duckdb_tpu_torch

sys.path.insert(0, os.path.dirname(__file__))
from _torch_parity import run_both  # noqa: E402

torch.set_num_threads(1)

SETUP = ["CREATE TABLE t (a INT, b VARCHAR)", "INSERT INTO t VALUES (1, 'x'), (2, 'y')"]


@pytest.fixture
def con():
    c = duckdb_tpu_torch.connect(device="cpu")
    for sql in SETUP:
        c.sql(sql)
    return c


def test_repeat_query_reuses_plan(con):
    q = "SELECT sum(a) FROM t WHERE b <> 'z'"
    assert con.sql(q).rows() == [(3,)]
    plan1 = con._plan_cache[q]
    assert con.sql(q).rows() == [(3,)]
    assert con._plan_cache[q] is plan1


def test_dml_invalidates(con):
    q = "SELECT count(*) FROM t"
    assert con.sql(q).rows() == [(2,)]
    con.sql("INSERT INTO t VALUES (3, 'z')")
    assert q not in con._plan_cache
    assert con.sql(q).rows() == [(3,)]


def test_ddl_invalidates(con):
    q = "SELECT * FROM t ORDER BY a"
    assert con.sql(q).rows() == [(1, "x"), (2, "y")]
    con.sql("CREATE OR REPLACE TABLE t AS SELECT a, b, a * 10 AS c FROM t")
    assert con.sql(q).rows() == [(1, "x", 10), (2, "y", 20)]


def test_set_invalidates(con):
    q = "SELECT a FROM t ORDER BY a LIMIT 1"
    assert con.sql(q).rows() == [(1,)]
    con.sql("SET num_shards = 2")
    assert q not in con._plan_cache
    assert con.sql(q).rows() == [(1,)]
    con.sql("RESET num_shards")


def test_random_is_read_when_the_plan_runs(con):
    q = "SELECT random() FROM t"
    first = con.sql(q).rows()
    assert q in con._plan_cache
    assert con.sql(q).rows() != first


def test_multi_statement_text_not_cached(con):
    assert con.sql("SELECT 1; SELECT 2").rows() == [(2,)]
    assert all(";" not in k for k in con._plan_cache)


def test_hidden_tables_go_with_the_cache(con):
    """range()'s hidden table lives as long as its cached plan: the next
    DML statement drops both."""
    q = "SELECT count(*) FROM range(10)"
    con.sql(q).rows()
    (hidden,) = con._plan_tables[q]
    assert con.catalog.has_table(hidden)
    con.sql("INSERT INTO t VALUES (5, 'q')")
    assert not con.catalog.has_table(hidden) and q not in con._plan_cache


def test_probe_cache_reuse_and_invalidation():
    """A join's cached build is keyed by both tables' versions: DML on the
    probe side and on the build side are both seen, as in the JAX
    package."""
    script = [
        "CREATE TABLE dim (k BIGINT PRIMARY KEY, v BIGINT)",
        "INSERT INTO dim SELECT range, range * 10 FROM range(1000)",
        "CREATE TABLE fact (fk BIGINT, x BIGINT)",
        "INSERT INTO fact SELECT range % 1000, range FROM range(100000)",
    ]
    q = "SELECT sum(v + x) FROM fact JOIN dim ON fk = k WHERE x % 7 = 0"
    jcon, tcon = run_both(script + [q, q, q])
    r1 = tcon.sql(q).rows()
    run_both(["INSERT INTO fact VALUES (5, 700000)", q], (jcon, tcon))
    r4 = tcon.sql(q).rows()
    assert r4[0][0] == r1[0][0] + 5 * 10 + 700000
    run_both(["UPDATE dim SET v = v + 1 WHERE k = 5", q], (jcon, tcon))
    assert tcon.sql(q).rows()[0][0] > r4[0][0]


def test_cursor_plans_see_the_other_cursors_commits():
    """Each cursor has its own plan cache; a warm plan on one must read the
    table the other committed."""
    c1 = duckdb_tpu_torch.connect(device="cpu")
    c2 = c1.cursor()
    c1.sql("CREATE TABLE d (k BIGINT, v BIGINT)")
    c1.sql("INSERT INTO d SELECT range, range FROM range(100)")
    c1.sql("CREATE TABLE f (k BIGINT)")
    c1.sql("INSERT INTO f SELECT range % 100 FROM range(500)")
    q = "SELECT sum(v) FROM f JOIN d ON f.k = d.k"
    assert c2.sql(q).rows() == c2.sql(q).rows() == [(5 * 4950,)]
    c1.sql("UPDATE d SET v = v + 1")
    assert q in c2._plan_cache  # c2 ran no statement but SELECTs
    assert c2.sql(q).rows() == [(5 * 4950 + 500,)]
