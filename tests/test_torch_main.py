"""duckdb_logs() and the profile of EXPLAIN ANALYZE in duckdb_tpu_torch
(main/logging.py, main/profiler.py; ROADMAP item 36), on the CPU, against
the JAX package.

The same statements log lines of the same types, whose messages begin as
the JAX package's do (the LIKE patterns of tests/test_distributed.py,
test_out_of_core.py and test_spill.py find them): QueryLog once per
SELECT, Checkpoint, out_of_core under a memory limit, StringHostLoop, and
the sharded routes' exchange_join, sharded_sort, sharded_topn and
sharded_window. EXPLAIN ANALYZE gives one explain_value row, the profile's
text; its tree lists every operator of the JAX package's profile with the
same row counts. The JAX package's profile misses the query text (S2): the
port's carries it. Tables are small and made from numpy with a seed.
"""

import collections
import re

import numpy as np
import pytest
import torch

import duckdb_tpu
import duckdb_tpu_torch
from duckdb_tpu.catalog import catalog as JC
from duckdb_tpu_torch.catalog import catalog as TC
from duckdb_tpu_torch.main.logging import LEVELS, LogManager
from duckdb_tpu_torch.main.profiler import OperatorProfile, QueryProfile

torch.set_num_threads(1)

RNG = np.random.default_rng(36)
N = 3000
_ROWS = ", ".join(f"({i}, {g}, {v}, 'k{g}')" for i, (g, v) in
                  enumerate(zip(RNG.integers(0, 6, N), RNG.integers(-50, 50, N))))
SETUP = ["CREATE TABLE t (i INTEGER, g INTEGER, v INTEGER, s VARCHAR)",
         f"INSERT INTO t VALUES {_ROWS}",
         "CREATE TABLE d (g INTEGER, name VARCHAR)",
         "INSERT INTO d VALUES (0, 'zero'), (1, 'one'), (2, 'two'), (3, 'three'), (4, 'four')"]


@pytest.fixture(autouse=True)
def no_limit():
    yield
    TC.set_memory_limit(0)
    JC.set_memory_limit(0)


@pytest.fixture
def cons():
    jcon, tcon = duckdb_tpu.connect(), duckdb_tpu_torch.connect(device="cpu")
    for sql in SETUP:
        jcon.sql(sql)
        tcon.sql(sql)
    return jcon, tcon


def logs(con, where="TRUE"):
    return con.sql(f"SELECT log_level, type, message FROM duckdb_logs() WHERE {where}").rows()


# -- the log ------------------------------------------------------------------------------
def test_log_manager_keeps_the_last_4096_entries_at_info_and_above():
    from duckdb_tpu.main.logging import LogManager as JLogManager

    mine, theirs = LogManager(), JLogManager()
    for m in (mine, theirs):
        for k in range(8000):
            m.log(LEVELS[k % 5], "T", f"m{k}")
    assert len(mine.entries) == len(theirs.entries) == 4096
    assert [(e.level, e.message) for e in mine.entries] == \
        [(e.level, e.message) for e in theirs.entries]
    assert {e.level for e in mine.entries} == {"INFO", "WARN", "ERROR"}
    ts, level, typ, msg = mine.rows()[-1]
    assert re.fullmatch(r"\d{4}-\d\d-\d\d \d\d:\d\d:\d\d\.\d{3}", ts)
    assert (level, typ, msg) == ("ERROR", "T", "m7999")


def test_duckdb_logs_columns_match_the_jax_package(cons):
    jcon, tcon = cons
    mine, theirs = tcon.sql("SELECT * FROM duckdb_logs()"), jcon.sql("SELECT * FROM duckdb_logs()")
    assert mine.names == theirs.names == ["timestamp", "log_level", "type", "message"]
    assert [str(t) for t in mine.types] == [str(t) for t in theirs.types]


def _shape(rows):
    """(level, type, the message's words before its first number)."""
    return collections.Counter((lv, t, re.split(r"[~\d]", m)[0]) for lv, t, m in rows)


def test_query_log_lines_match_the_jax_package(cons):
    """One QueryLog line per SELECT, with the JAX package's words; the
    second run of a text says it took the cached plan."""
    jcon, tcon = cons
    for c in (jcon, tcon):
        for sql in ("SELECT count(*) FROM t", "SELECT g, sum(v) FROM t GROUP BY g",
                    "SELECT count(*) FROM t"):
            c.sql(sql)
    mine, theirs = logs(tcon), logs(jcon)
    assert _shape(mine) == _shape(theirs)
    assert [m for _, _, m in mine][-1].endswith("(cached plan)")
    assert re.fullmatch(r"query returned 6 rows in \d+\.\d ms", mine[1][2])


def test_checkpoint_line_matches_the_jax_package(tmp_path):
    jcon = duckdb_tpu.connect(str(tmp_path / "j.db"))
    tcon = duckdb_tpu_torch.connect(str(tmp_path / "t.db"), device="cpu")
    try:
        for c in (jcon, tcon):
            c.sql("CREATE TABLE x (a INTEGER)")
            c.sql("INSERT INTO x VALUES (1)")
            c.sql("CHECKPOINT")
        mine = logs(tcon, "type = 'Checkpoint'")
        theirs = logs(jcon, "type = 'Checkpoint'")
        assert len(mine) == len(theirs) == 1
        assert mine[0][2].startswith("checkpoint written to ") and theirs[0][2].startswith(
            "checkpoint written to ")
    finally:
        tcon.close()
        jcon.close()


def test_out_of_core_lines_match_the_jax_package(cons):
    """Under a memory limit both chunk the same select and log it as
    out_of_core; the LIKE pattern of tests/test_out_of_core.py finds it."""
    jcon, tcon = cons
    sql = "SELECT g, sum(v), count(*) FROM t GROUP BY g ORDER BY g"
    want = jcon.sql(sql).rows()
    for c in (jcon, tcon):
        c.sql("SET memory_limit = '20KB'")
    assert tcon.sql(sql).rows() == jcon.sql(sql).rows() == want
    pattern = "type = 'out_of_core' AND message LIKE 'scan working set%'"
    mine, theirs = logs(tcon, pattern), logs(jcon, pattern)
    assert mine and len(mine) == len(theirs)
    # "…: processing t in k chunks of n rows" (k follows each package's bytes)
    assert mine[0][2].split(":")[1].split(" in ")[0] == theirs[0][2].split(":")[1].split(" in ")[0]


def test_range_partition_line(cons, monkeypatch):
    """A chunked ORDER BY over more than the limit holds logs its range
    partitions (the LIKE pattern of tests/test_spill.py)."""
    _, tcon = cons
    tcon.sql("SET memory_limit = '20KB'")
    rows = tcon.sql("SELECT i, v FROM t ORDER BY v, i").rows()
    assert [r[1] for r in rows] == sorted(r[1] for r in rows)
    assert tcon.sql("SELECT count(*) FROM duckdb_logs() WHERE type='out_of_core' "
                    "AND message LIKE '%range part%'").rows() == [(1,)]


def test_string_host_loop_warns(cons, monkeypatch):
    from duckdb_tpu_torch.ops import strings as TS

    _, tcon = cons
    monkeypatch.setattr(TS, "DEVICE_STR_MIN_DICT", 2)
    monkeypatch.setattr(TS, "DEVICE_LIKE_MIN_DICT", 2)
    tcon.sql("SELECT upper(s) FROM (VALUES ('é1'), ('é2'), ('é3')) t(s)").rows()
    (level, _, msg), = logs(tcon, "type = 'StringHostLoop'")
    assert level == "WARN" and msg.endswith("over 3 distinct values ran on host (device plane "
                                            "unavailable)")


@pytest.mark.parametrize("sql,log_type,like", [
    ("SELECT t.g, count(*) FROM t JOIN d ON t.g = d.g GROUP BY t.g ORDER BY t.g",
     "exchange_join", "join repartitioned%"),
    ("SELECT a.g, count(*) FROM t a JOIN t b ON a.g = b.g WHERE a.i < 300 AND b.i < 300 "
     "GROUP BY a.g ORDER BY a.g", "exchange_join", "dup-key join repartitioned%"),
    ("SELECT i, v FROM t ORDER BY v, i", "sharded_sort", "ORDER BY range-partitioned%"),
    ("SELECT i, v FROM t ORDER BY v DESC, i LIMIT 5", "sharded_topn", "TopN%"),
    ("SELECT i, sum(v) OVER (PARTITION BY g) FROM t", "sharded_window", "window%"),
])
def test_sharded_routes_log_their_lines(cons, monkeypatch, sql, log_type, like):
    """The sharded routes' lines, with the JAX package's types and first
    words (the LIKE patterns of tests/test_distributed.py)."""
    from duckdb_tpu_torch.execution import fused_agg as TFA
    from duckdb_tpu_torch.execution import window_exec as TW

    _, tcon = cons
    monkeypatch.setattr(TFA, "build_fused_agg", lambda ex, node: None)  # eager joins
    monkeypatch.setattr(TW, "_SHARDED_MIN_ROWS", 1)
    from duckdb_tpu_torch.execution.executor import Executor

    monkeypatch.setattr(Executor, "SHARDED_SORT_MIN_ROWS", 1)
    monkeypatch.setattr(Executor, "SHARDED_TOPN_MIN_ROWS", 1)
    want = tcon.sql(sql).rows()
    tcon.sql("SET num_shards = 4")
    tcon.sql("SET exchange_join_threshold = 0")
    got = tcon.sql(sql).rows()
    assert sorted(got) == sorted(want)
    n = tcon.sql(f"SELECT count(*) FROM duckdb_logs() WHERE type = '{log_type}' "
                 f"AND message LIKE '{like}'").rows()[0][0]
    assert n >= 1


# -- the profile ----------------------------------------------------------------------------
PROFILED = [
    "SELECT sum(i) FROM t",
    "SELECT g, sum(v), count(*) FROM t WHERE i > 100 GROUP BY g ORDER BY g",
    "SELECT t.g, d.name, count(*) FROM t JOIN d ON t.g = d.g GROUP BY t.g, d.name ORDER BY 1",
    "SELECT i, v FROM t WHERE v > 40 ORDER BY i LIMIT 7",
    "SELECT g, i, row_number() OVER (PARTITION BY g ORDER BY i) FROM t WHERE i < 50",
]


def _ops(root):
    out, stack = collections.Counter(), [root]
    while stack:
        op = stack.pop()
        out[(op.name, op.cardinality)] += 1
        stack += op.children
    return out


@pytest.mark.parametrize("sql", PROFILED)
def test_explain_analyze_lists_the_jax_operators(cons, sql):
    """One explain_value row holding the profile's text; every operator of
    the JAX package's tree, with its row count, is in the port's (the port
    shows more: its root and what the JAX package's fused tail hides, S2);
    the root's rows are the query's."""
    jcon, tcon = cons
    res = tcon.sql("EXPLAIN ANALYZE " + sql)
    assert res.names == ["explain_value"] and res.nrows == 1
    jcon.sql("EXPLAIN ANALYZE " + sql)
    prof = tcon.last_profile
    assert isinstance(prof, QueryProfile) and res.rows()[0][0] == prof.render()
    mine, theirs = _ops(prof.root), _ops(jcon.last_profile.root)
    assert not theirs - mine, (theirs, mine)
    want = tcon.sql(sql).rows()
    assert prof.result.rows() == want and prof.root.cardinality == len(want)


def test_s2_profile_carries_the_query_text(cons):
    """The JAX package's profile has an empty query text (S2)."""
    jcon, tcon = cons
    sql = "SELECT g, count(*) FROM t GROUP BY g"
    text = tcon.sql("explain analyze " + sql).rows()[0][0]
    jcon.sql("EXPLAIN ANALYZE " + sql)
    assert tcon.last_profile.query == sql and sql in text.splitlines()
    assert jcon.last_profile.query == ""
    assert "Total Time:" in text and tcon.last_profile.phases.keys() == {"planning",
                                                                          "execution"}


def test_profile_times_nest(cons):
    """An operator's time holds its children's (the tree nests, and each
    time runs to the device read of its row count)."""
    _, tcon = cons
    tcon.sql("EXPLAIN ANALYZE " + PROFILED[2])
    prof = tcon.last_profile
    for op in prof.root.walk():
        assert op.time_s >= sum(c.time_s for c in op.children) * 0.999
    assert prof.total_s >= prof.root.time_s
    assert prof.to_json().startswith("{") and isinstance(prof.root, OperatorProfile)


def test_pragma_profiling_sets_the_setting(cons):
    jcon, tcon = cons
    for c in (jcon, tcon):
        c.sql("PRAGMA enable_profiling")
    assert tcon.settings.get("enable_profiling") is True
    assert jcon.settings.get("enable_profiling") is True
    tcon.sql("PRAGMA disable_profiling")
    assert tcon.sql("SELECT current_setting('enable_profiling')").rows() == [("False",)]
