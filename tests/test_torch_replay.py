"""The recorded corpus of the JAX package's test statements and its replay
through the port (duckdb_tpu_torch/testing/replay.py, tools/shadow_jax_tests.py).

- The committed corpus loads, its counts match its header, its sequences
  are sorted by id and carry no temporary path of the host that recorded
  them.
- The recorder, run as a pytest plugin over a tiny JAX-package test file
  written to tmp_path, records exactly that test's operations; a file it
  wrote in Python leaves its sequence out; two corpora written from the
  same sequences are the same bytes.
- A CPU-against-CPU replay of a seeded sample of the corpus, and of a file
  database's sequence (close, reopen, crash), finds no problem.
- A planted difference (a port function monkeypatched to answer wrongly,
  or to raise, on the second device's run of one statement) is reported,
  and one matching a fault of replay.KNOWN is reported apart; a wrong value
  or order under ORDER BY … LIMIT is reported, also over FAST_ROWS rows,
  and a LIMIT without ORDER BY counts apart as held to its row count.
"""

import gzip
import json
import os
import pathlib
import random
import subprocess
import sys

import pytest
import torch

from duckdb_tpu_torch.api import connection as TC
from duckdb_tpu_torch.testing import replay

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def corpus():
    return replay.load()


def test_corpus_loads_and_matches_its_header(corpus):
    header, seqs = corpus
    assert os.path.getsize(replay.CORPUS) <= 2 << 20
    assert header["sequences"] == len(seqs) > 100
    sql = [op for s in seqs for op in s["ops"] if op["op"] == "sql"]
    assert header["statements"] == len(sql) > 1000
    assert header["nondeterministic"] == sum(op.get("nd", False) for op in sql)
    assert header["recorded"] == len(seqs) + sum(header["excluded"].values()) \
        + header["duplicates_dropped"]
    assert [s["id"] for s in seqs] == sorted(s["id"] for s in seqs)
    text = json.dumps(seqs)
    assert "/tmp/" not in text and str(ROOT) not in text
    ops = {op["op"] for s in seqs for op in s["ops"]}
    assert {"connect", "cursor", "close", "crash", "sql"} <= ops
    assert any(op["op"] == "connect" and op["db"].startswith("$TMP") for s in seqs
               for op in s["ops"])  # file databases are in it


TINY = '''
import jax
jax.config.update("jax_platforms", "cpu")
import duckdb_tpu


def test_tiny(tmp_path):
    con = duckdb_tpu.connect()
    con.sql("CREATE TABLE t AS SELECT range AS a FROM range(4)")
    assert con.cursor().execute("SELECT sum(a) FROM t").fetchone() == (6,)
    db = duckdb_tpu.connect(str(tmp_path / "db"))
    db.sql("CREATE TABLE u (x INTEGER)")
    db.sql("INSERT INTO u VALUES (1), (2)")
    db.close()
    db = duckdb_tpu.connect(str(tmp_path / "db"))
    db.sql(f"COPY u TO '{tmp_path}/u.csv' (HEADER)")
    assert db.sql("SELECT count(*) FROM u").rows() == [(2,)]
    con.sql("SELECT random() < 2")


def test_python_file(tmp_path):
    (tmp_path / "p.csv").write_text("a\\n1\\n")
    con = duckdb_tpu.connect()
    con.sql(f"CREATE TABLE p AS SELECT * FROM read_csv_auto('{tmp_path}/p.csv')")
'''


def test_recorder_records_exactly_the_tests_statements(tmp_path):
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import shadow_jax_tests as SH
    finally:
        sys.path.remove(str(ROOT / "tools"))
    (tmp_path / "test_tiny_jax.py").write_text(TINY)
    (tmp_path / "tmp").mkdir()  # the inner run's temporary files and twins stay in tmp_path
    env = dict(os.environ, JAX_PLATFORMS="cpu", TMPDIR=str(tmp_path / "tmp"),
               PYTHONPATH=os.pathsep.join([str(ROOT), str(ROOT / "tools")] + [
                   p for p in [os.environ.get("PYTHONPATH")] if p]))
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "no:randomly",
         "--rootdir", str(tmp_path), "-p", "shadow_jax_tests",
         f"--shadow-out={tmp_path / 'diff.jsonl'}",
         f"--shadow-record={tmp_path / 'part'}", str(tmp_path / "test_tiny_jax.py")],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    seqs = [json.loads(line) for line in (tmp_path / "part.main").read_text().splitlines()]
    assert [s["id"] for s in seqs] == ["test_tiny_jax.py::test_tiny#0",
                                       "test_tiny_jax.py::test_tiny#1",
                                       "test_tiny_jax.py::test_python_file#0"]
    mem, db, py = seqs
    assert [(op["op"], op.get("q")) for op in mem["ops"]] == [
        ("connect", None), ("sql", "CREATE TABLE t AS SELECT range AS a FROM range(4)"),
        ("cursor", None), ("sql", "SELECT sum(a) FROM t"), ("sql", "SELECT random() < 2")]
    assert mem["ops"][4]["nd"] and mem["ops"][2]["of"] == 0 and mem["ops"][2]["con"] == 1
    assert [(op["op"], op.get("q"), op.get("db")) for op in db["ops"]] == [
        ("connect", None, "$TMP0/db"), ("sql", "CREATE TABLE u (x INTEGER)", None),
        ("sql", "INSERT INTO u VALUES (1), (2)", None), ("close", None, None),
        ("connect", None, "$TMP0/db"), ("sql", "COPY u TO '$TMP0/u.csv' (HEADER)", None),
        ("sql", "SELECT count(*) FROM u", None)]
    assert "excluded" not in mem and "excluded" not in db
    assert py["excluded"] == SH.PYTHON_FILE
    logged = [json.loads(line) for line in (tmp_path / "diff.jsonl").read_text().splitlines()]
    assert {d["kind"] for d in logged} == {"not compared: nondeterministic",
                                           "not mirrored: a file written in Python"}
    # the corpus: the kept sequences, sorted, the same bytes twice
    header = SH.write_corpus([str(tmp_path / "part.main")], str(tmp_path / "a.jsonl.gz"))
    SH.write_corpus([str(tmp_path / "part.main")], str(tmp_path / "b.jsonl.gz"))
    assert (tmp_path / "a.jsonl.gz").read_bytes() == (tmp_path / "b.jsonl.gz").read_bytes()
    assert header["sequences"] == 2 and header["statements"] == 7
    assert header["excluded"] == {SH.PYTHON_FILE: 1}
    h, kept = replay.load(str(tmp_path / "a.jsonl.gz"))
    assert h == header and [s["id"] for s in kept] == [s["id"] for s in seqs[:2]]
    report = replay.replay(kept, ("cpu", "cpu"), str(tmp_path / "work"))
    assert report.problems == [] and report.statements == 7 and report.nondeterministic == 1


def test_cpu_replay_of_a_seeded_sample_finds_no_problem(corpus, tmp_path):
    _, seqs = corpus
    picked = sorted(random.Random(1).sample(range(len(seqs)), 40))
    report = replay.replay([seqs[i] for i in picked], ("cpu", "cpu"), str(tmp_path))
    assert report.problems == [], report.problems[:3]
    assert report.sequences == 40 and report.compared > 0 and report.refused > 0
    assert not any(p.startswith(str(tmp_path)) for p in TC._OPEN_DBS)


FILE_SEQ = {"id": "file#0", "tests": ["t"], "ops": [
    {"op": "connect", "con": 0, "db": "$TMP0/db"},
    {"op": "sql", "con": 0, "q": "CREATE TABLE t AS SELECT range AS a, range % 3 AS g "
                                 "FROM range(100)"},
    {"op": "cursor", "con": 1, "of": 0},
    {"op": "sql", "con": 1, "q": "SELECT g, sum(a) FROM t GROUP BY g"},
    {"op": "close", "con": 1}, {"op": "close", "con": 0},
    {"op": "connect", "con": 2, "db": "$TMP0/db"},
    {"op": "sql", "con": 2, "q": "INSERT INTO t VALUES (7, 7)"},
    {"op": "crash", "db": "$TMP0/db"},
    {"op": "connect", "con": 3, "db": "$TMP0/db"},
    {"op": "sql", "con": 3, "q": "SELECT count(*), sum(a) FROM t"},
    {"op": "sql", "con": 3, "q": "SELECT * FROM nope"},
    {"op": "sql", "con": 3, "q": "SELECT random() FROM t", "nd": True}]}


def test_a_file_database_sequence_replays_alike(tmp_path):
    report = replay.replay([FILE_SEQ], ("cpu", "cpu"), str(tmp_path))
    assert report.problems == []
    assert report.counts() == {"sequences": 1, "statements": 6, "compared": 3, "count_only": 0,
                               "answered": 5, "refused": 1, "nondeterministic": 1,
                               "problems": 0, "known": 0}


_REAL_SQL = TC.Connection.sql


def _planted(monkeypatch, target, plant):
    """Connection.sql answering `target` through plant(result) on its second
    run (the second device's)."""
    real, runs = _REAL_SQL, []

    def sql(self, query):
        res = real(self, query)
        if query == target:
            runs.append(query)
            if len(runs) % 2 == 0:
                return plant(res)
        return res
    monkeypatch.setattr(TC.Connection, "sql", sql)


def test_a_planted_difference_is_reported(monkeypatch, tmp_path):
    target = "SELECT count(*), sum(a) FROM t"

    def fewer(res):
        res.nrows = 0
        return res
    _planted(monkeypatch, target, fewer)
    report = replay.replay([FILE_SEQ], ("cpu", "cpu"), str(tmp_path / "a"))
    assert [(p[0], p[1]) for p in report.problems] == [("file#0", target)]
    assert "row count 1 != 0" in report.problems[0][2]

    def untyped(res):
        raise RuntimeError("planted")
    _planted(monkeypatch, target, untyped)
    report = replay.replay([FILE_SEQ], ("cpu", "cpu"), str(tmp_path / "b"))
    assert [p[2] for p in report.problems] == ["cpu: RuntimeError: planted"]
    monkeypatch.setattr(replay, "KNOWN", [("Z1", "a planted fault",
                                           lambda sid, sql: sql == target)])
    report = replay.replay([FILE_SEQ], ("cpu", "cpu"), str(tmp_path / "c"))
    assert report.problems == [] and [k[0] for k in report.known] == ["Z1"]


def _ordered_seq(q):
    return {"id": "ordered#0", "tests": ["t"], "ops": [
        {"op": "connect", "con": 0, "db": ":memory:"},
        {"op": "sql", "con": 0, "q": "CREATE TABLE t AS SELECT range AS a, range % 7 AS g, "
                                     "range * 0.5 AS x FROM range(30000)"},
        {"op": "sql", "con": 0, "q": q}]}


def _wrong_value(res):
    """The last column's value at row 1 one more."""
    vals, valid, dvals = res.columns[-1]
    vals = vals.copy()
    vals[1] += 1
    res.columns[-1] = (vals, valid, dvals)
    return res


def _swapped(res):
    """Rows 1 and 2 swapped in every column."""
    cols = []
    for vals, valid, dvals in res.columns:
        vals = vals.copy()
        vals[[1, 2]] = vals[[2, 1]]
        cols.append((vals, valid, dvals))
    res.columns = cols
    return res


@pytest.mark.parametrize("q,plant,found", [
    ("SELECT a, g FROM t ORDER BY a LIMIT 5", _wrong_value, "rows 1-1"),
    ("SELECT a, g FROM t ORDER BY a LIMIT 5", _swapped, "ORDER BY's columns differ at row 1"),
    ("SELECT g, a, x FROM t ORDER BY g DESC, a LIMIT 100", _wrong_value, "rows 1-1"),
    ("SELECT g, a, x FROM t ORDER BY g DESC, a LIMIT 100", _swapped, "differ at row 1"),
    ("SELECT g, x FROM t ORDER BY g LIMIT 100", _wrong_value, "rows 0-99"),
    ("SELECT a, g, x FROM t ORDER BY t.a LIMIT 20000", _wrong_value, "rows 1-1"),
    ("SELECT a, g, x FROM t ORDER BY 1 DESC LIMIT 20000", _swapped, "differ at row 1"),
    ("SELECT a, x FROM t ORDER BY a + 1 LIMIT 5", _wrong_value, "as multisets"),
])
def test_a_wrong_answer_under_order_by_limit_is_reported(monkeypatch, tmp_path, q, plant,
                                                         found):
    """Every column counts under ORDER BY … LIMIT: a value off by one, or two
    rows swapped, on the second device is a problem (over FAST_ROWS rows
    too, where numpy compares first)."""
    _planted(monkeypatch, q, plant)
    report = replay.replay([_ordered_seq(q)], ("cpu", "cpu"), str(tmp_path))
    assert [p[1] for p in report.problems] == [q]
    assert found in report.problems[0][2]
    monkeypatch.setattr(TC.Connection, "sql", _REAL_SQL)
    report = replay.replay([_ordered_seq(q)], ("cpu", "cpu"), str(tmp_path))
    assert report.problems == [] and report.compared == 1 and report.count_only == 0


def test_a_limit_without_order_by_is_held_to_its_row_count_apart(monkeypatch, tmp_path):
    q = "SELECT a, g FROM t LIMIT 5"
    _planted(monkeypatch, q, _wrong_value)
    report = replay.replay([_ordered_seq(q)], ("cpu", "cpu"), str(tmp_path))
    assert report.problems == [] and report.compared == 0 and report.count_only == 1
    q = "SELECT a, g FROM t WHERE a < 3 LIMIT 5"  # fewer rows than the LIMIT: all of them
    _planted(monkeypatch, q, _wrong_value)
    report = replay.replay([_ordered_seq(q)], ("cpu", "cpu"), str(tmp_path))
    assert [p[1] for p in report.problems] == [q] and report.count_only == 0


@pytest.mark.parametrize("q,names,want", [
    ("SELECT * FROM t ORDER BY g, o LIMIT 5", ["o", "g"], ([1, 0], 5, False)),
    ("SELECT * FROM (SELECT * FROM t ORDER BY s LIMIT 9) ORDER BY s, \"I\" DESC NULLS "
     "FIRST LIMIT 100 OFFSET 2;", ["i", "s"], ([1, 0], 100, True)),
    ("SELECT x, row_number() OVER (ORDER BY y) FROM t LIMIT 3", ["x", "r"], (None, 3, False)),
    ("SELECT 'ORDER BY x' AS x FROM t LIMIT 10%", ["x"], (None, -1, False)),
    ("SELECT a, b FROM t ORDER BY ALL", ["a", "b"], ([0, 1], None, False)),
    ("SELECT a FROM t ORDER BY lower(a) FETCH FIRST 3 ROWS ONLY", ["a"], (None, -1, False)),
    ("SELECT a FROM t ORDER BY b", ["a"], (None, None, False)),
])
def test_the_closing_order_by_and_limit_are_read(q, names, want):
    items, limit, offset = replay.order_of(q)
    keys = None if items is None else replay.key_columns(items, names)
    assert (keys, limit, offset) == want


def test_corpus_gzip_has_no_timestamp():
    with open(replay.CORPUS, "rb") as f:
        raw = f.read(10)
    assert raw[:2] == b"\x1f\x8b" and raw[4:8] == b"\0\0\0\0"  # mtime 0
    with gzip.open(replay.CORPUS, "rt") as f:
        assert json.loads(f.readline())["corpus"].startswith("the JAX package's")
