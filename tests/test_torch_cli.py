"""The port's shell, `python -m duckdb_tpu_torch.cli`, end to end through
a subprocess on the CPU (`-device cpu`): the counterparts of the cases of
tests/test_cli.py, then `.open` of a file database, the timer, `.schema`
and the JSON mode. Rows are held to the JAX package's Python API. Without
`-device` the shell opens on CUDA, so on a host with no card it exits
with the port's error.
"""

import json
import os
import subprocess
import sys

import duckdb_tpu

ROOT = os.path.join(os.path.dirname(__file__), "..")
ENV = {**os.environ, "PYTHONPATH": ROOT}


def run_cli(*args, stdin=None, device="cpu"):
    dev = ("-device", device) if device else ()
    return subprocess.run([sys.executable, "-m", "duckdb_tpu_torch.cli", *dev, *args],
                          capture_output=True, text=True, input=stdin, env=ENV, timeout=120,
                          cwd=ROOT)


def test_cli_commands():
    r = run_cli("-c", "CREATE TABLE t (a INT, b VARCHAR);",
                "-c", "INSERT INTO t VALUES (1,'x'),(2,'y');",
                "-c", "SELECT sum(a) AS s FROM t;")
    assert r.returncode == 0, r.stderr
    assert "3" in r.stdout
    assert "│ s " in r.stdout  # header rendered in a box
    assert "(1 row)" in r.stdout


def test_cli_csv_mode():
    sql = "SELECT 1 AS a, 'hi' AS b UNION ALL SELECT 2, 'yo' ORDER BY a"
    r = run_cli("-csv", "-c", sql + ";")
    assert r.returncode == 0, r.stderr
    want = duckdb_tpu.connect().sql(sql).rows()
    assert r.stdout.split() == ["a,b"] + [f"{a},{b}" for a, b in want]


def test_cli_repl_pipe():
    script = (".mode list\n"
              "CREATE TABLE t (x INT);\n"
              "INSERT INTO t VALUES (5);\n"
              "SELECT x * 2 AS d\n"
              "FROM t;\n"
              ".tables\n"
              ".quit\n")
    r = run_cli(stdin=script)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.replace("D ", "\n").replace("· ", "\n").split()
    assert "d" in lines and "10" in lines and "t" in lines
    assert "Count" not in r.stdout  # DML prints no count, as the JAX shell


def test_cli_error_handling():
    r = run_cli("-c", "SELECT nope FROM nothing;", "-c", "SELECT 7 AS x;")
    assert r.returncode == 0  # errors print, shell continues
    assert "Error" in r.stdout and "nothing" in r.stdout
    assert "│ 7 " in r.stdout.split("does not exist")[1]


def test_cli_opens_a_file_database_and_times(tmp_path):
    db = str(tmp_path / "cli_db")
    r = run_cli(db, "-c", "CREATE TABLE f AS SELECT range AS k, range % 3 AS g FROM range(30);")
    assert r.returncode == 0, r.stderr
    sql = "SELECT g, count(*), sum(k) FROM f GROUP BY g ORDER BY g"
    r = run_cli("-json", "-c", ".timer on", "-c", f".open {db}", "-c", sql + ";",
                "-c", ".schema f")
    assert r.returncode == 0, r.stderr
    body, rest = r.stdout.split("Run Time: ")
    got = [tuple(row.values()) for row in json.loads(body)]
    jcon = duckdb_tpu.connect()
    jcon.sql("CREATE TABLE f AS SELECT range AS k, range % 3 AS g FROM range(30)")
    assert got == jcon.sql(sql).rows()
    assert "CREATE TABLE f (\n  k BIGINT,\n  g BIGINT\n);" in rest


def test_cli_opens_on_cuda_unless_asked():
    r = run_cli("-c", "SELECT 1;", device=None)
    try:
        import torch

        has_cuda = torch.cuda.is_available()
    except ImportError:
        has_cuda = False
    if has_cuda:
        assert r.returncode == 0, r.stderr
    else:
        assert r.returncode != 0 and 'device="cpu"' in r.stderr
