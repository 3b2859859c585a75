#!/usr/bin/env python3
"""Replay the JAX package's own tests through the port, statement by
statement, and log every answer on which the two differ.

    python3 tools/shadow_jax_tests.py [--out FILE] [pytest arguments]

With no pytest arguments it runs every test file of tests/ but the port's
(test_torch_*.py), with `-m "not slow"` and four xdist workers. It is a
pytest plugin (this file, loaded with `-p shadow_jax_tests` from tools/):
each in-memory `duckdb_tpu` connection gets a twin,
`duckdb_tpu_torch.connect(device="cpu")`, that sees every `sql()` statement
and every `load_tpch()` of it (a cursor shares its database's twin). The
statement runs on the JAX connection first, as the test wrote it, and the
test goes on with the JAX package's answer; the twin's answer is compared
with `duckdb_tpu_torch.testing.fuzz.rows_differ` (DOUBLE within 1e-9
relative, everything else exact, rows as a multiset unless the text ends
in ORDER BY 1), after the JAX package's tuples inside values are read as
lists. Each difference is one JSON line in FILE (default
build/shadow_jax_tests.jsonl): the test, the statement, the kind ("rows",
"port raises", "jax raises") and what each side gave.

Tables a test fills outside SQL (the appender, Arrow, pandas, the C API,
files written by Python) are not mirrored, so statements over them differ
by construction; so do random() and now(). It imports both packages, so
the card's machine, which has no JAX, cannot run it.
"""

from __future__ import annotations

import json
import os
import sys
import weakref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(ROOT, "build", "shadow_jax_tests.jsonl")
# JAX results larger than this are not compared (reading them is slow)
MAX_ROWS = 200_000

_state = {"out": None, "test": None, "depth": 0}
_twins: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _lists(v):
    """A value with the tuples inside it read as lists (the JAX package
    gives a LIST's elements as a tuple where the port gives a list)."""
    if isinstance(v, (tuple, list)):
        return [_lists(x) for x in v]
    if isinstance(v, dict):
        return {k: _lists(x) for k, x in v.items()}
    return v


def _rows(res):
    if res is None:
        return None
    rows = res.rows() if hasattr(res, "rows") else res
    return [tuple(_lists(x) for x in r) for r in rows]


def _short(v, n=300):
    s = repr(v)
    return s if len(s) <= n else s[:n] + "…"


def _log(kind, sql, jax, port):
    if _state["out"] is None:
        return
    with open(_state["out"], "a") as f:
        f.write(json.dumps({"test": _state["test"], "sql": sql, "kind": kind,
                            "jax": _short(jax), "port": _short(port)}) + "\n")


def _twin(con):
    """The port connection beside a JAX connection (None: a file database):
    the first connection to a database gets a new port database, and each
    cursor of it a cursor of that one."""
    if con.database not in (":memory:", ""):
        return None
    twin = _twins.get(con)
    if twin is None:
        first = _twins.get(con._db)
        if first is None:
            import duckdb_tpu_torch

            twin = _twins[con._db] = duckdb_tpu_torch.connect(device="cpu")
        else:
            twin = first.cursor()
        _twins[con] = twin
    return twin


def _compare(sql, jres, jerr, twin):
    from duckdb_tpu_torch.testing.fuzz import rows_differ

    try:
        tres = twin.sql(sql)
        trows, terr = _rows(tres), None
    except Exception as err:  # noqa: BLE001 — a refusal is what is logged
        trows, terr = None, err
    if jerr is not None:
        if terr is None:
            _log("jax raises", sql, f"{type(jerr).__name__}: {jerr}", trows)
        return
    try:
        if jres is not None and getattr(jres, "nrows", 0) > MAX_ROWS:
            return
        jrows = _rows(jres)
    except Exception as err:  # noqa: BLE001 — the JAX package fails reading its rows
        if terr is None:
            _log("jax raises", sql, f"{type(err).__name__}: {err}", trows)
        return
    if terr is not None:
        _log("port raises", sql, jrows, f"{type(terr).__name__}: {terr}")
        return
    if (jrows is None) != (trows is None):
        _log("rows", sql, jrows, trows)
        return
    why = None if jrows is None else rows_differ(sql, jrows, trows)
    if why:
        _log("rows", sql, jrows, trows)


def _install():
    from duckdb_tpu.api import connection as C

    real_sql, real_load = C.Connection.sql, C.Connection.load_tpch
    if getattr(real_sql, "_shadowed", False):
        return

    def sql(self, query):
        if _state["depth"]:  # a statement the JAX package runs for itself
            return real_sql(self, query)
        twin = _twin(self)
        _state["depth"] += 1
        try:
            jres, jerr = real_sql(self, query), None
        except Exception as err:  # noqa: BLE001 — re-raised below
            jres, jerr = None, err
        finally:
            _state["depth"] -= 1
        if twin is not None:
            _compare(query, jres, jerr, twin)
        if jerr is not None:
            raise jerr
        return jres

    def load_tpch(self, data_dir, *args, **kwargs):
        out = real_load(self, data_dir, *args, **kwargs)
        twin = _twin(self)
        if twin is not None:
            try:
                twin.load_tpch(data_dir)
            except Exception as err:  # noqa: BLE001 — logged, the test goes on
                _log("port raises", f"load_tpch({data_dir!r})", None,
                     f"{type(err).__name__}: {err}")
        return out

    sql._shadowed = True
    C.Connection.sql, C.Connection.load_tpch = sql, load_tpch


# -- pytest hooks -----------------------------------------------------------------
def pytest_addoption(parser):
    parser.addoption("--shadow-out", default=DEFAULT_OUT,
                     help="JSON lines file of the differences (appended to)")


def pytest_configure(config):
    _state["out"] = config.getoption("--shadow-out")
    os.makedirs(os.path.dirname(os.path.abspath(_state["out"])), exist_ok=True)
    _install()


def pytest_runtest_setup(item):
    _state["test"] = item.nodeid


def main(argv) -> int:
    import pytest

    out = DEFAULT_OUT
    if argv[:1] == ["--out"]:
        out, argv = argv[1], argv[2:]
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    open(out, "w").close()
    if not argv:
        tests = sorted(f for f in os.listdir(os.path.join(ROOT, "tests"))
                       if f.startswith("test_") and f.endswith(".py")
                       and not f.startswith("test_torch_"))
        argv = [os.path.join("tests", f) for f in tests] + [
            "-q", "-m", "not slow", "-p", "xdist", "-n", "4", "-p", "no:cacheprovider"]
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [ROOT, os.path.join(ROOT, "tools")] + [p for p in [os.environ.get("PYTHONPATH")] if p])
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.chdir(ROOT)
    rc = pytest.main(argv + ["-p", "shadow_jax_tests", f"--shadow-out={out}"])
    n = sum(1 for _ in open(out)) if os.path.exists(out) else 0
    print(f"shadow_jax_tests: {n} difference(s) in {out}")
    return int(rc)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
