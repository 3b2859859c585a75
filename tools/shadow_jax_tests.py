#!/usr/bin/env python3
"""Replay the JAX package's own tests through the port, statement by
statement, log every answer on which the two differ, and record the
statements as a corpus the port replays on its own.

    python3 tools/shadow_jax_tests.py [--out FILE] [--record CORPUS] [pytest arguments]

With no pytest arguments it runs every test file of tests/ but the port's
(test_torch_*.py), with `-m "not slow"`, four xdist workers and
`--dist loadfile`. It is a pytest plugin (this file, loaded with
`-p shadow_jax_tests` from tools/): each `duckdb_tpu` connection a test
opens gets a twin, a `duckdb_tpu_torch` connection on the CPU, that sees
every `sql()` / `execute()` / `query()` statement, `load_tpch()`,
`cursor()` and `close()` of it:

- an in-memory database gets a new port database, and each cursor of it a
  cursor of that one;
- a file database gets the port database at the same path inside a mirror
  tree (`shadow_twin/` under the system's temporary directory for paths
  there, `build/shadow_twin/` for others), so base names, and with them
  current_database() and ATTACH's aliases, stay the same. A reopen after
  close() reopens the twin; a reopen after the test dropped the JAX
  package's registry of open databases (a simulated crash) drops the
  twin's too, so that both recover from their files. Temporary paths inside
  a statement (ATTACH, COPY, EXPORT, read_csv …) are mapped the same way.

The statement runs on the JAX connection first, as the test wrote it, and
the test goes on with the JAX package's answer; the twin's answer is
compared with `duckdb_tpu_torch.testing.replay.rows_differ` (DOUBLE within
1e-9 relative, everything else exact, every column, rows as a multiset and
in order where a closing ORDER BY over result columns fixes it; a LIMIT
without ORDER BY only by row count, logged "not compared: LIMIT without
ORDER BY …"), after the JAX package's tuples inside values are read as
lists. Each difference is one JSON line in FILE (default
build/shadow_jax_tests.jsonl): the test, the statement, the kind ("rows",
"port raises", "jax raises") and what each side gave.

Not compared, and logged by kind: statements over state the twin never saw
("not mirrored: …": a table the appender, from_df or from_arrow filled, a
table made outside SQL, a file the test wrote, edited or removed in Python,
a twin that could not open), and statements whose answer is not
deterministic ("not compared: nondeterministic": random(), now() and the
current_* functions, uuids, samples without REPEATABLE, duckdb_logs(),
EXPLAIN ANALYZE's timings, and every statement after such a one that
writes).

With --record, each database's operations (its connections and cursors,
their statements in order, load_tpch directories, closes and simulated
crashes; a file database across its reopens and the databases it
ATTACHes) become one sequence of CORPUS, gzip JSON lines sorted by the
node id of the test that opened the database, temporary paths written as
$TMP0, $TMP1, … and the repository's as $ROOT. Sequences that need a file
not in the repository, a file written in Python or a table filled outside
SQL are left out and counted by reason in the first line.
`duckdb_tpu_torch/testing/replay.py` replays the corpus through the port
on two devices. The plugin imports both packages, so the card's machine,
which has no JAX, cannot run it.
"""

from __future__ import annotations

import fnmatch
import glob
import gzip
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import weakref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(ROOT, "build", "shadow_jax_tests.jsonl")
# JAX results larger than this are not compared (reading them is slow)
MAX_ROWS = 200_000
TMP = os.path.realpath(tempfile.gettempdir())
MIRROR = os.path.join(TMP, "shadow_twin")
MIRROR_OTHER = os.path.join(ROOT, "build", "shadow_twin")
# why a sequence is left out of the corpus
NOT_IN_REPO = "needs a file not in the repository"
PYTHON_FILE = "needs a file written in Python"
OUTSIDE_SQL = "a table filled outside SQL"

_state = {"out": None, "record": None, "test": None, "depth": 0, "order": 0, "cons": 0}
_info: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()  # JAX con → (twin, group, id)
_db_twin: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()  # JAX Database → twin
_path_group: dict = {}  # a file database's real path → its group
_groups: list = []
_py_written: set = set()  # temporary paths the tests wrote, edited or removed in Python
_test_groups: dict = {}  # test → groups it opened

_LITERAL = re.compile(r"'((?:[^']|'')*)'")
_TMP_ROOT = re.compile(re.escape(TMP) + r"/(?:pytest-of-[^/]+/pytest-\d+/(?:popen-gw\d+/)?)?"
                       r"[^/'\"\s]+")
_NONDET = re.compile(
    r"\b(random|now|current_date|current_time|current_timestamp|get_current_time|"
    r"get_current_timestamp|localtime|localtimestamp|today|uuid\w*|gen_random_uuid|setseed|"
    r"txid_current|current_query|duckdb_logs|duckdb_memory|pragma_database_size)\b|"
    r"\bEXPLAIN\s+ANALY[SZ]E\b", re.I)
_SAMPLE = re.compile(r"\b(TABLESAMPLE|USING\s+SAMPLE)\b", re.I)
_READS = re.compile(r"^\s*\(*\s*(SELECT|WITH|FROM|VALUES|EXPLAIN|DESCRIBE|SHOW|SUMMARIZE|"
                    r"PRAGMA|TABLE)\b", re.I)


def nondeterministic(sql: str) -> bool:
    """Whether a statement's answer may differ between two runs of it."""
    return bool(_NONDET.search(sql)) or (bool(_SAMPLE.search(sql))
                                         and not re.search(r"\bREPEATABLE\b", sql, re.I))


# -- groups: one database's operations ------------------------------------------------
class _Group:
    """One database the twin mirrors: an in-memory database and its
    cursors, or a file database across its reopens. Groups that ATTACH one
    another merge (`root`)."""

    def __init__(self):
        self.test = _state["test"] or ""
        self.index = len(_test_groups.setdefault(self.test, []))
        _test_groups[self.test].append(self)
        self.ops = []  # (order, test, op)
        self.parent = None
        self.excluded = None  # why the sequence is left out of the corpus
        self.tainted = None  # the kind of state the twin never saw
        self.nd = False  # a nondeterministic statement wrote
        self.paths = set()  # its file databases' real paths
        _groups.append(self)

    def root(self) -> "_Group":
        g = self
        while g.parent is not None:
            g = g.parent
        return g

    def union(self, other: "_Group"):
        a, b = self.root(), other.root()
        if a is b:
            return
        first, second = sorted((a, b), key=lambda g: (g.test, g.index))
        second.parent = first
        first.ops += second.ops
        first.paths |= second.paths
        first.excluded = first.excluded or second.excluded
        first.tainted = first.tainted or second.tainted
        first.nd = first.nd or second.nd

    def add(self, op: dict):
        _state["order"] += 1
        self.root().ops.append((_state["order"], _state["test"] or self.test, op))

    @staticmethod
    def new_id() -> int:
        """A connection's number, unique in the process (a sequence's are
        renumbered from 0 when it is written)."""
        _state["cons"] += 1
        return _state["cons"]

    def taint(self, kind: str, reason: str):
        r = self.root()
        r.tainted = r.tainted or kind
        r.excluded = r.excluded or reason


# -- paths ---------------------------------------------------------------------------
def _real(path: str) -> str:
    return os.path.realpath(os.path.abspath(path))


def _is_tmp(path: str) -> bool:
    p = _real(path)
    return p.startswith(TMP + os.sep) and not p.startswith(MIRROR + os.sep)


def mirror(path: str) -> str:
    """The twin's path of a JAX-side path: the same path under the mirror
    tree (a temporary path's under MIRROR, another's under MIRROR_OTHER)."""
    p = _real(path)
    if p.startswith(TMP + os.sep):
        return os.path.join(MIRROR, os.path.relpath(p, TMP))
    return os.path.join(MIRROR_OTHER, p.lstrip(os.sep))


def _ensure_parent(path: str):
    parent = os.path.dirname(_real(path))
    if os.path.isdir(parent):
        os.makedirs(mirror(parent), exist_ok=True)


_tracked = None


def _in_repo(path: str) -> bool:
    """Whether a path is a file, or a directory of files, that git tracks."""
    global _tracked
    if _tracked is None:
        out = subprocess.run(["git", "ls-files", "-z"], cwd=ROOT, capture_output=True).stdout
        _tracked = {os.path.join(ROOT, f) for f in out.decode().split("\0") if f}
        _tracked |= {os.path.dirname(f) for f in list(_tracked)}
    p = _real(path)
    return p in _tracked or any(f in _tracked for f in glob.glob(p))


def _path_literals(sql: str):
    """The string literals of a statement that name files: temporary
    paths, and other absolute paths or paths that exist."""
    out = []
    for m in _LITERAL.finditer(sql):
        s = m.group(1).replace("''", "'")
        if not s or "\n" in s or len(s) > 4096:
            continue
        if s.startswith(os.sep) or (os.sep in s and (os.path.exists(s) or glob.glob(s))):
            out.append(s)
    return out


def _twin_sql(sql: str) -> str:
    """The statement with its temporary paths moved into the mirror tree."""
    def sub(m):
        s = m.group(1).replace("''", "'")
        if s.startswith(os.sep) and _is_tmp(s.split("*")[0] or s):
            _ensure_parent(s)
            if os.path.isdir(s):
                os.makedirs(mirror(s), exist_ok=True)
            return "'" + mirror(s).replace("'", "''") + "'"
        return m.group(0)
    return _LITERAL.sub(sub, sql)


def _check_paths(group: _Group, sql: str):
    """Before a statement runs: merge the groups of the file databases it
    names (ATTACH), and mark the group where it reads a file the test
    wrote in Python or a file the corpus cannot carry."""
    for s in _path_literals(sql):
        if not _is_tmp(s.split("*")[0] or s):
            if not _in_repo(s):
                r = group.root()
                r.excluded = r.excluded or NOT_IN_REPO
            continue
        p = _real(s)
        other = _path_group.get(p)
        if other is not None:
            group.union(other)
            continue
        hit = [w for w in _py_written if w == p or w.startswith(p + os.sep)
               or (("*" in s or "?" in s) and fnmatch.fnmatch(w, p))]
        if hit:
            group.taint("not mirrored: a file written in Python", PYTHON_FILE)
    for path in group.root().paths:
        if any(w == path or w.startswith(path + os.sep) for w in _py_written):
            group.taint("not mirrored: database files edited in Python", PYTHON_FILE)


def _note_write(path, *_):
    try:
        p = os.fspath(path)
        p = _real(p.decode() if isinstance(p, bytes) else p)
    except (TypeError, ValueError):
        return
    if _state["depth"] == 0 and p.startswith(TMP + os.sep) \
            and not p.startswith(MIRROR + os.sep):
        _py_written.add(p)


def _watch_python_writes():
    """Record the temporary paths that test code (not the JAX package inside
    a statement) opens for writing, truncates, moves or removes."""
    import builtins
    import io

    real_open = builtins.open

    def open_(file, mode="r", *a, **k):
        if isinstance(file, (str, bytes, os.PathLike)) and any(c in mode for c in "wax+"):
            _note_write(file)
        return real_open(file, mode, *a, **k)

    builtins.open = io.open = open_

    def wrap(mod, name, paths=1):
        real = getattr(mod, name)

        def f(*a, **k):
            for x in a[:paths]:
                _note_write(x)
            return real(*a, **k)
        setattr(mod, name, f)

    for name in ("truncate", "remove", "unlink"):
        wrap(os, name)
    for name in ("rename", "replace"):
        wrap(os, name, 2)
    wrap(shutil, "rmtree")


# -- the JAX package's connection, watched ---------------------------------------------
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


def _open_twin(con, database, cursor_of_db, fresh):
    """The twin of a JAX connection just opened (at depth 0)."""
    import duckdb_tpu_torch
    from duckdb_tpu_torch.api import connection as TC

    if cursor_of_db is not None:
        first = _db_twin.get(cursor_of_db)
        parent = next((v for k, v in _info.items() if k._db is cursor_of_db), None)
        if first is None or parent is None:
            return
        group = parent[1]
        cid = group.new_id()
        group.add({"op": "cursor", "con": cid, "of": parent[2]})
        _info[con] = (first.cursor(), group, cid)
        return
    if database in (":memory:", ""):
        group = _Group()
        cid = group.new_id()
        group.add({"op": "connect", "con": cid, "db": ":memory:"})
        twin = duckdb_tpu_torch.connect(device="cpu")
    else:
        real = _real(database)
        group = _path_group.get(real) or _Group()
        _path_group[real] = group
        group.root().paths.add(real)
        _check_paths(group, "'" + real.replace("'", "''") + "'")
        path = mirror(real)
        if fresh and path in TC._OPEN_DBS:
            del TC._OPEN_DBS[path]  # the test dropped the JAX registry: a crash
            group.add({"op": "crash", "db": real})
        cid = group.new_id()
        group.add({"op": "connect", "con": cid, "db": real})
        _ensure_parent(real)
        try:
            twin = duckdb_tpu_torch.connect(path, device="cpu")
        except Exception as err:  # noqa: BLE001 — the twin is then missing, and said so
            group.taint(f"not mirrored: the twin could not open ({type(err).__name__})",
                        OUTSIDE_SQL)
            _log("port raises", f"connect({database!r})", None, f"{type(err).__name__}: {err}")
            _info[con] = (None, group, cid)
            return
    _db_twin.setdefault(con._db, twin)
    _info[con] = (twin, group, cid)


def _twin(con):
    """The twin of a JAX connection (None: it could not open), made now for
    a connection opened before the plugin watched it."""
    if con not in _info:
        _open_twin(con, con.database, con._db if con._db in _db_twin else None, False)
    info = _info.get(con)
    return info[0] if info else None


def _compare(sql, jres, jerr, twin, twin_sql=None):
    from duckdb_tpu_torch.testing.replay import rows_differ

    try:
        tres = twin.sql(sql if twin_sql is None else twin_sql)
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
    if jrows is None:
        return
    why, how = rows_differ(sql, tres.names, jrows, trows)
    if why:
        _log("rows", sql, jrows, trows)
    elif how == "count":
        _log("not compared: LIMIT without ORDER BY (row counts only)", sql, None, None)


def _visible(tables) -> set:
    return {n for n in tables if not n.startswith("__")}


def _install():
    from duckdb_tpu.api import connection as C

    real_init, real_sql, real_load = C.Connection.__init__, C.Connection.sql, \
        C.Connection.load_tpch
    real_close = C.Connection.close
    if getattr(real_sql, "_shadowed", False):
        return

    def init(self, database: str = ":memory:", _db=None):
        if _state["depth"]:  # a connection the JAX package opens for itself
            return real_init(self, database, _db)
        fresh = _db is None and database not in (":memory:", "") and not (
            C._abspath(database) in C._OPEN_DBS and os.path.exists(C._abspath(database)))
        _state["depth"] += 1
        try:
            real_init(self, database, _db)
        finally:
            _state["depth"] -= 1
        _open_twin(self, database, _db, fresh)

    def sql(self, query):
        info = _info.get(self)
        if _state["depth"] or info is None:
            return real_sql(self, query)
        twin, group, cid = info
        _check_paths(group, query)
        root = group.root()
        nd = nondeterministic(query) or root.nd
        if nd and not _READS.match(query):
            root.nd = True  # what it wrote differs between runs
        group.add({"op": "sql", "con": cid, "q": query, **({"nd": True} if nd else {})})
        if twin is not None and root.tainted is None and \
                _visible(self.catalog.tables) - _visible(twin.catalog.tables):
            group.taint("not mirrored: a table made outside SQL", OUTSIDE_SQL)
        twin_query = _twin_sql(query) if twin is not None else query
        _state["depth"] += 1
        try:
            jres, jerr = real_sql(self, query), None
        except Exception as err:  # noqa: BLE001 — re-raised below
            jres, jerr = None, err
        finally:
            _state["depth"] -= 1
        if twin is not None:
            if root.tainted is not None:
                _log(root.tainted, query, None, None)
            elif nd:
                _log("not compared: nondeterministic", query, None, None)
                try:
                    twin.sql(twin_query)
                except Exception:  # noqa: BLE001 — its refusal is not compared either
                    pass
            else:
                _compare(query, jres, jerr, twin, twin_query)
        if jerr is not None:
            raise jerr
        return jres

    def load_tpch(self, data_dir, *args, **kwargs):
        _state["depth"] += 1
        try:
            out = real_load(self, data_dir, *args, **kwargs)
        finally:
            _state["depth"] -= 1
        info = _info.get(self)
        if info is None or _state["depth"]:
            return out
        twin, group, cid = info
        group.add({"op": "load_tpch", "con": cid, "dir": _real(data_dir)})
        if not _in_repo(data_dir):
            r = group.root()
            r.excluded = r.excluded or NOT_IN_REPO
        if twin is not None:
            try:
                twin.load_tpch(data_dir)
            except Exception as err:  # noqa: BLE001 — logged, the test goes on
                _log("port raises", f"load_tpch({data_dir!r})", None,
                     f"{type(err).__name__}: {err}")
        return out

    def close(self):
        _state["depth"] += 1
        try:
            real_close(self)
        finally:
            _state["depth"] -= 1
        info = _info.get(self)
        if info is not None and not _state["depth"]:
            twin, group, cid = info
            group.add({"op": "close", "con": cid})
            if twin is not None:
                try:
                    twin.close()
                except Exception as err:  # noqa: BLE001 — logged, the test goes on
                    _log("port raises", "close()", None, f"{type(err).__name__}: {err}")

    def outside(kind, real):
        def f(self, *a, **k):
            info = _info.get(self)
            if info is not None and not _state["depth"]:
                info[1].taint(f"not mirrored: {kind}", OUTSIDE_SQL)
            return real(self, *a, **k)
        return f

    sql._shadowed = True
    C.Connection.__init__ = init
    C.Connection.sql = C.Connection.execute = C.Connection.query = sql
    C.Connection.load_tpch, C.Connection.close = load_tpch, close
    for name in ("appender", "from_df", "from_arrow"):
        setattr(C.Connection, name, outside(name, getattr(C.Connection, name)))
    _watch_python_writes()


# -- the corpus ----------------------------------------------------------------------
def _placeholders(ops):
    """A sequence's operations with temporary paths as $TMP<k> (numbered by
    first appearance) and the repository's root as $ROOT."""
    roots = {}

    def sub(text):
        text = _TMP_ROOT.sub(lambda m: roots.setdefault(m.group(0), f"$TMP{len(roots)}"), text)
        return text.replace(ROOT + os.sep, "$ROOT/")

    out = []
    for op in ops:
        op = dict(op)
        for key in ("q", "db", "dir"):
            if key in op and op[key] != ":memory:":
                op[key] = sub(op[key])
        out.append(op)
    return out


def _sequences():
    """The worker's recorded sequences: [(sort key, record)]."""
    out = []
    for g in _groups:
        if g.parent is not None or not g.ops:
            continue
        ops = sorted(g.ops, key=lambda o: o[0])
        tests = []
        for _, t, _ in ops:
            if t not in tests:
                tests.append(t)
        ids = {}
        for _, _, op in ops:
            if "con" in op:
                ids.setdefault(op["con"], len(ids))
        rec = {"id": f"{g.test}#{g.index}", "tests": tests, "ops": _placeholders([
            dict(op, t=tests.index(t), **{k: ids[op[k]] for k in ("con", "of") if k in op})
            for _, t, op in ops])}
        if g.excluded:
            rec["excluded"] = g.excluded
        out.append(rec)
    return out


def write_corpus(parts, path: str) -> dict:
    """Merge the workers' sequence files into one gzip JSON lines corpus:
    a header line with the counts, then the kept sequences sorted by id
    (the same tree gives the same bytes). → the header."""
    seqs = []
    for p in parts:
        with open(p) as f:
            seqs += [json.loads(line) for line in f if line.strip()]
    seqs.sort(key=lambda s: s["id"])
    kept = [s for s in seqs if "excluded" not in s]
    excluded = {}
    for s in seqs:
        if "excluded" in s:
            excluded[s["excluded"]] = excluded.get(s["excluded"], 0) + 1
    # whole sequences identical statement for statement count once
    seen, unique, dropped = set(), [], 0
    for s in kept:
        key = json.dumps([{k: v for k, v in op.items() if k != "t"} for op in s["ops"]])
        if key in seen:
            dropped += 1
            continue
        seen.add(key)
        unique.append(s)
    header = {"corpus": "the JAX package's test statements (tools/shadow_jax_tests.py)",
              "sequences": len(unique),
              "statements": sum(op["op"] == "sql" for s in unique for op in s["ops"]),
              "nondeterministic": sum(op["op"] == "sql" and op.get("nd", False)
                                      for s in unique for op in s["ops"]),
              "recorded": len(seqs), "excluded": dict(sorted(excluded.items())),
              "duplicates_dropped": dropped}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as raw, gzip.GzipFile(fileobj=raw, mode="wb", mtime=0,
                                                filename="") as f:
        f.write((json.dumps(header, sort_keys=True) + "\n").encode())
        for s in unique:
            s = {k: v for k, v in s.items() if k != "excluded"}
            f.write((json.dumps(s, sort_keys=True, ensure_ascii=False) + "\n").encode())
    return header


# -- pytest hooks -----------------------------------------------------------------
def pytest_addoption(parser):
    parser.addoption("--shadow-out", default=DEFAULT_OUT,
                     help="JSON lines file of the differences (appended to)")
    parser.addoption("--shadow-record", default=None,
                     help="file prefix for the recorded sequences of each worker")


def pytest_configure(config):
    _state["out"] = config.getoption("--shadow-out")
    _state["record"] = config.getoption("--shadow-record")
    os.makedirs(os.path.dirname(os.path.abspath(_state["out"])), exist_ok=True)
    _install()


def pytest_runtest_protocol(item, nextitem):
    _state["test"] = item.nodeid


def pytest_sessionfinish(session):
    prefix = _state["record"]
    if not prefix:
        return
    worker = getattr(session.config, "workerinput", {}).get("workerid", "main")
    with open(f"{prefix}.{worker}", "w") as f:
        for rec in _sequences():
            f.write(json.dumps(rec, sort_keys=True, ensure_ascii=False) + "\n")


def main(argv) -> int:
    import pytest

    out, record = DEFAULT_OUT, None
    while argv[:1] in (["--out"], ["--record"]):
        if argv[0] == "--out":
            out = argv[1]
        else:
            record = os.path.abspath(argv[1])
        argv = argv[2:]
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    open(out, "w").close()
    if not argv:
        tests = sorted(f for f in os.listdir(os.path.join(ROOT, "tests"))
                       if f.startswith("test_") and f.endswith(".py")
                       and not f.startswith("test_torch_"))
        argv = [os.path.join("tests", f) for f in tests] + [
            "-q", "-m", "not slow", "-p", "xdist", "-n", "4", "--dist", "loadfile",
            "-p", "no:cacheprovider", "-p", "no:randomly"]
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [ROOT, os.path.join(ROOT, "tools")] + [p for p in [os.environ.get("PYTHONPATH")] if p])
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.chdir(ROOT)
    shutil.rmtree(MIRROR, ignore_errors=True)
    extra = ["-p", "shadow_jax_tests", f"--shadow-out={out}"]
    parts_dir = None
    if record:
        parts_dir = tempfile.mkdtemp(prefix="shadow_record_")
        extra.append(f"--shadow-record={os.path.join(parts_dir, 'part')}")
    rc = pytest.main(argv + extra)
    n = sum(1 for _ in open(out)) if os.path.exists(out) else 0
    print(f"shadow_jax_tests: {n} line(s) in {out}")
    if record:
        parts = sorted(glob.glob(os.path.join(parts_dir, "part.*")))
        header = write_corpus(parts, record)
        shutil.rmtree(parts_dir, ignore_errors=True)
        print(f"shadow_jax_tests: corpus {record} ({os.path.getsize(record)} bytes): "
              f"{json.dumps(header)}")
    shutil.rmtree(MIRROR, ignore_errors=True)
    return int(rc)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
