"""sqllogictest runner: the port's copy of the JAX package's
(duckdb_tpu/testing/sqllogic.py).

DuckDB's primary harness (~4,600 scripts,
duckdb/test/sqlite/sqllogic_test_runner.cpp, sqllogic_parser.cpp
:322-350) uses the extended SQLite format. This runner implements the
load-bearing directives so the same corpus format drives the port:

  statement ok | statement error [match] | statement maybe
  query <types> [rowsort|valuesort|nosort] [label]
  ----  (expected rows; empty block = no rows; or "N values hashing to MD5")
  loop/endloop, foreach/endloop substitution
  concurrentloop (threaded connections sharing the database)
  load <path> [readonly]   (a file database, deleted first unless
                            readonly)
  restart                  (close, which checkpoints, then reopen)
  require <ext>            (skipped unless builtin)
  require-env NAME [value]
  sleep N (msec|sec)
  skipif <system> / onlyif <system>  (we answer to "duckdb")
  mode skip / unskip, halt, hash-threshold N

Substitutions: __TEST_DIR__ (per-run temp dir), __WORKING_DIRECTORY__,
loop variables as ${x} / __x__ / bare token.

Values render like DuckDB's runner: NULL for nulls, 'true'/'false' bools,
floats with duckdb-ish formatting; large results may be MD5-hashed
("N values hashing to <md5>", sqllogictest classic format).
"""

from __future__ import annotations

import decimal as pydec
import hashlib
import math
import os
import shutil
import re
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass
class SqlLogicResult:
    path: str
    passed: int = 0
    failed: int = 0
    skipped: int = 0
    errors: List[str] = field(default_factory=list)

    @property
    def ok(self):
        return self.failed == 0


def _fmt_value(v, typ: str) -> str:
    """Render a value the way DuckDB's runner does
    (SQLLogicTestConvertValue, test/sqlite/result_helper.cpp:421): NULL,
    true/false bools, VARCHAR-cast numerics, '(empty)' for empty strings."""
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (list, tuple)):
        return _fmt_nested(v)
    if typ == "I":
        if isinstance(v, pydec.Decimal):
            return str(int(v))
        if isinstance(v, float):
            return str(int(v))
        return str(v)
    if typ == "R":
        f = float(v)
        if f == int(f) and abs(f) < 1e15:
            return f"{f:.1f}"
        return repr(f)
    if isinstance(v, (list, tuple)):
        return _fmt_nested(v)
    import datetime as _dt

    if isinstance(v, _dt.datetime):
        # duckdb prints timestamps with trailing fractional zeros trimmed
        # ('11.123', '11' — not python's '.123000')
        s = v.strftime("%Y-%m-%d %H:%M:%S")
        if v.microsecond:
            s += (".%06d" % v.microsecond).rstrip("0")
        return s
    s = str(v)
    if s == "":
        return "(empty)"
    return s.replace("\0", "\\0")


def _fmt_nested(v) -> str:
    """LIST/STRUCT → text like DuckDB's Value::ToString
    (src/common/types/value.cpp): bracketed, ', '-joined, unquoted."""
    parts = []
    for x in v:
        if x is None:
            parts.append("NULL")
        elif isinstance(x, bool):
            parts.append("true" if x else "false")
        elif isinstance(x, (list, tuple)):
            parts.append(_fmt_nested(x))
        else:
            parts.append(str(x))
    return "[" + ", ".join(parts) + "]"


def _values_equal(got: str, exp: str) -> bool:
    """Pairwise value comparison per DuckDB's CompareValues
    (result_helper.cpp:497): exact string match, else numeric comparison
    with ApproxEqual tolerance (|l-r| <= |r|*0.01 + 1e-8, types.cpp:1248),
    else boolean 1/0 == true/false equivalence."""
    if got == exp:
        return True
    gl, el = got.lower(), exp.lower()
    bools = {"true": 1, "1": 1, "false": 0, "0": 0}
    if gl in bools and el in bools and (gl in ("true", "false")
                                        or el in ("true", "false")):
        return bools[gl] == bools[el]
    try:
        g = float(got)
        e = float(exp)
    except (ValueError, OverflowError):
        return False
    if math.isnan(g) or math.isnan(e):
        return math.isnan(g) and math.isnan(e)
    if math.isinf(g) or math.isinf(e):
        return g == e
    return abs(g - e) <= abs(e) * 0.01 + 1e-8


def _rows_equal(got_rows, exp_rows) -> bool:
    if len(got_rows) != len(exp_rows):
        return False
    for g, e in zip(got_rows, exp_rows):
        if len(g) != len(e):
            return False
        for gv, ev in zip(g, e):
            if not _values_equal(gv, ev):
                return False
    return True


_HASH_RE = re.compile(r"^(\d+) values hashing to ([0-9a-f]{32})$")


class _Ctx:
    """Mutable run context: current connection + database location."""

    def __init__(self, connect, con):
        self.connect = connect
        self.con = con
        self.db_path = ":memory:"
        self.test_dir = None
        self.lock = threading.Lock()  # serializes con.sql across threads

    def get_test_dir(self):
        if self.test_dir is None:
            self.test_dir = tempfile.mkdtemp(prefix="sqllogic_")
        return self.test_dir


class SqlLogicRunner:
    BUILTIN_REQUIRES = {"tpch", "parquet", "json", "skip_reload",
                        "vector_size", "64bit"}
    SYSTEM_NAME = "duckdb"  # we answer to skipif/onlyif duckdb

    def __init__(self, connect=None):
        """`connect(path=":memory:")` opens the connection a script runs on
        (default duckdb_tpu_torch.connect, on the CUDA device; tests pass
        one on the CPU); `load` and `restart` call it with the database's
        path."""
        if connect is None:
            import duckdb_tpu_torch

            connect = duckdb_tpu_torch.connect
        self._connect = connect

    def run_file(self, path: str) -> SqlLogicResult:
        with open(path) as f:
            lines = f.read().splitlines()
        res = SqlLogicResult(path=path)
        ctx = _Ctx(self._connect, self._connect())
        self._run_lines(lines, ctx, res, {})
        return res

    def run_text(self, text: str, name: str = "<inline>") -> SqlLogicResult:
        res = SqlLogicResult(path=name)
        ctx = _Ctx(self._connect, self._connect())
        self._run_lines(text.splitlines(), ctx, res, {})
        return res

    # -- core ----------------------------------------------------------------
    def _run_lines(self, lines, ctx, res, subs):
        i = 0
        skipping = False
        skip_next = False  # skipif/onlyif applies to the next record
        while i < len(lines):
            raw = lines[i]
            line = self._substitute(raw, subs, ctx)
            s = line.strip()
            i += 1
            if not s or s.startswith("#"):
                continue
            tok = s.split()
            head = tok[0]
            if head == "halt":
                return
            if head == "mode":
                if len(tok) > 1 and tok[1] == "skip":
                    skipping = True
                elif len(tok) > 1 and tok[1] == "unskip":
                    skipping = False
                continue
            if head == "skipif":
                if len(tok) > 1 and tok[1].lower() == self.SYSTEM_NAME:
                    skip_next = True
                continue
            if head == "onlyif":
                if len(tok) > 1 and tok[1].lower() != self.SYSTEM_NAME:
                    skip_next = True
                continue
            if head == "require":
                if tok[1] not in self.BUILTIN_REQUIRES:
                    res.skipped += 1
                    return  # whole file requires an unsupported extension
                continue
            if head == "require-env":
                # DuckDB: skip the file unless the env var is set (and
                # matches the value when given), sqllogic_test_runner.cpp
                name = tok[1] if len(tok) > 1 else ""
                if name not in os.environ or (
                        len(tok) > 2 and os.environ[name] != tok[2]):
                    res.skipped += 1
                    return
                continue
            if head == "sleep":
                if not skipping:
                    n = float(tok[1]) if len(tok) > 1 else 0
                    unit = tok[2] if len(tok) > 2 else "sec"
                    scale = {"msec": 1e-3, "millisecond": 1e-3,
                             "milliseconds": 1e-3, "usec": 1e-6,
                             "microsecond": 1e-6}.get(unit, 1.0)
                    time.sleep(min(n * scale, 5.0))
                continue
            if head == "load":
                # open a file database (DuckDB: load <dbpath> [readonly]);
                # an existing one is deleted first unless read-only
                if skipping:
                    continue
                path = tok[1] if len(tok) > 1 else ":memory:"
                readonly = len(tok) > 2 and tok[2] == "readonly"
                ctx.con.close()
                if not readonly and path not in (":memory:", "") and os.path.exists(path):
                    (shutil.rmtree if os.path.isdir(path) else os.remove)(path)
                ctx.db_path = path
                ctx.con = ctx.connect(path)
                continue
            if head == "restart":
                # the round trip: close (the last connection checkpoints),
                # then open the database again
                if skipping or ctx.db_path in (":memory:", ""):
                    continue
                ctx.con.close()
                ctx.con = ctx.connect(ctx.db_path)
                continue
            if head == "hash-threshold":
                continue  # we hash only when the expected block demands it
            if head == "endloop":
                continue
            if head in ("loop", "foreach", "concurrentloop"):
                block, i = self._collect_block(lines, i)
                if skipping or skip_next:
                    skip_next = False
                    continue
                if head == "foreach":
                    var, values = tok[1], tok[2:]
                    for v in values:
                        self._run_lines(block, ctx, res, {**subs, var: v})
                elif head == "loop":
                    var, lo, hi = tok[1], int(tok[2]), int(tok[3])
                    for v in range(lo, hi):
                        self._run_lines(block, ctx, res,
                                        {**subs, var: str(v)})
                else:
                    # concurrentloop: each thread gets its OWN connection to
                    # the shared database instance (DuckDB's semantics:
                    # sqllogic_test_runner.cpp spawns per-thread
                    # connections; temp objects are connection-local)
                    var, lo, hi = tok[1], int(tok[2]), int(tok[3])

                    def run_one(v):
                        sub_ctx = _Ctx(ctx.connect, ctx.con.cursor())
                        sub_ctx.db_path = ctx.db_path
                        sub_ctx.test_dir = ctx.test_dir
                        sub_ctx.lock = ctx.lock
                        self._run_lines(block, sub_ctx, res,
                                        {**subs, var: str(v)})

                    threads = []
                    for v in range(lo, hi):
                        t = threading.Thread(target=run_one, args=(v,))
                        threads.append(t)
                        t.start()
                    for t in threads:
                        t.join()
                continue
            if head == "statement":
                expect_err = tok[1] in ("error", "maybe")
                sql, i = self._collect_sql(lines, i)
                match_text, i = self._collect_error_match(lines, i)
                if skipping or skip_next:
                    skip_next = False
                    continue
                sql = self._substitute(sql, subs, ctx)
                try:
                    with ctx.lock:
                        ctx.con.sql(sql)
                    if expect_err and tok[1] == "error":
                        res.failed += 1
                        res.errors.append(
                            f"{res.path}: expected error but succeeded: "
                            f"{sql[:100]}")
                    else:
                        res.passed += 1
                except Exception as e:  # noqa: BLE001
                    if expect_err:
                        if match_text and match_text not in str(e):
                            res.failed += 1
                            res.errors.append(
                                f"{res.path}: error mismatch: {e} !~ "
                                f"{match_text}")
                        else:
                            res.passed += 1
                    else:
                        res.failed += 1
                        res.errors.append(f"{res.path}: {e} on: {sql[:120]}")
                continue
            if head == "query":
                types = tok[1]
                sort_mode = tok[2] if len(tok) > 2 else "nosort"
                sql, i = self._collect_sql(lines, i)
                expected, i = self._collect_expected(lines, i)
                if skipping or skip_next:
                    skip_next = False
                    continue
                sql = self._substitute(sql, subs, ctx)
                try:
                    with ctx.lock:
                        r = ctx.con.sql(sql)
                    got = []
                    for row in r.rows():
                        got.append([_fmt_value(v, types[c] if c < len(types)
                                               else "T")
                                    for c, v in enumerate(row)])
                except Exception as e:  # noqa: BLE001
                    res.failed += 1
                    res.errors.append(f"{res.path}: {e} on: {sql[:120]}")
                    continue
                flat = [c for row in got for c in row]
                hash_m = (_HASH_RE.match(expected[0])
                          if len(expected) == 1 else None)
                if hash_m:
                    # classic sqllogictest hashed block: values are sorted
                    # per sort_mode, then md5 over "value\n" concatenation
                    if sort_mode == "rowsort":
                        rows_sorted = sorted("\t".join(r_) for r_ in got)
                        vals = [c for r_ in rows_sorted
                                for c in r_.split("\t")]
                    elif sort_mode == "valuesort":
                        vals = sorted(flat)
                    else:
                        vals = flat
                    digest = hashlib.md5(
                        "".join(v + "\n" for v in vals).encode()).hexdigest()
                    ok = (str(len(flat)) == hash_m.group(1)
                          and digest == hash_m.group(2))
                elif sort_mode == "rowsort":
                    got_rows = sorted(got)
                    exp_rows = sorted(
                        expected[j:j + len(types)]
                        for j in range(0, len(expected), len(types)))
                    ok = _rows_equal(got_rows, exp_rows)
                elif sort_mode == "valuesort":
                    ok = _rows_equal([[v] for v in sorted(flat)],
                                     [[v] for v in sorted(expected)])
                else:
                    ok = _rows_equal([[v] for v in flat],
                                     [[v] for v in expected])
                if ok:
                    res.passed += 1
                else:
                    res.failed += 1
                    res.errors.append(
                        f"{res.path}: result mismatch on: {sql[:100]}\n"
                        f"  got:      {flat[:12]}\n"
                        f"  expected: {expected[:12]}")
                continue
            # unknown directive: ignore
        return

    def _substitute(self, text, subs, ctx=None):
        for k, v in subs.items():
            # ${x}, __x__, and {x} — all three forms appear in the
            # DuckDB corpus (test/sql/types/float/infinity_test.test
            # uses bare {type})
            text = text.replace("${" + k + "}", v).replace(f"__{k}__", v)
            text = text.replace("{" + k + "}", v)
            text = re.sub(rf"\b{re.escape(k)}\b", v, text) if k in ("i",) \
                else text
        if ctx is not None and ("__TEST_DIR__" in text
                                or "{TEST_DIR}" in text
                                or "{TEMP_DIR}" in text):
            text = text.replace("__TEST_DIR__", ctx.get_test_dir())
            text = text.replace("{TEST_DIR}", ctx.get_test_dir())
            # DuckDB's harness injects TEMP_DIR via --temp-dir-root
            # (test/sqlite/sqllogic_test_runner.cpp:155); same per-run dir
            text = text.replace("{TEMP_DIR}", ctx.get_test_dir())
        if "__WORKING_DIRECTORY__" in text:
            text = text.replace("__WORKING_DIRECTORY__", os.getcwd())
        return text

    def _collect_sql(self, lines, i):
        sql = []
        while i < len(lines) and lines[i].strip() not in ("----",) \
                and lines[i].strip() != "":
            if lines[i].strip() == "----":
                break
            sql.append(lines[i])
            i += 1
        return "\n".join(sql), i

    def _collect_expected(self, lines, i):
        # skip blank up to ---- or directly the values
        if i < len(lines) and lines[i].strip() == "----":
            i += 1
        else:
            return [], i
        vals = []
        while i < len(lines) and lines[i].strip() != "":
            vals.extend(lines[i].split("\t"))
            i += 1
        return vals, i

    def _collect_error_match(self, lines, i):
        if i < len(lines) and lines[i].strip() == "----":
            i += 1
            msg = []
            while i < len(lines) and lines[i].strip() != "":
                msg.append(lines[i])
                i += 1
            return "\n".join(msg).replace("<REGEX>:", "").strip(), i
        return None, i

    def _collect_block(self, lines, i):
        depth = 1
        block = []
        while i < len(lines):
            s = lines[i].strip()
            if s.startswith(("loop", "foreach", "concurrentloop")):
                depth += 1
            elif s == "endloop":
                depth -= 1
                if depth == 0:
                    i += 1
                    break
            block.append(lines[i])
            i += 1
        return block, i
