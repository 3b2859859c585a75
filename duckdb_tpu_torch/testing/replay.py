"""Replay the JAX package's recorded test statements through the port on
two devices, and report where they differ.

The corpus (tests/data/torch_replay/corpus.jsonl.gz, recorded on a host
with both packages by `tools/shadow_jax_tests.py --record`) holds one
sequence per database a JAX-package test opened: its connections,
cursors, statements in order, closes and simulated crashes, with
temporary paths as $TMP0, $TMP1, … and the repository's root as $ROOT. A
header line gives its counts. This module imports no JAX: it runs each
sequence on a connection of the port on one device (the card's) and on
another (the CPU's), each in its own directory, and compares every
statement's answers:

- where both answer, with `results_differ`: every column of every row
  (DOUBLE within 1e-9 relative, the rest exact), as a multiset, and in
  order wherever the statement's closing ORDER BY fixes it (`rows_differ`
  says how). A statement with a LIMIT and no ORDER BY that may have cut
  its rows is held to its row count only and counted apart from the
  compared ones; a statement the recorder marked nondeterministic is run
  but not compared;
- where one refuses, the other must refuse with the same error class;
- an error that is not a typed engine error (`fuzz.is_typed`; or the
  checkpoint stop a sequence asks for with SET debug_checkpoint_abort) is
  a problem on either device.

A step is not caught and continued: every statement of a sequence runs on
both devices, and nothing falls back to the CPU. A problem that matches a
fault of `KNOWN` (a fault not mended yet, by its ROADMAP Queue 3 name) is
reported apart and does not count as one.
"""

from __future__ import annotations

import gzip
import json
import os
import re
import shutil
import statistics
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CORPUS = os.path.join(ROOT, "tests", "data", "torch_replay", "corpus.jsonl.gz")

# faults the replay finds that are not mended yet: (ROADMAP Queue 3 name,
# what it is, predicate over (sequence id, statement) that picks its
# problems). Each is printed on its own line and listed open in ROADMAP.
KNOWN: List[Tuple[str, str, Callable[[str, str], bool]]] = []

_TMP = re.compile(r"\$TMP(\d+)")


def load(path: str = CORPUS) -> Tuple[dict, List[dict]]:
    """(header, sequences) of a corpus file."""
    with gzip.open(path, "rt", encoding="utf-8") as f:
        header = json.loads(f.readline())
        return header, [json.loads(line) for line in f if line.strip()]


# -- comparing two answers --------------------------------------------------
_SKIP = re.compile(r"'(?:[^']|'')*'|\"(?:[^\"]|\"\")*\"|--[^\n]*|/\*.*?\*/", re.S)
_ORDER_BY = re.compile(r"\bORDER\s+BY\b", re.I)
_LIMIT = re.compile(r"\b(?:LIMIT\s+(\d+\b(?!\s*%))?|FETCH\b)", re.I)
_OFFSET = re.compile(r"\bOFFSET\b", re.I)
_CUT = re.compile(r"\b(LIMIT|OFFSET|FETCH)\b", re.I)
_ITEM_TAIL = re.compile(r"\s+(NULLS\s+(FIRST|LAST)|ASC|DESC|COLLATE\s+\S+)\s*$", re.I)
_NAME = re.compile(r'^(?:(?:[A-Za-z_]\w*|"(?:[^"]|"")+")\.)*([A-Za-z_]\w*|"(?:[^"]|"")+")$')


def _flat(sql: str) -> str:
    """sql with quoted text, comments and everything inside parentheses
    blanked (same length), so that what is left is the top level."""
    out = list(_SKIP.sub(lambda m: " " * len(m.group()), sql))
    depth = 0
    for i, ch in enumerate(out):
        if ch == "(":
            depth += 1
        if depth:
            out[i] = " "
        if ch == ")":
            depth = max(depth - 1, 0)
    return "".join(out)


def order_of(sql: str):
    """The closing clauses of a statement's last top level → (ORDER BY items
    as written or None, LIMIT's count or None (-1: a LIMIT that is not a
    count of rows, or FETCH), whether there is an OFFSET)."""
    flat = _flat(sql)
    semis = [i for i, ch in enumerate(flat) if ch == ";" and flat[i + 1:].strip()]
    start = semis[-1] + 1 if semis else 0
    sql, flat = sql[start:], flat[start:]
    lim = list(_LIMIT.finditer(flat))
    limit = None if not lim else int(sql[lim[-1].start(1):lim[-1].end(1)]) \
        if lim[-1].group(1) else -1
    offset = _OFFSET.search(flat) is not None
    order = list(_ORDER_BY.finditer(flat))
    if not order:
        return None, limit, offset
    begin = order[-1].end()
    cut = _CUT.search(flat, begin)
    end = cut.start() if cut else len(flat)
    items, at = [], begin
    for i in range(begin, end + 1):
        if i == end or flat[i] == ",":
            items.append(sql[at:i].strip().rstrip(";").strip())
            at = i + 1
    return items, limit, offset


def key_columns(items, names) -> Optional[List[int]]:
    """The result columns an ORDER BY's items name (an ordinal, ALL, or a
    column name as the result gives it), or None when one is an expression
    or a name that is not exactly one result column."""
    low = [n.lower() for n in names]
    bare = []
    for item in items:
        while _ITEM_TAIL.search(item):
            item = _ITEM_TAIL.sub("", item)
        bare.append(item)
    if [i.upper() for i in bare] == ["ALL"]:
        return list(range(len(names)))
    out = []
    for item in bare:
        if item.isdigit():
            k = int(item) - 1
            if not 0 <= k < len(names):
                return None
            out.append(k)
            continue
        m = _NAME.match(item)
        if m is None:
            return None
        name = m.group(1)
        name = name[1:-1].replace('""', '"') if name.startswith('"') else name
        if low.count(name.lower()) != 1:
            return None
        out.append(low.index(name.lower()))
    return out


def rows_differ(sql: str, names, a, b):
    """Why two answers (lists of rows, their columns named `names`) to one
    statement differ, and how far they were compared → (what or None,
    "rows" or "count"). Every value compares as fuzz does (DOUBLE within
    1e-9 relative, the rest exact). Under a closing ORDER BY whose items
    are result columns, the key columns compare in order and the rows of a
    run of equal keys as a multiset (a run that LIMIT cuts too: the port
    breaks ties alike on every device); under one over expressions, all rows
    as a multiset. A LIMIT or OFFSET with no ORDER BY leaves only the row
    count fixed ("count"), unless fewer rows came than the LIMIT."""
    from duckdb_tpu_torch.testing.fuzz import _same_multiset, _same_value

    if len(a) != len(b):
        return f"row count {len(a)} != {len(b)}", "rows"
    items, limit, offset = order_of(sql)
    if items is None:
        if offset or (limit is not None and not 0 <= len(a) < limit):
            return None, "count"
        return (None if _same_multiset(a, b) else "rows differ"), "rows"
    keys = key_columns(items, names)
    if keys is None:
        return (None if _same_multiset(a, b) else
                "rows differ (ORDER BY over expressions: compared as multisets)"), "rows"
    for i, (x, y) in enumerate(zip(a, b)):
        if not all(_same_value(x[k], y[k]) for k in keys):
            return f"ORDER BY's columns differ at row {i}", "rows"
    runs = []  # [start, stop) of rows with equal keys
    for i in range(len(a)):
        if runs and all(_same_value(a[runs[-1][0]][k], a[i][k]) for k in keys):
            runs[-1][1] = i + 1
        else:
            runs.append([i, i + 1])
    for lo, hi in runs:
        if not _same_multiset(a[lo:hi], b[lo:hi]):
            return f"rows {lo}-{hi - 1} (equal ORDER BY columns) differ", "rows"
    return None, "rows"


def _fast_same(sql: str, a, b) -> bool:
    """Whether two large Results surely agree as rows_differ compares them
    (False: not sure, compare their rows)."""
    import numpy as np

    from duckdb_tpu_torch.testing.fuzz import _column_keys

    cols = _column_keys(a, b)
    if cols is None:
        return False
    A = np.stack([ka for ka, _ in cols], 1)
    B = np.stack([kb for _, kb in cols], 1)
    items = order_of(sql)[0]
    keys = None if items is None else key_columns(items, a.names)
    if keys:
        if not np.array_equal(A[:, keys], B[:, keys]):
            return False
        K = A[:, keys]
        run = np.cumsum(np.r_[True, (K[1:] != K[:-1]).any(1)])
        A, B = np.column_stack([run, A]), np.column_stack([run, B])
    sa = A[np.lexsort(A.T[::-1])]
    sb = B[np.lexsort(B.T[::-1])]
    return bool(np.array_equal(sa, sb))


# results larger than this compare column-wise with numpy first
FAST_ROWS = 10_000


def results_differ(sql: str, a, b):
    """rows_differ over two Results → (what or None, "rows" or "count"):
    over FAST_ROWS rows numpy decides when it finds them equal, and the
    rows are compared only otherwise."""
    if a.nrows != b.nrows:
        return f"row count {a.nrows} != {b.nrows}", "rows"
    items, limit, offset = order_of(sql)
    if items is None and (offset or (limit is not None and not 0 <= a.nrows < limit)):
        return None, "count"
    if a.nrows > FAST_ROWS and _fast_same(sql, a, b):
        return None, "rows"
    return rows_differ(sql, a.names, a.rows(), b.rows())


@dataclass
class Report:
    sequences: int = 0
    statements: int = 0
    compared: int = 0  # answered on both devices and compared row by row
    count_only: int = 0  # answered on both, a LIMIT without ORDER BY: row counts
    answered: int = 0  # answered on both devices
    refused: int = 0  # refused on both devices with one error class
    nondeterministic: int = 0  # answered or refused on both, not compared
    problems: list = field(default_factory=list)  # (sequence id, statement, what)
    known: list = field(default_factory=list)  # (fault, sequence id, statement, what)
    walls: list = field(default_factory=list)  # seconds per statement on the first device

    def counts(self) -> dict:
        return {"sequences": self.sequences, "statements": self.statements,
                "compared": self.compared, "count_only": self.count_only,
                "answered": self.answered,
                "refused": self.refused, "nondeterministic": self.nondeterministic,
                "problems": len(self.problems), "known": len(self.known)}

    def median_wall_ms(self) -> float:
        return statistics.median(self.walls) * 1e3 if self.walls else 0.0


class _Side:
    """One device's connections of a sequence, in its own directory."""

    def __init__(self, device: str, root: str):
        self.device, self.root, self.cons = device, root, {}

    def path(self, text: str) -> str:
        text = _TMP.sub(lambda m: os.path.join(self.root, f"t{m.group(1)}"), text)
        return text.replace("$ROOT/", ROOT + os.sep)

    def apply(self, op: dict):
        """Run one operation → ("rows", Result | None) or ("error", exc)
        for a statement, None for the others (which raise as they do)."""
        import duckdb_tpu_torch
        from duckdb_tpu_torch.api import connection as TC

        kind = op["op"]
        if kind == "connect":
            db = op["db"]
            self.cons[op["con"]] = duckdb_tpu_torch.connect(
                db if db == ":memory:" else self.path(db), device=self.device)
        elif kind == "cursor":
            self.cons[op["con"]] = self.cons[op["of"]].cursor()
        elif kind == "close":
            self.cons[op["con"]].close()
        elif kind == "crash":
            TC._OPEN_DBS.pop(os.path.abspath(self.path(op["db"])), None)
        elif kind == "load_tpch":
            self.cons[op["con"]].load_tpch(self.path(op["dir"]))
        else:
            try:
                return "rows", self.cons[op["con"]].sql(self.path(op["q"]))
            except Exception as e:  # noqa: BLE001 — the caller classifies
                return "error", e
        return None

    def finish(self):
        """Close the sequence's connections; drop what a crash left open."""
        from duckdb_tpu_torch.api import connection as TC

        for con in self.cons.values():
            con.close()
        for path in [p for p in TC._OPEN_DBS if p.startswith(self.root + os.sep)]:
            TC._OPEN_DBS.pop(path, None)


def _typed(e: BaseException) -> bool:
    """A typed engine error (fuzz.is_typed), or the checkpoint stop that a
    sequence asked for with SET debug_checkpoint_abort."""
    from duckdb_tpu_torch.storage.persist import FaultInjected
    from duckdb_tpu_torch.testing.fuzz import is_typed

    return is_typed(e) or isinstance(e, FaultInjected)


def _compare(sql, nd, a, b):
    """What is wrong with two devices' outcomes of one statement (None:
    nothing) and how far they were compared: None (not), "rows" or
    "count" (results_differ)."""
    (ka, va), (kb, vb) = a, b
    for kind, v, where in ((ka, va, "card"), (kb, vb, "cpu")):
        if kind == "error" and not _typed(v):
            return f"{where}: {type(v).__name__}: {v}", None
    if ka != kb:
        return f"card {ka}, cpu {kb}: {va if ka == 'error' else vb}", None
    if ka == "error":
        if type(va) is not type(vb):
            return f"card {type(va).__name__} != cpu {type(vb).__name__}: {va}", None
        return None, None
    if (va is None) != (vb is None):
        return f"card gives {'no ' if va is None else ''}result, cpu "\
               f"{'none' if vb is None else 'one'}", None
    if va is None or nd:
        return None, None
    return results_differ(sql, va, vb)


def run_sequence(seq: dict, devices: Tuple[str, str], workdir: str, report: Report,
                 after_first: Optional[Callable[[str], str]] = None):
    """Replay one sequence on both devices into `report`. after_first(sql),
    if given, runs after each statement on the first device (its wall
    taken) and may return a problem's text."""
    import torch

    sides = [_Side(d, os.path.join(workdir, f"side{i}")) for i, d in enumerate(devices)]
    tmps = {int(m) for op in seq["ops"] for v in op.values() if isinstance(v, str)
            for m in _TMP.findall(v)}
    for s in sides:
        for k in tmps:
            os.makedirs(os.path.join(s.root, f"t{k}"), exist_ok=True)
    report.sequences += 1
    sid = seq["id"]

    def problem(sql, what):
        fault = next((name for name, _, hit in KNOWN if hit(sid, sql)), None)
        if fault is not None:
            report.known.append((fault, sid, sql, what))
        else:
            report.problems.append((sid, sql, what))

    try:
        for op in seq["ops"]:
            if op["op"] != "sql":
                # a connection's operation: both devices alike, or the
                # sequence ends with a problem
                errs = []
                for s in sides:
                    try:
                        s.apply(op)
                        errs.append(None)
                    except Exception as e:  # noqa: BLE001 — compared below
                        errs.append(e)
                what, _ = _compare("", False, *[("rows", None) if e is None else ("error", e)
                                                for e in errs])
                if what:
                    problem(json.dumps(op), what)
                    return
                continue
            sql, nd = op["q"], op.get("nd", False)
            report.statements += 1
            t0 = time.perf_counter()
            a = sides[0].apply(op)
            if a[0] == "rows" and a[1] is not None and sides[0].device != "cpu":
                torch.cuda.synchronize()
            report.walls.append(time.perf_counter() - t0)
            extra = after_first(sql) if after_first is not None else ""
            b = sides[1].apply(op)
            what, how = _compare(sql, nd, a, b)
            what = what or extra
            if a[0] == b[0] == "rows":
                report.answered += 1
            elif a[0] == b[0] == "error" and not what:
                report.refused += 1
            report.compared += how == "rows"
            report.count_only += how == "count"
            report.nondeterministic += nd and not what
            if what:
                problem(sql, what)
    finally:
        for s in sides:
            try:
                s.finish()
            except Exception as e:  # noqa: BLE001 — a problem of the sequence
                problem("close()", f"{s.device}: {type(e).__name__}: {e}")
        shutil.rmtree(workdir, ignore_errors=True)


def replay(sequences: List[dict], devices: Tuple[str, str], workdir: str,
           after_first: Optional[Callable[[str], str]] = None) -> Report:
    """Replay sequences on two devices (say ("cuda", "cpu")) → Report."""
    from duckdb_tpu_torch.catalog import catalog

    report = Report()
    for i, seq in enumerate(sequences):
        try:
            run_sequence(seq, devices, os.path.join(workdir, f"s{i}"), report, after_first)
        finally:
            catalog.set_memory_limit(0)  # SET memory_limit is process-wide
    return report
