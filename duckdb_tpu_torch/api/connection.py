"""Connection: the entry point of the port.

`connect(database=":memory:", device=None)` opens an in-memory database
whose columns and intermediates all live on `device` (default "cuda").
`Connection.sql` runs SQL text of any number of statements, as the JAX
package's Connection does (duckdb_tpu/api/connection.py): SELECT, the DDL
and DML of api/ddl.py and api/dml.py, BEGIN / COMMIT / ROLLBACK, SET /
RESET of every setting (main/settings.py), PREPARE / EXECUTE /
DEALLOCATE, EXPLAIN (ANALYZE: the profile of main/profiler.py) and PRAGMA,
CHECKPOINT, ATTACH / DETACH,
COPY TO / FROM (CSV and Parquet) and EXPORT / IMPORT DATABASE
(api/files.py), ALTER TABLE (api/alter.py), MERGE INTO (api/merge.py), and
PIVOT and UNPIVOT (api/pivot.py). Beside SQL it gives the appender
(api/appender.py), the relation API and prepared statements
(api/relation.py); what needs pandas or pyarrow (`from_df`, `from_arrow`,
`Result.df`, `Result.arrow`) waits for ROADMAP item 35b and says so.

`connect(path)` opens a file database (storage/persist.py): one
`Database` per directory in a process, shared by every connection to it
and kept until the last one closes, which checkpoints it. A commit writes
its statements and a commit record to the write-ahead log and fsyncs it
before it returns; recovery replays whole committed units only.

Transactions are snapshot isolation at table granularity (`_Txn`), as in
the JAX package: BEGIN takes a copy-on-write snapshot of the catalog (a
table is cloned when a statement first writes it; the clone shares the
host planes and device columns, and no plane is changed in place), COMMIT
publishes the tables the transaction wrote, and the first committer wins.
A statement that writes outside BEGIN runs in a transaction of its own,
and inside one on a copy of the transaction's catalog, so a statement
that fails leaves nothing behind. A device out-of-memory error is retried
once cold, every cache emptied (execution/cache_registry.py). Each
database keeps a log (main/logging.py) that duckdb_logs() reads.
"""

from __future__ import annotations

import collections
import itertools
import os
import random
import re
import threading
import time
from typing import Optional

import numpy as np
import torch

from duckdb_tpu_torch.api.alter import AlterMixin
from duckdb_tpu_torch.api.appender import Appender, to_columns
from duckdb_tpu_torch.api.ddl import DDLMixin, MacroBindError
from duckdb_tpu_torch.api.dml import DMLMixin
from duckdb_tpu_torch.api.files import FilesMixin, reads_files
from duckdb_tpu_torch.api.merge import MergeMixin
from duckdb_tpu_torch.api.pivot import PivotMixin
from duckdb_tpu_torch.api.relation import (PreparedStatement, Relation, bind_params, literal,
                                           param_count)
from duckdb_tpu_torch.catalog.catalog import POOL, Catalog, qualify
from duckdb_tpu_torch.errors import (  # noqa: F401 — the surface of the module
    ConnectionException, OutOfMemoryException, TransactionException)
from duckdb_tpu_torch.execution.cache_registry import PressureTrim, clear_all, is_oom
from duckdb_tpu_torch.execution.executor import Executor, Result
from duckdb_tpu_torch.main.logging import LogManager
from duckdb_tpu_torch.main.settings import SettingsManager, parse_bytes
from duckdb_tpu_torch.planner import functions_ext as FX
from duckdb_tpu_torch.planner import macros as M
from duckdb_tpu_torch.planner.bound import BindError, not_ported
from duckdb_tpu_torch.planner.planner import Planner
from duckdb_tpu_torch.planner.session import Session, activate
from duckdb_tpu_torch.sql import nodes as N
from duckdb_tpu_torch.sql.parser import Parser
from duckdb_tpu_torch.storage import persist
from duckdb_tpu_torch.types import BIGINT, VARCHAR


def _resolve_device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "duckdb_tpu_torch.connect(): no CUDA device is available; pass "
            "device=\"cpu\" to run on the CPU")
    return dev


class Database:
    """The state connections to one database share: the published catalog,
    the commit lock (DuckDB's DatabaseInstance and transaction manager) and
    the count of commits that published something, which tells each
    connection when its cached plans may hold what another one changed.
    A file database also has its directory (`path`), the number of the
    last WAL unit written or checkpointed (`wal_seq`), and the count of its
    open connections."""

    def __init__(self, device: torch.device, path: Optional[str] = None):
        self.catalog = Catalog(device=device)
        self.lock = threading.RLock()
        self.commits = 0
        self.path = path
        self.wal_seq = 0
        self.connections = 0
        # whether the catalog holds what the directory's header does not
        # (the last close checkpoints only then)
        self.dirty = False
        # whether it holds what neither the header nor the WAL does (tables
        # load_tpch registered): the next commit checkpoints, not logs
        self.unlogged = False
        # the database that ATTACHed this one: a file database attached
        # stays in _OPEN_DBS under its path, so that no second writer opens
        # the directory
        self.attached_by: Optional["Database"] = None


# one Database per directory in a process (DuckDB's DatabaseManager): a
# second connect() of a path joins the open one; a path ATTACHed by another
# database refuses both connect() and a second ATTACH
_OPEN_DBS: dict = {}


def _same_device(a, b) -> bool:
    a, b = torch.device(a), torch.device(b)
    return a.type == b.type and (a.index or 0) == (b.index or 0)


def _open_database(database: str, device) -> tuple:
    """The Database of `database` → (it, whether this call made it)."""
    if database in (":memory:", ""):
        return Database(_resolve_device(device)), False
    path = os.path.abspath(database)
    db = _OPEN_DBS.get(path)
    if db is not None and os.path.isdir(path):
        if db.attached_by is not None:
            raise ConnectionException(
                f'Connection Error: database "{database}" is attached to another database '
                "in this process; DETACH it first")
        if device is not None and not _same_device(device, db.catalog.device):
            raise ConnectionException(
                f'Connection Error: database "{database}" is open on {db.catalog.device} in '
                f"this process; it cannot be opened on {torch.device(device)}")
        return db, False
    return Database(_resolve_device(device), path), True


def _counters(cat: Catalog) -> dict:
    """The sequences' counters as they are now."""
    return {k: dict(v) for k, v in cat.sequences.items()}


def _advanced(before: dict, after: dict) -> dict:
    """The names of the sequences whose counter moved → `after`'s state."""
    return {k: v for k, v in after.items() if k in before and before[k] != v}


# the catalog's objects besides tables and schemas: a transaction copies
# each dict and shares its values, none of which is changed in place but a
# sequence's counter, which is shared on purpose (DuckDB's sequences are
# not transactional: neither ROLLBACK nor a failed statement gives a value
# back)
_OBJECTS = ("views", "macros", "table_macros", "sequences", "user_types", "indexes",
            "comments", "attached")


def _snapshot(shared: Catalog) -> Catalog:
    """A private copy of a catalog, copy-on-write: it holds the tables by
    reference and clones one only when a statement first writes it
    (`Catalog.writable_table`); the dicts of the other objects are copied,
    their values shared; the device and settings are the same."""
    snap = Catalog(device=shared.device)
    snap.settings = shared.settings
    snap.log = shared.log
    snap.tables = dict(shared.tables)
    snap._shared = set(shared.tables)
    snap._file_tables = shared._file_tables
    for name in _OBJECTS:
        setattr(snap, name, dict(getattr(shared, name)))
    snap.schemas = set(shared.schemas)
    return snap


class _Txn:
    """A transaction's state: a private snapshot of the catalog
    (`_snapshot`), what the published catalog held at BEGIN (the tables,
    for the commit's conflict check; the other objects, for its merge), the
    database's commit count then, and the versions of the tables (what it
    wrote). Versioning is per table, not per row: DML rewrites whole column
    planes, so a write-write conflict is any two transactions writing one
    table, as in the JAX package."""

    __slots__ = ("catalog", "base_refs", "base_versions", "begin", "begin_schemas",
                 "begin_commits", "implicit", "wal", "counters", "checkpoint")

    def __init__(self, db: Database, implicit: bool = False):
        with db.lock:
            shared = db.catalog
            self.catalog = _snapshot(shared)
            self.base_refs = dict(shared.tables)
            self.begin = {name: dict(getattr(shared, name)) for name in _OBJECTS}
            self.begin_schemas = set(shared.schemas)
            self.begin_commits = db.commits
            self.counters = _counters(shared)
        self.base_versions = {k: e.version for k, e in self.base_refs.items()}
        self.implicit = implicit
        # a file database's WAL unit: [(statement text, meta)]; or, where a
        # statement cannot be replayed from its text, a checkpoint at COMMIT
        self.wal = []
        self.checkpoint = False

    def written_tables(self):
        """(tables written or created, tables dropped), the plan-owned
        hidden tables ("__…") left out."""
        w = {k for k, e in self.catalog.tables.items()
             if not k.startswith("__")
             and (k not in self.base_versions or e.version != self.base_versions[k])}
        dropped = {k for k in self.base_refs
                   if k not in self.catalog.tables and not k.startswith("__")}
        return w, dropped


class _TempViews(dict):
    """A connection's TEMPORARY views, counting the plans that read one: a
    statement that did cannot be replayed from its text by another
    connection."""

    def __init__(self):
        super().__init__()
        self.reads = 0

    def get(self, key, default=None):
        view = super().get(key)
        if view is None:
            return default
        self.reads += 1
        return view


class _AppendRows:
    """An appender's flush, run as a statement that writes
    (`Connection._appender_flush`)."""

    def __init__(self, table: str, rows: list):
        self.table = table
        self.rows = rows


# the names of tables from_df / from_arrow register without one
_FROM_IDS = itertools.count(1)

class Connection(DDLMixin, DMLMixin, FilesMixin, AlterMixin, MergeMixin, PivotMixin):
    def __init__(self, database: str = ":memory:", device=None, _db: Optional[Database] = None,
                 _read_only: bool = False):
        self.database = database
        new = False
        if _db is None:
            _db, new = _open_database(database, device)
        self._db = _db
        _db.connections += 1
        self._closed = False
        self._replaying = False
        # (statement text, pinned entropy, sequence counters before) of the
        # statement running, for the WAL (file databases only)
        self._wal_pending = None
        self.device = self._db.catalog.device
        # SET / RESET values, shared by the connections of one database;
        # the executor reads the sharding settings through the catalog
        self.settings = self._db.catalog.settings or SettingsManager()
        self._db.catalog.settings = self.settings
        # the database's log, which duckdb_logs() reads
        self.log = self._db.catalog.log or LogManager()
        self._db.catalog.log = self.log
        self.last_profile = None  # the QueryProfile of the last EXPLAIN ANALYZE
        # plan cache: SQL text → (plan, output), SQL text → the hidden
        # tables of its materialized CTEs, which live as long as its plan,
        # and SQL text → the file reads it made (Planner.file_reads)
        self._plan_cache = {}
        self._plan_tables = {}
        self._plan_files = {}
        # the database's commit count the cached plans were made under
        self._plan_commits = 0
        # the routes this connection's queries took: grouping modes, fused
        # probe and membership steps, eager joins, CTEs materialized at plan
        # time (execution/executor.Executor.routes); callers may clear it
        self.routes = collections.Counter()
        # what current_database(), current_query(), random() and setseed()
        # read and change while a statement runs, and the catalog whose
        # macros, types and sequences it reads (planner/session.py)
        self.session = Session(database=_database_name(database))
        self.session.catalog_of = lambda: self.catalog
        # empties the device caches before a new statement when the card
        # is nearly full (execution/cache_registry.py)
        self._pressure_trim = PressureTrim()
        self._temp_views = _TempViews()  # TEMPORARY views: this connection's own
        self._default_schema = "main"  # USE: searched first for bare names
        self._prepared = {}  # PREPARE name → statement text
        self._txn: Optional[_Txn] = None
        if new:
            _OPEN_DBS[_db.path] = _db
            try:
                persist.load_database(self, _db.path, read_only=_read_only)
            except BaseException:
                del _OPEN_DBS[_db.path]
                raise

    @property
    def catalog(self) -> Catalog:
        """The catalog statements read and write: the transaction's
        snapshot inside BEGIN … COMMIT, the published one otherwise."""
        return self._txn.catalog if self._txn is not None else self._db.catalog

    def cursor(self) -> "Connection":
        """A second connection to the same database, on the same device;
        the two are isolated from each other by their snapshots."""
        return Connection(self.database, _db=self._db)

    duplicate = cursor

    # statements that write the catalog: outside BEGIN each runs in a
    # transaction of its own, and a file database logs them (COPY … FROM
    # too: `_mutating`; an appender's flush has no text, so the commit that
    # holds it checkpoints instead)
    _MUTATING = (N.CreateTable, N.CreateView, N.DropStatement, N.InsertStatement,
                 N.DeleteStatement, N.UpdateStatement, N.CreateSequence, N.CreateSchema,
                 N.CreateMacro, N.CreateType, N.CreateIndex, N.CommentStatement,
                 N.ImportStatement, N.MergeStatement, N.AlterStatement, _AppendRows)

    def _mutating(self, s) -> bool:
        return isinstance(s, self._MUTATING) or (
            isinstance(s, N.CopyStatement) and s.direction == "from")

    # -- main entry -----------------------------------------------------------
    def sql(self, query: str) -> Optional[Result]:
        """Run every statement of `query` in turn and return the last one's
        Result: rows for a query, the one-row Count of a DML statement, an
        empty Result for SET / RESET, None for the others."""
        stmts = Parser(query).parse_statements()
        if len(stmts) == 1:
            if isinstance(stmts[0], N.SelectStatement):
                stmts[0]._sql_text = query  # the plan cache's key
            texts = [query]
        else:
            # each statement's own text: what the WAL logs, and what a file
            # database keeps of a view or macro (None where the split fails)
            texts = persist.statement_texts(query, len(stmts)) or [None] * len(stmts)
        res = None
        for s, text in zip(stmts, texts):
            if not isinstance(s, N.SelectStatement):
                # DDL and DML change what a cached plan read
                self._clear_plan_cache()
                s._create_text = text or query
            with activate(self.session, query):
                if self._db.path is not None and not self._replaying:
                    res = self._logged_statement(s, text)
                else:
                    res = self._execute_statement(s)
        return res

    # -- the write-ahead log ------------------------------------------------------
    def _logged_statement(self, s, text):
        """A statement of a file database. One that writes has its entropy
        pinned (the time now() reads, the seed random(), the uuids and
        samples draw from on the host), so that replay gives what it
        stored; its WAL entry joins its transaction's unit when it succeeds
        (`_note_wal`). A statement that writes nothing but advances a
        sequence outside BEGIN logs the counters (DuckDB logs sequence
        values at commit)."""
        mutating = self._mutating(s)
        before = _counters(self.catalog)
        pin = None
        # IMPORT DATABASE runs statements inside its own
        outer, outer_pin = self._wal_pending, self.session.pin
        if mutating:
            pin = {"t": FX._now_micros(), "seed": self._statement_seed()}
            self.session.pin = (pin["t"], random.Random(pin["seed"]))
            # a TEMPORARY view's CREATE or DROP is the connection's own
            local = isinstance(s, (N.CreateView, N.DropStatement)) and (
                getattr(s, "temporary", False)
                or (getattr(s, "kind", None) == "view" and s.name.lower() in self._temp_views))
            self._wal_pending = (s, text, pin, before, local, self._temp_views.reads,
                                 self.catalog._file_tables.reads)
        try:
            res = self._execute_statement(s)
        finally:
            self.session.pin = outer_pin
            self._wal_pending = outer
        if not mutating and self._txn is None:
            moved = _advanced(before, _counters(self._db.catalog))
            if moved:
                with self._db.lock:
                    self._write_unit([], moved)
        return res

    def _statement_seed(self) -> int:
        """A logged statement's seed: drawn from the connection's generator
        once setseed() has seeded it, else at random."""
        if self.session._seed is None:
            return random.getrandbits(62)
        g = self.session.generator(self.device)
        return int(torch.randint(0, 1 << 62, (1,), generator=g, device=self.device))

    def _note_wal(self):
        """The statement that just succeeded joins its transaction's WAL
        unit. A TEMPORARY view's CREATE or DROP is not logged; nor is a
        statement that writes an attached database, which that database's
        checkpoint at COMMIT makes durable. One whose text is unknown, or
        that read an attached database or a TEMPORARY view, cannot be
        replayed from its text (nor can one run after USE of an attached
        database), so its COMMIT checkpoints instead. So does one that read
        a file (COPY … FROM, IMPORT DATABASE, a file reader anywhere in the
        statement, a view's included): replaying it would read the file
        again, which may have changed or gone since (ROADMAP F12)."""
        pending, txn = self._wal_pending, self._txn
        if pending is None or txn is None:
            return
        s, text, pin, before, local, temp_reads, file_reads = pending
        if isinstance(s, (N.CopyStatement, N.ImportStatement)) or reads_files(s) or \
                self.catalog._file_tables.reads != file_reads:
            txn.checkpoint = True
            return
        attached = self.catalog.attached
        target = getattr(s, "table", None) or getattr(s, "name", None)
        if local or (attached and isinstance(target, str)
                     and qualify(target).split(".", 1)[0] in attached):
            return
        if text is None or self._temp_views.reads != temp_reads or (attached and (
                self._default_schema in attached or _reads_attached(s, attached))):
            txn.checkpoint = True
            return
        meta = dict(pin)
        if self._default_schema != "main":
            meta["use"] = self._default_schema  # what unqualified names resolve in
        moved = _advanced(before, _counters(self.catalog))
        if moved:
            meta["seqs"] = {k: before[k] for k in moved}
        txn.wal.append((text, meta))

    def _write_unit(self, entries, counters):
        """Append one unit to the WAL (under the commit lock)."""
        self._db.wal_seq += 1
        self._db.dirty = True
        persist.wal_append_unit(self._db.path, self._db.wal_seq, entries, counters)

    def _replay(self, text: str, meta: dict):
        """Run one logged statement again, with its entropy and the sequence
        counters it started from, without logging it."""
        if meta.get("seqs"):
            persist.set_sequences(self._db.catalog, meta["seqs"])
        seed = meta.get("seed")
        self.session.pin = (meta.get("t"), None if seed is None else random.Random(seed))
        self._replaying = True
        self._default_schema = self.session.schema = meta.get("use", "main")
        try:
            self.sql(text)
        finally:
            self._replaying = False
            self._default_schema = self.session.schema = "main"
            self.session.pin = None

    def _abort_mode(self) -> str:
        return str(self.settings.get("debug_checkpoint_abort", "none"))

    def checkpoint(self):
        """Write a file database's published state to its directory (no-op
        in memory)."""
        if self._db.path is not None:
            persist.checkpoint(self._db, self._abort_mode())

    execute = sql
    query = sql

    def _execute_statement(self, s):
        """One statement, retried once cold if the card runs out of memory:
        every device cache and pooled column is dropped first; a second OOM
        raises OutOfMemoryException."""
        if self._pressure_trim(getattr(s, "_sql_text", None) or type(s).__name__, self.device):
            self.log.info("MemoryPressure", "proactive eviction: device residency above the "
                          "pressure threshold; caches dropped")
        try:
            return self._run(s)
        except Exception as err:  # noqa: BLE001 — classified, else re-raised
            if not is_oom(err):
                raise
        # the retry runs outside the except block: the first attempt's
        # traceback pins its frames' tensors until the handler ends
        n = clear_all()
        self.log.info("MemoryPressure", f"device OOM: cleared {n} cache stores, retrying cold")
        try:
            return self._run(s)
        except Exception as err:  # noqa: BLE001 — classified, else re-raised
            if not is_oom(err):
                raise
        raise OutOfMemoryException("Out of Memory Error: the query does not fit in device "
                                   "memory even with every cache evicted")

    def _run(self, s):
        """One attempt at a statement. One that writes runs in a transaction
        of its own outside BEGIN, and inside one on a copy of the
        transaction's catalog, so that a failure leaves nothing behind."""
        if not self._mutating(s):
            return self._execute_statement_inner(s)
        if self._txn is None:
            self._txn = _Txn(self._db, implicit=True)
            try:
                res = self._execute_statement_inner(s)
                self._note_wal()
            except BaseException:
                self._txn = None
                raise
            self._commit_txn()
            return res
        saved = self._txn.catalog
        stmt_cat = self._txn.catalog = _snapshot(saved)
        try:
            res = self._execute_statement_inner(s)
        except BaseException:
            self._txn.catalog = saved
            raise
        # what the statement did not clone is still what the transaction held
        stmt_cat._shared &= saved._shared
        self._note_wal()
        return res

    def _execute_statement_inner(self, s):
        if isinstance(s, N.SelectStatement):
            key = getattr(s, "_sql_text", None)
            cached = key is not None and key in self._plan_cache
            t0 = time.perf_counter()
            res = self._select(s, key)
            self.log.info("QueryLog", f"query returned {res.nrows} rows in "
                          f"{(time.perf_counter() - t0) * 1000:.1f} ms"
                          + (" (cached plan)" if cached else ""))
            return res
        if isinstance(s, N.SetStatement):
            if s.is_reset:
                self.settings.reset(s.name)
            else:
                self.settings.set(s.name, s.value)
            return Result(names=[], types=[], columns=[], nrows=0)
        if isinstance(s, N.TransactionStatement):
            return self._transaction(s)
        if isinstance(s, N.ExplainStatement):
            return self._explain(s)
        if isinstance(s, N.PragmaStatement):
            return self._pragma(s)
        if isinstance(s, N.PrepareStatement):
            self._prepared[s.name.lower()] = s.sql
            return None
        if isinstance(s, N.ExecuteStatement):
            return self._execute_prepared(s)
        if isinstance(s, N.DeallocateStatement):
            if s.name is None:
                self._prepared.clear()
            else:
                self._prepared.pop(s.name.lower(), None)
            return None
        if isinstance(s, N.UseStatement):
            return self._use(s)
        if isinstance(s, N.InsertStatement):
            return self._insert(s)
        if isinstance(s, N.DeleteStatement):
            return self._delete(s)
        if isinstance(s, N.UpdateStatement):
            return self._update(s)
        ddl = self._DDL.get(type(s))
        if ddl is not None:
            return getattr(self, ddl)(s)
        if isinstance(s, N.AttachStatement):
            return self._attach(s)
        if isinstance(s, N.DetachStatement):
            return self._detach(s)
        if isinstance(s, N.CopyStatement):
            return self._copy(s)
        if isinstance(s, N.ExportStatement):
            return self._export_database(s)
        if isinstance(s, N.ImportStatement):
            return self._import_database(s)
        if isinstance(s, N.MergeStatement):
            return self._merge(s)
        if isinstance(s, N.AlterStatement):
            return self._alter(s)
        if isinstance(s, N.PivotStatement):
            return self._pivot(s)
        if isinstance(s, N.UnpivotStatement):
            return self._unpivot(s)
        if isinstance(s, _AppendRows):
            entry = self.catalog.writable_table(s.table)
            self._append_rows(entry, to_columns(entry, s.rows), len(s.rows))
            return None
        raise ConnectionException(f"statement {type(s).__name__} not supported yet")

    # -- queries ----------------------------------------------------------------
    def _planner(self) -> Planner:
        return Planner(self.catalog, self.routes, temp_views=self._temp_views,
                       default_schema=self._default_schema)

    def _select(self, s: N.SelectStatement, cache_key=None) -> Result:
        """Plan (or take the cached plan of `cache_key`, the SQL text of a
        one-statement query) and run a SELECT. A plan that snapshots the
        catalog (duckdb_tables() and the like) is never cached, and its
        tables go with its run. A cached plan may hold what its tables held
        when it was made (an uncorrelated scalar subquery's value, a
        materialized CTE's rows), so the cache is dropped once another
        connection has published a commit this one can see; and a plan that
        reads files is made anew once one of them has changed (its path,
        mtime or size: Catalog.file_key), as DuckDB reads them on every
        query (ROADMAP I6)."""
        seen = self._txn.begin_commits if self._txn is not None else self._db.commits
        if seen != self._plan_commits:
            self._clear_plan_cache()
            self._plan_commits = seen
        cached = self._plan_cache.get(cache_key) if cache_key else None
        if cached is not None and not self._files_unchanged(cache_key):
            self._drop_tables(self._plan_tables.pop(cache_key))
            del self._plan_cache[cache_key], self._plan_files[cache_key]
            cached = None
        if cached is None:
            planner = self._planner()
            try:
                # macro calls expand first, so that planning sees the
                # aggregates inside their bodies
                stmt = M.expand_macros(s, planner.macros())
            except M.MacroError as err:
                raise MacroBindError(str(err)) from None
            try:
                cached = planner.plan_select(stmt)
            except BaseException:
                self._drop_tables(planner.hidden_tables)
                raise
            if planner.uncacheable or not cache_key:
                try:
                    return Executor(self.catalog, self.routes).run(*cached)
                finally:
                    self._drop_tables(planner.hidden_tables)
            self._plan_cache[cache_key] = cached
            self._plan_tables[cache_key] = planner.hidden_tables
            self._plan_files[cache_key] = planner.file_reads
        plan, output = cached
        return Executor(self.catalog, self.routes).run(plan, output)

    def load_tpch(self, data_dir: str, tables=None):
        """Register the TPC-H tables of a dbgen_tbl directory (lazy columns;
        `tables`: only these). A file database holds them from its next
        CHECKPOINT on: they are not logged, so the next commit checkpoints
        instead of logging its statements."""
        from duckdb_tpu_torch.catalog.tpch import register_tpch

        register_tpch(self.catalog, data_dir, tables)
        self._db.dirty = self._db.unlogged = True
        self._clear_plan_cache()

    def _clear_plan_cache(self):
        for names in self._plan_tables.values():
            self._drop_tables(names)
        self._plan_cache.clear()
        self._plan_tables.clear()
        self._plan_files.clear()

    def _files_unchanged(self, cache_key) -> bool:
        """Whether every file read of a cached plan still sees what it saw,
        from a table the catalog still has (a transaction's snapshot
        registers a file's table that its COMMIT does not publish)."""
        for args, key, table in self._plan_files.get(cache_key, ()):
            if not self.catalog.has_table(table):
                return False
            try:
                if self.catalog.file_key(*args) != key:
                    return False
            except ValueError:  # gone: planning again raises DuckDB's error
                return False
        return True

    def _drop_tables(self, names):
        for name in names:
            self.catalog.drop_table(name, if_exists=True)

    # -- transactions -----------------------------------------------------------
    def _transaction(self, s: N.TransactionStatement):
        """BEGIN snapshots the published catalog, ROLLBACK drops the
        snapshot, COMMIT publishes what the transaction wrote (DuckDB's
        duck_transaction_manager.cpp, at table granularity). CHECKPOINT writes
        a file database's published state to its directory."""
        a = s.action
        if a == "begin":
            if self._txn is not None:
                raise TransactionException("TransactionContext Error: cannot start a "
                                           "transaction within a transaction")
            self._txn = _Txn(self._db)
        elif a == "rollback":
            if self._txn is None:
                raise TransactionException("TransactionContext Error: cannot rollback - no "
                                           "transaction is active")
            self._txn = None
        elif a == "commit":
            if self._txn is None:
                raise TransactionException("TransactionContext Error: cannot commit - no "
                                           "transaction is active")
            self._commit_txn()
        elif a == "checkpoint":
            self.checkpoint()
            if self._db.path is not None:
                self.log.info("Checkpoint", f"checkpoint written to {self.database}")
        return None

    def _commit_txn(self):
        """Publish a transaction's writes. First committer wins: if another
        connection published a new version of a table this transaction
        wrote, dropped or created, the commit raises TransactionException
        and the transaction is rolled back. The other objects merge key by
        key against what the transaction saw at BEGIN, so what other
        connections committed meanwhile stays.

        In a file database the commit is durable before this returns: its
        WAL unit is written and fsynced under the lock, before publication
        (`_log_commit`); an attached file database it wrote is checkpointed;
        and the database checkpoints once the WAL passes
        checkpoint_threshold, after the whole unit."""
        txn, self._txn = self._txn, None
        if self.settings.get("debug_force_commit_failure", False):
            # the transaction rolls back: nothing published, nothing logged
            raise TransactionException("TransactionContext Error: Failed to commit: forced "
                                       "commit failure (debug_force_commit_failure)")
        db = self._db
        shared = db.catalog
        with db.lock:
            written, dropped = txn.written_tables()
            for k in sorted(written | dropped):
                if shared.tables.get(k) is not txn.base_refs.get(k):
                    raise TransactionException(
                        "TransactionContext Error: Failed to commit: write-write conflict "
                        f'on table "{k}": another transaction committed a conflicting '
                        "change")
            checkpoint = self._log_commit(txn)
            views, before = txn.catalog.views, txn.begin["views"]
            attached = {k.split(".", 1)[0] for k in written | dropped | {
                k for k in views.keys() | before.keys() if views.get(k) is not before.get(k)}}
            attached &= set(shared.attached)
            for k in written:
                old = shared.tables.get(k)
                shared.tables[k] = txn.catalog.tables[k]
                if old is not None:
                    POOL.release_entry(old)
            for k in dropped:
                POOL.release_entry(shared.tables.pop(k))
            changed = bool(written or dropped)
            for name in _OBJECTS:
                mine, before, published = (getattr(txn.catalog, name), txn.begin[name],
                                           getattr(shared, name))
                for k in before.keys() - mine.keys():
                    left = published.pop(k, None)
                    if name == "attached" and left is not None:  # DETACHed
                        _release_attached(db, left["path"])
                    changed = True
                for k, v in mine.items():
                    if before.get(k) is not v:
                        published[k] = v
                        changed = True
            gone = txn.begin_schemas - txn.catalog.schemas
            new = txn.catalog.schemas - txn.begin_schemas
            shared.schemas -= gone
            shared.schemas |= new
            if changed or gone or new:
                db.commits += 1
                db.dirty = True
            for alias in sorted(attached):
                info = shared.attached.get(alias)  # None: DETACHed by this transaction
                if info and not info.get("read_only") and info["path"] != ":memory:":
                    persist.checkpoint_attached(shared, alias, info["path"])
            if checkpoint or (db.path is not None and not self._replaying and persist.wal_size(
                    db.path) > parse_bytes(self.settings.get("checkpoint_threshold"))):
                persist.checkpoint(db, self._abort_mode())
        return None

    def _log_commit(self, txn: _Txn) -> bool:
        """Write a file database's commit to the WAL: the unit of its
        statements and the counters of the sequences it advanced → True
        where a checkpoint must make it durable instead: a statement that
        cannot be replayed from its text, or a transaction that began before
        another connection's commit (replaying its statements after that
        commit could give what it did not store), or a database that holds
        what was never logged."""
        db = self._db
        if db.path is None or self._replaying:
            return False
        if txn.checkpoint or db.unlogged or (txn.wal and txn.begin_commits != db.commits):
            return True
        moved = _advanced(txn.counters, _counters(db.catalog))
        if txn.wal or moved:
            self._write_unit(txn.wal, moved)
        return False

    def close(self):
        """Close the connection (an open transaction rolls back). The last
        connection of a database checkpoints a file database, leaves the
        registry, and lets go of the database's device memory."""
        if self._closed:
            return
        self._closed = True
        self._txn = None
        self._clear_plan_cache()
        db = self._db
        db.connections -= 1
        if db.connections > 0:
            return
        try:
            if db.path is not None and _OPEN_DBS.get(db.path) is db:
                try:
                    if db.dirty or persist.wal_size(db.path):
                        persist.checkpoint(db, self._abort_mode())
                finally:
                    del _OPEN_DBS[db.path]
        finally:
            for path in [p for p, d in _OPEN_DBS.items() if d.attached_by is db]:
                _release_attached(db, path)
            _release_device(db)

    # -- ATTACH / DETACH ------------------------------------------------------------
    def _attach(self, s: N.AttachStatement):
        """ATTACH a database under an alias: its tables and views are this
        catalog's `alias.name` (DuckDB's attached_database.cpp). A file
        database is opened through the normal path (its WAL replayed, then
        folded by a checkpoint unless READ_ONLY) and its entries adopted as
        clones, so that the database's own entries stay as they were. A
        commit that writes it checkpoints it before it returns."""
        cat = self.catalog
        memory = s.path in (":memory:", "")
        alias = (s.alias or _database_name(s.path)).lower()
        if not alias:
            raise ConnectionException(f"ATTACH: cannot derive an alias from {s.path!r}; use "
                                      "ATTACH ... AS name")
        if alias in cat.attached or alias in cat.schemas or alias == self.session.database:
            if s.if_not_exists:
                return None
            raise ConnectionException(f'Catalog Error: database or schema "{alias}" already '
                                      "exists!")
        if memory:
            cat.schemas.add(alias)
            cat.attached[alias] = {"path": ":memory:", "read_only": s.read_only}
            return None
        apath = os.path.abspath(s.path)
        if apath == self._db.path:
            raise ConnectionException("ATTACH: cannot attach the active database")
        if any(info["path"] == apath for info in cat.attached.values()):
            raise ConnectionException(f'database "{s.path}" is already attached')
        held = _OPEN_DBS.get(apath)
        if held is not None and held.attached_by is self._db:
            del _OPEN_DBS[apath]  # what a rolled-back ATTACH of this database left
        elif held is not None and os.path.isdir(apath):
            raise ConnectionException(f'database "{s.path}" is already open in this process')
        sub = Connection(apath, device=self.device, _read_only=s.read_only)
        try:
            if persist.wal_size(apath) and not s.read_only:
                sub.checkpoint()
            sub_cat = sub._db.catalog
            cat.schemas.add(alias)
            cat.attached[alias] = {"path": apath, "read_only": s.read_only}
            for k, e in sub_cat.tables.items():
                if not k.startswith("__"):
                    adopted = e.clone()
                    adopted.name = f"{alias}.{k}"
                    cat.tables[adopted.name] = adopted
            for k, v in sub_cat.views.items():
                cat.views[f"{alias}.{k}"] = v
        except BaseException:
            _OPEN_DBS.pop(apath, None)
            raise
        # the sub-database stays in the registry, without a checkpoint of
        # its own at close, until DETACH or the last close of this database
        sub._db.attached_by = self._db
        return None

    def _detach(self, s: N.DetachStatement):
        cat = self.catalog
        alias = s.name.lower()
        info = cat.attached.get(alias)
        if info is None:
            if s.if_exists:
                return None
            raise ConnectionException(f'Catalog Error: database "{s.name}" does not exist!')
        if info["path"] != ":memory:" and not info.get("read_only"):
            persist.checkpoint_attached(cat, alias, info["path"])
        if self._txn is None:  # inside BEGIN: at COMMIT
            _release_attached(self._db, info["path"])
        for k in [k for k in cat.tables if k.startswith(alias + ".")]:
            cat.drop_table(k)
        for k in [k for k in cat.views if k.startswith(alias + ".")]:
            del cat.views[k]
        cat.schemas.discard(alias)
        del cat.attached[alias]
        return None

    # -- the other statements -----------------------------------------------------
    def _use(self, s: N.UseStatement):
        name = s.name.lower().replace("\x02", ".")
        if name.startswith("memory."):
            name = name[7:]
        if name.startswith("main."):
            name = name[5:]
        if name != "main" and name not in self.catalog.schemas:
            raise ConnectionException(f'Catalog Error: SET schema: No catalog + schema named '
                                      f'"{s.name}" found.')
        self._default_schema = name
        self.session.schema = name
        return None

    def _execute_prepared(self, s: N.ExecuteStatement):
        """EXECUTE name(args): the prepared text with each placeholder
        token (?, $n) replaced by the argument's SQL literal, then run."""
        from duckdb_tpu_torch.planner.binder import ExprBinder, Scope

        sql = self._prepared.get(s.name.lower())
        if sql is None:
            raise ConnectionException(f'Catalog Error: Prepared statement "{s.name}" does not '
                                      "exist")
        vals = [ExprBinder(Scope()).bind(a).const_value() for a in s.args]
        need = param_count(sql)
        if need != len(vals):
            raise BindError(f"Prepared statement needs {need} parameters, {len(vals)} given")
        return self.sql(bind_params(sql, vals))

    # -- the appender, relations and prepared statements ---------------------------
    def appender(self, table: str) -> Appender:
        """An Appender of rows into `table` (api/appender.py)."""
        table = self._resolve_default(table)
        self.catalog.get_table(table)  # raises where there is none
        return Appender(self, table)

    def _appender_flush(self, table: str, rows: list):
        """Append an appender's rows as a statement of its own: constraints
        checked, committed on its own outside BEGIN, part of the transaction
        inside one, and in a file database made durable by a checkpoint at
        that commit (it has no text for the WAL to log)."""
        s = _AppendRows(table, rows)
        self._clear_plan_cache()
        with activate(self.session, ""):
            if self._db.path is not None and not self._replaying:
                self._logged_statement(s, None)
            else:
                self._execute_statement(s)

    def table(self, name: str) -> Relation:
        self.catalog.get_table(self._resolve_default(name))  # raises where there is none
        return Relation(self, f"SELECT * FROM {name}", alias=name.split(".")[-1])

    def view(self, name: str) -> Relation:
        return Relation(self, f"SELECT * FROM {name}", alias=name.split(".")[-1])

    def from_query(self, sql: str) -> Relation:
        return Relation(self, sql)

    def read_csv(self, path: str) -> Relation:
        return Relation(self, f"SELECT * FROM read_csv({literal(path)})", alias="csv")

    def read_parquet(self, path: str) -> Relation:
        return Relation(self, f"SELECT * FROM read_parquet({literal(path)})", alias="parquet")

    def prepare(self, sql: str) -> PreparedStatement:
        return PreparedStatement(self, sql)

    def from_df(self, df, table_name: str = None) -> Relation:
        """Register a pandas DataFrame as a table (api/arrow_interop.df_columns)."""
        from duckdb_tpu_torch.api.arrow_interop import df_columns

        return self._register_columns(*df_columns(df), table_name, "df")

    def from_arrow(self, tbl, table_name: str = None) -> Relation:
        """Register an Arrow table, record batch or stream (any object with
        __arrow_c_stream__ or __arrow_c_array__: a pyarrow object, or the
        port's own Result.arrow()) as a table, every batch read through
        Arrow's C interface (api/arrow_interop.arrow_columns)."""
        from duckdb_tpu_torch.api.arrow_interop import arrow_columns

        return self._register_columns(*arrow_columns(tbl), table_name, "arrow")

    register_arrow = from_arrow

    def _register_columns(self, cols, nrows: int, table_name, kind: str) -> Relation:
        """Host planes → a table of the catalog (replaced if it exists), as
        load_tpch registers its tables: promoted to the connection's device
        by the next query that reads them. No name: a fresh one."""
        from duckdb_tpu_torch.catalog.catalog import ColumnDef, TableEntry

        if table_name is None:
            table_name = f"{kind}_{next(_FROM_IDS)}"
        entry = TableEntry(table_name.lower(), [ColumnDef(n, t) for n, t, _, _, _ in cols])
        entry.nrows = nrows
        for n, t, vals, valid, dvals in cols:
            entry.set_host_column(n, vals, validity=valid, dict_values=dvals)
        self.catalog.create_table(entry, or_replace=True)
        self._db.dirty = self._db.unlogged = True
        self._clear_plan_cache()
        return self.table(table_name)

    @staticmethod
    def _count_result(n: int) -> Result:
        """The one-row BIGINT Count column a DML statement returns (the
        shell prints none: `_dml_count`, as the JAX package marks it)."""
        res = Result(names=["Count"], types=[BIGINT],
                     columns=[(np.array([n], dtype=np.int64), None, None)], nrows=1)
        res._dml_count = True
        return res

    def _explain(self, s: N.ExplainStatement):
        """EXPLAIN: the plan tree as text (planner/explain.py). EXPLAIN
        ANALYZE runs the query with every plan node timed
        (main/profiler.py) and gives the profile's text; `last_profile`
        keeps the QueryProfile, with the query's rows in `result`."""
        from duckdb_tpu_torch.main.profiler import QueryProfile, profile_executor
        from duckdb_tpu_torch.planner.explain import render_plan

        if not isinstance(s.query, N.SelectStatement):
            raise not_ported("EXPLAIN of a statement other than a SELECT")
        planner = self._planner()
        try:
            t0 = time.perf_counter()
            plan, output = planner.plan_select(M.expand_macros(s.query, planner.macros()))
            if s.analyze:
                sql = getattr(s, "_create_text", None) or self.session.query or ""
                profile = QueryProfile(query=re.sub(r"(?is)^\s*explain\s+analyze\s+", "", sql))
                profile.phases["planning"] = time.perf_counter() - t0
                ex = profile_executor(Executor(self.catalog, self.routes), profile)
                t1 = time.perf_counter()
                profile.result = ex.run(plan, output)
                profile.phases["execution"] = time.perf_counter() - t1
                profile.total_s = time.perf_counter() - t0
                self.last_profile = profile
                text = profile.render()
            else:
                text = render_plan(plan)
        finally:
            self._drop_tables(planner.hidden_tables)
        return Result(names=["explain_value"], types=[VARCHAR],
                      columns=[(np.zeros(1, np.int32), None, np.array([text], dtype=object))],
                      nrows=1)

    def _pragma(self, s: N.PragmaStatement):
        name = s.name.lower()
        if name in ("show", "show_tables"):
            return self.sql("SELECT name FROM duckdb_tables() ORDER BY name")
        if name == "table_info":
            return self.sql(f"SELECT * FROM pragma_table_info('{s.args[0].value}')")
        if name in ("enable_profiling", "disable_profiling"):
            self.settings.set("enable_profiling", name == "enable_profiling")
        return None  # VACUUM, ANALYZE and the rest: nothing to do in memory


def _database_name(database: str) -> str:
    """What current_database() gives: "memory", or the file's stem."""
    import re

    if database in (":memory:", ""):
        return "memory"
    return re.sub(r"\W", "_", os.path.splitext(os.path.basename(
        database.rstrip("/")))[0]).lower()


def _reads_attached(node, attached) -> bool:
    """Whether a statement's tree names a table of an attached database."""
    if isinstance(node, N.BaseTableRef):
        return (node.schema or "").lower() in attached
    if isinstance(node, (list, tuple)):
        return any(_reads_attached(v, attached) for v in node)
    if hasattr(node, "__dataclass_fields__"):
        return any(_reads_attached(getattr(node, f), attached)
                   for f in node.__dataclass_fields__)
    return False


def _release_attached(owner: Database, path: str):
    """The directory `owner` attached leaves the registry (DETACH, or the
    owner's last close): another connect() or ATTACH may open it again."""
    held = _OPEN_DBS.get(path)
    if held is not None and held.attached_by is owner:
        del _OPEN_DBS[path]


def _release_device(db: Database):
    """A closed database's columns leave the device: the pool forgets its
    tables, and the caches of execution/cache_registry drop what they keep
    for its dictionaries."""
    from duckdb_tpu_torch.execution.cache_registry import forget

    dicts = []
    for entry in db.catalog.tables.values():
        POOL.release_entry(entry)
        entry._device.clear()
        dicts += [h[2] for h in entry._host.values() if h[2] is not None]
    forget(dicts)


def connect(database: str = ":memory:", device=None) -> Connection:
    """A connection to an in-memory database, or to the file database in
    the directory `database` (made if missing). `device` defaults to "cuda"
    (or, for a database already open in this process, its device)."""
    return Connection(database, device=device)
