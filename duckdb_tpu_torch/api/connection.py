"""Connection: the entry point of the port.

`connect(database=":memory:", device=None)` opens an in-memory database
whose columns and intermediates all live on `device` (default "cuda").
`Connection.sql` runs SQL text of any number of statements, as the JAX
package's Connection does (duckdb_tpu/api/connection.py): SELECT, the DDL
and DML of api/ddl.py and api/dml.py, BEGIN / COMMIT / ROLLBACK, SET /
RESET of the settings the port honours (main/settings.py), PREPARE /
EXECUTE / DEALLOCATE, EXPLAIN and PRAGMA. Persistence, ATTACH, COPY and
EXPORT / IMPORT wait for the storage (ROADMAP item 33); MERGE, PIVOT,
UNPIVOT and ALTER for item 34b; each says so.

Transactions are snapshot isolation at table granularity (`_Txn`), as in
the JAX package: BEGIN takes a copy-on-write snapshot of the catalog (a
table is cloned when a statement first writes it; the clone shares the
host planes and device columns, and no plane is changed in place), COMMIT
publishes the tables the transaction wrote, and the first committer wins.
A statement that writes outside BEGIN runs in a transaction of its own,
and inside one on a copy of the transaction's catalog, so a statement
that fails leaves nothing behind. A device out-of-memory error is retried
once cold, every cache emptied (execution/cache_registry.py).
"""

from __future__ import annotations

import collections
import threading
from typing import Optional

import numpy as np
import torch

from duckdb_tpu_torch.api.ddl import DDLMixin, MacroBindError
from duckdb_tpu_torch.api.dml import DMLMixin
from duckdb_tpu_torch.catalog.catalog import POOL, Catalog
from duckdb_tpu_torch.errors import (  # noqa: F401 — the surface of the module
    ConnectionException, OutOfMemoryException, TransactionException)
from duckdb_tpu_torch.execution.cache_registry import PressureTrim, clear_all, is_oom
from duckdb_tpu_torch.execution.executor import Executor, Result
from duckdb_tpu_torch.main.settings import SettingsManager
from duckdb_tpu_torch.planner import macros as M
from duckdb_tpu_torch.planner.bound import BindError, not_ported
from duckdb_tpu_torch.planner.planner import Planner
from duckdb_tpu_torch.planner.session import Session, activate
from duckdb_tpu_torch.sql import nodes as N
from duckdb_tpu_torch.sql.parser import Parser
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
    In memory only: file databases wait for ROADMAP item 33."""

    def __init__(self, device: torch.device):
        self.catalog = Catalog(device=device)
        self.lock = threading.RLock()
        self.commits = 0


# the catalog's objects besides tables and schemas: a transaction copies
# each dict and shares its values, none of which is changed in place but a
# sequence's counter, which is shared on purpose (DuckDB's sequences are
# not transactional: neither ROLLBACK nor a failed statement gives a value
# back)
_OBJECTS = ("views", "macros", "table_macros", "sequences", "user_types", "indexes",
            "comments")


def _snapshot(shared: Catalog) -> Catalog:
    """A private copy of a catalog, copy-on-write: it holds the tables by
    reference and clones one only when a statement first writes it
    (`Catalog.writable_table`); the dicts of the other objects are copied,
    their values shared; the device and settings are the same."""
    snap = Catalog(device=shared.device)
    snap.settings = shared.settings
    snap.tables = dict(shared.tables)
    snap._shared = set(shared.tables)
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
                 "begin_commits", "implicit")

    def __init__(self, db: Database, implicit: bool = False):
        with db.lock:
            shared = db.catalog
            self.catalog = _snapshot(shared)
            self.base_refs = dict(shared.tables)
            self.begin = {name: dict(getattr(shared, name)) for name in _OBJECTS}
            self.begin_schemas = set(shared.schemas)
            self.begin_commits = db.commits
        self.base_versions = {k: e.version for k, e in self.base_refs.items()}
        self.implicit = implicit

    def written_tables(self):
        """(tables written or created, tables dropped), the plan-owned
        hidden tables ("__…") left out."""
        w = {k for k, e in self.catalog.tables.items()
             if not k.startswith("__")
             and (k not in self.base_versions or e.version != self.base_versions[k])}
        dropped = {k for k in self.base_refs
                   if k not in self.catalog.tables and not k.startswith("__")}
        return w, dropped


class Connection(DDLMixin, DMLMixin):
    def __init__(self, database: str = ":memory:", device=None, _db: Optional[Database] = None):
        if database not in (":memory:", ""):
            raise not_ported("persistent databases (ROADMAP item 33)")
        self.database = database
        self._db = _db if _db is not None else Database(_resolve_device(device))
        self.device = self._db.catalog.device
        # SET / RESET values, shared by the connections of one database;
        # the executor reads the sharding settings through the catalog
        self.settings = self._db.catalog.settings or SettingsManager()
        self._db.catalog.settings = self.settings
        # plan cache: SQL text → (plan, output), and SQL text → the hidden
        # tables of its materialized CTEs, which live as long as its plan
        self._plan_cache = {}
        self._plan_tables = {}
        # the database's commit count the cached plans were made under
        self._plan_commits = 0
        # the routes this connection's queries took: grouping modes, fused
        # probe and membership steps, eager joins, CTEs materialized at plan
        # time (execution/executor.Executor.routes); callers may clear it
        self.routes = collections.Counter()
        # what current_database(), current_query(), random() and setseed()
        # read and change while a statement runs, and the catalog whose
        # macros, types and sequences it reads (planner/session.py)
        self.session = Session()
        self.session.catalog_of = lambda: self.catalog
        # empties the device caches before a new statement when the card
        # is nearly full (execution/cache_registry.py)
        self._pressure_trim = PressureTrim()
        self._temp_views = {}  # TEMPORARY views: this connection's own
        self._default_schema = "main"  # USE: searched first for bare names
        self._prepared = {}  # PREPARE name → statement text
        self._txn: Optional[_Txn] = None

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
    # transaction of its own
    _MUTATING = (N.CreateTable, N.CreateView, N.DropStatement, N.InsertStatement,
                 N.DeleteStatement, N.UpdateStatement, N.CreateSequence, N.CreateSchema,
                 N.CreateMacro, N.CreateType, N.CreateIndex, N.CommentStatement)

    # -- main entry -----------------------------------------------------------
    def sql(self, query: str) -> Optional[Result]:
        """Run every statement of `query` in turn and return the last one's
        Result: rows for a query, the one-row Count of a DML statement, an
        empty Result for SET / RESET, None for the others."""
        stmts = Parser(query).parse_statements()
        if len(stmts) == 1 and isinstance(stmts[0], N.SelectStatement):
            stmts[0]._sql_text = query  # the plan cache's key
        res = None
        for s in stmts:
            if not isinstance(s, N.SelectStatement):
                # DDL and DML change what a cached plan read
                self._clear_plan_cache()
            with activate(self.session, query):
                res = self._execute_statement(s)
        return res

    execute = sql
    query = sql

    def _execute_statement(self, s):
        """One statement, retried once cold if the card runs out of memory:
        every device cache and pooled column is dropped first; a second OOM
        raises OutOfMemoryException."""
        self._pressure_trim(getattr(s, "_sql_text", None) or type(s).__name__, self.device)
        try:
            return self._run(s)
        except Exception as err:  # noqa: BLE001 — classified, else re-raised
            if not is_oom(err):
                raise
        # the retry runs outside the except block: the first attempt's
        # traceback pins its frames' tensors until the handler ends
        clear_all()
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
        if not isinstance(s, self._MUTATING):
            return self._execute_statement_inner(s)
        if self._txn is None:
            self._txn = _Txn(self._db, implicit=True)
            try:
                res = self._execute_statement_inner(s)
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
        return res

    def _execute_statement_inner(self, s):
        if isinstance(s, N.SelectStatement):
            return self._select(s, getattr(s, "_sql_text", None))
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
        later = self._LATER.get(type(s))
        if later is not None:
            raise not_ported(later)
        raise ConnectionException(f"statement {type(s).__name__} not supported yet")

    # statements of the JAX package the port does not run yet → what it says
    _LATER = {
        N.MergeStatement: "MERGE INTO (ROADMAP item 34b)",
        N.AlterStatement: "ALTER TABLE (ROADMAP item 34b)",
        N.PivotStatement: "PIVOT (ROADMAP item 34b)",
        N.UnpivotStatement: "UNPIVOT (ROADMAP item 34b)",
        N.AttachStatement: "ATTACH (ROADMAP item 33)",
        N.DetachStatement: "DETACH (ROADMAP item 33)",
        N.CopyStatement: "COPY (ROADMAP item 33)",
        N.ExportStatement: "EXPORT DATABASE (ROADMAP item 33)",
        N.ImportStatement: "IMPORT DATABASE (ROADMAP item 33)",
    }

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
        connection has published a commit this one can see."""
        seen = self._txn.begin_commits if self._txn is not None else self._db.commits
        if seen != self._plan_commits:
            self._clear_plan_cache()
            self._plan_commits = seen
        cached = self._plan_cache.get(cache_key) if cache_key else None
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
        plan, output = cached
        return Executor(self.catalog, self.routes).run(plan, output)

    def load_tpch(self, data_dir: str):
        """Register the TPC-H tables of a dbgen_tbl directory (lazy columns)."""
        from duckdb_tpu_torch.catalog.tpch import register_tpch

        register_tpch(self.catalog, data_dir)
        self._clear_plan_cache()

    def _clear_plan_cache(self):
        for names in self._plan_tables.values():
            self._drop_tables(names)
        self._plan_cache.clear()
        self._plan_tables.clear()

    def _drop_tables(self, names):
        for name in names:
            self.catalog.drop_table(name, if_exists=True)

    # -- transactions -----------------------------------------------------------
    def _transaction(self, s: N.TransactionStatement):
        """BEGIN snapshots the published catalog, ROLLBACK drops the
        snapshot, COMMIT publishes what the transaction wrote (DuckDB's
        duck_transaction_manager.cpp, at table granularity). CHECKPOINT has
        nothing to write in memory."""
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
        return None

    def _commit_txn(self):
        """Publish a transaction's writes. First committer wins: if another
        connection published a new version of a table this transaction
        wrote, dropped or created, the commit raises TransactionException
        and the transaction is rolled back. The other objects merge key by
        key against what the transaction saw at BEGIN, so what other
        connections committed meanwhile stays."""
        txn, self._txn = self._txn, None
        shared = self._db.catalog
        with self._db.lock:
            written, dropped = txn.written_tables()
            for k in sorted(written | dropped):
                if shared.tables.get(k) is not txn.base_refs.get(k):
                    raise TransactionException(
                        "TransactionContext Error: Failed to commit: write-write conflict "
                        f'on table "{k}": another transaction committed a conflicting '
                        "change")
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
                    published.pop(k, None)
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
                self._db.commits += 1
        return None

    def close(self):
        if self._txn is not None:
            self._txn = None  # an open transaction is rolled back
        self._clear_plan_cache()

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
        from duckdb_tpu_torch.sql.lexer import tokenize

        sql = self._prepared.get(s.name.lower())
        if sql is None:
            raise ConnectionException(f'Catalog Error: Prepared statement "{s.name}" does not '
                                      "exist")
        vals = [ExprBinder(Scope()).bind(a).const_value() for a in s.args]

        def render(v):
            if v is None:
                return "NULL"
            if isinstance(v, bool):
                return "true" if v else "false"
            if isinstance(v, str):
                return "'" + v.replace("'", "''") + "'"
            return str(v)

        params = [t for t in tokenize(sql) if t.type == "OP" and (
            t.value == "?" or (t.value.startswith("$") and t.value[1:].isdigit()))]
        need = sum(1 for t in params if t.value == "?") or max(
            (int(t.value[1:]) for t in params if t.value != "?"), default=0)
        if need != len(vals):
            raise BindError(f"Prepared statement needs {need} parameters, {len(vals)} given")
        pieces, last, i = [], 0, 0
        for t in params:
            if t.value == "?":
                v = vals[i]
                i += 1
            else:
                v = vals[int(t.value[1:]) - 1]
            pieces.append(sql[last:t.pos])
            pieces.append(render(v))
            last = t.pos + len(t.value)
        pieces.append(sql[last:])
        return self.sql("".join(pieces))

    @staticmethod
    def _count_result(n: int) -> Result:
        """The one-row BIGINT Count column a DML statement returns."""
        return Result(names=["Count"], types=[BIGINT],
                      columns=[(np.array([n], dtype=np.int64), None, None)], nrows=1)

    def _explain(self, s: N.ExplainStatement):
        """EXPLAIN: the plan tree as text (planner/explain.py). EXPLAIN
        ANALYZE runs the query first; its profile waits for ROADMAP item 36."""
        from duckdb_tpu_torch.planner.explain import render_plan

        if not isinstance(s.query, N.SelectStatement):
            raise not_ported("EXPLAIN of a statement other than a SELECT")
        planner = self._planner()
        try:
            plan, output = planner.plan_select(M.expand_macros(s.query, planner.macros()))
            if s.analyze:
                Executor(self.catalog, self.routes).run(plan, output)
        finally:
            self._drop_tables(planner.hidden_tables)
        return Result(names=["explain_value"], types=[VARCHAR],
                      columns=[(np.zeros(1, np.int32), None,
                                np.array([render_plan(plan)], dtype=object))], nrows=1)

    def _pragma(self, s: N.PragmaStatement):
        name = s.name.lower()
        if name in ("show", "show_tables"):
            return self.sql("SELECT name FROM duckdb_tables() ORDER BY name")
        if name == "table_info":
            return self.sql(f"SELECT * FROM pragma_table_info('{s.args[0].value}')")
        if name in ("enable_profiling", "disable_profiling"):
            raise not_ported("profiling (ROADMAP item 36)")
        return None  # VACUUM, ANALYZE and the rest: nothing to do in memory


def connect(database: str = ":memory:", device=None) -> Connection:
    return Connection(database, device=device)
