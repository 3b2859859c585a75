"""Connection: the entry point of the port.

`connect(database=":memory:", device=None)` opens an in-memory database
whose columns and intermediates all live on `device` (default "cuda").
This slice runs SELECT statements over tables registered with
`load_tpch`, and SET / RESET of the settings the port honours
(main/settings.py: num_shards, auto_shard_rows, exchange_join_threshold,
memory_limit); DDL, DML, persistence and the rest of the JAX package's
Connection surface come with later slices. A device out-of-memory error
is retried once cold, every cache emptied (execution/cache_registry.py).
"""

from __future__ import annotations

import collections

import torch

from duckdb_tpu_torch.catalog.catalog import Catalog
from duckdb_tpu_torch.errors import OutOfMemoryException
from duckdb_tpu_torch.execution.cache_registry import PressureTrim, clear_all, is_oom
from duckdb_tpu_torch.execution.executor import Executor, Result
from duckdb_tpu_torch.main.settings import SettingsManager
from duckdb_tpu_torch.planner import macros as M
from duckdb_tpu_torch.planner.bound import BindError, not_ported
from duckdb_tpu_torch.planner.planner import Planner
from duckdb_tpu_torch.planner.session import Session, activate
from duckdb_tpu_torch.sql import nodes as N
from duckdb_tpu_torch.sql.parser import Parser


def _resolve_device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "duckdb_tpu_torch.connect(): no CUDA device is available; pass "
            "device=\"cpu\" to run on the CPU")
    return dev


class Connection:
    def __init__(self, database: str = ":memory:", device=None):
        if database not in (":memory:", ""):
            raise not_ported("persistent databases")
        self.database = database
        self.device = _resolve_device(device)
        self.catalog = Catalog(device=self.device)
        # SET / RESET values; the executor reads the sharding settings
        # through the catalog, as nested executors share it
        self.settings = SettingsManager()
        self.catalog.settings = self.settings
        # plan cache: SQL text → (plan, output), and SQL text → the hidden
        # tables of its materialized CTEs, which live as long as its plan
        self._plan_cache = {}
        self._plan_tables = {}
        # the routes this connection's queries took: grouping modes, fused
        # probe and membership steps, eager joins, CTEs materialized at plan
        # time (execution/executor.Executor.routes); callers may clear it
        self.routes = collections.Counter()
        # what current_database(), current_query(), random() and setseed()
        # read and change while a statement runs (planner/session.py)
        self.session = Session()
        # empties the device caches before a new statement when the card
        # is nearly full (execution/cache_registry.py)
        self._pressure_trim = PressureTrim()

    def sql(self, query: str) -> Result:
        """Execute one SELECT (or SET / RESET) statement and return its
        Result (no rows for SET). If the card
        runs out of memory, every device cache and pooled column is dropped
        and the statement runs once more, cold; a second OOM raises
        OutOfMemoryException."""
        with activate(self.session, query):
            self._pressure_trim(query, self.device)
            try:
                return self._run(query)
            except Exception as err:  # noqa: BLE001 — classified, else re-raised
                if not is_oom(err):
                    raise
            # the retry runs outside the except block: the first attempt's
            # traceback pins its frames' tensors until the handler ends
            clear_all()
            try:
                return self._run(query)
            except Exception as err:  # noqa: BLE001 — classified, else re-raised
                if not is_oom(err):
                    raise
            raise OutOfMemoryException("Out of Memory Error: the query does not fit in device "
                                       "memory even with every cache evicted")

    def _run(self, query: str) -> Result:
        stmts = Parser(query).parse_statements()
        if len(stmts) == 1 and isinstance(stmts[0], N.SetStatement):
            s = stmts[0]
            if s.is_reset:
                self.settings.reset(s.name)
            else:
                self.settings.set(s.name, s.value)
            return Result(names=[], types=[], columns=[], nrows=0)
        if len(stmts) != 1 or not isinstance(stmts[0], N.SelectStatement):
            raise not_ported("statements other than a single SELECT or SET")
        cached = self._plan_cache.get(query)
        if cached is None:
            planner = Planner(self.catalog, self.routes)
            try:
                # macro calls expand first, so that planning sees the
                # aggregates inside their bodies
                stmt = M.expand_macros(stmts[0], M.default_macros())
            except M.MacroError as err:
                raise BindError(str(err)) from None
            try:
                cached = planner.plan_select(stmt)
            except BaseException:
                self._drop_tables(planner.hidden_tables)
                raise
            if planner.uncacheable:
                # a snapshot of the catalog (duckdb_tables() and the like)
                # is taken anew by every run, and its tables go with it
                try:
                    return Executor(self.catalog, self.routes).run(*cached)
                finally:
                    self._drop_tables(planner.hidden_tables)
            self._plan_cache[query] = cached
            self._plan_tables[query] = planner.hidden_tables
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
            self.catalog.drop_table(name)


def connect(database: str = ":memory:", device=None) -> Connection:
    return Connection(database, device=device)
