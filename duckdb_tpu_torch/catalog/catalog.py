"""Catalog: tables, column metadata, and device residency.

As in the JAX package, column data is host-resident numpy (the "disk
tier") and is promoted lazily to padded tensors on the catalog's device
(the device tier) on first query touch. A process-wide DeviceBufferPool
(`POOL`) counts the bytes of every promoted column and, under a memory
limit (`set_memory_limit`; 0, the default, is none), evicts the least
recently touched ones: an evicted column drops its device copy and
re-promotes from the host tier on its next touch (DuckDB's buffer
manager, standard_buffer_manager.cpp). A column made on the device (a
materialized CTE, range()'s) gets its host copy before it can leave the
device, so eviction never drops the only copy; a wide column (with a
high plane) is never evicted. Under a limit, a query whose scans do not
fit runs in chunks (execution/chunked.py).
"""

from __future__ import annotations

import itertools
import os
import weakref
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from duckdb_tpu_torch.blocks import Column, pad_bucket
from duckdb_tpu_torch.types import LogicalType, TypeId


class DeviceBufferPool:
    """LRU accounting of the device bytes of promoted columns. Clones of
    one table (transaction snapshots) share their Column objects, so bytes
    are counted per Column, once however many tables hold it, and a
    column leaves the device only when every table that holds it lets it
    go."""

    def __init__(self, limit_bytes: int = 0):
        self.limit = limit_bytes  # 0: no limit
        self.used = 0
        self._clock = 0
        # (id(entry), name) → id(column)
        self._resident: Dict[tuple, int] = {}
        # id(column) → [bytes, last touch, {(id(entry), name): (weakref(entry), name)}]
        self._columns: Dict[int, list] = {}
        # the ids of tables garbage-collected since the last call: the
        # collector may run inside any method, so its callback only notes
        # them, and the next call forgets them (`_reap`)
        self._dead: List[int] = []

    def _reap(self):
        while self._dead:
            self.forget(self._dead.pop())

    def touch(self, entry: "TableEntry", name: str, nbytes: int = 0, use: bool = True):
        """Mark a column used; a new one adds its bytes (once per Column
        object) and may evict others. `use=False` registers one more
        holder of a column (a table's clone) and leaves its last use as
        it was."""
        self._reap()
        if use:
            self._clock += 1
        key = (id(entry), name)
        cid = id(entry._device.get(name))
        if self._resident.get(key) not in (None, cid):
            self._drop(key)
        rec = self._columns.get(cid)
        if key in self._resident:
            if use:
                rec[1] = self._clock
            return
        if not any(k[0] == key[0] for k in self._resident):
            # a table that is garbage-collected leaves the pool with it
            weakref.finalize(entry, self._dead.append, key[0])
        self._resident[key] = cid
        if rec is None:
            rec = self._columns[cid] = [nbytes, self._clock, {}]
            self.used += nbytes
        if use:
            rec[1] = self._clock
        rec[2][key] = (weakref.ref(entry), name)
        self._maybe_evict()

    def _drop(self, key):
        cid = self._resident.pop(key, None)
        if cid is None:
            return
        rec = self._columns[cid]
        del rec[2][key]
        if not rec[2]:
            del self._columns[cid]
            self.used -= rec[0]

    def release(self, entry: "TableEntry", name: str):
        self._reap()
        self._drop((id(entry), name))

    def release_entry(self, entry: "TableEntry"):
        """Forget every column of a dropped or replaced table."""
        self.forget(id(entry))

    def forget(self, entry_id: int):
        for key in [k for k in self._resident if k[0] == entry_id]:
            self._drop(key)

    def holds(self, entry: "TableEntry") -> bool:
        self._reap()
        return any(k[0] == id(entry) for k in self._resident)

    def _evict_column(self, cid: int):
        """Every table holding the column drops its device copy."""
        for key, (ref, name) in list(self._columns[cid][2].items()):
            entry = ref()
            if entry is not None:
                entry.evict_device(name)
            self._drop(key)

    def _maybe_evict(self):
        self._reap()
        if not self.limit:
            return
        while self.used > self.limit and len(self._columns) > 1:
            self._evict_column(min(self._columns, key=lambda c: self._columns[c][1]))

    def evict_all(self):
        """Drop every pooled column's device copy (OOM recovery)."""
        self._reap()
        for cid in list(self._columns):
            self._evict_column(cid)


POOL = DeviceBufferPool()


def set_memory_limit(limit_bytes: int):
    """The device bytes promoted columns may hold (0: no limit). Above it,
    the least recently used columns leave the device, and a query whose
    scans need more runs in chunks (execution/chunked.py). `SET
    memory_limit` sets it (main/settings.py)."""
    POOL.limit = int(limit_bytes)
    POOL._maybe_evict()


@dataclass
class ColumnStats:
    min_val: Optional[object] = None
    max_val: Optional[object] = None
    n_unique: Optional[int] = None
    has_nulls: bool = False


@dataclass
class ColumnDef:
    name: str
    ltype: LogicalType


# the names of the tables read from files, unique in the process
_FILE_IDS = itertools.count()


class FileTables(dict):
    """file_key → the TableEntry read then, and the count of the reads made
    (a file database checkpoints a commit whose statements read a file)."""

    reads = 0

# table versions are unique across the process: two transactions that each
# write a clone of one table never reach the same version, so a cache keyed
# by (table, rows, version) cannot hand one of them the other's data
_VERSIONS = itertools.count(1)


class TableEntry:
    def __init__(self, name: str, columns: List[ColumnDef]):
        self.name = name
        self.columns = columns
        self.col_types: Dict[str, LogicalType] = {c.name: c.ltype for c in columns}
        self.nrows: int = 0
        self.device = "cpu"  # set by Catalog.create_table
        # host tier: name -> (np values, np validity|None, dict_values|None);
        # a plane is never changed in place (clones share it): every write
        # builds new arrays and goes through set_host_column
        self._host: Dict[str, Tuple] = {}
        self._loaders: Dict[str, Callable[[], Tuple]] = {}
        # device tier
        self._device: Dict[str, Column] = {}
        self.stats: Dict[str, ColumnStats] = {}
        # mutation counter, unique in the process: caches of join build
        # state and the unique-key index key on it
        self.version: int = next(_VERSIONS)
        # ("not_null", col) / ("primary_key"|"unique", [cols]) / ("check",
        # sql_text) / ("foreign_key", [cols], table, [ref cols]): enforced
        # on append and update (api/dml.py)
        self.constraints: List[tuple] = []
        # column DEFAULT expressions as SQL text, parsed on use
        self.defaults: Dict[str, str] = {}
        # key columns → (version, set of live keys): the unique-key index
        # (DuckDB's ART) and a foreign key's parent keys, good while the
        # version is the table's; clones share it (`key_set`)
        self._key_sets: Dict[tuple, tuple] = {}

    def clone(self) -> "TableEntry":
        """A transaction's copy of the table (copy-on-write): the host
        planes and statistics are shared, since no plane is changed in
        place; the device dict is its own, sharing the Column objects, so
        a write on either side drops only its own device copy; the version
        is carried, because the data is the same. The key sets are shared
        by reference and checked against the version, so only the lineage
        that writes next can advance them."""
        new = TableEntry(self.name, [ColumnDef(c.name, c.ltype) for c in self.columns])
        new.nrows = self.nrows
        new.device = self.device
        new._host = dict(self._host)
        new._loaders = dict(self._loaders)
        new.stats = dict(self.stats)
        new.constraints = list(self.constraints)
        new.defaults = dict(self.defaults)
        new._device = dict(self._device)
        for name, col in new._device.items():
            new._pool(name, col, use=False)  # one more holder of the shared column
        new.version = self.version
        new._key_sets = self._key_sets
        return new

    def mark_written(self):
        """A new version: what caches keyed by the old one hold is stale."""
        self.version = next(_VERSIONS)

    def key_set(self, cols) -> Optional[set]:
        """The live keys over `cols` as this version left them, or None
        where no set is kept for this version."""
        hit = self._key_sets.get(tuple(cols))
        return hit[1] if hit is not None and hit[0] == self.version else None

    def store_key_set(self, cols, keys: set):
        """Keep the live keys over `cols` for this version (never changed
        in place: a later version stores a new set)."""
        self._key_sets[tuple(cols)] = (self.version, keys)

    # -- population -----------------------------------------------------------
    def set_host_column(self, name, values, validity=None, dict_values=None,
                        exact_dict: bool = True):
        """Replace a column's host plane. `exact_dict=False` says a VARCHAR
        dictionary may hold values no row holds (a DELETE keeps the old
        one), so its length is no distinct count."""
        self._host[name] = (values, validity, dict_values)
        self._loaders.pop(name, None)
        self._device.pop(name, None)
        POOL.release(self, name)
        self._compute_stats(name)
        if not exact_dict:
            self.stats[name].n_unique = None
        self.mark_written()

    def set_device_column(self, name, col: Column):
        """A column computed on the device (a materialized CTE, CREATE
        TABLE … AS SELECT), already padded to the table's length: it stays
        there as the device tier, and the host tier gets one copy of its
        nrows values for the statistics (wide values recombined exactly as
        Python ints). A VARCHAR column keeps its source's whole dictionary,
        so its distinct count is that of the codes it holds, counted on the
        device, not the dictionary's length (which would let a join trust a
        duplicated key as unique)."""
        values, validity = col.host_values(self.nrows)
        self._host[name] = (values, validity, col.dict_values)
        self._compute_stats(name)
        st = self.stats[name]
        if st.n_unique is not None:
            codes = col.data[:self.nrows].to(torch.int64)
            if col.validity is not None:
                codes = codes[col.validity[:self.nrows]]
            st.n_unique = int((torch.bincount(codes, minlength=1) > 0).sum()) if len(codes) else 0
        self._device[name] = col
        self._pool(name, col)
        self.mark_written()

    def set_generated_column(self, name, col: Column, stats: ColumnStats):
        """A column made on the device (a table function's, such as
        range()), padded to the table's length: it stays there, its
        statistics are the caller's, and the host tier copies it only when
        something asks for it."""
        self._device[name] = col
        self.stats[name] = stats
        self._loaders[name] = lambda: (*col.host_values(self.nrows), col.dict_values)
        self._pool(name, col)
        self.mark_written()

    def set_lazy_column(self, name, loader: Callable[[], Tuple]):
        """loader() -> (values, validity, dict_values). It runs once: clones
        of the table share its result, so a snapshot's read does not load
        the column a second time."""
        memo = []

        def once():
            if not memo:
                memo.append(loader())
            return memo[0]

        self._loaders[name] = once

    def host_column(self, name):
        if name not in self._host and name in self._loaders:
            values, validity, dict_values = self._loaders.pop(name)()
            self._host[name] = (values, validity, dict_values)
            self._compute_stats(name)
        return self._host[name]

    def _device_dtype(self, name, values) -> np.dtype:
        """The dtype a column is promoted at: an int64-typed column whose
        zone-map range fits is narrowed to int32, which halves its device
        residency and the bytes every scan reads (compute still widens to
        int64)."""
        if np.dtype(self.col_types[name].np_dtype) == np.int64 and len(values):
            st = self.stats_for(name)
            if (st.min_val is not None and st.max_val is not None
                    and -2**31 < int(st.min_val) and int(st.max_val) < 2**31 - 1):
                return np.dtype(np.int32)
        return values.dtype

    def device_bytes(self, name) -> int:
        """The device bytes of a column, promoted or not: its padded rows at
        its device dtype's width, plus one a row for a validity plane."""
        col = self._device.get(name)
        if col is not None:
            return col.data.numel() * col.data.element_size() + (
                0 if col.validity is None else col.validity.numel())
        values, validity, _ = self.host_column(name)
        n = pad_bucket(self.nrows)
        return n * self._device_dtype(name, values).itemsize + (0 if validity is None else n)

    def device_column(self, name) -> Column:
        if name not in self._device:
            values, validity, dict_values = self.host_column(name)
            ltype = self.col_types[name]
            values = values.astype(self._device_dtype(name, values), copy=False)
            col = Column.from_numpy(
                values, ltype, validity=validity, dict_values=dict_values,
                pad_to=pad_bucket(self.nrows), device=self.device,
                dtype_override=values.dtype,
            )
            self._device[name] = col
            self._pool(name, col)
        else:
            self._pool(name, self._device[name])
        return self._device[name]

    def _pool(self, name, col: Column, use: bool = True):
        """Count a device column in the pool (a wide one stays pinned)."""
        if col.data_hi is None:
            nbytes = col.data.numel() * col.data.element_size()
            if col.validity is not None:
                nbytes += col.validity.numel()
            POOL.touch(self, name, nbytes, use)

    def evict_device(self, name):
        """Drop a column's device copy, keeping (or first making) its host
        copy; the next device_column() promotes it again."""
        col = self._device.get(name)
        if col is None or col.data_hi is not None:
            return
        self.host_column(name)  # a column made on the device is copied first
        del self._device[name]

    def _compute_stats(self, name):
        values, validity, dict_values = self._host[name]
        st = ColumnStats()
        ltype = self.col_types[name]
        if len(values):
            if validity is not None:
                st.has_nulls = bool(np.any(~validity))
                live = values[validity] if st.has_nulls else values
            else:
                live = values
            if len(live):
                if ltype.id is TypeId.VARCHAR:
                    st.n_unique = len(dict_values) if dict_values is not None else None
                mn, mx = live.min(), live.max()
                st.min_val = mn.item() if hasattr(mn, "item") else mn
                st.max_val = mx.item() if hasattr(mx, "item") else mx
        self.stats[name] = st

    def stats_for(self, name) -> ColumnStats:
        if name not in self.stats:
            self.host_column(name)  # force load to compute
        return self.stats.get(name, ColumnStats())

    def distinct_count(self, name) -> int:
        """Exact distinct count, computed lazily on the host and cached in
        the column's stats (the reference keeps HLL estimates; exact lets a
        primary key skip runtime uniqueness checks in joins)."""
        st = self.stats_for(name)
        if st.n_unique is None:
            values, validity, _ = self.host_column(name)
            live = values if validity is None else values[validity]
            st.n_unique = int(len(np.unique(live)))
        return st.n_unique

    def composite_unique(self, names: Tuple[str, ...]) -> bool:
        """True if the column tuple is row-unique (a composite primary key),
        computed on the host once per (columns, rows, version)."""
        key = (tuple(sorted(names)), self.nrows, self.version)
        cache = self.__dict__.setdefault("_composite_unique", {})
        if key not in cache:
            cols = [self.host_column(n)[0][:self.nrows] for n in names]
            cache[key] = bool(cols) and len(np.unique(np.rec.fromarrays(cols))) == self.nrows
        return cache[key]


def qualify(name: str) -> str:
    """Catalog key for a (possibly schema-qualified) object name: lowered,
    with the default schema prefix stripped ("main.t" ≡ "t")."""
    key = name.lower()
    if key.startswith("main."):
        key = key[5:]
    return key.replace("\x02", ".")


class Catalog:
    """The objects of one database: tables, views, macros, schemas,
    sequences, user types, indexes and comments (a transaction's snapshot
    is a Catalog of its own, api/connection._Txn)."""

    def __init__(self, device="cpu"):
        self.device = device
        self.tables: Dict[str, TableEntry] = {}
        # the connection's main/settings.SettingsManager (None: defaults,
        # one device)
        self.settings = None
        self.views: Dict[str, object] = {}  # name → parsed SELECT statement
        # CREATE MACRO: name → planner.macros.MacroDef (the default macros
        # are planner/macros.default_macros(), beside these)
        self.macros: Dict[str, object] = {}
        self.table_macros: Dict[str, object] = {}
        self.schemas = {"main"}
        # name → {"value": next value, "increment": n, "last": last given}
        self.sequences: Dict[str, dict] = {}
        # CREATE TYPE: name → {"kind": "enum", "values": [...]} |
        # {"kind": "alias", "base": str, "mods": [...]}
        self.user_types: Dict[str, dict] = {}
        # CREATE INDEX: name → {"table", "exprs", "unique"}
        self.indexes: Dict[str, dict] = {}
        # COMMENT ON: ("table", name) / ("column", table, col) / (kind, name)
        # → text or None
        self.comments: Dict[tuple, object] = {}
        # ATTACH: alias → {"path": absolute directory or ":memory:",
        # "read_only": bool}; the database's tables and views are here under
        # "alias.name" (api/connection.py)
        self.attached: Dict[str, dict] = {}
        # the names of tables this catalog holds by reference from the one it
        # was copied from (a transaction's snapshot): `writable_table` clones
        # such an entry the first time a statement writes it
        self._shared: set = set()
        # the tables read from files (`ensure_file_table`), by file_key();
        # a transaction's snapshot shares the dict with its catalog
        self._file_tables = FileTables()

    @staticmethod
    def file_key(paths, union_by_name: bool = False, hive_partitioning=None,
                 filename: bool = False) -> tuple:
        """What a read of `paths` (a path, a glob, or a list of either) sees
        now: the pattern, each file's path, mtime and size, and the
        options."""
        from duckdb_tpu_torch.storage import multi_file as mf

        files = mf.expand_patterns(paths)
        if not files:
            raise ValueError(f'IO Error: No files found that match the pattern "{paths}"')
        stamps = []
        for f in files:
            try:
                st = os.stat(f)
            except OSError as err:
                raise ValueError(f'IO Error: No files found that match the pattern "{f}" '
                                 f"({err.strerror})") from None
            stamps.append((f, st.st_mtime_ns, st.st_size))
        pattern = paths if isinstance(paths, str) else tuple(str(p) for p in paths)
        hive = None if hive_partitioning is None else bool(hive_partitioning)
        return pattern, tuple(stamps), bool(union_by_name), hive, bool(filename)

    def ensure_file_table(self, paths, union_by_name: bool = False, hive_partitioning=None,
                          filename: bool = False) -> Tuple[str, tuple]:
        """Register the file(s) `paths` as a hidden table → (its name, its
        file_key). A read whose files are unchanged since an earlier one
        (same paths, mtimes and sizes) gives the table read then; otherwise
        the files are read again and the table of the pattern's old contents
        leaves the catalog and the pool, so that a VARCHAR column read again
        gets a new dictionary array (the string caches key on the array).
        CSV, Parquet (lazily, per column) and JSON files, merged by
        storage/multi_file."""
        from duckdb_tpu_torch.storage import multi_file as mf

        key = self.file_key(paths, union_by_name, hive_partitioning, filename)
        self._file_tables.reads += 1
        entry = self._file_tables.get(key)
        if entry is None:
            for old in [k for k in self._file_tables if (k[0], k[2:]) == (key[0], key[2:])]:
                del self._file_tables[old]
            pattern, stamps, ubn, hive, fname = key
            entry = mf.build_entry(f"__file_{next(_FILE_IDS)}", [s[0] for s in stamps], ubn,
                                   hive, fname)
            self._file_tables[key] = entry
        live = set(map(id, self._file_tables.values()))
        for name in [n for n, e in self.tables.items()
                     if n.startswith("__file_") and id(e) not in live]:
            self.drop_table(name)
        if self.tables.get(entry.name) is not entry:
            self.create_table(entry, or_replace=True)
        return entry.name, key

    def create_table(self, entry: TableEntry, or_replace: bool = False):
        raw = entry.name.lower()
        if "." in raw.replace("\x02", ""):  # structural qualification only
            schema = raw.split(".", 1)[0].replace("\x02", ".")
            if schema != "main" and schema not in self.schemas:
                raise ValueError(f"Catalog Error: Schema with name {schema} does not exist!")
        key = qualify(entry.name)
        entry.name = key
        entry.device = self.device
        if key in self.tables and not or_replace:
            raise ValueError(f'table "{entry.name}" already exists')
        if key in self.tables:
            self._let_go(key)
        self.tables[key] = entry

    def _let_go(self, key: str):
        """A table leaves this catalog: its pooled bytes go too, unless the
        entry is still the published one, held by reference."""
        if key in self._shared:
            self._shared.discard(key)
        else:
            POOL.release_entry(self.tables[key])

    def writable_table(self, name: str) -> TableEntry:
        """The table a statement is about to write: an entry held by
        reference from the catalog this one was copied from is cloned
        first (copy-on-write), so the original stays as it was."""
        key = qualify(name)
        entry = self.get_table(name)
        if key in self._shared:
            entry = self.tables[key] = entry.clone()
            self._shared.discard(key)
        return entry

    def get_table(self, name: str) -> TableEntry:
        key = qualify(name)
        if key not in self.tables:
            raise ValueError(f'Table with name {name} does not exist!')
        return self.tables[key]

    def has_table(self, name: str) -> bool:
        return qualify(name) in self.tables

    def drop_table(self, name: str, if_exists: bool = False):
        key = qualify(name)
        if key in self.tables:
            self._let_go(key)
            del self.tables[key]
        elif not if_exists:
            raise ValueError(f'table "{name}" does not exist')
