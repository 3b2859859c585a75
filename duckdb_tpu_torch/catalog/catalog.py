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

import weakref
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from duckdb_tpu_torch.blocks import Column, pad_bucket
from duckdb_tpu_torch.types import LogicalType, TypeId


class DeviceBufferPool:
    """LRU accounting of the device bytes of promoted columns."""

    def __init__(self, limit_bytes: int = 0):
        self.limit = limit_bytes  # 0: no limit
        self.used = 0
        self._clock = 0
        # (id(entry), name) → [bytes, last touch, entry, name]
        self._resident: Dict[tuple, list] = {}

    def touch(self, entry: "TableEntry", name: str, nbytes: int = 0):
        """Mark a column used; a new one adds its bytes and may evict others."""
        self._clock += 1
        key = (id(entry), name)
        rec = self._resident.get(key)
        if rec is not None:
            rec[1] = self._clock
            return
        if not any(k[0] == key[0] for k in self._resident):
            # a table that is garbage-collected leaves the pool with it
            weakref.finalize(entry, self.forget, key[0])
        self._resident[key] = [nbytes, self._clock, weakref.ref(entry), name]
        self.used += nbytes
        self._maybe_evict()

    def release(self, entry: "TableEntry", name: str):
        rec = self._resident.pop((id(entry), name), None)
        if rec:
            self.used -= rec[0]

    def release_entry(self, entry: "TableEntry"):
        """Forget every column of a dropped or replaced table."""
        self.forget(id(entry))

    def forget(self, entry_id: int):
        for key in [k for k in self._resident if k[0] == entry_id]:
            self.used -= self._resident.pop(key)[0]

    def _maybe_evict(self):
        if not self.limit:
            return
        while self.used > self.limit and len(self._resident) > 1:
            key, (_, _, ref, name) = min(self._resident.items(), key=lambda kv: kv[1][1])
            entry = ref()
            if entry is not None:
                entry.evict_device(name)
            self.used -= self._resident.pop(key)[0]

    def evict_all(self):
        """Drop every pooled column's device copy (OOM recovery)."""
        for _, _, ref, name in list(self._resident.values()):
            entry = ref()
            if entry is not None:
                entry.evict_device(name)
        self._resident.clear()
        self.used = 0


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


class TableEntry:
    def __init__(self, name: str, columns: List[ColumnDef]):
        self.name = name
        self.columns = columns
        self.col_types: Dict[str, LogicalType] = {c.name: c.ltype for c in columns}
        self.nrows: int = 0
        self.device = "cpu"  # set by Catalog.create_table
        # host tier: name -> (np values, np validity|None, dict_values|None)
        self._host: Dict[str, Tuple] = {}
        self._loaders: Dict[str, Callable[[], Tuple]] = {}
        # device tier
        self._device: Dict[str, Column] = {}
        self.stats: Dict[str, ColumnStats] = {}
        # mutation counter: caches of join build state key on it
        self.version: int = 0

    # -- population -----------------------------------------------------------
    def set_host_column(self, name, values, validity=None, dict_values=None):
        self._host[name] = (values, validity, dict_values)
        self._device.pop(name, None)
        POOL.release(self, name)
        self._compute_stats(name)
        self.version += 1

    def set_device_column(self, name, col: Column):
        """A column computed on the device (a materialized CTE), already
        padded to the table's length: it stays there as the device tier,
        and the host tier gets one copy of its nrows values for the
        statistics (wide values recombined exactly as Python ints). A
        VARCHAR column keeps its source's whole dictionary, so its
        distinct count is that of the codes it holds, not the dictionary's
        length (which would let a join trust a duplicated key as unique)."""
        values, validity = col.host_values(self.nrows)
        self._host[name] = (values, validity, col.dict_values)
        self._compute_stats(name)
        st = self.stats[name]
        if st.n_unique is not None:
            live = values if validity is None else values[validity]
            st.n_unique = int(len(np.unique(live)))
        self._device[name] = col
        self._pool(name, col)
        self.version += 1

    def set_generated_column(self, name, col: Column, stats: ColumnStats):
        """A column made on the device (a table function's, such as
        range()), padded to the table's length: it stays there, its
        statistics are the caller's, and the host tier copies it only when
        something asks for it."""
        self._device[name] = col
        self.stats[name] = stats
        self._loaders[name] = lambda: (*col.host_values(self.nrows), col.dict_values)
        self._pool(name, col)
        self.version += 1

    def set_lazy_column(self, name, loader: Callable[[], Tuple]):
        """loader() -> (values, validity, dict_values)"""
        self._loaders[name] = loader

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
            POOL.touch(self, name)
        return self._device[name]

    def _pool(self, name, col: Column):
        """Count a device column in the pool (a wide one stays pinned)."""
        if col.data_hi is None:
            nbytes = col.data.numel() * col.data.element_size()
            if col.validity is not None:
                nbytes += col.validity.numel()
            POOL.touch(self, name, nbytes)

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
    def __init__(self, device="cpu"):
        self.device = device
        self.tables: Dict[str, TableEntry] = {}
        # the connection's main/settings.SettingsManager (None: defaults,
        # one device)
        self.settings = None

    def create_table(self, entry: TableEntry, or_replace: bool = False):
        key = qualify(entry.name)
        entry.name = key
        entry.device = self.device
        if key in self.tables and not or_replace:
            raise ValueError(f'table "{entry.name}" already exists')
        if key in self.tables:
            POOL.release_entry(self.tables[key])
        self.tables[key] = entry

    def get_table(self, name: str) -> TableEntry:
        key = qualify(name)
        if key not in self.tables:
            raise ValueError(f'Table with name {name} does not exist!')
        return self.tables[key]

    def has_table(self, name: str) -> bool:
        return qualify(name) in self.tables

    def drop_table(self, name: str):
        POOL.release_entry(self.tables.pop(qualify(name)))
