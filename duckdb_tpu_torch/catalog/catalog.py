"""Catalog: tables, column metadata, and device residency.

As in the JAX package, column data is host-resident numpy (the "disk
tier") and is promoted lazily to padded tensors on the catalog's device
(the device tier) on first query touch. This slice keeps no buffer-pool
limit: a promoted column stays on the device until its table is replaced.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from duckdb_tpu_torch.blocks import Column, pad_bucket
from duckdb_tpu_torch.types import LogicalType, TypeId


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
        self.version += 1

    def set_generated_column(self, name, col: Column, stats: ColumnStats):
        """A column made on the device (a table function's, such as
        range()), padded to the table's length: it stays there, its
        statistics are the caller's, and the host tier copies it only when
        something asks for it."""
        self._device[name] = col
        self.stats[name] = stats
        self._loaders[name] = lambda: (*col.host_values(self.nrows), col.dict_values)
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

    def device_column(self, name) -> Column:
        if name not in self._device:
            values, validity, dict_values = self.host_column(name)
            ltype = self.col_types[name]
            # width narrowing: store int64-typed columns as int32 planes when
            # the zone-map range fits — halves device residency and the bytes
            # every scan reads (compute still widens to int64)
            if np.dtype(ltype.np_dtype) == np.int64 and len(values):
                st = self.stats_for(name)
                if (st.min_val is not None and st.max_val is not None
                        and -2**31 < int(st.min_val)
                        and int(st.max_val) < 2**31 - 1):
                    values = values.astype(np.int32)
            self._device[name] = Column.from_numpy(
                values, ltype, validity=validity, dict_values=dict_values,
                pad_to=pad_bucket(self.nrows), device=self.device,
                dtype_override=values.dtype,
            )
        return self._device[name]

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

    def create_table(self, entry: TableEntry, or_replace: bool = False):
        key = qualify(entry.name)
        entry.name = key
        entry.device = self.device
        if key in self.tables and not or_replace:
            raise ValueError(f'table "{entry.name}" already exists')
        self.tables[key] = entry

    def get_table(self, name: str) -> TableEntry:
        key = qualify(name)
        if key not in self.tables:
            raise ValueError(f'Table with name {name} does not exist!')
        return self.tables[key]

    def has_table(self, name: str) -> bool:
        return qualify(name) in self.tables

    def drop_table(self, name: str):
        del self.tables[qualify(name)]
