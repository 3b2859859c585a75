"""Multi-file scans: glob expansion, schema merge, hive partitions.

The JAX package's duckdb_tpu/storage/multi_file.py (DuckDB's
src/common/multi_file/: multi_file_reader.cpp, hive partitioning in
multi_file_column_mapper.cpp): one merged TableEntry whose columns
concatenate per-file planes (Parquet columns stay lazy per column, CSV and
JSON files load whole), with dictionary codes remapped into a union
dictionary so that VARCHAR stays integer codes on the device. Parquet is
read by the port's own codec (storage/parquet.py).

Options (the named parameters of read_csv, read_parquet and read_json):
- union_by_name: merge schemas by column name; a missing column is NULL
- hive_partitioning: key=value path segments as columns (detected when
  every file has the same keys); a column of values that all parse as
  integers is BIGINT, else VARCHAR
- filename: the source path as a column
"""

from __future__ import annotations

import glob as _glob
import os
from functools import partial
from typing import Dict, List, Optional, Tuple

import numpy as np

from duckdb_tpu_torch.blocks.nested import NESTED_IDS, obj_array
from duckdb_tpu_torch.types import BIGINT, VARCHAR, LogicalType, TypeId, max_logical_type


def expand_patterns(arg) -> List[str]:
    """A path, a glob, or a list of either → the files, each once, globs
    sorted."""
    pats = [arg] if isinstance(arg, str) else [str(p) for p in arg]
    out: List[str] = []
    for p in pats:
        if any(ch in p for ch in "*?["):
            out.extend(h for h in sorted(_glob.glob(p, recursive=True)) if os.path.isfile(h))
        else:
            out.append(p)
    return list(dict.fromkeys(out))


def hive_parts(files: List[str]) -> Optional[List[Dict[str, str]]]:
    """The key=value directory segments of each file; None unless every
    file has the same non-empty key set (DuckDB's detection rule)."""
    per, keys0 = [], None
    for f in files:
        d: Dict[str, str] = {}
        for seg in f.split(os.sep)[:-1]:
            k, eq, v = seg.partition("=")
            if eq and k:
                d[k] = v
        if not d:
            return None
        ks = tuple(sorted(d))
        if keys0 is None:
            keys0 = ks
        elif ks != keys0:
            return None
        per.append(d)
    return per


def _promote(a: LogicalType, b: LogicalType) -> LogicalType:
    if a.id is b.id and a.scale == b.scale:
        return a
    if a.id is TypeId.VARCHAR or b.id is TypeId.VARCHAR:
        return VARCHAR
    try:
        return max_logical_type(a, b)
    except Exception:  # noqa: BLE001 — no common type: VARCHAR, as the JAX package does
        return VARCHAR


def merge_schemas(schemas: List[List[Tuple[str, LogicalType]]],
                  union_by_name: bool) -> List[Tuple[str, LogicalType]]:
    if not union_by_name:
        base = list(schemas[0])
        names0 = [n for n, _ in base]
        for s in schemas[1:]:
            if [n for n, _ in s] != names0:
                raise ValueError("schemas differ between files; pass union_by_name=true")
            for i, (_, t) in enumerate(s):
                base[i] = (base[i][0], _promote(base[i][1], t))
        return base
    types: Dict[str, LogicalType] = {}
    for s in schemas:
        for n, t in s:
            types[n] = _promote(types[n], t) if n in types else t
    return list(types.items())


def _null_part(n: int, ltype: LogicalType):
    if ltype.id is TypeId.VARCHAR:
        return np.zeros(n, np.int32), np.zeros(n, bool), np.array([""], dtype=object)
    return np.zeros(n, ltype.np_dtype), np.zeros(n, bool), None


def _to_varchar_part(vals, valid, dvals):
    """A numeric part under a VARCHAR-promoted column → dictionary codes."""
    if dvals is not None:
        return vals, valid, dvals
    uniq, codes = np.unique(np.asarray(vals).astype(str), return_inverse=True)
    return codes.reshape(-1).astype(np.int32), valid, uniq.astype(object)


def concat_parts(parts: List[Optional[Tuple]], lens: List[int], ltype: LogicalType) -> Tuple:
    """Per-file (values, validity, dictionary) or None → one column."""
    datas, valids, dicts = [], [], []
    for p, n in zip(parts, lens):
        vals, valid, dvals = _null_part(n, ltype) if p is None else p
        if ltype.id is TypeId.VARCHAR:
            vals, valid, dvals = _to_varchar_part(vals, valid, dvals)
        elif dvals is not None and ltype.id is not TypeId.BLOB and ltype.id not in NESTED_IDS:
            raise ValueError("dictionary part under non-VARCHAR column")
        datas.append(np.asarray(vals))
        valids.append(np.ones(n, bool) if valid is None else valid)
        dicts.append(dvals)
    validity = np.concatenate(valids) if valids else np.zeros(0, bool)
    valid = None if validity.all() else validity
    if ltype.id is TypeId.VARCHAR:
        if len(dicts) == 1:
            return datas[0].astype(np.int32), valid, dicts[0]
        union = np.unique(np.concatenate([d.astype(str) for d in dicts]))
        out = [np.searchsorted(union, d.astype(str)).astype(np.int32)[np.clip(v, 0, len(d) - 1)]
               for v, d in zip(datas, dicts)]
        return np.concatenate(out), valid, union.astype(object)
    if ltype.id is TypeId.BLOB or ltype.id in NESTED_IDS:
        # a BLOB's dictionary sorted by bytes, a nested one in first-seen order
        merged = [x for d in dicts if d is not None for x in d]
        if ltype.id is TypeId.BLOB:
            union = obj_array(sorted(set(merged)))
        else:
            union = obj_array(list(dict.fromkeys(merged)))
        index = {v: i for i, v in enumerate(union)}

        def remap(codes, d):
            if d is None or not len(d):
                return np.zeros(len(codes), np.int32)
            lut = np.array([index[x] for x in d], dtype=np.int32)
            return lut[np.clip(codes, 0, len(d) - 1)]

        out = [remap(v, d) for v, d in zip(datas, dicts)]
        if len(union) == 0:
            union = obj_array([b"" if ltype.id is TypeId.BLOB else ()])
        return np.concatenate(out) if out else np.zeros(0, np.int32), valid, union
    dt = object if any(d.dtype == object for d in datas) else ltype.np_dtype
    data = np.concatenate([d.astype(dt) for d in datas]) if datas else np.zeros(0, dt)
    return data, valid, None


def const_column(n_per_file: List[int], values: List[str]):
    """One value per file, repeated over the file's rows → dictionary codes."""
    union = np.unique(np.array([str(v) for v in values]))
    codes = np.concatenate([np.full(n, np.searchsorted(union, str(v)), dtype=np.int32)
                            for n, v in zip(n_per_file, values)])
    return codes, None, union.astype(object)


def partition_column(n_per_file: List[int], values: List[str]):
    """Hive partition values: BIGINT when every value parses as an integer."""
    try:
        ints = [int(v) for v in values]
    except ValueError:
        return VARCHAR, const_column(n_per_file, values)
    data = np.concatenate([np.full(n, v, dtype=np.int64) for n, v in zip(n_per_file, ints)])
    return BIGINT, (data, None, None)


# -- per-file sources and the merged TableEntry -----------------------------------------

class _FileSource:
    """One file: its schema, rows, and column(name) → its part."""

    def __init__(self, path: str):
        self.path = path
        self.kind = ("parquet" if path.endswith(".parquet") else
                     "json" if path.endswith((".json", ".jsonl", ".ndjson")) else "csv")
        if self.kind == "parquet":
            from duckdb_tpu_torch.storage import parquet

            self._pf = parquet.ParquetFile(path)
            self.schema, self.nrows = self._pf.schema, self._pf.nrows
        elif self.kind == "json":
            from duckdb_tpu_torch.storage import json_io

            self.schema, self._cols, self.nrows = json_io.read_json_file(path)
        else:
            from duckdb_tpu_torch.storage import csv as csvmod

            delim, has_header, self.schema = csvmod.sniff_csv(path)
            self._cols = csvmod.load_csv(path, self.schema, delim, has_header)
            first = next(iter(self._cols.values()), None)
            self.nrows = len(first[0]) if first is not None else 0
        self.types = dict(self.schema)

    def column(self, name: str):
        """(values, validity, dictionary), or None where this file lacks it."""
        if name not in self.types:
            return None
        if self.kind == "parquet":
            from duckdb_tpu_torch.storage import parquet

            return parquet.load_column(self.path, name, self._pf)
        return self._cols[name]


def _merged_column(sources: List[_FileSource], cname: str, ltype: LogicalType):
    parts = []
    for s in sources:
        p = s.column(cname)
        src = s.types.get(cname)
        if p is not None and ltype.id is TypeId.DECIMAL and src.id is TypeId.DECIMAL \
                and src.scale != ltype.scale:
            p = (np.asarray(p[0], np.int64) * 10 ** (ltype.scale - src.scale), p[1], p[2])
        parts.append(p)
    return concat_parts(parts, [s.nrows for s in sources], ltype)


def build_entry(name: str, files: List[str], union_by_name: bool, hive: Optional[bool],
                filename: bool):
    """The merged TableEntry over `files`, its columns lazy."""
    from duckdb_tpu_torch.catalog.catalog import ColumnDef, TableEntry

    sources = [_FileSource(f) for f in files]
    merged = merge_schemas([s.schema for s in sources], union_by_name)
    lens = [s.nrows for s in sources]
    cols = list(merged)
    hp = None if hive is False else hive_parts(files)
    if hive and hp is None:
        # hive_partitioning=true over paths without consistent key=value
        # directories is an error, not a silent no-op (DuckDB's
        # multi_file_column_mapper.cpp)
        raise ValueError("hive_partitioning was enabled explicitly, but the file paths do not "
                         "have consistent key=value partition directories")
    extra = {}
    if hp is not None:
        taken = {n for n, _ in cols}
        for k in sorted(hp[0]):
            if k not in taken:
                t, part = partition_column(lens, [d[k] for d in hp])
                cols.append((k, t))
                extra[k] = part
    if filename:
        cols.append(("filename", VARCHAR))
        extra["filename"] = const_column(lens, files)
    entry = TableEntry(name, [ColumnDef(n, t) for n, t in cols])
    entry.nrows = sum(lens)
    for cname, ltype in merged:
        entry.set_lazy_column(cname, partial(_merged_column, sources, cname, ltype))
    for cname, part in extra.items():
        entry.set_host_column(cname, part[0], validity=part[1], dict_values=part[2])
    return entry
