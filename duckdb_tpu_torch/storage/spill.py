"""The spill tier of out-of-core execution: host DRAM and temp files.

As in the JAX package (duckdb_tpu/storage/spill.py), and as DuckDB's
TemporaryFileManager spills operator state under `temp_directory`
(temporary_file_manager.cpp): chunk results gather in host memory, and
once they pass HOST_BYTES they stream column by column into flat binary
files in a temp directory and come back as np.memmap arrays, so host RAM
holds at most that much plus one chunk's output and the page cache backs
the reads of the merge. Small results, such as an aggregate's partials,
never touch the disk. A VARCHAR column keeps one append-only
dictionary while chunks arrive (codes stay stable) and is re-sorted with
one LUT rewrite at the end, so its dictionary is sorted as the catalog's
are. The directory is made under the database's `temp_directory` setting
(main/settings.py; made if missing), else the system temp directory.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np

from duckdb_tpu_torch.types import LogicalType, TypeId

# rows rewritten per step when a VARCHAR column's codes are re-sorted
_REMAP_ROWS = 1 << 24

# bytes of chunk results a writer holds in host memory before it moves
# them to temp files
HOST_BYTES = 64 << 20


def temp_root(catalog) -> Optional[str]:
    """The temp_directory setting of the catalog's database (made if
    missing); None (the system temp directory) when it is empty."""
    settings = getattr(catalog, "settings", None)
    d = str(settings.get("temp_directory", "")) if settings is not None else ""
    if not d:
        return None
    os.makedirs(d, exist_ok=True)
    return d


class SpillDir:
    """One operation's temp directory, under the catalog's temp_directory;
    delete() reclaims its space."""

    def __init__(self, tag: str, catalog=None):
        self.path = tempfile.mkdtemp(prefix=f"duckdb_tpu_torch_{tag}_", dir=temp_root(catalog))

    def delete(self):
        shutil.rmtree(self.path, ignore_errors=True)


def _spill_dtype(t: LogicalType) -> np.dtype:
    """A column's width in its file, from its logical type alone: each
    chunk's own zone maps may narrow its device data (an int64 column to
    int32), so no chunk's data sets it. Floats spill as float64."""
    dt = np.dtype(t.np_dtype)
    return np.dtype(np.float64) if dt.kind == "f" else dt


def _valid(d: np.ndarray, v: Optional[np.ndarray]) -> np.ndarray:
    return np.ones(len(d), np.bool_) if v is None else v


class SpillWriter:
    """Gathers chunk result columns: append() each chunk's (values,
    validity | None, dictionary | None) columns, then finish() → one
    (values, validity | None, dictionary | None) per column, with `nrows`
    rows in all: arrays in memory, or memmaps of the temp files
    (copy-on-write: writable, the files unchanged) once more than
    HOST_BYTES arrived. A wide column (Python ints, from a HUGEINT or
    DECIMAL(38) value) is kept at 64 bits: append() raises OverflowError
    for a value past them."""

    def __init__(self, spill: SpillDir, types: List[LogicalType]):
        self.dir = spill
        self.types = types
        self.nrows = 0
        self._dtypes = [_spill_dtype(t) for t in types]
        self._held: List[List[Tuple[np.ndarray, Optional[np.ndarray]]]] = [[] for _ in types]
        self._held_bytes = 0
        self._files = None  # [(values file, validity file)] once spilled
        self._any_null = [False] * len(types)
        self._dicts: List[Optional[Dict[str, int]]] = [
            {} if t.id is TypeId.VARCHAR else None for t in types]

    def append(self, columns, nrows: int):
        self.nrows += nrows
        for i, (t, (d, v, dv)) in enumerate(zip(self.types, columns)):
            d = np.asarray(d)[:nrows]
            if t.id is TypeId.VARCHAR:
                mapping = self._dicts[i]
                if dv is not None and len(dv):
                    strs = np.asarray(dv, dtype=object)[
                        np.clip(d.astype(np.int64), 0, len(dv) - 1)]
                else:
                    strs = np.full(nrows, "", dtype=object)
                uniq, inv = np.unique(strs.astype(str), return_inverse=True)
                lut = np.empty(len(uniq), np.int32)
                for j, s in enumerate(uniq):
                    code = mapping.get(s)
                    if code is None:
                        code = mapping[s] = len(mapping)
                    lut[j] = code
                d = lut[inv.reshape(-1)]
            else:
                d = np.ascontiguousarray(d.astype(self._dtypes[i], copy=False))
            if v is not None:
                v = np.asarray(v)[:nrows].astype(np.bool_)
                self._any_null[i] |= not v.all()
            self._held[i].append((d, v))
            self._held_bytes += d.nbytes + (0 if v is None else v.nbytes)
        if self._files is not None or self._held_bytes > HOST_BYTES:
            self._spill()

    def _spill(self):
        """Move the held columns to the temp files, opened on first use."""
        if self._files is None:
            self._files = [(open(os.path.join(self.dir.path, f"c{i}.bin"), "wb"),
                            open(os.path.join(self.dir.path, f"v{i}.bin"), "wb"))
                           for i in range(len(self.types))]
        for (df, vf), held in zip(self._files, self._held):
            for d, v in held:
                df.write(d.tobytes())
                vf.write(_valid(d, v).tobytes())
            held.clear()
        self._held_bytes = 0

    def finish(self) -> List[Tuple[np.ndarray, Optional[np.ndarray], Optional[np.ndarray]]]:
        cols = []
        for i, t in enumerate(self.types):
            dt, varchar = self._dtypes[i], t.id is TypeId.VARCHAR
            if self._files is None:
                held = self._held[i]
                data = np.concatenate([d for d, _ in held]) if held else np.zeros(0, dt)
                valid = np.concatenate([_valid(d, v) for d, v in held]) \
                    if self._any_null[i] else None
            else:
                for f in self._files[i]:
                    f.close()
                data = np.memmap(os.path.join(self.dir.path, f"c{i}.bin"), dtype=dt,
                                 mode="r+" if varchar else "c") if self.nrows else np.zeros(0, dt)
                valid = None
                if self._any_null[i] and self.nrows:
                    valid = np.memmap(os.path.join(self.dir.path, f"v{i}.bin"), dtype=np.bool_,
                                      mode="c")
            dv = None
            if varchar:
                mapping = self._dicts[i]
                vals = np.empty(max(len(mapping), 1), dtype=object)
                vals[0] = ""
                for s, c in mapping.items():
                    vals[c] = s
                # codes rewritten so that the dictionary is sorted
                order = np.argsort(vals.astype(str), kind="stable")
                remap = np.empty(len(vals), np.int32)
                remap[order] = np.arange(len(vals), dtype=np.int32)
                for lo in range(0, len(data), _REMAP_ROWS):
                    data[lo:lo + _REMAP_ROWS] = remap[data[lo:lo + _REMAP_ROWS]]
                if isinstance(data, np.memmap):
                    data.flush()
                dv = vals[order]
            cols.append((data, valid, dv))
        return cols
