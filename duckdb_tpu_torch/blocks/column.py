"""Columnar device blocks: duckdb's Vector/DataChunk as padded torch tensors.

duckdb flows 2048-row DataChunks between interpreted operators
(duckdb/src/include/duckdb/common/types/data_chunk.hpp:44). Here, as in the
JAX package, a Column is a whole table column as one padded tensor on the
connection's device, and a Batch is a set of equal-length Columns plus one
shared row mask: the (data, validity, selection) triple of duckdb's
UnifiedVectorFormat, with selection kept as a mask.

Padding: lengths round up to the JAX package's size buckets (`pad_bucket`)
so that padded lengths, and with them dense slot counts and output
capacities, match the reference row for row.

Dictionary-encoded columns hold int32 codes in `data` into the host-side
`dict_values`, with one invariant per type:
- VARCHAR (and BLOB): a sorted np.ndarray of unique values, so string
  ORDER BY, min/max and range predicates are code comparisons on the
  device;
- LIST, ARRAY, STRUCT, MAP, UNION and BIT (blocks/nested.py): an object
  array of unique values in first-seen order, so codes are good for
  equality only (GROUP BY, DISTINCT, `=`); ORDER BY, min/max, range
  predicates and join keys map them to DuckDB's ranks first
  (nested.rank_lut).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from duckdb_tpu_torch.types import LogicalType, torch_dtype_of


def pad_bucket(n: int) -> int:
    """Round n up to a padded capacity: multiple of 128, ~1/8 granularity."""
    if n <= 128:
        return 128
    e = max(0, (n - 1).bit_length() - 3)  # granularity 2^e gives <= 12.5% waste
    step = 1 << e
    b = ((n + step - 1) // step) * step
    return ((b + 127) // 128) * 128


@dataclass
class Column:
    """One column: padded device tensor + optional validity plane.

    data_hi: optional high-64-bit plane for values wider than int64
    (HUGEINT / DECIMAL(>18) sums): value = data_hi·2⁶⁴ + uint64(data).
    """

    data: torch.Tensor  # shape (P,) padded physical values
    ltype: LogicalType
    validity: Optional[torch.Tensor] = None  # bool (P,); None = all valid
    dict_values: Optional[np.ndarray] = None  # the dictionary (see the module docstring)
    data_hi: Optional[torch.Tensor] = None  # int64 (P,) high plane (wide values)

    @property
    def padded_len(self) -> int:
        return self.data.shape[0]

    def host_values(self, n: int):
        """The first n rows on the host → (values, validity|None); wide
        values recombined exactly as Python ints, hi·2^64 + uint64(lo)."""
        values = self.data[:n].cpu().numpy()
        if self.data_hi is not None:
            hi = self.data_hi[:n].cpu().numpy()
            values = np.array([int(h) * (1 << 64) + (int(lo) & ((1 << 64) - 1))
                               for h, lo in zip(hi, values)], dtype=object)
        validity = None if self.validity is None else self.validity[:n].cpu().numpy()
        return values, validity

    @staticmethod
    def from_wide(values: np.ndarray, ltype: LogicalType, validity: Optional[np.ndarray],
                  pad_to: int, device="cpu") -> "Column":
        """Exact Python ints (an object array) → a column of both 64-bit
        planes: data the low word as int64, data_hi the high word."""
        ints = [0 if v is None else int(v) for v in values]
        lo = np.array([v & ((1 << 64) - 1) for v in ints], dtype=np.uint64).view(np.int64)
        hi = np.array([v >> 64 for v in ints], dtype=np.int64)
        col = Column.from_numpy(lo, ltype, validity=validity, pad_to=pad_to, device=device,
                                dtype_override=np.int64)
        col.data_hi = torch.zeros(pad_to, dtype=torch.int64, device=device)
        col.data_hi[:len(hi)] = torch.from_numpy(hi).to(device)
        return col

    @staticmethod
    def from_numpy(
        values: np.ndarray,
        ltype: LogicalType,
        validity: Optional[np.ndarray] = None,
        dict_values: Optional[np.ndarray] = None,
        pad_to: Optional[int] = None,
        device="cpu",
        dtype_override=None,
    ) -> "Column":
        n = len(values)
        p = pad_to if pad_to is not None else pad_bucket(n)
        np_dtype = dtype_override or ltype.np_dtype
        data = torch.zeros(p, dtype=torch_dtype_of(np_dtype), device=device)
        data[:n] = torch.from_numpy(np.ascontiguousarray(values, dtype=np_dtype)).to(device)
        vmask = None
        if validity is not None:
            vmask = torch.zeros(p, dtype=torch.bool, device=device)
            vmask[:n] = torch.from_numpy(np.ascontiguousarray(validity, dtype=np.bool_)).to(device)
        return Column(data=data, ltype=ltype, validity=vmask, dict_values=dict_values)


@dataclass
class Batch:
    """Equal-length columns + one shared row mask (the selection vector analog)."""

    columns: Dict[str, Column]
    nrows: int  # logical row count (<= padded_len)
    mask: Optional[torch.Tensor] = None  # bool (P,); None = all first-nrows rows live

    @property
    def padded_len(self) -> int:
        for c in self.columns.values():
            return c.padded_len
        return 0

    def row_mask(self) -> torch.Tensor:
        """Mask of live rows, always accounting for padding."""
        p = self.padded_len
        device = next(iter(self.columns.values())).data.device
        base = torch.arange(p, device=device) < self.nrows
        if self.mask is not None:
            return base & self.mask
        return base

    def column(self, name: str) -> Column:
        return self.columns[name]
