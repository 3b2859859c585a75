"""Test helpers: carry the JAX package's table state into the port."""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np

from duckdb_tpu_torch.blocks import Column, pad_bucket
from duckdb_tpu_torch.types import LogicalType, decimal


def parse_type_text(text: str) -> LogicalType:
    """A logical type from its SQL text, e.g. "DECIMAL(15,2)" or "DATE"
    (the repr either package gives its LogicalType)."""
    from duckdb_tpu_torch.planner.binder import resolve_type_name

    m = re.fullmatch(r"\s*DECIMAL\((\d+),\s*(\d+)\)\s*", text, re.IGNORECASE)
    if m:
        return decimal(int(m.group(1)), int(m.group(2)))
    return resolve_type_name(text.strip().lower(), ())


def from_numpy_columns(
    planes: Mapping[str, Tuple[np.ndarray, Optional[np.ndarray], Optional[np.ndarray]]],
    types: Mapping[str, Union[LogicalType, str]],
    device="cpu",
    pad_to: Optional[int] = None,
) -> Dict[str, Column]:
    """Host column planes → port Columns on `device`.

    planes: name → (values, validity|None, dict_values|None), the host form
    both packages' TableEntry.host_column returns (VARCHAR as int32 codes
    into a sorted dictionary). types: name → port LogicalType or its SQL
    text, so a caller holding the JAX package's types passes repr(t).
    Every column pads to `pad_to` (default pad_bucket of the longest).
    """
    n = max((len(v) for v, _, _ in planes.values()), default=0)
    p = pad_to if pad_to is not None else pad_bucket(n)
    out = {}
    for name, (values, validity, dict_values) in planes.items():
        t = types[name]
        ltype = parse_type_text(t) if isinstance(t, str) else t
        values = np.asarray(values)
        out[name] = Column.from_numpy(values, ltype, validity=validity,
                                      dict_values=dict_values, pad_to=p,
                                      device=device, dtype_override=values.dtype)
    return out
