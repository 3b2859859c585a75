"""Selection compaction: mask → packed row indices.

duckdb filters produce SelectionVectors
(duckdb/src/include/duckdb/common/types/selection_vector.hpp:31). The
engine keeps masks through pipelines and only compacts at boundaries
where downstream cost depends on the live-row count.
"""

from __future__ import annotations

from typing import Tuple

import torch


def compact_indices(mask: torch.Tensor, out_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed indices of true mask positions.

    out_size: output capacity (truncates past it; the caller detects that
    through the live count). Returns (indices int64 (out_size,), out_live
    bool (out_size,)). Slots past the true count point at row 0 with
    out_live False.
    """
    pos = torch.nonzero(mask).flatten()
    count = pos.shape[0]
    idx = torch.zeros(out_size, dtype=torch.int64, device=mask.device)
    keep = min(count, out_size)
    idx[:keep] = pos[:keep]
    out_live = torch.arange(out_size, device=mask.device) < count
    return idx, out_live
