"""Selection compaction: mask → packed row indices.

duckdb filters produce SelectionVectors
(duckdb/src/include/duckdb/common/types/selection_vector.hpp:31). The
engine keeps masks through pipelines and only compacts at boundaries
where downstream cost depends on the live-row count.
"""

from __future__ import annotations

import torch


def packed_indices(mask: torch.Tensor, cap: int) -> torch.Tensor:
    """Packed indices of true mask positions for a capacity the caller
    knows holds them all (it has read the count): each true position
    writes its index to its rank, so no host sync is needed. The false
    positions all write to a spare slot that is cut off; slots past the
    count point at row 0, and the caller masks them with
    `arange(cap) < count`."""
    rank = torch.cumsum(mask.to(torch.int64), 0) - 1
    out = torch.zeros(cap + 1, dtype=torch.int64, device=mask.device)
    out.scatter_(0, torch.where(mask, rank, cap),
                 torch.arange(mask.shape[0], device=mask.device))
    return out[:cap]
