"""ORDER BY: multi-key sort via normalized int64 keys.

duckdb encodes all keys into binary-comparable normalized keys
(duckdb/src/common/sort/sort.cpp:19-60). As in the JAX package, each key
becomes an int64 whose ascending order equals the requested SQL order
(DESC = bitwise complement; floats via the sign-flip bit trick; NULLS
FIRST/LAST as a min/max fold). torch has no multi-key lexsort, so the
permutation comes from successive stable sorts, last key first.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

_I64_MIN = torch.iinfo(torch.int64).min
_I64_MAX = torch.iinfo(torch.int64).max


def orderable_int64(
    data: torch.Tensor,
    validity: Optional[torch.Tensor],
    descending: bool,
    nulls_first: bool,
) -> torch.Tensor:
    """Normalize one key column into an int64 whose ascending order is the SQL order."""
    if data.dtype.is_floating_point:
        bits = data.to(torch.float64).view(torch.int64)
        # signed-orderable encoding: positives keep their bits (already
        # ascending); negatives flip magnitude bits and keep the sign bit set
        k = torch.where(bits < 0, ~bits ^ _I64_MIN, bits)
    else:
        k = data.to(torch.int64)
    if descending:
        k = ~k
    if validity is not None:
        null_key = _I64_MIN if nulls_first else _I64_MAX
        k = torch.where(validity, k, null_key)
    return k


def sort_permutation(norm_keys: Sequence[torch.Tensor],
                     live: torch.Tensor) -> torch.Tensor:
    """Stable sort: dead rows last, then by normalized keys. Returns row perm."""
    perm = torch.arange(live.shape[0], device=live.device)
    for k in list(norm_keys)[::-1] + [(~live).to(torch.int8)]:
        order = torch.sort(k[perm], stable=True).indices
        perm = perm[order]
    return perm
