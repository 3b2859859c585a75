"""Registry of the caches that hold device memory, and the OOM recovery
that empties them.

As in the JAX package (duckdb_tpu/execution/cache_registry.py): outside
the catalog's column pool, the port keeps device tensors in per-node
caches (fused join-step preps and eager build batches on plan nodes,
execution/fused_agg._cache_store) and in the string LUT and plane caches
of ops/strings. Each is a `TrackedDict` registered here. When the card
runs out of memory (`torch.cuda.OutOfMemoryError`), `clear_all` empties
every one of them and evicts every column of the pool (columns
re-promote from the host tier on their next touch), and the connection
re-runs the statement cold. DuckDB's buffer manager evicts hash tables
and intermediates under pressure the same way
(standard_buffer_manager.cpp).
"""

from __future__ import annotations

import gc
import weakref

import torch

_STORES: "weakref.WeakSet[TrackedDict]" = weakref.WeakSet()

# `pressure_trim` empties the caches before a new statement when the
# card's allocated bytes pass this share of its memory
PRESSURE_SHARE = 0.85


class TrackedDict(dict):
    """A cache dict that `clear_all` and `pressure_trim` can empty
    (weakly referenced: a plan dropped from the plan cache takes its
    caches with it)."""

    __hash__ = object.__hash__


def tracked_dict() -> TrackedDict:
    d = TrackedDict()
    _STORES.add(d)
    return d


def clear_all() -> int:
    """Empty every registered cache and evict every pooled column; → the
    number of caches that held something."""
    from duckdb_tpu_torch.catalog.catalog import POOL

    n = 0
    for store in list(_STORES):
        if store:
            store.clear()
            n += 1
    POOL.evict_all()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return n


def forget(objects) -> int:
    """Drop every cached entry that holds one of `objects` first (the string
    caches key a LUT or plane by a dictionary's id and keep the dictionary
    beside it) → the number dropped. A closed database's dictionaries go
    this way, so that its device tensors go with them."""
    ids = {id(o) for o in objects}
    n = 0
    for store in list(_STORES):
        for k, v in list(store.items()):
            if isinstance(v, tuple) and v and id(v[0]) in ids:
                del store[k]
                n += 1
    return n


class PressureTrim:
    """Proactive eviction per connection: before a statement other than
    the last one runs, when the card's allocated bytes pass PRESSURE_SHARE
    of its memory, empty every cache first. Repeats of one statement never
    trim: their caches are their own working set."""

    def __init__(self):
        self.last = None

    def __call__(self, statement: str, device: torch.device) -> bool:
        same, self.last = statement == self.last, statement
        if same or device.type != "cuda":
            return False
        total = torch.cuda.get_device_properties(device).total_memory
        if torch.cuda.memory_allocated(device) <= PRESSURE_SHARE * total:
            return False
        clear_all()
        return True


def is_oom(err: BaseException) -> bool:
    """True for the card running out of memory."""
    return isinstance(err, torch.cuda.OutOfMemoryError) or (
        isinstance(err, RuntimeError) and "out of memory" in str(err).lower())
