"""Expression environments over a batch's columns.

The JAX package (duckdb_tpu/execution/tracing.py) wraps a plan node's
expression work into one jitted program per (node, block length); that
packaging exists to save TPU dispatches. PyTorch runs eagerly, so here
`run_jitted` calls `body(env)` directly over a TraceEnv of the batch
columns it needs.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

from duckdb_tpu_torch.blocks import Column
from duckdb_tpu_torch.planner import bound as B


class TraceEnv:
    """EvalEnv-compatible env over column views.

    `overlay` maps keys to bound expressions evaluated lazily on first use
    (projection outputs referenced by ORDER BY, etc.).
    """

    def __init__(self, cols: Dict[str, Column], plen: int, live, overlay=None):
        self._cols = cols
        self.plen = plen
        self.live = live
        self._overlay = overlay or {}

    @property
    def cols(self):
        return self

    def __getitem__(self, key: str) -> Column:
        if key in self._cols:
            return self._cols[key]
        if key in self._overlay:
            c = self._overlay[key].eval(self)
            self._cols[key] = c
            return c
        raise KeyError(key)

    def __contains__(self, key):
        return key in self._cols or key in self._overlay


def run_jitted(batch, exprs: Sequence[B.BoundExpr], body: Callable):
    """Run `body(env)` over the batch columns that `exprs` reference. (The
    JAX version also takes the plan node, a tag, a variant, an overlay and
    aux inputs, which shape and key its compiled programs.)"""
    keys = []
    for e in exprs:
        for n in B.walk(e):
            if isinstance(n, (B.BoundColumnRef, B.BoundAggregateRef)) \
                    and n.key not in keys:
                keys.append(n.key)
    return body(TraceEnv({k: batch.src[k] for k in keys}, batch.plen, batch.live))
