"""Plan executor: eager torch ops over padded columnar batches.

Replaces the reference's pull/push pipeline interpreter
(duckdb/src/parallel/pipeline_executor.cpp) with host-driven execution of
plan nodes, each a handful of torch ops over an entire padded block on the
connection's device. As in the JAX package, a Batch's columns are lazy:
an ORDER BY or LIMIT stores gather indices and only materializes the
planes downstream operators touch. Host syncs happen where a size is
needed (group count, live count); PyTorch runs eagerly, so a size is read
when it is needed instead of learned across runs.
"""

from __future__ import annotations

import datetime
import decimal as pydec
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from duckdb_tpu_torch.blocks import Column, pad_bucket
from duckdb_tpu_torch.catalog.catalog import Catalog, TableEntry
from duckdb_tpu_torch.ops import sort as S
from duckdb_tpu_torch.ops.compact import compact_indices
from duckdb_tpu_torch.planner import plan as P
from duckdb_tpu_torch.planner.bound import EvalEnv, bcast, not_ported
from duckdb_tpu_torch.types import LogicalType, TypeId

_I64_MIN = torch.iinfo(torch.int64).min


# ---------------------------------------------------------------------------
# lazy column sources
class ColSource:
    def __getitem__(self, key: str) -> Column:
        raise KeyError(key)

    def __contains__(self, key: str) -> bool:
        try:
            self[key]
            return True
        except KeyError:
            return False

    def stats_range(self, key: str):
        """(min, max) value bounds for an integer-physical column, or None.

        Bounds survive filters/gathers (they only shrink the value set) —
        the zone-map idea from the reference (duckdb/src/storage/statistics/).
        """
        return None


class TableCols(ColSource):
    def __init__(self, entry: TableEntry, keymap: Dict[str, str], plen: int):
        self.entry = entry
        self.keymap = keymap  # key → column name
        self.plen = plen

    def __getitem__(self, key: str) -> Column:
        col = self.entry.device_column(self.keymap[key])
        assert col.padded_len == self.plen
        return col

    def stats_range(self, key: str):
        if key not in self.keymap:
            return None
        col_name = self.keymap[key]
        t = self.entry.col_types[col_name]
        if t.id is TypeId.VARCHAR:
            _, _, dvals = self.entry.host_column(col_name)
            return (0, max(0, len(dvals) - 1)) if dvals is not None else None
        if not (t.is_integer or t.id.name in ("DATE", "DECIMAL", "BOOLEAN")):
            return None
        st = self.entry.stats_for(col_name)
        if st.min_val is None or st.max_val is None:
            return None
        return (int(st.min_val), int(st.max_val))


class DictCols(ColSource):
    def __init__(self, cols: Dict[str, Column]):
        self.cols = cols

    def __getitem__(self, key: str) -> Column:
        return self.cols[key]


class ChainCols(ColSource):
    """Lookup through a list of sources (projection outputs ∪ their input)."""

    def __init__(self, sources: List[ColSource]):
        self.sources = sources

    def __getitem__(self, key: str) -> Column:
        for s in self.sources:
            try:
                return s[key]
            except KeyError:
                continue
        raise KeyError(key)

    def stats_range(self, key: str):
        for s in self.sources:
            if key in s:
                return s.stats_range(key)
        return None


class GatherCols(ColSource):
    """Late materialization: parent columns gathered by row indices on access."""

    def __init__(self, parent: ColSource, rows: torch.Tensor):
        self.parent = parent
        self.rows = rows  # (P',) int64 indices into the parent block
        self._cache: Dict[str, Column] = {}

    def __getitem__(self, key: str) -> Column:
        if key in self._cache:
            return self._cache[key]
        col = self.parent[key]
        idx = self.rows.clamp(0, col.data.shape[0] - 1)

        def take(x):
            return None if x is None else x[idx]

        out = Column(data=take(col.data), ltype=col.ltype, validity=take(col.validity),
                     dict_values=col.dict_values, data_hi=take(col.data_hi))
        self._cache[key] = out
        return out

    def stats_range(self, key: str):
        return self.parent.stats_range(key)


@dataclass
class Batch:
    src: ColSource
    plen: int
    live: torch.Tensor  # (P,) bool

    def env(self) -> EvalEnv:
        return EvalEnv(cols=self.src, plen=self.plen, live=self.live)

    def count_live(self) -> int:
        return int(self.live.sum())


def _full_valid(c: Column, plen: int) -> torch.Tensor:
    if c.validity is None:
        return torch.ones(plen, dtype=torch.bool, device=c.data.device)
    return bcast(c.validity, plen)


# ---------------------------------------------------------------------------
@dataclass
class Result:
    names: List[str]
    types: List[LogicalType]
    # per column: (values, validity|None, dict_values|None) — host, compacted
    columns: List[Tuple[np.ndarray, Optional[np.ndarray], Optional[np.ndarray]]]
    nrows: int

    def fetchall(self):
        return self.rows()

    def rows(self) -> List[tuple]:
        """Python-value rows (DECIMAL → decimal.Decimal, DATE → datetime.date)."""
        pycols = []
        for (vals, valid, dvals), t in zip(self.columns, self.types):
            out = []
            for i in range(self.nrows):
                if valid is not None and not valid[i]:
                    out.append(None)
                    continue
                v = vals[i]
                if t.id is TypeId.VARCHAR:
                    out.append(str(dvals[v]))
                elif t.id is TypeId.DECIMAL:
                    out.append(pydec.Decimal(int(v)).scaleb(-t.scale))
                elif t.id is TypeId.HUGEINT:
                    out.append(int(v))
                elif t.id is TypeId.INTERVAL:
                    out.append(datetime.timedelta(microseconds=int(v)))
                elif t.id is TypeId.DATE:
                    out.append(datetime.date(1970, 1, 1) + datetime.timedelta(days=int(v)))
                elif t.id is TypeId.TIMESTAMP:
                    out.append(datetime.datetime(1970, 1, 1)
                               + datetime.timedelta(microseconds=int(v)))
                elif t.id is TypeId.TIME:
                    us = int(v)
                    out.append(datetime.time(us // 3_600_000_000, us // 60_000_000 % 60,
                                             us // 1_000_000 % 60, us % 1_000_000))
                elif t.id is TypeId.BOOLEAN:
                    out.append(bool(v))
                elif t.is_float:
                    out.append(float(v))
                elif t.is_integer:
                    out.append(int(v))
                else:
                    raise not_ported(f"materializing {t!r} values")
            pycols.append(out)
        return [tuple(c[i] for c in pycols) for i in range(self.nrows)]


class Executor:
    def __init__(self, catalog: Catalog):
        self.catalog = catalog
        self._batch_memo = {}

    # -- entry ---------------------------------------------------------------
    def run(self, plan: P.PlanNode, output: List[Tuple[str, str, LogicalType]]) -> Result:
        self._batch_memo = {}
        batch = self.execute(plan)
        n = batch.count_live()
        idx, _ = compact_indices(batch.live, max(1, pad_bucket(n)))
        idx = idx[:n]
        columns = []
        for _, key, _ in output:
            c = batch.src[key]
            d = bcast(c.data, batch.plen)[idx].cpu().numpy()
            v = (_full_valid(c, batch.plen)[idx].cpu().numpy()
                 if c.validity is not None else None)
            if c.data_hi is not None:
                # exact 128-bit recombination on host: hi·2^64 + uint64(lo)
                dh = bcast(c.data_hi, batch.plen)[idx].cpu().numpy()
                d = np.array([int(h) * (1 << 64) + (int(lo) & ((1 << 64) - 1))
                              for h, lo in zip(dh, d)], dtype=object)
            columns.append((d, v, c.dict_values))
        return Result(names=[n_ for n_, _, _ in output],
                      types=[t for _, _, t in output], columns=columns, nrows=n)

    def execute(self, node: P.PlanNode) -> Batch:
        b = self._batch_memo.get(id(node))
        if b is None:
            m = getattr(self, "_exec_" + type(node).__name__, None)
            if m is None:
                raise not_ported(f"the plan node {type(node).__name__}")
            b = m(node)
            self._batch_memo[id(node)] = b
        return b

    # -- scans / filters / projections ---------------------------------------
    def _exec_Scan(self, node: P.Scan) -> Batch:
        entry = self.catalog.get_table(node.table)
        plen = max(128, pad_bucket(entry.nrows))
        keymap = {key: col for col, key, _ in node.cols}
        live = torch.arange(plen, device=self.catalog.device) < entry.nrows
        return Batch(src=TableCols(entry, keymap, plen), plen=plen, live=live)

    def _exec_Filter(self, node: P.Filter) -> Batch:
        from duckdb_tpu_torch.execution.tracing import run_jitted

        b = self.execute(node.child)

        def body(env):
            c = node.expr.eval(env)
            keep = bcast(c.data.to(torch.bool), b.plen) & _full_valid(c, b.plen)
            return env.live & keep  # NULL → reject

        return Batch(src=b.src, plen=b.plen, live=run_jitted(b, [node.expr], body))

    def _exec_Project(self, node: P.Project) -> Batch:
        b = self.execute(node.child)
        env = b.env()
        cols = {}
        for key, expr in node.items:
            c = expr.eval(env)
            cols[key] = Column(data=bcast(c.data, b.plen), ltype=c.ltype,
                               validity=c.validity, dict_values=c.dict_values,
                               data_hi=c.data_hi)
        # keep the child source reachable for ORDER BY exprs over input cols
        return Batch(src=ChainCols([DictCols(cols), b.src]), plen=b.plen, live=b.live)

    def _exec_Aggregate(self, node: P.Aggregate) -> Batch:
        from duckdb_tpu_torch.execution.fused_agg import try_fused_aggregate

        fused = try_fused_aggregate(self, node)
        if fused is None:
            raise not_ported("this aggregate shape (joins, unbounded group keys, "
                             "or a grouped subquery input)")
        return fused

    # -- order / limit --------------------------------------------------------
    def _order_norm_keys(self, node: P.Order, b: Batch):
        env = b.env()
        norm = []
        for expr, desc, nulls_first in node.items:
            c = expr.eval(env)
            nulls_first = bool(nulls_first)  # duckdb default NULLS LAST
            data = bcast(c.data, b.plen)
            if c.data_hi is not None:
                # wide value: lexicographic (hi, unsigned-low) key pair
                norm.append(S.orderable_int64(bcast(c.data_hi, b.plen), c.validity,
                                              desc, nulls_first))
                data = data.to(torch.int64) ^ _I64_MIN
            norm.append(S.orderable_int64(data, c.validity, desc, nulls_first))
        return norm

    def _exec_Order(self, node: P.Order) -> Batch:
        b = self.execute(node.child)
        perm = S.sort_permutation(self._order_norm_keys(node, b), b.live)
        live = torch.arange(b.plen, device=b.live.device) < b.count_live()
        return Batch(src=GatherCols(b.src, perm), plen=b.plen, live=live)

    def _exec_Limit(self, node: P.Limit) -> Batch:
        b = self.execute(node.child)
        n = b.count_live()
        idx, _ = compact_indices(b.live, max(1, pad_bucket(n)))
        lo = min(node.offset, n)
        hi = n if node.n is None else min(n, lo + node.n)
        cap = max(128, pad_bucket(hi - lo))
        pos = torch.arange(cap, device=b.live.device)
        rows = idx[(pos + lo).clamp(0, idx.shape[0] - 1)]
        return Batch(src=GatherCols(b.src, rows), plen=cap, live=pos < hi - lo)
