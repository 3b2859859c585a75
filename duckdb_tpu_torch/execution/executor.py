"""Plan executor: eager torch ops over padded columnar batches.

Replaces the reference's pull/push pipeline interpreter
(duckdb/src/parallel/pipeline_executor.cpp) with host-driven execution of
plan nodes, each a handful of torch ops over an entire padded block on the
connection's device. As in the JAX package, a Batch's columns are lazy:
a join, ORDER BY or LIMIT stores gather indices and only materializes the
planes downstream operators touch. Inner equi-joins pack their keys into
one int64 per row and take a direct-address table when the build keys are
unique (the output keeps the probe's shape), else a sorted build with pair
expansion. Semi and anti joins (EXISTS, IN and their negations, NOT IN
null-aware) reuse both paths and keep the probe's rows that did or did
not match; a residual is evaluated on the matched build row or over the
expanded pairs. A left join keeps the probe's shape on the direct-address
path (build columns NULL where nothing matched); left joins with duplicate
build keys and every full join expand the pairs and append the unmatched
rows, NULL-extended. A join without keys is an inequality join (the build
sorted once, each probe row's candidate range found by searchsorted, the
conditions checked over the candidate pairs) or a cross expansion; an
ASOF join finds each probe row's nearest build row with one
searchsorted; NOT IN with a residual counts, per probe row, the build
rows its correlation selects. Set operations concatenate their inputs
(dictionaries merged); INTERSECT and EXCEPT repeat each grouped tuple as
SQL's multiset rules say. A sample narrows the live mask from a
torch.Generator on the device. Host syncs happen where a size is needed
(group count, live count, pair count); PyTorch runs eagerly, so a size is
read when it is needed instead of learned across runs. ListPack (a
columnar list_value) and Unnest build nested values from whole columns on
the host, one transfer per column, and Result.rows converts nested values
at every depth.
"""

from __future__ import annotations

import collections
import contextlib
import datetime
import decimal as pydec
import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from duckdb_tpu_torch.blocks import Column, pad_bucket
from duckdb_tpu_torch.blocks.nested import (UNSORTED_DICT_IDS, merged_rank_luts, order_data,
                                            to_result)
from duckdb_tpu_torch.catalog.catalog import Catalog, TableEntry
from duckdb_tpu_torch.ops import join as J
from duckdb_tpu_torch.ops import sort as S
from duckdb_tpu_torch.ops.compact import packed_indices
from duckdb_tpu_torch.planner import plan as P
from duckdb_tpu_torch.planner import bound as B
from duckdb_tpu_torch.planner.bound import BindError, EvalEnv, bcast, not_ported
from duckdb_tpu_torch.types import SQLNULL, LogicalType, TypeId

_I64_MIN = torch.iinfo(torch.int64).min
_I64_MAX = torch.iinfo(torch.int64).max


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

    def __init__(self, parent: ColSource, rows: torch.Tensor,
                 null_rows: Optional[torch.Tensor] = None):
        self.parent = parent
        self.rows = rows  # (P',) int64 indices into the parent block; may be -1
        self.null_rows = null_rows  # bool (P',): True → the row is NULL (outer joins)
        self._cache: Dict[str, Column] = {}

    def __getitem__(self, key: str) -> Column:
        if key in self._cache:
            return self._cache[key]
        col = self.parent[key]
        idx = self.rows.clamp(0, col.data.shape[0] - 1)

        def take(x):
            return None if x is None else x[idx]

        validity = take(col.validity)
        if self.null_rows is not None:
            validity = ~self.null_rows if validity is None else validity & ~self.null_rows
        out = Column(data=take(col.data), ltype=col.ltype, validity=validity,
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


def _reads(batch: "Batch", expr: B.BoundExpr) -> bool:
    """True if every column `expr` reads is one of `batch`'s."""
    return all(n.key in batch.src for n in B.walk(expr)
               if isinstance(n, (B.BoundColumnRef, B.BoundAggregateRef)))


# an inequality with its sides swapped
_FLIP = {">=": "<=", ">": "<", "<=": ">=", "<": ">"}


def _full_valid(c: Column, plen: int) -> torch.Tensor:
    if c.validity is None:
        return torch.ones(plen, dtype=torch.bool, device=c.data.device)
    return bcast(c.validity, plen)


def sort_keys(c: Column, plen: int, desc: bool, nulls_first: bool) -> List[torch.Tensor]:
    """A column's normalized int64 sort keys (ops/sort.orderable_int64), in
    DuckDB's order: a VARCHAR by its sorted dictionary's codes, a nested
    value by its rank, a wide value as its (high, unsigned low) pair."""
    data = bcast(c.data, plen)
    if c.ltype.id in UNSORTED_DICT_IDS:
        data = order_data(c, plen)  # first-seen codes → DuckDB's ranks
    keys = []
    if c.data_hi is not None:
        keys.append(S.orderable_int64(bcast(c.data_hi, plen), c.validity, desc, nulls_first))
        data = data.to(torch.int64) ^ _I64_MIN
    keys.append(S.orderable_int64(data, c.validity, desc, nulls_first))
    return keys


def concat_packed(parts, types) -> Tuple[int, List[Column]]:
    """Concatenate packed column sets [(n, [Column per type])], each with
    its n live rows first, into one packed set → (total, columns), padded
    as a table's are. VARCHAR and BLOB dictionaries merge into one sorted
    dictionary (a side without one, such as a NULL constant's, adds
    nothing); the nested types' first-seen dictionaries are concatenated,
    each side's codes shifted past the ones before."""
    total = sum(n for n, _ in parts)
    cap = max(128, pad_bucket(total))
    device = parts[0][1][0].data.device if parts and parts[0][1] else torch.device("cpu")
    out = []
    for ci, t in enumerate(types):
        cols = [(n, cs[ci]) for n, cs in parts]
        datas = [c.data[:n] for n, c in cols]
        dvals = None
        if t.id in (TypeId.VARCHAR, TypeId.BLOB):
            dicts = [np.empty(0, dtype=object) if c.dict_values is None
                     else np.asarray(c.dict_values, dtype=object) for _, c in cols]
            dvals = np.unique(np.concatenate(dicts)) if any(len(d) for d in dicts) \
                else np.array([""], dtype=object)
            for i, d in enumerate(dicts):
                lut = torch.from_numpy(np.searchsorted(dvals, d).astype(np.int64)
                                       if len(d) else np.zeros(1, np.int64)).to(device)
                datas[i] = lut[datas[i].long().clamp(0, lut.shape[0] - 1)].to(torch.int32)
        elif t.id in UNSORTED_DICT_IDS:
            merged, shift = [], 0
            for i, (_, c) in enumerate(cols):
                d = [] if c.dict_values is None else list(c.dict_values)
                datas[i] = datas[i].to(torch.int32) + shift
                merged += d
                shift += len(d)
            dvals = np.empty(max(len(merged), 1), dtype=object)
            for i, v in enumerate(merged):
                dvals[i] = v
        dtype = datas[0].dtype
        for d in datas[1:]:
            dtype = torch.promote_types(dtype, d.dtype)
        data = torch.zeros(cap, dtype=dtype, device=device)
        valid = torch.zeros(cap, dtype=torch.bool, device=device)
        wide = any(c.data_hi is not None for _, c in cols)
        hi = torch.zeros(cap, dtype=torch.int64, device=device) if wide else None
        at = 0
        for (n, c), d in zip(cols, datas):
            data[at:at + n] = d
            valid[at:at + n] = c.validity[:n] if c.validity is not None else True
            if wide:
                # a narrow side sign-extends into the high plane
                hi[at:at + n] = c.data_hi[:n] if c.data_hi is not None \
                    else torch.where(d < 0, -1, 0)
            at += n
        out.append(Column(data=data, ltype=t, validity=valid, dict_values=dvals, data_hi=hi))
    return total, out


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

    def fetchone(self):
        """The first row, or None when there is none: row 0 of each host
        plane, with no other row's Python values built."""
        return self.rows(0, 1)[0] if self.nrows else None

    def fetchnumpy(self) -> Dict[str, np.ndarray]:
        """{name: host numpy array}, with no pandas: a number or BOOLEAN
        column as an array of its type (DATE as datetime64[D], TIMESTAMP as
        datetime64[us]), masked where NULL; another column as an object
        array of its Python values, None for NULL."""
        out, rows, n = {}, None, self.nrows
        for i, (name, t, (vals, valid, _)) in enumerate(zip(self.names, self.types,
                                                            self.columns)):
            vals = np.asarray(vals)[:n]
            if vals.dtype != object and (t.is_float or t.id is TypeId.BOOLEAN or (
                    t.is_integer and t.id is not TypeId.HUGEINT)):
                arr = vals.astype(t.np_dtype, copy=False)
            elif t.id is TypeId.DATE:
                arr = vals.astype("datetime64[D]")
            elif t.id is TypeId.TIMESTAMP:
                arr = vals.astype("datetime64[us]")
            else:
                rows = self.rows() if rows is None else rows
                arr = np.empty(n, dtype=object)
                for j, r in enumerate(rows):
                    arr[j] = r[i]
                out[name] = arr
                continue
            if valid is not None and not np.asarray(valid)[:n].all():
                arr = np.ma.masked_array(arr, mask=~np.asarray(valid)[:n])
            out[name] = arr
        return out

    def df(self):
        """A pandas DataFrame of the rows (pandas imported here)."""
        from duckdb_tpu_torch.api.arrow_interop import result_df

        return result_df(self)

    def arrow(self):
        """The result as an Arrow table through Arrow's C stream interface
        (api/arrow_interop.ArrowTable: `pyarrow.table(res.arrow())`, or
        `Connection.from_arrow`), built from the host planes with no row
        loop and no Arrow library."""
        from duckdb_tpu_torch.api.arrow_interop import ArrowTable

        return ArrowTable(self)

    fetch_arrow_table = arrow

    def fetch_record_batch(self, rows_per_batch: int = 1_000_000):
        """The result as a stream of ceil(n / rows_per_batch) Arrow record
        batches (api/arrow_interop.ArrowBatchReader)."""
        from duckdb_tpu_torch.api.arrow_interop import ArrowBatchReader

        return ArrowBatchReader(self, rows_per_batch)

    record_batch = fetch_record_batch
    fetch_arrow_reader = fetch_record_batch

    def rows(self, start: int = 0, stop: Optional[int] = None) -> List[tuple]:
        """Python-value rows (DECIMAL → decimal.Decimal, DATE → datetime.date),
        of all rows or of [start, stop)."""
        span = range(start, self.nrows if stop is None else min(stop, self.nrows))
        pycols = []
        for (vals, valid, dvals), t in zip(self.columns, self.types):
            out = []
            for i in span:
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
                elif t.id is TypeId.TIMESTAMPTZ:
                    out.append(datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)
                               + datetime.timedelta(microseconds=int(v)))
                elif t.id is TypeId.BLOB:
                    out.append(bytes(dvals[v]))
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
                elif t.id in UNSORTED_DICT_IDS:
                    # LIST/ARRAY → list, STRUCT → dict, MAP → dict, UNION →
                    # its value, BIT → str, at every depth
                    out.append(to_result(dvals[v], t))
                else:
                    raise not_ported(f"materializing {t!r} values")
            pycols.append(out)
        return [tuple(c[i] for c in pycols) for i in range(len(span))]


# the duckdb_logs() line of each sharded route: (type, message), the JAX
# package's type and first words
_SHARD_LOG = {
    "exchange_join": ("exchange_join", "join repartitioned over {n} shards"),
    "exchange_join_dup": ("exchange_join", "dup-key join repartitioned over {n} shards"),
    "sharded_sort": ("sharded_sort", "ORDER BY range-partitioned over {n} shards"),
    "sharded_topn": ("sharded_topn", "TopN over {n} shards: local top-k + candidate merge"),
    "sharded_window": ("sharded_window", "window hash-partitioned over {n} shards"),
}


class Executor:
    def __init__(self, catalog: Catalog, routes: Optional[collections.Counter] = None):
        self.catalog = catalog
        self._batch_memo = {}
        # the paths queries took: "dense" / "sort_group" grouping,
        # "probe_dense" / "probe_sorted" fused join-step probes,
        # "fused_semi" / "fused_anti" fused membership steps, and
        # "eager_semi" / "eager_anti" / "eager_left" / "eager_full" /
        # "eager_inner_residual" joins run by _exec_Join, "general_aggregate"
        # for each aggregate the fused pipeline refused, with its grouping,
        # "general_perfect" or "general_sort_group", "window" per Window
        # node (the planner adds "cte_materialized" for each CTE it executes
        # at plan time)
        self.routes = collections.Counter() if routes is None else routes
        # table name → the TableEntry a scan reads instead (a chunk of the
        # table, or the merge's partial results: execution/chunked.py)
        self.scan_overrides: Dict[str, TableEntry] = {}

    def get_table(self, name: str) -> TableEntry:
        if name in self.scan_overrides:
            return self.scan_overrides[name]
        return self.catalog.get_table(name)

    # -- settings and the log ----------------------------------------------------
    def _setting_value(self, name: str, default):
        settings = getattr(self.catalog, "settings", None)
        return default if settings is None else settings.get(name, default)

    def _setting(self, name: str, default: int) -> int:
        return int(self._setting_value(name, default))

    def _log(self, level: str, log_type: str, msg: str):
        """An entry in the database's log (duckdb_logs())."""
        log = getattr(self.catalog, "log", None)
        if log is not None:
            log.log(level, log_type, msg)

    # -- sharding ------------------------------------------------------------
    def _join_shards(self, rows: Optional[int] = None) -> int:
        """Shard count for a distributed operator over `rows` padded rows.

        num_shards = 1, the port's default, is one device. num_shards = 0
        is the AUTO policy, the JAX package's default: every visible card
        once the operator's rows exceed auto_shard_rows (DuckDB
        parallelizes everything by default with its morsel scheduler,
        src/parallel/task_scheduler.cpp), so one on a host with one card
        and on the CPU; the port keeps it opt-in because on four cards it
        was slower than one (main/settings.py). num_shards = n > 1 gives n
        shards even with fewer cards: they share the cards round-robin
        (parallel/shard.Mesh). The JAX package runs single-chip then; the
        port shares, so that the CPU and a one-card host run the sharded
        code at all."""
        from duckdb_tpu_torch.parallel import shard

        n = self._setting("num_shards", 1)
        if n >= 1:
            return n
        k = shard.visible_devices(self.catalog.device)
        if k <= 1 or (rows is not None and rows < self._setting("auto_shard_rows", 1 << 15)):
            return 1
        return k

    def _mesh(self, n: int, op: str):
        """The n-shard mesh on the connection's device, the operator's route
        recorded with how the shards were placed: "sharded" (a card each)
        or "sharded_shared_card" (some share one; on the CPU, all)."""
        from duckdb_tpu_torch.parallel import shard

        mesh = shard.mesh_for(n, self.catalog.device)
        self.routes[op] += 1
        self.routes["sharded_shared_card" if mesh.shared else "sharded"] += 1
        if op in _SHARD_LOG:
            log_type, msg = _SHARD_LOG[op]
            self._log("INFO", log_type, msg.format(n=n))
        return mesh

    def _single_chip(self, reason: str):
        """A sharded operator that runs on one device: its route, and the
        JAX package's WARN line of type sharding."""
        self.routes[f"sharding_single:{reason}"] += 1
        self._log("WARN", "sharding", f"{reason}: runs single-chip")

    # -- entry ---------------------------------------------------------------
    def run(self, plan: P.PlanNode, output: List[Tuple[str, str, LogicalType]]) -> Result:
        """Run a plan to host rows: in chunks when a memory limit is set
        and its scans do not fit (execution/chunked.py), else at once. The
        catalog's log and its pallas_grouped_sum setting hold while it runs
        (ops/strings.ACTIVE_LOG, ops/grouped.KERNEL_MODE)."""
        from duckdb_tpu_torch.execution.chunked import try_chunked

        with self._context():
            if not self.scan_overrides:
                res = try_chunked(self, plan, output)
                if res is not None:
                    return res
            n, cols = self.materialize(plan, output)
            columns = [c.host_values(n) + (c.dict_values,) for c in cols]
            return Result(names=[n_ for n_, _, _ in output],
                          types=[t for _, _, t in output], columns=columns, nrows=n)

    @contextlib.contextmanager
    def _context(self):
        """The catalog's log and pallas_grouped_sum setting, for the ops
        below the executor while it runs."""
        from duckdb_tpu_torch.ops import grouped, strings

        log_tok = strings.ACTIVE_LOG.set(getattr(self.catalog, "log", None))
        mode_tok = grouped.KERNEL_MODE.set(str(self._setting_value("pallas_grouped_sum",
                                                                   "auto")))
        try:
            yield
        finally:
            grouped.KERNEL_MODE.reset(mode_tok)
            strings.ACTIVE_LOG.reset(log_tok)

    def materialize(self, plan: P.PlanNode, output) -> Tuple[int, List[Column]]:
        """Run a plan and keep its rows on the device: → (row count, one
        Column per output item, live rows packed first and padded as a
        catalog table's columns are, the padding zero and invalid)."""
        self._batch_memo = {}
        with self._context():
            return self._packed(self.execute(plan), [key for _, key, _ in output])

    def _packed(self, batch: Batch, keys) -> Tuple[int, List[Column]]:
        """A batch's live rows of `keys`, packed first → (count, Columns)."""
        n = batch.count_live()
        cap = max(128, pad_bucket(n))
        idx = packed_indices(batch.live, cap)
        live = torch.arange(cap, device=batch.live.device) < n

        def take(x):
            return None if x is None else torch.where(
                live, bcast(x, batch.plen)[idx], torch.zeros((), dtype=x.dtype,
                                                             device=x.device))

        columns = []
        for key in keys:
            c = batch.src[key]
            columns.append(Column(data=take(c.data), ltype=c.ltype,
                                  validity=take(c.validity), dict_values=c.dict_values,
                                  data_hi=take(c.data_hi)))
        return n, columns

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
        entry = self.get_table(node.table)
        plen = max(128, pad_bucket(entry.nrows))
        keymap = {key: col for col, key, _ in node.cols}
        live = torch.arange(plen, device=self.catalog.device) < entry.nrows
        return Batch(src=TableCols(entry, keymap, plen), plen=plen, live=live)

    def _exec_ConstantRow(self, node: P.ConstantRow) -> Batch:
        live = torch.arange(128, device=self.catalog.device) == 0
        return Batch(src=DictCols({}), plen=128, live=live)

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
        """The fused pipeline first; what it refuses takes the general path
        (aggregate_exec) over the executed child, as in the JAX package."""
        from duckdb_tpu_torch.execution.aggregate_exec import execute_aggregate
        from duckdb_tpu_torch.execution.fused_agg import try_fused_aggregate

        fused = try_fused_aggregate(self, node)
        if fused is not None:
            return fused
        self.routes["general_aggregate"] += 1
        return execute_aggregate(self, self.execute(node.child), node)

    # -- joins ---------------------------------------------------------------
    def _join_keys(self, batch: Batch, key_exprs):
        """Evaluate equi-key exprs → (per-key Columns, key_valid mask)."""
        env = batch.env()
        cols, valid = [], torch.ones(batch.plen, dtype=torch.bool, device=batch.live.device)
        for e in key_exprs:
            c = e.eval(env)
            cols.append(c)
            valid = valid & _full_valid(c, batch.plen)
        return cols, valid

    def _key_bounds(self, batch: Batch, expr) -> Optional[Tuple[int, int]]:
        """Static value bounds for a join-key expr, from table stats."""
        if isinstance(expr, B.BoundColumnRef):
            try:
                return batch.src.stats_range(expr.key)
            except KeyError:
                return None
        return None

    def _pack_keys(self, probe_b: Batch, build_b: Batch, probe_keys, build_keys):
        """Pack multi-column equi-keys into one int64 per side.

        Per-key value ranges come from table stats when available (the
        zone-map analog of duckdb sizing its perfect-hash join from stats,
        perfect_hash_join_executor.cpp), else one device min/max read over
        the build side. → (packed probe, probe key valid, packed build,
        build key valid, dense size Π(range + 1)).
        """
        p_cols, p_valid = self._join_keys(probe_b, probe_keys)
        b_cols, b_valid = self._join_keys(build_b, build_keys)
        device = probe_b.live.device
        packed_p = torch.zeros(probe_b.plen, dtype=torch.int64, device=device)
        packed_b = torch.zeros(build_b.plen, dtype=torch.int64, device=device)
        dense_size = 1
        for i, (pc, bc) in enumerate(zip(p_cols, b_cols)):
            if pc.ltype.id is TypeId.VARCHAR or pc.ltype.id in UNSORTED_DICT_IDS:
                # two dictionaries: compare ranks in one merged order
                lp, lb = (B._varchar_rank_luts(pc, bc, device) if pc.ltype.id is TypeId.VARCHAR
                          else merged_rank_luts(pc, bc, device))
                pd = lp[bcast(pc.data, probe_b.plen).long().clamp(0, len(lp) - 1)].long()
                bd = lb[bcast(bc.data, build_b.plen).long().clamp(0, len(lb) - 1)].long()
                lo, hi = 0, max(int(lp.shape[0]), int(lb.shape[0]))
            else:
                pd = bcast(pc.data, probe_b.plen).to(torch.int64)
                bd = bcast(bc.data, build_b.plen).to(torch.int64)
                bounds = self._key_bounds(build_b, build_keys[i])
                if bounds is None:
                    blive = build_b.live & b_valid
                    if not bool(blive.any()):
                        bounds = (0, 0)
                    else:
                        bounds = (int(torch.where(blive, bd, _I64_MAX).min()),
                                  int(torch.where(blive, bd, _I64_MIN).max()))
                lo, hi = bounds
            rng = hi - lo + 1
            # probe values outside [lo, hi] clip to the -1 / rng sentinels of
            # their digit, which no in-range packed build key can equal
            packed_p = packed_p * (rng + 1) + (pd - lo).clamp(-1, rng)
            packed_b = packed_b * (rng + 1) + (bd - lo).clamp(-1, rng)
            dense_size *= rng + 1
        return packed_p, p_valid, packed_b, b_valid, dense_size

    # direct-address join table cap (int64 slots: 1 GiB)
    DENSE_JOIN_LIMIT = 1 << 27

    # eager-join build cache row cap: cached Batches pin device planes
    EAGER_BUILD_CACHE_MAX = 1 << 25

    def _exec_Join(self, node: P.Join) -> Batch:
        if node.jtype not in ("inner", "semi", "anti", "left", "full", "asof", "asof_left"):
            raise not_ported(f"{node.jtype} joins")
        asof = node.jtype in ("asof", "asof_left")
        if node.jtype != "inner":
            self.routes["eager_" + node.jtype] += 1
        elif node.extra is not None and node.probe_keys:
            self.routes["eager_inner_residual"] += 1
        probe_b = self.execute(node.probe)
        build_b = self._exec_build_cached(node)
        if node.null_aware and node.extra is not None:
            return self._null_aware_residual(node, probe_b, build_b)
        if not node.probe_keys and not asof:
            # no equi key: the inequality join, else a cross expansion,
            # with the conditions as the residual
            out = self._ie_join(node, probe_b, build_b)
            return out if out is not None else self._keyless_cross(node, probe_b, build_b)
        pk, p_valid, bk, b_valid, dense_size = self._pack_keys(
            probe_b, build_b, node.probe_keys, node.build_keys)
        build_live = build_b.live & b_valid
        probe_live = probe_b.live & p_valid
        if asof:
            return self._asof_join(node, probe_b, build_b, pk, bk, probe_live, build_live)
        if node.jtype in ("inner", "semi"):
            # runtime join-filter pushdown (BuildPrefixRangeFilter analog,
            # reference join_hashtable.cpp:1011): tighten the probe mask by
            # the build's actual packed-key range, on the device. Anti and
            # outer probes must keep their non-matching rows, so not for them.
            blo = torch.where(build_live, bk, _I64_MAX).min()
            bhi = torch.where(build_live, bk, _I64_MIN).max()
            probe_live = probe_live & (pk >= blo) & (pk <= bhi)
        if node.jtype in ("semi", "anti") and node.extra is not None:
            out = self._try_semi_neq(node, probe_b, build_b)
            if out is not None:
                return out
        unique = self._build_known_unique(node, build_b)
        n_shards = self._join_shards(rows=max(probe_b.plen, build_b.plen))
        if n_shards > 1 and dense_size > self._setting("exchange_join_threshold", 1 << 24):
            exchange = self._exchange_join if unique else self._exchange_join_dup
            out = exchange(node, probe_b, build_b, pk, bk, probe_live, build_live, n_shards)
            if out is not None:
                return out
            self._single_chip(f"{node.jtype} join")
        # a full join's unmatched build rows come from the pair expansion
        if node.jtype != "full" and dense_size <= self.DENSE_JOIN_LIMIT:
            out = self._dense_join(node, probe_b, build_b, pk, bk, probe_live,
                                   build_live, dense_size, known_unique=unique)
            if out is not None:
                return out
        return self._sorted_join(node, probe_b, build_b, pk, bk, probe_live, build_live)

    def _exec_build_cached(self, node: P.Join) -> Batch:
        """Execute the build side with a batch cache on the join node, keyed
        by every scanned (table, rows, version) under the build: a warm query
        skips the whole build subtree."""
        from duckdb_tpu_torch.execution.fused_agg import _cache_store, _scan_versions

        vkey = _scan_versions(self, node.build)
        if vkey is None:
            return self.execute(node.build)
        cache = _cache_store(node, "_eager_build_cache")
        hit = cache.get(vkey)
        if hit is not None:
            return hit
        build_b = self.execute(node.build)
        if build_b.plen <= self.EAGER_BUILD_CACHE_MAX:
            cache.clear()
            cache[vkey] = build_b
        return build_b

    def _build_known_unique(self, node, build_b) -> bool:
        """True if catalog stats prove the build key is row-unique, which
        skips runtime duplicate checks (host syncs). A composite key is
        unique if the subset owned by ANY single table is already unique."""
        if not node.build_keys or not all(
                isinstance(e, (B.BoundColumnRef, B.BoundAggregateRef))
                for e in node.build_keys):
            return False
        keys = [e.key for e in node.build_keys]

        # GROUP BY outputs are unique by construction: a build side that is
        # (Filter/Project)*(Aggregate) with the join keys covering the
        # aggregate's full group-key set has one row per key tuple
        b = node.build
        akeys = list(keys)
        while isinstance(b, (P.Project, P.Filter)):
            if isinstance(b, P.Project):
                remap = dict(b.items)
                akeys = [remap[k].key if isinstance(
                    remap.get(k), (B.BoundColumnRef, B.BoundAggregateRef)) else k
                    for k in akeys]
            b = b.child
        if isinstance(b, P.Aggregate) and b.groups:
            if set(akeys) >= {gk for gk, _ in b.groups}:
                return True
        if not all(isinstance(e, B.BoundColumnRef) for e in node.build_keys):
            return False
        # walk chain sources to the TableCols owning each key. GatherCols is
        # opaque: a gather may duplicate rows (join expansion), which
        # destroys key uniqueness even when the table column is unique.
        per_entry: Dict[int, Tuple[TableEntry, list]] = {}
        stack = [build_b.src]
        n_found = 0
        while stack and n_found < len(keys):
            s_ = stack.pop()
            if isinstance(s_, ChainCols):
                stack.extend(s_.sources)
            elif isinstance(s_, TableCols):
                owned = [k for k in keys if k in s_.keymap]
                if owned:
                    ent, cols = per_entry.setdefault(id(s_.entry), (s_.entry, []))
                    cols.extend(s_.keymap[k] for k in owned)
                    n_found += len(owned)
        for ent, cols in per_entry.values():
            if len(cols) == 1:
                if ent.distinct_count(cols[0]) == ent.nrows:
                    return True
            elif ent.composite_unique(tuple(cols)):
                return True
        return False

    def _dense_join(self, node, probe_b, build_b, pk, bk, probe_live, build_live,
                    size, known_unique=False) -> Optional[Batch]:
        """Perfect direct-address join (unique build keys): probe = 1 gather.

        The duckdb PerfectHashJoinExecutor analog
        (duckdb/src/execution/operator/join/perfect_hash_join_executor.cpp).
        The output keeps the PROBE block shape (mask, no expansion). Dead
        build rows land in a spare slot past the table; an unproven build
        is checked for duplicate keys first (one host read) and goes to
        the sorted path if it has any.
        """
        device = bk.device
        slot = torch.where(build_live, bk.clamp(0, size), size)
        if not known_unique:
            occ = torch.zeros(size + 1, dtype=torch.int64, device=device)
            occ.index_add_(0, slot, torch.ones_like(slot))
            if int(occ[:size].max()) > 1:
                return None  # duplicate build keys → sorted path
        slots = torch.full((size + 1,), -1, dtype=torch.int64, device=device)
        slots[slot] = torch.where(build_live, torch.arange(build_b.plen, device=device), -1)
        brow, matched = self._probe_dense(node, slots, size, pk, probe_live)
        return self._one_match_tail(node, probe_b, build_b, brow, matched, probe_live,
                                    build_live)

    def _probe_dense(self, node, slots, size, pk, probe_live):
        """Dense-table probe → (build row or -1, matched). Sharded, the
        table is copied to each shard's device (DuckDB's broadcast
        exchange, src/parallel/pipeline_broadcast_exchange.cpp) and each
        shard probes its rows."""
        from duckdb_tpu_torch.parallel import shard

        def probe(slots, pk, probe_live):
            in_range = (pk >= 0) & (pk < size)
            brow = torch.where(in_range, slots[pk.clamp(0, size - 1)], -1)
            return brow, probe_live & (brow >= 0)

        n = self._join_shards(rows=pk.shape[0])
        if n <= 1:
            return probe(slots, pk, probe_live)
        mesh = self._mesh(n, "sharded_probe")
        parts = [probe(*a) for a in zip(self._replicas(node, mesh, slots),
                                        shard.split_rows(mesh, pk),
                                        shard.split_rows(mesh, probe_live))]
        return shard.gather(mesh, [b for b, _ in parts]), shard.gather(mesh, [m for _, m in parts])

    def _replicas(self, node, mesh, slots):
        """The dense table on every shard's device. The table is a function
        of the join's inputs, so the copies are kept on the join node keyed
        by every scan under it, as the build caches are: a warm query
        copies nothing between cards."""
        from duckdb_tpu_torch.execution.fused_agg import _cache_store, _scan_versions
        from duckdb_tpu_torch.parallel import shard

        vkey = _scan_versions(self, node)
        if vkey is None or slots.shape[0] > self.EAGER_BUILD_CACHE_MAX:
            return shard.replicate(mesh, slots)
        key = (vkey, slots.shape[0], tuple(mesh.devices))
        cache = _cache_store(node, "_replica_cache")
        hit = cache.get(key)
        if hit is None:
            cache.clear()
            hit = cache[key] = shard.replicate(mesh, slots)
        return hit

    def _exchange_join(self, node, probe_b, build_b, pk, bk, probe_live, build_live, n):
        """A join over the mesh with unique build keys: both sides
        hash-repartitioned, each shard's partition joined there
        (parallel/shard.make_exchange_join). Inner, left, semi and anti
        joins, a residual evaluated on the matched build row; a left join
        routes every live probe row (a NULL key as -2, which no live
        build key equals: packed build keys are non-negative). The
        output lists the routed probe rows shard by shard. None for other
        join types."""
        from duckdb_tpu_torch.parallel import shard

        if node.jtype not in ("inner", "left", "semi", "anti"):
            return None
        mesh = self._mesh(n, "exchange_join")
        device = pk.device
        route_live = probe_b.live if node.jtype == "left" else probe_live
        res = shard.make_exchange_join(mesh)(
            torch.where(probe_live, pk, -2), route_live,
            torch.arange(probe_b.plen, device=device), bk, build_live,
            torch.arange(build_b.plen, device=device))
        rp, br = shard.gather(mesh, res.rp), shard.gather(mesh, res.br)
        total = rp.shape[0]
        if node.jtype in ("semi", "anti"):
            matched = self._residual_on(node, probe_b, build_b, rp, br)
            hit = torch.zeros(probe_b.plen, dtype=torch.bool, device=device)
            hit[rp] = matched  # each routed probe row once
            return self._semi_anti_tail(node, probe_b, build_b, hit, probe_live, build_live)
        cap = max(128, pad_bucket(total))
        rp_p = torch.zeros(cap, dtype=torch.int64, device=device)
        rp_p[:total] = rp
        br_p = torch.full((cap,), -1, dtype=torch.int64, device=device)
        br_p[:total] = br
        routed = torch.arange(cap, device=device) < total
        matched = routed & self._residual_on(node, probe_b, build_b, rp_p, br_p)
        br_c = br_p.clamp(0, build_b.plen - 1)
        if node.jtype == "inner":
            src = ChainCols([GatherCols(probe_b.src, rp_p), GatherCols(build_b.src, br_c)])
            return Batch(src=src, plen=cap, live=matched)
        src = ChainCols([GatherCols(probe_b.src, rp_p),
                         GatherCols(build_b.src, br_c, null_rows=~matched)])
        return Batch(src=src, plen=cap, live=routed)

    def _residual_on(self, node, probe_b, build_b, rp, br) -> torch.Tensor:
        """Which (probe row, build row or -1) pairs match: a build row, and
        the join's residual TRUE on the pair where it has one."""
        matched = br >= 0
        if node.extra is None:
            return matched
        n = rp.shape[0]
        pair_src = ChainCols([GatherCols(probe_b.src, rp),
                              GatherCols(build_b.src, br.clamp(0, build_b.plen - 1),
                                         null_rows=~matched)])
        c = node.extra.eval(EvalEnv(cols=pair_src, plen=n, live=matched))
        return matched & bcast(c.data.to(torch.bool), n) & _full_valid(c, n)

    def _exchange_join_dup(self, node, probe_b, build_b, pk, bk, probe_live, build_live, n):
        """A join over the mesh with duplicate build keys
        (parallel/shard.make_exchange_join_dup): inner joins from the
        shards' pairs (a residual evaluated over them), semi and anti
        joins without a residual from each routed probe row's match flag.
        None otherwise."""
        from duckdb_tpu_torch.parallel import shard

        if node.jtype not in ("inner", "semi", "anti") or (
                node.jtype != "inner" and node.extra is not None):
            return None
        mesh = self._mesh(n, "exchange_join_dup")
        device = pk.device
        res = shard.make_exchange_join_dup(mesh)(
            torch.where(probe_live, pk, -2), probe_live,
            torch.arange(probe_b.plen, device=device), bk, build_live,
            torch.arange(build_b.plen, device=device))
        if node.jtype != "inner":
            hit = torch.zeros(probe_b.plen, dtype=torch.bool, device=device)
            hit[shard.gather(mesh, res.prr)] = shard.gather(mesh, res.pm)
            return self._semi_anti_tail(node, probe_b, build_b, hit, probe_live, build_live)
        pr, br = shard.gather(mesh, res.pr), shard.gather(mesh, res.br)
        total = pr.shape[0]
        cap = max(128, pad_bucket(total))
        pr_p = torch.zeros(cap, dtype=torch.int64, device=device)
        pr_p[:total] = pr
        br_p = torch.full((cap,), -1, dtype=torch.int64, device=device)
        br_p[:total] = br
        live = self._residual_on(node, probe_b, build_b, pr_p, br_p)
        src = ChainCols([GatherCols(probe_b.src, pr_p),
                         GatherCols(build_b.src, br_p.clamp(0, build_b.plen - 1))])
        return Batch(src=src, plen=cap, live=live)

    def _one_match_tail(self, node, probe_b, build_b, brow, matched, probe_live,
                        build_live) -> Batch:
        """Join result when each probe row has ≤1 build match: the output
        keeps the PROBE block shape (mask + gather, no expansion). A
        residual is evaluated on the matched build row, and a NULL result
        does not match. A left join keeps every probe row, its build
        columns NULL where nothing matched (a NULL or out-of-range key
        included)."""
        brow_c = brow.clamp(0, build_b.plen - 1)
        if node.extra is not None:
            pair_src = ChainCols([probe_b.src,
                                  GatherCols(build_b.src, brow_c, null_rows=~matched)])
            c = node.extra.eval(EvalEnv(cols=pair_src, plen=probe_b.plen, live=matched))
            matched = matched & bcast(c.data.to(torch.bool), probe_b.plen) \
                & _full_valid(c, probe_b.plen)
        if node.jtype == "inner":
            src = ChainCols([probe_b.src, GatherCols(build_b.src, brow_c)])
            return Batch(src=src, plen=probe_b.plen, live=matched)
        if node.jtype == "left":
            src = ChainCols([probe_b.src,
                             GatherCols(build_b.src, brow_c, null_rows=~matched)])
            return Batch(src=src, plen=probe_b.plen, live=probe_b.live)
        return self._semi_anti_tail(node, probe_b, build_b, matched, probe_live,
                                    build_live)

    def _semi_anti_tail(self, node, probe_b, build_b, matched, probe_live,
                        build_live) -> Batch:
        """Semi join: the probe rows that matched; anti join: those that did
        not (NOT IN drops more, see _null_aware_anti). The probe's columns
        pass through."""
        if node.jtype == "semi":
            live = probe_b.live & matched
        else:
            live = probe_b.live & ~matched
            if node.null_aware:
                live = self._null_aware_anti(node, live, probe_b, build_b, probe_live,
                                             build_live)
        return Batch(src=probe_b.src, plen=probe_b.plen, live=live)

    def _null_aware_anti(self, node, live, probe_b, build_b, probe_live, build_live):
        """NOT IN semantics (the reference's MARK-join NULL handling). The
        IN key is the last join key; the keys before it are a correlated
        subquery's equalities, and a probe row sees only the build rows
        they select (its group; the whole build when uncorrelated). Over a
        non-empty group, a NULL probe key is never TRUE, and a NULL build
        key makes `x NOT IN (…)` at best NULL, so the row goes. Over an
        empty group, NOT IN is TRUE, NULL keys included."""
        if len(node.probe_keys) == 1:
            group_empty = ~build_b.live.any()
            group_has_null = (build_b.live & ~build_live).any()
        else:
            pk, pv, bk, bv, _ = self._pack_keys(probe_b, build_b, node.probe_keys[:-1],
                                                node.build_keys[:-1])
            in_group = build_b.live & bv
            _, y_valid = self._join_keys(build_b, node.build_keys[-1:])
            pv = probe_b.live & pv
            n_rows, _, _ = J.probe_counts(J.build_sorted(bk, in_group), pk, pv)
            n_null, _, _ = J.probe_counts(J.build_sorted(bk, in_group & ~y_valid), pk, pv)
            group_empty, group_has_null = n_rows == 0, n_null > 0
        null_probe = probe_b.live & ~probe_live
        return (live & ~null_probe & ~group_has_null) | (probe_b.live & group_empty)

    def _try_semi_neq(self, node, probe_b, build_b) -> Optional[Batch]:
        """Semi/anti join with one `probe.c <> build.c` residual and no pair
        expansion: EXISTS(key match ∧ build.c ≠ probe.c ∧ build.c NOT NULL)
        ⟺ count(key) > count(key, c), counting only build rows whose c is
        not NULL (an IN subquery's `<>` correlation, in two count probes;
        the planner rewrites EXISTS's to min/max)."""
        e = node.extra
        if isinstance(e, B.BoundConjunction) and e.op == "and" and len(e.exprs) == 1:
            e = e.exprs[0]  # the planner's AND over the correlated predicates
        if not (isinstance(e, B.BoundComparison) and e.op in ("<>", "!=")):
            return None

        if _reads(probe_b, e.left) and _reads(build_b, e.right):
            e_probe, e_build = e.left, e.right
        elif _reads(probe_b, e.right) and _reads(build_b, e.left):
            e_probe, e_build = e.right, e.left
        else:
            return None
        pk1, p1v, bk1, b1v, _ = self._pack_keys(probe_b, build_b, node.probe_keys,
                                                node.build_keys)
        pk2, p2v, bk2, b2v, _ = self._pack_keys(probe_b, build_b,
                                                node.probe_keys + [e_probe],
                                                node.build_keys + [e_build])
        b_extra_valid = _full_valid(e_build.eval(build_b.env()), build_b.plen)
        t1 = J.build_sorted(bk1, build_b.live & b1v & b_extra_valid)
        c1, _, _ = J.probe_counts(t1, pk1, probe_b.live & p1v)
        t2 = J.build_sorted(bk2, build_b.live & b2v)
        c2, _, _ = J.probe_counts(t2, pk2, probe_b.live & p2v)
        # a NULL probe value makes ≠ NULL: never matched
        matched = (c1 > c2) & p2v
        live = probe_b.live & (matched if node.jtype == "semi" else ~matched)
        return Batch(src=probe_b.src, plen=probe_b.plen, live=live)

    def _sorted_join(self, node, probe_b, build_b, pk, bk, probe_live,
                     build_live) -> Batch:
        table = J.build_sorted(bk, build_live)
        counts, lo, _ = J.probe_counts(table, pk, probe_live)
        return self._expand_tail(node, probe_b, build_b, counts, lo, table.perm,
                                 probe_live, build_live)

    def _expand_tail(self, node, probe_b, build_b, counts, lo, perm, probe_live,
                     build_live, total: Optional[int] = None) -> Batch:
        """Join result via pair expansion: candidate position lo[row] + k
        (k < counts[row]) maps through `perm` to a build row. The pair
        count is read once from the device (`total`, where the caller has
        read it already). A semi/anti join without a
        residual needs only the counts; with one, the residual is evaluated
        over the expanded pairs and any pair that holds marks its probe
        row. Left and full joins emit the pairs that hold, then the live
        probe rows no pair holds for, then (full) the live build rows no
        pair holds for, each NULL on the other side."""
        if node.jtype in ("semi", "anti") and node.extra is None:
            return self._semi_anti_tail(node, probe_b, build_b, counts > 0, probe_live,
                                        build_live)
        if total is None:
            total = int(counts.sum())
        cap = max(128, pad_bucket(total))
        pr, br, pair_live = J.expand_matches(counts, lo, perm, cap)
        pair_src = ChainCols([GatherCols(probe_b.src, pr), GatherCols(build_b.src, br)])
        if node.extra is not None:
            c = node.extra.eval(EvalEnv(cols=pair_src, plen=cap, live=pair_live))
            pair_live = pair_live & bcast(c.data.to(torch.bool), cap) & _full_valid(c, cap)
        if node.jtype == "inner":
            return Batch(src=pair_src, plen=cap, live=pair_live)
        hits = torch.zeros(probe_b.plen, dtype=torch.int64, device=pr.device)
        hits.index_add_(0, pr, pair_live.to(torch.int64))
        if node.jtype in ("semi", "anti"):
            return self._semi_anti_tail(node, probe_b, build_b, hits > 0, probe_live,
                                        build_live)
        return self._outer_tail(node, probe_b, build_b, pr, br, pair_live, hits > 0)

    def _outer_tail(self, node, probe_b, build_b, pr, br, pair_live, probe_hit) -> Batch:
        """Left / full join output over the expanded pairs: [pairs that hold
        | unmatched probe rows | (full) unmatched build rows]. A build row
        is matched when a pair that holds reaches it, counted with
        index_add_ (a scatter of the pair mask would let CUDA keep any one
        of the duplicate writes). A build row with a NULL key matches
        nothing, so a full join emits it NULL-extended. The three sizes
        are read in one transfer, and with them known the compactions need
        no further read."""
        device = pr.device
        unmatched = probe_b.live & ~probe_hit
        sizes = [pair_live.sum(), unmatched.sum()]
        if node.jtype == "full":
            bhits = torch.zeros(build_b.plen, dtype=torch.int64, device=device)
            bhits.index_add_(0, br, pair_live.to(torch.int64))
            b_unmatched = build_b.live & (bhits == 0)
            sizes.append(b_unmatched.sum())
        sizes = torch.stack(sizes).tolist()
        n_pairs, n_unmatched = sizes[0], sizes[1]
        n_bun = sizes[2] if node.jtype == "full" else 0
        out_cap = max(128, pad_bucket(n_pairs + n_unmatched + n_bun))
        pair_idx = packed_indices(pair_live, out_cap)
        un_idx = packed_indices(unmatched, out_cap)
        pos = torch.arange(out_cap, device=device)
        from_pairs = pos < n_pairs
        un_pos = (pos - n_pairs).clamp(0, out_cap - 1)
        out_probe = torch.where(from_pairs, pr[pair_idx], un_idx[un_pos])
        out_build = torch.where(from_pairs, br[pair_idx], -1)
        null_build = ~from_pairs
        null_probe = None
        if node.jtype == "full":
            bun_idx = packed_indices(b_unmatched, out_cap)
            from_bun = pos >= n_pairs + n_unmatched
            bun_pos = (pos - n_pairs - n_unmatched).clamp(0, out_cap - 1)
            out_build = torch.where(from_bun, bun_idx[bun_pos], out_build)
            null_build = null_build & ~from_bun
            out_probe = torch.where(from_bun, 0, out_probe)
            null_probe = from_bun
        src = ChainCols([GatherCols(probe_b.src, out_probe, null_rows=null_probe),
                         GatherCols(build_b.src, out_build, null_rows=null_build)])
        return Batch(src=src, plen=out_cap, live=pos < n_pairs + n_unmatched + n_bun)

    # -- joins without an equi key ---------------------------------------------
    # the most candidate pairs an inequality join, a cross expansion or NOT
    # IN with a residual makes (the JAX package's IE_PAIR_CAP)
    PAIR_CAP = 1 << 27

    def _check_pairs(self, total: int) -> int:
        """`total` candidate pairs, refused above PAIR_CAP."""
        if total > self.PAIR_CAP:
            from duckdb_tpu_torch.errors import OutOfRangeException

            raise OutOfRangeException(f"Out of Range Error: the join would expand {total} "
                                      f"candidate pairs (the limit is {self.PAIR_CAP})")
        return total

    def _ie_join(self, node: P.Join, probe_b: Batch, build_b: Batch) -> Optional[Batch]:
        """Inequality join (DuckDB's PhysicalIEJoin, physical_iejoin.cpp,
        as the JAX package shapes it): sort the build once by the column
        that the best group of `probe op build` conjuncts compares (a
        lower and an upper bound on one column, peeled of constant shifts,
        make a band), find each probe row's candidate range with one
        searchsorted per conjunct, and expand only those pairs; every
        condition is checked over them as the residual. None when no
        conjunct compares the two sides by <, <=, > or >=, or when a side
        is a string."""
        conds = B.and_terms(node.extra) if node.extra is not None else []

        def peel(e):
            # monotone shifts by a constant keep the sort order
            while True:
                if isinstance(e, B.BoundArithmetic) and e.op in ("+", "-") \
                        and isinstance(e.right, B.BoundLiteral):
                    e = e.left
                elif isinstance(e, B.BoundArithmetic) and e.op == "+" \
                        and isinstance(e.left, B.BoundLiteral):
                    e = e.right
                elif isinstance(e, B.BoundFunction) and e.name in ("__interval_+",
                                                                  "__interval_-") \
                        and isinstance(e.args[1], B.BoundLiteral):
                    e = e.args[0]
                else:
                    return e

        groups: Dict[object, list] = {}
        for c in conds:
            if not (isinstance(c, B.BoundComparison) and c.op in _FLIP):
                continue
            if _reads(probe_b, c.left) and _reads(build_b, c.right):
                op, ep, eb = c.op, c.left, c.right
            elif _reads(probe_b, c.right) and _reads(build_b, c.left):
                op, ep, eb = _FLIP[c.op], c.right, c.left
            else:
                continue
            root = peel(eb)
            gk = ("col", root.key) if isinstance(root, B.BoundColumnRef) else ("id", id(eb))
            groups.setdefault(gk, []).append((op, ep, eb))
        if not groups:
            return None
        # a band (an upper and a lower bound on one column) first
        best = next((g for g in groups.values()
                     if any(op in (">", ">=") for op, _, _ in g)
                     and any(op in ("<", "<=") for op, _, _ in g)),
                    next(iter(groups.values())))
        m, plen = build_b.plen, probe_b.plen
        env_p, env_b = probe_b.env(), build_b.env()
        pairs = []
        for op, ep, eb in best:
            pc, bc = ep.eval(env_p), eb.eval(env_b)
            if TypeId.VARCHAR in (pc.ltype.id, bc.ltype.id) or \
                    pc.ltype.id in UNSORTED_DICT_IDS or bc.ltype.id in UNSORTED_DICT_IDS:
                return None
            pav, bav = B._common_numeric(
                Column(data=bcast(pc.data, plen), ltype=pc.ltype, data_hi=pc.data_hi),
                Column(data=bcast(bc.data, m), ltype=bc.ltype, data_hi=bc.data_hi))
            pairs.append((op, bcast(pav, plen), bcast(bav, m), _full_valid(pc, plen),
                          _full_valid(bc, m)))
        build_ok = build_b.live
        for *_, bv in pairs:
            build_ok = build_ok & bv
        root = peel(best[0][2])
        sort_vals = (bcast(root.eval(env_b).data, m)
                     if isinstance(root, B.BoundColumnRef) and root is not best[0][2]
                     else pairs[0][2])
        # live rows first, in the order of the build column: the candidate
        # ranges lie inside the live prefix
        perm = torch.sort(sort_vals, stable=True).indices
        perm = perm[torch.sort((~build_ok[perm]).to(torch.int8), stable=True).indices]
        m_live = int(build_ok.sum())
        pos_lo = torch.zeros(plen, dtype=torch.int64, device=build_ok.device)
        pos_up = torch.full((plen,), m_live, dtype=torch.int64, device=build_ok.device)
        probe_ok = probe_b.live
        for op, pav, bav, pv, _ in pairs:
            sk = bav[perm[:m_live]].contiguous()
            probe_ok = probe_ok & pv
            pos = torch.searchsorted(sk, pav.contiguous(), right=op in ("<", ">="))
            if op in (">", ">="):
                pos_up = torch.minimum(pos_up, pos)  # build values at or below the probe's
            else:
                pos_lo = torch.maximum(pos_lo, pos)  # at or above
        counts = torch.where(probe_ok, (pos_up - pos_lo).clamp(min=0), 0)
        total = self._check_pairs(int(counts.sum()))
        self.routes["ie_join"] += 1
        # outer tails must still see NULL-valued build rows as unmatched
        return self._expand_tail(node, probe_b, build_b, counts, pos_lo, perm, probe_ok,
                                 build_b.live, total)

    def _keyless_cross(self, node: P.Join, probe_b: Batch, build_b: Batch) -> Batch:
        """A keyless join no inequality prunes: every live probe row pairs
        with every live build row, through the shared tail (the residual
        checked over the pairs), for every join type."""
        counts, lo, perm = self._all_pairs(probe_b, build_b)
        total = self._check_pairs(int(counts.sum()))
        self.routes["cross_product"] += 1
        return self._expand_tail(node, probe_b, build_b, counts, lo, perm, probe_b.live,
                                 build_b.live, total)

    @staticmethod
    def _all_pairs(probe_b: Batch, build_b: Batch):
        """Every live probe row against every live build row, in the
        (counts, lo, perm) form `_expand_tail` and `J.expand_matches` take."""
        m_live = build_b.count_live()
        perm = packed_indices(build_b.live, max(1, pad_bucket(m_live)))
        counts = torch.where(probe_b.live, m_live, 0)
        return counts, torch.zeros(probe_b.plen, dtype=torch.int64, device=perm.device), perm

    def _exec_CrossJoin(self, node: P.CrossJoin) -> Batch:
        a = self.execute(node.probe)
        b = self.execute(node.build)
        na, nb = a.count_live(), b.count_live()
        total = na * nb
        self._check_pairs(total)
        self.routes["cross_product"] += 1
        ia = packed_indices(a.live, max(1, pad_bucket(na)))
        ib = packed_indices(b.live, max(1, pad_bucket(nb)))
        cap = max(128, pad_bucket(total))
        pos = torch.arange(cap, device=a.live.device)
        ra = ia[(pos // max(nb, 1)).clamp(0, ia.shape[0] - 1)]
        rb = ib[(pos % max(nb, 1)).clamp(0, ib.shape[0] - 1)]
        return Batch(src=ChainCols([GatherCols(a.src, ra), GatherCols(b.src, rb)]), plen=cap,
                     live=pos < total)

    def _asof_join(self, node, probe_b, build_b, pk, bk, probe_live, build_live) -> Batch:
        """ASOF join (DuckDB's physical_asof_join.cpp): per probe row, the
        build row of its equality group nearest on the inequality's side.
        Keys and values are ranked among the build's distinct ones, the
        build sorted by (key rank, value rank), and each probe row finds
        its candidate with one searchsorted."""
        e = node.extra
        if not (isinstance(e, B.BoundComparison) and e.op in (">=", ">", "<=", "<")):
            raise BindError("Binder Error: ASOF JOIN requires one inequality condition")

        op = e.op
        if _reads(probe_b, e.left) and _reads(build_b, e.right):
            e_probe, e_build = e.left, e.right
        elif _reads(probe_b, e.right) and _reads(build_b, e.left):
            e_probe, e_build = e.right, e.left
            op = _FLIP[op]
        else:
            raise BindError("Binder Error: the ASOF JOIN inequality must compare the two sides")
        pc, bc = e_probe.eval(probe_b.env()), e_build.eval(build_b.env())
        if TypeId.VARCHAR in (pc.ltype.id, bc.ltype.id):
            # both sides' codes as ranks in one merged, sorted dictionary
            pl, bl = B._varchar_rank_luts(pc, bc, probe_b.live.device)
            pav = pl[bcast(pc.data, probe_b.plen).long()].to(torch.int64)
            bav = bl[bcast(bc.data, build_b.plen).long()].to(torch.int64)
        else:
            pav, bav = B._common_numeric(
                Column(data=bcast(pc.data, probe_b.plen), ltype=pc.ltype, data_hi=pc.data_hi),
                Column(data=bcast(bc.data, build_b.plen), ltype=bc.ltype, data_hi=bc.data_hi))
        probe_live = probe_live & _full_valid(pc, probe_b.plen)
        build_live = build_live & _full_valid(bc, build_b.plen)
        if op in ("<=", "<"):  # the smallest build value at or above the probe's
            pav, bav = -pav, -bav
            op = {"<=": ">=", "<": ">"}[op]
        ukeys = torch.unique(bk[build_live])
        uvals = torch.unique(bav[build_live])
        nk, nv = max(1, ukeys.shape[0]), uvals.shape[0] + 1
        kb = torch.searchsorted(ukeys, bk.contiguous())
        vb = torch.searchsorted(uvals, bav.contiguous())
        kp = torch.searchsorted(ukeys, pk.contiguous()).clamp(max=nk - 1)
        found = ukeys.shape[0] > 0
        key_hit = probe_live & (ukeys[kp] == pk) if found else torch.zeros_like(probe_live)
        # the rank of the largest build value ≤ (or <) the probe's, -1 if none
        vp = torch.searchsorted(uvals, pav.contiguous(), right=op == ">=") - 1
        comb_b = torch.where(build_live, kb * nv + vb, _I64_MAX)
        sorted_b, perm = torch.sort(comb_b, stable=True)
        pos = torch.searchsorted(sorted_b, (kp * nv + vp).contiguous(), right=True) - 1
        posc = pos.clamp(0, build_b.plen - 1)
        cand = sorted_b[posc]
        matched = key_hit & (vp >= 0) & (pos >= 0) & (cand != _I64_MAX) & (cand // nv == kp)
        brow = perm[posc]
        src = ChainCols([probe_b.src, GatherCols(build_b.src, brow, null_rows=~matched)])
        return Batch(src=src, plen=probe_b.plen,
                     live=matched if node.jtype == "asof" else probe_b.live)

    def _null_aware_residual(self, node: P.Join, probe_b: Batch, build_b: Batch) -> Batch:
        """NOT IN over a subquery correlated by more than equalities: a
        probe row sees the build rows its correlation selects (the
        equality keys before the last, then the residual, over the
        expanded pairs). It stays when it sees none; else when its value
        is not NULL, equals none of them and none of theirs is NULL (SQL's
        rule, per probe row)."""
        if len(node.probe_keys) > 1:
            pk, pv, bk, bv, _ = self._pack_keys(probe_b, build_b, node.probe_keys[:-1],
                                                node.build_keys[:-1])
            table = J.build_sorted(bk, build_b.live & bv)
            counts, lo, _ = J.probe_counts(table, pk, probe_b.live & pv)
            perm = table.perm
        else:
            counts, lo, perm = self._all_pairs(probe_b, build_b)
        total = self._check_pairs(int(counts.sum()))
        cap = max(128, pad_bucket(total))
        pr, br, pair_live = J.expand_matches(counts, lo, perm, cap)
        env = EvalEnv(cols=ChainCols([GatherCols(probe_b.src, pr), GatherCols(build_b.src, br)]),
                      plen=cap, live=pair_live)
        r = node.extra.eval(env)
        seen = pair_live & bcast(r.data.to(torch.bool), cap) & _full_valid(r, cap)
        eq = B.BoundComparison("=", node.probe_keys[-1], node.build_keys[-1]).eval(env)
        y_null = ~_full_valid(node.build_keys[-1].eval(env), cap)

        # a probe row's pairs are contiguous (J.expand_matches), so its
        # count of a mask is the difference of a running sum at its bounds
        ends = torch.cumsum(counts, 0)
        starts = ends - counts

        def per_probe(mask):
            run = torch.zeros(cap + 1, dtype=torch.int64, device=pr.device)
            run[1:] = torch.cumsum(mask.to(torch.int64), 0)
            return run[ends] - run[starts]

        n_seen = per_probe(seen)
        n_eq = per_probe(seen & bcast(eq.data.to(torch.bool), cap) & _full_valid(eq, cap))
        n_null = per_probe(seen & y_null)
        x_valid = _full_valid(node.probe_keys[-1].eval(probe_b.env()), probe_b.plen)
        live = probe_b.live & ((n_seen == 0) | ((n_eq == 0) & x_valid & (n_null == 0)))
        return Batch(src=probe_b.src, plen=probe_b.plen, live=live)

    def _exec_PositionalJoin(self, node: P.PositionalJoin) -> Batch:
        """The i-th live row of each side side by side; the shorter side
        is NULL past its end."""
        a, b = self.execute(node.left), self.execute(node.right)
        na, nb = a.count_live(), b.count_live()
        n = max(na, nb)
        cap = max(128, pad_bucket(n))
        pos = torch.arange(cap, device=a.live.device)
        self.routes["positional"] += 1
        src = ChainCols([GatherCols(a.src, packed_indices(a.live, cap), null_rows=pos >= na),
                         GatherCols(b.src, packed_indices(b.live, cap), null_rows=pos >= nb)])
        return Batch(src=src, plen=cap, live=pos < n)

    # -- samples and set operations ---------------------------------------------
    def _exec_Sample(self, node: P.Sample) -> Batch:
        """Narrow the live mask: each live row kept with probability
        percent / 100 (Bernoulli), or `rows` live rows drawn without
        replacement. The draws come from a torch.Generator on the
        device, seeded by REPEATABLE / the method's seed, else the
        session's (setseed())."""
        from duckdb_tpu_torch.planner.functions_ext import pinned_generator
        from duckdb_tpu_torch.planner.session import current

        b = self.execute(node.child)
        device = b.live.device
        if node.seed is not None:
            g = torch.Generator(device=device)
            g.manual_seed(int(node.seed))
        else:
            session = current()
            g = pinned_generator() or (session.generator(device) if session is not None
                                       else None)
        r = torch.rand(b.plen, generator=g, device=device if g is None else g.device,
                       dtype=torch.float64).to(device)
        if node.percent is not None:
            keep = b.live & (r < node.percent / 100.0)
        else:
            order = torch.argsort(torch.where(b.live, r, 2.0))
            keep = torch.zeros(b.plen, dtype=torch.bool, device=device)
            keep[order[:max(0, min(node.rows, b.plen))]] = True
            keep &= b.live
        self.routes["sample"] += 1
        return Batch(src=b.src, plen=b.plen, live=keep)

    def _exec_SetOp(self, node: P.SetOp) -> Batch:
        """UNION ALL: each input's live rows packed, then concatenated."""
        keys = [k for k, _ in node.keys]
        parts = [self._packed(self.execute(child), keys) for child in node.inputs]
        total, cols = concat_packed(parts, [t for _, t in node.keys])
        self.routes["set_op"] += 1
        cap = cols[0].data.shape[0] if cols else max(128, pad_bucket(total))
        return Batch(src=DictCols(dict(zip(keys, cols))), plen=cap,
                     live=torch.arange(cap, device=self.catalog.device) < total)

    def _exec_Multiplicity(self, node: P.Multiplicity) -> Batch:
        """Each grouped tuple repeated as INTERSECT / EXCEPT [ALL] keep it."""
        b = self.execute(node.child)
        cl = bcast(b.src[node.left_count].data, b.plen).to(torch.int64)
        cr = bcast(b.src[node.right_count].data, b.plen).to(torch.int64)
        if node.op == "intersect":
            n = torch.minimum(cl, cr) if node.all else ((cl > 0) & (cr > 0)).to(torch.int64)
        else:
            n = (cl - cr).clamp(min=0) if node.all else ((cl > 0) & (cr == 0)).to(torch.int64)
        n = torch.where(b.live, n, 0)
        total = int(n.sum())
        cap = max(128, pad_bucket(total))
        rows = torch.zeros(cap, dtype=torch.int64, device=n.device)
        rows[:total] = torch.repeat_interleave(torch.arange(b.plen, device=n.device), n,
                                               output_size=total)
        return Batch(src=GatherCols(b.src, rows), plen=cap,
                     live=torch.arange(cap, device=n.device) < total)

    # -- nested values ------------------------------------------------------------
    def _exec_ListPack(self, node: P.ListPack) -> Batch:
        """One LIST value per live row from N columns: one transfer per
        column, the rows deduplicated as whole numpy arrays (their physical
        values and validity), and a tuple built per distinct row only. The
        dictionary is in first-seen row order; 0.0 and -0.0 are one value,
        and so are NaNs (DuckDB's equality)."""
        from duckdb_tpu_torch.blocks.nested import host_pyvals, obj_array

        b = self.execute(node.child)
        env = b.env()
        ct = node.ltype.child
        rows = np.flatnonzero(b.live.cpu().numpy())
        cols, keys = [], []
        for e in node.exprs:
            c = e.eval(env)
            if c.ltype != ct:
                c = B._coerce_to(c, ct, env)
            data = bcast(c.data, b.plen).cpu().numpy()[rows]
            valid = None if c.validity is None else bcast(c.validity, b.plen).cpu().numpy()[rows]
            hi = None if c.data_hi is None else bcast(c.data_hi, b.plen).cpu().numpy()[rows]
            cols.append((data, valid, c.dict_values, hi))
            if hi is not None:  # a wide value: its high plane is a key too
                keys.append(hi if valid is None else np.where(valid, hi, 0))
            if data.dtype.kind == "f":
                k = np.where(np.isnan(data), np.nan, data.astype(np.float64) + 0.0).view(np.int64)
            else:
                k = data.astype(np.int64)
            if valid is not None:
                k = np.where(valid, k, 0)
                keys.append(valid.astype(np.int64))
            keys.append(k)
        n = len(rows)
        if n:
            mat = np.stack(keys, axis=1) if keys else np.zeros((n, 1), np.int64)
            _, first, inv = np.unique(mat, axis=0, return_index=True, return_inverse=True)
            order = np.argsort(first, kind="stable")  # first-seen order
            rank = np.empty(len(order), dtype=np.int64)
            rank[order] = np.arange(len(order))
            inv = rank[inv.reshape(-1)]
            reps = first[order]
            vals = [host_pyvals(d[reps], None if v is None else v[reps], dv, ct,
                                None if h is None else h[reps])
                    for d, v, dv, h in cols]
            dvals = obj_array(list(zip(*vals)) if vals else [() for _ in reps])
        else:
            inv, dvals = np.zeros(0, np.int64), obj_array([()])
        codes = np.zeros(b.plen, dtype=np.int32)
        codes[rows] = inv
        col = Column(data=torch.from_numpy(codes).to(b.live.device), ltype=node.ltype,
                     dict_values=dvals)
        return Batch(src=ChainCols([DictCols({node.key: col}), b.src]), plen=b.plen,
                     live=b.live)

    def _exec_Unnest(self, node: P.Unnest) -> Batch:
        """LIST values to rows: each live row repeats max(list lengths)
        times (several unnests zip by position, the shorter NULL-padded) in
        row order, the other columns through a gather index. The element
        values are built once per distinct list (the dictionary
        flattened), and each output row gathers its element by index."""
        from duckdb_tpu_torch.blocks.nested import lut_column

        b = self.execute(node.child)
        env = b.env()
        device = b.live.device
        rows = np.flatnonzero(b.live.cpu().numpy())
        specs = []
        m = np.zeros(len(rows), dtype=np.int64)
        for e in node.exprs:
            c = e.eval(env)
            dv = c.dict_values if c.dict_values is not None else np.empty(0, dtype=object)
            codes = bcast(c.data, b.plen).long().cpu().numpy()[rows].clip(0, max(len(dv) - 1, 0))
            lens = np.fromiter((len(t) for t in dv), dtype=np.int64, count=len(dv))
            offs = np.cumsum(lens) - lens
            row_len = lens[codes] if len(dv) else np.zeros(len(rows), np.int64)
            if c.validity is not None:
                row_len = np.where(bcast(c.validity, b.plen).cpu().numpy()[rows], row_len, 0)
            specs.append((c.ltype.child or SQLNULL, dv, codes, offs, row_len))
            m = np.maximum(m, row_len)
        n = int(m.sum())
        cap = max(128, pad_bucket(n))
        start = np.repeat(np.cumsum(m) - m, m)
        j = np.arange(n, dtype=np.int64) - start
        src_row = np.repeat(np.arange(len(rows)), m)
        cols = {}
        for key, (ct, dv, codes, offs, row_len) in zip(node.keys, specs):
            flat = list(itertools.chain.from_iterable(dv))
            elem = lut_column(flat + [None], ct, device)
            idx = np.where(j < row_len[src_row], offs[codes[src_row]] + j, len(flat))
            pidx = np.full(cap, len(flat), dtype=np.int64)
            pidx[:n] = idx
            t_idx = torch.from_numpy(pidx).to(device)
            cols[key] = Column(data=elem.data[t_idx], ltype=ct,
                               validity=(torch.ones(cap, dtype=torch.bool, device=device)
                                         if elem.validity is None else elem.validity[t_idx]),
                               dict_values=elem.dict_values)
        gidx = np.zeros(cap, dtype=np.int64)
        gidx[:n] = rows[src_row]
        src = ChainCols([DictCols(cols), GatherCols(b.src, torch.from_numpy(gidx).to(device))])
        return Batch(src=src, plen=cap, live=torch.arange(cap, device=device) < n)

    # -- windows ----------------------------------------------------------------
    def _exec_Window(self, node: P.Window) -> Batch:
        from duckdb_tpu_torch.execution.window_exec import execute_window

        return execute_window(self, node)

    # -- order / limit --------------------------------------------------------
    def _order_norm_keys(self, node: P.Order, b: Batch):
        env = b.env()
        return [k for expr, desc, nulls_first in node.items
                for k in sort_keys(expr.eval(env), b.plen, desc, bool(nulls_first))]

    # padded rows from which ORDER BY and TopN shard
    SHARDED_SORT_MIN_ROWS = 1 << 14
    SHARDED_TOPN_MIN_ROWS = 1 << 15
    SHARDED_TOPN_MAX_K = 1 << 14

    def _exec_Order(self, node: P.Order) -> Batch:
        b = self.execute(node.child)
        keys = self._order_norm_keys(node, b)
        n = self._join_shards(rows=b.plen)
        if n > 1 and b.plen >= self.SHARDED_SORT_MIN_ROWS:
            return self._sharded_order(b, keys, n)
        perm = S.sort_permutation(keys, b.live)
        live = torch.arange(b.plen, device=b.live.device) < b.count_live()
        return Batch(src=GatherCols(b.src, perm), plen=b.plen, live=live)

    def _sharded_order(self, b: Batch, keys, n: int) -> Batch:
        """ORDER BY over the mesh (parallel/shard.make_sharded_sort):
        range-partitioned by the first key, each shard sorted by all keys
        and the row id, concatenated in shard order — the single-device
        stable sort's order exactly."""
        from duckdb_tpu_torch.parallel import shard

        mesh = self._mesh(n, "sharded_sort")
        device = b.live.device
        rows = shard.gather(mesh, shard.make_sharded_sort(mesh, len(keys))(
            torch.stack(keys), b.live, torch.arange(b.plen, device=device)))
        m = rows.shape[0]
        perm = torch.zeros(b.plen, dtype=torch.int64, device=device)
        perm[:m] = rows
        return Batch(src=GatherCols(b.src, perm), plen=b.plen,
                     live=torch.arange(b.plen, device=device) < m)

    def _sharded_topn(self, node: P.Limit) -> Optional[Batch]:
        """ORDER BY … LIMIT over the mesh: each shard's first offset + n
        rows (parallel/shard.make_sharded_topn), then one small stable sort
        of the candidates on the home device; candidates come in shard
        order, so ties keep row order. None below SHARDED_TOPN_MIN_ROWS,
        above SHARDED_TOPN_MAX_K rows, or unsharded."""
        from duckdb_tpu_torch.parallel import shard

        order = node.child
        offset = node.offset or 0
        k = offset + node.n
        if k <= 0 or k > self.SHARDED_TOPN_MAX_K:
            return None
        b = self.execute(order.child)
        n = self._join_shards(rows=b.plen)
        if n <= 1 or b.plen < self.SHARDED_TOPN_MIN_ROWS:
            return None
        keys = self._order_norm_keys(order, b)
        mesh = self._mesh(n, "sharded_topn")
        device = b.live.device
        cand = shard.make_sharded_topn(mesh, k, len(keys))(
            torch.stack(keys), b.live, torch.arange(b.plen, device=device))
        perm = S.sort_permutation(list(cand.keys), cand.live)
        n_live = int(cand.live.sum())
        lo = min(offset, n_live)
        hi = min(n_live, lo + node.n)
        cap = max(128, pad_bucket(hi - lo))
        pos = torch.arange(cap, device=device)
        rows = cand.rows[perm][(pos + lo).clamp(0, max(perm.shape[0] - 1, 0))] \
            if perm.shape[0] else torch.zeros(cap, dtype=torch.int64, device=device)
        return Batch(src=GatherCols(b.src, rows), plen=cap, live=pos < hi - lo)

    def _exec_Limit(self, node: P.Limit) -> Batch:
        if node.n is not None and isinstance(node.child, P.Order):
            out = self._sharded_topn(node)
            if out is not None:
                return out
        b = self.execute(node.child)
        n = b.count_live()
        idx = packed_indices(b.live, max(1, pad_bucket(n)))
        lo = min(node.offset, n)
        hi = n if node.n is None else min(n, lo + node.n)
        cap = max(128, pad_bucket(hi - lo))
        pos = torch.arange(cap, device=b.live.device)
        rows = idx[(pos + lo).clamp(0, idx.shape[0] - 1)]
        return Batch(src=GatherCols(b.src, rows), plen=cap, live=pos < hi - lo)
