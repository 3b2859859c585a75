"""MERGE INTO: match the target's rows against a source on equality keys,
then WHEN MATCHED [AND cond] THEN UPDATE SET … | DELETE | DO NOTHING and
WHEN NOT MATCHED [AND cond] THEN INSERT [(cols)] VALUES (…) | INSERT * |
DO NOTHING, the first applicable clause of each kind winning for a row.

The JAX package's `_merge` (duckdb_tpu/api/connection.py) on the device:
the target and the source are planned and executed as batches, their keys
packed (`Executor._pack_keys`), the source sorted by key
(`ops/join.build_sorted`) and probed by the target (`probe_counts`): a
target row matches where its count is positive, and reads the columns of
the first source row of its run through a gathered column source. The
WHEN conditions, the SET values and the inserted values are column
expressions evaluated over those batches; only the rows each clause takes
leave the device.

Where the JAX package differs from DuckDB the port follows DuckDB:
- a target row that two source rows match raises InvalidInputException
  when the statement has a WHEN MATCHED clause (SQL's cardinality
  violation; the JAX package updates it from one of them) — ROADMAP M1;
- the updates of every WHEN MATCHED clause are staged together, checked
  by `_verify_update_constraints` (NOT NULL, keys, CHECK, FOREIGN KEYs on
  both sides) and only then written (M2);
- the deletes go through `_delete_rows`, which refuses a parent key
  another table still references (M3);
- the inserts are whole columns gathered from the source batch at its
  unmatched rows, appended by `_append_rows`, so defaults, keys and CHECK
  apply; a source row whose key is NULL matches nothing and is inserted;
- MERGE returns one Count row: the rows it inserted, updated and deleted
  (M4).
The statement runs on its own copy of the catalog (api/connection.py
`_run`), so a violation anywhere leaves the table as it was.
"""

from __future__ import annotations

import numpy as np
import torch

from duckdb_tpu_torch.api.dml import _SORTED_DICT, _wide_to_int64
from duckdb_tpu_torch.blocks import Column
from duckdb_tpu_torch.blocks.nested import UNSORTED_DICT_IDS
from duckdb_tpu_torch.errors import ConnectionException, InvalidInputException
from duckdb_tpu_torch.execution.executor import ChainCols, Executor, GatherCols, _full_valid
from duckdb_tpu_torch.ops import join as J
from duckdb_tpu_torch.planner import bound as B
from duckdb_tpu_torch.planner.binder import Scope
from duckdb_tpu_torch.planner.bound import BindError, EvalEnv, bcast
from duckdb_tpu_torch.planner.planner import split_conjuncts
from duckdb_tpu_torch.sql import nodes as N
from duckdb_tpu_torch.sql.walk import table_ref
from duckdb_tpu_torch.types.logical_type import max_logical_type



def _rows_of(mask: torch.Tensor) -> torch.Tensor:
    return torch.nonzero(mask).flatten()


def _host_planes(c: Column, rows: torch.Tensor, plen: int):
    """An evaluated column's values at `rows` → host (values, validity|None,
    dictionary|None)."""
    def take(x):
        return None if x is None else bcast(x, plen)[rows]

    got = Column(data=take(c.data), ltype=c.ltype, validity=take(c.validity),
                 dict_values=c.dict_values, data_hi=take(c.data_hi))
    values, validity = got.host_values(len(rows))
    if c.ltype.id not in _SORTED_DICT and c.ltype.id not in UNSORTED_DICT_IDS:
        values = _wide_to_int64(values)
    return values, validity, c.dict_values


def _cast(e: B.BoundExpr, t) -> B.BoundExpr:
    return e if e.ltype == t else B.BoundCast(e, t)


class MergeMixin:
    """MERGE INTO of `Connection` (api/connection.py)."""

    def _merge(self, s: N.MergeStatement):
        s.target = self._resolve_default(s.target)
        self._check_writable(s.target)
        entry = self.catalog.writable_table(s.target)
        if any(a.kind == "insert" for a in s.matched) or any(
                a.kind not in ("insert", "do_nothing") for a in s.not_matched):
            raise BindError("Binder Error: WHEN MATCHED takes UPDATE, DELETE or DO NOTHING; "
                            "WHEN NOT MATCHED takes INSERT or DO NOTHING")
        planner = self._planner()
        try:
            return self._merge_planned(s, entry, planner)
        finally:
            self._drop_tables(planner.hidden_tables)

    def _merge_planned(self, s: N.MergeStatement, entry, planner):
        tplan, t_adds, _, _ = planner._plan_base_table(
            table_ref(entry.name, s.target_alias), {})
        scope = Scope()
        for a, c, key, t in t_adds:
            scope.add(a, c, key, t)
        t_keys = {key for _, _, key, _ in t_adds}
        atoms, pred_asts = [], []
        planner.collect_atoms(s.source, {}, scope, atoms, pred_asts)
        binder = planner._pred_binder(scope, {})
        splan = planner.plan_pool(atoms, [binder.bind(p) for p in pred_asts])
        pk, bk = [], []
        for cond in split_conjuncts(s.condition):
            c = binder.bind(cond)
            if isinstance(c, B.BoundComparison) and c.op in ("=", "=="):
                kl, kr = planner._keys_of(c.left), planner._keys_of(c.right)
                sides = ((c.left, c.right) if kl and kl <= t_keys and not kr & t_keys else
                         (c.right, c.left) if kr and kr <= t_keys and not kl & t_keys else None)
                if sides is not None:
                    t = max_logical_type(sides[0].ltype, sides[1].ltype)
                    pk.append(_cast(sides[0], t))
                    bk.append(_cast(sides[1], t))
                    continue
            raise ConnectionException("MERGE ON must be equality conditions between the "
                                      "target and the source")
        ex = Executor(self.catalog, self.routes)
        tb, sb = ex.execute(tplan), ex.execute(splan)
        pkv, pv, bkv, bv, _ = ex._pack_keys(tb, sb, pk, bk)
        t_live, s_live = tb.live & pv, sb.live & bv
        table = J.build_sorted(bkv, s_live)
        counts, lo, _ = J.probe_counts(table, pkv, t_live)
        # the source rows no target row matches (their key NULL too)
        s_counts, _, _ = J.probe_counts(J.build_sorted(pkv, t_live), bkv, s_live)
        unmatched = sb.live & (s_counts == 0)
        matched = counts > 0
        if s.matched and bool((counts > 1).any()):  # M1: one host sync
            raise InvalidInputException(
                "MERGE INTO: a target row matches more than one source row; it can be "
                "updated or deleted once only")
        srow = table.perm[lo.clamp(0, max(sb.plen - 1, 0))]
        env = EvalEnv(cols=ChainCols([tb.src, GatherCols(sb.src, srow, null_rows=~matched)]),
                      plen=tb.plen, live=tb.live)
        senv = EvalEnv(cols=sb.src, plen=sb.plen, live=sb.live)

        def applies(act, base, env_):
            m = base
            if act.condition is not None:
                cc = binder.bind(act.condition).eval(env_)
                m = m & bcast(cc.data.to(torch.bool), env_.plen) & _full_valid(cc, env_.plen)
            return m

        # WHEN MATCHED: the updates staged, the deleted rows marked
        n = entry.nrows
        consumed = torch.zeros_like(matched)
        staged, updated, delete = {}, [], np.zeros(n, bool)
        for act in s.matched:
            m = applies(act, matched & ~consumed, env)
            consumed |= m
            if act.kind == "do_nothing":
                continue
            rows = _rows_of(m)
            host_rows = rows.cpu().numpy()
            if act.kind == "delete":
                delete[host_rows] = True
                continue
            names = [self._colname(entry, c) for c, _ in act.assignments]
            if len(set(names)) != len(names):
                raise BindError("Binder Error: a column is assigned twice in the UPDATE SET")
            if not len(host_rows):
                continue
            for cname, (_, expr) in zip(names, act.assignments):
                c = _cast(binder.bind(expr), entry.col_types[cname]).eval(env)
                staged[cname] = self._scatter(entry, cname, host_rows,
                                              *_host_planes(c, rows, tb.plen),
                                              base=staged[cname][:3]
                                              if cname in staged else None)
            updated.append(host_rows)
        # WHEN NOT MATCHED: each INSERT's columns, gathered at its rows
        inserts = []
        taken = torch.zeros_like(unmatched)
        for act in s.not_matched:
            m = applies(act, unmatched & ~taken, senv)
            taken |= m
            if act.kind == "do_nothing":
                continue
            rows = _rows_of(m)
            k = int(rows.shape[0])
            if not k:
                continue
            if act.insert_star:
                exprs = [B.BoundColumnRef(b.key, b.ltype) for _, _, b in scope.order
                         if b.key not in t_keys]
                names = [c.name for c in entry.columns]
            else:
                names = ([self._colname(entry, c) for c in act.insert_columns]
                         or [c.name for c in entry.columns])
                exprs = [binder.bind(e) for e in act.insert_values]
            if len(exprs) != len(names):
                raise BindError(f"Binder Error: table {entry.name} has {len(names)} columns "
                                f"but {len(exprs)} values were supplied")
            cols = {nm: _host_planes(_cast(e, entry.col_types[nm]).eval(senv), rows, sb.plen)
                    for nm, e in zip(names, exprs)}
            for cd in entry.columns:
                if cd.name not in cols and cd.name in entry.defaults:
                    cols[cd.name] = self._eval_default(entry, cd, k)
            inserts.append((cols, k))
        # write: the updates once every constraint holds over them (M2),
        # then the deletes (M3), then the inserts
        rids = np.unique(np.concatenate(updated)) if updated else np.zeros(0, np.int64)
        if len(rids):
            self._verify_update_constraints(entry, staged, rids)
        for cname, (vals, valid, dvals, exact) in staged.items():
            entry.set_host_column(cname, vals, valid, dvals, exact_dict=exact)
        self._delete_rows(entry, delete)
        for cols, k in inserts:
            self._append_rows(entry, cols, k)
        return self._count_result(len(rids) + int(delete.sum()) + sum(k for _, k in inserts))
