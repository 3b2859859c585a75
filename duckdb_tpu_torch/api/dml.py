"""INSERT, DELETE and UPDATE, with the constraints they check.

The JAX package's DML (duckdb_tpu/api/connection.py: `_insert`,
`_append_rows`, `_resolve_conflicts`, `_delete`, `_update` and the
`_verify_*` checks), kept under its method names; its `_table_mask` and
`_delete_using_mask` are `_matching_rows` here, its `_set_cell` and
`_apply_masked_update` `_scatter`. What a statement
evaluates runs on the connection's device: an INSERT's SELECT (cast to
the target's types there, `_query_columns`), and the rows a DELETE or
UPDATE touches with their new values, found by one SELECT over the table
and a row-id column made on the device (`_matching_rows`). The new rows
then join the table's host planes column by column, in numpy, and every
write goes through `TableEntry.set_host_column`: a plane is never changed
in place, because a transaction's clones share it. A VARCHAR column's
merged dictionary is a new sorted array (`_merge_dicts`), or the old one
where the new values use the same dictionary object.

The constraint checks run before any plane is written, on the new rows
(INSERT) or the post-update state (UPDATE): NOT NULL, PRIMARY KEY and
UNIQUE (NULL keys never collide) through a unique-key index that a
successful append advances and a version mismatch rebuilds, FOREIGN KEY
on both sides, and CHECK as a SELECT over the new rows. A violation
raises ConstraintException, DuckDB's class, which is also the JAX
package's ConnectionException.
"""

from __future__ import annotations

import numpy as np
import torch

from duckdb_tpu_torch.blocks import Column, pad_bucket
from duckdb_tpu_torch.blocks.nested import UNSORTED_DICT_IDS, encode_objects
from duckdb_tpu_torch.catalog.catalog import ColumnDef, ColumnStats, TableEntry, qualify
from duckdb_tpu_torch.errors import (ConnectionException, ConstraintException,
                                     OutOfRangeException)
from duckdb_tpu_torch.execution.executor import Executor
from duckdb_tpu_torch.planner import bound as B
from duckdb_tpu_torch.planner import macros as M
from duckdb_tpu_torch.planner import plan as P
from duckdb_tpu_torch.planner.binder import ExprBinder, Scope
from duckdb_tpu_torch.planner.bound import BindError, not_ported
from duckdb_tpu_torch.sql import nodes as N
from duckdb_tpu_torch.sql.parser import Parser
from duckdb_tpu_torch.types import BIGINT, TypeId

# the types whose constant cells an INSERT … VALUES converts on the host
# (`_values_columns`); the others go through the query path
_FLAT = {TypeId.BOOLEAN, TypeId.TINYINT, TypeId.SMALLINT, TypeId.INTEGER, TypeId.BIGINT,
         TypeId.FLOAT, TypeId.DOUBLE, TypeId.DECIMAL, TypeId.DATE, TypeId.TIME,
         TypeId.TIMESTAMP, TypeId.TIMESTAMPTZ, TypeId.VARCHAR}
# the types whose dictionary is sorted and unique (blocks/column.py)
_SORTED_DICT = (TypeId.VARCHAR, TypeId.BLOB)


def _concat_valid(old_valid, new_valid, n_old: int, n_new: int):
    if old_valid is None and new_valid is None:
        return None
    a = np.ones(n_old, bool) if old_valid is None else old_valid
    b = np.ones(n_new, bool) if new_valid is None else new_valid
    return np.concatenate([a, b])


def _merge_dicts(parts):
    """Dictionary-coded parts [(codes, dictionary)] of one sorted-dictionary
    column → (codes into one dictionary, the dictionary). Where every part
    uses the same dictionary object it is kept; else the union is a new
    sorted array (a cached LUT keyed by a dictionary's id never sees it
    change)."""
    dicts = [d for c, d in parts if d is not None and len(c)]
    if dicts and all(d is dicts[0] for d in dicts):
        return np.concatenate([c for c, _ in parts]).astype(np.int32), dicts[0]
    if not dicts:
        n = sum(len(c) for c, _ in parts)
        return np.zeros(n, np.int32), np.array([""], dtype=object)
    uniq = np.unique(np.concatenate([np.asarray(d).astype(str) for d in dicts]))
    out = []
    for codes, d in parts:
        if not len(codes):
            continue
        if d is None or not len(d):
            out.append(np.zeros(len(codes), np.int64))
            continue
        lut = np.searchsorted(uniq, np.asarray(d).astype(str))
        out.append(lut[np.clip(codes, 0, len(d) - 1)])
    return np.concatenate(out).astype(np.int32), uniq.astype(object)


def _wide_to_int64(values: np.ndarray) -> np.ndarray:
    """A column of Python ints (a wide sum's result) as an int64 plane: the
    table's host tier holds 64-bit values, in the JAX package too, which
    raises the same class past them."""
    if values.dtype != object:
        return values
    try:
        return np.array(values.tolist(), dtype=np.int64)
    except OverflowError:
        raise OutOfRangeException("Out of Range Error: a table column holds 64-bit "
                                  "integers; the value is wider") from None


class DMLMixin:
    """INSERT, DELETE and UPDATE of `Connection` (api/connection.py)."""

    # -- the values a statement writes -------------------------------------------
    def _query_columns(self, stmt: N.SelectStatement, types, table: str = ""):
        """Run a SELECT on the device with its columns cast there to
        `types` (None: as they are) → (rows, [(values, validity|None,
        dictionary|None)] on the host, output names)."""
        planner = self._planner()
        try:
            plan, output = planner.plan_select(M.expand_macros(stmt, planner.macros()))
            if types is not None and len(types) != len(output):
                raise BindError(f"Binder Error: table {table} has {len(types)} columns but "
                                f"{len(output)} values were supplied")
            items, out = [], []
            for i, (name, key, t) in enumerate(output):
                want = t if types is None else types[i]
                e = B.BoundColumnRef(key, t)
                if want != t:
                    e = B.BoundCast(e, want)
                k = planner.fresh("dml")
                items.append((k, e))
                out.append((name, k, want))
            n, cols = Executor(self.catalog, self.routes).materialize(P.Project(plan, items), out)
        finally:
            self._drop_tables(planner.hidden_tables)
        host = []
        for c, (_, _, t) in zip(cols, out):
            values, validity = c.host_values(n)
            if t.id not in _SORTED_DICT and t.id not in UNSORTED_DICT_IDS:
                values = _wide_to_int64(values)
            host.append((values, validity, c.dict_values))
        return n, host, [name for name, _, _ in output]

    def _values_columns(self, vn: N.ValuesNode, types, table: str):
        """INSERT … VALUES of constants: each cell bound, cast to its
        column's type and folded on the host → the columns, or None when a
        cell is not a constant or a type is not flat (the query path
        evaluates those)."""
        if any(t.id not in _FLAT for t in types):
            return None
        binder = ExprBinder(Scope())
        cells = [[] for _ in types]
        for row in vn.rows:
            if len(row) != len(types):
                raise BindError(f"Binder Error: table {table} has {len(types)} columns but "
                                f"{len(row)} values were supplied")
            for j, (e, t) in enumerate(zip(row, types)):
                try:
                    b = binder.bind(e)
                except BindError:
                    return None
                if not b.is_const():
                    return None
                if b.ltype != t and b.ltype.id is not TypeId.SQLNULL:
                    b = B.BoundCast(b, t)
                cells[j].append(b.const_value())
        out = []
        for vals, t in zip(cells, types):
            valid = np.array([v is not None for v in vals], dtype=bool)
            validity = None if valid.all() else valid
            if t.id is TypeId.VARCHAR:
                uniq, codes = np.unique(np.array(["" if v is None else str(v) for v in vals],
                                                 dtype=str), return_inverse=True)
                out.append((codes.reshape(-1).astype(np.int32), validity, uniq.astype(object)))
            else:
                out.append((np.array([0 if v is None else v for v in vals], dtype=t.np_dtype),
                            validity, None))
        return out

    def _eval_default(self, entry: TableEntry, cd: ColumnDef, n: int):
        """A column's DEFAULT for n new rows, evaluated once a row (nextval(),
        random() and now() advance per row) and cast to the column's type."""
        stmt = Parser(f"SELECT ({entry.defaults[cd.name]}) AS v FROM range({n})"
                      ).parse_statements()[0]
        _, (col,), _ = self._query_columns(stmt, [cd.ltype])
        return col

    # -- INSERT -----------------------------------------------------------------
    def _insert(self, s: N.InsertStatement):
        s.table = self._resolve_default(s.table)
        self._check_writable(s.table)
        entry = self.catalog.writable_table(s.table)
        names = ([self._colname(entry, c) for c in s.columns] if s.columns
                 else [c.name for c in entry.columns])
        if s.source is None:  # DEFAULT VALUES: one row, every column its default
            n_new, new_cols = 1, {}
        else:
            cols = None
            if isinstance(s.source.node, N.ValuesNode) and not s.by_name:
                cols = self._values_columns(s.source.node, [entry.col_types[c] for c in names],
                                            entry.name)
            if cols is not None:
                n_new = len(s.source.node.rows)
            elif s.by_name:
                # BY NAME: the source's column names pick the target columns
                planner = self._planner()
                try:
                    _, output = planner.plan_select(M.expand_macros(s.source, planner.macros()))
                finally:
                    self._drop_tables(planner.hidden_tables)
                names = []
                for nm, _, _ in output:
                    if not any(c.name.lower() == nm.lower() for c in entry.columns):
                        raise BindError(f'Binder Error: Column "{nm}" does not exist in table '
                                        f'"{s.table}"')
                    names.append(self._colname(entry, nm))
                n_new, cols, _ = self._query_columns(
                    s.source, [entry.col_types[c] for c in names], entry.name)
            else:
                n_new, cols, _ = self._query_columns(
                    s.source, [entry.col_types[c] for c in names], entry.name)
            if len(set(names)) != len(names):
                raise BindError("Binder Error: a column is named twice in the INSERT's "
                                "column list")
            new_cols = dict(zip(names, cols))
        for cd in entry.columns:
            if cd.name not in new_cols and cd.name in entry.defaults and n_new:
                new_cols[cd.name] = self._eval_default(entry, cd, n_new)
        n_updated = 0
        if s.on_conflict is not None:
            new_cols, n_new, n_updated = self._resolve_conflicts(entry, new_cols, n_new,
                                                                 s.on_conflict)
        self._append_rows(entry, new_cols, n_new)
        if s.returning:
            return self._eval_returning(entry, s.returning,
                                        np.arange(entry.nrows - n_new, entry.nrows))
        # DuckDB's PhysicalInsert counts the rows an upsert updated too; the
        # JAX package counts the appended rows only (ROADMAP Queue 3, D10)
        return self._count_result(n_new + n_updated)

    def _append_rows(self, entry: TableEntry, new_cols: dict, n_new: int):
        """Append n_new rows, given as {column: (values, validity|None,
        dictionary|None)} in the columns' physical types; a column left out
        is NULL. Constraints are checked first; nothing is written if one
        fails."""
        if not n_new:
            return
        advance = self._verify_append_constraints(entry, new_cols, n_new)
        for cd in entry.columns:
            t = cd.ltype
            old_vals, old_valid, old_dict = entry.host_column(cd.name)
            n_old = len(old_vals)
            if cd.name in new_cols:
                vals, valid, dvals = new_cols[cd.name]
            else:
                vals, valid, dvals = (np.zeros(n_new, t.np_dtype), np.zeros(n_new, bool), None)
            new_valid = _concat_valid(old_valid, valid, n_old, n_new)
            if t.id in _SORTED_DICT:
                codes, d = _merge_dicts([(old_vals, old_dict), (vals, dvals)])
                entry.set_host_column(cd.name, codes, new_valid, d,
                                      exact_dict=d is old_dict and d is dvals)
            elif t.id in UNSORTED_DICT_IDS:
                entries = ([old_dict[c] for c in old_vals] if old_dict is not None else []) + \
                          ([dvals[c] for c in vals] if dvals is not None else [()] * n_new)
                codes, d = encode_objects(entries)
                entry.set_host_column(cd.name, codes, new_valid, d)
            else:
                merged = np.concatenate([old_vals.astype(t.np_dtype, copy=False),
                                         np.asarray(vals).astype(t.np_dtype, copy=False)])
                entry.set_host_column(cd.name, merged, new_valid)
        entry.nrows += n_new
        advance()

    # -- the constraints ------------------------------------------------------------
    @staticmethod
    def _key_part(vals, valid, dvals, t, n):
        """One key column → (comparable values, validity): a number as it
        is, a dictionary value as its string."""
        if dvals is not None and (t.id in _SORTED_DICT or t.id in UNSORTED_DICT_IDS):
            vs = (np.asarray(dvals, dtype=object)[np.clip(vals, 0, len(dvals) - 1)].astype(str)
                  if len(vals) and len(dvals) else np.zeros(len(vals), dtype="<U1"))
        else:
            vs = np.asarray(vals)
        return vs, (np.ones(n, bool) if valid is None else np.asarray(valid))

    def _keys(self, parts):
        """Key columns [(values, validity)] → (one key per row, all-valid
        mask). One numeric column is its values; several are joined as
        strings, as the JAX package joins them."""
        key, valid = parts[0]
        if len(parts) > 1:
            key = key.astype(str)
            for vs, va in parts[1:]:
                key = np.char.add(np.char.add(key, "\x1f"), vs.astype(str))
                valid = valid & va
        return key, valid

    def _table_keys(self, entry: TableEntry, cols):
        n = entry.nrows
        return self._keys([self._key_part(*entry.host_column(c), entry.col_types[c], n)
                           for c in cols])

    def _new_keys(self, entry: TableEntry, new_cols, n_new, cols):
        parts = []
        for c in cols:
            t = entry.col_types[c]
            vals, valid, dvals = new_cols.get(c, (np.zeros(n_new, t.np_dtype),
                                                  np.zeros(n_new, bool), None))
            parts.append(self._key_part(vals, valid, dvals, t, n_new))
        return self._keys(parts)

    def _verify_append_constraints(self, entry: TableEntry, new_cols, n_new):
        """NOT NULL, PRIMARY KEY, UNIQUE, FOREIGN KEY and CHECK over the new
        rows, before anything is written (DuckDB's
        VerifyAppendConstraints). → a function that advances the unique-key
        indexes once the append is done."""
        post = []
        for con in entry.constraints:
            kind = con[0]
            if kind == "not_null":
                valid = new_cols[con[1]][1] if con[1] in new_cols else np.zeros(1, bool)
                if valid is not None and not valid.all():
                    raise ConstraintException(f"NOT NULL constraint failed: "
                                              f"{entry.name}.{con[1]}")
            elif kind in ("primary_key", "unique"):
                cols = con[1]
                err = ConstraintException(
                    f"duplicate key violates {'PRIMARY KEY' if kind == 'primary_key' else 'UNIQUE'}"
                    f" constraint on {entry.name}({', '.join(cols)})")
                nkey, nvalid = self._new_keys(entry, new_cols, n_new, cols)
                new_live = nkey[nvalid]
                if len(np.unique(new_live)) < len(new_live):
                    raise err
                new_live = new_live.tolist()
                # the unique-key index (DuckDB's ART): the set of live keys
                old = self._live_keys(entry, cols)
                if any(k in old for k in new_live):
                    raise err
                post.append((cols, old.union(new_live)))
            elif kind == "foreign_key":
                cols, rt = con[1], con[2]
                parent, rcols = self._fk_parent(con)
                nkey, nvalid = self._new_keys(entry, new_cols, n_new, cols)
                pset = self._live_keys(parent, rcols)
                for k in nkey[nvalid].tolist():
                    if k not in pset:
                        raise ConstraintException(
                            f'Violates foreign key constraint because key "{k}" does not '
                            f'exist in the referenced table "{rt}"')
            elif kind == "check":
                self._verify_check(entry, new_cols, n_new, con[1])

        def advance():
            for cols, merged in post:
                entry.store_key_set(cols, merged)
        return advance

    def _fk_parent(self, con):
        """The referenced table of a FOREIGN KEY and its key columns (the
        parent's primary key where the constraint names none)."""
        rt, rcols = con[2], list(con[3])
        parent = self.catalog.tables.get(self._resolve_default(rt).lower())
        if parent is None:
            raise ConnectionException(f"Catalog Error: referenced table {rt} does not exist")
        if not rcols:
            rcols = next((c[1] for c in parent.constraints if c[0] == "primary_key"), None)
            if not rcols:
                raise BindError(f"Binder Error: there is no primary key on referenced table "
                                f"{rt}")
        return parent, [self._colname(parent, c) for c in rcols]

    def _live_keys(self, entry: TableEntry, cols) -> set:
        """A table's live (non-NULL) keys over `cols` as a set, kept with
        its version (`TableEntry.key_set`): the unique-key index, and a
        foreign key's parent keys (the JAX package's `_parent_key_set`)."""
        keys = entry.key_set(cols)
        if keys is None:
            key, valid = self._table_keys(entry, cols)
            keys = set(key[valid].tolist())
            entry.store_key_set(cols, keys)
        return keys

    def _fk_children_of(self, table_key: str):
        """Every (child table, child columns, parent columns) whose FOREIGN
        KEY references `table_key`."""
        out = []
        for child in self.catalog.tables.values():
            for con in child.constraints:
                if con[0] == "foreign_key" and \
                        qualify(self._resolve_default(con[2])) == table_key:
                    out.append((child, con[1], self._fk_parent(con)[1]))
        return out

    def _verify_check(self, entry: TableEntry, new_cols, n_new, check_sql):
        """A CHECK over the new rows: a SELECT over a scratch table of them."""
        tmp = TableEntry("__check_tmp", list(entry.columns))
        tmp.nrows = n_new
        for cd in entry.columns:
            vals, valid, dvals = new_cols.get(cd.name, (
                np.zeros(n_new, cd.ltype.np_dtype), np.zeros(n_new, bool),
                np.array([""], dtype=object) if cd.ltype.id in _SORTED_DICT else None))
            tmp.set_host_column(cd.name, vals, valid, dvals, exact_dict=False)
        self.catalog.create_table(tmp, or_replace=True)
        try:
            stmt = Parser(f"SELECT count(*) FROM __check_tmp WHERE NOT ({check_sql})"
                          ).parse_statements()[0]
            (n_viol,), = self._select(stmt).rows()
        finally:
            self.catalog.drop_table("__check_tmp", if_exists=True)
        if n_viol:
            raise ConstraintException(f"CHECK constraint failed on {entry.name}: {check_sql}")

    def _verify_existing_unique(self, entry: TableEntry, cols, iname: str):
        key, valid = self._table_keys(entry, cols)
        live = key[valid]
        if len(np.unique(live)) != len(live):
            raise ConstraintException(f"Data contains duplicates on indexed column(s) - "
                                      f'cannot create UNIQUE index "{iname}"')

    # -- ON CONFLICT ------------------------------------------------------------------
    def _resolve_conflicts(self, entry: TableEntry, new_cols, n_new, on_conflict):
        """INSERT … ON CONFLICT (DuckDB's physical_insert.cpp): a new row
        whose key exists drops (DO NOTHING) or updates the existing row (DO
        UPDATE SET col = excluded.col or a constant; INSERT OR REPLACE: every
        column not in the key); a later duplicate within the statement
        drops. → (the rows left to append, their number, the number of
        existing rows updated)."""
        action = on_conflict[0]
        tcols = [self._colname(entry, c) for c in (on_conflict[1] if len(on_conflict) > 1
                                                   else ())]
        if not tcols:
            tcols = next((list(c[1]) for c in entry.constraints
                          if c[0] in ("primary_key", "unique")), [])
        if not tcols:
            raise BindError("Binder Error: ON CONFLICT needs a PRIMARY KEY or UNIQUE "
                            "constraint, or a conflict target")
        nkey, nvalid = self._new_keys(entry, new_cols, n_new, tcols)
        okey, ovalid = self._table_keys(entry, tcols)
        # the first occurrence of each key in the statement
        first = np.zeros(n_new, bool)
        if n_new:
            _, idx = np.unique(nkey, return_index=True)
            first[idx] = True
        first |= ~nvalid  # NULL keys never conflict
        # the existing row of each new key (-1: none)
        target = np.full(n_new, -1, np.int64)
        live_rows = np.flatnonzero(ovalid)
        if len(live_rows) and n_new:
            order = live_rows[np.argsort(okey[live_rows], kind="stable")]
            sk = okey[order]
            pos = np.clip(np.searchsorted(sk, nkey), 0, len(sk) - 1)
            hit = (sk[pos] == nkey) & nvalid
            target[hit] = order[pos[hit]]
        conflict = (target >= 0) & first
        keep = first & (target < 0)
        n_updated = 0
        if action != "nothing" and conflict.any():
            rows, src = target[conflict], np.flatnonzero(conflict)
            if action == "replace":
                assigns = [(c.name, ("excluded", c.name)) for c in entry.columns
                           if c.name not in tcols]
            else:
                assigns = []
                for nm, expr in on_conflict[2]:
                    if isinstance(expr, N.ColumnRef) and len(expr.parts) == 2 \
                            and expr.parts[0].lower() == "excluded":
                        assigns.append((self._colname(entry, nm),
                                        ("excluded", self._colname(entry, expr.parts[1]))))
                    else:
                        assigns.append((self._colname(entry, nm), ("const", expr)))
            staged = {}
            for cname, spec in assigns:
                t = entry.col_types[cname]
                if spec[0] == "excluded":
                    vals, valid, dvals = new_cols.get(spec[1], (
                        np.zeros(n_new, t.np_dtype), np.zeros(n_new, bool), None))
                    if entry.col_types[spec[1]] != t:
                        raise not_ported("ON CONFLICT DO UPDATE between columns of two types")
                    part = (np.asarray(vals)[src], None if valid is None else valid[src], dvals)
                else:
                    b = ExprBinder(Scope()).bind(spec[1])
                    if not b.is_const():
                        raise not_ported("ON CONFLICT DO UPDATE SET of an expression other "
                                         "than excluded.col or a constant")
                    if b.ltype != t and b.ltype.id is not TypeId.SQLNULL:
                        b = B.BoundCast(b, t)
                    v = b.const_value()
                    k = len(src)
                    if t.id in _SORTED_DICT:
                        part = (np.zeros(k, np.int32), None if v is not None else np.zeros(k, bool),
                                np.array(["" if v is None else str(v)], dtype=object))
                    else:
                        part = (np.full(k, 0 if v is None else v, dtype=t.np_dtype),
                                None if v is not None else np.zeros(k, bool), None)
                staged[cname] = self._scatter(entry, cname, rows, *part)
            for cname, (vals, valid, dvals, exact) in staged.items():
                entry.set_host_column(cname, vals, valid, dvals, exact_dict=exact)
            n_updated = len(rows)
        idx = np.flatnonzero(keep)
        out = {c: (np.asarray(v)[idx], None if va is None else va[idx], d)
               for c, (v, va, d) in new_cols.items()}
        return out, len(idx), n_updated

    # -- the rows a statement touches -------------------------------------------------
    def _scatter(self, entry: TableEntry, cname: str, rows, vals, valid, dvals, base=None):
        """Column `cname` (or the planes `base` staged for it) with `rows` set
        to the given values → new planes (values, validity|None, dictionary,
        dictionary exact?); the old planes are not changed."""
        t = entry.col_types[cname]
        old_vals, old_valid, old_dict = base or entry.host_column(cname)
        n = entry.nrows
        if t.id in _SORTED_DICT:
            codes, d = _merge_dicts([(old_vals, old_dict), (vals, dvals)])
            out = codes[:n].copy()
            out[rows] = codes[n:]
            exact = False
        elif t.id in UNSORTED_DICT_IDS:
            entries = [old_dict[c] for c in old_vals]
            for r, c in zip(rows, vals):
                entries[r] = dvals[c]
            out, d = encode_objects(entries)
            exact = True
        else:
            out = old_vals.astype(t.np_dtype, copy=True)
            out[rows] = np.asarray(vals).astype(t.np_dtype, copy=False)
            d, exact = old_dict, True
        ov = np.ones(n, bool) if old_valid is None else old_valid.copy()
        ov[rows] = True if valid is None else valid
        return out, (None if ov.all() else ov), d, exact

    def _matching_rows(self, entry: TableEntry, alias, where, exprs=(), types=(),
                       extra_from=None):
        """The rows of `entry` that match WHERE (joined with the FROM /
        USING references `extra_from`), and the values of `exprs` on them
        cast to `types`, all computed on the device by one SELECT over the
        table and a row-id column → (sorted row ids, [(values, validity,
        dictionary)] in their order). The table's clone shares its device
        columns, so nothing is promoted twice."""
        alias = (alias or entry.name.split(".")[-1]).lower()
        name = "__dml_rows"
        tmp = entry.clone()
        tmp.name = name
        tmp.columns = list(entry.columns) + [ColumnDef("__rid", BIGINT)]
        tmp.col_types = dict(entry.col_types, __rid=BIGINT)
        n = entry.nrows
        self.catalog.create_table(tmp, or_replace=True)
        data = torch.zeros(pad_bucket(n), dtype=torch.int64, device=self.device)
        data[:n] = torch.arange(n, dtype=torch.int64, device=self.device)
        tmp.set_generated_column("__rid", Column(data=data, ltype=BIGINT), ColumnStats(
            min_val=0 if n else None, max_val=n - 1 if n else None, n_unique=n))
        ref = N.BaseTableRef(name, alias=alias)
        for u in extra_from or ():
            ref = N.JoinRef(ref, u, "cross")
        stmt = N.SelectStatement(node=N.SelectNode(
            select_list=[(N.ColumnRef((alias, "__rid")), None)] + [(e, None) for e in exprs],
            from_table=ref, where=where))
        try:
            m, cols, _ = self._query_columns(stmt, [BIGINT] + list(types))
        finally:
            self.catalog.drop_table(name, if_exists=True)
        rids = cols[0][0].astype(np.int64)
        order = np.argsort(rids, kind="stable")
        rids = rids[order]
        if len(rids) > 1:
            first = np.ones(len(rids), bool)
            first[1:] = rids[1:] != rids[:-1]  # a row met twice is written once
            order, rids = order[first], rids[first]
        vals = [(np.asarray(v)[order], None if va is None else va[order], d)
                for v, va, d in cols[1:]]
        return rids, vals

    def _eval_returning(self, entry: TableEntry, items, rows):
        """RETURNING: a SELECT of its list over the given rows of the table
        (a scratch copy the executor scans in the table's place)."""
        tmp = TableEntry(entry.name, list(entry.columns))
        tmp.nrows = len(rows)
        tmp.device = entry.device
        for cd in entry.columns:
            vals, valid, dvals = entry.host_column(cd.name)
            tmp.set_host_column(cd.name, np.asarray(vals)[rows],
                                None if valid is None else np.asarray(valid)[rows], dvals,
                                exact_dict=False)
        select = [(N.Star(), None) if e == "*" else (e, alias) for e, alias in items]
        stmt = N.SelectStatement(node=N.SelectNode(select_list=select,
                                                   from_table=N.BaseTableRef(entry.name)))
        planner = self._planner()
        try:
            plan, output = planner.plan_select(M.expand_macros(stmt, planner.macros()))
            ex = Executor(self.catalog, self.routes)
            ex.scan_overrides = {entry.name: tmp}
            return ex.run(plan, output)
        finally:
            self._drop_tables(planner.hidden_tables)

    # -- DELETE -----------------------------------------------------------------------
    def _delete(self, s: N.DeleteStatement):
        s.table = self._resolve_default(s.table)
        self._check_writable(s.table)
        entry = self.catalog.writable_table(s.table)
        mask = np.zeros(entry.nrows, bool)
        if s.where is None and not s.using:
            mask[:] = True
        else:
            rids, _ = self._matching_rows(entry, s.alias, s.where, extra_from=s.using)
            mask[rids] = True
        returning = (self._eval_returning(entry, s.returning, np.flatnonzero(mask))
                     if s.returning else None)
        self._delete_rows(entry, mask)
        if returning is not None:
            return returning
        return self._count_result(int(mask.sum()))

    def _delete_rows(self, entry: TableEntry, mask):
        """Remove the rows of `mask` (bool over the table's rows), once no
        FOREIGN KEY of another table references a key that goes."""
        if not mask.any():
            return
        keep = ~mask
        # a parent key that goes must not stay referenced (DuckDB's
        # VerifyDeleteForeignKeyConstraint)
        for child, ccols, rcols in self._fk_children_of(entry.name):
            if child is entry:
                continue
            key, valid = self._table_keys(entry, rcols)
            gone = set(key[mask & valid].tolist()) - set(key[keep & valid].tolist())
            if not gone:
                continue
            ckey, cvalid = self._table_keys(child, ccols)
            for k in ckey[cvalid].tolist():
                if k in gone:
                    raise ConstraintException(
                        f'Violates foreign key constraint because key "{k}" is still '
                        f'referenced by a foreign key in table "{child.name}"')
        for cd in entry.columns:
            vals, valid, dvals = entry.host_column(cd.name)
            entry.set_host_column(cd.name, vals[keep],
                                  None if valid is None else valid[keep], dvals,
                                  exact_dict=False)
        entry.nrows = int(keep.sum())

    # -- UPDATE -----------------------------------------------------------------------
    def _update(self, s: N.UpdateStatement):
        s.table = self._resolve_default(s.table)
        self._check_writable(s.table)
        entry = self.catalog.writable_table(s.table)
        assigns = [(self._colname(entry, c), e) for c, e in s.assignments]
        if len({c for c, _ in assigns}) != len(assigns):
            raise BindError("Binder Error: a column is assigned twice in the UPDATE")
        rids, values = self._matching_rows(entry, s.alias, s.where, [e for _, e in assigns],
                                           [entry.col_types[c] for c, _ in assigns],
                                           extra_from=getattr(s, "from_refs", None))
        staged = {c: self._scatter(entry, c, rids, *v) for (c, _), v in zip(assigns, values)}
        if len(rids):
            self._verify_update_constraints(entry, staged, rids)
        for c, (vals, valid, dvals, exact) in staged.items():
            entry.set_host_column(c, vals, valid, dvals, exact_dict=exact)
        if s.returning:
            return self._eval_returning(entry, s.returning, rids)
        return self._count_result(len(rids))

    def _verify_update_constraints(self, entry: TableEntry, staged, rids):
        """The constraints over the table as the UPDATE leaves it, before any
        column is written (DuckDB's VerifyUpdateConstraints)."""
        def post(name):
            return staged[name][:3] if name in staged else entry.host_column(name)

        n = entry.nrows
        # a parent key the UPDATE changes must not stay referenced (SQL's
        # default NO ACTION; DuckDB's VerifyUpdateConstraints): F5
        for child, ccols, rcols in self._fk_children_of(entry.name):
            if child is entry or not any(c in staged for c in rcols):
                continue
            old, old_valid = self._table_keys(entry, rcols)
            new, new_valid = self._keys([self._key_part(*post(c), entry.col_types[c], n)
                                         for c in rcols])
            gone = set(old[rids][old_valid[rids]].tolist()) - set(new[new_valid].tolist())
            if not gone:
                continue
            ckey, cvalid = self._table_keys(child, ccols)
            for k in ckey[cvalid].tolist():
                if k in gone:
                    raise ConstraintException(
                        f'Violates foreign key constraint because key "{k}" is still '
                        f'referenced by a foreign key in table "{child.name}"')
        for con in entry.constraints:
            kind = con[0]
            if kind == "not_null" and con[1] in staged:
                valid = staged[con[1]][1]
                if valid is not None and not valid.all():
                    raise ConstraintException(f"NOT NULL constraint failed: "
                                              f"{entry.name}.{con[1]}")
            elif kind in ("primary_key", "unique") and any(c in staged for c in con[1]):
                key, valid = self._keys([self._key_part(*post(c), entry.col_types[c], n)
                                         for c in con[1]])
                live = key[valid]
                if len(np.unique(live)) < len(live):
                    label = "PRIMARY KEY" if kind == "primary_key" else "UNIQUE"
                    raise ConstraintException(f"duplicate key violates {label} constraint on "
                                              f"{entry.name}({', '.join(con[1])})")
            elif kind == "foreign_key" and any(c in staged for c in con[1]):
                parent, rcols = self._fk_parent(con)
                key, valid = self._keys([self._key_part(*post(c), entry.col_types[c], n)
                                         for c in con[1]])
                pset = self._live_keys(parent, rcols)
                for k in key[rids][valid[rids]].tolist():
                    if k not in pset:
                        raise ConstraintException(
                            f'Violates foreign key constraint because key "{k}" does not '
                            f'exist in the referenced table "{con[2]}"')
            elif kind == "check":
                rows = {}
                for cd in entry.columns:
                    vals, valid, dvals = post(cd.name)
                    rows[cd.name] = (np.asarray(vals)[rids],
                                     None if valid is None else valid[rids], dvals)
                self._verify_check(entry, rows, len(rids), con[1])
