"""ALTER TABLE: ADD, DROP and RENAME COLUMN, RENAME TO, and ALTER COLUMN
TYPE / SET DATA TYPE, SET and DROP DEFAULT, SET and DROP NOT NULL.

The JAX package's `_alter` (duckdb_tpu/api/connection.py), one method per
action. Every action works on the statement's clone of the table
(`Catalog.writable_table`) and replaces its `columns`, `col_types`,
`constraints` and `defaults` rather than changing them in place, so a
ROLLBACK finds the published table as it was; each ends with
`mark_written`, so the key sets kept per version and the cached plans see
the change.

Where the JAX package differs from DuckDB the port follows DuckDB
(duck_table_entry.cpp):
- RENAME COLUMN renames the column wherever the catalog names it: the
  PRIMARY KEY, UNIQUE and NOT NULL constraints, the column references
  inside a CHECK (found on the parsed expression, so a string literal that
  spells the name stays), the DEFAULT, the comments, the indexes, and the
  FOREIGN KEYs of other tables that reference it (ROADMAP A1);
- DROP COLUMN refuses a column that a PRIMARY KEY, UNIQUE or FOREIGN KEY
  constraint, an index or a CHECK over several columns depends on, and
  drops a CHECK or NOT NULL over that column alone with it (A2).
ALTER … TYPE evaluates `CAST(col AS type)`, or its USING expression cast to
the type, as a SELECT over the table on the device (`_query_columns`).
"""

from __future__ import annotations

import numpy as np

from duckdb_tpu_torch.api.dml import _SORTED_DICT
from duckdb_tpu_torch.blocks.nested import UNSORTED_DICT_IDS, encode_objects
from duckdb_tpu_torch.catalog.catalog import POOL, ColumnDef, TableEntry, qualify
from duckdb_tpu_torch.errors import CatalogException, ConstraintException
from duckdb_tpu_torch.planner.binder import resolve_type_name
from duckdb_tpu_torch.sql import nodes as N
from duckdb_tpu_torch.sql.parser import Parser
from duckdb_tpu_torch.sql.walk import column_refs, table_ref


def referenced_columns(text: str) -> set:
    """The (lowered) column names an expression's text refers to."""
    return {r.parts[-1].lower() for r in column_refs(Parser(text).parse_expr())}


def _ident_end(text: str, pos: int) -> int:
    """Where the identifier that starts at `pos` ends (quoted or bare)."""
    if text[pos] == '"':
        j = pos + 1
        while j < len(text):
            if text[j] == '"':
                if text[j + 1:j + 2] == '"':
                    j += 2
                    continue
                return j + 1
            j += 1
        return j
    j = pos
    while j < len(text) and (text[j].isalnum() or text[j] in "_$"):
        j += 1
    return j


def quote_ident(name: str) -> str:
    return '"' + name.replace('"', '""') + '"'


def rename_refs(text: str, old: str, new: str) -> str:
    """An expression's text with each reference to column `old` naming
    `new`: the references are the parsed expression's column nodes (the
    parser keeps where each starts), so literals and function names that
    spell `old` stay as they are."""
    spots = sorted((r._pos for r in column_refs(Parser(text).parse_expr())
                    if r.parts[-1].lower() == old.lower() and hasattr(r, "_pos")),
                   reverse=True)
    for pos in spots:
        text = text[:pos] + quote_ident(new) + text[_ident_end(text, pos):]
    return text


def null_planes(t, n: int):
    """n NULLs of type t as host planes."""
    valid = np.zeros(n, bool) if n else None
    if t.id in _SORTED_DICT:
        return np.zeros(n, np.int32), valid, np.array([""], dtype=object)
    if t.id in UNSORTED_DICT_IDS:
        codes, d = encode_objects([()] * n)
        return codes, valid, d
    return np.zeros(n, t.np_dtype), valid, None


class AlterMixin:
    """ALTER TABLE of `Connection` (api/connection.py)."""

    def _alter(self, s: N.AlterStatement):
        s.table = self._resolve_default(s.table)
        self._check_writable(s.table)
        if not self.catalog.has_table(s.table):
            if s.if_exists:
                return None
            raise CatalogException(f"Table with name {s.table} does not exist!")
        entry = self.catalog.writable_table(s.table)
        getattr(self, "_alter_" + s.action)(entry, s)
        entry.mark_written()
        return None

    @staticmethod
    def _alter_column(entry: TableEntry, name: str) -> str:
        for c in entry.columns:
            if c.name.lower() == name.lower():
                return c.name
        raise CatalogException(f'Table "{entry.name}" does not have a column with name '
                               f'"{name}"')

    # -- columns --------------------------------------------------------------------
    def _alter_add_column(self, entry: TableEntry, s: N.AlterStatement):
        if any(c.name.lower() == s.name.lower() for c in entry.columns):
            if s.col_if:
                return
            raise CatalogException(f'Column with name {s.name} already exists!')
        cd = ColumnDef(s.name, resolve_type_name(s.col_type, s.col_mods))
        entry.columns = entry.columns + [cd]
        entry.col_types = {**entry.col_types, cd.name: cd.ltype}
        if s.default is not None and s.default_text:
            entry.defaults = {**entry.defaults, cd.name: s.default_text}
            if entry.nrows:
                # the rows there take the default, evaluated once a row
                # (DuckDB's AddColumn): random() and nextval() differ by row
                entry.set_host_column(cd.name, *self._eval_default(entry, cd, entry.nrows))
                return
        entry.set_host_column(cd.name, *null_planes(cd.ltype, entry.nrows))

    def _alter_drop_column(self, entry: TableEntry, s: N.AlterStatement):
        """DuckDB's RemoveColumn: a column that a key, a FOREIGN KEY, an index
        or a CHECK over several columns depends on stays; a CHECK or NOT
        NULL over it alone goes with it (A2)."""
        if not any(c.name.lower() == s.name.lower() for c in entry.columns) and s.col_if:
            return
        cn = self._alter_column(entry, s.name)
        if len(entry.columns) == 1:
            raise CatalogException("Cannot drop column: table only has one column remaining!")

        def depends(what):
            return CatalogException(f'Cannot drop column "{cn}" because there is a {what} '
                                    "constraint that depends on it")

        kept = []
        for con in entry.constraints:
            kind = con[0]
            if kind == "not_null" and con[1] == cn:
                continue
            if kind in ("primary_key", "unique") and cn in con[1]:
                raise depends("UNIQUE")
            if kind == "foreign_key" and cn in con[1]:
                raise depends("FOREIGN KEY")
            if kind == "check":
                refs = referenced_columns(con[1])
                if cn.lower() in refs:
                    if len(refs) > 1:
                        raise depends("CHECK")
                    continue
            kept.append(con)
        for child, _, rcols in self._fk_children_of(entry.name):
            if cn in rcols:
                raise depends("FOREIGN KEY")
        for info in self.catalog.indexes.values():
            if info["table"] == entry.name and any(
                    cn.lower() in referenced_columns(e) for e in info["exprs"]):
                raise CatalogException("Cannot drop this column: an index depends on it!")
        entry.constraints = kept
        entry.columns = [c for c in entry.columns if c.name != cn]
        entry.col_types = {k: v for k, v in entry.col_types.items() if k != cn}
        entry.defaults = {k: v for k, v in entry.defaults.items() if k != cn}
        entry._host = {k: v for k, v in entry._host.items() if k != cn}
        entry._loaders = {k: v for k, v in entry._loaders.items() if k != cn}
        entry._device = {k: v for k, v in entry._device.items() if k != cn}
        entry.stats = {k: v for k, v in entry.stats.items() if k != cn}
        POOL.release(entry, cn)  # the column's bytes leave with its last holder
        self.catalog.comments.pop(("column", entry.name, cn.lower()), None)

    def _alter_rename_column(self, entry: TableEntry, s: N.AlterStatement):
        """The column's new name everywhere the catalog holds it (A1)."""
        cn, new = self._alter_column(entry, s.name), s.new_name
        if any(c.name.lower() == new.lower() and c.name != cn for c in entry.columns):
            raise CatalogException(f"Column with name {new} already exists!")
        # found while the old name still resolves
        children = [c for c, _, _ in self._fk_children_of(entry.name) if c is not entry]

        def rn(name):
            return new if name == cn else name

        entry.columns = [ColumnDef(rn(c.name), c.ltype) for c in entry.columns]
        entry.col_types = {rn(k): v for k, v in entry.col_types.items()}
        entry.defaults = {rn(k): v for k, v in entry.defaults.items()}
        entry._host = {rn(k): v for k, v in entry._host.items()}
        entry._loaders = {rn(k): v for k, v in entry._loaders.items()}
        entry.stats = {rn(k): v for k, v in entry.stats.items()}
        col = entry._device.get(cn)
        POOL.release(entry, cn)
        entry._device = {rn(k): v for k, v in entry._device.items()}
        if col is not None:
            entry._pool(new, col, use=False)  # the same Column under its new name
        entry._key_sets = {}  # keyed by the old names; the lineage's own from now
        own = qualify(entry.name)

        def rename_referenced(con):
            """A FOREIGN KEY that references this table, naming `new` among
            the columns it references; any other constraint as it is."""
            if con[0] == "foreign_key" and qualify(self._resolve_default(con[2])) == own:
                return con[:3] + ([rn(c) for c in con[3]],) + tuple(con[4:])
            return con

        def rename_own(con):
            kind = con[0]
            if kind == "not_null":
                return (kind, rn(con[1]))
            if kind in ("primary_key", "unique"):
                return (kind, [rn(c) for c in con[1]])
            if kind == "check":
                return (kind, rename_refs(con[1], cn, new))
            if kind == "foreign_key":
                return rename_referenced((kind, [rn(c) for c in con[1]]) + tuple(con[2:]))
            return con

        entry.constraints = [rename_own(con) for con in entry.constraints]
        # another table's own columns keep their names, even one that
        # shares the renamed column's name
        for child in children:
            renamed = [rename_referenced(con) for con in child.constraints]
            if renamed != child.constraints:
                child = self.catalog.writable_table(child.name)
                child.constraints = renamed
                child.mark_written()
        comments = self.catalog.comments
        key = ("column", entry.name, cn.lower())
        if key in comments:
            comments[("column", entry.name, new.lower())] = comments.pop(key)
        for iname, info in list(self.catalog.indexes.items()):
            if info["table"] == entry.name:
                exprs = [rename_refs(e, cn, new) for e in info["exprs"]]
                if exprs != info["exprs"]:
                    self.catalog.indexes[iname] = {**info, "exprs": exprs}

    def _alter_alter_type(self, entry: TableEntry, s: N.AlterStatement):
        """The column again, cast to the new type on the device: `CAST(col
        AS type)`, or the USING expression cast to it."""
        cn = self._alter_column(entry, s.name)
        lt = resolve_type_name(s.col_type, s.col_mods)
        expr = s.using if s.using is not None else N.ColumnRef((cn,))
        stmt = N.SelectStatement(node=N.SelectNode(select_list=[(expr, "v")],
                                                   from_table=table_ref(entry.name)))
        n, (planes,), _ = self._query_columns(stmt, [lt])
        assert n == entry.nrows, (n, entry.nrows)
        entry.columns = [ColumnDef(c.name, lt) if c.name == cn else c for c in entry.columns]
        entry.col_types = {**entry.col_types, cn: lt}
        entry.set_host_column(cn, *planes)

    # -- defaults and NOT NULL ----------------------------------------------------
    def _alter_set_default(self, entry: TableEntry, s: N.AlterStatement):
        cn = self._alter_column(entry, s.name)
        if s.default_text:
            entry.defaults = {**entry.defaults, cn: s.default_text}

    def _alter_drop_default(self, entry: TableEntry, s: N.AlterStatement):
        cn = self._alter_column(entry, s.name)
        entry.defaults = {k: v for k, v in entry.defaults.items() if k != cn}

    def _alter_set_not_null(self, entry: TableEntry, s: N.AlterStatement):
        cn = self._alter_column(entry, s.name)
        _, valid, _ = entry.host_column(cn)
        if valid is not None and not np.asarray(valid)[:entry.nrows].all():
            raise ConstraintException(f"NOT NULL constraint failed: {entry.name}.{cn}")
        if ("not_null", cn) not in entry.constraints:
            entry.constraints = entry.constraints + [("not_null", cn)]

    def _alter_drop_not_null(self, entry: TableEntry, s: N.AlterStatement):
        cn = self._alter_column(entry, s.name)
        entry.constraints = [c for c in entry.constraints if c != ("not_null", cn)]

    # -- the table ----------------------------------------------------------------
    def _alter_rename_table(self, entry: TableEntry, s: N.AlterStatement):
        """A new catalog key: COMMIT publishes the new one and the removal of
        the old, so the first-committer-wins check sees both. The comments,
        indexes and FOREIGN KEYs that name the table follow it."""
        cat = self.catalog
        old = entry.name
        schema, _, _ = old.rpartition(".")
        new = qualify(f"{schema}.{s.new_name}" if schema else s.new_name)
        if cat.has_table(new) or new in cat.views:
            raise CatalogException(f'Could not rename "{old}" to "{s.new_name}": another '
                                   "entry with this name already exists!")
        children = [c for c, _, _ in self._fk_children_of(old) if c is not entry]
        # not drop_table: the clone's device columns stay in the pool
        del cat.tables[old]
        entry.name = new
        cat.tables[new] = entry

        def retarget(con):
            if con[0] == "foreign_key" and qualify(self._resolve_default(con[2])) == old:
                return con[:2] + (new,) + tuple(con[3:])
            return con

        entry.constraints = [retarget(c) for c in entry.constraints]
        for child in children:
            child = cat.writable_table(child.name)
            child.constraints = [retarget(c) for c in child.constraints]
            child.mark_written()
        for key in [k for k in cat.comments if k[0] in ("table", "column") and k[1] == old]:
            cat.comments[(key[0], new) + key[2:]] = cat.comments.pop(key)
        for iname, info in list(cat.indexes.items()):
            if info["table"] == old:
                cat.indexes[iname] = {**info, "table": new}
