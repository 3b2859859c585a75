"""The statements that define: CREATE / DROP of tables, views, schemas,
macros, sequences, types and indexes, and COMMENT ON.

The JAX package's DDL (duckdb_tpu/api/connection.py: `_create_table`,
the CREATE VIEW / SCHEMA / MACRO / SEQUENCE / TYPE branches of
`_execute_statement_inner`, `_create_index`, `_comment_on` and DROP),
kept under its method names, on the catalog of the statement (a
transaction's snapshot inside BEGIN … COMMIT). CREATE TABLE … AS SELECT
runs its query on the device and keeps the columns there
(`TableEntry.set_device_column`). Where the JAX package differs from
DuckDB the port follows DuckDB: CREATE SEQUENCE of a name that exists
raises (ROADMAP Queue 3).
"""

from __future__ import annotations

import numpy as np

from duckdb_tpu_torch.catalog.catalog import ColumnDef, TableEntry, qualify
from duckdb_tpu_torch.errors import ConnectionException
from duckdb_tpu_torch.execution.executor import Executor
from duckdb_tpu_torch.planner import macros as M
from duckdb_tpu_torch.planner.binder import resolve_type_name
from duckdb_tpu_torch.planner.bound import BindError, not_ported
from duckdb_tpu_torch.sql import nodes as N
from duckdb_tpu_torch.sql.walk import column_refs


class MacroBindError(BindError, ConnectionException):
    """A macro that does not define or expand (a default naming a column,
    an unknown named argument, a macro calling itself): a Binder Error, and
    the JAX package's ConnectionException."""


class DDLMixin:
    """The DDL of `Connection` (api/connection.py)."""

    # statement class → the method that runs it
    _DDL = {N.CreateTable: "_create_table", N.CreateView: "_create_view",
            N.CreateSchema: "_create_schema", N.CreateMacro: "_create_macro",
            N.DropStatement: "_drop", N.CreateSequence: "_create_sequence",
            N.CreateType: "_create_type", N.CreateIndex: "_create_index",
            N.CommentStatement: "_comment_on"}

    def _resolve_default(self, name: str, creating: bool = False) -> str:
        """An unqualified name in the USE schema: a new object goes there; a
        lookup prefers it where it holds the name."""
        if self._default_schema == "main" or "." in name.replace("\x02", ""):
            return name
        q = f"{self._default_schema}.{name.lower()}"
        if creating or self.catalog.has_table(q) or qualify(q) in self.catalog.views:
            return q
        return name

    def _check_writable(self, name: str):
        """A write into a database attached READ_ONLY raises."""
        head = qualify(name).split(".", 1)[0]
        info = self.catalog.attached.get(head)
        if info is not None and info.get("read_only"):
            raise ConnectionException(f'Cannot execute statement of type "write" on database '
                                      f'"{head}" which is attached in read-only mode!')

    @staticmethod
    def _colname(entry: TableEntry, name: str) -> str:
        for c in entry.columns:
            if c.name.lower() == name.lower():
                return c.name
        raise BindError(f'Binder Error: Column "{name}" does not exist')

    # -- tables -----------------------------------------------------------------
    def _create_table(self, s: N.CreateTable):
        s.name = self._resolve_default(s.name, creating=True)
        self._check_writable(s.name)
        if s.if_not_exists and self.catalog.has_table(s.name):
            return None
        if s.as_select is not None:
            planner = self._planner()
            try:
                plan, output = planner.plan_select(M.expand_macros(s.as_select,
                                                                   planner.macros()))
                n, cols = Executor(self.catalog, self.routes).materialize(plan, output)
            finally:
                self._drop_tables(planner.hidden_tables)
            entry = TableEntry(s.name, [ColumnDef(nm, t) for nm, _, t in output])
            entry.nrows = n
            self.catalog.create_table(entry, or_replace=s.or_replace)
            # the query's columns stay on the device as the table's
            for (nm, _, _), col in zip(output, cols):
                entry.set_device_column(nm, col)
            return None
        cols = [ColumnDef(c.name, resolve_type_name(c.type_name, c.type_mods))
                for c in s.columns]
        entry = TableEntry(s.name, cols)
        for c in s.columns:
            if c.not_null:
                entry.constraints.append(("not_null", c.name))
            if c.primary_key:
                entry.constraints.append(("primary_key", [c.name]))
            if c.unique:
                entry.constraints.append(("unique", [c.name]))
            if c.check:
                entry.constraints.append(("check", c.check))
            if c.references:
                rt, rc = c.references
                entry.constraints.append(("foreign_key", [c.name], rt, [rc] if rc else []))
        for con in s.constraints:
            if con[0] in ("primary_key", "unique", "foreign_key"):
                con = (con[0], [self._colname(entry, c) for c in con[1]]) + tuple(con[2:])
            if con[0] == "primary_key":
                entry.constraints += [("not_null", c) for c in con[1]]
            entry.constraints.append(con)
        for c in s.columns:
            if c.default is not None and c.default_text:
                entry.defaults[c.name] = c.default_text
        for cd in cols:
            entry.set_host_column(cd.name, np.empty(0, dtype=cd.ltype.np_dtype))
        self.catalog.create_table(entry, or_replace=s.or_replace)
        return None

    # -- views, schemas, macros -----------------------------------------------------
    def _create_view(self, s: N.CreateView):
        if s.temporary:
            # a TEMPORARY view is this connection's own
            key = s.name.lower()
            if key in self._temp_views and not s.or_replace:
                raise ConnectionException(f'view "{s.name}" already exists')
            self._temp_views[key] = s.query
            return None
        key = qualify(self._resolve_default(s.name, creating=True))
        self._check_writable(key)
        if key in self.catalog.views and not s.or_replace:
            raise ConnectionException(f'view "{s.name}" already exists')
        # the text a file database keeps for the view
        s.query._create_text = getattr(s, "_create_text", None)
        self.catalog.views[key] = s.query
        return None

    def _create_schema(self, s: N.CreateSchema):
        if s.name.lower() in self.catalog.schemas:
            if s.if_not_exists:
                return None
            raise ConnectionException(f'Catalog Error: Schema with name "{s.name}" already '
                                      "exists!")
        self.catalog.schemas.add(s.name.lower())
        return None

    def _create_macro(self, s: N.CreateMacro):
        key = s.name.lower()
        reg = self.catalog.table_macros if s.is_table else self.catalog.macros
        if (key in reg or (not s.is_table and key in M.default_macros())) \
                and not s.or_replace:
            if s.if_not_exists:
                return None
            raise ConnectionException(f'Catalog Error: Macro with name "{s.name}" already '
                                      "exists!")
        for dname, dexpr in s.defaults.items():
            if next(column_refs(dexpr), None) is not None:
                raise MacroBindError(f"Binder Error: Default value for parameter '{dname}' "
                                     "cannot contain column names")
        reg[key] = M.MacroDef(key, tuple(p.lower() for p in s.params), dict(s.defaults),
                              s.body, s.is_table, getattr(s, "_create_text", ""))
        return None

    def _create_sequence(self, s: N.CreateSequence):
        key = qualify(s.name)
        if key in self.catalog.sequences:
            if s.if_not_exists:
                return None
            # DuckDB refuses; the JAX package starts the sequence again
            raise ConnectionException(f'Catalog Error: Sequence with name "{s.name}" already '
                                      "exists!")
        self.catalog.sequences[key] = {"value": s.start, "increment": s.increment}
        return None

    def _create_type(self, s: N.CreateType):
        key = s.name.lower()
        if key in self.catalog.user_types:
            if s.if_not_exists:
                return None
            if not s.or_replace:
                raise ConnectionException(f'Catalog Error: Type with name "{s.name}" already '
                                          "exists!")
        if s.enum_values:
            self.catalog.user_types[key] = {"kind": "enum", "values": list(s.enum_values)}
        else:
            self.catalog.user_types[key] = {"kind": "alias", "base": s.base,
                                            "mods": list(s.base_mods)}
        return None

    # -- indexes and comments -----------------------------------------------------
    def _create_index(self, s: N.CreateIndex):
        """An index is catalog metadata; a UNIQUE one adds a unique
        constraint, checked against the rows there (joins find keys through
        their own tables, so a plain index adds no access path)."""
        entry = self.catalog.get_table(self._resolve_default(s.table))
        key = s.name.lower()
        if key in self.catalog.indexes:
            if s.if_not_exists:
                return None
            raise ConnectionException(f'Catalog Error: Index with name "{s.name}" already '
                                      "exists!")
        if s.unique:
            cols = [e.strip().strip('"') for e in s.exprs]
            if not all(any(c.name.lower() == x.lower() for c in entry.columns) for x in cols):
                raise not_ported("a UNIQUE index over expressions")
            ucols = [self._colname(entry, x) for x in cols]
            self._verify_existing_unique(entry, ucols, s.name)
            entry = self.catalog.writable_table(entry.name)
            entry.constraints.append(("unique", ucols))
            entry.mark_written()  # a new constraint is a write of the table
        self.catalog.indexes[key] = {"table": entry.name, "exprs": list(s.exprs),
                                     "unique": s.unique}
        return None

    def _comment_on(self, s: N.CommentStatement):
        """COMMENT ON …: duckdb_tables(), duckdb_columns(), duckdb_views() and
        duckdb_indexes() show it."""
        comments = self.catalog.comments
        if s.kind == "column":
            tbl, _, col = s.name.rpartition(".")
            entry = self.catalog.get_table(self._resolve_default(tbl))
            if not any(c.name.lower() == col.lower() for c in entry.columns):
                raise BindError(f'Catalog Error: Column with name "{col}" does not exist!')
            comments[("column", entry.name, col.lower())] = s.comment
        elif s.kind == "table":
            entry = self.catalog.get_table(self._resolve_default(s.name))
            comments[("table", entry.name)] = s.comment
        else:
            comments[(s.kind, qualify(s.name))] = s.comment
        return None

    # -- DROP -------------------------------------------------------------------------
    def _drop(self, s: N.DropStatement):
        cat = self.catalog
        name = s.name.lower()
        if s.kind == "view":
            if name in self._temp_views:
                del self._temp_views[name]
            elif cat.views.pop(qualify(self._resolve_default(s.name)), None) is None \
                    and not s.if_exists:
                raise ConnectionException(f'view "{s.name}" does not exist')
        elif s.kind == "schema":
            if name not in cat.schemas:
                if not s.if_exists:
                    raise ConnectionException(f'Catalog Error: Schema with name "{s.name}" '
                                              "does not exist!")
                return None
            inside = [k for k in cat.tables if k.startswith(name + ".")]
            if inside and not s.cascade:
                raise ConnectionException(
                    f'Dependency Error: Cannot drop schema "{s.name}" because there are '
                    "entries that depend on it. Use DROP ... CASCADE to drop all dependents.")
            for k in inside:
                cat.drop_table(k)
            cat.schemas.discard(name)
        elif s.kind == "sequence":
            if cat.sequences.pop(qualify(s.name), None) is None and not s.if_exists:
                raise ConnectionException(f'sequence "{s.name}" does not exist')
        elif s.kind in ("macro", "macro table"):
            reg = cat.table_macros if s.kind == "macro table" else cat.macros
            if reg.pop(name, None) is None and not s.if_exists:
                raise ConnectionException(f'macro "{s.name}" does not exist')
        elif s.kind == "type":
            if cat.user_types.pop(name, None) is None and not s.if_exists:
                raise ConnectionException(f'Catalog Error: Type with name "{s.name}" does not '
                                          "exist!")
        elif s.kind == "index":
            info = cat.indexes.pop(name, None)
            if info is None:
                if not s.if_exists:
                    raise ConnectionException(f'Catalog Error: Index with name "{s.name}" does '
                                              "not exist!")
            elif info["unique"] and cat.has_table(info["table"]):
                # the unique constraint the index added goes with it
                entry = cat.get_table(info["table"])
                want = ("unique", [self._colname(entry, e.strip().strip('"'))
                                   for e in info["exprs"]])
                if want in entry.constraints:
                    entry = cat.writable_table(info["table"])
                    entry.constraints.remove(want)
                    entry.mark_written()
        elif s.kind == "table":
            key = qualify(self._resolve_default(s.name))
            self._check_writable(key)
            if key in cat.tables:
                # a table another table's FOREIGN KEY names stays (DuckDB's
                # Catalog Error): F6
                for child, _, _ in self._fk_children_of(key):
                    if child.name != key:
                        raise ConnectionException(
                            "Catalog Error: Could not drop the table because this table is "
                            f'main key table of the table "{child.name}"')
            cat.drop_table(key, if_exists=s.if_exists)
        else:
            raise not_ported(f"DROP {s.kind.upper()}")
        return None

