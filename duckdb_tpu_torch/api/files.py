"""COPY TO / FROM, EXPORT DATABASE and IMPORT DATABASE.

The JAX package's `_copy`, `_export_database` and `_import_database`
(duckdb_tpu/api/connection.py; DuckDB's physical_copy_to_file.cpp,
physical_export.cpp), over the port's storage/csv.py and storage/parquet.py.

- COPY … TO writes a table, or a query's result, as CSV (DELIMITER or
  DELIM, HEADER, QUOTE) or Parquet (FORMAT PARQUET or a .parquet target;
  COMPRESSION). A table is written from its host planes, without a query.
- COPY … FROM appends a file's rows through INSERT's append path
  (api/dml.py `_append_rows`), so that constraints, the transaction and the
  table's version apply: a duplicate key raises ConstraintException and
  leaves the table as it was (the JAX package appends without checking
  keys, ROADMAP Facts). A CSV file is read in the table's types, its
  delimiter and header sniffed unless options set them; a Parquet file's
  columns are taken by position, and cast on the device where their types
  differ from the table's.
- EXPORT DATABASE writes schema.sql, load.sql and one data file per table;
  schema.sql recreates, in dependency order, the schemas, user types,
  sequences at their current value, tables with their constraints and
  defaults, views, macros and indexes (the JAX package writes the tables'
  columns and the views only, ROADMAP I5). IMPORT DATABASE runs the two
  scripts.

A file database makes a commit whose statements read a file durable by a
checkpoint, not by logging their text (api/connection.py `_note_wal`,
ROADMAP F12): replaying COPY … FROM would read the file again.
"""

from __future__ import annotations

import os
import re

from duckdb_tpu_torch.planner.bound import BindError
from duckdb_tpu_torch.sql import nodes as N
from duckdb_tpu_torch.sql.parser import Parser
from duckdb_tpu_torch.storage import csv as csvmod
from duckdb_tpu_torch.storage import parquet as pqmod

_PLAIN_IDENT = re.compile(r"^[a-z_][a-z0-9_]*$")


def reads_files(node) -> bool:
    """Whether a statement's tree calls a file reader (FROM 'file' too)."""
    from duckdb_tpu_torch.planner.planner import Planner

    if isinstance(node, N.TableFunctionRef):
        return node.name.lower() in Planner.FILE_FUNCTIONS or reads_files(node.args)
    if isinstance(node, (list, tuple)):
        return any(reads_files(v) for v in node)
    if hasattr(node, "__dataclass_fields__"):
        return any(reads_files(getattr(node, f)) for f in node.__dataclass_fields__)
    return False


def _truthy(v) -> bool:
    return v is True or str(v).lower() in ("true", "1", "on", "yes")


def _ident(name: str) -> str:
    """A catalog name as SQL: each dotted part quoted unless plain."""
    return ".".join(p if _PLAIN_IDENT.match(p) else '"' + p.replace('"', '""') + '"'
                    for p in name.split("."))


def _lit(v) -> str:
    return "'" + str(v).replace("'", "''") + "'"


def _is_parquet(s: N.CopyStatement) -> bool:
    fmt = str(s.options.get("format", "")).lower()
    return fmt == "parquet" or (not fmt and s.target.lower().endswith(".parquet"))


def _table_sql(name: str, entry, unique_indexes) -> str:
    """CREATE TABLE with the table's constraints and defaults."""
    cons = entry.constraints
    not_null = {c[1] for c in cons if c[0] == "not_null"}
    parts = []
    for cd in entry.columns:
        col = f"{_ident(cd.name)} {cd.ltype!r}"
        if cd.name in not_null:
            col += " NOT NULL"
        if cd.name in entry.defaults:
            col += f" DEFAULT {entry.defaults[cd.name]}"
        parts.append(col)
    for c in cons:
        cols = lambda cs: ", ".join(_ident(x) for x in cs)  # noqa: E731
        if c[0] == "primary_key":
            parts.append(f"PRIMARY KEY ({cols(c[1])})")
        elif c[0] == "unique" and tuple(c[1]) not in unique_indexes:
            parts.append(f"UNIQUE ({cols(c[1])})")
        elif c[0] == "check":
            parts.append(f"CHECK ({c[1]})")
        elif c[0] == "foreign_key":
            ref = f" ({cols(c[3])})" if c[3] else ""
            parts.append(f"FOREIGN KEY ({cols(c[1])}) REFERENCES {_ident(c[2])}{ref}")
    return f"CREATE TABLE {_ident(name)} ({', '.join(parts)});"


def schema_sql(cat, tables) -> list:
    """The statements that recreate the catalog's objects but their rows,
    each object after what it depends on."""
    out = [f"CREATE SCHEMA {_ident(s)};"
           for s in sorted(cat.schemas - {"main"} - set(cat.attached))]
    for name, t in cat.user_types.items():
        if t["kind"] == "enum":
            out.append(f"CREATE TYPE {_ident(name)} AS ENUM "
                       f"({', '.join(_lit(v) for v in t['values'])});")
        else:
            mods = f"({', '.join(map(str, t['mods']))})" if t.get("mods") else ""
            out.append(f"CREATE TYPE {_ident(name)} AS {t['base']}{mods};")
    for name, seq in cat.sequences.items():
        out.append(f"CREATE SEQUENCE {_ident(name)} START WITH {seq['value']} "
                   f"INCREMENT BY {seq['increment']};")
    unique_indexes = {}
    for info in cat.indexes.values():
        if info.get("unique"):
            unique_indexes.setdefault(info["table"], set()).add(
                tuple(e.strip().strip('"') for e in info["exprs"]))
    # a foreign key's parent before its child
    done, order = set(), []

    def visit(name):
        if name in done or name not in tables:
            return
        done.add(name)
        for c in tables[name].constraints:
            if c[0] == "foreign_key":
                visit(c[2].lower())
        order.append(name)

    for name in tables:
        visit(name)
    out += [_table_sql(n, tables[n], unique_indexes.get(n, ())) for n in order]
    for view in cat.views.values():
        text = getattr(view, "_create_text", None)
        if text:
            out.append(text.strip().rstrip(";") + ";")
    for mac in list(cat.macros.values()) + list(cat.table_macros.values()):
        if mac.sql_text:
            out.append(mac.sql_text.strip().rstrip(";") + ";")
    for name, info in cat.indexes.items():
        out.append(f"CREATE {'UNIQUE ' if info.get('unique') else ''}INDEX {_ident(name)} ON "
                   f"{_ident(info['table'])} ({', '.join(info['exprs'])});")
    return out


class FilesMixin:
    """COPY, EXPORT DATABASE and IMPORT DATABASE of api/connection.py."""

    def _copy(self, s: N.CopyStatement):
        if s.direction == "to":
            return self._copy_to(s)
        return self._copy_from(s)

    def _copy_to(self, s: N.CopyStatement):
        if s.select is None and self.catalog.has_table(self._resolve_default(s.table)):
            entry = self.catalog.get_table(self._resolve_default(s.table))
            names = [cd.name for cd in entry.columns]
            types = [cd.ltype for cd in entry.columns]
            columns = [entry.host_column(n) for n in names]
            nrows = entry.nrows
        else:
            stmt = s.select or Parser(f"SELECT * FROM {s.table}").parse_statements()[0]
            res = self._select(stmt)
            names, types, columns, nrows = res.names, res.types, res.columns, res.nrows
        opts = s.options
        if _is_parquet(s):
            pqmod.write_parquet(s.target, names, types, columns, nrows,
                                str(opts.get("compression", "snappy")))
        else:
            csvmod.write_csv(s.target, names, types, columns, nrows,
                             str(opts.get("delimiter", opts.get("delim", opts.get("sep", ",")))),
                             _truthy(opts.get("header", True)), str(opts.get("quote", '"')))
        return None

    def _copy_from(self, s: N.CopyStatement):
        name = self._resolve_default(s.table)
        self._check_writable(name)
        entry = self.catalog.writable_table(name)
        names = [cd.name for cd in entry.columns]
        types = [cd.ltype for cd in entry.columns]
        if _is_parquet(s):
            pf = pqmod.ParquetFile(s.target)
            if len(pf.columns) != len(names):
                raise BindError(f"Binder Error: table {entry.name} has {len(names)} columns but "
                                f"{s.target} has {len(pf.columns)}")
            if pf.schema and [t for _, t in pf.schema] == types:
                cols = [pqmod.load_column(s.target, n, pf) for n, _ in pf.schema]
                n_new = pf.nrows
            else:  # the types differ: cast on the device
                stmt = Parser(f"SELECT * FROM read_parquet({_lit(s.target)})").parse_statements()[0]
                n_new, cols, _ = self._query_columns(stmt, types, entry.name)
        else:
            opts = s.options
            delim = opts.get("delimiter", opts.get("delim", opts.get("sep")))
            header = opts.get("header")
            if delim is None or header is None:
                sniffed_delim, sniffed_header, _ = csvmod.sniff_csv(s.target)
                delim = sniffed_delim if delim is None else delim
                header = sniffed_header if header is None else header
            loaded = csvmod.load_csv(s.target, list(zip(names, types)), str(delim),
                                     _truthy(header), str(opts.get("quote", '"')))
            cols = [loaded[n] for n in names]
            n_new = len(cols[0][0]) if cols else 0
        self._append_rows(entry, dict(zip(names, cols)), n_new)
        return self._count_result(n_new)

    def _export_database(self, s: N.ExportStatement):
        cat = self.catalog
        os.makedirs(s.path, exist_ok=True)
        prefixes = tuple(a + "." for a in cat.attached)
        tables = {k: e for k, e in cat.tables.items()
                  if not k.startswith("__") and not (prefixes and k.startswith(prefixes))}
        parquet = str(s.fmt).lower() == "parquet"
        loads = []
        for name, entry in tables.items():
            path = os.path.join(s.path, f"{name}.{'parquet' if parquet else 'csv'}")
            names = [cd.name for cd in entry.columns]
            types = [cd.ltype for cd in entry.columns]
            columns = [entry.host_column(n) for n in names]
            if parquet:
                pqmod.write_parquet(path, names, types, columns, entry.nrows)
            else:
                csvmod.write_csv(path, names, types, columns, entry.nrows)
            loads.append(f"COPY {_ident(name)} FROM {_lit(path)} "
                         f"({'FORMAT PARQUET' if parquet else 'HEADER'});")
        with open(os.path.join(s.path, "schema.sql"), "w") as f:
            f.write("\n".join(schema_sql(cat, tables)) + "\n")
        with open(os.path.join(s.path, "load.sql"), "w") as f:
            f.write("\n".join(loads) + "\n")
        return None

    def _import_database(self, s: N.ImportStatement):
        from duckdb_tpu_torch.errors import ConnectionException

        for fname in ("schema.sql", "load.sql"):
            fp = os.path.join(s.path, fname)
            if not os.path.exists(fp):
                raise ConnectionException(f'IMPORT DATABASE: "{fp}" not found')
            with open(fp) as f:
                text = f.read()
            if text.strip():
                self.sql(text)
        return None
