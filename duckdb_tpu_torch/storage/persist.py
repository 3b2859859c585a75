"""File databases: the directory format, CHECKPOINT, the write-ahead log and
recovery.

The JAX package's format (duckdb_tpu/storage/persist.py), so that a
directory written by either package opens in the other:

  <db>/catalog.json          the header: tables (columns, types, rows,
                             constraints, defaults), views and macros as
                             their CREATE text, schemas, sequences with
                             their counters, user types, `data_gen` (the
                             live data generation) and `wal_seq` (the last
                             WAL unit the data holds)
  <db>/data.g<N>/<table>/    generation N's columns: meta.json ({"rows",
                             "columns": [{"name", "kind", "enc"}]}) and per
                             column <col>.z (storage/compression.py: the
                             scheme in "enc"), <col>.validz (bitpacked
                             validity), or <col>.i32 + <col>.dict.json for
                             a nested column's codes and dictionary
                             ("listdict"); `data/` is generation 0
  <db>/wal.sql               the write-ahead log since the checkpoint

CHECKPOINT writes a new generation beside the live one, then swaps the
header (`os.replace` of catalog.json), then removes the WAL and the old
generation: a crash before the swap leaves the old header, its data and
the WAL whole. The data files, their directories and the new header are
fsynced before the swap, and the database directory after it.

The WAL is DuckDB's contract (write_ahead_log.cpp, wal_replay.cpp), its
records logical SQL: each statement a committed transaction ran, as its
own text, then a line `--WAL_ENTRY {meta}` that pins its entropy ("t": the
statement's time for now() and current_date, "seed": the seed random(),
the uuids and samples draw from on the host, "seqs": the counters of the
sequences it advanced, as they were before it) and names its unit ("q",
"w": 1). After a transaction's statements comes its commit record,
`--WAL_COMMIT {"q": n, "n": statements[, "seq": counters after]}`: the
unit is written and fsynced before COMMIT returns, under the database's
commit lock. Replay applies whole units in order, skips those the
checkpoint holds (q <= wal_seq), and stops at the first unit that has no
commit record or is torn (a crash while it was written: that commit never
returned); a writable open then cuts the WAL back to the end of the last
complete unit, so that the next commit is appended after a whole one. A
WAL the JAX package wrote has no commit records: each of its
`--WAL_ENTRY` statements is a unit of its own, and a torn tail is dropped
too. The JAX package replays a torn tail and each entry of a transaction
on its own, and fsyncs nothing (ROADMAP Queue 3, F7-F11).
"""

from __future__ import annotations

import base64
import datetime
import decimal as pydec
import glob as _glob
import json
import os
import shutil
from functools import partial

import numpy as np

from duckdb_tpu_torch.blocks.nested import UNSORTED_DICT_IDS, obj_array
from duckdb_tpu_torch.catalog.catalog import ColumnDef, TableEntry
from duckdb_tpu_torch.errors import OutOfRangeException
from duckdb_tpu_torch.sql import nodes as N
from duckdb_tpu_torch.sql.lexer import tokenize
from duckdb_tpu_torch.sql.parser import Parser
from duckdb_tpu_torch.storage import binary_dir
from duckdb_tpu_torch.storage import compression as C
from duckdb_tpu_torch.types import LogicalType, TypeId, decimal as make_decimal

WAL_NAME = "wal.sql"
ENTRY = "--WAL_ENTRY"
COMMIT = "--WAL_COMMIT"
# the points debug_checkpoint_abort stops a checkpoint at
ABORT_POINTS = ("before_data", "before_header", "before_truncate")


class FaultInjected(RuntimeError):
    """A checkpoint stopped by debug_checkpoint_abort (DuckDB's
    crash-consistency testing hooks)."""


def _abort_point(abort_mode: str, point: str):
    if abort_mode == point:
        raise FaultInjected(f"checkpoint aborted at {point} (debug_checkpoint_abort)")


# -- durable file operations -------------------------------------------------------
def fsync_dir(path: str):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_file(path: str, data: bytes):
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


# -- types and nested values ---------------------------------------------------------
def _type_to_json(t: LogicalType):
    if t.id is TypeId.DECIMAL:
        return {"id": "decimal", "width": t.width, "scale": t.scale}
    if t.id is TypeId.LIST:
        return {"id": "list", "child": _type_to_json(t.child)}
    if t.id is TypeId.ARRAY:
        return {"id": "array", "child": _type_to_json(t.child), "width": t.width}
    if t.id in (TypeId.STRUCT, TypeId.UNION, TypeId.MAP):
        out = {"id": t.id.value,
               "fields": [[n, _type_to_json(ft)] for n, ft in (t.fields or ())]}
        if t.child is not None:
            out["child"] = _type_to_json(t.child)
        return out
    return {"id": t.id.value}


def _type_from_json(d) -> LogicalType:
    if d["id"] == "decimal":
        return make_decimal(d["width"], d["scale"])
    child = _type_from_json(d["child"]) if "child" in d else None
    fields = (tuple((n, _type_from_json(ft)) for n, ft in d["fields"])
              if "fields" in d else None)
    return LogicalType(TypeId(d["id"]), width=d.get("width", 0), child=child, fields=fields)


def _nested_default(o):
    """Tagged JSON for the values inside a nested dictionary: the JAX
    package's "$dec" and "$date", and "$ts", "$time", "$td" and "$bytes"."""
    if isinstance(o, pydec.Decimal):
        return {"$dec": str(o)}
    if isinstance(o, datetime.datetime):
        return {"$ts": o.isoformat()}
    if isinstance(o, datetime.date):
        return {"$date": o.isoformat()}
    if isinstance(o, datetime.time):
        return {"$time": o.isoformat()}
    if isinstance(o, datetime.timedelta):
        return {"$td": [o.days, o.seconds, o.microseconds]}
    if isinstance(o, bytes):
        return {"$bytes": base64.b64encode(o).decode("ascii")}
    if isinstance(o, (np.integer, np.floating, np.bool_)):
        return o.item()
    raise TypeError(f"not JSON serializable: {type(o)}")


def _nested_decode(v):
    if isinstance(v, dict):
        if "$dec" in v:
            return pydec.Decimal(v["$dec"])
        if "$date" in v:
            return datetime.date.fromisoformat(v["$date"])
        if "$ts" in v:
            return datetime.datetime.fromisoformat(v["$ts"])
        if "$time" in v:
            return datetime.time.fromisoformat(v["$time"])
        if "$td" in v:
            return datetime.timedelta(*v["$td"])
        if "$bytes" in v:
            return base64.b64decode(v["$bytes"])
        return {k: _nested_decode(x) for k, x in v.items()}
    if isinstance(v, list):
        return tuple(_nested_decode(x) for x in v)
    return v


# -- writing a generation --------------------------------------------------------------
def _data_gen_dir(path: str, gen: int) -> str:
    """Generation `gen`'s data directory (0: the unversioned `data/`)."""
    return os.path.join(path, "data" if gen == 0 else f"data.g{gen}")


def _current_gen(path: str) -> int:
    try:
        with open(os.path.join(path, "catalog.json")) as f:
            return int(json.load(f).get("data_gen", 0))
    except (OSError, ValueError):
        return 0


def _cleanup_stale_generations(path: str, keep_gen: int):
    """Remove every data generation but the live one (what an aborted
    checkpoint staged, or the one a header swap superseded)."""
    keep = os.path.abspath(_data_gen_dir(path, keep_gen))
    candidates = _glob.glob(os.path.join(path, "data.g*"))
    if keep_gen != 0:
        candidates.append(os.path.join(path, "data"))
    for d in candidates:
        if os.path.abspath(d) != keep and os.path.isdir(d):
            shutil.rmtree(d, ignore_errors=True)


def _write_column(tdir: str, cd: ColumnDef, entry: TableEntry) -> dict:
    """One column's files → its meta.json entry."""
    vals, valid, dvals = entry.host_column(cd.name)
    base = os.path.join(tdir, cd.name)
    out = {"name": cd.name}
    if cd.ltype.id in UNSORTED_DICT_IDS or cd.ltype.id is TypeId.BLOB:
        _write_file(base + ".i32", np.asarray(vals).astype("<i4").tobytes())
        entries = [list(t) if isinstance(t, tuple) else t
                   for t in (dvals if dvals is not None else [])]
        _write_file(base + ".dict.json",
                    json.dumps(entries, default=_nested_default).encode())
        out["kind"] = "listdict"
    else:
        if cd.ltype.id is TypeId.VARCHAR:
            m, payload = C.compress_strings(np.asarray(vals), dvals)
        elif np.asarray(vals).dtype.kind == "f":
            m, payload = C.compress_floats(np.asarray(vals))
        else:
            try:
                ints = np.asarray(vals).astype(np.int64)
            except OverflowError:
                raise OutOfRangeException(
                    f"Out of Range Error: column {cd.name} holds values wider than 64 bits, "
                    "which the file format has no room for") from None
            m, payload = C.compress_ints(ints)
            m["dtype"] = str(np.dtype(cd.ltype.np_dtype))
        _write_file(base + ".z", payload)
        out.update(kind="z", enc=m)
    if valid is not None:
        _write_file(base + ".validz", C.compress_validity(np.asarray(valid)))
    return out


def _write_db(path: str, tables: dict, views: dict, schemas, sequences, macros,
              user_types=None, wal_seq: int = 0, abort_mode: str = "none"):
    """Stage a new generation, swap the header to it, drop the WAL and the
    old generation (see the module docstring for the order and fsyncs)."""
    _abort_point(abort_mode, "before_data")
    gen = _current_gen(path) + 1
    data_root = _data_gen_dir(path, gen)
    if os.path.isdir(data_root):  # what an aborted checkpoint left
        shutil.rmtree(data_root)
    os.makedirs(data_root)
    meta = {"tables": [], "views": {}, "schemas": list(schemas), "data_gen": gen}
    for name, entry in tables.items():
        if name.startswith("__"):
            continue  # a plan's hidden tables
        tdir = os.path.join(data_root, name)
        os.makedirs(tdir, exist_ok=True)
        cols = [_write_column(tdir, cd, entry) for cd in entry.columns]
        _write_file(os.path.join(tdir, "meta.json"),
                    json.dumps({"rows": entry.nrows, "columns": cols}).encode())
        fsync_dir(tdir)
        meta["tables"].append({
            "name": name,
            "columns": [{"name": cd.name, "type": _type_to_json(cd.ltype)}
                        for cd in entry.columns],
            "rows": entry.nrows,
            "constraints": [list(c) for c in entry.constraints],
            "defaults": dict(entry.defaults),
        })
    fsync_dir(data_root)
    fsync_dir(path)
    meta["views"] = {k: v for k, v in views.items() if v}
    meta["sequences"] = sequences
    meta["macros"] = list(macros)
    meta["user_types"] = user_types or {}
    meta["wal_seq"] = wal_seq
    tmp = os.path.join(path, "catalog.json.tmp")
    _write_file(tmp, json.dumps(meta, indent=1).encode())
    _abort_point(abort_mode, "before_header")
    os.replace(tmp, os.path.join(path, "catalog.json"))
    fsync_dir(path)
    _abort_point(abort_mode, "before_truncate")
    wal = os.path.join(path, WAL_NAME)
    if os.path.exists(wal):
        os.remove(wal)
    # every column of the old generation was read into the host tier by
    # host_column() above, so no lazy loader points there any more
    _cleanup_stale_generations(path, gen)
    fsync_dir(path)


def _view_texts(views: dict) -> dict:
    return {k: getattr(v, "_create_text", None) for k, v in views.items()}


def checkpoint(db, abort_mode: str = "none"):
    """Write the database's published catalog to its directory, holding the
    commit lock throughout, so that no commit lands between the snapshot
    and the WAL's removal; then each writable attached file database to its
    own directory (DuckDB checkpoints each attached database)."""
    with db.lock:
        cat = db.catalog
        attached = dict(cat.attached)
        prefixes = tuple(a + "." for a in attached)

        def own(k):
            return not (prefixes and k.startswith(prefixes))

        _write_db(db.path,
                  {k: e for k, e in cat.tables.items() if own(k)},
                  _view_texts({k: v for k, v in cat.views.items() if own(k)}),
                  schemas=sorted(cat.schemas - {"main"} - set(attached)),
                  sequences={k: dict(v) for k, v in cat.sequences.items()},
                  macros=[m.sql_text for m in list(cat.macros.values())
                          + list(cat.table_macros.values()) if m.sql_text],
                  user_types={k: dict(v) for k, v in cat.user_types.items()},
                  wal_seq=db.wal_seq, abort_mode=abort_mode)
        db.dirty = db.unlogged = False
        for alias, info in attached.items():
            if not info.get("read_only") and info["path"] != ":memory:":
                checkpoint_attached(cat, alias, info["path"])


def checkpoint_attached(cat, alias: str, path: str):
    """Write one attached database's tables and views (the alias taken off
    their names); its schemas, sequences, macros and types are carried over
    from its header, as the JAX package does."""
    pre = alias + "."
    tables = {k[len(pre):]: e for k, e in cat.tables.items() if k.startswith(pre)}
    views = _view_texts({k[len(pre):]: v for k, v in cat.views.items() if k.startswith(pre)})
    old = {}
    cp = os.path.join(path, "catalog.json")
    if os.path.exists(cp):
        with open(cp) as f:
            old = json.load(f)
    _write_db(path, tables, views, schemas=old.get("schemas", []),
              sequences=old.get("sequences", {}), macros=old.get("macros", []),
              user_types=old.get("user_types", {}))


# -- the WAL --------------------------------------------------------------------------
def statement_texts(query: str, n: int):
    """The source text of each of the `n` statements of `query`, split at
    its top-level semicolons; None where that does not give `n`."""
    pieces, start, seen = [], 0, False
    for t in tokenize(query):
        if t.type == "EOF" or (t.type == "OP" and t.value == ";"):
            if seen:
                pieces.append(query[start:t.pos].strip())
            start, seen = t.pos + 1, False
        else:
            seen = True
    return pieces if len(pieces) == n else None


def _entry_text(sql: str, meta: dict) -> str:
    return sql.rstrip().rstrip(";") + f";\n{ENTRY} {json.dumps(meta)}\n"


def wal_append_unit(path: str, seq: int, entries, seq_after=None):
    """Append one committed transaction: its statements [(sql, meta)], then
    its commit record; fsynced (and the directory too when the WAL is new)
    before this returns."""
    wal = os.path.join(path, WAL_NAME)
    new = not os.path.exists(wal)
    parts = [_entry_text(sql, dict(meta, q=seq, w=1)) for sql, meta in entries]
    record = {"q": seq, "n": len(entries)}
    if seq_after:
        record["seq"] = seq_after
    parts.append(f"{COMMIT} {json.dumps(record)}\n")
    with open(wal, "a") as f:
        f.write("".join(parts))
        f.flush()
        os.fsync(f.fileno())
    if new:
        fsync_dir(path)


def wal_size(path: str) -> int:
    try:
        return os.path.getsize(os.path.join(path, WAL_NAME))
    except OSError:
        return 0


def read_wal(path: str):
    """The complete units of a WAL → ([(q or None, [(sql, meta)], seq_after)]
    in order, the byte offset just past the last of them). Parsing stops at
    a torn line (no newline at the end of the file, or a record that is not
    JSON); statements after the last commit record of the WAL's own units
    are dropped, and so is a statement with no `--WAL_ENTRY` line."""
    wal = os.path.join(path, WAL_NAME)
    if not os.path.exists(wal):
        return [], 0
    with open(wal, "rb") as f:
        data = f.read()
    units, pending, buf = [], [], []
    pos = end = 0
    while True:
        nl = data.find(b"\n", pos)
        if nl < 0:
            break  # after the last newline: nothing, or a line cut short
        line = data[pos:nl].decode("utf-8", errors="replace")
        pos = nl + 1
        head = ENTRY if line.startswith(ENTRY) else COMMIT if line.startswith(COMMIT) else None
        if head is None:
            buf.append(line)
            continue
        try:
            meta = json.loads(line[len(head):].strip() or "{}")
        except ValueError:
            break  # torn
        if head == ENTRY:
            stmt = "\n".join(buf).strip()
            buf = []
            if meta.get("w"):
                pending.append((stmt, meta))
            else:  # the JAX package's entry: a unit of its own
                if stmt:
                    units.append((meta.get("q"), [(stmt, meta)], None))
                end = pos
            continue
        if meta.get("n") != len(pending) or any(m.get("q") != meta.get("q")
                                                for _, m in pending):
            break  # a commit record that does not close what precedes it
        units.append((meta.get("q"), pending, meta.get("seq")))
        pending, buf, end = [], [], pos
    return units, end


def truncate_wal(path: str, end: int):
    """Cut the WAL back to `end`, the end of its last complete unit, and
    fsync it: the bytes of a commit that never returned go, so that the
    next unit is appended after a whole one (DuckDB truncates the WAL at
    the last valid commit on replay)."""
    with open(os.path.join(path, WAL_NAME), "r+b") as f:
        f.truncate(end)
        f.flush()
        os.fsync(f.fileno())


# -- opening ------------------------------------------------------------------------------
def _load_column(tdir, cname, kind, ltype, enc, nrows):
    """A lazily loaded column → (values, validity, dictionary)."""
    validity = None
    vpz = os.path.join(tdir, cname + ".validz")
    if os.path.exists(vpz):
        with open(vpz, "rb") as f:
            validity = C.decompress_validity(f.read(), nrows)
    elif os.path.exists(os.path.join(tdir, cname + ".valid")):
        validity = np.fromfile(os.path.join(tdir, cname + ".valid"), dtype=np.uint8).astype(bool)
    base = os.path.join(tdir, cname)
    if kind == "z":
        out = C.read_column(base, enc)
        if enc["s"] == "dict":
            codes, dvals = out
            if len(dvals) > 1 and not all(a < b for a, b in zip(dvals[:-1], dvals[1:])):
                # the port's VARCHAR dictionaries are sorted and unique
                uniq, inv = np.unique(dvals.astype(str), return_inverse=True)
                codes = inv.reshape(-1)[codes].astype(np.int32)
                dvals = uniq.astype(object)
            return codes, validity, dvals
        return out.astype(ltype.np_dtype if enc["s"] == "f64z"
                          else np.dtype(enc.get("dtype", "int64"))), validity, None
    if kind == "listdict":
        codes = np.fromfile(base + ".i32", dtype="<i4").astype(np.int32)
        with open(base + ".dict.json") as f:
            entries = [_nested_decode(x) for x in json.load(f)]
        return codes, validity, obj_array(entries)
    # the JAX package's raw kinds (generation 0 of older directories)
    if kind == "str":
        codes, uniq = binary_dir.dict_encode(binary_dir.read_string_column(tdir, cname))
        return codes, validity, uniq
    if kind == "f64":
        v = np.fromfile(base + ".f64", dtype=np.float64)
    else:
        v = binary_dir.read_numeric_column(tdir, cname, kind)
    return v.astype(ltype.np_dtype), validity, None


def _view_of(text: str, name: str):
    """The SELECT of the CREATE VIEW `name` in `text` (the first CREATE
    VIEW where none is named so)."""
    views = [s for s in Parser(text).parse_statements() if isinstance(s, N.CreateView)]
    pick = next((s for s in views if s.name.lower() == name), views[0] if views else None)
    return None if pick is None else pick.query


def load_database(con, path: str, read_only: bool = False):
    """Open (or create) the directory of `con`'s database: the header and
    its generation's columns (lazily), then the WAL's complete units; what
    follows the last of them is cut off the WAL unless `read_only`."""
    db = con._db
    cat = db.catalog
    os.makedirs(path, exist_ok=True)
    ckpt_seq = 0
    cat_path = os.path.join(path, "catalog.json")
    if os.path.exists(cat_path):
        with open(cat_path) as f:
            meta = json.load(f)
        ckpt_seq = int(meta.get("wal_seq", 0))
        gen = int(meta.get("data_gen", 0))
        _cleanup_stale_generations(path, gen)
        data_root = _data_gen_dir(path, gen)
        cat.schemas |= set(meta.get("schemas", []))
        if meta.get("user_types"):
            cat.user_types = {k: dict(v) for k, v in meta["user_types"].items()}
        for t in meta["tables"]:
            tdir = os.path.join(data_root, t["name"])
            cols = [ColumnDef(c["name"], _type_from_json(c["type"])) for c in t["columns"]]
            entry = TableEntry(t["name"], cols)
            entry.nrows = t["rows"]
            entry.constraints = [tuple(c) for c in t.get("constraints", [])]
            entry.defaults = dict(t.get("defaults", {}))
            with open(os.path.join(tdir, "meta.json")) as f:
                tmeta = {c["name"]: c for c in json.load(f)["columns"]}
            for cd in cols:
                c = tmeta[cd.name]
                entry.set_lazy_column(cd.name, partial(_load_column, tdir, cd.name, c["kind"],
                                                       cd.ltype, c.get("enc"), entry.nrows))
            cat.create_table(entry, or_replace=True)
        for vname, vsql in meta.get("views", {}).items():
            q = _view_of(vsql, vname)
            if q is not None:
                q._create_text = vsql
                cat.views[vname] = q
        cat.sequences = {k: dict(v) for k, v in meta.get("sequences", {}).items()}
        for msql in meta.get("macros", []):
            # the CREATE MACRO statements of the text (the JAX package keeps
            # the whole text the macro was created in)
            stmts = Parser(msql).parse_statements()
            texts = statement_texts(msql, len(stmts)) or [msql] * len(stmts)
            for s, text in zip(stmts, texts):
                if isinstance(s, N.CreateMacro):
                    s.or_replace = True
                    s._create_text = text
                    con._create_macro(s)
    db.wal_seq = ckpt_seq
    units, end = read_wal(path)
    for seq, entries, seq_after in units:
        if seq is not None and int(seq) <= ckpt_seq:
            continue  # the checkpoint holds it (a crash before the WAL went)
        for sql, meta in entries:
            con._replay(sql, meta)
        if seq_after:
            set_sequences(cat, seq_after)
        if seq is not None:
            db.wal_seq = max(db.wal_seq, int(seq))
    if not read_only and wal_size(path) > end:
        truncate_wal(path, end)


def set_sequences(cat, states: dict):
    """Put sequence counters back to logged states (in place: the counter
    dicts are shared by the catalog's snapshots)."""
    for name, state in states.items():
        counter = cat.sequences.get(name)
        if counter is not None:
            counter.clear()
            counter.update(state)
