"""Python side of the port's C API (capi.cpp calls these through CPython).

A copy of the JAX package's bridge (duckdb_tpu/capi/bridge.py) over
duckdb_tpu_torch. Results are flattened to primitives the C layer can
store without touching Python again: per column a DUCKDB_TYPE id, a
storage class ('i'|'f'|'s'), and cell values rendered exactly like the
port's own row output (Decimal/date/time as text, as DuckDB formats them).
A connection opens on CUDA unless the config names a `device`
(duckdb_set_config(config, "device", "cpu")); the other config entries are
SET on it. duckdb_disconnect closes it.
"""

from __future__ import annotations

import datetime
import decimal

import duckdb_tpu_torch

# LogicalType name → duckdb_type enum (capi/duckdb_tpu_torch.h; values
# match DuckDB's DUCKDB_TYPE_* in src/include/duckdb.h)
_TYPE_IDS = {
    "BOOLEAN": 1, "TINYINT": 2, "SMALLINT": 3, "INTEGER": 4, "BIGINT": 5,
    "FLOAT": 10, "DOUBLE": 11, "TIMESTAMP": 12, "DATE": 13, "TIME": 14,
    "INTERVAL": 15, "HUGEINT": 16, "VARCHAR": 17, "BLOB": 18,
    "DECIMAL": 19, "LIST": 24, "STRUCT": 25, "MAP": 26,
}
_INT_IDS = {1, 2, 3, 4, 5}
_FLOAT_IDS = {10, 11}


def connect(path: str, pairs=()):
    """A connection to `path` (":memory:" when empty) on the config's
    `device` (default CUDA), with the other config entries SET on it."""
    pairs = list(pairs)
    device = next((v for k, v in pairs if k.lower() == "device"), None)
    con = duckdb_tpu_torch.connect(path if path else ":memory:", device=device)
    try:
        apply_settings(con, [(k, v) for k, v in pairs if k.lower() != "device"])
    except BaseException:
        con.close()
        raise
    return con


def disconnect(con):
    con.close()


def _flatten(res):
    if res is None:
        return ([], [], [], [], [])
    names = list(res.names)
    tids = [_TYPE_IDS.get(t.id.name, 17) for t in res.types]
    classes = ["i" if t in _INT_IDS else "f" if t in _FLOAT_IDS else "s"
               for t in tids]
    cols = [[] for _ in names]
    for row in res.rows():
        for i, v in enumerate(row):
            if v is None:
                cols[i].append((True, 0 if classes[i] == "i"
                                else 0.0 if classes[i] == "f" else ""))
            elif classes[i] == "i":
                cols[i].append((False, int(v)))
            elif classes[i] == "f":
                cols[i].append((False, float(v)))
            else:
                cols[i].append((False, _render(v)))
    decs = [(t.width, t.scale) if t.id.name == "DECIMAL" else (0, 0) for t in res.types]
    return (names, tids, classes, cols, decs)


def query(con, sql: str):
    """→ (names, type_ids, classes, columns, (width, scale) per column);
    columns[i] = [(is_null, value)] with value already int/float/str per
    the storage class; a DECIMAL column's width and scale are its type's."""
    return _flatten(con.sql(sql))


def _render(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (decimal.Decimal, datetime.date, datetime.time,
                      datetime.datetime)):
        return str(v)
    if isinstance(v, bytes):
        return v.decode("utf-8", "replace")
    return str(v)


def prepare(con, sql: str):
    return con.prepare(sql)


def nparams(stmt) -> int:
    return stmt.nparams


def check_config(pairs):
    """duckdb_open_ext's check of its config entries, as DuckDB resolves
    them at open: an unknown option, a value the option does not take, or
    a device torch cannot name raises (and the open fails with its text)."""
    import torch

    from duckdb_tpu_torch.main.settings import SettingsManager

    mgr = SettingsManager()
    for name, value in pairs:
        if name.lower() == "device":
            try:
                torch.device(value)
            except RuntimeError as err:
                raise ValueError(f"Invalid Input Error: the device {value!r}: {err}") from None
            continue
        v = value.strip()
        mgr.set(name, int(v) if v.lstrip("+-").isdigit() else v)


def apply_settings(con, pairs):
    """duckdb_open_ext config entries -> SET statements on the fresh
    connection (DuckDB resolves config options at open,
    src/main/config.cpp)."""
    for name, value in pairs:
        v = value.strip()
        if (v.lstrip("+-").replace(".", "", 1).isdigit()
                or v.lower() in ("true", "false")):
            lit = v
        else:
            lit = "'" + v.replace("'", "''") + "'"
        con.sql(f"SET {name} = {lit}")


# typed C values -> the port's Python representations (capi.cpp converts
# raw C structs to these through the helpers below; DuckDB converts
# through Value::DATE etc., src/main/capi/prepared-c.cpp)
def make_date(days: int):
    return datetime.date(1970, 1, 1) + datetime.timedelta(days=days)


def make_time(micros: int):
    return (datetime.datetime(1970, 1, 1)
            + datetime.timedelta(microseconds=micros)).time()


def make_timestamp(micros: int):
    return (datetime.datetime(1970, 1, 1)
            + datetime.timedelta(microseconds=micros))


def make_interval(months: int, days: int, micros: int):
    # substitutes verbatim as an INTERVAL literal
    from duckdb_tpu_torch.api.relation import RawSQL

    parts = []
    if months:
        parts.append(f"{months} months")
    if days:
        parts.append(f"{days} days")
    if micros or not parts:
        parts.append(f"{micros} microseconds")
    return RawSQL("INTERVAL '" + " ".join(parts) + "'")


def make_blob(data: bytes):
    return data


def appender_ncols(app) -> int:
    return app._ncols


def run_prepared(stmt, params):
    return _flatten(stmt.execute(*params))


def appender_create(con, table: str):
    return con.appender(table)


def append_row(app, values):
    app.append_row(*values)


def appender_flush(app):
    app.flush()
