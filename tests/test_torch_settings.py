"""SET, RESET, current_setting() and duckdb_settings() in
duckdb_tpu_torch (main/settings.py), on the CPU, against the JAX package.

The registry is the JAX package's: its 24 own settings and DuckDB's other
163, with the same names, types, scopes, defaults and aliases, but for the
port's two deliberate defaults (num_shards 1, not AUTO; memory_limit '0',
not "80% of HBM"). The settings the port honours take effect: num_shards,
auto_shard_rows and exchange_join_threshold route operators over the mesh
(held through `con.routes`), memory_limit sends a query down the
out-of-core route, temp_directory holds its spill files, join_order picks
the join-order search, pallas_grouped_sum 'off' keeps int64 sums off the
grouped-sum kernel, default_order and default_null_order order ORDER BY
terms that name no direction, and a time zone other than UTC raises. The
rest is accepted and stored. An unknown name raises the JAX package's
message.

The JAX package's faults held to DuckDB: S1, current_setting() gives ''
whatever was SET; S3, default_order and default_null_order change nothing.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

import duckdb_tpu
import duckdb_tpu_torch
from duckdb_tpu.main import settings as JSET
from duckdb_tpu_torch.catalog import catalog as C
from duckdb_tpu_torch.main import settings as TSET
from duckdb_tpu_torch.parallel import shard as TS
from duckdb_tpu_torch.types import BIGINT

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def no_limit():
    yield
    C.set_memory_limit(0)


@pytest.fixture
def con():
    con = duckdb_tpu_torch.connect(device="cpu")
    i = np.arange(100_000, dtype=np.int64)
    for name, cols in {"t": {"i": i, "g": i % 7},
                       "d": {"k": np.arange(7, dtype=np.int64), "w": np.arange(7) * 10}}.items():
        entry = C.TableEntry(name, [C.ColumnDef(c, BIGINT) for c in cols])
        entry.nrows = len(next(iter(cols.values())))
        for c, v in cols.items():
            entry.set_host_column(c, v.astype(np.int64))
        con.catalog.create_table(entry)
    return con


AGG = "SELECT g, sum(i), count(*) FROM t GROUP BY g ORDER BY g"
WANT = [(g, int(np.arange(g, 100_000, 7).sum()), len(range(g, 100_000, 7))) for g in range(7)]
JOIN = "SELECT t.g, count(*), sum(d.w) FROM t JOIN d ON t.g = d.k GROUP BY t.g ORDER BY t.g"


def run(con, sql):
    con.routes.clear()
    return con.sql(sql).rows(), dict(con.routes)


# the port's deliberate defaults (main/settings.py's docstring says why)
DELIBERATE = {"num_shards": (1, 0), "memory_limit": ("0", "80% of HBM")}


def test_registry_matches_the_jax_package():
    """Every setting of the JAX package's registry (its own and DuckDB's),
    in its order, with its names, types, scopes and defaults (but the two
    deliberate ones), and DuckDB's aliases."""
    from duckdb_tpu.main import settings_compat as JC

    assert [s.name for s in TSET.SETTINGS] == [s.name for s in JSET.SETTINGS]
    assert len(TSET.SETTINGS) == 187
    for t, j in zip(TSET.SETTINGS, JSET.SETTINGS):
        assert (t.typ, t.scope) == (j.typ, j.scope), t.name
        if t.name in DELIBERATE:
            assert (t.default, j.default) == DELIBERATE[t.name]
        else:
            assert t.default == j.default and type(t.default) is type(j.default), t.name
    assert TSET.SETTING_ALIASES == JC.SETTING_ALIASES
    # the port runs on one device unless asked; the JAX package's AUTO
    assert TSET.BY_NAME["num_shards"].default == 1 and JSET.BY_NAME["num_shards"].default == 0


def test_num_shards(con):
    assert con.settings.get("num_shards") == 1  # one device unless asked
    rows, routes = run(con, AGG)
    assert rows == WANT and "sharded_agg" not in routes
    assert con.sql("SET num_shards = 8") is None  # as the JAX package and DuckDB (G3)
    assert con.settings.get("num_shards") == 8
    rows, routes = run(con, AGG)
    assert rows == WANT and routes["sharded_agg"] == 1 and routes["sharded_shared_card"] == 1
    con.sql("SET num_shards TO 1")
    assert "sharded_agg" not in run(con, AGG)[1]
    con.sql("SET num_shards = 3")
    rows, routes = run(con, AGG)
    assert rows == WANT and routes["sharded_agg"] == 1
    con.sql("RESET num_shards")
    assert con.settings.get("num_shards") == 1 and "sharded_agg" not in run(con, AGG)[1]


def test_auto_shard_rows(con, monkeypatch):
    monkeypatch.setattr(TS, "visible_devices", lambda home: 4)
    assert "sharded_agg" not in run(con, AGG)[1]  # the default: one device
    con.sql("SET num_shards = 0")  # AUTO
    assert run(con, AGG)[1]["sharded_agg"] == 1  # 131,072 padded rows > 32,768
    con.sql("SET auto_shard_rows = 200000")
    rows, routes = run(con, AGG)
    assert rows == WANT and "sharded_agg" not in routes
    con.sql("RESET auto_shard_rows")
    assert con.settings.get("auto_shard_rows") == 1 << 15
    assert run(con, AGG)[1]["sharded_agg"] == 1


def test_exchange_join_threshold(con, monkeypatch):
    from duckdb_tpu_torch.execution import fused_agg as TFA

    monkeypatch.setattr(TFA, "build_fused_agg", lambda ex, node: None)  # an eager join
    con.sql("SET num_shards = 8")
    single = run(con, JOIN)
    assert "exchange_join" not in single[1] and single[1]["sharded_probe"] == 1
    con.sql("SET exchange_join_threshold = 0")
    rows, routes = run(con, JOIN)
    assert rows == single[0] and routes["exchange_join"] == 1
    con.sql("RESET exchange_join_threshold")
    assert con.settings.get("exchange_join_threshold") == 1 << 24
    assert "exchange_join" not in run(con, JOIN)[1]


def test_memory_limit_sends_a_query_out_of_core(con):
    rows, routes = run(con, AGG)
    assert rows == WANT and "out_of_core" not in routes
    con.sql("SET memory_limit = '1MB'")
    assert C.POOL.limit == 1 << 20
    rows, routes = run(con, AGG)
    assert rows == WANT and routes["out_of_core"] == 1 and routes["out_of_core_chunks"] >= 2
    con.sql("RESET memory_limit")
    assert C.POOL.limit == 0
    assert "out_of_core" not in run(con, AGG)[1]
    con.sql("SET max_memory = '2GiB'")  # DuckDB's other name for it
    assert C.POOL.limit == 2 << 30 and con.settings.get("memory_limit") == "2GiB"


@pytest.mark.parametrize("text", ["1MB", "2GiB", "512KB", "1.5GB", "0", "100", "3 TB"])
def test_parse_bytes_as_the_jax_package(text):
    assert TSET.parse_bytes(text) == JSET.parse_bytes(text)
    assert TSET.parse_bytes(7) == 7


def test_unknown_setting_says_so_as_the_jax_package(con):
    with pytest.raises(ValueError) as err:
        duckdb_tpu.connect().sql("SET no_such_setting = 1")
    with pytest.raises(ValueError, match='unrecognized configuration parameter '
                                         '"no_such_setting"') as mine:
        con.sql("SET no_such_setting = 1")
    assert str(mine.value) == str(err.value)
    with pytest.raises(ValueError, match="unrecognized"):
        con.sql("RESET no_such_setting")


@pytest.mark.parametrize("name,value", [
    ("threads", "4"), ("enable_progress_bar", "true"), ("default_null_order", "'nulls_first'"),
    ("temp_directory", "'/tmp/x'"), ("join_order", "'greedy'"),
    ("pallas_grouped_sum", "'off'"), ("access_mode", "'READ_ONLY'"),
    ("allocator_flush_threshold", "'1MB'"), ("worker_threads", "2"),
    ("preserve_insertion_order", "false"), ("TimeZone", "'UTC'")])
def test_unwired_settings_raise_naming_item_36(con, name, value):
    """The settings item 36 brought: SET stores the value (current_setting()
    reads it back as duckdb_settings() shows it), RESET restores the
    default, through an alias too (worker_threads is threads)."""
    canon = TSET.canonical(name)
    con.sql(f"SET {name} = {value}")
    shown = str(con.settings.get(canon))
    assert con.sql(f"SELECT current_setting('{name}')").rows() == [(shown,)]
    assert con.sql(f"SELECT value FROM duckdb_settings() WHERE name = '{canon}'").rows() \
        == [(shown,)]
    con.sql(f"RESET {name}")
    assert con.settings.get(canon) == TSET.BY_NAME[canon].default


def test_bad_values(con):
    with pytest.raises(ValueError, match="integer"):
        con.sql("SET num_shards = 'many'")
    with pytest.raises(ValueError, match="negative"):
        con.sql("SET auto_shard_rows = '-1'")
    with pytest.raises(ValueError, match="Failed to parse memory limit"):
        con.sql("SET memory_limit = 'lots'")
    assert con.settings.get("num_shards") == 1


@pytest.mark.parametrize("sql", ["SELECT current_setting('num_shards')",
                                 "SELECT * FROM duckdb_settings()"])
def test_reading_settings_waits_for_item_36(con, sql):
    """Item 36 brought both: they read the database's settings."""
    rows = con.sql(sql).rows()
    if "current_setting" in sql:
        assert rows == [("1",)]
    else:
        assert rows == con.settings.rows() and len(rows) == 187


# -- item 36: the whole registry, and what the new settings change ----------------------
def test_duckdb_settings_rows_match_the_jax_package(con):
    """duckdb_settings()' name, value, input_type and scope columns against
    the JAX package's, in its order; values differ only in the deliberate
    defaults."""
    sql = "SELECT name, value, input_type, scope FROM duckdb_settings()"
    mine, theirs = con.sql(sql).rows(), duckdb_tpu.connect().sql(sql).rows()
    assert len(mine) == len(theirs) == 187
    for m, t in zip(mine, theirs):
        if m[0] in DELIBERATE:
            assert (m[1], t[1]) == tuple(str(v) for v in DELIBERATE[m[0]])
            m, t = (m[0],) + m[2:], (t[0],) + t[2:]
        assert m == t
    described = dict(con.sql("SELECT name, description FROM duckdb_settings()").rows())
    assert described["access_mode"].endswith("(accepted for reference compatibility; no "
                                             "engine effect)")
    assert described["threads"].endswith("(accepted and stored; no effect in the port)")


def test_s1_current_setting_reads_what_was_set(con):
    """The JAX package's current_setting() gives '' whatever was SET (S1)."""
    jcon = duckdb_tpu.connect()
    sql = "SELECT current_setting('memory_limit'), current_setting('max_memory')"
    for c in (con, jcon):
        c.sql("SET memory_limit = '1GB'")
    assert con.sql(sql).rows() == [("1GB", "1GB")]
    assert jcon.sql(sql).rows() != [("1GB", "1GB")]
    for c in (con, jcon):
        c.sql("RESET memory_limit")
    assert con.sql(sql).rows() == [("0", "0")]
    assert con.sql("SELECT current_setting('enable_profiling')").rows() == [("False",)]
    con.sql("PRAGMA enable_profiling")
    assert con.sql("SELECT current_setting('enable_profiling')").rows() == [("True",)]
    con.sql("PRAGMA disable_profiling")
    with pytest.raises(ValueError, match='unrecognized configuration parameter "nope"'):
        con.sql("SELECT current_setting('nope')")


NULLS = "(VALUES (2), (NULL), (1), (3)) t(x)"


@pytest.mark.parametrize("setting,value,sql,want", [
    ("default_order", "desc", f"SELECT x FROM {NULLS} ORDER BY x", [3, 2, 1, None]),
    ("default_order", "descending", f"SELECT x FROM {NULLS} ORDER BY x ASC", [1, 2, 3, None]),
    ("default_null_order", "nulls_first", f"SELECT x FROM {NULLS} ORDER BY x",
     [None, 1, 2, 3]),
    ("default_null_order", "nulls_first", f"SELECT x FROM {NULLS} ORDER BY x NULLS LAST",
     [1, 2, 3, None]),
    ("default_null_order", "nulls_first_on_asc_last_on_desc",
     f"SELECT x FROM {NULLS} ORDER BY x", [None, 1, 2, 3]),
    ("default_null_order", "nulls_last_on_asc_first_on_desc",
     f"SELECT x FROM {NULLS} ORDER BY x DESC", [None, 3, 2, 1]),
    ("default_order", "desc",
     f"SELECT x, row_number() OVER (ORDER BY x) FROM {NULLS} WHERE x IS NOT NULL ORDER BY x ASC",
     [(1, 3), (2, 2), (3, 1)]),
])
def test_s3_default_orders_follow_duckdb(con, setting, value, sql, want):
    """An ORDER BY term that names no direction or NULLS placement takes
    default_order / default_null_order, as in DuckDB; the JAX package
    accepts both and changes nothing (S3)."""
    jcon = duckdb_tpu.connect()
    for c in (con, jcon):
        c.sql(f"SET {setting} = '{value}'")
    rows = con.sql(sql).rows()
    assert (rows if isinstance(want[0], tuple) else [r[0] for r in rows]) == want
    if "ASC" not in sql and "NULLS LAST" not in sql:
        jrows = jcon.sql(sql).rows()
        assert (jrows if isinstance(want[0], tuple) else [r[0] for r in jrows]) != want
    con.sql(f"RESET {setting}")
    assert [r[0] for r in con.sql(f"SELECT x FROM {NULLS} ORDER BY x").rows()] \
        == [1, 2, 3, None]


def test_join_order_greedy_and_dp_give_the_same_rows(con, monkeypatch):
    from duckdb_tpu_torch.planner import join_order as TJO

    calls = []
    real = TJO.dp_join_order
    monkeypatch.setattr(TJO, "dp_join_order", lambda *a: calls.append(1) or real(*a))
    con.sql("CREATE TABLE e (k BIGINT, z BIGINT)")
    con.sql("INSERT INTO e SELECT range, range * 3 FROM range(7)")
    sql = ("SELECT t.g, count(*), sum(d.w), sum(e.z) FROM t JOIN d ON t.g = d.k "
           "JOIN e ON d.k = e.k WHERE t.i < 5000 GROUP BY t.g ORDER BY t.g")
    dp = con.sql(sql).rows()
    assert calls and con.settings.get("join_order") == "dp"
    calls.clear()
    con.sql("SET join_order = 'greedy'")
    assert con.sql(sql).rows() == dp and not calls
    con.sql("RESET join_order")
    assert con.sql(sql).rows() == dp and calls
    with pytest.raises(ValueError, match="join_order must be one of"):
        con.sql("SET join_order = 'random'")


def test_pallas_grouped_sum_off_keeps_sums_off_the_kernel(con, monkeypatch):
    """'off' sends the int64 sums of up to 256 slots to index_add_ (the
    route of wider domains), with the same rows; RESET brings the kernel
    back. The value is checked as the JAX package checks it."""
    from duckdb_tpu_torch.ops import grouped as TG

    calls = []
    real = TG.grouped_sum_i64
    monkeypatch.setattr(TG, "grouped_sum_i64", lambda *a: calls.append(1) or real(*a))
    on = con.sql(AGG).rows()
    assert on == WANT and calls
    calls.clear()
    con.sql("SET pallas_grouped_sum = 'off'")
    assert con.sql(AGG).rows() == WANT and not calls
    con.sql("RESET pallas_grouped_sum")
    assert con.sql(AGG).rows() == WANT and calls
    with pytest.raises(ValueError, match="pallas_grouped_sum must be one of"):
        con.sql("SET pallas_grouped_sum = 'sometimes'")
    with pytest.raises(ValueError, match="must be 'auto', 'on', or 'off'"):
        duckdb_tpu.connect().sql("SET pallas_grouped_sum = 'sometimes'")


def test_temp_directory_holds_the_spill_files(con, monkeypatch, tmp_path):
    """Out-of-core spill directories are made under temp_directory (made if
    missing), as the JAX package's are; empty is the system temp."""
    from duckdb_tpu_torch.storage import spill as TSP

    made = []
    monkeypatch.setattr(TSP, "HOST_BYTES", 1 << 10)  # every chunk goes to files
    monkeypatch.setattr(TSP.SpillDir, "delete", lambda self: made.append(self.path))
    where = tmp_path / "spill_here"
    con.sql(f"SET temp_directory = '{where}'")
    con.sql("SET memory_limit = '1MB'")
    con.routes.clear()
    rows = con.sql("SELECT i, g FROM t WHERE g = 3 ORDER BY i").rows()
    assert [r[0] for r in rows] == list(range(3, 100_000, 7))
    assert con.routes["out_of_core"] == 1
    assert made and all(os.path.dirname(p) == str(where) for p in made)
    assert any(os.listdir(p) for p in made)  # the chunks' columns, in files
    con.sql("RESET temp_directory")
    made.clear()
    con.sql("SELECT i, g FROM t WHERE g = 2 ORDER BY i").rows()
    assert made and all(os.path.dirname(p) == tempfile.gettempdir() for p in made)


def test_timezone_is_utc_only(con):
    con.sql("SET timezone = 'UTC'")
    with pytest.raises(ValueError, match="UTC only"):
        con.sql("SET TimeZone = 'America/New_York'")
    assert con.sql("SELECT current_setting('timezone')").rows() == [("UTC",)]
