"""SET and RESET in duckdb_tpu_torch (main/settings.py), on the CPU.

The four settings the port honours take effect: num_shards,
auto_shard_rows and exchange_join_threshold route operators over the mesh
(held through `con.routes`), memory_limit sets the device buffer pool's
limit, so that `SET memory_limit = '1MB'` sends a query down the
out-of-core route with the rows of the in-memory run. An unknown name
raises the JAX package's message; every other name of its registry, its
own and DuckDB's, raises "not yet ported", naming ROADMAP item 36, instead
of being ignored. num_shards defaults to 1 (the JAX package's default is
0, AUTO).
"""

import numpy as np
import pytest
import torch

import duckdb_tpu
import duckdb_tpu_torch
from duckdb_tpu.main import settings as JSET
from duckdb_tpu_torch.catalog import catalog as C
from duckdb_tpu_torch.main import settings as TSET
from duckdb_tpu_torch.parallel import shard as TS
from duckdb_tpu_torch.planner.bound import BindError
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


def test_registry_matches_the_jax_package():
    """Every setting of the JAX package's registry (its own and DuckDB's),
    either wired or refused as not yet ported, and DuckDB's aliases; the
    wired ones keep the JAX package's defaults but for num_shards."""
    from duckdb_tpu.main import settings_compat as JC

    wired = {s.name for s in TSET.SETTINGS}
    assert wired == {"num_shards", "auto_shard_rows", "exchange_join_threshold", "memory_limit"}
    assert not wired & TSET.NOT_PORTED
    assert wired | TSET.NOT_PORTED == {s.name for s in JSET.SETTINGS}
    assert len(TSET.NOT_PORTED) > 180
    assert TSET.SETTING_ALIASES == JC.SETTING_ALIASES
    for name in ("auto_shard_rows", "exchange_join_threshold"):
        assert TSET.BY_NAME[name].default == JSET.BY_NAME[name].default
    # the port runs on one device unless asked; the JAX package's AUTO
    assert TSET.BY_NAME["num_shards"].default == 1 and JSET.BY_NAME["num_shards"].default == 0


def test_num_shards(con):
    assert con.settings.get("num_shards") == 1  # one device unless asked
    rows, routes = run(con, AGG)
    assert rows == WANT and "sharded_agg" not in routes
    assert con.sql("SET num_shards = 8").rows() == []
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
    """A SET that changed nothing would seem to have worked."""
    with pytest.raises(BindError, match="not yet ported.*") as err:
        con.sql(f"SET {name} = {value}")
    assert "item 36" in str(err.value)
    with pytest.raises(BindError, match="item 36"):
        con.sql(f"RESET {name}")


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
    with pytest.raises(BindError, match="36"):
        con.sql(sql).rows()
