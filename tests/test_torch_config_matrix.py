"""The rest of the configuration matrix through duckdb_tpu_torch (device="cpu").

tests/test_config_matrix.py runs TPC-H and a corpus slice under fifteen
forced configurations of the JAX package; tests/test_torch_distributed.py
runs four of them (sharded, shard_everything, exchange_join_forced,
spill_sharded) through the port. This file runs the other eleven (chunked,
spill_4mb, spill_2mb, greedy_join, greedy_spill, greedy_sharded, pallas_off,
pallas_off_sharded, threads_1, shard2_tiny, exchange_spill) over the port's
own TPC-H data (testing/tpch_gen.py, SF 0.01, seed 7), with the SET
statements of that file: the seven queries of the sharded matrix, each
equal to the oracle (tpch_oracle.answer, chip_smoke.numpy_q1 for Q1) and to
the default configuration's rows, with the route each configuration forces
(the sharded operators, the out-of-core chunks, the masked reduce in place
of the grouped-sum kernel's wrapper). Then the three vendored
tests/sqllogic/*.test scripts under all fifteen configurations, in place of
the corpus slice, which needs the reference tree.

One loaded connection serves each configuration's queries: its SET
statements run again before each query, since memory_limit is the
process's (catalog.set_memory_limit), and are reset after.
"""

import glob
import os
import sys

import pytest
import torch

import duckdb_tpu_torch
from duckdb_tpu_torch.catalog import catalog as C
from duckdb_tpu_torch.ops import grouped as TG
from duckdb_tpu_torch.testing import tpch_oracle
from duckdb_tpu_torch.testing.sqllogic import SqlLogicRunner
from duckdb_tpu_torch.testing.tpch_gen import write_tables
from tests.test_config_matrix import CONFIGS as ALL_CONFIGS
from tests.test_torch_distributed import CONFIGS as SHARDED_CONFIGS
from tests.test_torch_distributed import MATRIX_QUERIES, SHARDED_OPS, assert_rows_match

torch.set_num_threads(1)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import chip_smoke  # noqa: E402  (Q1's text and its numpy answer)

Q = {**tpch_oracle.QUERIES, **tpch_oracle.LIKE_QUERIES, **tpch_oracle.GENERAL_QUERIES,
     "q01": chip_smoke.Q1}
CONFIGS = {k: v for k, v in ALL_CONFIGS.items() if k not in SHARDED_CONFIGS}
SCRIPTS = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "sqllogic", "*.test")))
# the queries whose scans pass each memory limit at SF 0.01, so that they
# run in chunks (the others fit, and run whole; 64MB holds them all)
OUT_OF_CORE = {"spill_2mb": set(MATRIX_QUERIES), "spill_4mb": {"q01"}}


def test_the_matrix_is_the_jax_packages():
    """The eleven configurations here, and chip_smoke.py's copy of all
    fifteen (phase 25 runs them on the card), are the JAX package's."""
    assert len(ALL_CONFIGS) == 15 and len(CONFIGS) == 11
    assert chip_smoke.MATRIX_CONFIGS == ALL_CONFIGS
    assert list(chip_smoke.MATRIX_QUERIES) == MATRIX_QUERIES
    assert set(CONFIGS) == {"chunked", "spill_4mb", "spill_2mb", "greedy_join", "greedy_spill",
                            "greedy_sharded", "pallas_off", "pallas_off_sharded", "threads_1",
                            "shard2_tiny", "exchange_spill"}


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("tpch_gen_matrix")
    write_tables(str(root), 0.01, seed=7)
    return str(root)


@pytest.fixture(scope="module")
def cons(data_dir):
    """One loaded connection per configuration, made at first use."""
    made = {}

    def get(config):
        if config not in made:
            con = duckdb_tpu_torch.connect(device="cpu")
            con.load_tpch(data_dir)
            made[config] = con
        return made[config]

    return get


@pytest.fixture(scope="module")
def default_rows(cons):
    rows = {}

    def get(name):
        if name not in rows:
            rows[name] = cons("default").sql(Q[name]).rows()
        return rows[name]

    return get


@pytest.fixture(autouse=True)
def no_limit():
    yield
    C.set_memory_limit(0)


@pytest.fixture
def kernel_calls(monkeypatch):
    """Calls of the grouped-sum kernel's wrapper (its plain version on the
    CPU), which `SET pallas_grouped_sum = 'off'` bypasses."""
    calls = []
    real = TG.grouped_sum_i64

    def counting(dense, vectors, nseg):
        calls.append(nseg)
        return real(dense, vectors, nseg)

    monkeypatch.setattr(TG, "grouped_sum_i64", counting)
    return calls


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("name", MATRIX_QUERIES)
def test_config_matrix(cons, default_rows, kernel_calls, data_dir, config, name):
    want = chip_smoke.numpy_q1(data_dir) if name == "q01" else tpch_oracle.answer(name, data_dir)
    con = cons(config)
    for s in CONFIGS[config]:
        con.sql(s)
    con.routes.clear()
    try:
        got = con.sql(Q[name]).rows()
    finally:
        for s in ("memory_limit", "num_shards", "auto_shard_rows", "exchange_join_threshold",
                  "pallas_grouped_sum", "threads", "join_order"):
            con.sql(f"RESET {s}")
    assert_rows_match(got, want)
    assert got == default_rows(name)
    routes = dict(con.routes)
    if any("num_shards" in s for s in CONFIGS[config]):
        assert SHARDED_OPS & set(routes), routes
    if name in OUT_OF_CORE.get(config, ()):
        assert any(r.startswith("out_of_core") for r in routes), routes
    if config.startswith("pallas_off"):
        assert not kernel_calls, kernel_calls
    elif name == "q01" and config in ("chunked", "greedy_join", "threads_1"):
        assert kernel_calls  # Q1's sums go through the kernel's wrapper


def _connect(sets):
    def connect(path=":memory:"):
        con = duckdb_tpu_torch.connect(path, device="cpu")
        for s in sets:
            con.sql(s)
        return con

    return connect


@pytest.mark.parametrize("config", sorted(ALL_CONFIGS))
@pytest.mark.parametrize("path", SCRIPTS, ids=[os.path.basename(p) for p in SCRIPTS])
def test_sqllogic_under_config(config, path):
    res = SqlLogicRunner(_connect(ALL_CONFIGS[config])).run_file(path)
    assert res.ok, f"[{config}] " + "\n".join(res.errors)
    assert res.passed >= 3
