"""TPC-H Q6 and Q22 end to end through duckdb_tpu_torch (device="cpu"),
against duckdb_tpu and the numpy oracle, over the port's generator's tables
at SF 0.01, seed 7 (the specification's texts and parameters).

Q6 fuses into one slot and sums through the grouped-sum kernel's wrapper.
Q22 groups by `substring(c_phone FROM 1 FOR 2)`, a computed VARCHAR key, so
its aggregate takes the general path, grouped perfectly over the 25 codes
of the dictionary substring made; its count and wide sum run through the
kernel's wrapper over the 128 output slots. Its substring takes the host
loop here (c_phone has 1,500 values, under DEVICE_STR_MIN_DICT) and the
device plane op with the threshold patched low in both packages, as at SF1
where c_phone has 150,000 values.
"""

import pytest
import torch

import duckdb_tpu
import duckdb_tpu_torch
from duckdb_tpu.ops import strings as JS
from duckdb_tpu_torch.ops import grouped as grouped_mod
from duckdb_tpu_torch.ops import strings as TS
from duckdb_tpu_torch.testing import tpch_oracle
from duckdb_tpu_torch.testing.tpch_gen import write_tables

torch.set_num_threads(1)

QUERIES = {k: v for k, v in tpch_oracle.GENERAL_QUERIES.items() if k in ("q06", "q22")}
# the routes each shows on a fresh connection (every eager_* route listed);
# Q22's scalar subquery is a fused ungrouped average ("dense")
ROUTES = {"q06": {"dense": 1},
          "q22": {"dense": 1, "general_aggregate": 1, "general_perfect": 1,
                  "eager_anti": 1}}


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("tpch_gen_q22")
    write_tables(str(root), 0.01, seed=7)
    return str(root)


@pytest.fixture(scope="module")
def cons(data_dir):
    jcon = duckdb_tpu.connect()
    jcon.load_tpch(data_dir)
    jcon.sql("SET pallas_grouped_sum = 'on'")
    tcon = duckdb_tpu_torch.connect(device="cpu")
    tcon.load_tpch(data_dir)
    yield jcon, tcon
    jcon.sql("RESET pallas_grouped_sum")


def _fresh(data_dir):
    tcon = duckdb_tpu_torch.connect(device="cpu")
    tcon.load_tpch(data_dir)
    return tcon


@pytest.mark.parametrize("route", ["host", "device"])
@pytest.mark.parametrize("name", sorted(QUERIES))
def test_query_matches_jax_and_oracle(cons, data_dir, monkeypatch, name, route):
    jcon, tcon = cons
    if route == "device":
        monkeypatch.setattr(TS, "DEVICE_STR_MIN_DICT", 100)
        monkeypatch.setattr(JS, "DEVICE_STR_MIN_DICT", 100)
    got = tcon.sql(QUERIES[name]).rows()
    want = tpch_oracle.answer(name, data_dir)
    assert want and want != [(None,)]
    assert got == want
    assert got == jcon.sql(QUERIES[name]).rows()


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_query_route(data_dir, name):
    tcon = _fresh(data_dir)
    tcon.routes.clear()
    tcon.sql(QUERIES[name]).rows()
    routes = dict(tcon.routes)
    assert {k: routes.get(k) for k in ROUTES[name]} == ROUTES[name], routes
    assert {k for k in routes if k.startswith("eager_")} == \
        {k for k in ROUTES[name] if k.startswith("eager_")}, routes


def test_q22_substring_runs_on_the_plane_path(data_dir, monkeypatch):
    """With c_phone over the threshold, Q22's substring (twice in its text,
    one cached LUT) is a plane op, never the host loop."""
    monkeypatch.setattr(TS, "DEVICE_STR_MIN_DICT", 100)
    tcon = _fresh(data_dir)
    TS.device_str_events.clear()
    TS.host_loop_events.clear()
    tcon.sql(QUERIES["q22"]).rows()
    assert TS.device_str_events == [("substr:1:2", 1500)]
    assert TS.host_loop_events == []


@pytest.mark.parametrize("name,slots", [("q06", [1]), ("q22", [1, 7, 7, 26])])
def test_grouped_sum_kernel_calls(data_dir, monkeypatch, name, slots):
    """The kernel wrapper's calls, by slot count: Q6's one slot; Q22's
    subquery average (one slot), its perfect grouping's occupancy over the
    25 codes and the NULL slot, and over its 7 groups the count of its live
    rows (count(*) and the sum's count alike) and the sum's two 32-bit
    halves (chip_smoke.py checks the kernel on these inputs)."""
    seen = []
    orig = grouped_mod.grouped_sum_i64

    def recording(dense, vectors, nseg):
        seen.append(nseg)
        return orig(dense, vectors, nseg)

    monkeypatch.setattr(grouped_mod, "grouped_sum_i64", recording)
    _fresh(data_dir).sql(QUERIES[name]).rows()
    assert sorted(seen) == slots


def test_q22_codes_parameter_changes_the_answer(cons, data_dir):
    """The oracle's country codes are a real parameter: other codes give
    other rows, and the port agrees."""
    _, tcon = cons
    codes = ("10", "11", "12")
    sql = QUERIES["q22"]
    for old, new in zip(tpch_oracle.Q22_CODES, codes + tpch_oracle.Q22_CODES[len(codes):]):
        sql = sql.replace(f"'{old}'", f"'{new}'")
    want = tpch_oracle.answer("q22", data_dir, codes=codes + tpch_oracle.Q22_CODES[3:])
    assert want != tpch_oracle.answer("q22", data_dir)
    assert tcon.sql(sql).rows() == want
