"""Sharded execution of duckdb_tpu_torch (device="cpu", 8 shards on the CPU)
against its single-device run, the JAX package on 8 virtual devices and
the numpy oracle.

tests/test_distributed.py's queries, over the port's generated TPC-H
tables (testing/tpch_gen.py, SF 0.01, seed 7) and over small tables made
the same way in both packages (CREATE TABLE in the JAX package,
`catalog.create_table` in the port). Each query runs through the port at
`SET num_shards = 1` and `= 8` on fresh connections (so no cached build
hides the route), through the JAX package at 8, and through the oracle
where it has the query. Rows must be equal (DOUBLE within 1e-9 relative),
in ORDER BY order, else as multisets. The routes show that the sharded
path ran: "sharded_agg", "exchange_join", "exchange_join_dup",
"sharded_probe", "sharded_sort", "sharded_topn", "sharded_window", each
with "sharded_shared_card" (the CPU's 8 shards share one device).

W5: the JAX package's sharded whole-partition count and sum are wrong, so
those windows are held to the single-device run and to Python only. Then
a small config matrix after tests/test_config_matrix.py (sharded,
shard_everything, exchange_join_forced, spill_sharded) over the oracle's
TPC-H queries, and the AUTO policy with the visible-device count
monkeypatched to 8.
"""

import os
import sys

import numpy as np
import pytest
import torch

import duckdb_tpu
import duckdb_tpu_torch
from duckdb_tpu_torch.catalog import catalog as C
from duckdb_tpu_torch.execution import fused_agg as TFA
from duckdb_tpu_torch.ops import grouped as TG
from duckdb_tpu_torch.parallel import shard as TS
from duckdb_tpu_torch.testing import tpch_oracle
from duckdb_tpu_torch.testing.tpch_gen import write_tables
from duckdb_tpu_torch.types import BIGINT, DOUBLE, INTEGER, VARCHAR

torch.set_num_threads(1)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402  (Q1's text and its numpy answer)

Q = {**tpch_oracle.QUERIES, **tpch_oracle.LIKE_QUERIES, **tpch_oracle.GENERAL_QUERIES,
     "q01": chip_smoke.Q1}
SHARDED_OPS = {"sharded_agg", "exchange_join", "exchange_join_dup", "sharded_probe",
               "sharded_sort", "sharded_topn", "sharded_window"}


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("tpch_gen_dist")
    write_tables(str(root), 0.01, seed=7)
    return str(root)


@pytest.fixture(autouse=True)
def no_limit():
    yield
    C.set_memory_limit(0)


def _table(con, name, cols):
    """A port table of numpy columns {name: (values, type, validity | None)}."""
    entry = C.TableEntry(name, [C.ColumnDef(c, t) for c, (_, t, _) in cols.items()])
    entry.nrows = len(next(iter(cols.values()))[0])
    for c, (v, _, valid) in cols.items():
        entry.set_host_column(c, v, valid, None)
    con.catalog.create_table(entry, or_replace=True)


def port(sql, shards, data_dir=None, tables=None, sets=()):
    """Rows and routes of sql on a fresh port connection at num_shards."""
    con = duckdb_tpu_torch.connect(device="cpu")
    if data_dir is not None:
        con.load_tpch(data_dir)
    for name, cols in (tables or {}).items():
        _table(con, name, cols)
    con.sql(f"SET num_shards = {shards}")
    for s in sets:
        con.sql(s)
    con.routes.clear()
    rows = con.sql(sql).rows()
    return rows, dict(con.routes)


def jax_rows(sql, data_dir=None, setup=(), sets=()):
    con = duckdb_tpu.connect()
    if data_dir is not None:
        con.load_tpch(data_dir)
    for s in setup:
        con.sql(s)
    con.sql("SET num_shards = 8")
    for s in sets:
        con.sql(s)
    return con.sql(sql).rows()


def assert_rows_match(got, want, ordered=True):
    if not ordered:
        got, want = sorted(got, key=repr), sorted(want, key=repr)
    assert len(got) == len(want)
    for g_row, w_row in zip(got, want):
        assert len(g_row) == len(w_row)
        for g, w in zip(g_row, w_row):
            assert type(g) is type(w), (g_row, w_row)
            if isinstance(w, float):
                assert g == pytest.approx(w, rel=1e-9, abs=0.0), (g_row, w_row)
            else:
                assert g == w, (g_row, w_row)


def sharded(routes, *ops):
    """The routes of a sharded run: each op, the CPU's shared placement."""
    assert routes.get("sharded_shared_card", 0) >= 1 and "sharded" not in routes, routes
    for op in ops:
        assert routes.get(op, 0) >= 1, (op, routes)


def check(sql, data_dir=None, ops=(), oracle=None, jax=True, ordered=True, tables=None,
          jsetup=(), sets=(), jsets=None):
    """Port at 1 and 8 shards, JAX at 8, the oracle: all equal."""
    single, r1 = port(sql, 1, data_dir, tables, sets)
    assert not SHARDED_OPS & set(r1) and "sharded_shared_card" not in r1, r1
    got, routes = port(sql, 8, data_dir, tables, sets)
    sharded(routes, *ops)
    assert_rows_match(got, single, ordered)
    if jax:
        assert_rows_match(got, jax_rows(sql, data_dir, jsetup, sets if jsets is None else jsets),
                          ordered)
    if oracle is not None:
        assert_rows_match(got, oracle, ordered)
    return got, routes


def test_sharded_aggregate_q1(data_dir, monkeypatch):
    """Q1's dense aggregate on 8 shards: the grouped sum once per shard."""
    calls = []
    orig = TG.grouped_sum_i64

    def counted(dense, vectors, nseg):
        calls.append((dense.shape[0], len(vectors), nseg))
        return orig(dense, vectors, nseg)

    monkeypatch.setattr(TG, "grouped_sum_i64", counted)
    got, routes = check(Q["q01"], data_dir, ("sharded_agg",), chip_smoke.numpy_q1(data_dir))
    assert routes["sharded_agg"] == 1 and routes["dense"] == 1
    # one call at 1 shard, then one per shard over its rows (K 16, 20 slots)
    assert len(calls) == 1 + 8 and all(c[1:] == (16, 20) for c in calls)
    assert sum(n for n, _, _ in calls[1:]) == calls[0][0]


def test_sharded_join_q3(data_dir):
    got, routes = check(Q["q03"], data_dir, ("sharded_probe",),
                        tpch_oracle.answer("q03", data_dir))
    assert routes["sharding_single:sort_group aggregate"] == 1


@pytest.mark.parametrize("name,op", [("q03", "exchange_join"), ("q09", "exchange_join"),
                                     ("q05", "exchange_join_dup")])
def test_exchange_join_tpch(data_dir, name, op):
    """exchange_join_threshold = 0: every eager equi-join repartitions."""
    check(Q[name], data_dir, (op,), tpch_oracle.answer(name, data_dir),
          sets=("SET exchange_join_threshold = 0",))


@pytest.mark.parametrize("sql,jtype", [
    ("SELECT count(*), sum(o_totalprice) FROM orders LEFT JOIN customer ON o_custkey = c_custkey",
     "left"),
    ("SELECT count(*), sum(o_totalprice) FROM orders LEFT JOIN customer "
     "ON o_custkey = c_custkey AND c_acctbal > 0", "left"),
    ("SELECT count(*) FROM orders WHERE EXISTS "
     "(SELECT 1 FROM customer WHERE c_custkey = o_custkey)", "semi"),
    ("SELECT count(*) FROM orders WHERE o_custkey NOT IN "
     "(SELECT c_custkey FROM customer WHERE c_acctbal > 0)", "anti"),
    ("SELECT count(*) FROM orders WHERE NOT EXISTS "
     "(SELECT 1 FROM customer WHERE c_custkey = o_custkey AND c_nationkey < 5)", "anti"),
])
def test_exchange_join_left_semi_anti(data_dir, monkeypatch, sql, jtype):
    """Eager left, semi and anti joins through the exchange (the fused
    pipeline is switched off in both packages, as tests/test_distributed.py
    does, or it would take the semi and anti joins as membership steps)."""
    from duckdb_tpu.execution import fused_agg as JFA

    monkeypatch.setattr(JFA, "build_fused_agg", lambda ex, node: None)
    monkeypatch.setattr(TFA, "build_fused_agg", lambda ex, node: None)
    _, routes = check(sql, data_dir, ("exchange_join",),
                      sets=("SET exchange_join_threshold = 0",))
    assert routes[f"eager_{jtype}"] == 1


def test_sharded_minmax(data_dir):
    sql = ("SELECT l_returnflag, min(l_quantity), max(l_extendedprice), avg(l_discount), "
           "min(l_shipdate), max(CAST(l_tax AS DOUBLE)) FROM lineitem GROUP BY l_returnflag "
           "ORDER BY l_returnflag")
    check(sql, data_dir, ("sharded_agg",))


def _kv_tables(nl, ml, nr, mr):
    """l(k, v) and r(k, w) as tests/test_distributed.py builds them."""
    i, j = np.arange(nl, dtype=np.int64), np.arange(nr, dtype=np.int64)
    return ({"l": {"k": ((i % ml).astype(np.int32), INTEGER, None), "v": (i, BIGINT, None)},
             "r": {"k": ((j % mr).astype(np.int32), INTEGER, None),
                   "w": (j * 3, BIGINT, None)}},
            [f"CREATE TABLE l AS SELECT CAST(range % {ml} AS INTEGER) AS k, range AS v "
             f"FROM range({nl})",
             f"CREATE TABLE r AS SELECT CAST(range % {mr} AS INTEGER) AS k, range * 3 AS w "
             f"FROM range({nr})"])


def test_exchange_join_duplicate_build_keys():
    """A fact-fact join with duplicate keys on both sides (median keeps it
    off the fused path): the dup-key exchange, equal to one device."""
    tables, setup = _kv_tables(4000, 50, 300, 50)
    q = ("SELECT l.k, median(l.v + r.w), count(*), sum(r.w) FROM l JOIN r ON l.k = r.k "
         "GROUP BY l.k ORDER BY l.k")
    got, _ = check(q, ops=("exchange_join_dup",), tables=tables, jsetup=setup,
                   sets=("SET exchange_join_threshold = 0",))
    assert [r[2] for r in got] == [80 * 6] * 50


@pytest.mark.parametrize("q", [
    "SELECT count(*) FROM l WHERE EXISTS (SELECT 1 FROM r WHERE r.k = l.k)",
    "SELECT count(*) FROM l WHERE NOT EXISTS (SELECT 1 FROM r WHERE r.k = l.k)",
])
def test_exchange_join_dup_semi_anti(monkeypatch, q):
    from duckdb_tpu.execution import fused_agg as JFA

    monkeypatch.setattr(JFA, "build_fused_agg", lambda ex, node: None)
    monkeypatch.setattr(TFA, "build_fused_agg", lambda ex, node: None)
    tables, setup = _kv_tables(3000, 37, 200, 11)
    got, _ = check(q, ops=("exchange_join_dup",), tables=tables, jsetup=setup,
                   sets=("SET exchange_join_threshold = 0",))
    exists = int((np.arange(3000) % 37 < 11).sum())
    assert got[0][0] == (3000 - exists if "NOT" in q else exists)


def _order_table():
    i = np.arange(20000, dtype=np.int64)
    return ({"t": {"a": ((i * 2654435761) % 1000000, BIGINT, None),
                   "b": (i.astype(np.int32), INTEGER, None)}},
            ["CREATE TABLE t AS SELECT (range * 2654435761) % 1000000 AS a, "
             "CAST(range AS INTEGER) AS b FROM range(20000)"])


def test_sharded_order_by():
    tables, setup = _order_table()
    got, _ = check("SELECT a, b FROM t ORDER BY a", ops=("sharded_sort",), tables=tables,
                   jsetup=setup)
    a = tables["t"]["a"][0]
    assert [r[1] for r in got] == np.argsort(a, kind="stable").tolist()


def _nulls_table():
    i = np.arange(17000, dtype=np.int64)
    a = (i * 48271) % 99991
    return ({"t": {"a": (a, BIGINT, i % 97 != 0), "i": (i, BIGINT, None)}},
            ["CREATE TABLE t AS SELECT CASE WHEN range % 97 = 0 THEN NULL "
             "ELSE (range * 48271) % 99991 END AS a, range AS i FROM range(17000)"])


@pytest.mark.parametrize("q", ["SELECT a, i FROM t ORDER BY a DESC",
                               "SELECT a, i FROM t ORDER BY a NULLS FIRST",
                               "SELECT a, i FROM t ORDER BY a DESC NULLS FIRST, i DESC"])
def test_sharded_order_by_desc_nulls(q):
    tables, setup = _nulls_table()
    check(q, ops=("sharded_sort",), tables=tables, jsetup=setup)


def test_sharded_order_by_lineitem(data_dir):
    """ORDER BY over all of lineitem, ties (equal prices) by row order."""
    check("SELECT l_orderkey, l_linenumber, l_extendedprice FROM lineitem "
          "ORDER BY l_extendedprice DESC, l_shipdate", data_dir, ("sharded_sort",))


@pytest.mark.parametrize("q", ["SELECT a FROM t ORDER BY a LIMIT 7",
                               "SELECT a FROM t ORDER BY a DESC LIMIT 5 OFFSET 3",
                               "SELECT a, s FROM t ORDER BY s, a LIMIT 6",
                               "SELECT a FROM t WHERE a > 50000 ORDER BY a LIMIT 4"])
def test_sharded_topn(q):
    i = np.arange(65536, dtype=np.int64)
    a = ((i * 7919) % 100000).astype(np.int32)
    s = (i % 4).astype(np.int32)
    con = duckdb_tpu_torch.connect(device="cpu")
    entry = C.TableEntry("t", [C.ColumnDef("a", INTEGER), C.ColumnDef("s", VARCHAR)])
    entry.nrows = len(i)
    entry.set_host_column("a", a)
    entry.set_host_column("s", s, None, np.array(["v0", "v1", "v2", "v3"], dtype=object))
    con.catalog.create_table(entry)
    got = {}
    for shards in (1, 8):
        con.sql(f"SET num_shards = {shards}")
        con.routes.clear()
        got[shards] = con.sql(q).rows()
        if shards == 8:
            sharded(dict(con.routes), "sharded_topn")
    assert got[8] == got[1]
    want = jax_rows(q, setup=["CREATE TABLE t AS SELECT CAST((range * 7919) % 100000 AS INTEGER)"
                              " AS a, 'v' || (range % 4) AS s FROM range(65536)"])
    assert got[8] == want


def test_sharded_topn_lineitem(data_dir):
    check("SELECT l_orderkey, l_linenumber, l_extendedprice FROM lineitem "
          "ORDER BY l_extendedprice DESC NULLS FIRST, l_orderkey LIMIT 25 OFFSET 5", data_dir,
          ("sharded_topn",))


def _window_table():
    i = np.arange(40000, dtype=np.int64)
    return ({"w": {"g": ((i % 97).astype(np.int32), INTEGER, None),
                   "o": (((i * 31) % 1009).astype(np.int32), INTEGER, None),
                   "v": ((i % 50).astype(np.int32), INTEGER, None),
                   "f": (i / 3.0, DOUBLE, None)}},
            ["CREATE TABLE w (g INT, o INT, v INT, f DOUBLE)",
             "INSERT INTO w SELECT range % 97, (range * 31) % 1009, range % 50, range / 3.0 "
             "FROM range(40000)"])


WINDOW_QUERIES = {
    "row_number": "SELECT g, o, row_number() OVER (PARTITION BY g ORDER BY o) rn "
                  "FROM w ORDER BY g, o, rn LIMIT 50",
    "rank": "SELECT g, o, rank() OVER (PARTITION BY g ORDER BY v) rn FROM w "
            "ORDER BY g, o, rn LIMIT 50",
    "dense_rank": "SELECT g, o, dense_rank() OVER (PARTITION BY g ORDER BY v) d FROM w "
                  "ORDER BY g, o, d LIMIT 50",
    "sum_running": "SELECT g, o, sum(v) OVER (PARTITION BY g ORDER BY o) s FROM w "
                   "ORDER BY g, o, s LIMIT 50",
    "min": "SELECT g, min(v) OVER (PARTITION BY g) s FROM w ORDER BY g LIMIT 30",
    "sum": "SELECT g, sum(v) OVER (PARTITION BY g) s FROM w ORDER BY g LIMIT 30",
    "avg": "SELECT g, avg(f) OVER (PARTITION BY g) s FROM w ORDER BY g, s LIMIT 30",
    "count": "SELECT g, count(*) OVER (PARTITION BY g) c, max(o) OVER (PARTITION BY g) m "
             "FROM w ORDER BY g LIMIT 30",
}
# W5 in the JAX package: whole-partition and running count, sum and avg
# (its sums run to the end of the shard)
W5 = ("sum", "avg", "count", "sum_running")


@pytest.mark.parametrize("name", sorted(WINDOW_QUERIES))
def test_sharded_window(name):
    tables, setup = _window_table()
    got, routes = check(WINDOW_QUERIES[name], ops=("sharded_window",), tables=tables,
                        jsetup=setup, jax=name not in W5)
    if name in W5:  # the partition's own rows, not the shard's
        g, o = tables["w"]["g"][0], tables["w"]["o"][0]
        v, f = tables["w"]["v"][0], tables["w"]["f"][0]
        for row in got:
            m = g == row[0]
            want = {"sum": int(v[m].sum()), "count": int(m.sum()), "avg": float(f[m].mean()),
                    "sum_running": int(v[m & (o <= row[1])].sum())}[name]
            assert row[-1 if name == "sum_running" else 1] == pytest.approx(want, rel=1e-9)


def test_w5_partition_count_over_lineitem(data_dir):
    """W5's repro: count(*) and sum(l_quantity) OVER (PARTITION BY
    l_orderkey) at 8 shards give each order's own line count and quantity
    (held to a GROUP BY over the same rows). Both windows share one
    exchange."""
    sql = ("SELECT l_orderkey, l_linenumber, count(*) OVER (PARTITION BY l_orderkey) c, "
           "sum(l_quantity) OVER (PARTITION BY l_orderkey) s FROM lineitem "
           "ORDER BY l_orderkey, l_linenumber LIMIT 200")
    got, routes = check(sql, data_dir, ("sharded_window",), jax=False)
    assert routes["sharded_window"] == 1
    per_order = {k: (c, s) for k, c, s in port(
        "SELECT l_orderkey, count(*), sum(l_quantity) FROM lineitem GROUP BY l_orderkey",
        1, data_dir)[0]}
    assert all((r[2], r[3]) == per_order[r[0]] for r in got)
    assert got[0][2] > 1


# -- config matrix (tests/test_config_matrix.py's sharded configurations) ------------
CONFIGS = {
    "sharded": ["SET num_shards = 8"],
    "shard_everything": ["SET num_shards = 8", "SET auto_shard_rows = 1"],
    "exchange_join_forced": ["SET num_shards = 8", "SET exchange_join_threshold = 0"],
    "spill_sharded": ["SET memory_limit = '32MB'", "SET num_shards = 8"],
}
MATRIX_QUERIES = ["q01", "q03", "q05", "q06", "q10", "q12", "q14"]


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("name", MATRIX_QUERIES)
def test_config_matrix(data_dir, config, name):
    want = chip_smoke.numpy_q1(data_dir) if name == "q01" else tpch_oracle.answer(name, data_dir)
    con = duckdb_tpu_torch.connect(device="cpu")
    con.load_tpch(data_dir)
    for s in CONFIGS[config]:
        con.sql(s)
    con.routes.clear()
    assert_rows_match(con.sql(Q[name]).rows(), want)
    sharded(dict(con.routes))
    assert SHARDED_OPS & set(con.routes), dict(con.routes)


# -- AUTO ------------------------------------------------------------------------------
def test_auto_shard_policy(monkeypatch):
    """num_shards = 0 (AUTO, the JAX package's default; the port's is 1):
    every visible card once an operator's rows exceed auto_shard_rows. One
    device (the CPU, a one-card host) never shards; with 8 visible it
    does, above 32,768 rows only. The default shards nothing, also with 8
    visible."""
    i = np.arange(40000, dtype=np.int64)
    big = {"big": {"g": (i % 11, BIGINT, None), "v": (i, BIGINT, None)}}
    q = "SELECT g, sum(v) FROM big GROUP BY g ORDER BY g"
    want = [(g, int(i[i % 11 == g].sum())) for g in range(11)]

    def run(tables, sql, auto=True):
        con = duckdb_tpu_torch.connect(device="cpu")
        for name, cols in tables.items():
            _table(con, name, cols)
        assert con.settings.get("num_shards") == 1
        if auto:
            con.sql("SET num_shards = 0")
        con.routes.clear()
        return con.sql(sql).rows(), dict(con.routes)

    rows, routes = run(big, q)
    assert rows == want and not SHARDED_OPS & set(routes)
    monkeypatch.setattr(TS, "visible_devices", lambda home: 8)
    rows, routes = run(big, q, auto=False)
    assert rows == want and not SHARDED_OPS & set(routes)
    rows, routes = run(big, q)
    assert rows == want and routes["sharded_agg"] == 1
    small = {"small": {"r": (np.arange(100, dtype=np.int64), BIGINT, None)}}
    rows, routes = run(small, "SELECT sum(r) FROM small")
    assert rows == [(4950,)] and not SHARDED_OPS & set(routes)


def test_sharded_probe_keeps_its_copies(monkeypatch):
    """The sharded dense probe copies the dense table to the shards'
    devices once per join and data: a warm query replicates nothing, a
    changed build table replicates again, and the rows stay those of one
    device."""
    monkeypatch.setattr(TFA, "build_fused_agg", lambda ex, node: None)  # an eager join
    calls, orig = [], TS.replicate
    monkeypatch.setattr(TS, "replicate", lambda mesh, x: calls.append(x.shape[0])
                        or orig(mesh, x))
    i = np.arange(50_000, dtype=np.int64)
    tables = {"t": {"i": (i, BIGINT, None), "g": (i % 7, BIGINT, None)},
              "d": {"k": (np.arange(7, dtype=np.int64), BIGINT, None),
                    "w": (np.arange(7, dtype=np.int64) * 10, BIGINT, None)}}
    q = "SELECT t.g, count(*), sum(d.w) FROM t JOIN d ON t.g = d.k GROUP BY t.g ORDER BY t.g"
    want = [(g, int((i % 7 == g).sum()), int((i % 7 == g).sum()) * 10 * g) for g in range(7)]
    assert port(q, 1, tables=tables)[0] == want and not calls
    con = duckdb_tpu_torch.connect(device="cpu")
    for name, cols in tables.items():
        _table(con, name, cols)
    con.sql("SET num_shards = 8")
    for _ in range(3):
        con.routes.clear()
        assert con.sql(q).rows() == want
        sharded(dict(con.routes), "sharded_probe")
    assert len(calls) == 1
    con.catalog.get_table("d").set_host_column("k", np.arange(7, dtype=np.int64)[::-1].copy())
    assert con.sql(q).rows() == [(g, n, n * 10 * (6 - g)) for g, n, _ in want]
    assert len(calls) == 2


def test_sharded_aggregate_compacts_each_shard(monkeypatch):
    """A dense aggregate over more than 1,024 slots whose filter keeps few
    rows compacts each shard after the filter; the shards' live counts are
    read in one transfer, and the rows equal one device's."""
    i = np.arange(140_000, dtype=np.int64)
    tables = {"t": {"i": (i, BIGINT, None), "g": (i % 2000, BIGINT, None)}}
    q = "SELECT g, count(*), sum(i) FROM t WHERE i % 7 = 1 GROUP BY g ORDER BY g"
    reads, packs = [], []
    orig_read, orig_pack = TS.host_ints, TFA.packed_indices
    monkeypatch.setattr(TS, "host_ints", lambda mesh, parts: reads.append(len(parts))
                        or orig_read(mesh, parts))
    # the pipeline's compactions (over more than 65,536 rows; the output's
    # compaction of the slots is the other call)
    monkeypatch.setattr(TFA, "packed_indices", lambda live, cap: (
        live.shape[0] > 1 << 16 and packs.append(live.shape[0])) or orig_pack(live, cap))
    single, _ = port(q, 1, tables=tables)
    assert packs == [163_840]
    got, routes = port(q, 2, tables=tables)
    assert got == single and routes["sharded_agg"] == 1
    assert reads == [2] and packs[1:] == [81_920, 81_920]
    m = i % 7 == 1
    assert got == [(g, int((m & (i % 2000 == g)).sum()), int(i[m & (i % 2000 == g)].sum()))
                   for g in range(2000)]
