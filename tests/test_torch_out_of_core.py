"""Out-of-core execution, the device buffer pool, the spill tier and the
OOM retry of duckdb_tpu_torch (device="cpu").

What tests/test_out_of_core.py checks for the JAX package, on generated
data: under `catalog.set_memory_limit` below a query's working set the
port runs the query in chunks of its largest scan (the "out_of_core"
route and its chunk count), and the rows are bit-identical to the same
query run in memory. Aggregates merge (avg as a sum and a count), pure
selects concatenate (an ORDER BY over more rows than the limit holds
sorts range partitions), a join chunks its probe side, VARCHAR group keys
re-encode, per-chunk zone maps bound the dense slots, and a plan that
cannot chunk (median) runs in memory. The JAX package runs the same SQL
under `SET memory_limit` over the same numbers (CREATE TABLE … AS
there; `catalog.create_table` in the port, which has no CREATE TABLE
yet). TPC-H tables come from the port's seeded generator at SF 0.01,
seed 7, and Q3 and Q6 are also held to the numpy oracle.
"""

import os
import sys

import numpy as np
import pytest
import torch

import duckdb_tpu
import duckdb_tpu_torch
from duckdb_tpu_torch.catalog import catalog as C
from duckdb_tpu_torch.errors import OutOfMemoryException
from duckdb_tpu_torch.execution import cache_registry
from duckdb_tpu_torch.storage import spill
from duckdb_tpu_torch.storage.spill import SpillDir, SpillWriter
from duckdb_tpu_torch.testing import tpch_oracle
from duckdb_tpu_torch.testing.tpch_gen import write_tables
from duckdb_tpu_torch.types import BIGINT, VARCHAR, decimal

torch.set_num_threads(1)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402  (Q1's text and its numpy answer)

N = 100_000


@pytest.fixture(autouse=True)
def no_limit():
    yield
    C.set_memory_limit(0)


def _table(con, name, cols):
    """A table of numpy columns {name: (values, type, dictionary | None)}."""
    entry = C.TableEntry(name, [C.ColumnDef(c, t) for c, (_, t, _) in cols.items()])
    entry.nrows = len(next(iter(cols.values()))[0])
    for c, (v, _, dv) in cols.items():
        entry.set_host_column(c, v, None, dv)
    con.catalog.create_table(entry, or_replace=True)


@pytest.fixture(scope="module")
def tcon():
    con = duckdb_tpu_torch.connect(device="cpu")
    i = np.arange(N, dtype=np.int64)
    # x = i * 0.5 as DECIMAL(20,1): scaled integers i * 5
    _table(con, "t", {"i": (i, BIGINT, None), "g": (i % 7, BIGINT, None),
                      "x": (i * 5, decimal(20, 1), None)})
    f = np.arange(200_000, dtype=np.int64)
    _table(con, "fact", {"id": (f, BIGINT, None), "k": (f % 100, BIGINT, None),
                         "v": (f * 15, decimal(20, 1), None)})
    d = np.arange(100, dtype=np.int64)
    _table(con, "dim", {"k": (d, BIGINT, None), "nm": (d * 7, BIGINT, None)})
    s = np.arange(60_000, dtype=np.int64)
    _table(con, "sv", {"s": ((s % 3).astype(np.int32), VARCHAR,
                             np.array(["aa", "bb", "cc"], dtype=object)),
                       "v": (s, BIGINT, None)})
    return con


@pytest.fixture(scope="module")
def jcon():
    con = duckdb_tpu.connect()
    con.sql(f"CREATE TABLE t AS SELECT range AS i, range % 7 AS g, range * 0.5 AS x "
            f"FROM range({N})")
    yield con
    con.sql("SET memory_limit = '0'")


def _check(con, queries, limit, chunked=True):
    """Each query's rows under `limit` equal its rows in memory, and (when
    `chunked`) each took the out-of-core route."""
    for q in queries:
        C.set_memory_limit(0)
        ref = con.sql(q).rows()
        C.set_memory_limit(limit)
        con.routes.clear()
        try:
            got = con.sql(q).rows()
        finally:
            C.set_memory_limit(0)
        assert got == ref, q
        if chunked:
            assert con.routes["out_of_core"] == 1 and con.routes["out_of_core_chunks"] >= 2, \
                (q, dict(con.routes))
    return ref


AGG_QUERIES = [
    "SELECT g, sum(i), count(*), avg(x), min(i), max(x) FROM t GROUP BY g ORDER BY g",
    "SELECT sum(x), count(*) FROM t",
    "SELECT count(*) FROM t WHERE g = 3",
    "SELECT g, avg(i) FROM t GROUP BY g HAVING avg(i) > 49999 ORDER BY g",
]


@pytest.mark.parametrize("q", AGG_QUERIES)
def test_chunked_aggregates(tcon, jcon, q):
    """Chunked equals in memory bit for bit, and equals the JAX package
    under SET memory_limit."""
    got = _check(tcon, [q], 1_000_000)
    jcon.sql("SET memory_limit = '1MB'")
    try:
        assert got == jcon.sql(q).rows()
    finally:
        jcon.sql("SET memory_limit = '0'")


def test_chunked_pure_select(tcon):
    _check(tcon, [
        "SELECT i, x FROM t WHERE i % 1000 = 3 ORDER BY i LIMIT 20",
        # ORDER BY a source column the projection does not give
        "SELECT i FROM t WHERE i < 50 ORDER BY x DESC LIMIT 5",
    ], 1_000_000)


def test_chunked_probe_side_join(tcon):
    _check(tcon, [
        "SELECT d.nm, sum(f.v), count(*) FROM fact f JOIN dim d ON f.k = d.k "
        "WHERE f.id % 3 = 0 GROUP BY d.nm ORDER BY d.nm LIMIT 10",
        "SELECT f.id, d.nm FROM fact f JOIN dim d ON f.k = d.k WHERE f.id % 20000 = 7 "
        "ORDER BY f.id",
    ], 2_000_000)


def test_unchunkable_falls_back(tcon):
    """median has no distributive merge: the plan runs in memory, counted
    as out_of_core_fallback, and answers as in memory."""
    q = "SELECT g, median(i) FROM t GROUP BY g ORDER BY g"
    _check(tcon, [q], 1_000_000, chunked=False)
    assert tcon.routes["out_of_core_fallback"] == 1 and not tcon.routes["out_of_core"]


def test_full_join_over_chunked_table_falls_back(tcon):
    """A FULL join also emits the build rows that no probe row matched,
    which no one chunk can tell: over the chunked table it runs in memory
    (no dim row repeats per chunk, none is NULL-extended wrongly)."""
    q = ("SELECT count(*), count(f.id), count(d.k), sum(d.nm), sum(f.v) FROM "
         "(SELECT * FROM fact WHERE k < 50) f FULL JOIN dim d ON f.k = d.k")
    rows = _check(tcon, [q], 2_000_000, chunked=False)
    assert tcon.routes["out_of_core_fallback"] == 1 and not tcon.routes["out_of_core"]
    # 100,000 fact rows match dim rows 0-49 (2,000 each); dim rows 50-99 match none
    assert rows[0][:4] == (100_050, 100_000, 100_050,
                           sum(7 * k for k in range(50)) * 2000 + sum(7 * k for k in range(50, 100)))


def test_chunked_select_bigint_past_int32(tcon):
    """Each chunk's zone maps narrow its own int64 data: a first chunk
    under 2^31 promotes at int32 and a later one at int64, and the spill
    files keep the logical width (no later value truncates)."""
    base = 2**31 - 60_000
    ids = base + np.arange(N, dtype=np.int64)
    _table(tcon, "wide_ids", {"id": (ids, BIGINT, None), "r": (ids % 1000, BIGINT, None)})
    rows = _check(tcon, ["SELECT id, r FROM wide_ids WHERE r = 7 ORDER BY id DESC"], 1_000_000)
    want = [int(v) for v in ids[ids % 1000 == 7][::-1]]
    assert [r[0] for r in rows] == want and max(want) > 2**31


@pytest.mark.parametrize("value,chunked", [(2**48, True), (2**62, False)])
def test_chunked_hugeint_sum(tcon, value, chunked):
    """A BIGINT sum is a HUGEINT: each chunk sums wide, and the merge sums
    the partials wide, so a total past 2^63 stays exact (2^48). A chunk
    whose own partial passes 64 bits (2^62) runs the query in memory,
    counted as out_of_core_fallback, and answers exactly there."""
    _table(tcon, "big_vals", {"v": (np.full(N, value, dtype=np.int64), BIGINT, None),
                              "g": (np.arange(N, dtype=np.int64) % 2, BIGINT, None)})
    rows = _check(tcon, ["SELECT g, sum(v), count(*) FROM big_vals GROUP BY g ORDER BY g"],
                  500_000, chunked=chunked)
    assert rows == [(0, value * N // 2, N // 2), (1, value * N // 2, N // 2)]
    assert value * N // 2 > 2**63
    assert tcon.routes["out_of_core_fallback"] == (0 if chunked else 1)
    if chunked:
        assert tcon.routes["out_of_core_chunks"] >= 3


def test_chunked_varchar_group_keys(tcon):
    """The chunks' dictionaries are re-encoded at the merge."""
    rows = _check(tcon, ["SELECT s, sum(v), count(*) FROM sv GROUP BY s ORDER BY s",
                         "SELECT s, v FROM sv WHERE v % 9997 = 5 ORDER BY v"], 500_000)
    assert rows == [("aabbcc"[2 * (v % 3):2 * (v % 3) + 2], v) for v in range(5, 60_000, 9997)]


@pytest.mark.parametrize("host_bytes", [spill.HOST_BYTES, 0])
def test_range_partitioned_order(tcon, monkeypatch, host_bytes):
    """An ORDER BY whose result passes the limit: range partitions of the
    leading key, each sorted on the device, in order; the chunks' rows and
    the sorted partitions held in host memory, or in temp files."""
    monkeypatch.setattr(spill, "HOST_BYTES", host_bytes)
    q = "SELECT i, x FROM t WHERE i % 2 = 0 ORDER BY x DESC, i"
    rows = _check(tcon, [q], 400_000)
    assert tcon.routes["out_of_core_sort"] == 1
    assert tcon.routes["out_of_core_sort_partitions"] >= 2
    assert [r[0] for r in rows] == list(range(N - 2, -1, -2))


# -- TPC-H under memory pressure -------------------------------------------------------
@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("tpch_gen_ooc")
    write_tables(str(root), 0.01, seed=7)
    return str(root)


@pytest.fixture(scope="module")
def tpch(data_dir):
    con = duckdb_tpu_torch.connect(device="cpu")
    con.load_tpch(data_dir)
    return con


TPCH = {"q01": chip_smoke.Q1, "q03": tpch_oracle.QUERIES["q03"],
        "q06": tpch_oracle.GENERAL_QUERIES["q06"]}


@pytest.mark.parametrize("name", sorted(TPCH))
def test_tpch_under_memory_pressure(tpch, data_dir, name):
    """Under a limit below lineitem's working set: bit-identical to the
    in-memory run and equal to numpy."""
    rows = _check(tpch, [TPCH[name]], 2_000_000)
    want = chip_smoke.numpy_q1(data_dir) if name == "q01" else tpch_oracle.answer(name, data_dir)
    assert chip_smoke.rows_match(rows, want) == ""


def test_tpch_q1_matches_jax_under_memory_limit(tpch, data_dir):
    jcon = duckdb_tpu.connect()
    jcon.load_tpch(data_dir)
    C.set_memory_limit(2_000_000)
    got = tpch.sql(chip_smoke.Q1).rows()
    jcon.sql("SET memory_limit = '2MB'")
    assert chip_smoke.rows_match(got, jcon.sql(chip_smoke.Q1).rows()) == ""


def test_chunked_group_bounds_not_baked(tpch):
    """Each chunk's zone maps bound its own dense slots: no chunk's keys are
    clamped into another's domain, under several limits."""
    q = ("SELECT l_orderkey, sum(l_extendedprice * (1 - l_discount)), o_orderdate "
         "FROM lineitem, orders WHERE l_orderkey = o_orderkey GROUP BY l_orderkey, o_orderdate")
    ref = sorted(tpch.sql(q).rows())
    for lim in (2_000_000, 1_000_000, 400_000):
        C.set_memory_limit(lim)
        tpch.routes.clear()
        got = sorted(tpch.sql(q).rows())
        C.set_memory_limit(0)
        assert got == ref, lim
        assert tpch.routes["out_of_core"] == 1, lim


def test_tpch_q3_multiple_limits(tpch):
    q = tpch_oracle.QUERIES["q03"]
    ref = tpch.sql(q).rows()
    counts = []
    for lim in (400_000, 1_500_000, 3_000_000):
        C.set_memory_limit(lim)
        tpch.routes.clear()
        assert tpch.sql(q).rows() == ref, lim
        counts.append(tpch.routes["out_of_core_chunks"])
        C.set_memory_limit(0)
    assert counts[0] > counts[1] >= counts[2] >= 2


# -- the pool, the spill tier and the OOM retry --------------------------------------------
def _entry(name, n):
    e = C.TableEntry(name, [C.ColumnDef("a", BIGINT), C.ColumnDef("b", BIGINT)])
    e.nrows = n
    e.set_host_column("a", np.arange(n, dtype=np.int64) << 40)
    e.set_host_column("b", -(np.arange(n, dtype=np.int64) << 40))
    return e


def test_pool_lru_eviction_and_repromotion():
    """Under a limit the least recently touched column leaves the device
    and its next touch promotes it again, with the same values."""
    e = _entry("lru", 1000)  # 1024 padded int64 rows: 8,192 bytes a column
    a = e.device_column("a").data.clone()
    e.device_column("b")
    assert C.POOL.used >= 16_384
    e.device_column("a")  # b is now the least recent
    C.set_memory_limit(9_000)
    assert list(e._device) == ["a"] and C.POOL.used == 8_192
    b = e.device_column("b")  # re-promoted; a leaves
    assert list(e._device) == ["b"]
    assert torch.equal(b.data[:1000], -(torch.arange(1000, dtype=torch.int64) << 40))
    assert torch.equal(e.device_column("a").data, a)
    C.set_memory_limit(0)
    C.POOL.release_entry(e)


def test_device_only_column_survives_eviction():
    """A column made on the device (a range() hidden table, a materialized
    CTE) gets its host copy before it leaves, so eviction loses nothing."""
    con = duckdb_tpu_torch.connect(device="cpu")
    q = "SELECT count(*), sum(range) FROM range(300000)"
    want = con.sql(q).rows()
    hidden = [t for t in con.catalog.tables.values() if t.name.startswith("__")]
    assert hidden and all(not t._host for t in hidden)  # device-only so far
    other = _entry("other", 10)
    other.device_column("a")  # the most recent: it stays
    C.set_memory_limit(1)
    assert all(not t._device for t in hidden)
    C.set_memory_limit(0)
    assert con.sql(q).rows() == want == [(300000, 300000 * 299999 // 2)]
    sql = ("WITH c AS (SELECT n_regionkey AS r, count(*) AS n FROM nation GROUP BY 1) "
           "SELECT a.r, a.n + b.n FROM c a JOIN c b ON a.r = b.r ORDER BY 1")
    con.load_tpch(_tiny_tpch())
    want = con.sql(sql).rows()
    cache_registry.clear_all()
    assert con.sql(sql).rows() == want == [(r, 10) for r in range(5)]


_TINY = []


def _tiny_tpch():
    if not _TINY:
        import tempfile

        d = tempfile.mkdtemp(prefix="tpch_tiny_")
        write_tables(d, 0.001, seed=7)
        _TINY.append(d)
    return _TINY[0]


@pytest.mark.parametrize("host_bytes", [spill.HOST_BYTES, 0])
def test_spill_round_trip(monkeypatch, host_bytes):
    """Chunks appended to the spill tier come back whole: values, NULLs,
    and VARCHAR codes re-encoded into one sorted dictionary; held in host
    memory, or moved to temp files once more than HOST_BYTES arrived."""
    monkeypatch.setattr(spill, "HOST_BYTES", host_bytes)
    sd = SpillDir("test")
    try:
        w = SpillWriter(sd, [BIGINT, VARCHAR])
        w.append([(np.array([1, 2, 3]), np.array([True, False, True]), None),
                  (np.array([1, 0, 1], dtype=np.int32), None,
                   np.array(["x", "zz"], dtype=object))], 3)
        w.append([(np.array([4]), None, None),
                  (np.array([0], dtype=np.int32), None, np.array(["a"], dtype=object))], 1)
        (d, v, _), (s, sv, dv) = w.finish()
        assert isinstance(d, np.memmap) == (host_bytes == 0)
        assert w.nrows == 4 and list(d) == [1, 2, 3, 4] and list(v) == [True, False, True, True]
        assert sv is None and list(dv) == ["a", "x", "zz"]
        assert [dv[c] for c in s] == ["zz", "x", "zz", "a"]
    finally:
        sd.delete()
    assert not os.path.exists(sd.path)


def test_oom_retry(monkeypatch):
    """A statement that runs out of device memory once is retried cold
    (every tracked cache emptied, every pooled column evicted); twice
    raises OutOfMemoryException."""
    con = duckdb_tpu_torch.connect(device="cpu")
    con.load_tpch(_tiny_tpch())
    q = "SELECT n_regionkey, count(*) FROM nation GROUP BY 1 ORDER BY 1"
    want = con.sql(q).rows()
    real = con._run
    fails = {"n": 1}
    cleared = []
    real_clear = cache_registry.clear_all

    def flaky(query):
        if fails["n"] > 0:
            fails["n"] -= 1
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
        return real(query)

    def spy_clear():
        cleared.append(C.POOL.used)
        return real_clear()

    monkeypatch.setattr(con, "_run", flaky)
    monkeypatch.setattr("duckdb_tpu_torch.api.connection.clear_all", spy_clear)
    assert con.sql(q).rows() == want
    assert len(cleared) == 1 and C.POOL.used > 0  # the retry promoted the columns again
    fails["n"] = 2
    with pytest.raises(OutOfMemoryException, match="Out of Memory Error"):
        con.sql(q)
    assert fails["n"] == 0 and len(cleared) == 2
    fails["n"] = 0
    monkeypatch.setattr(con, "_run", lambda query: (_ for _ in ()).throw(ValueError("other")))
    with pytest.raises(ValueError, match="other"):
        con.sql(q)
    assert len(cleared) == 2  # other errors are not retried


def test_is_oom():
    assert cache_registry.is_oom(torch.cuda.OutOfMemoryError("CUDA out of memory"))
    assert cache_registry.is_oom(RuntimeError("CUDA error: out of memory"))
    assert not cache_registry.is_oom(RuntimeError("shape mismatch"))


def test_tracked_caches_are_cleared(tpch):
    """The join build caches on plan nodes and the string caches are
    tracked, so OOM recovery empties them."""
    tpch.sql(tpch_oracle.QUERIES["q03"]).rows()
    stores = list(cache_registry._STORES)
    assert any(stores) and len(stores) >= 3
    cache_registry.clear_all()
    assert not any(cache_registry._STORES) and C.POOL.used == 0
