"""Card-only checks of the port's CUDA kernels against their plain versions.

Imports no jax, so it runs on a GPU host without JAX:
    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
Each test skips itself where no CUDA device is present.
"""

import pytest
import torch

from duckdb_tpu_torch.ops import grouped_sum as GS


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _expected_launches(k, nseg):
    """Launches and launches by regime that the wrapper's plan makes for k vectors."""
    by_regime = {"small": 0, "large": 0}
    while k:
        plan = GS.launch_plan(nseg, k)
        by_regime[plan.regime] += 1
        k -= plan.vectors
    return sum(by_regime.values()), by_regime


@pytest.mark.gpu
@pytest.mark.parametrize("n,k,nseg,ids", [
    (1, 1, 1, None), (1000, 15, 20, None), (1000, 16, 20, None),
    (1 << 20, 24, 256, None), (1 << 20, 40, 256, None), (6_291_456, 15, 20, None),
    (6_291_456, 16, 20, (0, 1, 4, 5, -1)),   # Q1's 4 live slots of 20
    ((1 << 20) + 77, 16, 20, (7,)),          # every row in one slot, ragged tail
    (1 << 20, 16, "max", None),              # last nseg of the small regime
    (1 << 20, 16, "max+1", None),            # first nseg of the large regime
    (1 << 20, 9, 216, (100,)),               # large regime, every row in one slot
    (1 << 20, 25, 20, (3, 9, 21)),           # splits 24 + 1; id 21 is dead
])
def test_grouped_sum_kernel_matches_plain(n, k, nseg, ids):
    """Bit-equal to the plain version: full-range values wrap mod 2^64, and
    where ids are drawn from a few given ones the dead rows keep nonzero
    values, which both versions must ignore."""
    _need_cuda()
    nseg = {"max": GS.SMALL_MAX_NSEG, "max+1": GS.SMALL_MAX_NSEG + 1}.get(nseg, nseg)
    gen = torch.Generator().manual_seed(n + k + nseg)
    if ids is None:
        dense = torch.randint(-1, nseg + 2, (n,), generator=gen, dtype=torch.int32)
    else:
        dense = torch.tensor(ids, dtype=torch.int32)[
            torch.randint(0, len(ids), (n,), generator=gen)]
    dead = (dense < 0) | (dense >= nseg)
    vecs = []
    for _ in range(k):
        v = torch.randint(-(2**63 - 1), 2**63 - 1, (n,), generator=gen, dtype=torch.int64)
        vecs.append((torch.where(dead, 0, v) if ids is None else v).cuda())
    dense = dense.cuda()
    GS.grouped_sum_i64.launches = 0
    GS.grouped_sum_i64.regime_launches = {"small": 0, "large": 0}
    got = GS.grouped_sum_i64(dense, vecs, nseg)
    launches, by_regime = _expected_launches(k, nseg)
    assert GS.grouped_sum_i64.launches == launches
    assert GS.grouped_sum_i64.regime_launches == by_regime
    want = GS.grouped_sum_i64_plain(dense, vecs, nseg)
    torch.cuda.synchronize()
    assert len(got) == k
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_grouped_sum_kernel_takes_unaligned_views():
    """Vectors that start 8 bytes past a 16-byte boundary are copied, not refused."""
    _need_cuda()
    n, nseg = 10_001, 20
    gen = torch.Generator().manual_seed(1)
    dense = torch.randint(0, nseg, (n + 1,), generator=gen, dtype=torch.int32).cuda()[1:]
    base = torch.randint(-1000, 1000, (3, n + 1), generator=gen, dtype=torch.int64).cuda()
    vecs = [base[j, 1:] for j in range(3)]
    got = GS.grouped_sum_i64(dense, vecs, nseg)
    want = GS.grouped_sum_i64_plain(dense, vecs, nseg)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _join_inputs(seed, nb, npr, key_range, dead):
    gen = torch.Generator().manual_seed(seed)
    bkeys = torch.randint(0, key_range, (nb,), generator=gen)
    blive = torch.rand(nb, generator=gen) >= dead
    # probes reach past the build's range on both sides
    pkeys = torch.randint(-key_range, 2 * key_range, (npr,), generator=gen)
    plive = torch.rand(npr, generator=gen) >= dead
    return bkeys, blive, pkeys, plive


@pytest.mark.gpu
@pytest.mark.parametrize("nb,npr,key_range,dead", [
    (1000, 5000, 100, 0.0),          # duplicates
    (1 << 20, 1 << 21, 1 << 22, 0.3),  # mostly unique, dead rows
    (4096, 4096, 64, 1.0),           # nothing live
])
def test_join_ops_on_cuda_match_cpu(nb, npr, key_range, dead):
    """ops/join on the card equals the same calls on the CPU: out-of-range
    and dead probes must not trip a device-side assert."""
    _need_cuda()
    from duckdb_tpu_torch.ops import join as J

    bkeys, blive, pkeys, plive = _join_inputs(nb + npr, nb, npr, key_range, dead)
    out = {}
    for dev in ("cpu", "cuda"):
        tb = J.build_sorted(bkeys.to(dev), blive.to(dev))
        counts, lo, hi = J.probe_counts(tb, pkeys.to(dev), plive.to(dev))
        total = int(counts.sum())
        pr, br, live = J.expand_matches(counts, lo, tb.perm, total + 128)
        # the pairs as (probe row, build key): independent of the order
        # within a run of equal build keys
        pairs = torch.stack([pr[live], bkeys.to(dev)[br[live]]], 1)
        slots = J.perfect_build(torch.arange(nb, device=dev) * 3, blive.to(dev), 0, 3 * nb)
        rows, matched = J.perfect_probe(slots, pkeys.to(dev), plive.to(dev), -7)
        out[dev] = [tb.sorted_keys, counts, lo, hi, pairs, live, slots, rows, matched]
    torch.cuda.synchronize()
    for c, g in zip(out["cpu"], out["cuda"]):
        assert torch.equal(c, g.cpu())


@pytest.mark.gpu
def test_join_queries_on_cuda(tmp_path):
    """Q3, Q5, Q10 and Q12 at SF 0.01 on the card equal the numpy oracle."""
    _need_cuda()
    import duckdb_tpu_torch
    from duckdb_tpu_torch.testing import tpch_oracle
    from duckdb_tpu_torch.testing.tpch_gen import write_tables

    write_tables(str(tmp_path), 0.01, seed=7)
    con = duckdb_tpu_torch.connect()
    con.load_tpch(str(tmp_path))
    for name, sql in tpch_oracle.QUERIES.items():
        assert con.sql(sql).rows() == tpch_oracle.answer(name, str(tmp_path)), name


def _membership_connections(seed=11, n_probe=200_000, n_build=50_000):
    """A CPU and a CUDA connection over the same two tables: probe keys
    reach past the build's range on both sides and hold NULLs; build keys
    repeat (each about four times) and hold NULLs in a second table."""
    import numpy as np

    import duckdb_tpu_torch
    from duckdb_tpu_torch.catalog.catalog import ColumnDef, TableEntry
    from duckdb_tpu_torch.types import BIGINT

    rng = np.random.default_rng(seed)
    tables = {
        "tp": ("x", rng.integers(-5_000, 25_000, n_probe), rng.random(n_probe) >= 0.05),
        "tb": ("y", rng.integers(0, 20_000, n_build) // 4 * 4, None),
        "tbn": ("y", rng.integers(0, 20_000, n_build), rng.random(n_build) >= 0.01),
    }
    cons = []
    for dev in ("cpu", "cuda"):
        con = duckdb_tpu_torch.connect(device=dev)
        for name, (col, values, valid) in tables.items():
            entry = TableEntry(name, [ColumnDef(col, BIGINT), ColumnDef("v", BIGINT)])
            entry.nrows = len(values)
            entry.set_host_column(col, values.astype(np.int64), valid)
            entry.set_host_column("v", np.arange(len(values), dtype=np.int64) % 97)
            con.catalog.create_table(entry)
        cons.append(con)
    return cons


@pytest.mark.gpu
@pytest.mark.parametrize("sql,route", [
    # fused membership steps: duplicate build keys in the LUT
    ("SELECT v % 7 AS g, count(*), sum(v) FROM tp WHERE EXISTS "
     "(SELECT * FROM tb WHERE y = x) GROUP BY g ORDER BY g", "fused_semi"),
    # anti: out-of-range and NULL probe keys must survive
    ("SELECT v % 7 AS g, count(*), sum(x) FROM tp WHERE NOT EXISTS "
     "(SELECT * FROM tb WHERE y = x) GROUP BY g ORDER BY g", "fused_anti"),
    # a residual over a unique (aggregated) build, fused
    ("SELECT count(*), sum(v) FROM tp WHERE NOT EXISTS (SELECT * FROM tb "
     "WHERE y = x AND v <> tp.v)", "fused_anti"),
    # NOT IN: null-aware, eager, against a build with and without NULLs
    ("SELECT count(*), sum(x) FROM tp WHERE x NOT IN (SELECT y FROM tb)", "eager_anti"),
    ("SELECT count(*) FROM tp WHERE x NOT IN (SELECT y FROM tbn)", "eager_anti"),
    # correlated NOT IN: each row's NULL cases come from its own group
    ("SELECT count(*), sum(v) FROM tp WHERE x NOT IN "
     "(SELECT y FROM tbn WHERE tbn.v = tp.v)", "eager_anti"),
    # IN with a `<>` correlation: two count probes on the card
    ("SELECT count(*), sum(v) FROM tp WHERE x IN "
     "(SELECT y FROM tb WHERE tb.v <> tp.v)", "eager_semi"),
    # eager semi join with duplicate build keys (no aggregate above)
    ("SELECT x, v FROM tp WHERE x IN (SELECT y FROM tbn) ORDER BY x, v LIMIT 50",
     "eager_semi"),
])
def test_semi_anti_on_cuda_match_cpu(sql, route):
    """Semi/anti joins on the card equal the CPU's: a CUDA scatter of
    duplicate keys picks any row, which membership must not notice."""
    _need_cuda()
    cpu, cuda = _membership_connections()
    want = cpu.sql(sql).rows()
    cuda.routes.clear()
    got = cuda.sql(sql).rows()
    assert got == want
    assert cuda.routes.get(route) == 1, dict(cuda.routes)


@pytest.mark.gpu
def test_subquery_queries_on_cuda(tmp_path):
    """Q4, Q11, Q17, Q18 and Q21 at SF 0.01 on the card equal the numpy
    oracle (Q11 and Q18 with values that select rows at this scale)."""
    _need_cuda()
    import duckdb_tpu_torch
    from duckdb_tpu_torch.testing import tpch_oracle
    from duckdb_tpu_torch.testing.tpch_gen import write_tables

    write_tables(str(tmp_path), 0.01, seed=7)
    con = duckdb_tpu_torch.connect()
    con.load_tpch(str(tmp_path))
    params = {"q11": ("GERMANY", "JAPAN", {"nation": "JAPAN"}),
              "q18": ("> 300", "> 250", {"threshold": 250})}
    for name, sql in tpch_oracle.SUBQUERY_QUERIES.items():
        old, new, kw = params.get(name, ("", "", {}))
        got = con.sql(sql.replace(old, new) if old else sql).rows()
        want = tpch_oracle.answer(name, str(tmp_path), **kw)
        assert want and got == want, name


@pytest.mark.gpu
@pytest.mark.parametrize("sql,route", [
    # duplicate build keys and NULL keys on both sides: the sorted path
    ("SELECT count(*), count(y), sum(tp.v), sum(y) FROM tp LEFT JOIN tbn ON x = y",
     "eager_left"),
    ("SELECT x, tp.v, y, tbn.v FROM tp LEFT JOIN tbn ON x = y AND tbn.v < tp.v "
     "ORDER BY tp.v, x, y, tbn.v LIMIT 300", "eager_left"),
    # unique build keys: the direct-address path keeps the probe's shape
    ("SELECT count(*), count(y), sum(y) FROM tp LEFT JOIN tu ON x = y AND tu.v > 40",
     "eager_left"),
    # a full join: unmatched build rows (a NULL key's too) marked on the card
    ("SELECT count(*), count(x), count(y), sum(x), sum(y) FROM tp FULL JOIN tbn "
     "ON x = y AND tbn.v < tp.v", "eager_full"),
    ("SELECT count(*), count(x), count(y) FROM tp FULL JOIN tu ON x = y", "eager_full"),
    # a correlated count through a left join
    ("SELECT count(*), sum(x) FROM tp WHERE 0 = (SELECT count(*) FROM tbn WHERE y = x)",
     "eager_left"),
])
def test_outer_joins_on_cuda_match_cpu(sql, route):
    """Left and full joins on the card equal the CPU's, with duplicate build
    keys and NULL keys on both sides."""
    _need_cuda()
    import numpy as np

    from duckdb_tpu_torch.catalog.catalog import ColumnDef, TableEntry
    from duckdb_tpu_torch.types import BIGINT

    cpu, cuda = _membership_connections()
    keys = np.random.default_rng(5).permutation(20_000).astype(np.int64) * 2
    for con in (cpu, cuda):
        entry = TableEntry("tu", [ColumnDef("y", BIGINT), ColumnDef("v", BIGINT)])
        entry.nrows = len(keys)
        entry.set_host_column("y", keys)
        entry.set_host_column("v", np.arange(len(keys), dtype=np.int64) % 97)
        con.catalog.create_table(entry)
    want = cpu.sql(sql).rows()
    cuda.routes.clear()
    got = cuda.sql(sql).rows()
    assert got == want
    assert cuda.routes.get(route) == 1, dict(cuda.routes)


@pytest.mark.gpu
def test_from_queries_on_cuda(tmp_path):
    """Q7, Q8, Q15, Q19 and q13_nolike at SF 0.01 on the card equal the
    numpy oracle (Q8's share within 1e-9 relative)."""
    _need_cuda()
    import duckdb_tpu_torch
    from duckdb_tpu_torch.testing import tpch_oracle
    from duckdb_tpu_torch.testing.tpch_gen import write_tables

    write_tables(str(tmp_path), 0.01, seed=7)
    con = duckdb_tpu_torch.connect()
    con.load_tpch(str(tmp_path))
    for name, sql in tpch_oracle.FROM_QUERIES.items():
        got = con.sql(sql).rows()
        want = tpch_oracle.answer(name, str(tmp_path))
        assert len(got) == len(want) and want, name
        for g, w in zip(got, want):
            assert g == pytest.approx(w, rel=1e-9) if name == "q08" else g == w, name


@pytest.mark.gpu
def test_materialized_cte_stays_on_cuda(tmp_path):
    """A CTE referenced twice runs once into a hidden table whose columns
    are on the card; Q15 written so equals the oracle's Q15."""
    _need_cuda()
    import duckdb_tpu_torch
    from duckdb_tpu_torch.testing import tpch_oracle
    from duckdb_tpu_torch.testing.tpch_gen import write_tables

    write_tables(str(tmp_path), 0.01, seed=7)
    con = duckdb_tpu_torch.connect()
    con.load_tpch(str(tmp_path))
    sql = """
WITH revenue AS (
  SELECT l_suppkey AS supplier_no, sum(l_extendedprice * (1 - l_discount)) AS total_revenue
  FROM lineitem
  WHERE l_shipdate >= CAST('1996-01-01' AS date) AND l_shipdate < CAST('1996-04-01' AS date)
  GROUP BY supplier_no)
SELECT s_suppkey, s_name, s_address, s_phone, total_revenue
FROM supplier, revenue
WHERE s_suppkey = supplier_no AND total_revenue = (SELECT max(total_revenue) FROM revenue)
ORDER BY s_suppkey"""
    con.routes.clear()
    assert con.sql(sql).rows() == tpch_oracle.answer("q15", str(tmp_path))
    assert con.routes.get("cte_materialized") == 1
    (hidden,) = [n for n in con.catalog.tables if n.startswith("__cte_revenue_")]
    entry = con.catalog.get_table(hidden)
    assert all(entry.device_column(c.name).data.is_cuda for c in entry.columns)


@pytest.mark.gpu
def test_like_matcher_on_cuda_matches_cpu(tmp_path):
    """The dictionary LIKE matcher on the card equals its CPU run (and so
    Python re, which tests/test_torch_like.py holds the CPU run to) on
    o_comment and ps_comment at SF 0.01 and a hand-built dictionary with
    LIKE's special characters in its values; the LUT stays on the card."""
    _need_cuda()
    import numpy as np

    import duckdb_tpu_torch
    from duckdb_tpu_torch.ops import strings as TS
    from duckdb_tpu_torch.testing.tpch_gen import write_tables

    write_tables(str(tmp_path), 0.01, seed=7)
    con = duckdb_tpu_torch.connect(device="cpu")
    con.load_tpch(str(tmp_path))
    rng = np.random.default_rng(3)
    hand = np.array(sorted({"".join(rng.choice(list("abcXYZ09 %_\\"), size=int(n)))
                            for n in rng.integers(0, 20, 6000)}), dtype=object)
    dicts = [con.catalog.get_table("orders").host_column("o_comment")[2],
             con.catalog.get_table("partsupp").host_column("ps_comment")[2], hand]
    for dvals in dicts:
        for pattern in ("%special%requests%", "a%", "%s", "%a_b%", "_", "", "%",
                        "%\\%%", "%\\_%", "x" * 300):
            for ci in (False, True):
                got = TS.device_like_lut(dvals, pattern, ci, torch.device("cuda"))
                assert got.is_cuda
                want = TS.device_like_lut(dvals, pattern, ci, "cpu")
                assert torch.equal(got.cpu(), want), (pattern, ci)


@pytest.mark.gpu
def test_like_queries_on_cuda(tmp_path):
    """Q2, Q9, Q13, Q14, Q16 and Q20 at SF 0.01 on the card equal the numpy
    oracle (Q14's share within 1e-9 relative), and count/sum/avg DISTINCT
    on the card equal the CPU's."""
    _need_cuda()
    import duckdb_tpu_torch
    from duckdb_tpu_torch.testing import tpch_oracle
    from duckdb_tpu_torch.testing.tpch_gen import write_tables

    write_tables(str(tmp_path), 0.01, seed=7)
    con = duckdb_tpu_torch.connect()
    con.load_tpch(str(tmp_path))
    for name, sql in tpch_oracle.LIKE_QUERIES.items():
        got = con.sql(sql).rows()
        want = tpch_oracle.answer(name, str(tmp_path))
        assert len(got) == len(want) and want, name
        for g, w in zip(got, want):
            assert g == pytest.approx(w, rel=1e-9) if name == "q14" else g == w, name
    cpu = duckdb_tpu_torch.connect(device="cpu")
    cpu.load_tpch(str(tmp_path))
    for sql in (
            "SELECT l_returnflag, count(DISTINCT l_suppkey), sum(DISTINCT l_quantity), "
            "avg(DISTINCT l_discount), count(DISTINCT l_shipmode) FROM lineitem "
            "GROUP BY l_returnflag ORDER BY l_returnflag",
            "SELECT c_custkey, count(DISTINCT o_orderpriority), sum(DISTINCT o_totalprice) "
            "FROM customer LEFT JOIN orders ON c_custkey = o_custkey "
            "WHERE c_custkey < 300 GROUP BY c_custkey ORDER BY c_custkey",
            "SELECT CAST(o_custkey % 7 AS DOUBLE) AS g, count(DISTINCT o_orderpriority) "
            "FROM orders GROUP BY g ORDER BY g"):
        assert con.sql(sql).rows() == cpu.sql(sql).rows(), sql


@pytest.mark.gpu
def test_string_plane_ops_on_cuda_match_host(tmp_path):
    """Every plane op of ops/strings on the card equals its host function
    (testing/plane_checks) over c_phone, c_comment, p_name and o_comment at
    SF 0.01, and a transform's LUT stays on the card."""
    _need_cuda()
    import duckdb_tpu_torch
    from duckdb_tpu_torch.ops import strings as TS
    from duckdb_tpu_torch.testing import plane_checks
    from duckdb_tpu_torch.testing.tpch_gen import write_tables

    write_tables(str(tmp_path), 0.01, seed=7)
    con = duckdb_tpu_torch.connect(device="cpu")
    con.load_tpch(str(tmp_path))
    for table, col in (("customer", "c_phone"), ("customer", "c_comment"),
                       ("part", "p_name"), ("orders", "o_comment")):
        dvals = con.catalog.get_table(table).host_column(col)[2]
        assert plane_checks.check_dictionary(dvals, torch.device("cuda")) == [], col
        remap, _ = TS.device_transform_lut(dvals, "gpu:upper",
                                           lambda p, le: TS.op_case(p, le, True),
                                           torch.device("cuda"))
        assert remap.is_cuda


@pytest.mark.gpu
def test_general_aggregates_on_cuda_match_cpu(tmp_path, monkeypatch):
    """The general aggregate path on the card equals its CPU run (DOUBLE
    within 1e-9 relative: the card's float sums take another order), and
    Q6, Q22 (its substring on the plane path) and the general-aggregate
    query equal the numpy oracle there."""
    _need_cuda()
    import duckdb_tpu_torch
    from duckdb_tpu_torch.ops import strings as TS
    from duckdb_tpu_torch.testing import tpch_oracle
    from duckdb_tpu_torch.testing.tpch_gen import write_tables

    write_tables(str(tmp_path), 0.01, seed=7)
    monkeypatch.setattr(TS, "DEVICE_STR_MIN_DICT", 100)
    con = duckdb_tpu_torch.connect()
    con.load_tpch(str(tmp_path))
    cpu = duckdb_tpu_torch.connect(device="cpu")
    cpu.load_tpch(str(tmp_path))

    def same(got, want):
        assert len(got) == len(want) and want
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                if isinstance(b, float) and b == b:
                    assert a == pytest.approx(b, rel=1e-9, abs=0.0), (g, w)
                elif isinstance(b, float):
                    assert a != a, (g, w)
                else:
                    assert a == b and type(a) is type(b), (g, w)

    aggs = ("stddev_samp(o_totalprice), var_pop(o_custkey), median(o_totalprice), "
            "quantile_disc(o_orderdate, 0.9), mode(o_orderstatus), "
            "first(o_orderkey ORDER BY o_totalprice DESC), last(o_orderkey), "
            "arg_max(o_comment, o_totalprice), bool_or(o_orderstatus = 'P'), "
            "product(1 + o_custkey % 3) FILTER (WHERE o_orderkey < 300), "
            "count(*) FILTER (WHERE o_totalprice > 150000), min(o_comment), "
            "max(o_clerk), corr(o_totalprice, o_custkey), skewness(o_totalprice), "
            "entropy(o_orderstatus), mad(o_totalprice), count(DISTINCT o_custkey)")
    for sql in (f"SELECT o_orderpriority, {aggs} FROM orders GROUP BY 1 ORDER BY 1",
                f"SELECT CAST(o_custkey % 5 AS DOUBLE) AS g, {aggs} FROM orders "
                "GROUP BY g ORDER BY g",
                f"SELECT {aggs} FROM orders",
                f"SELECT c_nationkey, {aggs} FROM customer LEFT JOIN orders "
                "ON c_custkey = o_custkey AND o_totalprice > 400000 GROUP BY 1 ORDER BY 1",
                "SELECT substring(o_comment, 1, 1) AS k, count(*), median(o_totalprice) "
                "FROM orders GROUP BY k ORDER BY k"):
        same(con.sql(sql).rows(), cpu.sql(sql).rows())
    TS.host_loop_events.clear()
    for name, sql in tpch_oracle.GENERAL_QUERIES.items():
        same(con.sql(sql).rows(), tpch_oracle.answer(name, str(tmp_path)))
    assert TS.host_loop_events == []


@pytest.mark.gpu
def test_hash64_and_new_plane_ops_on_cuda_match_cpu():
    """hash64 and clz64 on the card equal the CPU's bit for bit, over
    negative, zero and wrapping values; the plane ops of the function
    library equal their CPU results on a ragged seeded plane."""
    _need_cuda()
    from duckdb_tpu_torch.ops import hash as TH
    from duckdb_tpu_torch.ops import strings as TS

    gen = torch.Generator().manual_seed(11)
    x = torch.randint(-(2**63), 2**63 - 1, (1 << 20,), generator=gen, dtype=torch.int64)
    x[:4] = torch.tensor([0, -1, 2**63 - 1, -(2**63)])
    assert torch.equal(TH.hash64(x.cuda()).cpu(), TH.hash64(x))
    assert torch.equal(TH.clz64(x.cuda()).cpu(), TH.clz64(x))
    lens = torch.randint(0, 33, (4096,), generator=gen)
    plane = torch.randint(32, 127, (4096, 32), generator=gen, dtype=torch.int64).to(torch.uint8)
    plane = torch.where(torch.arange(32)[None, :] < lens[:, None], plane, 0)
    for op, args in (("op_initcap", ()), ("op_reverse", ()), ("op_left", (5,)),
                     ("op_left", (-3,)), ("op_right", (4,)), ("op_right", (-2,)),
                     ("op_pad", (12, "*", True)), ("op_pad", (40, "xy", False)),
                     ("op_repeat", (3,)), ("op_strpos", ("a",)), ("op_ascii", ())):
        got = getattr(TS, op)(plane.cuda(), lens.cuda(), *args)
        want = getattr(TS, op)(plane, lens, *args)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert g.is_cuda and torch.equal(g.cpu(), w), op


@pytest.mark.gpu
def test_bit_and_hll_aggregates_on_cuda_match_cpu(tmp_path):
    """bit_and/bit_or/bit_xor and approx_count_distinct on the card equal
    the port's CPU run exactly, grouped (perfect, sort-group, more than
    2,048 groups) and ungrouped, over NULLs."""
    _need_cuda()
    import duckdb_tpu_torch
    from duckdb_tpu_torch.testing.tpch_gen import write_tables

    write_tables(str(tmp_path), 0.01, seed=7)
    con = duckdb_tpu_torch.connect()
    con.load_tpch(str(tmp_path))
    cpu = duckdb_tpu_torch.connect(device="cpu")
    cpu.load_tpch(str(tmp_path))
    for sql in (
            "SELECT bit_and(o_custkey), bit_or(o_custkey), bit_xor(o_orderkey), "
            "approx_count_distinct(o_custkey), approx_count_distinct(o_comment) FROM orders",
            "SELECT o_orderstatus, bit_and(o_custkey - 700), bit_or(-o_orderkey), "
            "bit_xor(CASE WHEN o_orderkey % 3 = 0 THEN NULL ELSE o_custkey END), "
            "approx_count_distinct(o_totalprice) FROM orders GROUP BY 1 ORDER BY 1",
            "SELECT o_orderpriority, o_orderstatus, bit_xor(hash(o_custkey)), "
            "approx_count_distinct(o_clerk) FROM orders GROUP BY 1, 2 ORDER BY 1, 2",
            "SELECT o_orderkey, approx_count_distinct(o_custkey) FROM orders "
            "GROUP BY o_orderkey ORDER BY o_orderkey"):
        assert con.sql(sql).rows() == cpu.sql(sql).rows(), sql


@pytest.mark.gpu
def test_function_queries_on_cuda(tmp_path, monkeypatch):
    """The four FUNCTION_QUERIES on the card equal the numpy oracle (DOUBLE
    within 1e-9 relative), with the string functions on the plane path and
    none as a host loop, and SELECT without FROM gives DuckDB's answers."""
    _need_cuda()
    import duckdb_tpu_torch
    from duckdb_tpu_torch.ops import strings as TS
    from duckdb_tpu_torch.testing import tpch_oracle
    from duckdb_tpu_torch.testing.tpch_gen import write_tables

    write_tables(str(tmp_path), 0.01, seed=7)
    monkeypatch.setattr(TS, "DEVICE_STR_MIN_DICT", 100)
    con = duckdb_tpu_torch.connect()
    con.load_tpch(str(tmp_path))
    TS.host_loop_events.clear()
    for name, sql in tpch_oracle.FUNCTION_QUERIES.items():
        got, want = con.sql(sql).rows(), tpch_oracle.answer(name, str(tmp_path))
        assert len(got) == len(want) and want
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                if isinstance(b, float):
                    assert a == pytest.approx(b, rel=1e-9, abs=0.0), (name, g, w)
                else:
                    assert a == b, (name, g, w)
    assert TS.host_loop_events == []
    assert con.sql("SELECT greatest(1, NULL, 3), -7 % 3, -7 // 2, "
                   "TRY_CAST('1e309' AS DOUBLE)").rows() == [(3, -1, -3, None)]


@pytest.mark.gpu
def test_nested_queries_on_cuda(tmp_path):
    """The five NESTED_QUERIES on the card equal the numpy oracle, and the
    nested constants and casts give DuckDB's answers there."""
    _need_cuda()
    import duckdb_tpu_torch
    from duckdb_tpu_torch.testing import tpch_oracle
    from duckdb_tpu_torch.testing.tpch_gen import write_tables

    write_tables(str(tmp_path), 0.01, seed=7)
    con = duckdb_tpu_torch.connect()
    con.load_tpch(str(tmp_path))
    for name, sql in tpch_oracle.NESTED_QUERIES.items():
        assert con.sql(sql).rows() == tpch_oracle.answer(name, str(tmp_path)), name
    assert con.sql("SELECT [{'a': 1}], CAST('[1, 2, NULL]' AS INTEGER[]), "
                   "CAST([1,2] AS VARCHAR), list_reduce([1, 2, 3], (a, x) -> a + x)").rows() \
        == [([{"a": 1}], [1, 2, None], "[1, 2]", 6)]


@pytest.mark.gpu
def test_nested_values_on_cuda_match_cpu(tmp_path):
    """Lambdas over per-order lists, ListPack, UNNEST, ORDER BY a list and
    every nested-result aggregate on the card equal the port's CPU run."""
    _need_cuda()
    import duckdb_tpu_torch
    from duckdb_tpu_torch.testing.tpch_gen import write_tables

    write_tables(str(tmp_path), 0.01, seed=7)
    con = duckdb_tpu_torch.connect()
    con.load_tpch(str(tmp_path))
    cpu = duckdb_tpu_torch.connect(device="cpu")
    cpu.load_tpch(str(tmp_path))
    for sql in (
            "SELECT o_custkey, list_reduce(l, lambda a, x: a + x), list_transform(l, "
            "lambda x, i: x * i), list_filter(l, x -> x % 3 = 0), list_sort(l) FROM "
            "(SELECT o_custkey, list(o_orderkey ORDER BY o_totalprice) AS l FROM orders "
            "WHERE o_custkey < 300 GROUP BY 1) ORDER BY l",
            "SELECT p_size, sum(list_value(p_partkey, p_size)[1]), min(string_split(p_name, ' ')) "
            "FROM part GROUP BY 1 ORDER BY 1",
            "SELECT unnest(string_split(p_type, ' ')) AS w, p_partkey FROM part "
            "WHERE p_partkey < 300 ORDER BY 2, 1",
            "SELECT n_regionkey, list(n_name ORDER BY n_name DESC), string_agg(n_name, ',' "
            "ORDER BY n_nationkey), histogram(n_nationkey % 3), approx_top_k(n_nationkey % 4, 2), "
            "bitstring_agg(n_nationkey), list(DISTINCT n_nationkey % 2), "
            "histogram_exact(n_nationkey % 4, [0, 1]) FROM nation GROUP BY 1 ORDER BY 1",
            "SELECT list(o_orderkey) FILTER (WHERE o_orderkey % 5 = 0), "
            "histogram(o_orderstatus) FROM orders"):
        assert con.sql(sql).rows() == cpu.sql(sql).rows(), sql


def _close_rows(got, want, what):
    assert len(got) == len(want) and want, what
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=1e-9, abs=1e-12), (what, g, w)
            else:
                assert a == b, (what, g, w)


@pytest.mark.gpu
def test_more_queries_on_cuda(tmp_path):
    """The five MORE_QUERIES on the card equal the numpy oracle (DOUBLE
    within 1e-9 relative: more_math's transcendental functions)."""
    _need_cuda()
    import duckdb_tpu_torch
    from duckdb_tpu_torch.testing import tpch_oracle
    from duckdb_tpu_torch.testing.tpch_gen import write_tables

    write_tables(str(tmp_path), 0.01, seed=7)
    con = duckdb_tpu_torch.connect()
    con.load_tpch(str(tmp_path))
    for name, sql in tpch_oracle.MORE_QUERIES.items():
        _close_rows(con.sql(sql).rows(), tpch_oracle.answer(name, str(tmp_path)), name)


@pytest.mark.gpu
def test_list_vector_math_on_cuda_matches_cpu(tmp_path):
    """The list vector functions reduce over the flattened elements on the
    card; they equal the CPU run, over constants and a columnar list."""
    _need_cuda()
    import duckdb_tpu_torch
    from duckdb_tpu_torch.testing.tpch_gen import write_tables

    write_tables(str(tmp_path), 0.01, seed=7)
    con = duckdb_tpu_torch.connect()
    con.load_tpch(str(tmp_path))
    cpu = duckdb_tpu_torch.connect(device="cpu")
    cpu.load_tpch(str(tmp_path))
    for sql in (
            "SELECT p_partkey, list_dot_product(v, [1, 2]), list_distance(v, [10, 3]), "
            "list_cosine_similarity(v, [1, 1]), list_cosine_distance(v, v), "
            "list_negative_inner_product(v, [2, 5]), v <-> [0, 0] FROM (SELECT p_partkey, "
            "list_value(p_size, p_partkey % 7) AS v FROM part) ORDER BY 1",
            "SELECT list_distance([1, 2, 3], [1, 2, 5]), list_inner_product([1.5, 2.0], "
            "[2.0, 4.0]), array_cross_product([1, 2, 3], [4, 5, 6])"):
        _close_rows(con.sql(sql).rows(), cpu.sql(sql).rows(), sql)


@pytest.mark.gpu
def test_per_distinct_hash_lut_on_cuda_matches_cpu(tmp_path):
    """A per-distinct hash (sha256, md5_number) is computed once per
    dictionary value, its lookup table on the card; the gathered rows equal
    the CPU run's, and a second run reads the cached table."""
    _need_cuda()
    import duckdb_tpu_torch
    from duckdb_tpu_torch.ops import strings as TS
    from duckdb_tpu_torch.testing.tpch_gen import write_tables

    write_tables(str(tmp_path), 0.01, seed=7)
    con = duckdb_tpu_torch.connect()
    con.load_tpch(str(tmp_path))
    cpu = duckdb_tpu_torch.connect(device="cpu")
    cpu.load_tpch(str(tmp_path))
    sql = ("SELECT p_partkey, sha256(p_name), md5_number(p_type), to_base64(p_name::BLOB), "
           "jaccard(p_name, 'almond') FROM part ORDER BY 1")
    got = con.sql(sql).rows()
    _close_rows(got, cpu.sql(sql).rows(), sql)
    cached = len(TS._LUT_CACHE)
    assert con.sql(sql).rows() == got and len(TS._LUT_CACHE) == cached
    assert any(isinstance(v[1], torch.Tensor) and v[1].device.type == "cuda"
               for v in TS._LUT_CACHE.values())


@pytest.mark.gpu
def test_range_on_cuda(tmp_path):
    """range()'s column is made on the card; its sum equals numpy's."""
    _need_cuda()
    import numpy as np

    import duckdb_tpu_torch

    con = duckdb_tpu_torch.connect()
    sql = "SELECT count(*), sum(range), max(range) FROM range(3, 5000003, 7)"
    want = np.arange(3, 5_000_003, 7, dtype=np.int64)
    assert con.sql(sql).rows() == [(len(want), int(want.sum()), int(want.max()))]
    entry = con.catalog.get_table(con._plan_tables[sql][0])
    assert entry.device_column("range").data.device.type == "cuda"


@pytest.mark.gpu
def test_rollup_on_cuda_launches_kernel_equal_to_plain(tmp_path, monkeypatch):
    """A ROLLUP over a generated table on the card: each branch's dense
    aggregate launches the grouped sum, which equals its plain version on
    that branch's inputs, and the rows equal the numpy oracle."""
    _need_cuda()
    import duckdb_tpu_torch
    from duckdb_tpu_torch.ops import grouped as grouped_mod
    from duckdb_tpu_torch.testing import tpch_oracle
    from duckdb_tpu_torch.testing.tpch_gen import write_tables

    write_tables(str(tmp_path), 0.01, seed=7)
    con = duckdb_tpu_torch.connect()
    con.load_tpch(str(tmp_path))
    seen = []

    def recording(dense, vectors, nseg):
        seen.append((dense.clone(), [v.clone() for v in vectors], nseg))
        return GS.grouped_sum_i64(dense, vectors, nseg)

    monkeypatch.setattr(grouped_mod, "grouped_sum_i64", recording)
    GS.grouped_sum_i64.launches = 0
    got = con.sql(tpch_oracle.SELECT_FORM_QUERIES["rollup_q1"]).rows()
    _close_rows(got, tpch_oracle.answer("rollup_q1", str(tmp_path)), "rollup_q1")
    assert len(seen) == 3 and GS.grouped_sum_i64.launches >= 3
    for dense, vecs, nseg in seen:
        assert dense.device.type == "cuda"
        for a, b in zip(GS.grouped_sum_i64(dense, vecs, nseg),
                        GS.grouped_sum_i64_plain(dense, vecs, nseg)):
            assert torch.equal(a, b)


@pytest.mark.gpu
def test_keyless_joins_on_cuda_match_cpu(tmp_path):
    """A keyless cross join, an inequality (band) join, an ASOF join and a
    FULL inequality join on CUDA tensors give the CPU port's rows."""
    _need_cuda()
    import duckdb_tpu_torch
    from duckdb_tpu_torch.testing import tpch_oracle
    from duckdb_tpu_torch.testing.tpch_gen import write_tables

    write_tables(str(tmp_path), 0.01, seed=7)
    con = duckdb_tpu_torch.connect()
    con.load_tpch(str(tmp_path))
    cpu = duckdb_tpu_torch.connect(device="cpu")
    cpu.load_tpch(str(tmp_path))
    for sql in ("SELECT r_name, count(*), sum(n_nationkey) FROM nation, region "
                "GROUP BY r_name ORDER BY 1",
                tpch_oracle.SELECT_FORM_QUERIES["band_join"],
                tpch_oracle.SELECT_FORM_QUERIES["asof_ship"],
                "SELECT count(*), count(a.n_name), count(b.n_name) FROM nation a FULL JOIN "
                "nation b ON a.n_nationkey < b.n_regionkey",
                "SELECT count(*) FROM orders WHERE o_custkey NOT IN (SELECT c_custkey FROM "
                "customer WHERE c_acctbal > o_totalprice)"):
        con.routes.clear()
        got = con.sql(sql).rows()
        assert got == cpu.sql(sql).rows(), sql
    assert con.sql("SELECT count(*) FROM lineitem TABLESAMPLE 10% REPEATABLE (3)").rows() == \
        con.sql("SELECT count(*) FROM lineitem TABLESAMPLE 10% REPEATABLE (3)").rows()


@pytest.mark.gpu
def test_select_forms_on_cuda(tmp_path):
    """Every SELECT_FORM_QUERIES query on the card equals the numpy oracle."""
    _need_cuda()
    import duckdb_tpu_torch
    from duckdb_tpu_torch.testing import tpch_oracle
    from duckdb_tpu_torch.testing.tpch_gen import write_tables

    write_tables(str(tmp_path), 0.01, seed=7)
    con = duckdb_tpu_torch.connect()
    con.load_tpch(str(tmp_path))
    for name, sql in tpch_oracle.SELECT_FORM_QUERIES.items():
        _close_rows(con.sql(sql).rows(), tpch_oracle.answer(name, str(tmp_path)), name)


@pytest.mark.gpu
def test_windows_on_cuda_match_cpu(tmp_path):
    """Ranking, running sums, framed min/max (the sparse table), RANGE
    frames (the bisection, INTERVAL offsets) and the holistics on CUDA
    tensors give the CPU port's rows; the WINDOW_QUERIES equal the numpy
    oracle."""
    _need_cuda()
    import duckdb_tpu_torch
    from duckdb_tpu_torch.testing import tpch_oracle
    from duckdb_tpu_torch.testing.tpch_gen import write_tables

    write_tables(str(tmp_path), 0.01, seed=7)
    con = duckdb_tpu_torch.connect()
    con.load_tpch(str(tmp_path))
    cpu = duckdb_tpu_torch.connect(device="cpu")
    cpu.load_tpch(str(tmp_path))
    for sql in (
            "SELECT l_orderkey, l_linenumber, rank() OVER (PARTITION BY l_orderkey ORDER BY "
            "l_extendedprice DESC), dense_rank() OVER (ORDER BY l_shipmode), row_number() OVER "
            "(PARTITION BY l_returnflag ORDER BY l_orderkey, l_linenumber) FROM lineitem",
            "SELECT o_orderkey, sum(o_totalprice) OVER (PARTITION BY o_orderpriority ORDER BY "
            "o_orderdate, o_orderkey), avg(o_totalprice) OVER (PARTITION BY o_orderstatus), "
            "min(o_orderdate) OVER (PARTITION BY o_custkey ORDER BY o_orderkey) FROM orders",
            "SELECT l_orderkey, l_linenumber, min(l_extendedprice) OVER (PARTITION BY l_suppkey "
            "ORDER BY l_orderkey, l_linenumber ROWS BETWEEN 3 PRECEDING AND 3 FOLLOWING), "
            "max(l_discount) OVER (PARTITION BY l_suppkey ORDER BY l_orderkey, l_linenumber ROWS "
            "BETWEEN 5 PRECEDING AND CURRENT ROW) FROM lineitem",
            "SELECT l_orderkey, l_linenumber, sum(l_quantity) OVER (PARTITION BY l_suppkey ORDER "
            "BY l_shipdate RANGE BETWEEN INTERVAL 30 DAY PRECEDING AND CURRENT ROW), count(*) "
            "OVER (PARTITION BY l_suppkey ORDER BY l_shipdate DESC RANGE BETWEEN INTERVAL 1 "
            "MONTH PRECEDING AND INTERVAL 2 DAY FOLLOWING) FROM lineitem",
            "SELECT p_partkey, median(p_retailprice) OVER (PARTITION BY p_brand), lag(p_name, 2, "
            "'none') OVER (ORDER BY p_partkey), ntile(7) OVER (PARTITION BY p_size ORDER BY "
            "p_partkey) FROM part",
            # DOUBLE running and span sums: log-step scans per partition,
            # held to the CPU within 1e-9 relative
            "SELECT l_orderkey, l_linenumber, sum(CAST(l_extendedprice AS DOUBLE)) OVER "
            "(PARTITION BY l_suppkey ORDER BY l_orderkey, l_linenumber), avg(CAST(l_tax AS "
            "DOUBLE)) OVER (PARTITION BY l_suppkey ORDER BY l_orderkey, l_linenumber ROWS BETWEEN "
            "20 PRECEDING AND 5 FOLLOWING) FROM lineitem"):
        got = sorted(con.sql(sql).rows())
        _close_rows(got, sorted(cpu.sql(sql).rows()), sql)
    for name, sql in tpch_oracle.WINDOW_QUERIES.items():
        _close_rows(con.sql(sql).rows(), tpch_oracle.answer(name, str(tmp_path)), name)


@pytest.mark.gpu
def test_chunked_aggregate_on_cuda(tmp_path):
    """Under a memory limit Q1 runs in chunks on the card, bit-identical to
    its run in memory."""
    _need_cuda()
    import chip_smoke
    import duckdb_tpu_torch
    from duckdb_tpu_torch.catalog import catalog as C
    from duckdb_tpu_torch.testing.tpch_gen import write_tables

    write_tables(str(tmp_path), 0.01, seed=7)
    con = duckdb_tpu_torch.connect()
    con.load_tpch(str(tmp_path))
    want = con.sql(chip_smoke.Q1).rows()
    C.set_memory_limit(2_000_000)
    try:
        con.routes.clear()
        got = con.sql(chip_smoke.Q1).rows()
    finally:
        C.set_memory_limit(0)
    assert got == want
    assert con.routes["out_of_core"] == 1 and con.routes["out_of_core_chunks"] >= 2


# -- multi-device execution (parallel/shard.py) ----------------------------------------
@pytest.mark.gpu
def test_kernel_on_every_card():
    """The grouped-sum kernel launched on each visible card reads that
    card's memory and writes its result there, equal to the plain version."""
    _need_cuda()
    gen = torch.Generator().manual_seed(31)
    for i in range(torch.cuda.device_count()):
        dev = torch.device("cuda", i)
        dense = torch.randint(-1, 22, (300_000,), generator=gen, dtype=torch.int32)
        vecs = [torch.randint(-(2**62), 2**62, (300_000,), generator=gen, dtype=torch.int64)
                for _ in range(5)]
        GS.grouped_sum_i64.launches = 0
        got = GS.grouped_sum_i64(dense.to(dev), [v.to(dev) for v in vecs], 20)
        torch.cuda.synchronize(dev)
        assert GS.grouped_sum_i64.launches == 1
        want = GS.grouped_sum_i64_plain(dense, vecs, 20)
        for g, w in zip(got, want):
            assert g.device == dev and torch.equal(g.cpu(), w)


def _graft_q1_inputs():
    import numpy as np

    rng = np.random.default_rng(0)
    n = 2048
    return [torch.from_numpy(x) for x in (
        rng.integers(1, 50, n) * 100, rng.integers(1000, 100000, n), rng.integers(0, 10, n),
        rng.integers(0, 8, n), rng.integers(0, 8, n).astype(np.int32), rng.random(n) < 0.95)]


def _sharded_q1_checks(n_shards, monkeypatch, tmp_path):
    """q1_local_partial and make_sharded_q1 over n_shards on the cards,
    then Q1 through SQL: equal to the CPU, one launch per shard, each on
    its shard's card."""
    import chip_smoke
    import duckdb_tpu_torch
    from duckdb_tpu_torch.ops import grouped as G
    from duckdb_tpu_torch.parallel import shard
    from duckdb_tpu_torch.testing.tpch_gen import write_tables

    ins = _graft_q1_inputs()
    want = shard.q1_local_partial(*ins, 8)
    mesh = shard.mesh_for(n_shards, "cuda")
    assert mesh.devices == [torch.device("cuda", i % torch.cuda.device_count())
                            for i in range(n_shards)]
    GS.grouped_sum_i64.launches = 0
    got = shard.make_sharded_q1(mesh, 8)(*(x.cuda() for x in ins))
    torch.cuda.synchronize()
    assert GS.grouped_sum_i64.launches == n_shards
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    assert all(torch.equal(g.cpu(), w) for g, w in zip(shard.q1_local_partial(
        *(x.cuda() for x in ins), 8), want))

    write_tables(str(tmp_path), 0.01, seed=7)
    cpu = duckdb_tpu_torch.connect(device="cpu")
    cpu.load_tpch(str(tmp_path))
    con = duckdb_tpu_torch.connect()
    con.load_tpch(str(tmp_path))
    con.sql(f"SET num_shards = {n_shards}")
    want_rows = cpu.sql(chip_smoke.Q1).rows()
    devices = []
    orig = G.grouped_sum_i64

    def on(dense, vectors, nseg):
        devices.append(dense.device)
        return orig(dense, vectors, nseg)

    monkeypatch.setattr(G, "grouped_sum_i64", on)
    GS.grouped_sum_i64.launches = 0
    con.routes.clear()
    rows = con.sql(chip_smoke.Q1).rows()
    assert rows == want_rows
    assert GS.grouped_sum_i64.launches == n_shards and devices == mesh.devices
    assert con.routes["sharded_agg"] == 1
    assert con.routes["sharded_shared_card" if mesh.shared else "sharded"] == 1
    return con, cpu


@pytest.mark.gpu
def test_sharded_q1_shards_share_one_card(monkeypatch, tmp_path):
    """Eight shards on however many cards (one card: all eight share it)."""
    _need_cuda()
    _sharded_q1_checks(8, monkeypatch, tmp_path)


@pytest.mark.gpu
def test_sharded_queries_across_two_cards(monkeypatch, tmp_path):
    """Two shards on two cards: Q1's kernel launches on each card, and the
    exchange joins, ORDER BY, TopN and windows equal the CPU's rows."""
    _need_cuda()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from duckdb_tpu_torch.parallel import shard
    from duckdb_tpu_torch.testing import tpch_oracle

    con, cpu = _sharded_q1_checks(2, monkeypatch, tmp_path)
    con.sql("SET exchange_join_threshold = 0")
    shard.COPIED["bytes"] = 0
    for sql in [tpch_oracle.QUERIES["q03"], tpch_oracle.QUERIES["q05"],
                "SELECT count(*), sum(o_totalprice) FROM orders LEFT JOIN customer "
                "ON o_custkey = c_custkey AND c_acctbal > 0",
                "SELECT l_orderkey, l_linenumber FROM lineitem ORDER BY l_extendedprice DESC, "
                "l_orderkey, l_linenumber",
                "SELECT l_orderkey, l_linenumber FROM lineitem ORDER BY l_extendedprice, "
                "l_orderkey LIMIT 30",
                "SELECT l_orderkey, l_linenumber, row_number() OVER (PARTITION BY l_orderkey "
                "ORDER BY l_linenumber), count(*) OVER (PARTITION BY l_orderkey), "
                "sum(l_quantity) OVER (PARTITION BY l_orderkey) FROM lineitem"]:
        con.routes.clear()
        got = con.sql(sql).rows()
        assert con.routes["sharded"] >= 1, (sql, dict(con.routes))
        _close_rows(got, cpu.sql(sql).rows(), sql)
    assert shard.COPIED["bytes"] > 0


# -- DDL, DML and transactions (api/ddl.py, api/dml.py) ----------------------------------
@pytest.mark.gpu
def test_dml_widens_an_int64_column_on_cuda():
    """An UPDATE past 2^31 of a BIGINT column narrowed to int32 on the card
    promotes it again at int64; the answers equal the CPU run's."""
    _need_cuda()
    import duckdb_tpu_torch

    script = ["CREATE TABLE t (k INT, v BIGINT)",
              "INSERT INTO t SELECT range, range * 3 FROM range(100000)",
              "SELECT sum(v), max(v) FROM t",
              "UPDATE t SET v = v + 3000000000 WHERE k % 1000 = 7",
              "SELECT sum(v), max(v), min(v) FROM t",
              "INSERT INTO t VALUES (-1, -5000000000)",
              "SELECT k % 4, sum(v) FROM t GROUP BY 1 ORDER BY 1"]
    con, cpu = duckdb_tpu_torch.connect(), duckdb_tpu_torch.connect(device="cpu")
    for sql in script:
        got, want = con.sql(sql), cpu.sql(sql)
        assert (got.rows() if got is not None else None) == \
            (want.rows() if want is not None else None), sql
        if sql.startswith("SELECT sum(v), max(v) FROM"):
            assert con.catalog.get_table("t").device_column("v").data.dtype == torch.int32
    col = con.catalog.get_table("t").device_column("v")
    assert col.data.device.type == "cuda" and col.data.dtype == torch.int64


@pytest.mark.gpu
def test_dml_varchar_insert_feeds_like_on_cuda(monkeypatch):
    """A VARCHAR INSERT builds a new dictionary; the LIKE after it runs on
    the card over the new dictionary (the matcher forced onto the device)
    and equals the CPU run."""
    _need_cuda()
    import duckdb_tpu_torch
    from duckdb_tpu_torch.ops import strings as TS

    monkeypatch.setattr(TS, "DEVICE_LIKE_MIN_DICT", 1)
    con, cpu = duckdb_tpu_torch.connect(), duckdb_tpu_torch.connect(device="cpu")
    script = ["CREATE TABLE w (k INT, s VARCHAR)",
              "INSERT INTO w SELECT range, 'item ' || range FROM range(5000)",
              "SELECT count(*) FROM w WHERE s LIKE '%7%'",
              "INSERT INTO w VALUES (9001, 'seven 7 new'), (9002, 'plain')",
              "SELECT count(*) FROM w WHERE s LIKE '%7%'",
              "SELECT k FROM w WHERE s LIKE 'seven%' OR s = 'plain' ORDER BY k"]
    for sql in script:
        TS.device_like_events.clear()
        got, want = con.sql(sql), cpu.sql(sql)
        assert (got.rows() if got is not None else None) == \
            (want.rows() if want is not None else None), sql
        if "LIKE" in sql:
            assert TS.device_like_events, sql  # the matcher ran on the card
    assert con.sql("SELECT count(*) FROM w WHERE s LIKE '%7%'").rows() == [(
        sum("7" in f"item {i}" for i in range(5000)) + 1,)]


@pytest.mark.gpu
def test_dml_rolled_back_delete_then_q1_on_cuda(tmp_path):
    """A DELETE rolled back leaves Q1 over the table as it was: Q1 runs
    through the grouped-sum kernel on the card and equals the CPU run."""
    _need_cuda()
    import chip_smoke
    import duckdb_tpu_torch
    from duckdb_tpu_torch.testing.tpch_gen import write_tables

    write_tables(str(tmp_path), 0.01, seed=7)
    q1 = chip_smoke.Q1.replace("FROM lineitem", "FROM li")
    answers = []
    for con in (duckdb_tpu_torch.connect(), duckdb_tpu_torch.connect(device="cpu")):
        con.load_tpch(str(tmp_path))
        con.sql("CREATE TABLE li AS SELECT * FROM lineitem")
        before = con.sql(q1).rows()
        con.sql("BEGIN")
        n = con.sql("DELETE FROM li WHERE l_linestatus = 'F'").rows()
        inside = con.sql(q1).rows()
        con.sql("ROLLBACK")
        GS.grouped_sum_i64.launches = 0
        after = con.sql(q1).rows()
        assert after == before and inside != before
        answers.append((before, n, inside, GS.grouped_sum_i64.launches))
    (gb, gn, gi, launches), (cb, cn, ci, _) = answers
    assert (gb, gn, gi) == (cb, cn, ci) and launches >= 1


@pytest.mark.gpu
def test_file_database_q1_on_cuda_after_reopen_and_recovery(tmp_path):
    """A file database written on the card: Q1 over the checkpointed and
    reopened lineitem, then over the WAL-recovered one, runs through the
    grouped-sum kernel and equals the CPU run over the same directory;
    random() and uuid() stored on the card replay equal on the CPU (the
    logged statement draws on the host)."""
    _need_cuda()
    import shutil

    import chip_smoke
    import duckdb_tpu_torch
    from duckdb_tpu_torch.api import connection as AC
    from duckdb_tpu_torch.testing.tpch_gen import write_tables

    data = str(tmp_path / "tpch")
    write_tables(data, 0.01, seed=7)
    db = str(tmp_path / "db")
    con = duckdb_tpu_torch.connect(db)
    con.load_tpch(data, tables=["lineitem"])
    con.sql("CHECKPOINT")
    con.sql("CREATE TABLE r AS SELECT range AS i, random() AS x, uuid() AS u FROM range(50)")
    stored = con.sql("SELECT * FROM r ORDER BY i").rows()
    shutil.copytree(db, str(tmp_path / "wal_copy"))  # as a crash leaves it: r in the WAL
    replayed = duckdb_tpu_torch.connect(str(tmp_path / "wal_copy"), device="cpu")
    assert replayed.sql("SELECT * FROM r ORDER BY i").rows() == stored
    replayed.close()
    con.close()
    answers = []
    for step in ("reopen", "recovered"):
        con = duckdb_tpu_torch.connect(db)
        if step == "recovered":
            con.sql("DELETE FROM lineitem WHERE l_orderkey % 3 = 0")
            del con
            AC._OPEN_DBS.clear()
            con = duckdb_tpu_torch.connect(db)
        GS.grouped_sum_i64.launches = 0
        got = con.sql(chip_smoke.Q1).rows()
        assert GS.grouped_sum_i64.launches >= 1
        con.close()
        copy = str(tmp_path / f"copy_{step}")
        shutil.copytree(db, copy)
        cpu = duckdb_tpu_torch.connect(copy, device="cpu")
        assert cpu.sql(chip_smoke.Q1).rows() == got
        assert cpu.sql("SELECT * FROM r ORDER BY i").rows() == stored
        cpu.close()
        answers.append(got)
    assert answers[0] != answers[1]


@pytest.mark.gpu
def test_q1_on_cuda_over_csv_and_parquet_files(tmp_path):
    """Q1 on the card over lineitem loaded by COPY FROM a CSV file, and over
    read_parquet of the file the port wrote, runs through the grouped-sum
    kernel and equals the CPU run over the same files; the committed
    pyarrow fixtures read on the card as on the CPU."""
    _need_cuda()
    import chip_smoke
    import duckdb_tpu_torch
    from duckdb_tpu_torch.catalog.tpch import TPCH_SCHEMA
    from duckdb_tpu_torch.testing.tpch_gen import write_tables

    data = str(tmp_path / "tpch")
    write_tables(data, 0.01, seed=7)
    src = duckdb_tpu_torch.connect(device="cpu")
    src.load_tpch(data, tables=["lineitem"])
    src.sql(f"COPY lineitem TO '{tmp_path}/li.csv' (HEADER)")
    src.sql(f"COPY lineitem TO '{tmp_path}/li.parquet' (FORMAT PARQUET)")
    cols = ", ".join(f"{n} {t!r}" for n, t in TPCH_SCHEMA["lineitem"])
    sources = {"copy": "lineitem", "parquet": f"read_parquet('{tmp_path}/li.parquet')"}
    answers = {}
    for device in ("cpu", "cuda"):
        con = duckdb_tpu_torch.connect(device=device)
        con.sql(f"CREATE TABLE lineitem ({cols})")
        con.sql(f"COPY lineitem FROM '{tmp_path}/li.csv' (HEADER)")
        for name, source in sources.items():
            GS.grouped_sum_i64.launches = 0
            got = con.sql(chip_smoke.Q1.replace("FROM lineitem", f"FROM {source}")).rows()
            if device == "cuda":
                assert GS.grouped_sum_i64.launches >= 1, name
                assert got == answers[name], name
            else:
                assert got == chip_smoke.numpy_q1(data)
                answers[name] = got
        for path, sql, want in chip_smoke.fixture_cases():
            assert con.sql(sql).rows() == want, path
        con.close()


@pytest.mark.gpu
def test_merge_and_alter_rename_then_q1_on_cuda(tmp_path):
    """A MERGE with all three clauses (phase 21's), an ALTER … RENAME COLUMN
    and Q1 written with the new name on the card: the Count and Q1 equal
    the CPU run's, Q1 through the grouped-sum kernel, and a second MERGE
    with a duplicate source row raises on the card as on the CPU."""
    _need_cuda()
    import chip_smoke
    import duckdb_tpu_torch
    from duckdb_tpu_torch.errors import InvalidInputException
    from duckdb_tpu_torch.testing.tpch_gen import write_tables

    write_tables(str(tmp_path), 0.01, seed=7)
    q1 = chip_smoke.Q1_ALTERED
    answers = []
    for con in (duckdb_tpu_torch.connect(), duckdb_tpu_torch.connect(device="cpu")):
        con.load_tpch(str(tmp_path))
        con.sql("CREATE TABLE li AS SELECT * FROM lineitem")
        con.sql("CREATE TABLE stg AS SELECT * FROM lineitem WHERE l_orderkey % 50 = 0")
        con.sql("UPDATE stg SET l_orderkey = l_orderkey + 6000000 WHERE l_orderkey % 100 = 50")
        count = con.sql(chip_smoke.MERGE_LI).rows()
        con.sql("ALTER TABLE li RENAME COLUMN l_quantity TO l_qty")
        GS.grouped_sum_i64.launches = 0
        rows = con.sql(q1).rows()
        launches = GS.grouped_sum_i64.launches
        con.sql("INSERT INTO stg SELECT * FROM stg LIMIT 1")
        with pytest.raises(InvalidInputException):
            con.sql(chip_smoke.MERGE_LI.replace("l_quantity = stg", "l_qty = stg"))
        assert con.sql(q1).rows() == rows
        answers.append((count, rows, launches))
    (gc, gr, launches), (cc, cr, _) = answers
    assert (gc, gr) == (cc, cr) and launches >= 1


@pytest.mark.gpu
def test_explain_analyze_and_capi_q1_on_cuda(tmp_path):
    """EXPLAIN ANALYZE of Q1 and Q1 through the C API (capi.cpp, loaded into
    this process) on the card: both give the CPU run's rows, both launch the
    grouped-sum kernel, and the kernel equals its plain version on each
    input it was given."""
    _need_cuda()
    import ctypes

    import chip_smoke
    import duckdb_tpu_torch
    import duckdb_tpu_torch.capi
    from duckdb_tpu_torch.ops import grouped as grouped_mod
    from duckdb_tpu_torch.testing.tpch_gen import write_tables

    write_tables(str(tmp_path / "data"), 0.01, seed=7)
    cpu = duckdb_tpu_torch.connect(device="cpu")
    cpu.load_tpch(str(tmp_path / "data"))
    want = cpu.sql(chip_smoke.Q1).rows()
    seen = []

    def recording(dense, vectors, nseg):
        seen.append((dense, list(vectors), nseg))
        return GS.grouped_sum_i64(dense, vectors, nseg)

    db_path = str(tmp_path / "db")
    con = duckdb_tpu_torch.connect(db_path)
    con.load_tpch(str(tmp_path / "data"), tables=["lineitem"])
    grouped_mod.grouped_sum_i64 = recording
    try:
        GS.grouped_sum_i64.launches = 0
        con.sql("EXPLAIN ANALYZE " + chip_smoke.Q1)
        assert con.last_profile.result.rows() == want
        assert GS.grouped_sum_i64.launches >= 1 and con.last_profile.root.cardinality == 4
        con.sql("CHECKPOINT")
        con.close()

        lib = duckdb_tpu_torch.capi.library()
        V, U = ctypes.c_void_p, ctypes.c_uint64

        class CResult(ctypes.Structure):
            _fields_ = [("internal_data", V)]

        lib.duckdb_open.argtypes = [ctypes.c_char_p, ctypes.POINTER(V)]
        lib.duckdb_connect.argtypes = [V, ctypes.POINTER(V)]
        lib.duckdb_query.argtypes = [V, ctypes.c_char_p, V]
        lib.duckdb_value_int64.argtypes, lib.duckdb_value_int64.restype = [V, U, U], ctypes.c_int64
        db, c, res = V(), V(), CResult()
        assert lib.duckdb_open(db_path.encode(), ctypes.byref(db)) == 0
        assert lib.duckdb_connect(db, ctypes.byref(c)) == 0
        GS.grouped_sum_i64.launches = 0
        assert lib.duckdb_query(c, chip_smoke.Q1.encode(), ctypes.byref(res)) == 0
        assert GS.grouped_sum_i64.launches >= 1
        assert [lib.duckdb_value_int64(ctypes.byref(res), 9, r) for r in range(4)] == \
            [r[9] for r in want]
        lib.duckdb_destroy_result(ctypes.byref(res))
        lib.duckdb_disconnect(ctypes.byref(c))
        lib.duckdb_close(ctypes.byref(db))
    finally:
        grouped_mod.grouped_sum_i64 = GS.grouped_sum_i64
    assert seen and all(d.device.type == "cuda" for d, _, _ in seen)
    for dense, vecs, nseg in seen:
        for g, w in zip(GS.grouped_sum_i64(dense, vecs, nseg),
                        GS.grouped_sum_i64_plain(dense, vecs, nseg)):
            assert torch.equal(g, w)


@pytest.mark.gpu
def test_fuzz_card_against_cpu_with_the_kernel_held_to_plain():
    """The grammar fuzzer's seed 1 × 100 on a card connection against a CPU
    connection (testing/fuzz.card_against_cpu, as phase 23 of chip_smoke
    runs it): no non-typed error, the same answers, and every grouped-sum
    launch of the card queries equal to the plain version."""
    _need_cuda()
    import duckdb_tpu_torch
    from duckdb_tpu_torch.ops import grouped as grouped_mod
    from duckdb_tpu_torch.testing import fuzz as FZ

    card = FZ.setup_connection(duckdb_tpu_torch.connect())
    cpu = FZ.setup_connection(duckdb_tpu_torch.connect(device="cpu"))
    recorded, kernel = [], GS.grouped_sum_i64

    def recording(dense, vectors, nseg):
        if dense.is_cuda:
            recorded.append((dense, list(vectors), nseg))
        return kernel(dense, vectors, nseg)

    def hold(i, sql):
        counted = kernel.launches
        try:
            for dense, vecs, nseg in recorded:
                for g, w in zip(kernel(dense, vecs, nseg),
                                GS.grouped_sum_i64_plain(dense, vecs, nseg)):
                    if not torch.equal(g, w):
                        return "grouped_sum_i64 differs from its plain version"
            return ""
        finally:
            recorded.clear()
            kernel.launches = counted

    grouped_mod.grouped_sum_i64 = recording
    kernel.launches = 0
    try:
        answered, refused, problems, _ = FZ.card_against_cpu(100, 1, card, cpu, after_card=hold)
    finally:
        grouped_mod.grouped_sum_i64 = kernel
    assert not problems, problems[:3]
    assert answered >= 20 and kernel.launches >= 1


_GLOO_CARD_WORKER = r"""
import sys
sys.path.insert(0, {root!r})
import numpy as np
import torch
from duckdb_tpu_torch.ops import grouped_sum as GS
from duckdb_tpu_torch.parallel import shard as TS
sys.path.insert(0, {root!r} + "/tests")
import test_torch_multihost as M  # by its file: another "tests" package may be installed

addr, rank = sys.argv[1], int(sys.argv[2])
mesh = TS.init_process_mesh("gloo", local=2, init_method="tcp://" + addr, world_size=2,
                            rank=rank)  # no device named: the card, shared by both ranks
assert mesh.staged and mesh.n == 4 and mesh.home == torch.device("cuda", 0), mesh
d = M.make_inputs()
dev = mesh.home

def h(x):
    return torch.from_numpy(np.ascontiguousarray(M.half(x, rank))).to(dev)

def r(x):
    return torch.from_numpy(M.rows_of(x, rank)).to(dev)

ins = [h(d[k]) for k in ("qty", "price", "disc", "tax", "gid", "q_live")]
GS.grouped_sum_i64.launches = 0
sums = TS.make_sharded_q1(mesh, 8)(*ins)
assert GS.grouped_sum_i64.launches >= 2, GS.grouped_sum_i64.launches
for i, shard in enumerate(zip(*(TS.split_rows(mesh, x) for x in ins))):
    g, vecs = TS.q1_partial_inputs(*shard, 8)
    for a, b in zip(GS.grouped_sum_i64(g, vecs, 8), GS.grouped_sum_i64_plain(g, vecs, 8)):
        assert torch.equal(a, b)
live = d["q_live"]
omd = d["price"] * (100 - d["disc"])
vals = [d["qty"], d["price"], omd, omd * (100 + d["tax"]), d["disc"], np.ones_like(d["qty"])]
want = [[int(v[live & (d["gid"] == g)].sum()) for g in range(8)] for v in vals]
assert torch.stack(sums).cpu().tolist() == want
j = TS.make_exchange_join(mesh)(h(d["pk"]), h(d["p_live"]), r(d["pk"]), h(d["bk"]),
                                h(d["b_live"]), r(d["bk"]))
lut = {{int(k): i for i, (k, lv) in enumerate(zip(d["bk"], d["b_live"])) if lv}}
for rp, br in zip(j.rp, j.br):
    assert rp.is_cuda
    for a, b in zip(rp.tolist(), br.tolist()):
        assert b == lut.get(int(d["pk"][a]), -1)
assert TS.COPIED["staged"] > 0
print(f"rank {{rank}} OK", flush=True)
"""


@pytest.mark.gpu
def test_two_gloo_processes_share_the_card(tmp_path):
    """Two gloo ranks × 2 shards on cuda:0 (parallel/shard.ProcessMesh, the
    collectives staged through the host): Q1's partial through the kernel
    on each shard (equal to the plain version) then all_reduce'd to numpy's
    sums, and the exchange join held to the host oracle."""
    _need_cuda()
    import os
    import socket
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    addr = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    script = tmp_path / "worker.py"
    script.write_text(_GLOO_CARD_WORKER.format(root=root))
    # one visible card: both ranks default to it
    card = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES=card)
    procs = [subprocess.Popen([sys.executable, str(script), addr, str(i)], cwd=root, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"rank {i} OK" in out, out[-3000:]


@pytest.mark.gpu
def test_arrow_round_trip_of_card_columns_through_the_ports_own_capsules(tmp_path):
    """A result of columns on the card through the port's Arrow export
    (api/arrow_interop.py over csrc/arrow_c.cpp, no pyarrow) and back by its
    own from_arrow, whole and in batches: Q1 over each import gives the CPU
    run's rows through the kernel, held to its plain version, and every
    Arrow struct is released."""
    _need_cuda()
    import gc

    import chip_smoke
    import duckdb_tpu_torch
    from duckdb_tpu_torch.api import arrow_interop as AI
    from duckdb_tpu_torch.ops import grouped as grouped_mod
    from duckdb_tpu_torch.testing.tpch_gen import write_tables

    write_tables(str(tmp_path / "data"), 0.01, seed=7)
    cpu = duckdb_tpu_torch.connect(device="cpu")
    cpu.load_tpch(str(tmp_path / "data"), tables=["lineitem"])
    want = cpu.sql(chip_smoke.Q1).rows()
    con = duckdb_tpu_torch.connect()
    con.load_tpch(str(tmp_path / "data"), tables=["lineitem"])
    res = con.sql("SELECT * FROM lineitem")
    assert con.catalog.get_table("lineitem").device_column("l_quantity").data.is_cuda
    con.from_arrow(res.arrow(), "whole")
    con.from_arrow(res.fetch_record_batch(7_000), "batched")
    seen = []

    def recording(dense, vectors, nseg):
        seen.append((dense, list(vectors), nseg))
        return GS.grouped_sum_i64(dense, vectors, nseg)

    grouped_mod.grouped_sum_i64 = recording
    try:
        for name in ("whole", "batched"):
            assert con.sql(chip_smoke.Q1.replace("FROM lineitem", f"FROM {name}")).rows() == want
    finally:
        grouped_mod.grouped_sum_i64 = GS.grouped_sum_i64
    assert len(seen) >= 2 and all(d.is_cuda for d, _, _ in seen)
    for dense, vecs, nseg in seen:
        for g, w in zip(GS.grouped_sum_i64(dense, vecs, nseg),
                        GS.grouped_sum_i64_plain(dense, vecs, nseg)):
            assert torch.equal(g, w)
    del res
    gc.collect()
    assert AI.live_structs() == 0


@pytest.mark.gpu
def test_capi_faults_c1_to_c5_on_the_card_machine():
    """C1-C5 through the C API library built on this machine, a database
    opened on the card (chip_smoke.capi_faults)."""
    _need_cuda()
    import chip_smoke
    import duckdb_tpu_torch.capi

    assert chip_smoke.capi_faults(duckdb_tpu_torch.capi.library()) == ""


@pytest.mark.gpu
def test_item49_and_f31_fixtures_on_cuda():
    """The nested, TIME, UINT64 and BLOB fixtures read on a card connection
    to their expected rows, a deeper nesting refused naming its column, and
    LIST and TIME columns written by COPY TO read back
    (chip_smoke.parquet_step)."""
    _need_cuda()
    import chip_smoke

    assert chip_smoke.parquet_step("the card") == ""


@pytest.mark.gpu
def test_frame_windows_on_cuda_match_cpu(tmp_path):
    """The wavelet matrix and the moment tree on CUDA tensors give the CPU's
    answers (kth and counts exactly, sums and moments within 1e-9), and the
    holistic windows over frames and DISTINCT over a frame on a card
    connection give the CPU port's rows."""
    _need_cuda()
    import numpy as np

    import duckdb_tpu_torch
    from duckdb_tpu_torch.ops.frame_stats import MomentTree, WaveletMatrix
    from duckdb_tpu_torch.testing.tpch_gen import write_tables

    rng = np.random.default_rng(0)
    n, bits = 100_003, 9
    keys = torch.from_numpy(rng.integers(0, 2 ** bits, n))
    wi, wf = torch.from_numpy(rng.integers(-1000, 1000, n)), torch.from_numpy(rng.normal(size=n))
    lo = torch.from_numpy(rng.integers(0, n, n))
    hi = torch.minimum(lo + torch.from_numpy(rng.integers(0, 700, n)), torch.tensor(n))
    k = (torch.rand(n, dtype=torch.float64) * (hi - lo)).floor().to(torch.int64)
    t = torch.from_numpy(rng.integers(0, 2 ** bits, n))
    answers = []
    for dev in ("cpu", "cuda"):
        wm = WaveletMatrix(keys.to(dev), bits, [wi.to(dev), wf.to(dev)])
        kth = wm.kth(lo.to(dev), hi.to(dev), k.to(dev))
        cnt, sums = wm.count_below(lo.to(dev), hi.to(dev), t.to(dev))
        tree = MomentTree(wf.to(dev) + 1e6, (wi > -800).to(dev), 11)
        mom = tree.query(lo.to(dev), hi.to(dev))
        answers.append([v.cpu() for v in (kth, cnt, *sums, *mom)])
    (c_kth, c_cnt, c_si, c_sf, *c_mom), (g_kth, g_cnt, g_si, g_sf, *g_mom) = answers
    assert torch.equal(c_kth, g_kth) and torch.equal(c_cnt, g_cnt) and torch.equal(c_si, g_si)
    assert torch.allclose(c_sf, g_sf, rtol=0, atol=1e-9)
    for a, b in zip(c_mom, g_mom):
        assert torch.allclose(a, b, rtol=1e-9, atol=1e-6)

    write_tables(str(tmp_path), 0.01, seed=7)
    con = duckdb_tpu_torch.connect()
    con.load_tpch(str(tmp_path))
    cpu = duckdb_tpu_torch.connect(device="cpu")
    cpu.load_tpch(str(tmp_path))
    for sql in (
            "SELECT l_orderkey, l_linenumber, median(l_extendedprice) OVER (PARTITION BY "
            "l_suppkey ORDER BY l_shipdate, l_orderkey, l_linenumber ROWS BETWEEN 5 PRECEDING "
            "AND 5 FOLLOWING), quantile_cont(l_quantity, 0.9) OVER (PARTITION BY l_partkey "
            "ORDER BY l_shipdate) FROM lineitem",
            "SELECT l_orderkey, l_linenumber, stddev_samp(l_discount) OVER (PARTITION BY "
            "l_suppkey ORDER BY l_shipdate RANGE BETWEEN INTERVAL '30 days' PRECEDING AND "
            "CURRENT ROW), var_pop(l_tax) OVER (PARTITION BY l_suppkey ORDER BY l_shipdate DESC) "
            "FROM lineitem",
            "SELECT l_orderkey, l_linenumber, count(DISTINCT l_quantity) OVER (PARTITION BY "
            "l_suppkey ORDER BY l_shipdate, l_orderkey, l_linenumber ROWS BETWEEN 10 PRECEDING "
            "AND CURRENT ROW), sum(DISTINCT l_quantity) OVER (PARTITION BY l_suppkey ORDER BY "
            "l_shipdate, l_orderkey, l_linenumber ROWS BETWEEN 10 PRECEDING AND CURRENT ROW) "
            "FROM lineitem",
            "SELECT p_partkey, median(p_name) OVER (PARTITION BY p_size ORDER BY p_partkey ROWS "
            "BETWEEN 2 PRECEDING AND 2 FOLLOWING) FROM part"):
        _close_rows(sorted(con.sql(sql).rows()), sorted(cpu.sql(sql).rows()), sql)


@pytest.mark.gpu
def test_h1_fetchone_and_h2_distinct_holistic_windows_on_cuda(tmp_path):
    """H1 and H2 on a card connection: fetchone() gives the CPU port's
    first row (None for an empty result); the eight holistic windows with
    DISTINCT over the whole partition, the default frame, frames from
    UNBOUNDED PRECEDING and moving frames give the CPU port's rows over
    lineitem at SF 0.01; and the wavelet matrix's `moments` and `filter`
    options give the CPU's answers on CUDA tensors."""
    _need_cuda()
    import numpy as np

    import duckdb_tpu_torch
    from duckdb_tpu_torch.ops.frame_stats import WaveletMatrix
    from duckdb_tpu_torch.testing.tpch_gen import write_tables

    rng = np.random.default_rng(1)
    n, bits, fbits = 50_001, 8, 7
    keys = torch.from_numpy(rng.integers(0, 2 ** bits, n))
    fkeys = torch.from_numpy(rng.integers(0, 2 ** fbits, n))
    x = torch.from_numpy(rng.normal(size=n) * 3 + 1e6)
    valid = torch.from_numpy(rng.random(n) < 0.9)
    lo = torch.from_numpy(rng.integers(0, n, n))
    hi = torch.minimum(lo + torch.from_numpy(rng.integers(0, 400, n)), torch.tensor(n))
    t = torch.from_numpy(rng.integers(0, 2 ** bits, n))
    ft = torch.from_numpy(rng.integers(0, 2 ** fbits - 1, n))
    k = (torch.rand(n, dtype=torch.float64) * (hi - lo) * 0.3).floor().to(torch.int64)
    answers = []
    for dev in ("cpu", "cuda"):
        wm = WaveletMatrix(keys.to(dev), bits, moments=(x.to(dev), valid.to(dev), 10),
                           filter=(fkeys.to(dev), fbits))
        mom = wm.moments_below(lo.to(dev), hi.to(dev), t.to(dev))
        kth = wm.kth(lo.to(dev), hi.to(dev), k.to(dev), ft.to(dev))
        answers.append([v.cpu() for v in (kth, *mom)])
    (c_kth, *c_mom), (g_kth, *g_mom) = answers
    assert torch.equal(c_kth, g_kth)
    for a, b in zip(c_mom, g_mom):
        assert torch.allclose(a, b, rtol=1e-9, atol=1e-6)

    write_tables(str(tmp_path), 0.01, seed=7)
    con = duckdb_tpu_torch.connect()
    con.load_tpch(str(tmp_path))
    cpu = duckdb_tpu_torch.connect(device="cpu")
    cpu.load_tpch(str(tmp_path))
    first = "SELECT l_orderkey, l_linenumber FROM lineitem ORDER BY l_orderkey DESC, 2"
    assert con.sql(first).fetchone() == cpu.sql(first).fetchone() is not None
    assert con.execute("SELECT 1 WHERE false").fetchone() is None
    part = "PARTITION BY l_suppkey"
    order = "ORDER BY l_shipdate, l_orderkey, l_linenumber"
    for over in (part, f"{part} {order}",
                 f"{part} {order} ROWS BETWEEN UNBOUNDED PRECEDING AND 3 FOLLOWING",
                 f"{part} {order} ROWS BETWEEN 10 PRECEDING AND CURRENT ROW",
                 f"{part} ORDER BY l_shipdate DESC RANGE BETWEEN INTERVAL '20 days' PRECEDING "
                 "AND CURRENT ROW"):
        sql = ("SELECT l_orderkey, l_linenumber, " + ", ".join(
            f"{fn} OVER ({over})" for fn in (
                "median(DISTINCT l_quantity)", "quantile_cont(DISTINCT l_discount, 0.25)",
                "stddev(DISTINCT l_extendedprice)", "stddev_samp(DISTINCT l_tax)",
                "stddev_pop(DISTINCT l_quantity)", "var_samp(DISTINCT l_discount)",
                "var_pop(DISTINCT l_tax)", "variance(DISTINCT l_quantity)")) + " FROM lineitem")
        _close_rows(sorted(con.sql(sql).rows()), sorted(cpu.sql(sql).rows()), sql)
