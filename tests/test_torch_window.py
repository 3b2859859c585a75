"""Window functions, QUALIFY and DISTINCT ON through duckdb_tpu_torch
(device="cpu"), against duckdb_tpu and, where the reference is at fault,
against DuckDB's answer.

Both packages load one directory of all eight tables written by the port's
seeded generator (duckdb_tpu_torch/testing/tpch_gen.py) at SF 0.01, seed 7;
the JAX connection runs with `SET pallas_grouped_sum = 'on'`. Small tables
come from VALUES (the port has no CREATE TABLE yet). DECIMAL, integer,
string, date and NULL values must match exactly, DOUBLE values within
1e-9 relative; rows are compared as multisets unless ORDER BY fixes their
order.

The reference's faults that the port does not copy are held to DuckDB:
- W1: DISTINCT ON is ignored (all 25 nations come back, not 5);
- W2: QUALIFY cannot read a select alias ("column rn not found");
- W3: median, quantile_cont, stddev and var with an ORDER BY or a frame
  answer over the whole partition; the port answers over each row's frame,
  as DuckDB does (tests/test_torch_frame_windows.py holds them to numpy);
- W4: stddev and var over a DECIMAL take its scaled integers (15.27… for
  1.0, 2.0, 4.0 where DuckDB gives 1.527…);
- W5: over 16,384 rows or more on several devices (tests/conftest.py gives
  the JAX package 8), a whole-partition count or sum goes through the
  reference's sharded window and comes out wrong (count(*) OVER (PARTITION
  BY l_orderkey) gives 7,787 for order 1's lines), so such windows are held
  to Python's counts; the sharded window is ROADMAP item 31;
- mean() over a window raises NotImplementedError in the reference; the
  port reads it as avg(), as DuckDB does.
"""

import datetime
import decimal
import statistics

import pytest
import torch

import duckdb_tpu
import duckdb_tpu_torch
from duckdb_tpu_torch.ops import grouped as grouped_mod
from duckdb_tpu_torch.planner.bound import BindError
from duckdb_tpu_torch.testing import tpch_oracle
from duckdb_tpu_torch.testing.tpch_gen import write_tables

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("tpch_gen_window")
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


def _key(row):
    return tuple((v is None, "" if v is None else repr(type(v)), v if v is not None else 0)
                 for v in row)


def assert_rows_match(got, want, ordered=False):
    if not ordered:
        got, want = sorted(got, key=_key), sorted(want, key=_key)
    assert len(got) == len(want), (got[:5], want[:5])
    for g_row, w_row in zip(got, want):
        assert len(g_row) == len(w_row)
        for g, w in zip(g_row, w_row):
            assert type(g) is type(w), (g_row, w_row)
            if isinstance(w, float):
                assert g == pytest.approx(w, rel=1e-9, abs=0.0), (g_row, w_row)
            else:
                assert g == w, (g_row, w_row)


# -- tests/test_window.py's sixteen queries, over VALUES -------------------------
T = "(VALUES ('a', 1), ('a', 2), ('a', 2), ('a', 5), ('b', 10), ('b', NULL), ('b', 3)) t(g, x)"
BASE_QUERIES = [
    f"SELECT g, x, row_number() OVER (PARTITION BY g ORDER BY x) FROM {T}",
    f"SELECT g, x, rank() OVER (PARTITION BY g ORDER BY x) FROM {T}",
    f"SELECT g, x, dense_rank() OVER (PARTITION BY g ORDER BY x) FROM {T}",
    f"SELECT g, x, sum(x) OVER (PARTITION BY g ORDER BY x) FROM {T}",
    f"SELECT g, x, sum(x) OVER (PARTITION BY g) FROM {T}",
    f"SELECT g, x, avg(x) OVER (PARTITION BY g ORDER BY x) FROM {T}",
    f"SELECT g, x, min(x) OVER (PARTITION BY g ORDER BY x) FROM {T}",
    f"SELECT g, x, max(x) OVER (PARTITION BY g ORDER BY x) FROM {T}",
    f"SELECT g, x, count(x) OVER (PARTITION BY g ORDER BY x) FROM {T}",
    f"SELECT g, x, lag(x) OVER (PARTITION BY g ORDER BY x) FROM {T}",
    f"SELECT g, x, lead(x, 1) OVER (PARTITION BY g ORDER BY x) FROM {T}",
    f"SELECT g, x, first_value(x) OVER (PARTITION BY g ORDER BY x) FROM {T}",
    f"SELECT g, x, last_value(x) OVER (PARTITION BY g ORDER BY x) FROM {T}",
    f"SELECT g, x, sum(x) OVER (PARTITION BY g ORDER BY x ROWS BETWEEN 1 PRECEDING AND "
    "CURRENT ROW) FROM {T}",
    f"SELECT g, x, sum(x) OVER (PARTITION BY g ORDER BY x ROWS BETWEEN UNBOUNDED PRECEDING "
    "AND 1 FOLLOWING) FROM {T}",
    f"SELECT g, x, row_number() OVER (ORDER BY x DESC NULLS LAST) FROM {T}",
]
BASE_QUERIES = [q.replace("{T}", T) for q in BASE_QUERIES]


@pytest.mark.parametrize("i", range(len(BASE_QUERIES)))
def test_window_queries_match_jax(cons, i):
    """The two ('a', 2) rows are peers, so a row_number may fall to either:
    rows are compared as multisets."""
    jcon, tcon = cons
    q = BASE_QUERIES[i] + " ORDER BY g, x NULLS LAST"
    assert_rows_match(tcon.sql(q).rows(), jcon.sql(q).rows())


# -- explicit ROWS and RANGE frames (tests/test_window.py's TestExplicitFrames:
# the expectations are DuckDB's) ----------------------------------------------------
WT = ("(VALUES (1, 1, 10), (1, 2, 20), (1, 2, 25), (1, 5, 50), (1, 9, 90), (2, 1, 5), "
      "(2, 3, 30), (2, 4, NULL), (2, 8, 80), (1, NULL, 7), (2, NULL, NULL)) wt(g, k, v)")
WD = ("(VALUES (1, 1.50::DECIMAL(8,2), 10), (1, 2.25, 20), (1, 2.80, 25), (1, 5.00, 50), "
      "(2, 0.10, 5), (2, 3.75, 30), (2, NULL, 9)) wd(g, k, v)")
WDT = ("(VALUES (DATE '2024-01-01', 1), (DATE '2024-01-03', 3), (DATE '2024-01-04', 4), "
       "(DATE '2024-01-10', 10)) wdt(k, v)")
FRAMES = {
    "range_sum_offsets": (f"SELECT g, k, v, sum(v) OVER (PARTITION BY g ORDER BY k RANGE BETWEEN "
                          f"2 PRECEDING AND 2 FOLLOWING) FROM {WT} ORDER BY g, k, v",
                          [55, 55, 55, 50, 90, 7, 35, 35, 30, 80, None]),
    "range_min_offsets": (f"SELECT g, k, v, min(v) OVER (PARTITION BY g ORDER BY k RANGE BETWEEN "
                          f"2 PRECEDING AND 2 FOLLOWING) FROM {WT} ORDER BY g, k, v",
                          [10, 10, 10, 50, 90, 7, 5, 5, 30, 80, None]),
    "rows_minmax_sliding": (f"SELECT g, k, v, min(v) OVER (PARTITION BY g ORDER BY k ROWS "
                            f"BETWEEN 2 PRECEDING AND CURRENT ROW) FROM {WT} ORDER BY g, k, v",
                            [10, 10, 10, 20, 25, 7, 5, 5, 5, 30, 80]),
    "range_desc": (f"SELECT g, k, v, sum(v) OVER (PARTITION BY g ORDER BY k DESC RANGE BETWEEN "
                   f"2 PRECEDING AND 2 FOLLOWING) FROM {WT} ORDER BY g, k, v",
                   [55, 55, 55, 50, 90, 7, 35, 35, 30, 80, None]),
    "range_following_only_empty_frames": (
        f"SELECT g, k, v, sum(v) OVER (PARTITION BY g ORDER BY k RANGE BETWEEN 1 FOLLOWING AND "
        f"3 FOLLOWING) FROM {WT} ORDER BY g, k, v",
        [45, 50, 50, None, None, 7, 30, None, None, None, None]),
    "framed_first_last_value": (
        f"SELECT g, k, v, last_value(v) OVER (PARTITION BY g ORDER BY k RANGE BETWEEN 2 "
        f"PRECEDING AND 1 FOLLOWING) FROM {WT} ORDER BY g, k, v",
        [25, 25, 25, 50, 90, 7, 5, None, None, 80, None]),
    "decimal_range_key": (f"SELECT g, k, sum(v) OVER (PARTITION BY g ORDER BY k RANGE BETWEEN "
                          f"1.0 PRECEDING AND 0.55 FOLLOWING) FROM {WD} ORDER BY g, k",
                          [10, 55, 45, 50, 5, 30, 9]),
    "date_range_key": (f"SELECT k, sum(v) OVER (ORDER BY k RANGE BETWEEN 2 PRECEDING AND 1 "
                       f"FOLLOWING) FROM {WDT} ORDER BY k", [1, 8, 7, 10]),
    "rows_preceding_only": (f"SELECT g, k, v, sum(v) OVER (PARTITION BY g ORDER BY k ROWS "
                            f"BETWEEN 2 PRECEDING AND 1 PRECEDING) FROM {WT} ORDER BY g, k, v",
                            [None, 10, 30, 45, 75, 140, None, 5, 35, 30, 80]),
}


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_explicit_frames(cons, name):
    """DuckDB's values in the last column, and the JAX package's rows."""
    jcon, tcon = cons
    sql, want = FRAMES[name]
    got = tcon.sql(sql).rows()
    assert [r[-1] for r in got] == want
    assert_rows_match(got, jcon.sql(sql).rows(), ordered=True)


def test_percent_rank_cume_dist_nth_value(cons):
    """The distribution functions and nth_value (the default peer-bounded
    frame and a ROWS frame), as tests/test_window.py holds the reference."""
    jcon, tcon = cons
    cases = {
        "SELECT v, percent_rank() OVER (ORDER BY v), cume_dist() OVER (ORDER BY v) FROM "
        "(SELECT unnest([10, 20, 20, 30]) AS v) ORDER BY v":
            [(10, 0.0, 0.25), (20, 1 / 3, 0.75), (20, 1 / 3, 0.75), (30, 1.0, 1.0)],
        "SELECT v, nth_value(v, 2) OVER (ORDER BY v) FROM (SELECT unnest([10, 20, 30]) AS v) "
        "ORDER BY v": [(10, None), (20, 20), (30, 20)],
        "SELECT v, nth_value(v, 2) OVER (ORDER BY v ROWS BETWEEN 1 PRECEDING AND 1 FOLLOWING) "
        "FROM (SELECT unnest([10, 20, 30]) AS v) ORDER BY v": [(10, 20), (20, 20), (30, 30)],
    }
    for sql, want in cases.items():
        got = tcon.sql(sql).rows()
        assert got == want
        assert_rows_match(got, jcon.sql(sql).rows(), ordered=True)


def test_holistic_window_aggregates(cons):
    """median, stddev and var_pop over whole partitions."""
    jcon, tcon = cons
    src = "(SELECT unnest([1, 1, 1, 2, 2]) AS g, unnest([10, 20, 40, 5, NULL]) AS v)"
    sql = f"SELECT g, v, median(v) OVER (PARTITION BY g) FROM {src} ORDER BY g, v"
    got = tcon.sql(sql).rows()
    assert [r[2] for r in got] == [20.0, 20.0, 20.0, 5.0, 5.0]
    assert_rows_match(got, jcon.sql(sql).rows(), ordered=True)
    sql = f"SELECT g, v, stddev(v) OVER (PARTITION BY g) FROM {src} ORDER BY g, v"
    got = tcon.sql(sql).rows()
    assert got[0][2] == pytest.approx(statistics.stdev([10, 20, 40]), rel=1e-12)
    assert got[3][2] is None  # n < 2
    assert_rows_match(got, jcon.sql(sql).rows(), ordered=True)
    sql = "SELECT var_pop(v) OVER (PARTITION BY g) FROM (SELECT unnest([1, 1, 1]) AS g, " \
          "unnest([10, 20, 40]) AS v)"
    assert tcon.sql(sql).rows()[0][0] == pytest.approx(1400 / 9, rel=1e-12)
    sql = f"SELECT g, variance(v) OVER (PARTITION BY g) FROM {src}"
    assert_rows_match(tcon.sql(sql).rows(), jcon.sql(sql).rows())
    # W12: the reference reads the DECIMAL fraction 0.25 as its scaled
    # integer 25, so its quantiles gather past the partition; DuckDB gives
    # 15.0 (between 10 and 20) and 5.0
    sql = f"SELECT g, v, quantile_cont(v, 0.25) OVER (PARTITION BY g) FROM {src} ORDER BY g, v"
    assert [r[2] for r in tcon.sql(sql).rows()] == [15.0, 15.0, 15.0, 5.0, 5.0]
    assert [r[2] for r in jcon.sql(sql).rows()] != [15.0, 15.0, 15.0, 5.0, 5.0]


EV = ("(VALUES (DATE '2024-01-15', 1), (DATE '2024-02-10', 2), (DATE '2024-03-05', 4), "
      "(DATE '2024-05-01', 8)) ev(d, v)")


@pytest.mark.parametrize("order,frame,want", [
    ("", "INTERVAL '1' MONTH PRECEDING AND CURRENT ROW", [1, 3, 6, 8]),
    ("", "INTERVAL '30' DAY PRECEDING AND INTERVAL '30' DAY FOLLOWING", [3, 7, 6, 8]),
    ("", "INTERVAL '25' DAY PRECEDING AND INTERVAL '1' MONTH FOLLOWING", [3, 6, 6, 8]),
    # W6: under DESC, PRECEDING rows hold the larger dates, so the frame of
    # d is [d, d + 1 month] and [d - 1 month, d + 25 days] (DuckDB's answers)
    ("DESC", "INTERVAL '1' MONTH PRECEDING AND CURRENT ROW", [3, 6, 4, 8]),
    ("DESC", "INTERVAL '30' DAY PRECEDING AND INTERVAL '30' DAY FOLLOWING", [3, 7, 6, 8]),
    ("DESC", "INTERVAL '25' DAY PRECEDING AND INTERVAL '1' MONTH FOLLOWING", [1, 7, 6, 8]),
])
def test_range_frame_interval(cons, order, frame, want):
    """Calendar months (the day clamped to the month's length) and days,
    ascending and descending. The JAX package shifts DESC keys the wrong
    way (W6), so only the ascending frames are held to it."""
    jcon, tcon = cons
    sql = f"SELECT d, sum(v) OVER (ORDER BY d {order} RANGE BETWEEN {frame}) FROM {EV} " \
          f"ORDER BY d"
    got = tcon.sql(sql).rows()
    assert [r[1] for r in got] == want
    if not order:
        assert got == jcon.sql(sql).rows()


def test_range_frame_interval_desc_timestamp(cons):
    """W6 over TIMESTAMP keys: under DESC each row's frame of 1 day 12
    hours PRECEDING holds its own row and those up to 36 hours later."""
    _, tcon = cons
    src = ("(VALUES (TIMESTAMP '2024-01-01 00:00:00', 1), (TIMESTAMP '2024-01-02 06:00:00', 2), "
           "(TIMESTAMP '2024-01-02 18:00:00', 4), (TIMESTAMP '2024-01-05 00:00:00', 8)) ev(t, v)")
    sql = f"SELECT t, sum(v) OVER (ORDER BY t DESC RANGE BETWEEN INTERVAL '1 day 12 hours' " \
          f"PRECEDING AND CURRENT ROW), count(*) OVER (ORDER BY t DESC RANGE BETWEEN " \
          f"INTERVAL '12' HOUR PRECEDING AND INTERVAL '12' HOUR FOLLOWING) FROM {src} ORDER BY t"
    assert [r[1:] for r in tcon.sql(sql).rows()] == [(3, 1), (6, 2), (4, 2), (8, 1)]


# -- windows over TPC-H columns: VARCHAR keys, DECIMAL arguments ----------------------
TPCH_WINDOWS = [
    "SELECT n_name, n_regionkey, rank() OVER (PARTITION BY n_regionkey ORDER BY n_name DESC) "
    "FROM nation",
    "SELECT r_name, n_name, row_number() OVER (PARTITION BY r_name ORDER BY n_name) "
    "FROM nation JOIN region ON n_regionkey = r_regionkey",
    "SELECT o_orderkey, o_orderpriority, sum(o_totalprice) OVER (PARTITION BY o_orderpriority "
    "ORDER BY o_orderkey ROWS BETWEEN 2 PRECEDING AND CURRENT ROW) FROM orders "
    "WHERE o_orderkey < 3000",
    "SELECT o_orderkey, avg(o_totalprice) OVER (PARTITION BY o_orderstatus ORDER BY "
    "o_orderdate, o_orderkey) FROM orders WHERE o_orderkey < 3000",
    "SELECT c_custkey, min(c_name) OVER (PARTITION BY c_nationkey), max(c_phone) OVER "
    "(PARTITION BY c_mktsegment ORDER BY c_custkey) FROM customer WHERE c_custkey < 400",
    "SELECT s_suppkey, lag(s_name, 2) OVER (ORDER BY s_suppkey), lead(s_acctbal) OVER "
    "(PARTITION BY s_nationkey ORDER BY s_suppkey), first_value(s_name) OVER (PARTITION BY "
    "s_nationkey ORDER BY s_acctbal DESC) FROM supplier",
    "SELECT p_partkey, ntile(3) OVER (PARTITION BY p_brand ORDER BY p_partkey), "
    "last_value(p_retailprice) OVER (PARTITION BY p_brand ORDER BY p_partkey ROWS BETWEEN "
    "UNBOUNDED PRECEDING AND UNBOUNDED FOLLOWING) FROM part WHERE p_partkey < 500",
    "SELECT l_orderkey, l_linenumber, "
    "max(l_shipdate) OVER (PARTITION BY l_orderkey ORDER BY l_linenumber), min(l_discount) "
    "OVER (PARTITION BY l_shipmode ORDER BY l_orderkey, l_linenumber ROWS BETWEEN 3 PRECEDING "
    "AND 3 FOLLOWING) FROM lineitem WHERE l_orderkey < 600",
    "SELECT ps_partkey, ps_suppkey, sum(ps_availqty) OVER (PARTITION BY ps_partkey ORDER BY "
    "ps_supplycost RANGE BETWEEN 200 PRECEDING AND 100 FOLLOWING) FROM partsupp "
    "WHERE ps_partkey < 300",
    "SELECT l_orderkey, l_linenumber, sum(l_quantity) OVER (ORDER BY l_shipdate RANGE "
    "BETWEEN INTERVAL 10 DAY PRECEDING AND CURRENT ROW) FROM lineitem WHERE l_orderkey < 300",
    "SELECT n_name, rank_dense() OVER (ORDER BY n_regionkey), avg(n_nationkey) OVER () "
    "FROM nation",
    "SELECT c_custkey, fill(CASE WHEN c_custkey % 3 = 0 THEN c_acctbal END) OVER (ORDER BY "
    "c_custkey) FROM customer WHERE c_custkey < 50",
]


@pytest.mark.parametrize("i", range(len(TPCH_WINDOWS)))
def test_tpch_windows_match_jax(cons, i):
    jcon, tcon = cons
    sql = TPCH_WINDOWS[i]
    assert_rows_match(tcon.sql(sql).rows(), jcon.sql(sql).rows())


def test_window_over_an_aggregate(cons):
    """A window over a GROUP BY's aggregate: rank by sum(l_quantity)."""
    jcon, tcon = cons
    sql = ("SELECT l_returnflag, sum(l_quantity) AS q, rank() OVER (ORDER BY sum(l_quantity) "
           "DESC) AS r, sum(sum(l_quantity)) OVER () AS total FROM lineitem GROUP BY "
           "l_returnflag ORDER BY l_returnflag")
    got = tcon.sql(sql).rows()
    assert sorted(r[2] for r in got) == [1, 2, 3]
    assert all(r[3] == sum(x[1] for x in got) for r in got)
    assert_rows_match(got, jcon.sql(sql).rows(), ordered=True)


def test_order_by_computed_varchar_is_by_value(cons):
    """reverse(n_name)'s values are not in n_name's code order: a window
    orders them by value, as the port's ORDER BY does."""
    _, tcon = cons
    names = [r[0] for r in tcon.sql("SELECT n_name FROM nation").rows()]
    got = tcon.sql("SELECT n_name, row_number() OVER (ORDER BY reverse(n_name)) FROM "
                   "nation").rows()
    rank = {n: i + 1 for i, n in enumerate(sorted(names, key=lambda s: s[::-1]))}
    assert sorted(got) == sorted((n, rank[n]) for n in names)
    assert [n for n, _ in sorted(got, key=lambda r: r[1])] != sorted(names)


def test_w5_partition_count_over_many_rows(cons):
    """count(*) and sum over l_orderkey partitions of all of lineitem,
    against Python's per-order counts and sums (the reference's sharded
    window is wrong here: W5)."""
    _, tcon = cons
    lines = tcon.sql("SELECT l_orderkey, l_quantity FROM lineitem").rows()
    n, q = {}, {}
    for k, x in lines:
        n[k] = n.get(k, 0) + 1
        q[k] = q.get(k, 0) + x
    got = tcon.sql("SELECT l_orderkey, count(*) OVER (PARTITION BY l_orderkey), "
                   "sum(l_quantity) OVER (PARTITION BY l_orderkey) FROM lineitem").rows()
    assert len(got) == len(lines)
    assert all(c == n[k] and s == q[k] for k, c, s in got)


def test_mean_is_avg(cons):
    _, tcon = cons
    assert tcon.sql("SELECT mean(n_nationkey) OVER () FROM nation LIMIT 1").rows() == [(12.0,)]


def test_lag_varchar_default(cons):
    """A lag default outside the argument's dictionary."""
    _, tcon = cons
    got = tcon.sql("SELECT n_nationkey, lag(n_name, 1, 'none') OVER (ORDER BY n_nationkey) "
                   "FROM nation ORDER BY n_nationkey LIMIT 3").rows()
    assert got == [(0, "none"), (1, "ALGERIA"), (2, "ARGENTINA")]


def test_qualify_inline_matches_jax(cons):
    jcon, tcon = cons
    sql = ("SELECT n_regionkey, n_name FROM nation QUALIFY row_number() OVER (PARTITION BY "
           "n_regionkey ORDER BY n_name) = 1 ORDER BY 1")
    got = tcon.sql(sql).rows()
    assert len(got) == 5
    assert got == jcon.sql(sql).rows()


# -- the reference's faults, held to DuckDB ---------------------------------------------
def _nations(tcon):
    return tcon.sql("SELECT n_regionkey, n_name FROM nation").rows()


def test_w1_distinct_on_keeps_the_first_row_per_key(cons):
    """DuckDB: the first row of each region in ORDER BY order (5 rows; the
    reference returns all 25)."""
    jcon, tcon = cons
    sql = ("SELECT DISTINCT ON (n_regionkey) n_regionkey, n_name FROM nation "
           "ORDER BY n_regionkey, n_name")
    want = sorted({r: min(n for k, n in _nations(tcon) if k == r)
                   for r, _ in _nations(tcon)}.items())
    assert tcon.sql(sql).rows() == want
    assert len(jcon.sql(sql).rows()) == 25  # W1 in the reference
    desc = tcon.sql("SELECT DISTINCT ON (n_regionkey) n_regionkey, n_name FROM nation "
                    "ORDER BY n_regionkey, n_name DESC").rows()
    assert desc == sorted({r: max(n for k, n in _nations(tcon) if k == r)
                           for r, _ in _nations(tcon)}.items())
    # without ORDER BY: one row of each key
    any_row = tcon.sql("SELECT DISTINCT ON (n_regionkey) n_regionkey, n_name FROM nation").rows()
    assert sorted(r for r, _ in any_row) == [0, 1, 2, 3, 4]
    assert set(any_row) <= set(_nations(tcon))


def test_w2_qualify_reads_a_select_alias(cons):
    jcon, tcon = cons
    sql = ("SELECT n_regionkey, n_name, row_number() OVER (PARTITION BY n_regionkey ORDER BY "
           "n_name) AS rn FROM nation QUALIFY rn = 1 ORDER BY n_regionkey")
    want = [(r, n, 1) for r, n in sorted(
        {r: min(n for k, n in _nations(tcon) if k == r) for r, _ in _nations(tcon)}.items())]
    assert tcon.sql(sql).rows() == want
    with pytest.raises(Exception, match="rn"):
        jcon.sql(sql).rows()  # W2 in the reference


# DuckDB's answers over (1, 5, 3) in x's order (1, 3, 5): the framed median
# is 1, 2 and 4, the running one 1, 2 and 3; the JAX package answers over the
# whole partition on every row (W3)
_W3_ROWS = "ORDER BY x ROWS BETWEEN 1 PRECEDING AND CURRENT ROW"
_W3 = {
    ("median(x)", _W3_ROWS): [1.0, 2.0, 4.0],
    ("median(x)", "ORDER BY x"): [1.0, 2.0, 3.0],
    ("quantile_cont(x, 0.5)", _W3_ROWS): [1.0, 2.0, 4.0],
    ("quantile_cont(x, 0.5)", "ORDER BY x"): [1.0, 2.0, 3.0],
    ("stddev(x)", _W3_ROWS): [None, 2 ** 0.5, 2 ** 0.5],
    ("stddev(x)", "ORDER BY x"): [None, 2 ** 0.5, 2.0],
    ("var_pop(x)", _W3_ROWS): [0.0, 1.0, 1.0],
    ("var_pop(x)", "ORDER BY x"): [0.0, 1.0, 8 / 3],
}
# (the reference's quantile_cont reads 0.5 as its scaled integer 5 and
# gathers past the partition, W12)
_W3_WHOLE = {"median(x)": 3.0, "quantile_cont(x, 0.5)": 0.0, "stddev(x)": 2.0,
             "var_pop(x)": 8 / 3}


@pytest.mark.parametrize("func", ["median(x)", "quantile_cont(x, 0.5)", "stddev(x)",
                                  "var_pop(x)"])
@pytest.mark.parametrize("over", [_W3_ROWS, "ORDER BY x"])
def test_w3_ordered_holistic_windows_not_ported(cons, func, over):
    """ROADMAP item 44, now ported: the holistic windows answer over each
    row's frame as DuckDB does (the name is kept from when the port refused
    them). The reference still answers over the whole partition (W3)."""
    jcon, tcon = cons
    sql = f"SELECT x, {func} OVER ({over}) FROM (VALUES (1), (5), (3)) t(x) ORDER BY x"
    got = [v for _, v in tcon.sql(sql).rows()]
    want = _W3[(func, over)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g is None if w is None else g == pytest.approx(w, rel=1e-12)
    assert [v for _, v in jcon.sql(sql).rows()] == pytest.approx([_W3_WHOLE[func]] * 3,
                                                                  rel=1e-12)


def test_w4_decimal_moments_unscale(cons):
    _, tcon = cons
    got = tcon.sql("SELECT stddev(x) OVER (), var_samp(x) OVER (), var_pop(x) OVER () FROM "
                   "(VALUES (1.0), (2.0), (4.0)) t(x)").rows()
    assert got[0][0] == pytest.approx(statistics.stdev([1.0, 2.0, 4.0]), rel=1e-12)
    assert got[0][1] == pytest.approx(statistics.variance([1.0, 2.0, 4.0]), rel=1e-12)
    assert got[0][2] == pytest.approx(statistics.pvariance([1.0, 2.0, 4.0]), rel=1e-12)


def test_window_errors(cons):
    _, tcon = cons
    with pytest.raises(BindError, match="not supported"):
        tcon.sql("SELECT nope() OVER () FROM nation")
    with pytest.raises(BindError, match="ntile must be greater than zero"):
        tcon.sql("SELECT ntile(0) OVER () FROM nation").rows()
    with pytest.raises(BindError, match="not allowed"):
        tcon.sql("SELECT n_name FROM nation WHERE row_number() OVER () = 1")


# -- the phase-15 queries: numpy oracle, the reference, routes and the kernel ---------
@pytest.mark.parametrize("name", sorted(tpch_oracle.WINDOW_QUERIES))
def test_window_query_matches_oracle(cons, data_dir, name):
    _, tcon = cons
    assert_rows_match(tcon.sql(tpch_oracle.WINDOW_QUERIES[name]).rows(),
                      tpch_oracle.answer(name, data_dir), ordered=True)


@pytest.mark.parametrize("name", ["win_rank_lineitem", "win_lag_lead", "win_median_part",
                                  "win_running_orders"])
def test_window_query_matches_jax(cons, name):
    jcon, tcon = cons
    sql = tpch_oracle.WINDOW_QUERIES[name]
    assert_rows_match(tcon.sql(sql).rows(), jcon.sql(sql).rows(), ordered=True)


def test_window_query_routes_and_grouped_sum(data_dir, monkeypatch):
    """One Window node each; the outer aggregates group into dense slots
    through the grouped sum (win_dist_partsupp's ntile key by sort-group)."""
    calls = []
    real = grouped_mod.grouped_sum_i64

    def spy(dense, vectors, nseg):
        calls.append(nseg)
        return real(dense, vectors, nseg)

    monkeypatch.setattr(grouped_mod, "grouped_sum_i64", spy)
    tcon = duckdb_tpu_torch.connect(device="cpu")
    tcon.load_tpch(data_dir)
    for name in ("win_rank_lineitem", "win_frames_lineitem", "win_dist_partsupp",
                 "qualify_top3"):
        calls.clear()
        tcon.routes.clear()
        tcon.sql(tpch_oracle.WINDOW_QUERIES[name]).rows()
        routes = dict(tcon.routes)
        assert routes.pop("window") == 1
        if name == "qualify_top3":
            assert routes == {} and not calls
        elif name == "win_dist_partsupp":
            assert routes == {"sort_group": 1}
        else:
            assert routes == {"dense": 1} and calls, (name, routes)


def test_window_types(cons):
    _, tcon = cons
    got = tcon.sql("SELECT sum(n_nationkey) OVER (), avg(n_nationkey) OVER (), "
                   "count(*) OVER (), min(n_name) OVER (), first_value(n_regionkey) OVER () "
                   "FROM nation LIMIT 1").rows()
    assert got == [(300, 12.0, 25, "ALGERIA", 0)]
    got = tcon.sql("SELECT sum(x) OVER (ORDER BY x), max(d) OVER () FROM (VALUES (1.25, "
                   "DATE '2024-02-29'), (2.50, DATE '2023-01-01')) t(x, d) ORDER BY 1").rows()
    assert got == [(decimal.Decimal("1.25"), datetime.date(2024, 2, 29)),
                   (decimal.Decimal("3.75"), datetime.date(2024, 2, 29))]
