"""MARK joins (IN and EXISTS outside a WHERE conjunct), NOT IN correlated
by a residual, and USING SAMPLE / TABLESAMPLE through duckdb_tpu_torch
(device="cpu").

Both packages load one directory of all eight tables written by the port's
seeded generator at SF 0.01, seed 7. MARK joins are compared with
duckdb_tpu and, over hand-made tables with NULLs (made with
`catalog.create_table` in the port), with SQL's three-valued answers
written out. NOT IN with a residual is held to a nested loop in numpy. A
sample cannot equal the reference's (JAX's PRNG is not torch's), so the
tests hold the exact count of `n ROWS`, a `p%` count within 5 standard
deviations of the binomial mean, one seed giving the same rows twice, and
every sampled row being a live row of its source.
"""

import math

import numpy as np
import pytest
import torch

import duckdb_tpu
import duckdb_tpu_torch
from duckdb_tpu_torch.catalog.catalog import ColumnDef, TableEntry
from duckdb_tpu_torch.testing import tpch_oracle
from duckdb_tpu_torch.testing.tpch_gen import write_tables
from duckdb_tpu_torch.types import INTEGER

torch.set_num_threads(1)

X = [1, 2, None, 4]  # probe values
Y_NULL = [1, None, 3]  # a build with a NULL
Y = [1, 3]  # a build without


def _int_table(name, col, values):
    entry = TableEntry(name, [ColumnDef(col, INTEGER)])
    entry.nrows = len(values)
    valid = np.array([v is not None for v in values])
    entry.set_host_column(col, np.array([v or 0 for v in values], dtype=np.int32),
                          None if valid.all() else valid)
    return entry


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("tpch_gen_mark")
    write_tables(str(root), 0.01, seed=7)
    return str(root)


@pytest.fixture(scope="module")
def cons(data_dir):
    jcon = duckdb_tpu.connect()
    jcon.load_tpch(data_dir)
    jcon.sql("SET pallas_grouped_sum = 'on'")
    tcon = duckdb_tpu_torch.connect(device="cpu")
    tcon.load_tpch(data_dir)
    for name, values in (("px", X), ("by", Y), ("byn", Y_NULL), ("bempty", [])):
        tcon.catalog.create_table(_int_table(name, "v", values))
    yield jcon, tcon
    jcon.sql("RESET pallas_grouped_sum")


def _sorted(rows):
    return sorted(rows, key=lambda r: tuple((v is None, "" if v is None else v) for v in r))


# -- MARK joins against the reference ---------------------------------------------------
PARITY = [
    "SELECT n_name, n_nationkey IN (SELECT r_regionkey FROM region) FROM nation",
    "SELECT n_name, n_nationkey NOT IN (SELECT r_regionkey FROM region WHERE r_regionkey > 2) "
    "FROM nation",
    "SELECT n_name, EXISTS (SELECT * FROM region WHERE r_regionkey = n_nationkey) FROM nation",
    "SELECT n_name, NOT EXISTS (SELECT * FROM region WHERE r_regionkey = n_nationkey "
    "AND r_name LIKE 'A%') FROM nation",
    "SELECT EXISTS (SELECT * FROM region WHERE r_regionkey > 10) FROM nation",
    "SELECT CASE WHEN n_name IN (SELECT n_name FROM nation WHERE n_regionkey = 1) "
    "THEN 'a' ELSE 'b' END, count(*) FROM nation GROUP BY 1",
    "SELECT count(*) FROM orders WHERE o_custkey IN (SELECT c_custkey FROM customer "
    "WHERE c_mktsegment = 'BUILDING') OR o_totalprice > 300000",
    "SELECT o_orderpriority, sum(CASE WHEN EXISTS (SELECT * FROM lineitem WHERE "
    "l_orderkey = o_orderkey AND l_commitdate < l_receiptdate) THEN 1 ELSE 0 END) "
    "FROM orders GROUP BY 1",
    "SELECT count(*) FROM lineitem WHERE l_quantity IN (SELECT p_size FROM part "
    "WHERE p_size < 10) OR l_discount = 0.05",
    "SELECT count(*) FROM nation WHERE n_regionkey NOT IN "
    "(SELECT r_regionkey FROM region WHERE r_regionkey < n_nationkey)",
]


@pytest.mark.parametrize("sql", PARITY)
def test_mark_joins_match_reference(cons, sql):
    jcon, tcon = cons
    assert _sorted(tcon.sql(sql).rows()) == _sorted(jcon.sql(sql).rows())


def test_mark_build_runs_once_per_plan(cons):
    """The build of a MARK join runs on the first eval; the cached plan
    reuses it."""
    _, tcon = cons
    sql = "SELECT count(*) FROM nation WHERE n_nationkey IN (SELECT 3) OR n_regionkey = 0"
    tcon.routes.clear()
    first = tcon.sql(sql).rows()
    assert tcon.sql(sql).rows() == first == [(6,)]
    assert tcon.routes["mark_build"] == 1


def _three_valued(x, build, negated):
    """SQL's x [NOT] IN (build)."""
    if not build:
        return negated
    if x is not None and x in build:
        return not negated
    if x is None or None in build:
        return None
    return negated


@pytest.mark.parametrize("build", ["by", "byn", "bempty"])
@pytest.mark.parametrize("negated", [False, True])
def test_mark_null_semantics(cons, build, negated):
    """TRUE on a match; FALSE against a build without NULLs; NULL when the
    probe is NULL or the build holds a NULL; FALSE over an empty build."""
    _, tcon = cons
    values = {"by": Y, "byn": Y_NULL, "bempty": []}[build]
    got = tcon.sql(f"SELECT v, v {'NOT ' if negated else ''}IN (SELECT v FROM {build}) "
                   "FROM px").rows()
    assert _sorted(got) == _sorted([(x, _three_valued(x, values, negated)) for x in X])


def test_correlated_exists_mark_is_two_valued(cons):
    """EXISTS correlated by one equality is TRUE or FALSE, never NULL."""
    _, tcon = cons
    got = tcon.sql("SELECT v, EXISTS (SELECT * FROM byn WHERE byn.v = px.v), "
                   "NOT EXISTS (SELECT * FROM byn WHERE byn.v = px.v) FROM px").rows()
    assert _sorted(got) == _sorted([(x, x == 1, x != 1) for x in X])


def test_mark_q4_and_in_or_against_numpy(cons, data_dir):
    _, tcon = cons
    for name in ("mark_q4", "mark_in_or"):
        assert tcon.sql(tpch_oracle.SELECT_FORM_QUERIES[name]).rows() == \
            tpch_oracle.answer(name, data_dir)


# -- NOT IN correlated by a residual ---------------------------------------------------
def test_not_in_residual_against_nested_loop(cons, data_dir):
    """`l_suppkey NOT IN (SELECT ps_suppkey FROM partsupp WHERE ps_partkey =
    l_partkey AND ps_availqty > l_quantity * 100)`: each lineitem row sees
    the partsupp rows of its part whose quantity passes."""
    _, tcon = cons
    t = tpch_oracle._Tables(data_dir)
    ps = {}
    for part, supp, avail in zip(t("partsupp", "ps_partkey").tolist(),
                                 t("partsupp", "ps_suppkey").tolist(),
                                 t("partsupp", "ps_availqty").tolist()):
        ps.setdefault(part, []).append((supp, avail))
    keep = [supp not in [s for s, a in ps.get(part, []) if a > qty]  # qty is in cents
            for part, supp, qty in zip(t("lineitem", "l_partkey").tolist(),
                                       t("lineitem", "l_suppkey").tolist(),
                                       t("lineitem", "l_quantity").tolist())]
    qty = t("lineitem", "l_quantity")
    got = tcon.sql(tpch_oracle.SELECT_FORM_QUERIES["notin_residual"]).rows()
    assert got == [(sum(keep), tpch_oracle._dec(int(qty[np.array(keep)].sum()), 2))]
    assert got == tpch_oracle.answer("notin_residual", data_dir)


def test_not_in_residual_nulls(cons):
    """SQL's NULL rule per probe row over the build rows its correlation
    selects: none selected → TRUE; a NULL among them, or a NULL probe → not
    TRUE."""
    _, tcon = cons
    # every probe sees the NULL row alone: nothing passes
    assert tcon.sql("SELECT v FROM px WHERE v NOT IN (SELECT v FROM byn "
                    "WHERE byn.v IS NULL OR byn.v > px.v + 5)").rows() == []
    got = tcon.sql("SELECT v FROM px WHERE v NOT IN "
                   "(SELECT v FROM byn WHERE byn.v > px.v)").rows()
    # 1 sees {3} (NULL > 1 is not TRUE); 2 sees {3}; NULL sees none; 4 sees none
    assert _sorted(got) == _sorted([(1,), (2,), (None,), (4,)])
    got = tcon.sql("SELECT v FROM px WHERE v NOT IN "
                   "(SELECT v FROM byn WHERE byn.v >= px.v OR byn.v IS NULL)").rows()
    assert got == []


# -- SAMPLE --------------------------------------------------------------------------------
def test_sample_rows_is_exact(cons, data_dir):
    _, tcon = cons
    assert tcon.sql(tpch_oracle.SELECT_FORM_QUERIES["sample_rows"]).rows() == [(60012,)]
    assert tcon.sql("SELECT count(*) FROM lineitem USING SAMPLE 1000 ROWS").rows() == [(1000,)]
    assert tcon.sql("SELECT count(*) FROM nation USING SAMPLE 5 ROWS").rows() == [(5,)]
    assert tcon.sql("SELECT count(*) FROM nation TABLESAMPLE 40 ROWS").rows() == [(25,)]


@pytest.mark.parametrize("sql,n,p", [
    ("SELECT count(*) FROM orders TABLESAMPLE 10%", 15003, 0.10),
    ("SELECT count(*) FROM lineitem TABLESAMPLE 10% REPEATABLE (42)", 60012, 0.10),
    ("SELECT count(*) FROM orders USING SAMPLE 25 PERCENT (bernoulli)", 15003, 0.25),
    ("SELECT count(*) FROM lineitem WHERE l_quantity < 10 USING SAMPLE 50%", None, 0.5),
])
def test_sample_percent_within_5_sigma(cons, data_dir, sql, n, p):
    _, tcon = cons
    if n is None:
        n = int((tpch_oracle._Tables(data_dir)("lineitem", "l_quantity") < 1000).sum())
    got = tcon.sql(sql).rows()[0][0]
    assert abs(got - n * p) <= 5 * math.sqrt(n * p * (1 - p)), (got, n * p)


def test_sample_seed_repeats_and_rows_are_live(cons, data_dir):
    _, tcon = cons
    sql = "SELECT l_orderkey, l_linenumber FROM lineitem TABLESAMPLE 5% REPEATABLE (7)"
    first = tcon.sql(sql).rows()
    assert tcon.sql(sql).rows() == first
    other = tcon.sql(sql.replace("(7)", "(8)")).rows()
    assert other != first
    t = tpch_oracle._Tables(data_dir)
    source = set(zip(t("lineitem", "l_orderkey").tolist(), t("lineitem", "l_linenumber").tolist()))
    assert first and set(first) <= source and len(set(first)) == len(first)
    rows = tcon.sql("SELECT n_nationkey FROM nation WHERE n_regionkey = 1 "
                    "USING SAMPLE 3 ROWS (reservoir, 5)").rows()
    assert len(rows) == 3 and {r[0] for r in rows} <= {1, 2, 3, 17, 24}


def test_sample_follows_setseed(data_dir):
    """Without REPEATABLE, a sample draws from the session's generator:
    setseed() makes it repeat, within a connection and across two."""
    def draw():
        con = duckdb_tpu_torch.connect(device="cpu")
        con.load_tpch(data_dir)
        con.sql("SELECT setseed(0.25)").rows()
        return con, con.sql("SELECT o_orderkey FROM orders USING SAMPLE 20 ROWS").rows()

    con, a = draw()
    assert draw()[1] == a
    con.sql("SELECT setseed(0.25)").rows()
    assert con.sql("SELECT o_orderkey FROM orders USING SAMPLE 20 ROWS").rows() == a
