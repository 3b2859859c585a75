"""TPC-H Q1 end to end: duckdb_tpu_torch (device="cpu") against duckdb_tpu.

Both packages load one lineitem directory written by the port's seeded
generator (duckdb_tpu_torch/testing/tpch_gen.py) at SF 0.01. The JAX
connection runs with `SET pallas_grouped_sum = 'on'`, so its int64 sums
go through the Pallas kernel in interpret mode wherever its VMEM gate
(pallas_agg.fits_vmem) admits the shape: the ungrouped and the narrow
variants below take the kernel; full Q1's 15 vectors over 20 slots fall
back to the masked reduce. DECIMAL, integer, date and string values must
match exactly, DOUBLE values within 1e-9 relative, in the order ORDER BY
fixes.
"""

import datetime
import decimal

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import duckdb_tpu
import duckdb_tpu_torch
from duckdb_tpu.planner import bound as JB
from duckdb_tpu.types import DATE as JDATE, INTEGER as JINT, decimal as jdecimal
from duckdb_tpu_torch.planner import bound as TB
from duckdb_tpu_torch.testing import from_numpy_columns
from duckdb_tpu_torch.testing.tpch_gen import write_lineitem
from duckdb_tpu_torch.types import DATE as TDATE, INTEGER as TINT, decimal as tdecimal

torch.set_num_threads(1)

Q1 = """
SELECT l_returnflag, l_linestatus, sum(l_quantity) AS sum_qty,
  sum(l_extendedprice) AS sum_base_price,
  sum(l_extendedprice * (1 - l_discount)) AS sum_disc_price,
  sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) AS sum_charge,
  avg(l_quantity) AS avg_qty, avg(l_extendedprice) AS avg_price,
  avg(l_discount) AS avg_disc, count(*) AS count_order
FROM lineitem
WHERE l_shipdate <= CAST('1998-09-02' AS date)
GROUP BY l_returnflag, l_linestatus
ORDER BY l_returnflag, l_linestatus
"""

VARIANTS = {
    "q1": Q1,
    # the specification's text: a date cut-off folded from an interval
    "q1_interval_cutoff": Q1.replace(
        "CAST('1998-09-02' AS date)", "date '1998-12-01' - interval '120' day"),
    "q1_early_cutoff": Q1.replace("1998-09-02", "1995-06-17"),
    "q1_no_group_by": """
        SELECT sum(l_quantity), sum(l_extendedprice * (1 - l_discount)),
          avg(l_discount), count(*)
        FROM lineitem WHERE l_shipdate <= CAST('1998-09-02' AS date)""",
    "q1_narrow": """
        SELECT l_returnflag, l_linestatus, sum(l_quantity), count(*)
        FROM lineitem WHERE l_shipdate <= CAST('1998-09-02' AS date)
        GROUP BY l_returnflag, l_linestatus ORDER BY l_returnflag, l_linestatus""",
    "desc_limit_having": """
        SELECT l_returnflag AS rf, l_linestatus, min(l_extendedprice),
          max(l_discount), count(*) AS n
        FROM lineitem WHERE l_shipdate BETWEEN date '1994-01-01' AND date '1997-12-31'
          AND l_shipmode IN ('AIR', 'RAIL')
        GROUP BY rf, l_linestatus HAVING count(*) > 10
        ORDER BY rf DESC, l_linestatus LIMIT 3""",
    "case_and_extract": """
        SELECT extract(year FROM l_shipdate) AS y,
          sum(CASE WHEN l_discount > 0.05 THEN l_quantity ELSE 0 END) AS big_disc,
          avg(l_tax * 2), count(*)
        FROM lineitem WHERE l_returnflag <> 'N'
        GROUP BY y ORDER BY y""",
}


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("tpch_gen")
    write_lineitem(str(root), 0.01, seed=7)
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


def assert_rows_match(got, want):
    assert len(got) == len(want)
    for g_row, w_row in zip(got, want):
        assert len(g_row) == len(w_row)
        for g, w in zip(g_row, w_row):
            assert type(g) is type(w), (g_row, w_row)
            if isinstance(w, float):
                assert g == pytest.approx(w, rel=1e-9, abs=0.0), (g_row, w_row)
            else:
                assert g == w, (g_row, w_row)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_query_matches_jax(cons, name):
    jcon, tcon = cons
    want = jcon.sql(VARIANTS[name]).rows()
    got = tcon.sql(VARIANTS[name]).rows()
    assert want, "the variant must select rows"
    assert_rows_match(got, want)


def test_q1_shape_and_plan_cache(cons):
    _, tcon = cons
    rows = tcon.sql(Q1).rows()
    assert [r[:2] for r in rows] == [("A", "F"), ("N", "F"), ("N", "O"), ("R", "F")]
    assert all(isinstance(r[2], decimal.Decimal) and isinstance(r[6], float)
               for r in rows)
    assert Q1 in tcon._plan_cache
    assert tcon.sql(Q1).rows() == rows  # served from the cached plan


def test_q1_expressions_match_jax(cons):
    """The Q1 filter and charge expression over identical column state:
    the JAX package's host planes carried into port Columns."""
    jcon, _ = cons
    entry = jcon.catalog.get_table("lineitem")
    names = ["l_shipdate", "l_extendedprice", "l_discount", "l_tax"]
    planes = {n: entry.host_column(n) for n in names}
    n = entry.nrows
    tcols = from_numpy_columns(planes, {k: repr(entry.col_types[k]) for k in names})
    p = tcols["l_shipdate"].padded_len
    jcols = {k: entry.device_column(k) for k in names}
    assert all(c.padded_len == p for c in jcols.values())

    def build(M, date_t, int_t, dec):
        ref = {k: M.BoundColumnRef(k, dec(15, 2)) for k in names[1:]}
        cutoff = (datetime.date(1998, 9, 2) - datetime.date(1970, 1, 1)).days
        pred = M.BoundComparison("<=", M.BoundColumnRef("l_shipdate", date_t),
                                 M.BoundLiteral(cutoff, date_t))
        one = M.BoundLiteral(1, int_t)
        disc = M.BoundArithmetic("-", one, ref["l_discount"], dec(16, 2))
        tax = M.BoundArithmetic("+", one, ref["l_tax"], dec(16, 2))
        price = M.BoundArithmetic("*", ref["l_extendedprice"], disc, dec(31, 4))
        return pred, M.BoundArithmetic("*", price, tax, dec(38, 6))

    jlive = jnp.arange(p) < n
    tlive = torch.arange(p) < n
    jenv = JB.EvalEnv(cols=jcols, plen=p, live=jlive)
    tenv = TB.EvalEnv(cols=tcols, plen=p, live=tlive)
    for je, te in zip(build(JB, JDATE, JINT, jdecimal), build(TB, TDATE, TINT, tdecimal)):
        jc, tc = je.eval(jenv), te.eval(tenv)
        assert tc.ltype == te.ltype
        np.testing.assert_array_equal(tc.data[:n].numpy(), np.asarray(jc.data)[:n])


def test_decimal_scale_down_rounds_half_away_from_zero(cons, data_dir):
    """DuckDB rounds a DECIMAL cast to a smaller scale; the reference does
    not (ROADMAP Queue 3, rule #6), so this holds the port to numpy."""
    _, tcon = cons
    (got,) = tcon.sql("SELECT sum(CAST(l_discount AS DECIMAL(15,1))) FROM lineitem").rows()
    disc = np.fromfile(f"{data_dir}/lineitem/l_discount.i64", dtype=np.int64)
    want = int(((disc + 5) // 10).sum())  # discounts are ≥ 0: half up
    assert got == (decimal.Decimal(want).scaleb(-1),)
