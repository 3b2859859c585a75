"""Casts, type names, DuckDB's % and // and SELECT without FROM in
duckdb_tpu_torch (device="cpu"), against duckdb_tpu and DuckDB's answers.

The flat casts the reference has (TIMESTAMP, TIMESTAMPTZ, TIME and BLOB
to and from VARCHAR; numbers, dates and booleans to VARCHAR; text to
numbers, dates and times, strictly and under TRY_CAST) and the type names
json, uuid, guid, timestamptz, timetz, blob, bytea, binary and varbinary
are compared with the reference over the port's generator's tables at
SF 0.01, seed 7. The VARCHAR cast and strftime format each distinct value
once: their codes and dictionary equal those of formatting every row.
Three differences from DuckDB that the reference has are held to
DuckDB's answers (ROADMAP Queue 3): `%` and `//` truncate toward zero
(#5: -5 % 3 is -2, 5 % -3 is 2, -7 // 2 is -3) for integers, DECIMAL and
DOUBLE, folded and at run time; greatest/least skip a NULL argument (#7);
a text value beyond DOUBLE's range is a conversion error and NULL under
TRY_CAST (#8). SELECT without FROM reads one constant row, also as a
subquery.
"""

import datetime
import decimal

import numpy as np
import pytest
import torch

import duckdb_tpu
import duckdb_tpu_torch
from duckdb_tpu_torch.blocks import Column
from duckdb_tpu_torch.planner import bound as TB
from duckdb_tpu_torch.testing.tpch_gen import write_tables
from duckdb_tpu_torch.types import DATE, DOUBLE, INTEGER, TIMESTAMP, decimal as dec_t

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("tpch_gen_casts")
    write_tables(str(root), 0.01, seed=7)
    return str(root)


@pytest.fixture(scope="module")
def cons(data_dir):
    jcon = duckdb_tpu.connect()
    jcon.load_tpch(data_dir)
    tcon = duckdb_tpu_torch.connect(device="cpu")
    tcon.load_tpch(data_dir)
    return jcon, tcon


CASTS = {
    "to_varchar": "SELECT o_orderkey, CAST(o_orderdate AS VARCHAR), "
                  "CAST(o_totalprice AS VARCHAR), CAST(o_custkey AS VARCHAR), "
                  "CAST(o_totalprice > 100000 AS VARCHAR), "
                  "CAST(CAST(o_totalprice AS DOUBLE) AS VARCHAR), "
                  "CAST(CAST(o_orderdate AS TIMESTAMP) AS VARCHAR) FROM orders",
    "timestamptz": "SELECT o_orderkey, CAST(CAST(o_orderdate AS TIMESTAMPTZ) AS VARCHAR), "
                   "CAST(o_orderdate AS TIMESTAMPTZ) FROM orders WHERE o_orderkey < 500",
    "time": "SELECT CAST('12:30:00' AS TIME), CAST('10:11:12.5' AS TIME), "
            "CAST(CAST('23:59:59.000001' AS TIME) AS VARCHAR), CAST('00:00:00' AS TIMETZ)",
    "text_to_temporal": "SELECT CAST('1992-01-01 10:00:00' AS TIMESTAMP), "
                        "CAST('2020-01-01 10:00:00+02' AS TIMESTAMPTZ), "
                        "CAST(CAST('2020-01-01 10:00:00' AS TIMESTAMPTZ) AS VARCHAR), "
                        "CAST('1969-07-20' AS DATE)",
    "text_columns": "SELECT o_orderkey, CAST(CAST(o_orderdate AS VARCHAR) AS DATE), "
                    "CAST(CAST(o_orderdate AS VARCHAR) || ' 01:02:03' AS TIMESTAMP), "
                    "CAST(CAST(o_custkey AS VARCHAR) AS INTEGER), "
                    "CAST(CAST(o_totalprice AS VARCHAR) AS DOUBLE), "
                    "TRY_CAST(o_comment AS DOUBLE), TRY_CAST(o_clerk AS INTEGER) "
                    "FROM orders WHERE o_orderkey < 2000",
    "blob": "SELECT o_orderkey, CAST(o_orderstatus AS BLOB), "
            "CAST(CAST(o_clerk AS BYTEA) AS VARCHAR), typeof(CAST(o_comment AS VARBINARY)), "
            "typeof(CAST('x' AS BINARY)) FROM orders WHERE o_orderkey < 300",
    "type_names": "SELECT CAST('{\"a\": 1}' AS JSON), "
                  "CAST('a0eebc99-9c0b-4ef8-bb6d-6bb9bd380a11' AS UUID), "
                  "CAST('a0eebc99-9c0b-4ef8-bb6d-6bb9bd380a11' AS GUID), "
                  "typeof(CAST('2020-01-01' AS TIMESTAMPTZ)), typeof(CAST('01:02:03' AS TIMETZ))",
    "concat_casts": "SELECT c_custkey, c_name || c_custkey, c_acctbal || '', "
                    "concat(c_name, '-', c_custkey, NULL, c_acctbal) FROM customer",
    "null_rows": "SELECT o_orderkey, CAST(nullif(o_custkey % 7, 3) AS VARCHAR), "
                 "CAST(CASE WHEN o_orderkey % 5 = 0 THEN NULL ELSE o_orderdate END AS VARCHAR) "
                 "FROM orders WHERE o_orderkey < 1000",
}


def _rows(con, sql):
    return sorted(con.sql(sql).rows(), key=repr)


@pytest.mark.parametrize("name", sorted(CASTS))
def test_cast_matches_jax(cons, name):
    jcon, tcon = cons
    assert _rows(tcon, CASTS[name]) == _rows(jcon, CASTS[name])


def _env(n):
    return TB.EvalEnv(cols={}, plen=n, live=torch.ones(n, dtype=torch.bool))


@pytest.mark.parametrize("ltype,values", [
    (DATE, [-25567, 0, 8035, 8035, 10957, -1, 8035]),
    (TIMESTAMP, [0, 86_400_000_000 + 5, -1, 123_456_789_000_001, 0]),
    (INTEGER, [5, -5, 0, 5, 2**31 - 1]),
    (dec_t(15, 2), [12345, -100, 0, 12345, 99]),
    (DOUBLE, [1.5, -0.0, 0.0, 1e300, float("inf"), 1.5]),
])
def test_per_distinct_formatting_equals_per_row(ltype, values):
    """_cast_to_varchar formats each distinct value once: its codes and
    dictionary equal formatting every row (NULL rows as '') and np.unique."""
    data = torch.tensor(values, dtype=ltype.torch_dtype)
    valid = torch.tensor([i % 3 != 1 for i in range(len(values))])
    c = Column(data=data, ltype=ltype, validity=valid)
    got = TB._cast_to_varchar(c, _env(len(values)))
    strs = [TB.format_varchar(v, ltype) if ok else "" for v, ok in
            zip(data.tolist(), valid.tolist())]
    uniq, codes = np.unique(np.array(strs, dtype=str), return_inverse=True)
    assert got.data.tolist() == codes.reshape(-1).tolist()
    assert list(got.dict_values) == list(uniq)
    assert got.validity is valid


def test_strftime_formats_each_distinct_date_once(cons):
    """strftime's codes and dictionary equal those of formatting every row;
    rows match the reference."""
    jcon, tcon = cons
    sql = ("SELECT o_orderkey, strftime(o_orderdate, '%Y-%m'), strftime(o_orderdate, '%d/%m/%Y'), "
           "strftime(CAST(o_orderdate AS TIMESTAMP), '%Y %H:%M') FROM orders")
    assert _rows(tcon, sql) == _rows(jcon, sql)
    days = torch.tensor([8035, 8036, 8035, -3, 10000], dtype=torch.int32)
    from duckdb_tpu_torch.planner.functions_ext import _to_datetime

    got = TB.format_distinct(Column(data=days, ltype=DATE), _env(5),
                             lambda v: _to_datetime(v, DATE).strftime("%Y-%m"))
    strs = [(datetime.date(1970, 1, 1) + datetime.timedelta(days=d)).strftime("%Y-%m")
            for d in days.tolist()]
    uniq, codes = np.unique(np.array(strs), return_inverse=True)
    assert got.data.tolist() == codes.tolist() and list(got.dict_values) == list(uniq)


# DuckDB truncates % and // toward zero (#5): (a constant expression, the
# same over nation's n_nationkey = 0 row, DuckDB's answer)
TRUNCATE = [
    ("-5 % 3", "(n_nationkey - 5) % 3", -2), ("5 % -3", "(n_nationkey + 5) % -3", 2),
    ("-7 // 2", "(n_nationkey - 7) // 2", -3), ("7 // -2", "(n_nationkey + 7) // -2", -3),
    ("-7 % -3", "(n_nationkey - 7) % -3", -1), ("7 % 0", "(n_nationkey + 7) % 0", None),
    ("-7 // 0", "(n_nationkey - 7) // 0", None),
    ("-7.5 % 2", "(n_nationkey - 7.5) % 2", decimal.Decimal("-1.5")),
    ("CAST(-7.5 AS DOUBLE) % 2", "CAST(n_nationkey - 7.5 AS DOUBLE) % 2", -1.5),
    ("CAST(-7.5 AS DOUBLE) // 2", "CAST(n_nationkey - 7.5 AS DOUBLE) // 2", -3.0),
    ("mod(-7, 3)", "mod(n_nationkey - 7, 3)", -1), ("mod(7, -3)", "mod(n_nationkey + 7, -3)", 1),
]


@pytest.mark.parametrize("const,col,want", TRUNCATE, ids=[c for c, _, _ in TRUNCATE])
def test_mod_and_integer_division_truncate(cons, const, col, want):
    """Folded constants and the run-time ops over a column alike."""
    _, tcon = cons
    (got,), = tcon.sql(f"SELECT {const}").rows()
    assert got == want and type(got) is type(want)
    (got,), = tcon.sql(f"SELECT {col} FROM nation WHERE n_nationkey = 0").rows()
    assert got == want and type(got) is type(want)


def test_mod_over_columns_follows_duckdb(cons, data_dir):
    """Integer and DECIMAL columns: the remainder takes the dividend's sign."""
    _, tcon = cons
    from duckdb_tpu_torch.testing import tpch_oracle

    t = tpch_oracle._Tables(data_dir)
    ln, qty = t("lineitem", "l_linenumber"), t("lineitem", "l_quantity")
    got = tcon.sql("SELECT sum(-l_linenumber % 3), sum(-l_linenumber // 2), "
                   "sum(-l_quantity % 7) FROM lineitem").rows()
    want = [(int(np.fmod(-ln, 3).sum()), int(-(ln // 2).sum()),
             decimal.Decimal(int(np.fmod(-qty, 700).sum())).scaleb(-2))]
    assert got == want


def test_greatest_least_skip_nulls(cons):
    """#7: DuckDB skips NULL arguments (the reference raises on a NULL
    literal); NULL only when all are."""
    _, tcon = cons
    assert tcon.sql("SELECT greatest(1, NULL, 3), least(NULL, 2, 5), greatest(NULL, NULL), "
                    "least('b', NULL, 'a')").rows() == [(3, 2, None, "a")]
    rows = tcon.sql("SELECT greatest(nullif(n_nationkey, 3), n_regionkey) FROM nation "
                    "WHERE n_nationkey IN (3, 4) ORDER BY n_nationkey").rows()
    assert rows == [(1,), (4,)]


def test_text_beyond_double_is_a_conversion_error(cons):
    """#8: '1e309'::DOUBLE raises (the reference gives inf); TRY_CAST gives
    NULL; 'inf' and in-range values cast."""
    _, tcon = cons
    with pytest.raises(Exception, match="Could not convert string '1e309' to DOUBLE"):
        tcon.sql("SELECT CAST('1e309' AS DOUBLE)").rows()
    with pytest.raises(Exception, match="Could not convert string '-1e999' to DOUBLE"):
        tcon.sql("SELECT CAST(v AS DOUBLE) FROM (SELECT '-1e999' AS v) t").rows()
    assert tcon.sql("SELECT TRY_CAST('1e309' AS DOUBLE), CAST('inf' AS DOUBLE), "
                    "CAST('-Infinity' AS DOUBLE), CAST('1e308' AS DOUBLE), "
                    "TRY_CAST('1e39' AS REAL)").rows() == [(None, float("inf"),
                                                            float("-inf"), 1e308, None)]


def test_later_type_names_name_their_item(cons):
    """BIT and the nested type names are ported (tests/test_torch_nested.py);
    user types and ENUM come from CREATE TYPE
    (tests/test_torch_sequences_types.py), so a name no CREATE TYPE made is
    unknown, as in the JAX package."""
    jcon, tcon = cons
    assert tcon.sql("SELECT CAST('101' AS BIT)").rows() == [("101",)]
    for con in (jcon, tcon):
        with pytest.raises(ValueError, match="unknown type name mood"):
            con.sql("SELECT CAST(1 AS mood)")


NO_FROM = {
    "constants": "SELECT 1 + 2, 'a' || 'b', CAST(NULL AS INTEGER), 3 * 4 AS x, "
                 "DATE '1992-01-01' + 3, typeof(1.5)",
    "functions": "SELECT greatest(1, 5, 3), least(4, 2), 7 % 3, upper('ab'), "
                 "date_trunc('month', DATE '1992-03-17'), pi()",
    "aggregate": "SELECT count(*), sum(1), max(2)",
    "derived": "SELECT x * 2 FROM (SELECT 21 AS x) t",
    "scalar_subquery": "SELECT (SELECT 1), (SELECT max(r_name) FROM region)",
    "in_subquery": "SELECT count(*) FROM nation WHERE n_nationkey IN (SELECT 1)",
    "exists": "SELECT count(*) FROM nation WHERE EXISTS (SELECT 42)",
    "cte": "WITH c AS (SELECT 5 AS v) SELECT v + 1 FROM c",
}


@pytest.mark.parametrize("name", sorted(NO_FROM))
def test_select_without_from_matches_jax(cons, name):
    jcon, tcon = cons
    assert tcon.sql(NO_FROM[name]).rows() == jcon.sql(NO_FROM[name]).rows()


def test_select_without_from_where_false_has_no_row(cons):
    """SQL: the one row fails the WHERE. The reference returns it anyway
    (ROADMAP Queue 3)."""
    _, tcon = cons
    assert tcon.sql("SELECT 1 WHERE 1 = 0").rows() == []
    assert tcon.sql("SELECT 1 WHERE 1 = 1").rows() == [(1,)]
