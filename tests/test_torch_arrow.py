"""Arrow and pandas in duckdb_tpu_torch (device="cpu"), with no pyarrow in
the port: api/arrow_interop.py over csrc/arrow_c.cpp, Arrow's C data and
stream interface.

pyarrow (here only, on the test side) consumes the port's exports through
the PyCapsule protocol, and is held to the JAX package's own pyarrow
export: schema and values, for every flat type, with NULLs, HUGEINT past
2^64, an empty result and TPC-H Q1 at SF 0.01. LIST and STRUCT follow
DuckDB (Arrow list and struct), where the JAX package exports dictionary
codes. fetch_record_batch gives ceil(n / k) batches. The same pyarrow
Table, RecordBatch and RecordBatchReader go into both packages'
from_arrow; where the JAX package is wrong (uint64, a decimal past int64,
list and struct) the port follows DuckDB and the test asserts the
difference. The port's own export goes back into the port with pyarrow
blocked, in a subprocess, as on the machine with the card. Capsules,
consumed or dropped, leave no struct alive. df() and from_df are held to
the JAX package's, and the error that names pandas is tested with pandas
blocked.
"""

import decimal
import math
import os
import subprocess
import sys

import pytest
import torch

import duckdb_tpu
import duckdb_tpu_torch
from duckdb_tpu_torch.api import arrow_interop as AI
from duckdb_tpu_torch.errors import ConversionException, InvalidInputException
from duckdb_tpu_torch.planner.bound import BindError
from duckdb_tpu_torch.testing.tpch_gen import write_tables

pa = pytest.importorskip("pyarrow")

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

# a table with a NULL in every flat type, made by the same statements in
# both packages
FLAT_SETUP = [
    "CREATE TABLE flat (ti TINYINT, si SMALLINT, i INTEGER, bi BIGINT, hi HUGEINT, f FLOAT, "
    "d DOUBLE, b BOOLEAN, s VARCHAR, dec DECIMAL(10,2), dt DATE, ts TIMESTAMP)",
    "INSERT INTO flat VALUES (1, 2, 3, 4, 5, 1.5, 2.25, true, 'x', 12.34, DATE '2020-01-02', "
    "TIMESTAMP '2020-01-02 03:04:05'), (NULL, NULL, NULL, NULL, NULL, NULL, NULL, NULL, "
    "NULL, NULL, NULL, NULL), (-1, -2, -3, -4, -5, -0.5, -2.5, false, 'yy', -0.01, "
    "DATE '1969-12-31', TIMESTAMP '1969-12-31 23:59:59.5')",
]

# LIST and STRUCT columns (the port's nested constructors take constants)
NESTED_SETUP = [
    "CREATE TABLE nested (l INTEGER[], st STRUCT(s VARCHAR, n INTEGER))",
    "INSERT INTO nested VALUES ([1, NULL, 3], {'s': 'a', 'n': 1}), (NULL, NULL), "
    "([4], {'s': 'b', 'n': 2})",
]

FLAT_QUERIES = {
    "literals": "SELECT 1::TINYINT a, 2::SMALLINT b, 3 c, 4::BIGINT d, 1.5::DOUBLE e, "
                "2.5::FLOAT f, true g, 'x' h, 1.25::DECIMAL(10,2) i, DATE '2020-01-02' k, "
                "TIMESTAMP '2020-01-02 03:04:05' l, TIME '01:02:03' m, INTERVAL 5 SECOND n",
    "nulls_in_every_flat_type": "SELECT * FROM flat",
    "filtered": "SELECT s, dec, dt FROM flat WHERE i > 0 OR i IS NULL",
    "hugeint_past_2_64": "SELECT sum(x) AS h, -(170141183460469231731687303715884105727::HUGEINT)"
                         " AS g FROM (VALUES (9223372036854775807::HUGEINT), "
                         "(9223372036854775807::HUGEINT), (9223372036854775807::HUGEINT)) t(x)",
    "empty": "SELECT * FROM flat WHERE i > 100",
}


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("tpch_arrow")
    write_tables(str(root), 0.01, seed=7)
    return str(root)


@pytest.fixture(scope="module")
def cons(data_dir):
    jcon, tcon = duckdb_tpu.connect(), duckdb_tpu_torch.connect(device="cpu")
    for con in (jcon, tcon):
        for s in FLAT_SETUP:
            con.sql(s)
        con.load_tpch(data_dir)
    return jcon, tcon


@pytest.mark.parametrize("name", sorted(FLAT_QUERIES))
def test_export_equals_the_jax_package(cons, name):
    jcon, tcon = cons
    sql = FLAT_QUERIES[name]
    mine = pa.table(tcon.sql(sql).arrow())
    theirs = jcon.sql(sql).arrow()
    assert mine.schema == theirs.schema
    assert mine.equals(theirs), (mine.to_pylist(), theirs.to_pylist())


def test_q1_export_equals_the_jax_package(cons, data_dir):
    jcon, tcon = cons
    res = tcon.sql(chip_smoke.Q1)
    mine = pa.table(res.arrow())
    assert mine.equals(jcon.sql(chip_smoke.Q1).arrow())
    assert mine.num_rows == res.nrows == 4 and mine.column_names == res.names
    assert [f.name for f in res.arrow().schema] == res.names


def test_list_and_struct_follow_duckdb(cons):
    """LIST and STRUCT are Arrow list and struct, as DuckDB exports them;
    the JAX package exports their dictionary codes (two int32 zeros)."""
    jcon, tcon = cons
    sql = "SELECT [1,2] AS l, {'x': 1, 'y': 'a'} AS s, [['a'], NULL] AS ll, NULL::INT[] AS n"
    t = pa.table(tcon.sql(sql).arrow())
    assert t.schema.field("l").type == pa.list_(pa.int32())
    assert t.schema.field("s").type == pa.struct([("x", pa.int32()), ("y", pa.string())])
    assert t.schema.field("ll").type == pa.list_(pa.list_(pa.string()))
    assert t.to_pylist() == [{"l": [1, 2], "s": {"x": 1, "y": "a"}, "ll": [["a"], None],
                              "n": None}]
    theirs = jcon.sql("SELECT [1,2] AS l, {'x': 1, 'y': 'a'} AS s").arrow()
    assert theirs.schema.types == [pa.int32(), pa.int32()]
    assert theirs.to_pylist() == [{"l": 0, "s": 0}]


def test_a_type_with_no_arrow_form_raises_naming_it():
    con = duckdb_tpu_torch.connect(device="cpu")
    with pytest.raises(BindError, match="MAP.*ROADMAP item 35b"):
        pa.table(con.sql("SELECT MAP {1: 2} AS m").arrow())


@pytest.mark.parametrize("k", [1, 7, 1000, 5000])
def test_fetch_record_batch_gives_ceil_n_over_k_batches(cons, k):
    _, tcon = cons
    res = tcon.sql("SELECT l_orderkey, l_comment, l_extendedprice, l_shipdate FROM lineitem "
                   "WHERE l_orderkey < 2000")
    reader = pa.RecordBatchReader.from_stream(res.fetch_record_batch(k))
    batches = list(reader)
    assert len(batches) == math.ceil(res.nrows / k) == res.fetch_record_batch(k).num_batches
    assert all(b.num_rows == k for b in batches[:-1])
    assert pa.Table.from_batches(batches).equals(pa.table(res.arrow()))
    assert res.record_batch is not None and res.fetch_arrow_reader(k).num_batches == len(batches)


def _arrow_inputs():
    """A pyarrow Table of three chunks with dictionary, utf8 and large_utf8
    columns and NULLs; its RecordBatch; and a RecordBatchReader of it."""
    chunks = [pa.record_batch({
        "k": pa.array([3 * c, 3 * c + 1, 3 * c + 2], pa.int64()),
        "i": pa.array([c, None, -c], pa.int32()),
        "f": pa.array([0.5 * c, None, 1e300], pa.float64()),
        "s": pa.array([f"s{c}", None, "zz"]),
        "ls": pa.array(["a", f"b{c}", "a"], pa.large_utf8()),
        "d": pa.array(["red", "blue", None]).dictionary_encode(),
        "b": pa.array([True, None, False]),
        "dec": pa.array([decimal.Decimal("1.25"), None, decimal.Decimal(-c)],
                        pa.decimal128(9, 2)),
        "dt": pa.array([18000 + c, None, -3], pa.date32()),
        "ts": pa.array([10**15 + c, None, -1], pa.timestamp("us")),
        "tms": pa.array([10**12, 5, None], pa.timestamp("ms")),
    }) for c in range(3)]
    table = pa.Table.from_batches(chunks)
    return {"table": table, "batch": chunks[1],
            "reader": pa.RecordBatchReader.from_batches(table.schema, iter(chunks))}


@pytest.mark.parametrize("kind", ["table", "batch", "reader"])
def test_from_arrow_equals_the_jax_package(kind):
    mine, theirs = _arrow_inputs()[kind], _arrow_inputs()[kind]
    tcon, jcon = duckdb_tpu_torch.connect(device="cpu"), duckdb_tpu.connect()
    tcon.from_arrow(mine, "a")
    jcon.from_arrow(theirs, "a")
    # (the JAX package orders an imported dictionary by its codes, so the
    # groups are compared as a set)
    for sql in ["SELECT * FROM a ORDER BY k",
                "SELECT d, count(*), sum(i), min(s), max(ls), sum(dec) FROM a GROUP BY d"]:
        assert sorted(tcon.sql(sql).rows(), key=repr) == sorted(jcon.sql(sql).rows(), key=repr)
    assert tcon.sql("SELECT count(*) FROM a").rows() == [
        (mine.num_rows if kind != "reader" else 9,)]


def test_from_arrow_of_lineitem_gives_q1(cons):
    """lineitem's pyarrow export in several chunks into both packages'
    from_arrow (and the port's register_arrow): Q1 over it is Q1."""
    jcon, tcon = cons
    table = jcon.sql("SELECT * FROM lineitem").arrow()
    chunked = pa.Table.from_batches(table.to_batches(max_chunksize=7_000))
    assert chunked.column(0).num_chunks > 5
    q1 = chip_smoke.Q1.replace("FROM lineitem", "FROM li")
    want = jcon.sql(chip_smoke.Q1).rows()
    tcon.register_arrow(chunked, "li")
    jcon.from_arrow(chunked, "li")
    assert tcon.sql(q1).rows() == want == jcon.sql(q1).rows()


def test_from_arrow_follows_duckdb_where_the_jax_package_does_not():
    """uint64 is HUGEINT (the JAX package wraps it), list and struct are
    LIST and STRUCT (the JAX package reads their Python text), time and
    duration TIME and INTERVAL, binary BLOB, a timestamp with a zone
    TIMESTAMPTZ (the JAX package's TIMESTAMP drops the zone)."""
    import datetime

    t = pa.table({
        "u": pa.array([2**63 + 5, None], pa.uint64()),
        "l": pa.array([[1, None], None], pa.list_(pa.int64())),
        "st": pa.array([{"x": 1, "y": "a"}, None], pa.struct([("x", pa.int64()),
                                                               ("y", pa.string())])),
        "tm": pa.array([3_723_000_000, None], pa.time64("us")),
        "du": pa.array([5_000_000, None], pa.duration("us")),
        "bn": pa.array([b"\x00c", None], pa.binary()),
        "tz": pa.array([1_000_000, None], pa.timestamp("us", tz="UTC")),
    })
    tcon, jcon = duckdb_tpu_torch.connect(device="cpu"), duckdb_tpu.connect()
    tcon.from_arrow(t, "t")
    jcon.from_arrow(t, "t")
    res = tcon.sql("SELECT * FROM t")
    assert [repr(x) for x in res.types] == ["HUGEINT", "BIGINT[]",
                                            "STRUCT(x BIGINT, y VARCHAR)", "TIME",
                                            "INTERVAL", "BLOB", "TIMESTAMP WITH TIME ZONE"]
    assert res.rows() == [(2**63 + 5, [1, None], {"x": 1, "y": "a"}, datetime.time(1, 2, 3),
                           datetime.timedelta(seconds=5), b"\x00c",
                           datetime.datetime(1970, 1, 1, 0, 0, 1, tzinfo=datetime.timezone.utc)),
                          (None, None, None, None, None, None, None)]
    assert tcon.sql("SELECT u + 1 FROM t WHERE u IS NOT NULL").rows() == [(2**63 + 6,)]
    theirs = jcon.sql("SELECT * FROM t").rows()
    assert theirs[0][6] == datetime.datetime(1970, 1, 1, 0, 0, 1)  # TIMESTAMP, no zone
    assert theirs[0][0] == 2**63 + 5 - 2**64
    assert theirs[0][1] == "[1, None]" and theirs[0][2] == "{'x': 1, 'y': 'a'}"


def test_from_arrow_refuses_what_it_cannot_hold():
    con = duckdb_tpu_torch.connect(device="cpu")
    wide = pa.table({"big": pa.array([decimal.Decimal(10) ** 30], pa.decimal128(38, 0))})
    with pytest.raises(ConversionException, match='"big"'):
        con.from_arrow(wide, "w")
    odd = pa.table({"mdn": pa.array([(1, 2, 3)], pa.month_day_nano_interval())})
    with pytest.raises(BindError, match='"mdn" of format "tin"'):
        con.from_arrow(odd, "o")
    with pytest.raises(InvalidInputException, match="__arrow_c_stream__"):
        con.from_arrow([1, 2], "x")
    # a decimal128 that fits int64 reads, whatever its declared width
    fits = pa.table({"d": pa.array([decimal.Decimal("1.5")], pa.decimal128(38, 1))})
    assert con.from_arrow(fits, "f").fetchall() == [(decimal.Decimal("1.5"),)]


def test_the_ports_own_export_imports_back_with_pyarrow_blocked(tmp_path):
    """The card's case: no pyarrow. The port's export of a result with every
    flat type, NULLs, a LIST and a STRUCT, read back by its own from_arrow,
    whole and in batches, gives the same rows."""
    script = tmp_path / "roundtrip.py"
    script.write_text(f"""
import sys
sys.modules["pyarrow"] = None
sys.path.insert(0, {ROOT!r})
import duckdb_tpu_torch
from duckdb_tpu_torch.api import arrow_interop as AI
con = duckdb_tpu_torch.connect(device="cpu")
for s in {FLAT_SETUP!r} + {NESTED_SETUP!r}:
    con.sql(s)
sql = ("SELECT flat.*, nested.*, TIME '01:02:03' AS tm, INTERVAL 3 DAY AS iv "
       "FROM flat POSITIONAL JOIN nested")
res = con.sql(sql)
con.from_arrow(res.arrow(), "back")
con.from_arrow(res.fetch_record_batch(2), "batched")
want = res.rows()
assert con.sql("SELECT * FROM back").rows() == want, con.sql("SELECT * FROM back").rows()
assert con.sql("SELECT * FROM batched").rows() == want
# the JAX package's import types: the narrow integers INTEGER, FLOAT (exported
# as float64) DOUBLE, HUGEINT (decimal128(38, 0)) DECIMAL(38,0)
widen = {{"TINYINT": "INTEGER", "SMALLINT": "INTEGER", "FLOAT": "DOUBLE",
         "HUGEINT": "DECIMAL(38,0)"}}
assert [repr(t) for t in con.sql("SELECT * FROM back").types] == [
    widen.get(repr(t), repr(t)) for t in res.types]
try:
    import pyarrow  # noqa: F401
    raise SystemExit("pyarrow imported")
except ImportError:
    pass
del res
import gc; gc.collect()
assert AI.live_structs() == 0, AI.live_structs()
print("ok")
""")
    out = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                         timeout=120, env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-3000:]


def test_capsules_consumed_or_dropped_release_every_struct(cons):
    _, tcon = cons
    res = tcon.sql("SELECT l_orderkey, l_comment, [l_linenumber] AS l FROM lineitem LIMIT 50")
    before = AI.live_structs()
    cap = res.arrow().__arrow_c_stream__()
    scap = res.arrow().__arrow_c_schema__()
    assert AI.live_structs() > before
    del cap, scap  # dropped unconsumed
    assert AI.live_structs() == before
    t = pa.table(res.arrow())  # consumed: pyarrow releases what it took
    reader = pa.RecordBatchReader.from_stream(res.fetch_record_batch(7))
    next(iter(reader))
    del t, reader  # a stream half read, then dropped
    assert AI.live_structs() == before == 0


def test_df_and_from_df_equal_the_jax_package(cons):
    jcon, tcon = cons
    import pandas as pd

    sql = "SELECT * FROM flat"
    mine, theirs = tcon.sql(sql).df(), jcon.sql(sql).df()
    assert list(mine.columns) == list(theirs.columns)
    assert mine.astype(str).equals(theirs.astype(str))
    assert tcon.table("flat").df().astype(str).equals(theirs.astype(str))
    df = pd.DataFrame({"a": [1, 2, None], "b": [0.5, float("nan"), 2.0],
                       "c": [True, False, True], "d": ["x", None, "z"],
                       "e": pd.to_datetime(["2020-01-01", None, "2021-06-01"])})
    tcon.from_df(df, "pdf")
    jcon.from_df(df, "pdf")
    q = "SELECT * FROM pdf ORDER BY a NULLS LAST"
    assert tcon.sql(q).rows() == jcon.sql(q).rows()
    assert [repr(t) for t in tcon.sql(q).types] == ["DOUBLE", "DOUBLE", "BOOLEAN", "VARCHAR",
                                                    "VARCHAR"]
    old = duckdb_tpu_torch._default_con
    duckdb_tpu_torch._default_con = tcon
    try:
        rel = duckdb_tpu_torch.from_df(pd.DataFrame({"k": [1, 2]}), "mod_df")
        assert rel.fetchall() == [(1,), (2,)]
        assert duckdb_tpu_torch.from_arrow(pa.table({"z": [3]}), "mod_arrow").fetchall() == [
            (3,)]
    finally:
        duckdb_tpu_torch._default_con = old


def test_pandas_missing_is_named(monkeypatch):
    con = duckdb_tpu_torch.connect(device="cpu")
    monkeypatch.setitem(sys.modules, "pandas", None)
    with pytest.raises(InvalidInputException, match="needs the pandas package"):
        con.sql("SELECT 1").df()
    with pytest.raises(InvalidInputException, match="needs the pandas package"):
        con.from_df(object(), "x")
    with pytest.raises(InvalidInputException, match="Relation.df\\(\\) needs the pandas"):
        con.sql("CREATE TABLE t (a INT)")
        con.table("t").df()


def test_an_empty_stream_imports_with_its_types():
    """A stream of no batches (pyarrow's empty table, the port's empty
    export) registers an empty table whose types come from the schema."""
    con = duckdb_tpu_torch.connect(device="cpu")
    con.from_arrow(pa.table({"a": pa.array([], pa.int64()), "s": pa.array([], pa.string()),
                             "l": pa.array([], pa.list_(pa.int32())),
                             "d": pa.array([], pa.string()).dictionary_encode()}), "e")
    res = con.sql("SELECT * FROM e")
    assert res.rows() == [] and [repr(t) for t in res.types] == ["BIGINT", "VARCHAR",
                                                                 "INTEGER[]", "VARCHAR"]
    con.from_arrow(con.sql("SELECT 1 AS x, 'y' AS y WHERE false").arrow(), "e2")
    assert con.sql("SELECT count(*), min(y) FROM e2").rows() == [(0, None)]
