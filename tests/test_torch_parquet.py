"""Parquet in duckdb_tpu_torch (device="cpu"): the port's own codec
(storage/parquet.py, csrc/parquet_codec.cpp) against pyarrow, which the
port never imports.

The reader against pyarrow.parquet.write_table over every type the JAX
package maps, every codec, data pages v1 and v2, dictionary and PLAIN
encodings, several row groups and NULLs; pyarrow reading the port's
writer with equal values and types; Snappy both ways against pyarrow's
codec; the corner cases (a page of NULLs only, a dictionary that falls
back to PLAIN inside a column chunk, a bit width of 0, a run longer than
a page, DECIMAL(38, 10) in a FIXED_LEN_BYTE_ARRAY, negative decimals, a
TIMESTAMP with a time zone, a file of no rows, a nested column); the
Parquet cases of tests/test_io.py through both packages; lazy columns;
and I4 held to DuckDB.
"""

import datetime
import decimal

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import duckdb_tpu
import duckdb_tpu_torch
from duckdb_tpu_torch.errors import ConversionException
from duckdb_tpu_torch.execution.executor import Result
from duckdb_tpu_torch.storage import parquet as P

from _torch_parity import run_both

torch.set_num_threads(1)

N = 700


def _table(seed: int = 0, n: int = N) -> pa.Table:
    rng = np.random.default_rng(seed)

    def nulls(values, every):
        return [None if i % every == 0 else v for i, v in enumerate(values)]

    dec = decimal.Decimal
    return pa.table({
        "b": pa.array(nulls([bool(x) for x in rng.integers(0, 2, n)], 7)),
        "i8": pa.array(rng.integers(-128, 128, n), pa.int8()),
        "i16": pa.array(rng.integers(-2**15, 2**15, n), pa.int16()),
        "i32": pa.array(nulls([int(x) for x in rng.integers(-2**31, 2**31, n)], 5), pa.int32()),
        "i64": pa.array(rng.integers(-2**62, 2**62, n), pa.int64()),
        "u8": pa.array(rng.integers(0, 256, n), pa.uint8()),
        "u32": pa.array(rng.integers(0, 2**32, n), pa.uint32()),
        "f32": pa.array(rng.standard_normal(n).astype(np.float32)),
        "f64": pa.array(nulls(list(rng.standard_normal(n)), 9)),
        "d9": pa.array([dec(int(x)).scaleb(-2) for x in rng.integers(-10**8, 10**8, n)],
                       pa.decimal128(9, 2)),
        "d18": pa.array(nulls([dec(int(x)).scaleb(-4) for x in
                               rng.integers(-10**17, 10**17, n)], 3), pa.decimal128(18, 4)),
        "d38": pa.array([dec(int(x)).scaleb(-10) for x in rng.integers(-10**17, 10**17, n)],
                        pa.decimal128(38, 10)),
        "day": pa.array(rng.integers(-1000, 20000, n).astype(np.int32), pa.date32()),
        "ts_us": pa.array(rng.integers(-2**50, 2**50, n), pa.timestamp("us")),
        "ts_ms": pa.array(rng.integers(-2**40, 2**40, n), pa.timestamp("ms")),
        "ts_ns": pa.array(rng.integers(-2**60, 2**60, n), pa.timestamp("ns")),
        "s": pa.array(nulls([f"v{x}é" for x in rng.integers(0, 40, n)], 11)),
        "s_unique": pa.array([f"row {i} {'x' * (i % 13)}" for i in range(n)]),
    })


def _python_values(table: pa.Table, name: str) -> list:
    """A pyarrow column as the port's Result.rows() gives it."""
    col = table.column(name)
    t = col.type
    out = col.to_pylist()
    if pa.types.is_timestamp(t):
        unit = {"s": 10**6, "ms": 1000, "us": 1, "ns": 1}[t.unit]
        ints = col.cast(pa.int64()).to_pylist()
        epoch = datetime.datetime(1970, 1, 1)
        return [None if v is None else epoch + datetime.timedelta(
            microseconds=v * unit if t.unit != "ns" else v // 1000) for v in ints]
    if pa.types.is_float32(t):
        return [None if v is None else float(np.float32(v)) for v in out]
    return out


def _port_values(path: str, name: str) -> list:
    pf = P.ParquetFile(path)
    t = dict(pf.schema)[name]
    return [r[0] for r in Result([name], [t], [P.load_column(path, name, pf)], pf.nrows).rows()]


@pytest.mark.parametrize("codec", ["none", "snappy", "gzip", "zstd"])
@pytest.mark.parametrize("version", ["1.0", "2.0"])
@pytest.mark.parametrize("dictionary", [True, False])
def test_reader_against_pyarrow(tmp_path, codec, version, dictionary):
    table = _table(seed=len(codec) + (version == "2.0") + 2 * dictionary)
    path = str(tmp_path / "a.parquet")
    pq.write_table(table, path, compression=codec, data_page_version=version,
                   use_dictionary=dictionary, row_group_size=256)
    pf = P.ParquetFile(path)
    assert len(pf.row_groups) == 3 and pf.nrows == N
    types = {n: str(t) for n, t in pf.schema}
    assert types == {"b": "BOOLEAN", "i8": "TINYINT", "i16": "SMALLINT", "i32": "INTEGER",
                     "i64": "BIGINT", "u8": "BIGINT", "u32": "BIGINT", "f32": "FLOAT",
                     "f64": "DOUBLE", "d9": "DECIMAL(9,2)", "d18": "DECIMAL(18,4)",
                     "d38": "DECIMAL(38,10)", "day": "DATE", "ts_us": "TIMESTAMP",
                     "ts_ms": "TIMESTAMP", "ts_ns": "TIMESTAMP", "s": "VARCHAR",
                     "s_unique": "VARCHAR"}
    for name in table.column_names:
        assert _port_values(path, name) == _python_values(table, name), name


def test_pyarrow_reads_the_port_writer(tmp_path, monkeypatch):
    """Every type the writer takes, with NULLs and several row groups (of
    1,000 rows here, DuckDB's 122,880 on the card): the values and the
    types pyarrow reads back."""
    monkeypatch.setattr(P, "ROW_GROUP_ROWS", 1000)
    rng = np.random.default_rng(9)
    n = 2 * P.ROW_GROUP_ROWS + 77
    valid = rng.random(n) > 0.2
    strings = np.array(["", "a", "bé", "longer value"], dtype=object)
    cols = [(rng.random(n) > 0.5, valid, None),
            (rng.integers(-128, 128, n).astype(np.int8), None, None),
            (rng.integers(-2**15, 2**15, n).astype(np.int16), valid, None),
            (rng.integers(-2**31, 2**31, n).astype(np.int32), None, None),
            (rng.integers(-2**62, 2**62, n), valid, None),
            (rng.standard_normal(n).astype(np.float32), None, None),
            (rng.standard_normal(n), valid, None),
            (rng.integers(-10**8, 10**8, n).astype(np.int32), None, None),
            (rng.integers(-10**17, 10**17, n), valid, None),
            (rng.integers(-10**17, 10**17, n), None, None),
            (rng.integers(-1000, 20000, n).astype(np.int32), valid, None),
            (rng.integers(-2**50, 2**50, n), valid, None),
            (rng.integers(0, len(strings), n).astype(np.int32), valid, strings)]
    from duckdb_tpu_torch.types import (BIGINT, BOOLEAN, DATE, DOUBLE, FLOAT, INTEGER,
                                        SMALLINT, TIMESTAMP, TINYINT, VARCHAR, decimal as dec)

    types = [BOOLEAN, TINYINT, SMALLINT, INTEGER, BIGINT, FLOAT, DOUBLE, dec(9, 2), dec(18, 4),
             dec(38, 10), DATE, TIMESTAMP, VARCHAR]
    names = [f"c{i}" for i in range(len(types))]
    want_types = [pa.bool_(), pa.int8(), pa.int16(), pa.int32(), pa.int64(), pa.float32(),
                  pa.float64(), pa.decimal128(9, 2), pa.decimal128(18, 4),
                  pa.decimal128(38, 10), pa.date32(), pa.timestamp("us"), pa.string()]
    rows = Result(names, types, cols, n).rows()
    for codec in ("snappy", "uncompressed", "gzip", "zstd"):
        path = str(tmp_path / f"{codec}.parquet")
        P.write_parquet(path, names, types, cols, n, codec)
        table = pq.read_table(path)
        assert table.schema.types == want_types
        assert pq.ParquetFile(path).metadata.num_row_groups == 3
        for k, name in enumerate(names):
            assert _python_values(table, name) == [r[k] for r in rows], (codec, name)
            assert _port_values(path, name) == [r[k] for r in rows], (codec, name)


def test_snappy_against_pyarrow():
    rng = np.random.default_rng(2)
    for data in (b"", b"a", b"abcd" * 5000, rng.integers(0, 256, 100_000, dtype=np.uint8)
                 .tobytes(), bytes(range(256)) * 300 + b"tail",
                 rng.integers(0, 4, 200_000, dtype=np.uint8).tobytes()):
        mine = P.snappy_compress(data)
        codec = pa.Codec("snappy")
        assert codec.decompress(mine, decompressed_size=len(data)).to_pybytes() == data
        assert P.snappy_decompress(codec.compress(data).to_pybytes()) == data
        assert P.snappy_decompress(mine) == data


def test_rle_hybrid_runs_and_bit_width_zero():
    # a run of 5 sevens (bit width 3), then 8 bit-packed values 0..7
    buf = bytes([5 << 1, 7, (1 << 1) | 1]) + np.packbits(
        ((np.arange(8)[:, None] >> np.arange(3)) & 1).astype(np.uint8).reshape(-1),
        bitorder="little").tobytes()
    assert P.rle_hybrid(buf, 3, 13).tolist() == [7] * 5 + list(range(8))
    # bit width 0: a run carries no value bytes, and every value is 0
    assert P.rle_hybrid(bytes([10 << 1]), 0, 10).tolist() == [0] * 10


def test_a_page_of_nulls_only_and_a_run_longer_than_a_page(tmp_path):
    n = 5000
    table = pa.table({"allnull": pa.array([None] * n, pa.int64()),
                      "half": pa.array([None] * (n // 2) + list(range(n // 2)), pa.int32()),
                      "same": pa.array(["one value"] * n)})
    path = str(tmp_path / "n.parquet")
    pq.write_table(table, path, data_page_size=512, compression="snappy")
    assert pq.ParquetFile(path).metadata.row_group(0).column(2).num_values == n
    for name in table.column_names:
        assert _port_values(path, name) == _python_values(table, name)
    values, valid, _ = P.load_column(path, "allnull")
    assert not valid.any()


def test_dictionary_falls_back_to_plain_inside_a_chunk(tmp_path):
    """pyarrow stops the dictionary past its page limit and writes the rest
    of the column chunk PLAIN."""
    n = 20_000
    table = pa.table({"s": pa.array([f"value number {i}" for i in range(n)]),
                      "i": pa.array(np.arange(n) * 7919 % 100_003, pa.int64())})
    path = str(tmp_path / "f.parquet")
    pq.write_table(table, path, dictionary_pagesize_limit=4096, data_page_size=4096)
    encodings = pq.ParquetFile(path).metadata.row_group(0).column(0).encodings
    assert "PLAIN" in encodings and "RLE_DICTIONARY" in encodings
    for name in table.column_names:
        assert _port_values(path, name) == _python_values(table, name)


def test_decimal_38_10_in_fixed_len_byte_array(tmp_path):
    """DECIMAL(38, 10) reads as the port's CREATE TABLE holds it (int64);
    negative values too; a value past int64 raises, naming the column."""
    dec = decimal.Decimal
    vals = [dec("-12345678.0123456789"), dec("0.0000000001"), dec("-0.0000000001"), None,
            dec("922337203.6854775807")]
    path = str(tmp_path / "d.parquet")
    pq.write_table(pa.table({"d": pa.array(vals, pa.decimal128(38, 10))}), path)
    el = P.ParquetFile(path).columns[0][2]
    assert el[1] == P.FIXED_T
    assert _port_values(path, "d") == vals
    con = duckdb_tpu_torch.connect(device="cpu")
    con.sql("CREATE TABLE t (d DECIMAL(38, 10))")
    con.sql(f"COPY t FROM '{path}'")
    assert [r[0] for r in con.sql("SELECT d FROM t").rows()] == vals
    big = str(tmp_path / "big.parquet")
    pq.write_table(pa.table({"wide": pa.array([dec("1"), dec("9" * 28)],
                                              pa.decimal128(38, 10))}), big)
    with pytest.raises(ConversionException, match='"wide"'):
        con.sql(f"SELECT * FROM '{big}'")


def test_timestamp_with_a_time_zone(tmp_path):
    """A UTC-adjusted TIMESTAMP reads as its UTC instant, TIMESTAMP as the
    JAX package maps it."""
    path = str(tmp_path / "tz.parquet")
    pq.write_table(pa.table({"t": pa.array([0, 1577934245000000, None],
                                           pa.timestamp("us", tz="UTC"))}), path)
    _, tcon = run_both([f"SELECT t FROM '{path}'"])
    assert tcon.sql(f"SELECT t FROM '{path}'").rows() == [
        (datetime.datetime(1970, 1, 1),), (datetime.datetime(2020, 1, 2, 3, 4, 5),), (None,)]


def test_a_file_of_no_rows(tmp_path):
    path = str(tmp_path / "empty.parquet")
    pq.write_table(pa.table({"a": pa.array([], pa.int64()), "s": pa.array([], pa.string())}),
                   path)
    run_both([f"SELECT count(*), sum(a) FROM '{path}'", f"SELECT * FROM '{path}'"])
    con = duckdb_tpu_torch.connect(device="cpu")
    con.sql(f"COPY (SELECT * FROM '{path}') TO '{tmp_path}/again.parquet'")
    assert pq.read_table(f"{tmp_path}/again.parquet").num_rows == 0


def test_a_nested_column_raises_naming_it(tmp_path):
    """A LIST of flat values reads (item 49); a LIST of LISTs raises,
    naming its column."""
    path = str(tmp_path / "nested.parquet")
    pq.write_table(pa.table({"k": [1], "tags": pa.array([[[1, 2]]])}), path)
    with pytest.raises(ValueError, match='"tags"'):
        duckdb_tpu_torch.connect(device="cpu").sql(f"SELECT k FROM '{path}'")


# -- tests/test_io.py's Parquet case, lazy columns, and I4 ----------------------------------

def test_parquet_round_trip(tmp_path):
    csv_file = tmp_path / "people.csv"
    csv_file.write_text("name,age,score,joined\nalice,30,9.5,2020-01-15\nbob,25,,2021-06-01\n"
                        "carol,35,7.25,2019-12-31\n")
    jcon, tcon = duckdb_tpu.connect(), duckdb_tpu_torch.connect(device="cpu")
    for side, con in (("j", jcon), ("t", tcon)):
        con.sql("CREATE TABLE p (name VARCHAR, age INT, score DOUBLE, joined DATE)")
        con.sql(f"COPY p FROM '{csv_file}' (HEADER)")
        con.sql(f"COPY p TO '{tmp_path}/{side}.parquet' (FORMAT PARQUET)")
    for side in ("j", "t"):  # each package reads both files
        run_both([f"SELECT name, joined FROM '{tmp_path}/{side}.parquet' ORDER BY name",
                  f"SELECT count(*) FROM '{tmp_path}/{side}.parquet' WHERE score IS NULL"],
                 cons=(jcon, tcon))


def test_columns_load_lazily(tmp_path, monkeypatch):
    """A query decodes only the columns it touches."""
    path = str(tmp_path / "lazy.parquet")
    pq.write_table(_table(seed=4), path)
    decoded = []
    real = P.load_column
    monkeypatch.setattr(P, "load_column", lambda p, name, pf=None: decoded.append(name)
                        or real(p, name, pf))
    con = duckdb_tpu_torch.connect(device="cpu")
    got = con.sql(f"SELECT sum(i64), count(s) FROM read_parquet('{path}')").rows()
    assert sorted(decoded) == ["i64", "s"]
    t = pq.read_table(path)
    assert got == [(sum(t.column("i64").to_pylist()),
                    sum(v is not None for v in t.column("s").to_pylist()))]


def test_i4_copy_to_parquet_keeps_a_timestamp(tmp_path):
    """I4: a TIMESTAMP written to Parquet reads back as a TIMESTAMP (the
    JAX package writes its int64 micros, which read back as a BIGINT)."""
    jcon, tcon = duckdb_tpu.connect(), duckdb_tpu_torch.connect(device="cpu")
    want = [(datetime.datetime(2020, 1, 2, 3, 4, 5),)]
    for side, con in (("j", jcon), ("t", tcon)):
        con.sql("CREATE TABLE t (ts TIMESTAMP)")
        con.sql("INSERT INTO t VALUES (TIMESTAMP '2020-01-02 03:04:05')")
        con.sql(f"COPY t TO '{tmp_path}/{side}.parquet' (FORMAT PARQUET)")
    sql = "SELECT ts FROM '{}/{}.parquet'"
    assert tcon.sql(sql.format(tmp_path, "t")).rows() == want
    assert jcon.sql(sql.format(tmp_path, "j")).rows() == [(1577934245000000,)]
    assert pq.read_table(f"{tmp_path}/t.parquet").schema.types == [pa.timestamp("us")]


# -- the committed fixtures (tools/make_torch_io_fixtures.py) -------------------------------

def _fixture_cases():
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    import chip_smoke

    return chip_smoke.fixture_cases()


@pytest.mark.parametrize("case", _fixture_cases(), ids=lambda c: c[0].rsplit("/", 1)[-1])
def test_committed_fixtures(case):
    """The files phase 20 of chip_smoke.py reads on the card, where there is
    no pyarrow: the port reads the expected rows, and so does pyarrow (or
    Python's json), which wrote them."""
    import json
    import os

    path, sql, want = case
    assert os.path.getsize(path) < 100_000
    assert duckdb_tpu_torch.connect(device="cpu").sql(sql).rows() == want
    if path.endswith(".parquet"):
        table = pq.read_table(path)
        key = table.column_names.index(json.load(open(path + ".expected.json"))["order_by"])
        cols = [_python_values(table, n) for n in table.column_names]
        assert sorted(zip(*cols), key=lambda r: r[key]) == want


# -- F31: UINT64 and unannotated BYTE_ARRAY, held to DuckDB --------------------------------

def test_f31_uint64_reads_as_hugeint_and_binary_as_blob(tmp_path):
    """A Parquet UINT64 past 2^63 reads exactly, as HUGEINT (DuckDB's UBIGINT,
    which neither package has), and a BYTE_ARRAY with no string annotation
    as BLOB, as DuckDB reads them. The JAX package reads the first as a
    negative BIGINT and the second as the text of its Python bytes."""
    path = str(tmp_path / "f31.parquet")
    pq.write_table(pa.table({
        "k": pa.array([1, 2, 3, 4], pa.int64()),
        "u": pa.array([2**63 + 5, None, 2**64 - 1, 7], pa.uint64()),
        "b": pa.array([b"\x00c", b"", None, b"\xff"], pa.binary()),
    }), path)
    sql = f"SELECT k, u, b, typeof(u), typeof(b) FROM '{path}' ORDER BY k"
    con = duckdb_tpu_torch.connect(device="cpu")
    assert con.sql(sql).rows() == [
        (1, 2**63 + 5, b"\x00c", "HUGEINT", "BLOB"), (2, None, b"", "HUGEINT", "BLOB"),
        (3, 2**64 - 1, None, "HUGEINT", "BLOB"), (4, 7, b"\xff", "HUGEINT", "BLOB")]
    assert con.sql(f"SELECT sum(u), max(u), count(b) FROM '{path}' WHERE u > 6").rows() == [
        (2**63 + 5 + 2**64 - 1 + 7, 2**64 - 1, 2)]
    jrows = duckdb_tpu.connect().sql(f"SELECT k, u, b FROM '{path}' ORDER BY k").rows()
    assert jrows[0][1] == 2**63 + 5 - 2**64 and jrows[0][2] == "b'\\x00c'"


# -- item 49: LIST, STRUCT and TIME columns, held to DuckDB --------------------------------

@pytest.mark.parametrize("version", ["1.0", "2.0"])
@pytest.mark.parametrize("dictionary", [True, False])
def test_item49_list_struct_and_time_read_as_duckdb_reads_them(tmp_path, version, dictionary):
    """An optional LIST of optional elements (pyarrow's three-level
    encoding), an optional STRUCT of flat fields and TIME in ms and us read
    as LIST, STRUCT and TIME, over several row groups and both page
    versions. The JAX package reads their Python text as VARCHAR."""
    rng = np.random.default_rng(5)
    n = 300
    ints = [None if i % 7 == 0 else [] if i % 11 == 0 else
            [None if (i + j) % 5 == 0 else int(x) + j for j in range(i % 4 + 1)]
            for i, x in enumerate(rng.integers(-50, 50, n))]
    t = pa.table({
        "k": pa.array(np.arange(n), pa.int64()),
        "l": pa.array(ints, pa.list_(pa.int32())),
        "ls": pa.array([None if i % 9 == 0 else [f"w{(i + j) % 4}" for j in range(i % 3)]
                        for i in range(n)], pa.list_(pa.string())),
        "s": pa.array([None if i % 10 == 0 else {"x": None if i % 4 == 0 else i, "y": f"y{i % 6}",
                                                "d": decimal.Decimal(i).scaleb(-2)}
                       for i in range(n)],
                      pa.struct([("x", pa.int64()), ("y", pa.string()),
                                 ("d", pa.decimal128(9, 2))])),
        "t32": pa.array([None if i % 12 == 0 else i * 1000 for i in range(n)], pa.time32("ms")),
        "t64": pa.array([i * 1_000_001 for i in range(n)], pa.time64("us")),
    })
    path = str(tmp_path / "n.parquet")
    pq.write_table(t, path, data_page_version=version, use_dictionary=dictionary,
                   row_group_size=64)
    res = duckdb_tpu_torch.connect(device="cpu").sql(f"SELECT * FROM '{path}' ORDER BY k")
    assert [repr(x) for x in res.types] == [
        "BIGINT", "INTEGER[]", "VARCHAR[]", "STRUCT(x BIGINT, y VARCHAR, d DECIMAL(9,2))",
        "TIME", "TIME"]
    assert res.rows() == [tuple(r.values()) for r in t.to_pylist()]
    jrow = duckdb_tpu.connect().sql(f"SELECT * FROM '{path}' ORDER BY k").rows()[1]
    assert isinstance(jrow[1], str) and isinstance(jrow[3], str) and isinstance(jrow[4], str)


def test_item49_deeper_nesting_raises_naming_the_column(tmp_path):
    import os

    deep = os.path.join(os.path.dirname(__file__), "data", "torch_io", "nested_deep.parquet")
    with pytest.raises(ValueError, match='"ll", nested deeper'):
        duckdb_tpu_torch.connect(device="cpu").sql(f"SELECT * FROM '{deep}'")
    path = str(tmp_path / "sl.parquet")
    pq.write_table(pq.read_table(deep).select(["k", "sl"]), path)
    with pytest.raises(ValueError, match='"sl", nested deeper'):
        duckdb_tpu_torch.connect(device="cpu").sql(f"SELECT k FROM '{path}'")


def test_item49_copy_to_writes_list_and_time_columns(tmp_path):
    """COPY TO Parquet writes an INTEGER[], a VARCHAR[] and a TIME column in
    the three-level encoding and as TIME(us): pyarrow and the port read them
    back. The JAX package writes an INTEGER[] as its code, 0."""
    import datetime

    con = duckdb_tpu_torch.connect(device="cpu")
    con.sql("CREATE TABLE src (k INTEGER, l INTEGER[], s VARCHAR[], t TIME)")
    con.sql("INSERT INTO src VALUES (1, [1, NULL, 3], ['a', NULL], TIME '01:02:03'), "
            "(2, NULL, NULL, NULL), (3, [4], ['b', 'c', 'b'], TIME '23:59:59.5')")
    con.sql("INSERT INTO src SELECT range + 10, [range::INTEGER], ['x' || range], "
            "TIME '00:00:01' FROM range(130000)")
    path = str(tmp_path / "out.parquet")
    con.sql(f"COPY (SELECT * FROM src ORDER BY k) TO '{path}' (FORMAT PARQUET)")
    back = pq.read_table(path)
    assert back.schema.field("l").type.value_type == pa.int32()
    assert back.schema.field("s").type.value_type == pa.string()
    assert back.schema.field("t").type == pa.time64("us")
    assert pq.ParquetFile(path).metadata.num_row_groups == 2
    assert back.slice(0, 3).to_pylist() == [
        {"k": 1, "l": [1, None, 3], "s": ["a", None], "t": datetime.time(1, 2, 3)},
        {"k": 2, "l": None, "s": None, "t": None},
        {"k": 3, "l": [4], "s": ["b", "c", "b"], "t": datetime.time(23, 59, 59, 500000)}]
    assert con.sql(f"SELECT * FROM '{path}' ORDER BY k").rows() == \
        con.sql("SELECT * FROM src ORDER BY k").rows()
    jpath = str(tmp_path / "jax.parquet")
    duckdb_tpu.connect().sql(f"COPY (SELECT [1, 2] AS l) TO '{jpath}' (FORMAT PARQUET)")
    assert pq.read_table(jpath).to_pylist() == [{"l": 0}]
