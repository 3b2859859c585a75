"""CSV in duckdb_tpu_torch (device="cpu"): storage/csv.py and csrc/csv2col.cpp
against duckdb_tpu and Python's csv module.

The sniffer against the JAX package's sniff_csv on seeded files; the CSV
cases of tests/test_io.py and tests/test_persistence.py through both
packages (tests/_torch_parity.run_both); the tokenizer against
csv.reader on quoted fields, escaped quotes, embedded newlines and CRLF,
over a file large enough to be split between threads; the writer byte
for byte against csv.writer; every integer width; and the reference
faults I1-I3 held to DuckDB, each asserting that the JAX package still
differs.
"""

import csv
import datetime
import decimal
import io
import os

import numpy as np
import pytest
import torch

import duckdb_tpu
import duckdb_tpu_torch
from duckdb_tpu.storage import csv as jcsv
from duckdb_tpu_torch.errors import ConversionException
from duckdb_tpu_torch.execution.executor import Result
from duckdb_tpu_torch.storage import csv as tcsv
from duckdb_tpu_torch.types import (BIGINT, BOOLEAN, DATE, DOUBLE, FLOAT, TIMESTAMP, TINYINT,
                                    VARCHAR, decimal as dec)

from _torch_parity import run_both

torch.set_num_threads(1)


def _tcon():
    return duckdb_tpu_torch.connect(device="cpu")


# -- the sniffer -------------------------------------------------------------------------

def _seeded_file(tmp_path, kind: str, seed: int) -> str:
    rng = np.random.default_rng(seed)
    n = 50
    delim = {"comma": ",", "pipe": "|", "tab": "\t", "semicolon": ";"}.get(kind, ",")
    ints = rng.integers(-1000, 1000, n)
    cols = {"id": [str(i) for i in range(n)], "v": [str(x) for x in ints],
            "price": [f"{x:.2f}" for x in rng.random(n) * 100],
            "day": [str(datetime.date(1995, 1, 1) + datetime.timedelta(days=int(d)))
                    for d in rng.integers(0, 2000, n)],
            "flag": [str(bool(b)).lower() for b in rng.integers(0, 2, n)],
            "name": [f"n{x}" for x in rng.integers(0, 10, n)]}
    header = True
    if kind == "big_ints":
        cols["v"] = [str(int(x) * 10**7) for x in ints]  # past 2^31
    elif kind == "all_varchar":
        cols = {"a": [f"x{i}" for i in range(n)], "b": [f"y{i % 3}" for i in range(n)]}
    elif kind == "no_header":
        header = False
    elif kind == "nulls":
        cols["v"] = ["" if i % 4 == 0 else x for i, x in enumerate(cols["v"])]
    lines = [delim.join(cols)] if header else []
    lines += [delim.join(c[i] for c in cols.values()) for i in range(n)]
    p = tmp_path / f"{kind}.csv"
    p.write_text("\n".join(lines) + "\n")
    return str(p)


@pytest.mark.parametrize("kind", ["comma", "pipe", "tab", "semicolon", "big_ints",
                                  "all_varchar", "no_header", "nulls"])
def test_sniffer_against_the_reference(tmp_path, kind):
    path = _seeded_file(tmp_path, kind, seed=len(kind))
    jd, jh, js = jcsv.sniff_csv(path)
    td, th, ts = tcsv.sniff_csv(path)
    assert (td, th) == (jd, jh)
    assert [(n, str(t)) for n, t in ts] == [(n, str(t)) for n, t in js]
    if kind == "big_ints":
        assert dict(ts)["v"] == BIGINT


def test_sniffer_finds_timestamps_as_duckdb_does(tmp_path):
    """DuckDB sniffs TIMESTAMP; the JAX package reads such a column as
    VARCHAR."""
    p = tmp_path / "ts.csv"
    p.write_text("k,ts\n1,2020-01-02 03:04:05\n2,2021-02-03 04:05:06.5\n")
    assert dict(tcsv.sniff_csv(str(p))[2])["ts"] == TIMESTAMP
    assert str(dict(jcsv.sniff_csv(str(p))[2])["ts"]) == "VARCHAR"
    con = _tcon()
    assert con.sql(f"SELECT ts FROM '{p}' ORDER BY k").rows() == [
        (datetime.datetime(2020, 1, 2, 3, 4, 5),),
        (datetime.datetime(2021, 2, 3, 4, 5, 6, 500000),)]


# -- tests/test_io.py's and tests/test_persistence.py's CSV cases ---------------------------

@pytest.fixture()
def csv_file(tmp_path):
    p = tmp_path / "people.csv"
    p.write_text("name,age,score,joined\n"
                 "alice,30,9.5,2020-01-15\n"
                 "bob,25,,2021-06-01\n"
                 "carol,35,7.25,2019-12-31\n")
    return str(p)


def test_file_replacement_scan(csv_file):
    run_both([f"SELECT name, age FROM '{csv_file}' ORDER BY age"])


def test_read_csv_function(csv_file):
    run_both([f"SELECT count(*), avg(age) FROM read_csv('{csv_file}')",
              f"SELECT count(*), avg(age) FROM read_csv_auto('{csv_file}')"])


def test_csv_null_sniffing(csv_file):
    run_both([f"SELECT name FROM '{csv_file}' WHERE score IS NULL"])


def test_copy_from_and_to(csv_file, tmp_path):
    outs = [tmp_path / "j.csv", tmp_path / "t.csv"]
    script = ["CREATE TABLE p (name VARCHAR, age INT, score DOUBLE, joined DATE)",
              f"COPY p FROM '{csv_file}' (HEADER)", "SELECT count(*) FROM p"]
    jcon, tcon = run_both(script)
    for con, out in zip((jcon, tcon), outs):
        con.sql(f"COPY (SELECT name, age*2 AS dbl FROM p ORDER BY name) TO '{out}'")
    assert outs[1].read_text().splitlines() == outs[0].read_text().splitlines()
    assert outs[1].read_text().splitlines()[:2] == ["name,dbl", "alice,60"]


def test_copy_from_appends(csv_file):
    run_both(["CREATE TABLE p (name VARCHAR, age INT, score DOUBLE, joined DATE)",
              f"COPY p FROM '{csv_file}' (HEADER)", f"COPY p FROM '{csv_file}' (HEADER)",
              "SELECT count(*) FROM p", "SELECT count(DISTINCT name) FROM p"])


def test_csv_decimal_exact(tmp_path):
    """DECIMAL wider than 15 digits loads exactly (no float64 trip)."""
    p = tmp_path / "d.csv"
    p.write_text("a\n12345678901234567.89\n-0.005\n1e2\n")
    _, tcon = run_both(["CREATE TABLE t (a DECIMAL(19,2))", f"COPY t FROM '{p}' (HEADER)",
                        "SELECT a FROM t"])
    assert tcon.sql("SELECT a FROM t").rows() == [
        (decimal.Decimal("12345678901234567.89"),), (decimal.Decimal("-0.01"),),
        (decimal.Decimal("100.00"),)]


@pytest.mark.parametrize("text,scale,want", [
    ("1.5", 2, 150), ("-1.5", 2, -150), ("12345678901234567.89", 2, 1234567890123456789),
    (".5", 1, 5), ("3", 2, 300), ("0.005", 2, 1), ("-0.005", 2, -1), ("1e2", 1, 1000),
    ("0.0049", 2, 0), ("2.5e-1", 1, 3)])
def test_parse_decimal_text_unit(tmp_path, text, scale, want):
    """The Python parse and csv2col's agree with the JAX package's."""
    assert jcsv.parse_decimal_text(text, scale) == want
    assert tcsv.parse_decimal_text(text, scale) == want
    p = tmp_path / "one.csv"
    p.write_text(f"{text}\n")
    got = tcsv.load_csv(str(p), [("a", dec(19, scale))], ",", False)["a"][0]
    assert int(got[0]) == want


# -- the tokenizer --------------------------------------------------------------------------

def test_tokenizer_against_csv_reader(tmp_path):
    """Quoted delimiters, doubled quotes, embedded newlines, CRLF rows and
    text after a closing quote, over a file of several MiB, which csv2col
    splits between threads (never inside a quoted field)."""
    rng = np.random.default_rng(3)
    pieces = ["plain", "with,comma", 'say "hi"', "two\nlines", "crlf\r\nin", "", "é ü",
              "trailing ", " lead"]
    n = 60_000
    picks = rng.integers(0, len(pieces), (n, 2))
    buf = io.StringIO(newline="")
    w = csv.writer(buf, lineterminator="\r\n" if n % 2 else "\n")
    rows = []
    for i in range(n):
        r = [str(i), pieces[picks[i, 0]] + str(i % 7), pieces[picks[i, 1]]]
        rows.append(r)
        w.writerow(r)
    p = tmp_path / "tok.csv"
    p.write_bytes(buf.getvalue().encode("utf-8"))
    assert os.path.getsize(p) > (1 << 20)
    cols = tcsv.load_csv(str(p), [("i", BIGINT), ("a", VARCHAR), ("b", VARCHAR)], ",", False)
    with open(p, newline="", encoding="utf-8") as f:
        want = list(csv.reader(f))
    assert len(cols["i"][0]) == len(want) == n
    assert cols["i"][0].tolist() == [int(r[0]) for r in want]
    for k, name in ((1, "a"), (2, "b")):
        codes, valid, d = cols[name]
        got = [None if valid is not None and not valid[i] else d[codes[i]] for i in range(n)]
        # csv.writer quotes an empty field only when it is the row's only
        # one, so an empty string here is unquoted: NULL (DuckDB's rule)
        assert got == [v if v != "" else None for v in (r[k] for r in want)]


def test_integer_widths_and_overflow(tmp_path):
    p = tmp_path / "w.csv"
    p.write_text("t,s,i,b,f,o\n-128,32767,-2147483648,9223372036854775807,1.5,true\n"
                 "127,-32768,2147483647,-9223372036854775808,-0.25,F\n")
    con = _tcon()
    con.sql("CREATE TABLE w (t TINYINT, s SMALLINT, i INTEGER, b BIGINT, f FLOAT, o BOOLEAN)")
    assert con.sql(f"COPY w FROM '{p}' (HEADER)").rows() == [(2,)]
    assert con.sql("SELECT * FROM w").rows() == [
        (-128, 32767, -2147483648, 9223372036854775807, 1.5, True),
        (127, -32768, 2147483647, -9223372036854775808, -0.25, False)]
    bad = tmp_path / "bad.csv"
    bad.write_text("t,s,i,b,f,o\n128,0,0,0,0,true\n")
    with pytest.raises(ConversionException, match=r'"128".*TINYINT.*column "t".*line 2'):
        con.sql(f"COPY w FROM '{bad}' (HEADER)")
    assert con.sql("SELECT count(*) FROM w").rows() == [(2,)]


def test_a_row_past_the_sample_that_breaks_the_sniffed_type(tmp_path):
    """The sniffer reads 2,048 rows; a later value that is not an integer
    raises ConversionException naming the line, column and type (the JAX
    package raises a bare ValueError from int())."""
    p = tmp_path / "late.csv"
    p.write_text("k,v\n" + "".join(f"{i},{i}\n" for i in range(3000)) + "3000,oops\n")
    with pytest.raises(ConversionException,
                       match=r'"oops" to \'INTEGER\' in column "v", at line 3002'):
        _tcon().sql(f"SELECT sum(v) FROM '{p}'")
    with pytest.raises(ValueError):
        duckdb_tpu.connect().sql(f"SELECT sum(v) FROM '{p}'").rows()


# -- the writer ------------------------------------------------------------------------------

def test_writer_matches_csv_writer(tmp_path):
    """Whole columns formatted in csv2col give the bytes csv.writer gives
    for Result.rows(), but for the empty string (ROADMAP I2)."""
    rng = np.random.default_rng(5)
    n = 500
    strings = np.array(["", "a", "b,c", 'q"t', "line\nbreak", "ünï", "  sp "], dtype=object)
    doubles = np.concatenate([rng.standard_normal(n - 8) * 10.0 ** rng.integers(-8, 20, n - 8),
                              [0.0, -0.0, 1e16, 1e15, 1e-5, 1e-4, np.inf, 123.0]])
    cols = [(rng.integers(-2**62, 2**62, n), rng.random(n) > 0.1, None),
            (rng.integers(0, len(strings), n).astype(np.int32), rng.random(n) > 0.1, strings),
            (doubles, None, None),
            (rng.standard_normal(n).astype(np.float32), None, None),
            (rng.integers(-10**12, 10**12, n), None, None),
            (rng.integers(-30000, 30000, n).astype(np.int32), None, None),
            (rng.integers(-2**55, 2**55, n), None, None),
            (rng.random(n) > 0.5, None, None),
            (rng.integers(-100, 100, n).astype(np.int8), None, None),
            (rng.integers(-10**6, 10**6, n).astype(np.int32), None, None)]
    types = [BIGINT, VARCHAR, DOUBLE, FLOAT, dec(18, 4), DATE, TIMESTAMP, BOOLEAN, TINYINT,
             dec(9, 2)]
    names = [f"c{i}" for i in range(len(types))]
    out = tmp_path / "w.csv"
    tcsv.write_csv(str(out), names, types, cols, n)
    rows = Result(names, types, cols, n).rows()
    buf = io.StringIO(newline="")
    w = csv.writer(buf)
    w.writerow(names)
    for r in rows:
        w.writerow(["" if v is None else v for v in r])
    want = buf.getvalue().encode("utf-8")
    got = out.read_bytes()
    # the one difference: csv.writer writes the empty string bare
    assert got.replace(b',"",', b",,") == want
    assert got.count(b',"",') == sum(1 for r in rows if r[1] == "")


def test_writer_delimiter_header_and_quote(tmp_path):
    out = tmp_path / "o.tbl"
    con = _tcon()
    con.sql("CREATE TABLE t (a INT, s VARCHAR); INSERT INTO t VALUES (1, 'x|y'), (2, 'p''q')")
    con.sql(f"COPY t TO '{out}' (DELIMITER '|', HEADER false, QUOTE '''')")
    assert out.read_bytes() == b"1|'x|y'\r\n2|'p''q'\r\n"
    con.sql("CREATE TABLE u (a INT, s VARCHAR)")
    assert con.sql(f"COPY u FROM '{out}' (DELIMITER '|', HEADER false, QUOTE '''')"
                   ).rows() == [(2,)]
    assert con.sql("SELECT * FROM u ORDER BY a").rows() == [(1, "x|y"), (2, "p'q")]


# -- the reference faults, held to DuckDB ----------------------------------------------------

def test_i1_a_quoted_empty_field_is_the_empty_string(tmp_path):
    """I1: DuckDB reads `""` as '' and only an unquoted empty field as
    NULL; the JAX package's Python loader reads both as NULL."""
    p = tmp_path / "i1.csv"
    p.write_text('a,b\n1,""\n2,x\n3,\n')
    sql = f"SELECT a, b FROM '{p}' ORDER BY a"
    run_both([sql], duckdb={sql: [(1, ""), (2, "x"), (3, None)]})


def test_i2_copy_to_writes_the_empty_string_quoted(tmp_path):
    """I2: COPY TO writes '' as "" and NULL as nothing, so a round trip
    keeps them apart; the JAX package writes both as nothing."""
    jcon, tcon = duckdb_tpu.connect(), _tcon()
    for side, con in (("j", jcon), ("t", tcon)):
        con.sql("CREATE TABLE t (k INT, s VARCHAR)")
        con.sql("INSERT INTO t VALUES (1, ''), (2, NULL), (3, 'x')")
        con.sql(f"COPY t TO '{tmp_path}/{side}.csv' (HEADER)")
        con.sql("CREATE TABLE r (k INT, s VARCHAR)")
        con.sql(f"COPY r FROM '{tmp_path}/{side}.csv' (HEADER)")
    assert (tmp_path / "t.csv").read_bytes() == b'k,s\r\n1,""\r\n2,\r\n3,x\r\n'
    want = [(1, ""), (2, None), (3, "x")]
    assert tcon.sql("SELECT * FROM r ORDER BY k").rows() == want
    assert jcon.sql("SELECT * FROM r ORDER BY k").rows() != want


def test_i3_copy_from_into_a_timestamp_column(tmp_path):
    """I3: COPY FROM CSV into a TIMESTAMP column reads the timestamps (the
    JAX package raises ValueError from int())."""
    jcon, tcon = duckdb_tpu.connect(), _tcon()
    script = ["CREATE TABLE t (k INT, ts TIMESTAMP)",
              "INSERT INTO t VALUES (1, TIMESTAMP '2020-01-02 03:04:05'), "
              "(2, TIMESTAMP '1969-12-31 23:59:59.5'), (3, NULL)",
              f"COPY t TO '{tmp_path}/ts.csv' (HEADER)",
              "CREATE TABLE t2 (k INT, ts TIMESTAMP)",
              f"COPY t2 FROM '{tmp_path}/ts.csv' (HEADER)",
              "SELECT * FROM t2 ORDER BY k"]
    want = [(1, datetime.datetime(2020, 1, 2, 3, 4, 5)),
            (2, datetime.datetime(1969, 12, 31, 23, 59, 59, 500000)), (3, None)]
    with pytest.raises(ValueError, match="invalid literal for int"):
        for sql in script[:5]:
            jcon.sql(sql)
    for sql in script[:5]:
        tcon.sql(sql)
    assert tcon.sql(script[5]).rows() == want
    assert tcon.sql(script[5]).rows() == tcon.sql("SELECT * FROM t ORDER BY k").rows()


def test_copy_from_sniffs_the_delimiter_and_header(tmp_path):
    p = tmp_path / "lineitem.tbl"
    p.write_text("1|A|12.50|1996-03-13\n2|N|0.01|1997-01-28\n")
    run_both(["CREATE TABLE li (k BIGINT, f VARCHAR, price DECIMAL(15,2), d DATE)",
              f"COPY li FROM '{p}'", "SELECT * FROM li ORDER BY k",
              f"COPY li FROM '{p}' (quote '\"', header 0, delimiter '|')",
              "SELECT count(*), sum(price) FROM li"])
