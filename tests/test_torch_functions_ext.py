"""The extended scalar function library (planner/functions_ext.py) in
duckdb_tpu_torch (device="cpu"), against duckdb_tpu and DuckDB's answers.

Every function the reference registers in its functions_ext.py but
nextval/currval (which need CREATE SEQUENCE: tests/test_torch_sequences_types.py) runs
through SQL in both packages over the port's generator's tables at SF
0.01, seed 7: math, conditionals, strings, dates and the misc family, on
the host route and, for the string functions with a plane op, on the
device route (DEVICE_STR_MIN_DICT patched low in both packages). NULLs
come from nullif and CASE; dates before 1970 from make_date, held to
Python's calendar. DOUBLE results are held to 1e-9 relative (1e-12
absolute near zero): torch's and XLA's transcendental functions may
differ in the last ulp. Where the reference differs from DuckDB the port
is held to DuckDB: greatest/least with a NULL argument, right() with a
negative count, mod's exact truncation, to_hex, time_bucket's origin,
uuid() and random() per row.
"""

import datetime
import re
import uuid

import pytest
import torch

import duckdb_tpu
import duckdb_tpu_torch
from duckdb_tpu.ops import strings as JS
from duckdb_tpu.planner import functions_ext as JE
from duckdb_tpu_torch.ops import strings as TS
from duckdb_tpu_torch.planner import functions_ext as TE
from duckdb_tpu_torch.testing.tpch_gen import write_tables

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("tpch_gen_functions_ext")
    write_tables(str(root), 0.01, seed=7)
    return str(root)


@pytest.fixture(scope="module")
def cons(data_dir):
    jcon = duckdb_tpu.connect()
    jcon.load_tpch(data_dir)
    tcon = duckdb_tpu_torch.connect(device="cpu")
    tcon.load_tpch(data_dir)
    return jcon, tcon


def _close(got, want):
    assert len(got) == len(want), (len(got), len(want))
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=1e-9, abs=1e-12, nan_ok=True), (g, w)
            else:
                assert a == b and type(a) is type(b), (g, w)


_LI = "FROM lineitem WHERE l_orderkey < 400 ORDER BY l_orderkey, l_linenumber"
SQL = {
    "math_unary": "SELECT l_orderkey, l_linenumber, ln(l_extendedprice), log2(l_quantity), "
                  "log10(l_extendedprice), log(l_quantity), exp(l_discount), sin(l_tax), "
                  "cos(l_tax), tan(l_discount), asin(l_discount), acos(l_tax), atan(l_quantity), "
                  "sinh(l_discount), cosh(l_tax), tanh(l_quantity), degrees(l_tax), "
                  f"radians(l_quantity), cbrt(l_extendedprice), cbrt(-l_quantity) {_LI}",
    "math_more": "SELECT l_orderkey, l_linenumber, pow(l_quantity, 2), power(l_tax, 0.5), "
                 "atan2(l_tax, l_discount), pi(), sign(l_discount - 0.05), sign(l_linenumber - 3), "
                 "gamma(l_linenumber), lgamma(l_quantity), even(l_quantity / 3), "
                 "even(-l_quantity / 3), factorial(l_linenumber), trunc(-l_extendedprice / 7), "
                 "gcd(l_orderkey, l_partkey), lcm(l_linenumber, l_suppkey), bit_count(l_partkey), "
                 "mod(l_partkey, l_linenumber), nextafter(l_tax, 1), isfinite(l_tax), "
                 f"isnan(l_tax), isinf(ln(l_discount)) {_LI}",
    "math_constants": "SELECT ln(2.0), log2(8), cbrt(27), pow(2, 10), factorial(20), gcd(12, 18), "
                      "lcm(4, 6), bit_count(255), mod(17, 5), nextafter(1.0, 2.0), even(2.5)",
    "conditionals": "SELECT o_orderkey, nullif(o_orderstatus, 'F'), nullif(o_custkey % 5, 2), "
                    "ifnull(nullif(o_shippriority, 0), -1), if(o_totalprice > 100000, 'big', "
                    "o_orderpriority), iif(o_orderkey % 2 = 0, o_custkey, NULL), "
                    "greatest(o_custkey, o_orderkey), least(o_totalprice, 50000) "
                    "FROM orders WHERE o_orderkey < 3000",
    "strings": "SELECT c_custkey, reverse(c_name), left(c_name, 3), left(c_name, -3), "
               "right(c_phone, 4), lpad(c_name, 20, 'xy'), rpad(c_mktsegment, 12, '-'), "
               "lpad(c_phone, 5, '*'), repeat(c_mktsegment, 2), initcap(c_comment), "
               "strpos(c_comment, 'the'), position(c_phone, '-'), instr(c_name, '00'), "
               "ascii(c_comment) FROM customer",
    "strings_host": "SELECT c_custkey, replace(c_name, '0', 'o'), split_part(c_phone, '-', 2), "
                    "md5(c_name), translate(c_phone, '-1', '_I'), regexp_matches(c_comment, "
                    "'the[a-z]'), regexp_replace(c_comment, '[aeiou]', '_'), "
                    "regexp_extract(c_phone, '([0-9]+)-', 1), levenshtein(c_mktsegment, "
                    "'BUILDING'), editdist3(c_mktsegment, 'HOUSE'), hamming(c_mktsegment, "
                    "'BUILDING'), mismatches(c_mktsegment, 'MACHINERY'), hex(c_mktsegment), "
                    "unicode(c_name), ord(c_comment), ends_with(c_name, '7'), suffix(c_phone, '9') "
                    "FROM customer",
    "string_constants": "SELECT concat_ws('-', 'a', 'b', 'c'), chr(65), "
                        "concat('a', NULL, 'b', 3), uuid_extract_version("
                        "'a0eebc99-9c0b-4ef8-bb6d-6bb9bd380a11'), "
                        "uuid_extract_timestamp('01890a5d-ac96-774b-bcce-b302099a8057')",
    "concat_format": "SELECT o_orderkey, concat(o_orderstatus, '-', o_orderkey, NULL), "
                     "format('{}-{}', o_orderkey, o_orderstatus), printf('%d:%s', o_orderkey, "
                     "o_orderstatus), bar(o_totalprice, 0, 500000, 20) FROM orders "
                     "WHERE o_orderkey < 500",
    "dates": "SELECT o_orderkey, date_trunc('year', o_orderdate), date_trunc('quarter', "
             "o_orderdate), datetrunc('month', o_orderdate), date_trunc('week', o_orderdate), "
             "date_trunc('day', o_orderdate), last_day(o_orderdate), date_diff('day', o_orderdate, "
             "DATE '1999-01-01'), datediff('month', o_orderdate, DATE '1999-01-01'), "
             "date_diff('year', DATE '1990-06-01', o_orderdate), date_diff('week', o_orderdate, "
             "DATE '1999-01-01'), dayname(o_orderdate), monthname(o_orderdate), "
             "strftime(o_orderdate, '%d/%m/%Y'), epoch(o_orderdate), week(o_orderdate), "
             "weekofyear(o_orderdate), isodow(o_orderdate), age(o_orderdate, DATE '1990-01-01'), "
             "time_bucket(INTERVAL '1 day', o_orderdate) FROM orders WHERE o_orderkey < 3000",
    "timestamps": "SELECT o_orderkey, date_trunc('month', CAST(o_orderdate AS TIMESTAMP)), "
                  "strftime(CAST(o_orderdate AS TIMESTAMP), '%Y-%m-%d %H'), "
                  "epoch(CAST(o_orderdate AS TIMESTAMP)), make_date(1990, o_orderkey % 12 + 1, "
                  "o_orderkey % 28 + 1), strptime('2020-03-04 05:06:07', '%Y-%m-%d %H:%M:%S') "
                  "FROM orders WHERE o_orderkey < 2000",
    "misc": "SELECT o_orderkey, typeof(o_totalprice), typeof(o_orderdate), typeof(o_comment), "
            "typeof(o_orderkey), typeof(CAST(o_orderkey AS DOUBLE)), hash(o_orderkey), "
            "hash(o_custkey % 7) FROM orders WHERE o_orderkey < 1000",
    "grouped": "SELECT o_orderpriority, sum(ln(o_totalprice)), max(reverse(o_clerk)), "
               "min(dayname(o_orderdate)), sum(gcd(o_orderkey, 12)), max(greatest(o_custkey, 700)) "
               "FROM orders GROUP BY 1 ORDER BY 1",
}


@pytest.mark.parametrize("route", ["host", "device"])
@pytest.mark.parametrize("name", sorted(SQL))
def test_function_matches_jax(cons, monkeypatch, name, route):
    jcon, tcon = cons
    if route == "device":
        monkeypatch.setattr(TS, "DEVICE_STR_MIN_DICT", 100)
        monkeypatch.setattr(JS, "DEVICE_STR_MIN_DICT", 100)
    got = sorted(tcon.sql(SQL[name]).rows(), key=repr)
    _close(got, sorted(jcon.sql(SQL[name]).rows(), key=repr))


def test_plane_ops_run_on_the_device_route(data_dir, monkeypatch):
    """With the threshold low, left/right/reverse/initcap/lpad/repeat/strpos
    /ascii over c_name, c_phone and c_comment run as plane ops, and none as
    a host loop."""
    monkeypatch.setattr(TS, "DEVICE_STR_MIN_DICT", 100)
    tcon = duckdb_tpu_torch.connect(device="cpu")
    tcon.load_tpch(data_dir)
    TS.device_str_events.clear()
    TS.host_loop_events.clear()
    tcon.sql(SQL["strings"]).rows()
    ops = {k.split(":")[0] for k, _ in TS.device_str_events}
    assert {"reverse", "left", "right", "lpad", "initcap", "strpos", "ascii"} <= ops, ops
    assert TS.host_loop_events == []


def test_dates_before_1970(cons):
    """make_date and the calendar functions on dates before the epoch, held
    to Python's calendar (the floor divisions)."""
    _, tcon = cons
    days = [(1969, 12, 31), (1900, 2, 28), (1600, 3, 1), (1, 1, 1), (1955, 8, 17),
            (1904, 2, 29)]
    for y, m, d in days:
        dt = datetime.date(y, m, d)
        got, = tcon.sql(
            f"SELECT make_date({y}, {m}, {d}), last_day(make_date({y}, {m}, {d})), "
            f"dayname(make_date({y}, {m}, {d})), isodow(make_date({y}, {m}, {d})), "
            f"week(make_date({y}, {m}, {d})), year(make_date({y}, {m}, {d})), "
            f"date_trunc('quarter', make_date({y}, {m}, {d})), "
            f"monthname(make_date({y}, {m}, {d}))").rows()
        nxt = datetime.date(y + (m == 12), m % 12 + 1, 1)
        q = datetime.datetime(y, (m - 1) // 3 * 3 + 1, 1)
        assert got == (dt, nxt - datetime.timedelta(days=1), dt.strftime("%A"),
                       dt.isoweekday(), dt.isocalendar()[1], y, q, dt.strftime("%B"))


def test_differences_held_to_duckdb(cons):
    """The reference's right() with a negative count takes from the end,
    its to_hex returns its input, its time_bucket counts from the epoch:
    the port gives DuckDB's answers."""
    _, tcon = cons
    assert tcon.sql("SELECT right('abcdef', -2), left('abcdef', -2), to_hex('az'), "
                    "mod(9007199254740993, 10), "
                    "time_bucket(INTERVAL 7 DAY, DATE '2000-01-10'), "
                    "time_bucket(INTERVAL 7 DAY, DATE '1999-12-31'), "
                    "time_bucket(INTERVAL 1 MONTH, DATE '1992-05-17')").rows() == [
        ("cdef", "abcd", "617A", 3, datetime.date(2000, 1, 10), datetime.date(1999, 12, 27),
         datetime.date(1992, 5, 1))]


def test_greatest_least_over_strings(cons):
    """Over VARCHAR the port compares the strings (the reference loses the
    dictionary and raises on materializing)."""
    _, tcon = cons
    rows = tcon.sql("SELECT o_orderstatus, o_orderpriority, o_clerk, "
                    "greatest(o_orderstatus, o_orderpriority), "
                    "least(o_orderstatus, o_orderpriority, o_clerk) "
                    "FROM orders WHERE o_orderkey < 500").rows()
    assert rows
    for a, b, c, g, lo in rows:
        assert g == max(a, b) and lo == min(a, b, c)


def test_now_and_current_date_follow_the_replay_hook(cons, monkeypatch):
    """REPLAY_TIME_MICROS pins now() and current_date in both packages; a
    cached plan reads the clock again on its next run."""
    jcon, tcon = cons
    micros = 1_700_000_000_000_000
    monkeypatch.setattr(TE, "REPLAY_TIME_MICROS", micros)
    monkeypatch.setattr(JE, "REPLAY_TIME_MICROS", micros)
    sql = ("SELECT now(), current_timestamp, current_date, today(), get_current_timestamp(), "
           "transaction_timestamp()")
    assert tcon.sql(sql).rows() == jcon.sql(sql).rows()
    monkeypatch.setattr(TE, "REPLAY_TIME_MICROS", micros + 86_400_000_000)
    (now, *_), = tcon.sql(sql).rows()
    assert now == datetime.datetime(1970, 1, 1) + datetime.timedelta(
        microseconds=micros + 86_400_000_000)


def test_random_and_uuids_per_row(cons):
    _, tcon = cons
    rows = tcon.sql("SELECT random(), uuid(), gen_random_uuid(), uuidv4(), uuidv7() "
                    "FROM nation").rows()
    assert len({r[0] for r in rows}) == 25 and all(0.0 <= r[0] < 1.0 for r in rows)
    for col in range(1, 5):
        vals = [r[col] for r in rows]
        assert len(set(vals)) == 25
        for v in vals:
            u = uuid.UUID(v)
            assert str(u) == v and u.version == (7 if col == 4 else 4)
    (version, ts), = tcon.sql("SELECT uuid_extract_version(uuidv7()), "
                              "uuid_extract_timestamp(uuidv7())").rows()
    assert version == 7 and abs(ts - datetime.datetime.now()) < datetime.timedelta(hours=1)


@pytest.mark.parametrize("sql,match", [
    ("SELECT nextval('s')", 'Sequence with name "s" does not exist'),
    ("SELECT currval('s')", 'Sequence with name "s" does not exist'),
    ("SELECT current_setting('no_such_setting')",
     'unrecognized configuration parameter "no_such_setting"'),
    ("SELECT concat_ws('-', n_name, n_comment) FROM nation", "concat_ws.*not yet ported"),
    ("SELECT hex(n_nationkey) FROM nation", "hex.*not yet ported"),
])
def test_left_out_forms_say_not_ported(cons, sql, match):
    """The forms the port leaves out say so; nextval/currval are ported
    (tests/test_torch_sequences_types.py) and name a missing sequence, and
    current_setting (item 36) an unknown setting."""
    _, tcon = cons
    with pytest.raises(ValueError, match=match):
        tcon.sql(sql).rows()


def test_registry_covers_the_reference(cons):
    """Every name the reference's functions_ext registers is registered in
    the port (nextval/currval as refusals)."""
    from duckdb_tpu.planner.functions import REGISTRY as JREG
    from duckdb_tpu_torch.planner.functions import REGISTRY as TREG

    src = open(JE.__file__).read()
    names = set(re.findall(r'@register\("(\w+)"\)', src))
    names |= set(re.findall(r'REGISTRY\["(\w+)"\]', src))
    names |= set(re.findall(r'_str_transform\("(\w+)"', src))
    names |= set(re.findall(r'_host_int_fn\("(\w+)"', src))
    names |= set(re.findall(r'\("(\w+)", jnp\.', src))
    assert names and names <= set(JREG)
    assert names - set(TREG) == set()
