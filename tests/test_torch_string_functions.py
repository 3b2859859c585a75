"""String functions and || in duckdb_tpu_torch (device="cpu").

The plane ops (`ops/strings`: case, substring, trim, concatenation with a
constant, contains, prefix, suffix, the decode of a result plane) are held
against the JAX package's (`duckdb_tpu.ops.strings`, jnp on the CPU) on the
same seeded byte planes: empty strings, full-width strings and ragged
lengths, planes and lengths equal. Through SQL, over the port's generator's
tables at SF 0.01 seed 7, substring, upper/lower, trim/ltrim/rtrim, length,
contains, starts_with/prefix, suffix and || are compared with the JAX
package on both routes: the host loop (dictionaries under
DEVICE_STR_MIN_DICT) and the device plane ops (the threshold patched low in
both packages, since c_phone has 1,500 values here). Every `||` route is
taken: a constant suffix or prefix, the product of two small dictionaries,
and the per-row host concatenation. substring's start of 0 and negative
start are held to DuckDB's answers, where the JAX package is wrong (ROADMAP
Queue 3).
"""

import numpy as np
import pytest
import torch

import duckdb_tpu
import duckdb_tpu_torch
from duckdb_tpu.ops import strings as JS
from duckdb_tpu_torch.ops import strings as TS
from duckdb_tpu_torch.planner import binder as TBinder
from duckdb_tpu_torch.planner import functions as TF
from duckdb_tpu_torch.testing.tpch_gen import write_tables

torch.set_num_threads(1)


def _plane(seed=5, n=300, width=16):
    """(uint8 plane (n, width), lengths): ASCII over letters, digits and
    blanks (blanks lead and trail often), ragged lengths with empty and
    full-width rows, zero past each length."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, width + 1, n)
    lens[:3] = (0, width, 1)
    alphabet = np.frombuffer(b"abcXYZ019 .-", np.uint8)
    plane = alphabet[rng.integers(0, len(alphabet), (n, width))]
    plane[rng.random((n, width)) < 0.15] = ord(" ")
    plane = np.where(np.arange(width)[None, :] < lens[:, None], plane, 0).astype(np.uint8)
    return plane, lens


def _both(fn_t, fn_j, *args):
    plane, lens = _plane()
    got = fn_t(torch.from_numpy(plane), torch.from_numpy(lens.astype(np.int64)), *args)
    want = fn_j(JS.jnp.asarray(plane), JS.jnp.asarray(lens.astype(np.int32)), *args)
    return got, want


def _eq(got, want):
    if isinstance(got, tuple):
        for g, w in zip(got, want):
            _eq(g, w)
        return
    g, w = got.numpy(), np.asarray(want)
    assert g.shape == w.shape
    assert np.array_equal(g.astype(np.int64), w.astype(np.int64))


TRANSFORMS = [
    ("op_case", (True,)), ("op_case", (False,)),
    ("op_substring", (0, 2)), ("op_substring", (3, None)), ("op_substring", (5, 4)),
    ("op_substring", (15, 7)), ("op_substring", (16, 3)), ("op_substring", (40, None)),
    ("op_substring", (0, 0)),
    ("op_trim", (b" ", True, True)), ("op_trim", (b" ", True, False)),
    ("op_trim", (b" ", False, True)), ("op_trim", (b" a.", True, True)),
    ("op_concat_const", ("", "-x")), ("op_concat_const", ("pre", "")),
    ("op_concat_const", ("<", ">")), ("op_concat_const", ("", "")),
]


@pytest.mark.parametrize("op,args", TRANSFORMS, ids=[f"{o}{a}" for o, a in TRANSFORMS])
def test_plane_transform_matches_jax(op, args):
    """Plane and lengths equal the reference op's, zero past each length."""
    got, want = _both(getattr(TS, op), getattr(JS, op), *args)
    _eq(got, want)
    out, lens = got
    tail = torch.arange(out.shape[1])[None, :] >= lens[:, None]
    assert not out[tail].any()


PREDICATES = [
    ("op_contains", "a"), ("op_contains", " 0"), ("op_contains", ""),
    ("op_contains", "x" * 20), ("op_prefix", "a"), ("op_prefix", "ab"), ("op_prefix", ""),
    ("op_prefix", "y" * 17), ("op_suffix", "c"), ("op_suffix", "9 "), ("op_suffix", ""),
    ("op_suffix", "z" * 17),
]


@pytest.mark.parametrize("op,needle", PREDICATES, ids=[f"{o}({n!r})" for o, n in PREDICATES])
def test_plane_predicate_matches_jax(op, needle):
    got, want = _both(getattr(TS, op), getattr(JS, op), needle)
    _eq(got, want)


@pytest.mark.parametrize("needle", [b"a", b"0a", b"abcXYZ019 .-abcXY"])
def test_find_windows_matches_jax(needle):
    got, want = _both(TS._find_windows, JS._find_windows, needle)
    if want is None:
        assert got is None
    else:
        _eq(got, want)


def test_mask_tail_and_decode_match_jax():
    plane, lens = _plane(seed=9)
    tp = torch.from_numpy(plane)
    tl = torch.from_numpy(np.maximum(lens - 2, 0).astype(np.int64))
    masked = TS._mask_tail(tp, tl)
    _eq(masked, JS._mask_tail(JS.jnp.asarray(plane), JS.jnp.asarray(tl.numpy().astype(np.int32))))
    remap, uniq = TS._decode_plane(masked, tl)
    jremap, juniq = JS._decode_plane(JS.jnp.asarray(masked.numpy()), JS.jnp.asarray(tl.numpy()))
    assert np.array_equal(remap, jremap) and list(uniq) == list(juniq)
    # the decode gives each row its text
    for i in range(len(lens)):
        assert uniq[remap[i]] == bytes(plane[i, :tl[i]]).decode()


def test_device_luts_match_jax_and_cache():
    """device_transform_lut / device_value_lut / device_lens_lut on a
    dictionary: the same remap, dictionary and LUTs as the reference's;
    a second call is served from the cache (no new plane-op event)."""
    plane, lens = _plane(seed=11, n=500)
    dvals = np.array(sorted({bytes(r[:n]).decode() for r, n in zip(plane, lens)}), dtype=object)
    fn = lambda p, le: TS.op_substring(p, le, 1, 3)  # noqa: E731
    jfn = lambda p, le: JS.op_substring(p, le, 1, 3)  # noqa: E731
    remap, uniq = TS.device_transform_lut(dvals, "t:sub13", fn, torch.device("cpu"))
    jremap, juniq = JS.device_transform_lut(dvals, "t:sub13", jfn)
    assert np.array_equal(remap.numpy(), jremap) and list(uniq) == list(juniq)
    n_events = len(TS.device_str_events)
    again = TS.device_transform_lut(dvals, "t:sub13", fn, torch.device("cpu"))
    assert again[0] is remap and len(TS.device_str_events) == n_events
    lut = TS.device_value_lut(dvals, "t:pre_a", lambda p, le: TS.op_prefix(p, le, "a"),
                              torch.device("cpu"))
    jlut = JS.device_value_lut(dvals, "t:pre_a", lambda p, le: JS.op_prefix(p, le, "a"))
    assert np.array_equal(lut.numpy(), jlut)
    assert np.array_equal(TS.device_lens_lut(dvals, torch.device("cpu")).numpy(),
                          JS.device_lens_lut(dvals))


def test_non_ascii_dictionary_takes_the_host_path():
    dvals = np.array(["abc", "héllo", "zz"], dtype=object)
    assert TS.device_transform_lut(dvals, "t:case", lambda p, le: TS.op_case(p, le, True),
                                   torch.device("cpu")) is None


# -- through SQL ---------------------------------------------------------------
@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("tpch_gen_strings")
    write_tables(str(root), 0.01, seed=7)
    return str(root)


@pytest.fixture(scope="module")
def cons(data_dir):
    jcon = duckdb_tpu.connect()
    jcon.load_tpch(data_dir)
    tcon = duckdb_tpu_torch.connect(device="cpu")
    tcon.load_tpch(data_dir)
    return jcon, tcon


SQL = {
    "substring": "SELECT c_custkey, substring(c_phone, 1, 2), substr(c_phone, 4), "
                 "substring(c_name FROM 10 FOR 3), substring(c_comment, 5, 0), "
                 "substring(c_phone, 20) FROM customer",
    "case": "SELECT c_custkey, upper(c_comment), lower(c_name), ucase(c_mktsegment), "
            "lcase(c_phone) FROM customer",
    "trim": "SELECT c_custkey, trim(c_comment), ltrim(c_comment), rtrim(c_comment), "
            "trim(c_phone, '1-'), ltrim(c_name, 'Cus') FROM customer",
    "length": "SELECT c_custkey, length(c_comment), len(c_phone), strlen(c_name) FROM customer",
    "predicates": "SELECT c_custkey, contains(c_comment, 'the'), starts_with(c_phone, '1'), "
                  "prefix(c_comment, 'a'), suffix(c_name, '9'), contains(c_phone, '') "
                  "FROM customer",
    "concat_const": "SELECT c_custkey, c_phone || '-x', '+' || c_phone, c_name || '' "
                    "FROM customer",
    "in_where": "SELECT count(*), sum(c_acctbal) FROM customer "
                "WHERE substring(c_phone, 1, 2) IN ('13', '31', '23') "
                "AND contains(lower(c_comment), 'the') AND length(trim(c_comment)) > 20",
    "nested": "SELECT c_custkey, upper(substring(trim(c_comment), 2, 5)) || '|' "
              "FROM customer WHERE starts_with(upper(c_mktsegment), 'BUILD')",
}


def _rows(con, sql):
    return sorted(con.sql(sql).rows())


@pytest.mark.parametrize("route", ["host", "device"])
@pytest.mark.parametrize("name", sorted(SQL))
def test_sql_matches_jax(cons, monkeypatch, name, route):
    """Both routes, both packages: the threshold patched low sends c_phone,
    c_comment and c_name (1,500 values each) through the plane ops."""
    jcon, tcon = cons
    if route == "device":
        monkeypatch.setattr(TS, "DEVICE_STR_MIN_DICT", 100)
        monkeypatch.setattr(JS, "DEVICE_STR_MIN_DICT", 100)
    n_dev = len(TS.device_str_events)
    got = _rows(tcon, SQL[name])
    assert got == _rows(jcon, SQL[name])
    assert (len(TS.device_str_events) > n_dev) == (route == "device")


def test_device_route_events(data_dir, monkeypatch):
    """A large dictionary runs the plane op once, not the host loop, and a
    warm query reads the cached LUT."""
    monkeypatch.setattr(TS, "DEVICE_STR_MIN_DICT", 100)
    tcon = duckdb_tpu_torch.connect(device="cpu")
    tcon.load_tpch(data_dir)
    TS.device_str_events.clear()
    TS.host_loop_events.clear()
    sql = "SELECT substring(c_phone, 1, 2) AS cc, count(*) FROM customer GROUP BY cc ORDER BY cc"
    first = tcon.sql(sql).rows()
    assert TS.device_str_events == [("substr:1:2", 1500)]
    assert TS.host_loop_events == []
    assert tcon.sql(sql).rows() == first and len(TS.device_str_events) == 1
    assert [cc for cc, _ in first] == sorted({cc for cc, _ in first})


def test_host_loop_over_large_dictionary_is_recorded(data_dir, monkeypatch):
    """A non-ASCII argument sends a large dictionary to the host loop, and
    the loop is recorded."""
    monkeypatch.setattr(TS, "DEVICE_STR_MIN_DICT", 100)
    tcon = duckdb_tpu_torch.connect(device="cpu")
    tcon.load_tpch(data_dir)
    TS.host_loop_events.clear()
    (n,), = tcon.sql("SELECT count(*) FROM customer WHERE contains(c_comment, 'é')").rows()
    assert n == 0 and TS.host_loop_events == [("contains:é", 1500)]


CONCAT = {
    # two small dictionaries: one LUT over their product
    "product": "SELECT o_orderkey, o_orderstatus || o_orderpriority FROM orders",
    # near-unique on both sides: per row on the host
    "rows": "SELECT o_orderkey, o_comment || o_clerk FROM orders WHERE o_orderkey < 2000",
    "null": "SELECT o_orderkey, o_orderstatus || NULL, NULL || o_clerk, "
            "CASE WHEN o_orderkey % 3 = 0 THEN NULL ELSE o_orderstatus END || 'z' "
            "FROM orders WHERE o_orderkey < 200",
}


@pytest.mark.parametrize("name", sorted(CONCAT))
def test_concat_routes_match_jax(cons, name):
    jcon, tcon = cons
    assert _rows(tcon, CONCAT[name]) == _rows(jcon, CONCAT[name])


def test_concat_host_route_when_the_product_is_large(cons, monkeypatch):
    """Above CONCAT_PRODUCT_LIMIT pairs the rows concatenate on the host."""
    jcon, tcon = cons
    monkeypatch.setattr(TBinder, "CONCAT_PRODUCT_LIMIT", 4)
    sql = CONCAT["product"]
    assert _rows(tcon, sql) == _rows(jcon, sql)


def test_concat_prefix_and_suffix_of_one_string_stay_apart(cons, monkeypatch):
    """`s || '*'` and `'*' || s` over one dictionary cache two LUTs. The
    JAX package keys both as 'concat:*:*' on its device route, so its second
    column repeats the first (ROADMAP Queue 3); the port is held to SQL."""
    _, tcon = cons
    monkeypatch.setattr(TS, "DEVICE_STR_MIN_DICT", 100)
    sql = "SELECT c_phone || '*', '*' || c_phone, c_phone FROM customer"
    rows = tcon.sql(sql).rows()
    assert len(rows) == 1500
    assert all(a == p + "*" and b == "*" + p for a, b, p in rows)


def test_concat_of_a_number_says_not_ported(cons):
    """|| casts a number to VARCHAR first, as the reference does; an
    INTERVAL operand casts to DuckDB's text ('1 day'), where the reference
    gives its microseconds (ROADMAP item 47)."""
    jcon, tcon = cons
    sql = "SELECT o_orderkey, o_orderstatus || o_orderkey, o_totalprice || '' FROM orders"
    assert _rows(tcon, sql) == _rows(jcon, sql)
    sql = "SELECT DISTINCT o_orderstatus || INTERVAL 1 DAY FROM orders"
    assert sorted(tcon.sql(sql).rows()) == [("F1 day",), ("O1 day",), ("P1 day",)]
    assert sorted(jcon.sql(sql).rows()) != [("F1 day",), ("O1 day",), ("P1 day",)]


# substring by DuckDB's rules (substring.cpp): the JAX package slices
# Python strings at start - 1, which gives '' for a start of 0 and takes
# one character too many for a negative start
SUBSTRING_DUCKDB = [
    ("substring(r_name, 0, 2)", ["A", "A", "A", "E", "M"]),
    ("substring(r_name, -3)", ["ICA", "ICA", "SIA", "OPE", "AST"]),
    ("substring(r_name, -3, 2)", ["IC", "IC", "SI", "OP", "AS"]),
    ("substring(r_name, 3, -2)", ["AF", "AM", "AS", "EU", "MI"]),
    ("substring(r_name, 0)", ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]),
    ("substring(r_name, -20, 3)", ["AFR", "AME", "ASI", "EUR", "MID"]),
]


@pytest.mark.parametrize("route", ["host", "device"])
@pytest.mark.parametrize("expr,want", SUBSTRING_DUCKDB, ids=[e for e, _ in SUBSTRING_DUCKDB])
def test_substring_follows_duckdb(cons, monkeypatch, expr, want, route):
    _, tcon = cons
    if route == "device":
        monkeypatch.setattr(TS, "DEVICE_STR_MIN_DICT", 1)
    got = [r[0] for r in tcon.sql(f"SELECT {expr} FROM region ORDER BY r_name").rows()]
    assert got == want


# DuckDB's SubstringStartEnd: a positive start counts from 1, a negative one
# from the end (clamped at the first character), a start of 0 begins one
# character before the first; a negative length takes the characters before
# the start
@pytest.mark.parametrize("s,start,length,want", [
    ("AFRICA", 0, 2, "A"), ("AFRICA", -3, None, "ICA"), ("AFRICA", 3, -2, "AF"),
    ("AFRICA", 1, 100, "AFRICA"), ("", 1, 2, ""), ("ab", 5, None, ""),
    ("abcdef", -10, 8, "abcdef"), ("abcdef", 0, None, "abcdef"), ("abc", 2, 0, ""),
    ("abcdef", -2, -2, "cd"), ("abcdef", 0, 1, ""), ("abcdef", 2, -5, "a")])
def test_duckdb_substring_rules(s, start, length, want):
    assert TF.duckdb_substring(s, start, length) == want


@pytest.mark.parametrize("table,col", [("customer", "c_phone"), ("customer", "c_comment"),
                                       ("part", "p_name"), ("orders", "o_comment")])
def test_plane_checks_agree_on_cpu(cons, table, col):
    """testing/plane_checks (which chip_smoke.py runs on the card at SF1):
    every plane op equals its host function over the dictionary."""
    from duckdb_tpu_torch.testing import plane_checks

    _, tcon = cons
    dvals = tcon.catalog.get_table(table).host_column(col)[2]
    assert plane_checks.check_dictionary(dvals, torch.device("cpu")) == []
