"""LIKE, NOT LIKE and ILIKE in duckdb_tpu_torch (device="cpu").

The dictionary matcher (`ops/strings.device_like_lut`, torch ops on the
column's device) is held against the JAX package's
(`duckdb_tpu.ops.strings.device_like_lut`, jnp on the CPU) and against
Python `re` on near-unique dictionaries: o_comment (14,989 values) and
ps_comment (8,000) of the port's generator at SF 0.01, seed 7, c_comment
(1,500, under the 4,096-value threshold, so the matcher is called
directly) and a hand-built dictionary with `%`, `_`, `\\`, upper case and
the empty string in its values. Patterns cover prefixes, suffixes, infixes,
several `%`, `_`, `\\` escapes, ILIKE, `''`, `'%'` and a pattern longer
than every value. A non-ASCII dictionary takes the host path. SQL with LIKE
in WHERE, inside CASE under a sum, in a LEFT join's ON over the side that
is not preserved, over NULLs and as `~~` operators is compared with the
JAX package on tables made with `catalog.create_table`.
"""

import re

import numpy as np
import pytest
import torch

import duckdb_tpu
import duckdb_tpu_torch
from duckdb_tpu.ops import strings as JS
from duckdb_tpu_torch.catalog.catalog import ColumnDef, TableEntry
from duckdb_tpu_torch.ops import strings as TS
from duckdb_tpu_torch.planner import bound as TB
from duckdb_tpu_torch.testing.tpch_gen import write_tables
from duckdb_tpu_torch.types import INTEGER, VARCHAR

torch.set_num_threads(1)

PATTERNS = [
    "ab%", "%ing", "%ab%", "%a%b%c%", "a_c%", "%_b", "_", "%\\%%", "%\\_%",
    "%\\\\%", "", "%", "x" * 300, "%special%requests%", "furiously%",
]


def _hand_dict():
    """4,500 distinct ASCII values, 0-24 characters, over letters of both
    cases, digits, blanks and the characters LIKE gives a meaning to."""
    rng = np.random.default_rng(3)
    alphabet = list("abcxyzABCXYZ019 %_\\")
    vals = {""}
    while len(vals) < 4500:
        n = int(rng.integers(0, 25))
        vals.add("".join(rng.choice(alphabet, size=n)))
    return np.array(sorted(vals), dtype=object)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("tpch_gen_like")
    write_tables(str(root), 0.01, seed=7)
    return str(root)


@pytest.fixture(scope="module")
def dicts(data_dir):
    tcon = duckdb_tpu_torch.connect(device="cpu")
    tcon.load_tpch(data_dir)
    out = {"hand": _hand_dict()}
    for table, col in (("orders", "o_comment"), ("partsupp", "ps_comment"),
                       ("customer", "c_comment")):
        out[col] = tcon.catalog.get_table(table).host_column(col)[2]
    return out


def _re_lut(dvals, pattern, ci):
    prog = re.compile(TB.like_to_regex(pattern), re.DOTALL | (re.IGNORECASE if ci else 0))
    return np.array([prog.match(s) is not None for s in dvals])


@pytest.mark.parametrize("ci", [False, True])
@pytest.mark.parametrize("name", ["o_comment", "ps_comment", "c_comment", "hand"])
def test_device_lut_matches_re(dicts, name, ci):
    dvals = dicts[name]
    for pattern in PATTERNS:
        got = TS.device_like_lut(dvals, pattern, ci, "cpu")
        np.testing.assert_array_equal(got.numpy(), _re_lut(dvals, pattern, ci),
                                      err_msg=f"{name} {pattern!r} ci={ci}")


@pytest.mark.parametrize("ci", [False, True])
@pytest.mark.parametrize("name", ["o_comment", "ps_comment", "c_comment", "hand"])
def test_device_lut_matches_jax(dicts, name, ci):
    """Each pattern is one jitted program per dictionary width in the JAX
    package."""
    dvals = dicts[name]
    for pattern in PATTERNS:
        want = JS.device_like_lut(dvals, pattern, ci)
        np.testing.assert_array_equal(
            TS.device_like_lut(dvals, pattern, ci, "cpu").numpy(), want,
            err_msg=f"{name} {pattern!r} ci={ci}")


def test_some_patterns_select_some_values(dicts):
    """The comparisons above are not all-False: the hand-built dictionary
    and o_comment hold matches for the escapes and Q13's pattern."""
    for name, pattern in (("hand", "%\\%%"), ("hand", "%\\_%"), ("hand", "%\\\\%"),
                          ("hand", "a_c%"), ("o_comment", "%special%requests%")):
        lut = TS.device_like_lut(dicts[name], pattern, False, "cpu").numpy()
        assert 0 < lut.sum() < len(lut), (name, pattern)


def test_like_lut_routes_by_size_and_ascii(dicts):
    """From 4,096 values the device matcher runs (once per dictionary and
    pattern: the LUT is cached); under it, and for a non-ASCII dictionary,
    the host regex. Both give the same LUT."""
    big = dicts["o_comment"]
    TS.device_like_events.clear()
    first = TB.like_lut(big, "%ironic%", False, "cpu")
    assert TS.device_like_events == [("%ironic%", len(big))]
    assert TB.like_lut(big, "%ironic%", False, "cpu") is first
    assert TS.device_like_events == [("%ironic%", len(big))]
    np.testing.assert_array_equal(first.numpy(), _re_lut(big, "%ironic%", False))

    small = dicts["c_comment"]
    TS.device_like_events.clear()
    lut = TB.like_lut(small, "%ab%", False, "cpu")
    assert TS.device_like_events == []
    np.testing.assert_array_equal(lut.numpy(), _re_lut(small, "%ab%", False))

    accented = np.array(sorted({f"café {i}" for i in range(5000)}), dtype=object)
    assert TS.device_like_lut(accented, "caf%", False, "cpu") is None
    assert JS.device_like_lut(accented, "caf%", False) is None
    TS.host_loop_events.clear()
    lut = TB.like_lut(accented, "café 1%", False, "cpu")
    assert TS.host_loop_events == [("like:café 1%", 5000)]
    np.testing.assert_array_equal(lut.numpy(), _re_lut(accented, "café 1%", False))
    # a non-ASCII pattern over an ASCII dictionary: the host path as well
    assert TS.device_like_lut(big, "%é%", False, "cpu") is None


def test_tokenize_pattern_matches_jax():
    for pattern in PATTERNS + ["a\\", "\\%", "é%"]:
        for ci in (False, True):
            assert TS.tokenize_pattern(pattern, ci) == JS.tokenize_pattern(pattern, ci)


# -- SQL over tables with NULL strings, against the JAX package --------------
WORDS = ["apple", "Apricot", "banana", "cab", "a_c", "50%", "back\\slash", "", "abc"]


def _rows():
    rng = np.random.default_rng(5)
    t = [(None if rng.random() < 0.15 else str(rng.choice(WORDS)), int(x))
         for x in rng.integers(0, 40, 200)]
    u = [(int(k), None if rng.random() < 0.2 else str(rng.choice(WORDS)))
         for k in rng.integers(0, 40, 60)]
    return t, u


T_ROWS, U_ROWS = _rows()


def _entry(name, cols, rows):
    entry = TableEntry(name, [ColumnDef(c, t) for c, t in cols])
    entry.nrows = len(rows)
    for (col, t), values in zip(cols, zip(*rows)):
        valid = np.array([v is not None for v in values])
        if t is VARCHAR:
            dvals = np.array(sorted({v for v in values if v is not None}), dtype=object)
            codes = np.array([0 if v is None else int(np.searchsorted(dvals, v))
                              for v in values], dtype=np.int32)
            entry.set_host_column(col, codes, None if valid.all() else valid, dvals)
        else:
            entry.set_host_column(col, np.array([v or 0 for v in values], dtype=np.int32),
                                  None if valid.all() else valid)
    return entry


def _sql_value(v):
    if v is None:
        return "NULL"
    if isinstance(v, str):
        return "'" + v.replace("'", "''") + "'"
    return str(v)


@pytest.fixture(scope="module")
def cons():
    jcon = duckdb_tpu.connect()
    tcon = duckdb_tpu_torch.connect(device="cpu")
    for name, cols, rows in (("t", (("s", VARCHAR), ("x", INTEGER)), T_ROWS),
                             ("u", (("k", INTEGER), ("s", VARCHAR)), U_ROWS)):
        jcon.sql(f"CREATE TABLE {name} ("
                 + ", ".join(f"{c} {'VARCHAR' if t is VARCHAR else 'INTEGER'}" for c, t in cols)
                 + ")")
        jcon.sql(f"INSERT INTO {name} VALUES " + ", ".join(
            "(" + ", ".join(_sql_value(v) for v in r) + ")" for r in rows))
        tcon.catalog.create_table(_entry(name, cols, rows))
    return jcon, tcon


SQL_CASES = [
    "SELECT count(*) FROM t WHERE s LIKE 'a%'",
    "SELECT x, s FROM t WHERE s NOT LIKE '%b%' ORDER BY x, s",
    "SELECT x, s FROM t WHERE s ILIKE 'A%' ORDER BY x, s",
    "SELECT count(*) FROM t WHERE s NOT ILIKE '%an%'",
    "SELECT count(*) FROM t WHERE s LIKE 'a\\_c'",
    "SELECT count(*) FROM t WHERE s LIKE '%\\%'",
    "SELECT count(*) FROM t WHERE s LIKE '%\\\\%'",
    "SELECT count(*) FROM t WHERE s LIKE ''",
    "SELECT count(*) FROM t WHERE s LIKE '%'",
    "SELECT count(*) FROM t WHERE s ~~ '_a%' OR s !~~* '%A%'",
    "SELECT sum(CASE WHEN s LIKE '%a%' THEN x ELSE 0 END) AS a, count(*) AS n FROM t",
    "SELECT x, sum(CASE WHEN s NOT LIKE 'b%' THEN 1 ELSE 0 END) AS nb FROM t "
    "GROUP BY x ORDER BY x",
    "SELECT t.x, u.k, u.s FROM t LEFT JOIN u ON t.x = u.k AND u.s LIKE '%a%' "
    "ORDER BY t.x, u.k, u.s",
    "SELECT t.x, count(u.k) AS n FROM t LEFT JOIN u ON t.x = u.k AND u.s NOT LIKE 'a%' "
    "GROUP BY t.x ORDER BY t.x",
]


def _sorted(rows):
    return sorted(rows, key=lambda r: tuple((v is None, str(v)) for v in r))


@pytest.mark.parametrize("sql", SQL_CASES)
def test_sql_matches_jax(cons, sql):
    jcon, tcon = cons
    want = jcon.sql(sql).rows()
    assert want
    got = tcon.sql(sql).rows()
    if "ORDER BY" in sql:
        assert got == want
    else:
        assert _sorted(got) == _sorted(want)


def test_like_over_nulls_is_null(cons):
    """NULL LIKE p is NULL: neither LIKE nor NOT LIKE keeps the row."""
    _, tcon = cons
    n_null = sum(s is None for s, _ in T_ROWS)
    assert n_null
    (like,), = tcon.sql("SELECT count(*) FROM t WHERE s LIKE '%'").rows()
    (unlike,), = tcon.sql("SELECT count(*) FROM t WHERE s NOT LIKE '%'").rows()
    assert (like, unlike) == (len(T_ROWS) - n_null, 0)


def test_non_constant_pattern_is_a_bind_error(cons):
    _, tcon = cons
    with pytest.raises(ValueError, match="non-constant LIKE pattern"):
        tcon.sql("SELECT count(*) FROM t, u WHERE t.x = u.k AND t.s LIKE u.s")


@pytest.mark.parametrize("sql", [
    "SELECT count(*) FROM orders WHERE o_comment LIKE '%special%requests%'",
    "SELECT o_orderpriority, count(*) AS n FROM orders "
    "WHERE o_comment NOT ILIKE '%FURIOUSLY%' GROUP BY o_orderpriority "
    "ORDER BY o_orderpriority",
    "SELECT count(*) FROM partsupp WHERE ps_comment LIKE '%a_b%'",
])
def test_tpch_text_columns_match_jax(data_dir, sql):
    """Near-unique TPC-H columns through the device matcher (on the CPU)."""
    jcon = duckdb_tpu.connect()
    jcon.load_tpch(data_dir)
    tcon = duckdb_tpu_torch.connect(device="cpu")
    tcon.load_tpch(data_dir)
    TS.host_loop_events.clear()
    assert tcon.sql(sql).rows() == jcon.sql(sql).rows()
    assert TS.host_loop_events == []
