"""Functions over an argument of the wrong kind (ROADMAP Queue 3, F28-F30),
held to DuckDB through duckdb_tpu_torch (device="cpu"), with the JAX
package's differing answer asserted beside each.

- F30: a string function over a LIST. `repeat` has DuckDB's LIST overload;
  reverse, strlen, lower and the other string-only functions refuse a LIST
  with DuckDB's Binder Error (the port read the LIST's tuples as text).
- F28: a list or map function over a scalar, `split` over numbers, and
  `date_part` with one argument give a Binder Error, never a bare Python
  error. The sweep that found F28: every registered scalar function at
  every argument count functions.ARITY allows, with INTEGER and then
  VARCHAR literals, answers or raises one of the port's typed exceptions.
- F29: a VARCHAR string literal where a function takes a number, a date or
  a time reads as that type (functions.PARAMS records the parameter types),
  as DuckDB reads a literal; text that does not read is a Conversion Error,
  and a VARCHAR column has no overload (Binder Error). Both packages read
  the literal's dictionary code.
"""

import datetime

import pytest
import torch

import duckdb_tpu
import duckdb_tpu_torch
from duckdb_tpu_torch import errors as TE
from duckdb_tpu_torch.planner import binder  # noqa: F401  (registers every function)
from duckdb_tpu_torch.planner import functions as F
from duckdb_tpu_torch.planner.bound import BindError
from duckdb_tpu_torch.planner.macros import MacroError
from duckdb_tpu_torch.sql.parser import ParserError

torch.set_num_threads(1)

TYPED = (BindError, ParserError, MacroError, TE.Error, TE.ConnectionException)


@pytest.fixture(scope="module")
def jcon():
    return duckdb_tpu.connect()


def _outcome(con, sql):
    try:
        return "rows", con.sql(sql).rows()
    except Exception as err:  # noqa: BLE001 — the class is what is compared
        return "error", err


# -- F30 -----------------------------------------------------------------------------------
LIST_SETUP = "CREATE TABLE lists AS SELECT * FROM (VALUES ([1, 2]), (NULL), ([3])) t(x)"


@pytest.mark.parametrize("sql,want,jax", [
    ("SELECT repeat([1, 2], 2)", [([1, 2, 1, 2],)], ValueError),
    ("SELECT repeat(['a', 'b'], 3)", [(["a", "b"] * 3,)], ValueError),
    ("SELECT repeat([1, 2], 0), repeat([1, 2], -1)", [([], [])], ValueError),
    ("SELECT repeat(x, 2) FROM lists", [([1, 2, 1, 2],), (None,), ([3, 3],)], None),
    ("SELECT repeat(NULL::INT[], 2), repeat([1], NULL)", [(None, None)], None),
])
def test_f30_repeat_has_the_list_overload(jcon, sql, want, jax):
    con = duckdb_tpu_torch.connect(device="cpu")
    con.sql(LIST_SETUP)
    assert con.sql(sql).rows() == want
    if jax is not None:
        kind, got = _outcome(jcon, sql)
        assert kind == "error" and type(got) is jax


@pytest.mark.parametrize("fn", ["reverse", "strlen", "lower", "upper", "initcap", "ltrim"])
@pytest.mark.parametrize("arg", ["[1, 2]", "x"])
def test_f30_string_functions_refuse_a_list(jcon, fn, arg):
    con = duckdb_tpu_torch.connect(device="cpu")
    con.sql(LIST_SETUP)
    sql = f"SELECT {fn}({arg}) FROM lists"
    with pytest.raises(BindError, match=f"No function matches.*'{fn}\\(INTEGER\\[\\]\\)'"):
        con.sql(sql)
    jcon.sql("CREATE OR REPLACE TABLE lists AS SELECT * FROM (VALUES ([1, 2]), (NULL), ([3])) "
             "t(x)")
    kind, got = _outcome(jcon, sql)
    assert kind == "rows" or not isinstance(got, BindError)


def test_f30_length_of_a_list_stays_its_length():
    con = duckdb_tpu_torch.connect(device="cpu")
    assert con.sql("SELECT length([1, 2]), len([1, 2, 3]), strlen('abc')").rows() == [(2, 3, 3)]


# -- F28 -----------------------------------------------------------------------------------
@pytest.mark.parametrize("sql", [
    "SELECT array_append(1, 1)", "SELECT list_contains(1, 1)", "SELECT array_length(1)",
    "SELECT map_keys(1)", "SELECT grade_up(1)", "SELECT list_slice(1, 1, 1)",
    "SELECT map(1, 1)", "SELECT list_where(1, 1)", "SELECT list_has_all(1, 1)",
    "SELECT split(1, 1)", "SELECT string_split(1, 1)", "SELECT date_part(1)",
    "SELECT element_at(1, 1)", "SELECT cardinality(1)", "SELECT array_cross_product(1, 1)",
])
def test_f28_wrong_kind_is_a_binder_error(jcon, sql):
    with pytest.raises(BindError, match="No function matches"):
        duckdb_tpu_torch.connect(device="cpu").sql(sql).rows()
    kind, got = _outcome(jcon, sql)
    if "date_part" in sql:  # the one the JAX package refuses as DuckDB does
        assert kind == "error" and type(got).__name__ == "BindError"
    else:  # a bare Python error, or an answer
        assert kind == "rows" or type(got).__name__ in ("TypeError", "ValueError", "IndexError")


def test_f28_make_date_of_text_is_a_conversion_error(jcon):
    """make_date('a', 'a', 'a') raised OverflowError in Result.rows (F29's
    code read as a year) in both packages."""
    sql = "SELECT make_date('a', 'a', 'a')"
    with pytest.raises(TE.ConversionException, match="Could not convert string 'a'"):
        duckdb_tpu_torch.connect(device="cpu").sql(sql).rows()
    kind, got = _outcome(jcon, sql)
    assert kind == "error" and type(got) is OverflowError


def _arities(name):
    if name in F.ARITY:
        return [k for k in range(8) if k in F.ARITY[name]][:4]
    return range(4)


@pytest.mark.parametrize("name", sorted(F.REGISTRY))
def test_f28_every_function_answers_or_raises_typed(name):
    """Every registered scalar function, at every argument count ARITY
    allows (0-3 where it declares none), with INTEGER literals and then
    VARCHAR literals: rows, or one of the port's typed exceptions."""
    con = duckdb_tpu_torch.connect(device="cpu")
    for k in _arities(name):
        for lit in ("1", "'a'", "'1'"):
            sql = f"SELECT {name}({', '.join([lit] * k)})"
            kind, got = _outcome(con, sql)
            if kind == "error":
                assert isinstance(got, TYPED) and type(got) is not ValueError, (
                    sql, type(got).__name__, got)


# -- F29 -----------------------------------------------------------------------------------
OWN = {"int": "2::BIGINT", "double": "2.5::DOUBLE", "date": "DATE '2020-03-04'",
       "time": "TIME '01:02:03'", "timestamp": "TIMESTAMP '2020-03-04 05:06:07'"}
TEXT = {"int": "'2'", "double": "'2.5'", "date": "'2020-03-04'", "time": "'01:02:03'",
        "timestamp": "'2020-03-04 05:06:07'"}
OTHER = {"list": "[1, 2, 3]", "map": "MAP {1: 2}", "nested": "[1, 2, 3]", "str": "'abcd'",
         "interval": "INTERVAL 1 DAY", "any": "'abcd'"}
TYPED_NAMES = sorted(n for n, kinds in F.PARAMS.items() if set(kinds) & set(F.PARAM_TYPES))


def _call(name, text: bool, column: bool = False):
    kinds = F.PARAMS[name]
    counts = [k for k in range(len(kinds) + 1) if name not in F.ARITY or k in F.ARITY[name]]
    args, used = [], False
    for kind in kinds[:max(counts)]:
        if kind in F.PARAM_TYPES:
            if column and not used:
                args.append("s")
                used = True
            else:
                args.append((TEXT if text else OWN)[kind])
        else:
            args.append(OTHER[kind])
    tail = " FROM (VALUES ('2')) t(s)" if column else ""
    return f"SELECT {name}({', '.join(args)}){tail}"


def test_f29_the_record_covers_the_functions_that_read_numbers_and_dates():
    assert {"make_date", "make_time", "make_timestamp", "to_days", "to_hours", "factorial",
            "gcd", "day", "year", "format_bytes", "dayname", "julian", "to_timestamp", "abs",
            "sqrt", "round", "left", "substring", "list_slice"} <= set(TYPED_NAMES)
    assert not hasattr(F, "NUMERIC_ARG_FNS")  # F17's set is folded into PARAMS


@pytest.mark.parametrize("name", TYPED_NAMES)
def test_f29_string_literal_reads_as_the_parameter_type(name):
    """f(the parameter's own literal) and f(the same value as a string
    literal) give the same answer (or the same error); over a VARCHAR
    column there is no overload."""
    con = duckdb_tpu_torch.connect(device="cpu")
    own, text = _outcome(con, _call(name, False)), _outcome(con, _call(name, True))
    if own[0] == "rows":
        assert repr(text) == repr(own), (_call(name, True), text, own)
    else:
        assert text[0] == own[0] and type(text[1]) is type(own[1]), (text, own)
    with pytest.raises(BindError, match="No function matches"):
        con.sql(_call(name, False, column=True))


@pytest.mark.parametrize("sql,want,jax_rows", [
    ("SELECT make_time('1', '2', '3')", [(datetime.time(1, 2, 3),)],
     [(datetime.time(0, 0),)]),
    ("SELECT factorial('2'), gcd('2', '2')", [(2, 2)], [(1, 0)]),
    ("SELECT make_date('2020', '1', '2')", [(datetime.date(2020, 1, 2),)], None),
    ("SELECT day('2020-03-04'), year('2020-03-04')", [(4, 2020)], None),
    ("SELECT to_days('2')", [(datetime.timedelta(days=2),)], [(datetime.timedelta(0),)]),
])
def test_f29_held_to_duckdb(jcon, sql, want, jax_rows):
    assert duckdb_tpu_torch.connect(device="cpu").sql(sql).rows() == want
    kind, got = _outcome(jcon, sql)
    assert (kind, got) != ("rows", want)
    if jax_rows is not None:
        assert got == jax_rows


@pytest.mark.parametrize("sql", ["SELECT day('2')", "SELECT make_time('x', 1, 1)",
                                 "SELECT factorial('two')", "SELECT to_hours('1h')"])
def test_f29_text_that_does_not_read_is_a_conversion_error(sql):
    with pytest.raises(TE.ConversionException, match="Could not convert string"):
        duckdb_tpu_torch.connect(device="cpu").sql(sql).rows()
