"""The grammar fuzzer through duckdb_tpu_torch (device="cpu").

The port's duckdb_tpu_torch/testing/fuzz.py against the contract of
tests/test_fuzz.py: the engine may refuse a generated query with a typed
error but never raises a bare Python error. Seeds 1, 7 and 11 × 400, the
JAX package's pinned regressions through the port, the generator's text
equal to the JAX package's, and the faults a fuzz run through both
packages found (ROADMAP Queue 3, F14-F17), each held to DuckDB's answer
with the JAX package's differing answer asserted beside it.
"""

import datetime
import decimal

import pytest
import torch

import duckdb_tpu
import duckdb_tpu_torch
from duckdb_tpu.testing import fuzz as JF
from duckdb_tpu_torch import errors as TE
from duckdb_tpu_torch.planner.bound import BindError
from duckdb_tpu_torch.testing import fuzz as TF
from tests.test_fuzz import REGRESSIONS_OK, REGRESSIONS_REJECT

torch.set_num_threads(1)

N = 400


@pytest.fixture(scope="module")
def con():
    return TF.setup_connection(duckdb_tpu_torch.connect(device="cpu"))


@pytest.fixture(scope="module")
def jcon():
    return duckdb_tpu.connect()


@pytest.mark.parametrize("seed", [1, 7, 11])
def test_fuzz_no_crashes(con, seed):
    ok, rej, failures = TF.run_fuzz(N, seed=seed, con=con)
    assert not failures, "\n".join(
        f"{type(e).__name__}: {e}\n  {sql}" for sql, e in failures[:5])
    assert ok >= N * 0.2, f"only {ok}/{N} queries executed"
    assert ok + rej == N


@pytest.mark.parametrize("seed", [1, 7, 11])
def test_generator_matches_the_jax_package(seed):
    ours, theirs = TF.SqlFuzzer(seed), JF.SqlFuzzer(seed)
    for i in range(50):
        assert ours.query() == theirs.query(), (seed, i)
    assert TF.SETUP == JF.SETUP and TF.ACCEPTABLE == JF.ACCEPTABLE


def test_run_fuzz_defaults_to_the_card():
    """Without a connection run_fuzz connects on the default device, the
    card: on a host without one that raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(Exception):
        TF.run_fuzz(1, seed=1)


@pytest.mark.parametrize("q", REGRESSIONS_REJECT)
def test_fuzz_regression_rejects_typed(q):
    with pytest.raises(Exception) as err:
        duckdb_tpu_torch.connect(device="cpu").sql(q)
    assert TF.is_typed(err.value), (q, err.value)


@pytest.mark.parametrize("q,exp", REGRESSIONS_OK)
def test_fuzz_regression_ok(q, exp):
    got = duckdb_tpu_torch.connect(device="cpu").sql(q).rows()
    if exp is not None:
        assert got == exp


def _jax(jcon, sql):
    return TF.run_one(jcon, sql)


# F14: one argument too many. DuckDB has no overload: its Binder Error. The
# JAX package answers, ignoring the extra argument (md5(1, 2) it refuses).
@pytest.mark.parametrize("sql,jax_answers", [
    ("SELECT md5('a', 33)", True),
    ("SELECT reverse('ab', 1)", True),
    ("SELECT md5(1, 2)", False),
    ("SELECT sqrt(78, 92)", True),
    ("SELECT cot(1.0, 2.0)", True),
    ("SELECT length('', 1)", True),
])
def test_f14_extra_argument_is_a_binder_error(jcon, sql, jax_answers):
    with pytest.raises(BindError, match="No function matches"):
        duckdb_tpu_torch.connect(device="cpu").sql(sql)
    kind, _ = _jax(jcon, sql)
    assert (kind == "rows") == jax_answers


# F15: one argument too few: a BindError as the JAX package's, never an
# IndexError from the implementation.
@pytest.mark.parametrize("sql", ["SELECT atan2(1.0)", "SELECT atan2(1.0) + 1", "SELECT pow(2)",
                                 "SELECT nextafter(1.0)", "SELECT length()", "SELECT sqrt()"])
def test_f15_missing_argument_is_a_binder_error(jcon, sql):
    with pytest.raises(BindError):
        duckdb_tpu_torch.connect(device="cpu").sql(sql)
    kind, err = _jax(jcon, sql)
    assert kind == "error" and isinstance(err, ValueError)


# A function's argument counts are declared once, in functions.ARITY or
# where it registers; the binder checks them before the function binds.
@pytest.mark.parametrize("sql", ["SELECT make_date(1, 1)", "SELECT make_timestamp(1, 2)",
                                 "SELECT to_base(5)", "SELECT parse_filename('a/b', 'c')",
                                 "SELECT string_split_regex('a')", "SELECT bin(1, 2)"])
def test_declared_arity_is_a_binder_error(sql):
    with pytest.raises(BindError, match="No function matches"):
        duckdb_tpu_torch.connect(device="cpu").sql(sql)


@pytest.mark.parametrize("sql,want", [
    ("SELECT make_date(2020, 1, 2)", [(datetime.date(2020, 1, 2),)]),
    ("SELECT make_timestamp(0)", [(datetime.datetime(1970, 1, 1),)]),
    ("SELECT to_base(5, 2)", [("101",)]),
    ("SELECT regexp_split_to_array('a1b', '[0-9]')", [(["a", "b"],)]),
])
def test_declared_arity_admits_its_counts(sql, want):
    assert duckdb_tpu_torch.connect(device="cpu").sql(sql).fetchall() == want


def test_arity_is_declared_once():
    from duckdb_tpu_torch.planner import functions as F

    assert F.ARITY["make_date"] == frozenset({1, 3})
    binder = F.REGISTRY["make_date"]
    with pytest.raises(ValueError, match="declared twice"):
        F.register("make_date", 2)(lambda args: None)
    assert F.REGISTRY["make_date"] is binder and 2 not in F.ARITY["make_date"]


# F16: a LIST compared with a non-LIST needs a cast in DuckDB: a typed
# BindError. The JAX package answers (NULL or false): a recorded difference.
@pytest.mark.parametrize("sql,jax_rows", [
    ("SELECT CASE list_value(1.157) WHEN 3 THEN 1 END", [(None,)]),
    ("SELECT list_value(1) = 3", [(False,)]),
    ("SELECT 3 IN (list_value(1))", None),
])
def test_f16_list_against_scalar_is_a_binder_error(jcon, sql, jax_rows):
    with pytest.raises(BindError, match="Cannot compare values of type"):
        duckdb_tpu_torch.connect(device="cpu").sql(sql).rows()
    kind, got = _jax(jcon, sql)
    if jax_rows is not None:
        assert kind == "rows" and got == jax_rows


# F17: a numeric function over a VARCHAR literal reads it as DOUBLE, as
# DuckDB does: text that does not read as a number is a
# ConversionException. Over a VARCHAR column DuckDB has no overload (F29:
# it casts no VARCHAR column implicitly), a Binder Error. The JAX package
# loses the value (a TypeError in Result.rows) or computes over the
# dictionary codes.
_F17_ERRORS = [("SELECT abs('x')", TE.ConversionException, "Could not convert string"),
               ("SELECT sqrt('x')", TE.ConversionException, "Could not convert string"),
               ("SELECT sign('zz')", TE.ConversionException, "Could not convert string"),
               ("SELECT even(s) FROM (VALUES ('x')) t(s)", BindError, "No function matches"),
               ("SELECT atan2('x', 1)", TE.ConversionException, "Could not convert string")]


@pytest.mark.parametrize("sql,err,match", _F17_ERRORS, ids=[c[0] for c in _F17_ERRORS])
def test_f17_numeric_function_over_text_is_a_conversion_error(jcon, sql, err, match):
    with pytest.raises(err, match=match):
        duckdb_tpu_torch.connect(device="cpu").sql(sql).rows()
    kind, got = _jax(jcon, sql)
    assert kind == "rows" or type(got) is TypeError


_F17_VALUES = [
    ("SELECT abs('4')", [(4.0,)], None),
    ("SELECT sqrt('4')", [(2.0,)], [(0.0,)]),
    ("SELECT round('2.5')", [(3.0,)], [(0.0,)]),
    # a VARCHAR column (F29): no overload, where the JAX package answers
    ("SELECT ln(s) FROM (VALUES ('1')) t(s)", BindError, None),
]


@pytest.mark.parametrize("sql,want,jax_rows", _F17_VALUES,
                         ids=[f"{c[0]}-want{i}-{'None' if c[2] is None else f'jax_rows{i}'}"
                              for i, c in enumerate(_F17_VALUES)])
def test_f17_numeric_text_reads_as_double(jcon, sql, want, jax_rows):
    if want is BindError:
        with pytest.raises(BindError, match="No function matches"):
            duckdb_tpu_torch.connect(device="cpu").sql(sql).rows()
        assert _jax(jcon, sql)[0] == "rows"
        return
    assert duckdb_tpu_torch.connect(device="cpu").sql(sql).rows() == want
    kind, got = _jax(jcon, sql)
    assert (kind, got) != ("rows", want)
    if jax_rows is not None:
        assert got == jax_rows


def test_coalesce_over_varchar_keeps_its_dictionary(jcon):
    """coalesce over text merges the arguments' dictionaries (both packages
    lost them: a TypeError in Result.rows)."""
    sql = "SELECT coalesce(s, 'y'), coalesce(NULL, s, 'z') FROM (VALUES ('x'), (NULL)) t(s)"
    assert duckdb_tpu_torch.connect(device="cpu").sql(sql).rows() == [("x", "x"), ("y", "z")]
    kind, got = _jax(jcon, sql)
    assert kind == "error" and type(got) is TypeError


def test_least_greatest_over_lists_refuse_typed(jcon):
    with pytest.raises(BindError, match="not yet ported"):
        duckdb_tpu_torch.connect(device="cpu").sql("SELECT greatest([1], [2])").rows()
    kind, got = _jax(jcon, "SELECT greatest([1], [2])")
    assert kind == "error" and type(got) is TypeError


@pytest.mark.parametrize("sql,other,differs", [
    ("SELECT range AS a, range * 0.5 AS f, 'k' || (range % 7) AS s FROM range(20000)",
     "SELECT range AS a, range * 0.5 AS f, 'k' || (range % 7) AS s FROM range(20000) "
     "ORDER BY a DESC", False),
    ("SELECT range AS a, 'k' || (range % 7) AS s FROM range(20000)",
     "SELECT range AS a, 'k' || ((range + 1) % 7) AS s FROM range(20000)", True),
    ("SELECT range % 3 AS a, range AS b FROM range(20000) ORDER BY 1",
     "SELECT range % 3 AS a, range AS b FROM range(20000) ORDER BY a, b DESC", False),
    ("SELECT range % 3 AS a, range AS b FROM range(20000) ORDER BY 1",
     "SELECT range % 3 AS a, range AS b FROM range(20000) ORDER BY a DESC", True),
    ("SELECT range % 3 AS a, range AS b FROM range(20000) ORDER BY 1",
     "SELECT range % 3 AS a, range + 1 AS b FROM range(20000) ORDER BY 1", True),
    ("SELECT CAST(range AS DOUBLE) / 3 AS f FROM range(20000)",
     "SELECT CAST(range AS DOUBLE) / 3 * (1 + 1e-12) AS f FROM range(20000)", False),
    ("SELECT CAST(range AS DOUBLE) / 3 AS f FROM range(20000)",
     "SELECT CAST(range AS DOUBLE) / 3 * (1 + 1e-6) + 1e-3 AS f FROM range(20000)", True),
])
def test_results_differ_large_results(sql, other, differs):
    """Results past FAST_ROWS compare column-wise first, with the same
    verdict as comparing their rows (ORDER BY 1's ties as multisets)."""
    con = duckdb_tpu_torch.connect(device="cpu")
    a, b = con.sql(sql), con.sql(other)
    assert a.nrows > TF.FAST_ROWS
    # the second query's text decides ordering, as the fuzzer's tail does
    assert bool(TF.results_differ(sql, a, b)) == differs
    assert bool(TF.rows_differ(sql, a.rows(), b.rows())) == differs


# Found by seeds 0-9 × 1,000 through both packages (ROADMAP Queue 3,
# F19-F27): (sql, the port's rows or its error class, the JAX package's
# differing outcome: rows, or the name of its error class).
SWEEP_REGRESSIONS = [
    # F19: DuckDB's format_bytes takes a BIGINT; the JAX package wraps
    ("SELECT format_bytes(9223372036854775808)", BindError, [("-8.0 EiB",)]),
    # F20: a typed NULL of VARCHAR carries a dictionary
    ("SELECT CASE 'a' WHEN 'x' - NULL THEN 1 ELSE 2 END", [(2,)], "TypeError"),
    ("SELECT count(*) FROM (VALUES (DATE '2020-01-01')) t(d) "
     "WHERE TRY_CAST(NULL AS VARCHAR) <= d", [(0,)], "AttributeError"),
    # F21: coalesce / ifnull merge the dictionaries
    ("SELECT ifnull(s, 'y') FROM (VALUES ('x'), (NULL)) t(s)", [("x",), ("y",)], "TypeError"),
    # F22: round's precision is its value
    ("SELECT round(2.56, 1.254)", [(decimal.Decimal("2.6"),)],
     [(decimal.Decimal("2.56"),)]),
    # F23-F27
    ("SELECT to_base(68, NULL)", [(None,)], "TypeError"),
    ("SELECT bit_xor('x')", BindError, "TypeError"),
    ("SELECT 0.860 - 9223372036854775806", TE.OutOfRangeException, None),
    ("SELECT count(*) FROM (VALUES (DATE '2020-01-01')) t(d) "
     "WHERE (9223372036854775808 + DATE '2020-06-15') = d", TE.OutOfRangeException, None),
    ("SELECT 'v1' IN ('k3', (SELECT min(a) FROM (VALUES (1)) t(a)))", BindError, "TypeError"),
    ("SELECT TRY_CAST(format_bytes(NULL) AS DECIMAL(12,3))", [(None,)], "ConversionException"),
    # arithmetic over a NULL-typed operand: NULL, as the JAX package (it was refused)
    ("SELECT count(*) FROM range(3) WHERE "
     "(CASE WHEN range > 1 THEN '' ELSE NULL END * NULL) IS NULL", [(3,)], None),
    ("SELECT sum(NULL // (CASE 70 WHEN 3 THEN NULL END)) FROM range(3)", [(None,)], None),
    # F13 in the fuzzer's forms: the 2^63 literal keeps its high half
    ("SELECT greatest(NULL, 9223372036854775808)", [(9223372036854775808,)],
     [(-9223372036854775808,)]),
    ("SELECT max(9223372036854775808) FROM range(3)", [(9223372036854775808,)],
     [(-9223372036854775808,)]),
    ("SELECT sum(9223372036854775808) FROM range(40)", [(40 * 9223372036854775808,)],
     [(-40 * 9223372036854775808,)]),
    ("SELECT 9223372036854775806 || 9223372036854775808",
     [("92233720368547758069223372036854775808",)],
     [("9223372036854775806-9223372036854775808",)]),
]


def test_a_device_fault_in_a_constant_is_not_a_range_error(monkeypatch):
    """F25's OutOfRangeException comes from the folded value's range alone:
    a RuntimeError in making the constant's tensor (a fault of the card)
    propagates as itself, not as a typed refusal."""
    from duckdb_tpu_torch.planner import bound as B

    def broken(env, value, dtype):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(B, "_const", broken)
    with pytest.raises(RuntimeError, match="illegal memory access") as err:
        duckdb_tpu_torch.connect(device="cpu").sql("SELECT 41 + x FROM range(2) t(x)").fetchall()
    assert not isinstance(err.value, TE.OutOfRangeException)
    assert not TF.is_typed(err.value)


@pytest.mark.parametrize("sql,want,jax", SWEEP_REGRESSIONS)
def test_sweep_regressions(jcon, sql, want, jax):
    con = duckdb_tpu_torch.connect(device="cpu")
    if isinstance(want, type):
        with pytest.raises(want):
            con.sql(sql).rows()
    else:
        assert con.sql(sql).rows() == want
    kind, got = _jax(jcon, sql)
    if isinstance(jax, str):
        assert kind == "error" and type(got).__name__ == jax, (kind, got)
    elif jax is not None:
        assert kind == "rows" and got == jax
