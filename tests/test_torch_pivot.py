"""PIVOT and UNPIVOT of duckdb_tpu_torch (device="cpu") against the JAX
package.

Each script runs statement by statement through both packages
(tests/_torch_parity.py): the cases of tests/test_pivot.py, an IN list of
dates, a PIVOT without other columns, and UNPIVOT leaving out NULLs. The
column names are compared too. Where the JAX package is wrong the port is
held to DuckDB: P1, each ON value is a typed constant (a quote in a
string, a DATE) and names its column as the value cast to VARCHAR (a
BOOLEAN's 'true'), and without GROUP BY the other columns are those the
expressions reference, not those a regex finds in their text; P2,
UNPIVOT's value column takes the ON columns' common type.
"""

import datetime
import os
import sys

import pytest
import torch

from duckdb_tpu_torch.ops import grouped as grouped_mod

sys.path.insert(0, os.path.dirname(__file__))
from _torch_parity import connect_both, run_both  # noqa: E402

torch.set_num_threads(1)

SALES = ["CREATE TABLE sales (year INT, region VARCHAR, amt INT)",
         "INSERT INTO sales VALUES (2023,'east',10),(2023,'west',20),(2024,'east',5)"]

SCRIPTS = {
    # tests/test_pivot.py
    "pivot_basic": SALES + ["PIVOT sales ON region USING sum(amt)"],
    "pivot_in_list_and_group": SALES + [
        "PIVOT sales ON region IN ('east') USING sum(amt) GROUP BY year"],
    "unpivot": SALES + ["UNPIVOT sales ON year, amt INTO NAME k VALUE v"],
    "aggregate_filter_clause": SALES + [
        "SELECT year, sum(amt) FILTER (region = 'east'), count(*) FILTER (WHERE region = "
        "'west') FROM sales GROUP BY year ORDER BY year"],
    # more shapes
    "pivot_numbers": SALES + ["INSERT INTO sales VALUES (2024, NULL, 7), (2025, 'west', NULL)",
                              "PIVOT sales ON year USING count(amt)",
                              "PIVOT sales ON year USING max(amt) GROUP BY region",
                              "PIVOT sales ON amt % 2 USING sum(amt) GROUP BY year"],
    "pivot_dates_in": [
        "CREATE TABLE o (d DATE, c VARCHAR, n INT)",
        "INSERT INTO o VALUES (DATE '2020-01-01','a',1),(DATE '2020-01-02','a',2),"
        "(DATE '2020-01-01','b',3)",
        "PIVOT o ON d IN (DATE '2020-01-01', DATE '2020-01-02') USING sum(n) GROUP BY c"],
    "pivot_no_other_columns": ["CREATE TABLE s2 (k VARCHAR, x INT)",
                               "INSERT INTO s2 VALUES ('a', 1), ('b', 2), ('a', 3)",
                               "PIVOT s2 ON k USING sum(x)"],
    # a computed VARCHAR group key keeps its dictionary (PIVOT's value query)
    "computed_varchar_key": SALES + [
        "INSERT INTO sales VALUES (2024, NULL, 7), (2025, 'west', NULL)",
        "SELECT year % 2 AS v, CAST(amt % 2 AS VARCHAR) AS s, count(*) FROM sales "
        "GROUP BY 1, 2 ORDER BY 1, 2"],
    "unpivot_nulls": ["CREATE TABLE w (id INT, a INT, b INT)",
                      "INSERT INTO w VALUES (1, 10, NULL), (2, NULL, NULL), (3, 30, 31)",
                      "UNPIVOT w ON a, b INTO NAME col VALUE val"],
}


def _names_too(script, duckdb=None):
    """run_both → the last statement's Result in each package (the JAX
    package's None where `duckdb` holds the port to another answer)."""
    jcon, tcon = run_both(script, duckdb=duckdb)
    return (None if duckdb else jcon.sql(script[-1])), tcon.sql(script[-1])


# P1 in the names: the JAX package names an IN list's DATE by its day number
NAMES = {"pivot_dates_in": ["c", "2020-01-01", "2020-01-02"]}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_pivot_matches_jax(name):
    j, t = _names_too(SCRIPTS[name])
    if name in NAMES:
        assert t.names == NAMES[name] and j.names != t.names
    else:
        assert j.names == t.names


# P1: the setups of ROADMAP's P1
P1 = {
    "quote": (["CREATE TABLE p (g INT, k VARCHAR, x INT)",
               "INSERT INTO p VALUES (1, 'it''s', 2), (1, 'plain', 3), (2, 'it''s', 4)"],
              "PIVOT p ON k USING sum(x)", ["g", "it's", "plain"], [(1, 2, 3), (2, 4, None)]),
    "date": (["CREATE TABLE pd (g INT, d DATE, x INT)",
              "INSERT INTO pd VALUES (1, DATE '2020-01-01', 1), (1, DATE '2020-01-02', 2), "
              "(2, DATE '2020-01-01', 3)"],
             "PIVOT pd ON d USING sum(x) GROUP BY g", ["g", "2020-01-01", "2020-01-02"],
             [(1, 1, 2), (2, 3, None)]),
    "regex_groups": (SALES, "PIVOT sales ON region USING sum(amt + length('year'))",
                     ["year", "east", "west"], [(2023, 14, 24), (2024, 9, None)]),
}


@pytest.mark.parametrize("kind", sorted(P1))
def test_p1_values_are_typed_constants(kind):
    setup, pivot, names, rows = P1[kind]
    _, t = _names_too(setup + [pivot], duckdb={pivot: rows})
    assert t.names == names


def test_p1_boolean_columns_named_as_duckdb_names_them():
    script = ["CREATE TABLE pb (g INT, b BOOLEAN, x INT)",
              "INSERT INTO pb VALUES (1, true, 1), (1, false, 2), (2, true, 3)",
              "PIVOT pb ON b USING sum(x) GROUP BY g"]
    j, t = _names_too(script)
    assert t.names == ["g", "false", "true"] and j.names == ["g", "False", "True"]


def test_p2_unpivot_takes_the_common_type():
    u = "UNPIVOT u2 ON a, b INTO NAME n VALUE v"
    _, t = _names_too(["CREATE TABLE u2 (a INTEGER, b DOUBLE)", "INSERT INTO u2 VALUES (1, 2.5)",
                       u], duckdb={u: [("a", 1.0), ("b", 2.5)]})
    assert repr(t.types[1]) == "DOUBLE"


def test_pivot_sums_reach_the_grouped_sum(monkeypatch):
    """PIVOT's FILTERed sums are aggregates like any others: over enough
    rows the fused path takes them through the grouped sum."""
    _, tcon = connect_both()
    tcon.sql("CREATE TABLE big AS SELECT range % 3 AS g, range % 5 AS k, range AS x "
             "FROM range(30000)")
    calls = []
    orig = grouped_mod.grouped_sum_i64

    def recording(dense, vectors, nseg):
        calls.append((len(vectors), nseg))
        return orig(dense, vectors, nseg)

    monkeypatch.setattr(grouped_mod, "grouped_sum_i64", recording)
    rows = tcon.sql("PIVOT big ON k USING sum(x) GROUP BY g").rows()
    want = [(g,) + tuple(sum(x for x in range(30000) if x % 3 == g and x % 5 == k)
                         for k in range(5)) for g in range(3)]
    assert rows == want
    assert calls, "the FILTERed sums did not reach the grouped sum"


def test_pivot_of_a_date_column_orders_its_values():
    _, tcon = connect_both()
    tcon.sql("CREATE TABLE e (d DATE, x INT)")
    tcon.sql("INSERT INTO e VALUES (DATE '2021-03-01', 1), (DATE '1999-12-31', 2), (NULL, 3)")
    res = tcon.sql("PIVOT e ON d USING sum(x)")
    assert res.names == ["1999-12-31", "2021-03-01"] and res.rows() == [(2, 1)]
    assert isinstance(tcon.sql("SELECT min(d) FROM e").rows()[0][0], datetime.date)
