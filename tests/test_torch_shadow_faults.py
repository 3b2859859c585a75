"""The faults a replay of the JAX package's own tests through the port
found (tools/shadow_jax_tests.py), each held to the JAX package where it
answers and to DuckDB where it does not; and the replay's comparison
itself.

- G1: an empty list literal (SQLNULL[]) is a value of every list type of
  its depth: INSERT VALUES with [] beside typed lists, INSERT into a list
  column, UPDATE … SET l = [] and [] as a CASE or COALESCE branch. The
  JAX package raises on the last two, DuckDB casts, so the port is held to
  DuckDB there.
- G2: `||` with a LIST on its left is list_concat (the JAX binder's
  branch, lost in the port's copy), NULL in, NULL out.
- G3: SET and RESET return None, as in the JAX package and DuckDB (the
  port returned an empty Result).
- H3: a STRUCT literal with a NULL field ({'a': NULL, 'b': 'y'}, of type
  STRUCT(a SQLNULL, b VARCHAR)) is a value of every STRUCT type of its
  field names: INSERT beside typed rows, INSERT alone, a list of such
  structs, and (as DuckDB, where the JAX package raises) UNION ALL.
- H4: a nested value whose leaves widen into a nested column's (a STRUCT
  literal's DECIMAL(2,1) field into DECIMAL(4,1), an INTEGER[] into
  DOUBLE[]) inserts, each leaf converted as DuckDB's list_cast.cpp and
  struct_cast.cpp do (the JAX package keeps the list's integers as they
  were); CAST between such types answers too (the JAX package refuses).
- S4 (a fault of the JAX package the port does not copy): current_database()
  of a file database is 'memory' there; the port gives the database's
  name, as DuckDB does.
"""

import datetime
import decimal
import json

import pytest
import torch

import duckdb_tpu
import duckdb_tpu_torch

torch.set_num_threads(1)


def _lists(rows):
    """The JAX package gives a LIST's elements as a tuple (fault (c))."""
    def fix(v):
        return [fix(x) for x in v] if isinstance(v, (tuple, list)) else v
    return [tuple(fix(v) for v in r) for r in rows]


@pytest.fixture()
def both():
    cons = duckdb_tpu.connect(), duckdb_tpu_torch.connect(device="cpu")
    for c in cons:
        c.sql("CREATE TABLE lt (id INTEGER, s VARCHAR[], l INTEGER[])")
        c.sql("CREATE TABLE w (g INTEGER, l INTEGER[], n INTEGER[][])")
    return cons


def test_g1_empty_list_inserts_as_the_jax_package_does(both):
    jcon, tcon = both
    for sql in ("INSERT INTO lt VALUES (1, ['a','b'], [10,20,30]), (2, ['c'], []), "
                "(3, NULL, [5])",
                "INSERT INTO w (g, l) VALUES (4, [])",
                "INSERT INTO w VALUES (5, [1], [[]]), (6, [], [[2], []])"):
        assert tcon.sql(sql).rows() == jcon.sql(sql).rows()
    for sql in ("SELECT * FROM lt ORDER BY id", "SELECT * FROM w ORDER BY g"):
        assert tcon.sql(sql).rows() == _lists(jcon.sql(sql).rows())
    assert tcon.sql("SELECT * FROM lt ORDER BY id").rows() == [
        (1, ["a", "b"], [10, 20, 30]), (2, ["c"], []), (3, None, [5])]


def test_g1_update_and_case_follow_duckdb(both):
    """UPDATE … SET l = [] and [] as a CASE or COALESCE branch: DuckDB casts
    the empty list; the JAX package raises."""
    jcon, tcon = both
    for c in both:
        c.sql("INSERT INTO w (g, l) VALUES (1, [1, 2]), (2, NULL)")
    assert tcon.sql("UPDATE w SET l = [] WHERE g = 1").rows() == [(1,)]
    assert tcon.sql("SELECT g, l FROM w ORDER BY g").rows() == [(1, []), (2, None)]
    with pytest.raises(Exception, match="SQLNULL"):
        jcon.sql("UPDATE w SET l = [] WHERE g = 1")
    sql = ("SELECT g, CASE WHEN g = 1 THEN [7] ELSE [] END, coalesce(l, []), "
           "coalesce(NULL, []) FROM w ORDER BY g")
    assert tcon.sql(sql).rows() == [(1, [7], [], []), (2, [], [], [])]
    with pytest.raises(Exception, match="SQLNULL"):
        jcon.sql(sql).rows()


def test_g2_list_concat_operator(both):
    jcon, tcon = both
    for c in both:
        c.sql("INSERT INTO w (g, l) VALUES (1, [1, 2]), (2, NULL), (3, [])")
    for sql in ("SELECT [1, 2] || [3]", "SELECT [] || [1]", "SELECT ['a'] || []",
                "SELECT g, l || [7], [7] || l FROM w ORDER BY g",
                "SELECT 'a' || 'b', NULL || [1]"):
        assert tcon.sql(sql).rows() == _lists(jcon.sql(sql).rows()), sql
    assert tcon.sql("SELECT g, l || [7] FROM w ORDER BY g").rows() == [
        (1, [1, 2, 7]), (2, None), (3, [7])]
    # a NULL on the right: DuckDB gives NULL; the JAX package raises
    assert tcon.sql("SELECT [1] || NULL").rows() == [(None,)]
    with pytest.raises(Exception, match="list_concat expects LIST"):
        jcon.sql("SELECT [1] || NULL")
    with pytest.raises(Exception, match="list_concat expects LIST"):
        tcon.sql("SELECT [1, 2] || 3")


def test_g3_set_returns_none(both):
    for c in both:
        assert c.sql("SET threads = 4") is None
        assert c.sql("RESET threads") is None


def test_shadow_replay_logs_what_differs(tmp_path, monkeypatch):
    """tools/shadow_jax_tests.py's comparison: agreeing answers (a SET's None
    on both sides too) log nothing; rows that differ and a refusal on one
    side log a line each, under the test's name."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "tools" / "shadow_jax_tests.py"
    spec = importlib.util.spec_from_file_location("shadow_jax_tests_under_test", path)
    sh = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sh)
    out = tmp_path / "diff.jsonl"
    monkeypatch.setitem(sh._state, "out", str(out))
    monkeypatch.setitem(sh._state, "test", "t::case")
    jcon = duckdb_tpu.connect()
    twin = sh._twin(jcon)
    assert sh._twin(jcon) is twin and sh._twin(jcon.cursor()) is not twin
    cases = [("SELECT [1, 2] || [3]", None), ("SELECT 7 % 3", None), ("SET threads = 2", None),
             ("SELECT -7 % 3", "rows"), ("SELECT [1] || NULL", "jax raises")]
    for sql, kind in cases:
        try:
            jres, jerr = jcon.sql(sql), None
        except Exception as err:  # noqa: BLE001 — the replay compares refusals too
            jres, jerr = None, err
        sh._compare(sql, jres, jerr, twin)
    logged = [json.loads(line) for line in out.read_text().splitlines()]
    assert [(d["sql"], d["kind"]) for d in logged] == [
        (sql, kind) for sql, kind in cases if kind is not None]
    assert all(d["test"] == "t::case" for d in logged)
    assert logged[0]["jax"] == "[(2,)]" and logged[0]["port"] == "[(-1,)]"  # #5: DuckDB's -1


def test_h3_struct_with_null_fields_inserts_as_the_jax_package_does():
    jcon, tcon = duckdb_tpu.connect(), duckdb_tpu_torch.connect(device="cpu")
    for c in (jcon, tcon):
        c.sql("CREATE TABLE v (i INTEGER, st STRUCT(a INTEGER, b VARCHAR), "
              "l STRUCT(a INTEGER)[])")
    for sql in ("INSERT INTO v VALUES (1, {'a': 1, 'b': 'x'}, [{'a': 1}, {'a': NULL}]), "
                "(3, {'a': NULL, 'b': 'y'}, NULL)",
                "INSERT INTO v VALUES (4, {'a': NULL, 'b': NULL}, [{'a': NULL}])",
                "INSERT INTO v (i, st) VALUES (5, {'a': NULL, 'b': 'z'})"):
        assert tcon.sql(sql).rows() == jcon.sql(sql).rows()
    sql = "SELECT * FROM v ORDER BY i"
    got = tcon.sql(sql).rows()
    assert got == [
        (1, {"a": 1, "b": "x"}, [{"a": 1}, {"a": None}]), (3, {"a": None, "b": "y"}, None),
        (4, {"a": None, "b": None}, [{"a": None}]), (5, {"a": None, "b": "z"}, None)]
    # the JAX package gives a struct inside a list as a tuple (fault (c))
    assert [r[:2] for r in got] == [r[:2] for r in jcon.sql(sql).rows()]
    sql = "SELECT {'a': 1, 'b': 'x'} AS s UNION ALL SELECT {'a': NULL, 'b': 'y'} ORDER BY 1"
    assert tcon.sql(sql).rows() == [({"a": 1, "b": "x"},), ({"a": None, "b": "y"},)]
    with pytest.raises(Exception, match="Cannot compare"):
        jcon.sql(sql)
    with pytest.raises(Exception):  # another field name is another shape
        tcon.sql("INSERT INTO v (i, st) VALUES (6, {'c': NULL, 'b': 'z'})")


def test_h4_nested_values_widen_into_nested_columns():
    jcon, tcon = duckdb_tpu.connect(), duckdb_tpu_torch.connect(device="cpu")
    for c in (jcon, tcon):
        c.sql("CREATE TABLE sp (s STRUCT(x INTEGER, y DECIMAL(4,1)), l DOUBLE[], "
              "n BIGINT[][])")
    sql = "INSERT INTO sp VALUES ({'x': 1, 'y': 2.5}, [1, 2], [[1], [2, 3]])"
    assert tcon.sql(sql).rows() == jcon.sql(sql).rows() == [(1,)]
    sql = "SELECT s, s['y'], l, n FROM sp"
    got, want = tcon.sql(sql).rows(), jcon.sql(sql).rows()
    assert got[0][:2] == want[0][:2] == ({"x": 1, "y": decimal.Decimal("2.5")},
                                         decimal.Decimal("2.5"))
    assert got[0][2:] == ([1.0, 2.0], [[1], [2, 3]])
    assert all(type(v) is float for v in got[0][2])
    assert [type(v) for v in want[0][2]] == [int, int]  # the JAX package keeps the ints
    casts = ("SELECT CAST([1, 2] AS DOUBLE[]), CAST({'a': 1, 'b': 2.5} AS "
             "STRUCT(a DOUBLE, b DECIMAL(6,2))), CAST([DATE '2020-01-01'] AS TIMESTAMP[])")
    assert tcon.sql(casts).rows() == [([1.0, 2.0], {"a": 1.0, "b": decimal.Decimal("2.50")},
                                       [datetime.datetime(2020, 1, 1)])]
    with pytest.raises(Exception, match="unsupported coercion"):
        jcon.sql(casts)
    with pytest.raises(Exception, match="not yet ported"):  # narrowing: refused in both
        tcon.sql("SELECT CAST([1.5, 2] AS INTEGER[])")


def test_s4_current_database_of_a_file_database_is_its_name(tmp_path):
    jcon = duckdb_tpu.connect(str(tmp_path / "jdb" / "shop"))
    tcon = duckdb_tpu_torch.connect(str(tmp_path / "tdb" / "shop"), device="cpu")
    try:
        assert tcon.sql("SELECT current_database()").rows() == [("shop",)]
        assert jcon.sql("SELECT current_database()").rows() == [("memory",)]
    finally:
        tcon.close()
        jcon.close()
