"""The JSON functions (storage/json_io.py) and json_group_array in
duckdb_tpu_torch (device="cpu"), against duckdb_tpu and Python's json.

A table of hand-written documents (objects, arrays, scalars, unicode, a
JSON null, text that is not JSON and a SQL NULL) and a column of paths is
made in both packages (CREATE TABLE in the reference, a catalog table in
the port, which has no DDL yet: ROADMAP item 34); then every JSON
function runs through SQL in both: extraction with a constant path, a
list of paths and a path column, json_value/json_exists, the ->/->>
operators, to_json and the constructors over TPC-H columns at SF 0.01,
seed 7 (json_object over two columns runs once per distinct tuple of
values), merge_patch, contains, pretty, strip_nulls, structure, valid,
array_length, keys, type, and json_group_array grouped and ungrouped.
Every value compares exactly: JSON results are text.
"""

import json

import numpy as np
import pytest
import torch

import duckdb_tpu
import duckdb_tpu_torch
from duckdb_tpu_torch.catalog.catalog import ColumnDef, TableEntry
from duckdb_tpu_torch.testing.tpch_gen import write_tables
from duckdb_tpu_torch.types import INTEGER, VARCHAR

torch.set_num_threads(1)

DOCS = [
    '{"a": 1, "b": {"c": [1, 2, 3]}, "s": "x", "t": true}',
    '{"a": 2, "n": null, "arr": [1, "two", null, 4.5], "s": "y\\u00e9"}',
    '[1, 2, {"k": "v"}, [7]]',
    '"just text"',
    "-3.25",
    "not json",
    None,
    '{"a": -7, "b": {"c": [], "d": {"e": false}}, "s": ""}',
]
PATHS = ["$.a", "$.b.c[1]", "$[2].k", "$", "$.s", "/b/c/0", "a", "$.missing", "$[#-1]", None]
VALID = ['{"a": {"b": null, "c": [1, null]}}', "[1, 2.5, \"x\", null, true]", '{"k": [{"x": 1}]}',
         "7", '{"z": 1, "y": {"w": 2}}']


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("tpch_gen_json")
    write_tables(str(root), 0.01, seed=7)
    return str(root)


def _sql_text(v):
    return "NULL" if v is None else "'" + v.replace("'", "''") + "'"


def _port_table(con, name, cols, rows):
    entry = TableEntry(name, [ColumnDef(c, t) for c, t in cols])
    entry.nrows = len(rows)
    con.catalog.create_table(entry)
    for (col, t), values in zip(cols, zip(*rows)):
        valid = np.array([v is not None for v in values])
        if t.id is VARCHAR.id:
            uniq, codes = np.unique(np.array(["" if v is None else v for v in values], dtype=str),
                                    return_inverse=True)
            entry.set_host_column(col, codes.reshape(-1).astype(np.int32),
                                  None if valid.all() else valid, uniq.astype(object))
        else:
            entry.set_host_column(col, np.array(values, dtype=np.int32))


@pytest.fixture(scope="module")
def cons(data_dir):
    jcon = duckdb_tpu.connect()
    jcon.load_tpch(data_dir)
    tcon = duckdb_tpu_torch.connect(device="cpu")
    tcon.load_tpch(data_dir)
    rows = [(i, d, PATHS[i % len(PATHS)]) for i, d in enumerate(DOCS * 2)]
    jcon.sql("CREATE TABLE j (id INTEGER, d VARCHAR, p VARCHAR)")
    jcon.sql("INSERT INTO j VALUES " + ", ".join(
        f"({i}, {_sql_text(d)}, {_sql_text(p)})" for i, d, p in rows))
    _port_table(tcon, "j", [("id", INTEGER), ("d", VARCHAR), ("p", VARCHAR)], rows)
    valid = list(enumerate(VALID))
    jcon.sql("CREATE TABLE v (id INTEGER, d VARCHAR)")
    jcon.sql("INSERT INTO v VALUES " + ", ".join(f"({i}, {_sql_text(d)})" for i, d in valid))
    _port_table(tcon, "v", [("id", INTEGER), ("d", VARCHAR)], valid)
    return jcon, tcon


def _rows(con, sql):
    return sorted(con.sql(sql).rows(), key=repr)


SQL = {
    "extract": "SELECT id, json_extract(d, '$.a'), json_extract_string(d, '$.s'), "
               "json_extract_path(d, '$.b.c[1]'), json_extract_path_text(d, '/b/c/0'), "
               "json_extract(d, 'a'), json_extract(d, '$[#-1]'), json_extract(d, 1), "
               "json_extract_string(d, '$[2].k'), json_extract(d, '$.n') FROM j",
    "arrows": "SELECT id, d -> '$.b', d ->> 's', d -> 'arr' FROM j",
    "value_exists": "SELECT id, json_value(d, '$.a'), json_value(d, '$.b'), json_value(d, 1), "
                    "json_exists(d, '$.a'), json_exists(d, '$.n'), json_exists(d, '$.zz') "
                    "FROM j",
    "path_column": "SELECT id, json_extract(d, p), json_extract_string(d, p), "
                   "json_value(d, p), json_exists(d, p) FROM j",
    "path_list": "SELECT id, json_extract(d, ['$.a', '$.s']), "
                 "json_extract_string(d, ['$.s', '$.b.c[0]']) FROM j",
    "inspect": "SELECT id, json_valid(d), json_type(d), json_typeof(d, '$.a'), "
               "json_array_length(d), json_array_length(d, '$.b.c'), json_keys(d), "
               "json_keys(d, '$.b'), json_contains(d, '2'), json_contains(d, '{\"a\": 1}') FROM j",
    "rewrite": "SELECT id, json(d), json_structure(d), json_pretty(d), json_strip_nulls(d), "
               "json_merge_patch(d, '{\"a\": 10, \"b\": null}'), json_merge_patch(d, d), "
               "json_merge_patch('{\"q\": 1}', d, '{\"r\": 2}'), to_json(d), json_quote(id) "
               "FROM v",
    "constructors": "SELECT o_orderkey, json_object('k', o_orderkey % 10, 'p', o_orderpriority), "
                    "json_array(o_orderstatus, o_custkey % 3, NULL), to_json(o_totalprice), "
                    "to_json(o_orderdate), row_to_json(o_orderstatus), "
                    "array_to_json(o_shippriority), json_object('d', o_orderdate) "
                    "FROM orders WHERE o_orderkey < 800",
    "constants": "SELECT to_json([1, 2, 3]), to_json('str'), to_json(1.5), "
                 "to_json(DATE '2024-01-01'), to_json({'k': 1, 'l': [true, NULL]}), "
                 "json_object('k', 1, 'k2', 'v'), json_array(1, 'a', NULL), "
                 "json('{\"a\":   1}'), json_valid('{'), json_type('[1]'), "
                 "json_merge_patch('{\"a\": 1, \"b\": 2}', '{\"b\": null, \"c\": 3}'), "
                 "json_extract('{\"a\": {\"b\": [5, 6]}}', '$.a.b[1]')",
    "group_array": "SELECT n_regionkey, json_group_array(n_name), json_group_array(n_nationkey) "
                   "FROM nation GROUP BY 1",
    "group_array_all": "SELECT json_group_array(r_name), count(*) FROM region",
}


@pytest.mark.parametrize("name", sorted(SQL))
def test_json_matches_jax(cons, name):
    jcon, tcon = cons
    assert _rows(tcon, SQL[name]) == _rows(jcon, SQL[name])


def test_json_object_runs_per_distinct_tuple(cons, data_dir):
    """json_object over two columns of orders: one document per distinct
    (o_orderkey % 10, o_orderpriority) pair, parsed back by Python."""
    _, tcon = cons
    rows = tcon.sql("SELECT o_orderkey, o_orderpriority, json_object('a', o_orderkey % 10, "
                    "'b', o_orderpriority) FROM orders").rows()
    docs = {r[2] for r in rows}
    assert len(docs) == len({(k % 10, p) for k, p, _ in rows}) == 50
    for k, p, doc in rows:
        assert json.loads(doc) == {"a": k % 10, "b": p}


def test_nested_to_json(cons):
    """to_json of a columnar list and of a struct constant, held to Python."""
    _, tcon = cons
    rows = tcon.sql("SELECT p_partkey, p_size, to_json(list_value(p_partkey, p_size)) "
                    "FROM part WHERE p_partkey < 50").rows()
    assert rows and all(json.loads(j) == [k, s] for k, s, j in rows)
    assert tcon.sql("SELECT to_json({'a': [1, 2], 'b': {'c': 'x'}})").rows() == [
        ('{"a":[1,2],"b":{"c":"x"}}',)]


def test_json_group_array_is_ported(cons):
    """The default macro to_json(list(x)), no longer refused."""
    _, tcon = cons
    rows = tcon.sql("SELECT o_orderstatus, json_group_array(o_custkey) FROM orders "
                    "WHERE o_orderkey < 100 GROUP BY 1 ORDER BY 1").rows()
    want = tcon.sql("SELECT o_orderstatus, list(o_custkey) FROM orders "
                    "WHERE o_orderkey < 100 GROUP BY 1 ORDER BY 1").rows()
    assert [(s, json.loads(j)) for s, j in rows] == want


def test_json_results_are_cached_per_dictionary(cons):
    """A constant-path extraction over a column's dictionary is computed
    once: the second run of the plan reads the cached lookup table."""
    from duckdb_tpu_torch.ops import strings as TS

    _, tcon = cons
    sql = "SELECT json_extract_string(d, '$.s'), count(*) FROM j GROUP BY 1"
    first = _rows(tcon, sql)
    before = len(TS._LUT_CACHE)
    assert _rows(tcon, sql) == first and len(TS._LUT_CACHE) == before


def test_invalid_documents_a_where_removes_do_not_raise(cons):
    """json() and json_structure raise on text that is not JSON only where
    a row the statement reads holds it (the reference raises whenever the
    dictionary holds one: ROADMAP Queue 3, F3)."""
    _, tcon = cons
    rows = tcon.sql("SELECT id, json(d), json_structure(d) FROM j WHERE json_valid(d)").rows()
    valid = [(i, d) for i, d in enumerate(DOCS * 2) if d is not None and d != "not json"]
    assert sorted(r[:2] for r in rows) == sorted(
        (i, json.dumps(json.loads(d), separators=(",", ":"))) for i, d in valid)
    with pytest.raises(ValueError):
        tcon.sql("SELECT json(d) FROM j").rows()


def test_registry_covers_the_reference(cons):
    """Every JSON function the reference registers (register_json_functions)
    is registered in the port."""
    import re

    from duckdb_tpu.storage import json_io as JJ
    from duckdb_tpu_torch.planner.functions import REGISTRY as TREG

    src = open(JJ.__file__).read()
    names = set(re.findall(r'REGISTRY\["(\w+)"\]', src))
    names |= set(re.findall(r'for _n in \(([^)]*)\)', src) and
                 re.findall(r'"(\w+)"', re.findall(r'for _n in \(([^)]*)\)', src)[0]))
    assert len(names) >= 22
    assert names - set(TREG) == set()


# -- JSON files: tests/test_json.py's file cases through both packages ------------------------

@pytest.fixture()
def ndjson(tmp_path):
    p = tmp_path / "data.ndjson"
    p.write_text('{"id": 1, "name": "alice", "tags": ["a","b"], "score": 9.5}\n'
                 '{"id": 2, "name": "bob", "score": 7}\n'
                 '{"id": 3, "name": "carol", "tags": ["x"], "meta": {"city": "NYC"}}\n')
    return str(p)


def _run_both(script):
    from _torch_parity import run_both

    return run_both(script)


def test_read_ndjson(ndjson):
    _, tcon = _run_both([f"SELECT id, name, score FROM '{ndjson}' ORDER BY id",
                         f"SELECT id FROM read_ndjson('{ndjson}') ORDER BY id",
                         f"SELECT count(*) FROM read_json_auto('{ndjson}')"])
    assert tcon.sql(f"SELECT id, name, score FROM '{ndjson}' ORDER BY id").rows() == [
        (1, "alice", 9.5), (2, "bob", 7.0), (3, "carol", None)]


def test_json_array_length_over_a_file(ndjson):
    _run_both([f"SELECT name, json_array_length(tags) FROM read_json('{ndjson}') "
               "WHERE tags IS NOT NULL ORDER BY id"])


def test_json_extract_over_a_file(ndjson):
    _run_both([f"SELECT json_extract_string(meta, '$.city') FROM '{ndjson}' "
               "WHERE meta IS NOT NULL"])


def test_json_type_and_valid_over_a_file(ndjson):
    _, tcon = _run_both([f"SELECT json_type(tags), json_valid(name) FROM '{ndjson}' "
                         "WHERE id = 1"])
    assert tcon.sql(f"SELECT json_type(tags), json_valid(name) FROM '{ndjson}' "
                    "WHERE id = 1").rows() == [("ARRAY", False)]


def test_json_array_file(tmp_path):
    """An array document; a nested value is VARCHAR JSON text, as in the
    JAX package (DuckDB gives STRUCT and LIST: ROADMAP Facts)."""
    p = tmp_path / "arr.json"
    p.write_text('[{"a": 1, "o": {"k": [1, 2]}, "f": true}, {"a": 2, "f": false}, '
                 '{"a": null, "o": "s"}]')
    _, tcon = _run_both([f"SELECT sum(a), count(*) FROM '{p}'",
                         f"SELECT o, f FROM '{p}' ORDER BY a NULLS LAST"])
    assert tcon.sql(f"SELECT o FROM '{p}' WHERE a = 1").rows() == [('{"k":[1,2]}',)]
    res = tcon.sql(f"SELECT * FROM '{p}'")
    assert [str(t) for t in res.types] == ["BIGINT", "VARCHAR", "BOOLEAN"]
