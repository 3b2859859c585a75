"""H1: Result.fetchone() through duckdb_tpu_torch (device="cpu"), against
the JAX package's (duckdb_tpu/execution/executor.py Result.fetchone).

The first row of a result, or None when it has none, from `execute()`,
`sql()` and a cursor's `sql()`, over DECIMAL, VARCHAR, DATE, LIST, STRUCT
and NULL values, an empty, a one-row and a 100,000-row result. The port
reads row 0 of each host plane and builds no other row's Python values.
"""

import pytest
import torch

import duckdb_tpu
import duckdb_tpu_torch

torch.set_num_threads(1)


def _lists(v):
    """The JAX package gives a LIST's elements as a tuple (fault (c))."""
    if isinstance(v, (tuple, list)):
        return [_lists(x) for x in v]
    if isinstance(v, dict):
        return {k: _lists(x) for k, x in v.items()}
    return v


def _row(r):
    return None if r is None else tuple(_lists(v) for v in r)


SETUP = [
    "CREATE TABLE v (i INTEGER, d DECIMAL(12, 3), s VARCHAR, dt DATE, l INTEGER[], "
    "st STRUCT(a INTEGER, b VARCHAR))",
    "INSERT INTO v VALUES (2, 1.250, 'b', DATE '2024-02-29', [1, NULL, 3], {'a': 1, 'b': 'x'}), "
    "(1, NULL, NULL, NULL, NULL, NULL), (3, -7.001, 'cc', DATE '1969-12-31', [], "
    "{'a': NULL, 'b': 'y'})",
    "CREATE TABLE big AS SELECT range AS k, range * 2 AS k2 FROM range(100000)",
]

QUERIES = {
    "empty": "SELECT * FROM v WHERE i > 10",
    "one_row": "SELECT 42, 'x', NULL",
    "big": "SELECT k, k2 FROM big ORDER BY k DESC",
    "big_agg": "SELECT count(*), sum(k2) FROM big",
    "decimal_varchar_date_list_struct": "SELECT * FROM v ORDER BY i DESC",
    "nulls_first": "SELECT * FROM v ORDER BY i",
    "list_struct_literals": "SELECT [1, 2] AS l, {'a': 1, 'b': 'x'} AS s, 1.5::DECIMAL(10, 2), "
                            "DATE '2024-01-02', NULL",
}


@pytest.fixture(scope="module")
def cons():
    jcon, tcon = duckdb_tpu.connect(), duckdb_tpu_torch.connect(device="cpu")
    for c in (jcon, tcon):
        for s in SETUP:
            c.sql(s)
    return jcon, tcon


@pytest.mark.parametrize("how", ["execute", "sql", "cursor"])
@pytest.mark.parametrize("name", sorted(QUERIES))
def test_h1_fetchone_gives_the_jax_packages_first_row(cons, name, how):
    jcon, tcon = cons
    sql = QUERIES[name]
    if how == "cursor":
        jcon, tcon = jcon.cursor(), tcon.cursor()
    want = _row(getattr(jcon, "sql" if how == "cursor" else how)(sql).fetchone())
    got = getattr(tcon, "sql" if how == "cursor" else how)(sql).fetchone()
    assert got == want
    if name == "empty":
        assert got is None
    else:
        assert got == tcon.sql(sql).rows()[0]


def test_h1_fetchone_reads_one_row_of_the_planes(cons):
    """fetchone() builds one row: Result.rows(0, 1) of a 100,000-row result
    is that row, and a span past the end is cut to the rows there are."""
    _, tcon = cons
    res = tcon.sql(QUERIES["big"])
    assert res.nrows == 100_000
    assert res.rows(0, 1) == [(99_999, 199_998)]
    assert res.rows(99_998) == [(1, 2), (0, 0)]
    assert res.rows(5, 3) == []
    assert tcon.sql("SELECT * FROM v ORDER BY i").fetchone() == (1, None, None, None, None, None)


def test_h1_relation_fetchone_matches_the_result():
    """Relation.fetchone() reads its Result's fetchone()."""
    tcon = duckdb_tpu_torch.connect(device="cpu")
    tcon.sql("CREATE TABLE r AS SELECT range AS x FROM range(3)")
    tcon.sql("CREATE TABLE e (x INTEGER)")
    assert tcon.table("r").order("x DESC").fetchone() == (2,)
    assert tcon.table("e").fetchone() is None
