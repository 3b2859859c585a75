"""The relation API, prepared statements, Result.fetchnumpy and the
module-level API of duckdb_tpu_torch (device="cpu") against the JAX
package.

The cases of tests/test_relation.py run on both packages and must give
the same rows, without their pandas and Arrow assertions: `Relation.df`,
`Result.df`, `Result.arrow`, `fetch_record_batch`, `from_df` and
`from_arrow` answer in the port through its own Arrow C interface
(ROADMAP item 35b; tests/test_torch_arrow.py holds them to the JAX
package's). The module-level API runs over its lazily made
default connection (on the CPU here), and its `sql` function shadows the
`duckdb_tpu_torch.sql` subpackage without breaking the port's imports of
it, in this process and in a fresh one.
"""

import ast
import datetime
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import duckdb_tpu
import duckdb_tpu_torch

sys.path.insert(0, os.path.dirname(__file__))
from _torch_parity import same  # noqa: E402

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parent.parent

PEOPLE = ["CREATE TABLE people (name VARCHAR, age INT, city VARCHAR)",
          "INSERT INTO people VALUES ('alice',30,'NYC'),('bob',25,'LA'),('carol',35,'NYC')",
          "CREATE TABLE cities (city VARCHAR, pop INT)",
          "INSERT INTO cities VALUES ('NYC', 8), ('LA', 4)"]


@pytest.fixture()
def cons():
    jcon, tcon = duckdb_tpu.connect(), duckdb_tpu_torch.connect(device="cpu")
    for sql in PEOPLE:
        jcon.sql(sql)
        tcon.sql(sql)
    return jcon, tcon


# each case: con → a value both packages must give alike (rows, or a number)
CASES = {
    "filter_project_order": lambda c: c.table("people").filter("age > 26")
    .project("name", "age").order("age DESC").fetchall(),
    "aggregate": lambda c: c.table("people").aggregate("count(*) AS n, avg(age) AS a", "city")
    .order("city").fetchall(),
    "count": lambda c: [(c.table("people").count(),)],
    "limit": lambda c: c.table("people").order("age").limit(2).fetchall(),
    "limit_offset": lambda c: c.table("people").order("age").limit(2, 1).fetchall(),
    "join": lambda c: [(c.table("people").set_alias("p").join(
        c.table("cities").set_alias("c"), "p.city = c.city").count(),)],
    "left_join": lambda c: c.table("cities").set_alias("c").join(
        c.table("people").set_alias("p"), "p.city = c.city AND p.age > 28", how="left")
    .fetchall(),
    "prepared": lambda c: c.prepare("SELECT name FROM people WHERE age > ? AND city = ?")
    .execute(26, "NYC").rows() + c.prepare("SELECT name FROM people WHERE age > ? AND "
                                           "city = ?").execute(100, "NYC").rows(),
    "prepared_dollar": lambda c: c.prepare("SELECT $2 || name, age + $1 FROM people WHERE "
                                           "name <> 'who?' ORDER BY age").execute(1, "x")
    .rows(),
    "create": lambda c: (c.table("people").filter("age >= 30").create("elders"),
                         c.sql("SELECT count(*) FROM elders").rows())[1],
    "setops": lambda c: sorted(
        c.from_query("SELECT name FROM people WHERE age > 26").union(
            c.from_query("SELECT name FROM people WHERE city = 'NYC'")).fetchall()) + [
        (c.from_query("SELECT name FROM people WHERE age > 26").intersect(
            c.from_query("SELECT name FROM people WHERE city = 'NYC'")).count(),),
        (c.from_query("SELECT name FROM people").except_(
            c.from_query("SELECT name FROM people WHERE city = 'NYC'")).count(),)],
    "distinct_view": lambda c: (c.table("people").project("city").distinct()
                                .create_view("pc"),
                                sorted(c.view("pc").fetchall()))[1],
    "fetchone_columns": lambda c: [c.table("people").order("age").fetchone(),
                                   tuple(c.table("people").columns)],
    # test_dataframe_round_trip without pandas and Arrow
    "round_trip": lambda c: (c.sql("CREATE TABLE t2 (a BIGINT, b VARCHAR)"),
                             c.sql("INSERT INTO t2 VALUES (1, 'x'), (2, 'y'), (3, NULL)"),
                             c.sql("SELECT a, b FROM t2 ORDER BY a").fetchall()
                             + [tuple(c.sql("SELECT a FROM t2 ORDER BY a").fetchnumpy()["a"])])[2],
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_relation_matches_jax(cons, name):
    jcon, tcon = cons
    j, t = CASES[name](jcon), CASES[name](tcon)
    same(name, ("rows", j), ("rows", t))


def test_pandas_and_arrow_name_item_35b(cons):
    """Item 35b's entry points answer (each raised, naming the item): the
    relation's and the result's df(), arrow() and fetch_record_batch() with
    the aliases, and from_df / from_arrow, which refuse what is neither a
    DataFrame nor an Arrow object with a typed error."""
    from duckdb_tpu_torch.errors import InvalidInputException

    _, tcon = cons
    res = tcon.sql("SELECT * FROM people")
    frame = tcon.table("people").df()
    assert list(frame.columns) == res.names and len(frame) == res.nrows
    assert frame.astype(str).equals(res.df().astype(str))
    tcon.from_arrow(res.fetch_arrow_table(), "people_arrow")
    assert tcon.sql("SELECT * FROM people_arrow").rows() == res.rows()
    assert res.fetch_record_batch(1).num_batches == res.record_batch(2).num_rows == res.nrows
    tcon.register_arrow(res.fetch_arrow_reader(2), "people_batches")
    assert tcon.sql("SELECT * FROM people_batches").rows() == res.rows()
    tcon.from_df(frame, "people_df")
    assert tcon.sql("SELECT count(*) FROM people_df").rows() == [(res.nrows,)]
    for call in (lambda: tcon.from_df(None, "x"), lambda: tcon.from_arrow(None, "x")):
        with pytest.raises(InvalidInputException):
            call()


def test_fetchnumpy_gives_host_arrays(cons):
    _, tcon = cons
    tcon.sql("CREATE TABLE n (i INT, x DOUBLE, b BOOLEAN, d DATE, s VARCHAR, m DECIMAL(9,2))")
    tcon.sql("INSERT INTO n VALUES (1, 1.5, true, DATE '2020-01-02', 'a', 1.25), "
             "(NULL, 2.5, false, NULL, NULL, NULL)")
    got = tcon.sql("SELECT * FROM n ORDER BY x").fetchnumpy()
    assert got["i"].dtype == np.int32 and list(got["i"].mask) == [False, True]
    assert got["x"].tolist() == [1.5, 2.5] and got["b"].dtype == np.bool_
    assert got["d"][0] == np.datetime64("2020-01-02") and got["d"].mask[1]
    assert list(got["s"]) == ["a", None] and got["s"].dtype == object
    assert str(got["m"][0]) == "1.25"


def test_explain_repr_and_files(cons, tmp_path):
    _, tcon = cons
    rel = tcon.table("people").filter("age > 26")
    assert "Scan" in rel.explain() or "SCAN" in rel.explain().upper()
    box = repr(rel)
    assert "alice" in box and "carol" in box and "bob" not in box
    rel.to_csv(str(tmp_path / "p.csv"))
    rel.to_parquet(str(tmp_path / "p's.parquet"))
    want = sorted(rel.fetchall())
    assert sorted(tcon.read_csv(str(tmp_path / "p.csv")).fetchall()) == want
    assert sorted(tcon.read_parquet(str(tmp_path / "p's.parquet")).fetchall()) == want
    with pytest.raises(ValueError):
        tcon.table("nope")


def test_module_level_api(monkeypatch, tmp_path):
    """tests/test_relation.py::test_module_level_api on the port, over a
    default connection on the CPU; without CUDA the default device raises
    and says to pass device="cpu"."""
    monkeypatch.setattr(duckdb_tpu_torch, "_default_con", None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            duckdb_tpu_torch.sql("SELECT 1")
    monkeypatch.setattr(duckdb_tpu_torch, "_default_con",
                        duckdb_tpu_torch.connect(device="cpu"))
    assert duckdb_tpu_torch.sql("SELECT 1+1").rows() == [(2,)]
    duckdb_tpu_torch.execute("CREATE OR REPLACE TABLE _mod (a INT)")
    duckdb_tpu_torch.execute("INSERT INTO _mod VALUES (5), (7)")
    assert duckdb_tpu_torch.query("SELECT sum(a) FROM _mod").rows() == [(12,)]
    assert duckdb_tpu_torch.table("_mod").count() == 2
    duckdb_tpu_torch.sql(f"COPY _mod TO '{tmp_path / 'm.csv'}'")
    assert sorted(duckdb_tpu_torch.read_csv(str(tmp_path / "m.csv")).fetchall()) == [(5,), (7,)]
    duckdb_tpu_torch.sql(f"COPY _mod TO '{tmp_path / 'm.parquet'}' (FORMAT PARQUET)")
    assert duckdb_tpu_torch.read_parquet(str(tmp_path / "m.parquet")).count() == 2
    assert duckdb_tpu_torch.default_connection() is duckdb_tpu_torch._default_con
    # the internal SQL subpackage stays importable despite the shadow
    from duckdb_tpu_torch.sql.parser import Parser  # noqa: F401
    assert callable(duckdb_tpu_torch.sql)


def test_sql_subpackage_imports_survive_the_shadow():
    """Every module of the port names the subpackage as `from
    duckdb_tpu_torch.sql[.x] import y` (an `import duckdb_tpu_torch.sql.x`
    would resolve the attribute, now a function), and a fresh process can
    import it after the package."""
    for path in sorted((ROOT / "duckdb_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                assert not any(a.name.startswith("duckdb_tpu_torch.sql") for a in node.names), \
                    path
            # duckdb_tpu_torch.sql.x: an attribute of the function
            assert not (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Attribute)
                        and isinstance(node.value.value, ast.Name)
                        and node.value.value.id == "duckdb_tpu_torch"
                        and node.value.attr == "sql"), path
    code = ("import duckdb_tpu_torch\n"
            "from duckdb_tpu_torch.sql.parser import Parser\n"
            "from duckdb_tpu_torch.sql import nodes, lexer\n"
            "assert callable(duckdb_tpu_torch.sql)\n"
            "assert Parser('SELECT 1').parse_statements()\n"
            "con = duckdb_tpu_torch.connect(device='cpu')\n"
            "assert con.sql('SELECT 40 + 2').rows() == [(42,)]\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)), timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_prepared_parameter_kinds(cons):
    _, tcon = cons
    ps = tcon.prepare("SELECT ?, ?, ?, ?, ? FROM people WHERE name = ?")
    assert ps.nparams == 6
    rows = ps.execute(None, True, "it's", datetime.date(2020, 1, 2), 2.5, "bob").rows()
    assert rows == [(None, True, "it's", datetime.date(2020, 1, 2), 2.5)]
