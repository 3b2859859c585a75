"""The catalog table functions duckdb_tables(), duckdb_columns(),
duckdb_types() and pragma_table_info() through duckdb_tpu_torch
(device="cpu"), against duckdb_tpu and against the generator's own schema.

A plan that holds one of them snapshots the catalog, so the connection
never caches it: a second duckdb_tables() sees a table created after the
first, and its hidden snapshot tables are dropped after each run. The
functions that wait for later items still name them.
"""

import numpy as np
import pytest
import torch

import duckdb_tpu
import duckdb_tpu_torch
from duckdb_tpu_torch.catalog.catalog import ColumnDef, TableEntry
from duckdb_tpu_torch.planner.bound import BindError
from duckdb_tpu_torch.testing.tpch_gen import TABLE_COLUMNS, write_tables
from duckdb_tpu_torch.types import INTEGER

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("tpch_gen_catalog")
    write_tables(str(root), 0.01, seed=7)
    return str(root)


@pytest.fixture(scope="module")
def cons(data_dir):
    jcon = duckdb_tpu.connect()
    jcon.load_tpch(data_dir)
    tcon = duckdb_tpu_torch.connect(device="cpu")
    tcon.load_tpch(data_dir)
    return jcon, tcon


PARITY = [
    "SELECT * FROM duckdb_tables()",
    "SELECT * FROM duckdb_columns()",
    "SELECT * FROM duckdb_types()",
    "SELECT * FROM pragma_table_info('region')",
    "SELECT * FROM pragma_table_info('lineitem')",
    "SELECT table_name, count(*) FROM duckdb_columns() GROUP BY table_name ORDER BY 1",
    "SELECT name, column_count FROM duckdb_tables() WHERE estimated_size > 1000 ORDER BY 1",
    "SELECT logical_type, count(*) FROM duckdb_types() GROUP BY 1 ORDER BY 1",
]


@pytest.mark.parametrize("sql", PARITY)
def test_catalog_functions_match_reference(cons, sql):
    jcon, tcon = cons
    assert tcon.sql(sql).rows() == jcon.sql(sql).rows()


def test_catalog_functions_follow_the_schema(cons, data_dir):
    """duckdb_columns() and pragma_table_info() list each generated
    table's columns in order; duckdb_tables() their counts."""
    _, tcon = cons
    cols = tcon.sql("SELECT table_name, column_name, column_index FROM duckdb_columns()").rows()
    want = [(t, c, i) for t in sorted(TABLE_COLUMNS)
            for i, (c, _) in enumerate(TABLE_COLUMNS[t])]
    assert cols == want
    info = tcon.sql("SELECT cid, name FROM pragma_table_info('lineitem')").rows()
    assert info == [(i, c) for i, (c, _) in enumerate(TABLE_COLUMNS["lineitem"])]
    tables = tcon.sql("SELECT name, column_count FROM duckdb_tables()").rows()
    assert tables == [(t, len(TABLE_COLUMNS[t])) for t in sorted(TABLE_COLUMNS)]


def test_catalog_plans_are_not_cached(data_dir):
    """The second duckdb_tables() sees a table created after the first;
    no snapshot table outlives its run."""
    tcon = duckdb_tpu_torch.connect(device="cpu")
    tcon.load_tpch(data_dir)
    sql = "SELECT name FROM duckdb_tables()"
    first = [r[0] for r in tcon.sql(sql).rows()]
    assert "t_new" not in first
    entry = TableEntry("t_new", [ColumnDef("a", INTEGER)])
    entry.nrows = 2
    entry.set_host_column("a", np.array([1, 2], dtype=np.int32))
    tcon.catalog.create_table(entry)
    second = [r[0] for r in tcon.sql(sql).rows()]
    assert second == sorted(first + ["t_new"])
    assert sql not in tcon._plan_cache
    assert not [n for n in tcon.catalog.tables if n.startswith("__")]
    assert tcon.sql("SELECT count(*) FROM pragma_table_info('t_new')").rows() == [(1,)]


@pytest.mark.parametrize("name,item", [("duckdb_settings", 36), ("duckdb_logs", 36),
                                       ("duckdb_views", 34), ("duckdb_indexes", 34)])
def test_later_catalog_functions_name_their_item(cons, name, item):
    """The views and indexes of item 34 give the JAX package's rows; the
    settings and the log of item 36 give its columns (the settings' names,
    types and scopes are held in tests/test_torch_settings.py, the log's
    lines in tests/test_torch_main.py)."""
    jcon, tcon = cons
    if item == 34:
        assert tcon.sql(f"SELECT * FROM {name}()").rows() == \
            jcon.sql(f"SELECT * FROM {name}()").rows()
        return
    mine, theirs = tcon.sql(f"SELECT * FROM {name}()"), jcon.sql(f"SELECT * FROM {name}()")
    assert mine.names == theirs.names
    assert [str(t) for t in mine.types] == [str(t) for t in theirs.types]
    assert mine.rows() and theirs.rows()


def test_pragma_table_info_needs_a_table(cons):
    _, tcon = cons
    with pytest.raises(BindError, match="Table with name nope does not exist"):
        tcon.sql("SELECT * FROM pragma_table_info('nope')")
    with pytest.raises(BindError, match="takes no arguments"):
        tcon.sql("SELECT * FROM duckdb_tables(1)")
