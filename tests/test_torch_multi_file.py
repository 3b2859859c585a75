"""Multi-file scans in duckdb_tpu_torch (device="cpu") against duckdb_tpu:
the cases of tests/test_multi_file.py through both packages
(tests/_torch_parity.run_both: rows, or the class of the exception), then
what the port adds: Parquet parts read by its own codec, the file
registry's reuse and replacement of a file's table, and a column read
again getting a new dictionary array."""

import os

import numpy as np
import pytest
import torch

import duckdb_tpu_torch
from duckdb_tpu_torch.catalog import catalog as C
from duckdb_tpu_torch.storage import multi_file as mf

from _torch_parity import connect_both, run_both

torch.set_num_threads(1)


@pytest.fixture()
def csv_dir(tmp_path):
    d = tmp_path / "csvs"
    d.mkdir()
    (d / "a.csv").write_text("id,v\n1,x\n2,y\n")
    (d / "b.csv").write_text("id,v\n3,z\n")
    return str(d)


def test_glob_csv(csv_dir):
    run_both([f"SELECT id, v FROM read_csv('{csv_dir}/*.csv') ORDER BY id"])


def test_glob_replacement_scan(csv_dir):
    run_both([f"SELECT count(*) FROM '{csv_dir}/*.csv'"])


def test_filename_column(csv_dir):
    _, tcon = run_both([f"SELECT id, filename FROM read_csv('{csv_dir}/*.csv', filename=true) "
                        "ORDER BY id"])
    rows = tcon.sql(f"SELECT id, filename FROM read_csv('{csv_dir}/*.csv', filename=true) "
                    "ORDER BY id").rows()
    assert [r[0] for r in rows] == [1, 2, 3]
    assert rows[0][1].endswith("a.csv") and rows[2][1].endswith("b.csv")


def test_union_by_name(tmp_path):
    d = tmp_path / "u"
    d.mkdir()
    (d / "a.csv").write_text("id,x\n1,10\n")
    (d / "b.csv").write_text("id,y\n2,hello\n")
    run_both([f"SELECT id, x, y FROM read_csv('{d}/*.csv', union_by_name=true) ORDER BY id"])


def test_schema_mismatch_errors(tmp_path):
    d = tmp_path / "m"
    d.mkdir()
    (d / "a.csv").write_text("id,x\n1,10\n")
    (d / "b.csv").write_text("id,y\n2,20\n")
    _, tcon = run_both([f"SELECT * FROM read_csv('{d}/*.csv')"])
    with pytest.raises(ValueError, match="union_by_name"):
        tcon.sql(f"SELECT * FROM read_csv('{d}/*.csv')")


def _hive(base):
    for year, month, vals in [(2023, 1, [1, 2]), (2023, 2, [3]), (2024, 1, [4, 5, 6])]:
        d = base / f"year={year}" / f"month={month}"
        d.mkdir(parents=True)
        (d / "part.csv").write_text("v\n" + "\n".join(str(v) for v in vals) + "\n")
    return f"{base}/**/*.csv"


def test_hive_partitioning(tmp_path):
    pat = _hive(tmp_path / "hive")
    _, tcon = run_both([
        f"SELECT year, month, sum(v) FROM read_csv('{pat}', hive_partitioning=1) "
        "GROUP BY year, month ORDER BY year, month",
        f"SELECT sum(v) FROM read_csv('{pat}', hive_partitioning=1) WHERE year = 2024"])
    assert tcon.sql(f"SELECT sum(v) FROM read_csv('{pat}', hive_partitioning=1) "
                    "WHERE year = 2024").rows() == [(15,)]


def test_hive_auto_detection(tmp_path):
    base = tmp_path / "auto"
    for region, v in (("eu", 7), ("us", 8)):
        d = base / f"region={region}"
        d.mkdir(parents=True)
        (d / "x.csv").write_text(f"v\n{v}\n")
    run_both([f"SELECT region, v FROM read_csv('{base}/**/*.csv') ORDER BY region"])


def test_multi_parquet(tmp_path):
    """The Parquet parts are written by each package itself: pyarrow in the
    JAX package, the port's own writer in the port."""
    jcon, tcon = connect_both()
    for side, con in (("j", jcon), ("t", tcon)):
        (tmp_path / side).mkdir()
        con.sql(f"COPY (SELECT range AS i, range * 2 AS d FROM range(5)) "
                f"TO '{tmp_path}/{side}/p1.parquet' (FORMAT PARQUET)")
        con.sql(f"COPY (SELECT range + 5 AS i, range AS d FROM range(3)) "
                f"TO '{tmp_path}/{side}/p2.parquet' (FORMAT PARQUET)")
    want = jcon.sql(f"SELECT count(*), sum(i) FROM read_parquet('{tmp_path}/j/*.parquet')").rows()
    assert want == [(8, 28)]
    assert tcon.sql(f"SELECT count(*), sum(i) FROM read_parquet('{tmp_path}/t/*.parquet')"
                    ).rows() == want
    # and each reads the other's files
    assert tcon.sql(f"SELECT count(*), sum(i) FROM read_parquet('{tmp_path}/j/*.parquet')"
                    ).rows() == want
    assert jcon.sql(f"SELECT count(*), sum(i) FROM read_parquet('{tmp_path}/t/*.parquet')"
                    ).rows() == want


def test_list_of_paths(csv_dir):
    run_both([f"SELECT count(*) FROM read_csv(['{csv_dir}/a.csv', '{csv_dir}/b.csv'])"])


def test_no_files_error():
    _, tcon = run_both(["SELECT * FROM read_csv('/nonexistent/dir/*.csv')"])
    with pytest.raises(ValueError, match="No files found"):
        tcon.sql("SELECT * FROM read_csv('/nonexistent/dir/*.csv')")


def test_hive_explicit_mismatch_errors(csv_dir):
    _, tcon = run_both([f"SELECT * FROM read_csv('{csv_dir}/*.csv', hive_partitioning=1)"])
    with pytest.raises(ValueError, match="hive_partitioning"):
        tcon.sql(f"SELECT * FROM read_csv('{csv_dir}/*.csv', hive_partitioning=1)")


def test_hive_single_file_auto_detect(tmp_path):
    d = tmp_path / "single" / "year=2024"
    d.mkdir(parents=True)
    (d / "x.csv").write_text("v\n9\n")
    _, tcon = run_both([f"SELECT year, v FROM read_csv('{d}/x.csv')",
                        f"SELECT year, v FROM '{d}/x.csv'"])
    assert tcon.sql(f"SELECT year, v FROM '{d}/x.csv'").rows() == [(2024, 9)]


def test_unknown_named_parameter_errors(csv_dir):
    _, tcon = run_both([f"SELECT * FROM read_csv('{csv_dir}/a.csv', union_by_names=true)"])
    with pytest.raises(ValueError, match="union_by_names"):
        tcon.sql(f"SELECT * FROM read_csv('{csv_dir}/a.csv', union_by_names=true)")


# -- what the port adds ------------------------------------------------------------------

def test_hive_parquet_partitions_and_decimal_rescaling(tmp_path):
    """Parquet parts under l_returnflag=X/ directories, one written with a
    DECIMAL of another scale: the flag comes from the path, the DECIMAL
    parts are rescaled to the merged scale."""
    tcon = duckdb_tpu_torch.connect(device="cpu")
    for flag, scale in (("A", 2), ("N", 2), ("R", 4)):
        (tmp_path / f"l_returnflag={flag}").mkdir()
        tcon.sql(f"COPY (SELECT range AS k, CAST(range * 1.25 AS DECIMAL(15,{scale})) AS p "
                 f"FROM range(4)) TO '{tmp_path}/l_returnflag={flag}/part.parquet'")
    rows = tcon.sql(f"SELECT l_returnflag, sum(p), count(*) FROM read_parquet("
                    f"'{tmp_path}/*/*.parquet', hive_partitioning=true) GROUP BY l_returnflag "
                    "ORDER BY l_returnflag").rows()
    import decimal

    assert [(r[0], r[1], r[2]) for r in rows] == [
        (f, decimal.Decimal("7.5000"), 4) for f in ("A", "N", "R")]
    assert str(tcon.sql(f"SELECT p FROM read_parquet('{tmp_path}/*/*.parquet') LIMIT 1")
               .types[0]) == "DECIMAL(17,4)"  # 13 integer digits, scale 4


def test_partition_column_types():
    assert mf.partition_column([1, 2], ["1995", "3"])[0].id.name == "BIGINT"
    assert mf.partition_column([1, 2], ["1995", "x"])[0].id.name == "VARCHAR"
    assert mf.hive_parts(["a/year=1995/month=3/f.parquet", "a/year=1996/month=1/f.parquet"]) == [
        {"year": "1995", "month": "3"}, {"year": "1996", "month": "1"}]
    assert mf.hive_parts(["a/year=1995/f.csv", "a/f.csv"]) is None


def test_registry_reuses_and_replaces_a_file_table(tmp_path):
    """An unchanged file gives the table read before; a rewritten one is
    read again, its VARCHAR column gets a new dictionary array, and the old
    table leaves the catalog and the pool (with memory_limit set)."""
    p = tmp_path / "r.csv"
    p.write_text("a,s\n1,x\n2,y\n")
    con = duckdb_tpu_torch.connect(device="cpu")
    con.sql("SET memory_limit = '64MB'")
    try:
        sql = f"SELECT count(*), sum(a), min(s) FROM '{p}'"
        assert con.sql(sql).rows() == [(2, 3, "x")]
        (name,) = [n for n in con.catalog.tables if n.startswith("__file_")]
        old = con.catalog.get_table(name)
        old_dict = old.host_column("s")[2]
        assert C.POOL.holds(old)
        assert con.sql(f"SELECT max(s) FROM '{p}'").rows() == [("y",)]
        assert [n for n in con.catalog.tables if n.startswith("__file_")] == [name]
        p.write_text("a,s\n1,q\n2,x\n3,y\n4,z\n")
        os.utime(p, ns=(os.stat(p).st_atime_ns, os.stat(p).st_mtime_ns + 10**9))
        assert con.sql(sql).rows() == [(4, 10, "q")]
        names = [n for n in con.catalog.tables if n.startswith("__file_")]
        assert len(names) == 1 and names[0] != name
        new_dict = con.catalog.get_table(names[0]).host_column("s")[2]
        assert new_dict is not old_dict and list(new_dict) == ["q", "x", "y", "z"]
        assert not C.POOL.holds(old)
        new = con.catalog.get_table(names[0])
        assert C.POOL.holds(new)
        con.catalog.drop_table(names[0])  # a dropped file table lets go of its bytes
        assert not C.POOL.holds(new)
        assert con.sql(sql).rows() == [(4, 10, "q")]  # and is registered again
    finally:
        con.sql("SET memory_limit = '0B'")


def test_merge_schemas_promotes_and_refuses():
    from duckdb_tpu_torch.types import BIGINT, DOUBLE, INTEGER, VARCHAR

    assert mf.merge_schemas([[("a", INTEGER)], [("a", BIGINT)]], False) == [("a", BIGINT)]
    assert mf.merge_schemas([[("a", INTEGER)], [("a", VARCHAR)]], False) == [("a", VARCHAR)]
    assert mf.merge_schemas([[("a", INTEGER)], [("b", DOUBLE)]], True) == [
        ("a", INTEGER), ("b", DOUBLE)]
    with pytest.raises(ValueError, match="union_by_name"):
        mf.merge_schemas([[("a", INTEGER)], [("b", INTEGER)]], False)
    codes, valid, d = mf.concat_parts([None, (np.array([0, 1], np.int32), None,
                                              np.array(["b", "c"], object))], [1, 2], VARCHAR)
    assert list(d[codes]) == ["", "b", "c"] and list(valid) == [False, True, True]
