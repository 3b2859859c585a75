"""ATTACH / DETACH in the port against the JAX package (the counterpart of
tests/test_attach.py), and F10.

A file database attached under an alias: its tables and its views (whose
bodies bind in its own catalog) read as alias.name, a join across
databases, READ_ONLY refusing writes, ':memory:', IF NOT EXISTS, the
default alias and the errors, each through both packages
(tests/_torch_parity.run_both_files). F10 (ROADMAP Queue 3): the JAX
package writes an attached database only at CHECKPOINT, DETACH or
close(), so a committed write is lost when the process dies; the port
checkpoints the attached database inside the commit, as DuckDB makes a
commit durable before it returns. Held with a crash in process and with a
killed child process.
"""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

import duckdb_tpu_torch

sys.path.insert(0, os.path.dirname(__file__))
from _torch_parity import run_both_files  # noqa: E402

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _make_ext(side):
    c = side.connect("ext_db")
    for q in ("CREATE TABLE items (id INT, name VARCHAR)",
              "INSERT INTO items VALUES (1, 'hammer'), (2, 'wrench')",
              "CREATE VIEW big AS SELECT * FROM items WHERE id > 1"):
        c.sql(q)
    c.close()
    side.crash()
    return side.path("ext_db")


def _run(side, con, script):
    return [(q, side.sql(con, q)) for q in script]


SCRIPTS = {
    "read": lambda ext: [f"ATTACH '{ext}' AS ext", "SELECT * FROM ext.items ORDER BY id",
                         "SELECT * FROM ext.big"],
    "read_only": lambda ext: [f"ATTACH '{ext}' AS ro (READ_ONLY)",
                              "INSERT INTO ro.items VALUES (9, 'x')",
                              "CREATE TABLE ro.t2 (a INT)", "SELECT count(*) FROM ro.items"],
    "memory": lambda ext: ["ATTACH ':memory:' AS scratch", "CREATE TABLE scratch.t (a INT)",
                           "INSERT INTO scratch.t VALUES (5)", "SELECT * FROM scratch.t",
                           "DETACH scratch", "SELECT * FROM scratch.t"],
    "cross_database_join": lambda ext: [
        f"ATTACH '{ext}' AS ext", "CREATE TABLE loc (id INT, qty INT)",
        "INSERT INTO loc VALUES (1, 7), (3, 9)",
        "SELECT r.name, l.qty FROM ext.items r JOIN loc l ON r.id = l.id"],
    "errors": lambda ext: [
        f"ATTACH '{ext}' AS ext", f"ATTACH '{ext}' AS ext2", "ATTACH ':memory:' AS ext",
        f"ATTACH IF NOT EXISTS '{ext}' AS ext", "DETACH nope", "DETACH IF EXISTS nope",
        "SELECT count(*) FROM ext.items"],
    "default_alias": lambda ext: [f"ATTACH '{ext}'", "SELECT count(*) FROM ext_db.items"],
    "write_then_detach": lambda ext: [
        f"ATTACH '{ext}' AS ext", "INSERT INTO ext.items VALUES (3, 'saw')",
        "UPDATE ext.items SET name = 'mallet' WHERE id = 1", "DETACH ext",
        "SELECT * FROM ext.items"],
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_attach_matches_jax(tmp_path, name):
    def scenario(side):
        ext = _make_ext(side)
        out = _run(side, side.connect(), SCRIPTS[name](ext))
        if name == "write_then_detach":
            side.crash()
            c2 = side.connect("ext_db")
            out += _run(side, c2, ["SELECT * FROM items ORDER BY id", "SELECT * FROM big"])
            c2.close()
        return out

    _, t = run_both_files(tmp_path, scenario)
    if name == "read_only":
        assert "read-only" in str(t[1][1][1]) and "read-only" in str(t[2][1][1])
    if name == "write_then_detach":
        assert t[-2][1] == ("rows", [(1, "mallet"), (2, "wrench"), (3, "saw")])


def test_f10_attached_write_survives_a_crash(tmp_path):
    """F10: after a committed INSERT into an attached database the process
    dies (no DETACH, CHECKPOINT or close): the port's row is there on
    reopen, as DuckDB's is; the JAX package's is lost."""
    counts = {}
    for which in ("jax", "torch"):
        from _torch_parity import FilePackage

        side = FilePackage(which, tmp_path)
        ext = _make_ext(side)
        con = side.connect()
        con.sql(f"ATTACH '{ext}' AS ext")
        con.sql("BEGIN")
        con.sql("INSERT INTO ext.items VALUES (3, 'saw')")
        con.sql("DELETE FROM ext.items WHERE id = 1")
        con.sql("COMMIT")
        side.crash()
        del con
        counts[which] = side.connect("ext_db").sql("SELECT id FROM items ORDER BY id").rows()
    assert counts["torch"] == [(2,), (3,)]
    assert counts["jax"] == [(1,), (2,)]  # the JAX package lost the commit (F10)


def test_f10_killed_child_process(tmp_path):
    """A child process attaches, commits an INSERT and dies with os._exit
    right after COMMIT returns; the parent opens the database with the
    row."""
    ext = str(tmp_path / "ext_db")
    c = duckdb_tpu_torch.connect(ext, device="cpu")
    c.sql("CREATE TABLE items (id INT, name VARCHAR)")
    c.sql("INSERT INTO items VALUES (1, 'hammer')")
    c.close()
    child = textwrap.dedent(f"""
        import os, sys
        sys.path.insert(0, {ROOT!r})
        import torch
        torch.set_num_threads(1)
        import duckdb_tpu_torch
        con = duckdb_tpu_torch.connect(device="cpu")
        con.sql("ATTACH '{ext}' AS ext")
        con.sql("INSERT INTO ext.items VALUES (2, 'saw')")
        os._exit(0)
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, "-c", child], check=True, env=env, timeout=300)
    con = duckdb_tpu_torch.connect(ext, device="cpu")
    assert con.sql("SELECT * FROM items ORDER BY id").rows() == [(1, "hammer"), (2, "saw")]
    con.close()


def test_attached_entries_are_clones(tmp_path):
    """ATTACH adopts clones: the sub-database's entries keep their names."""
    from duckdb_tpu_torch.api import connection as C

    ext = str(tmp_path / "ext_db")
    c = duckdb_tpu_torch.connect(ext, device="cpu")
    c.sql("CREATE TABLE items (id INT)")
    c.close()
    con = duckdb_tpu_torch.connect(device="cpu")
    con.sql(f"ATTACH '{ext}' AS ext")
    entry = con.catalog.get_table("ext.items")
    assert entry.name == "ext.items"
    assert C._OPEN_DBS[ext].catalog.get_table("items").name == "items"
    con.sql("INSERT INTO ext.items VALUES (4)")
    assert con.sql("SELECT * FROM ext.items").rows() == [(4,)]
    con.close()


def test_an_attached_directory_has_one_writer(tmp_path):
    """A directory ATTACHed by one database refuses connect() and an ATTACH
    by another database until DETACH or the attaching database's last
    close, as DuckDB refuses a file already in use: two writers would each
    checkpoint over the other's generation and WAL."""
    from duckdb_tpu_torch.errors import ConnectionException

    ext = str(tmp_path / "ext_db")
    c = duckdb_tpu_torch.connect(ext, device="cpu")
    c.sql("CREATE TABLE items (id INT)")
    c.close()
    a = duckdb_tpu_torch.connect(device="cpu")
    a.sql(f"ATTACH '{ext}' AS ext")
    a.sql("INSERT INTO ext.items VALUES (1)")
    b = duckdb_tpu_torch.connect(device="cpu")
    with pytest.raises(ConnectionException, match="attached to another database"):
        duckdb_tpu_torch.connect(ext, device="cpu")
    for sql in (f"ATTACH '{ext}' AS e2", f"ATTACH '{ext}' AS e2 (READ_ONLY)"):
        with pytest.raises(ConnectionException, match="already open"):
            b.sql(sql)
    with pytest.raises(ConnectionException, match="already open"):
        duckdb_tpu_torch.connect(str(tmp_path / "main_db"), device="cpu").sql(
            f"ATTACH '{ext}' AS e3")
    a.sql("DETACH ext")
    b.sql(f"ATTACH '{ext}' AS e2")  # free again
    assert b.sql("SELECT * FROM e2.items").rows() == [(1,)]
    b.sql("INSERT INTO e2.items VALUES (2)")
    with pytest.raises(ConnectionException, match="already open"):
        a.sql(f"ATTACH '{ext}' AS ext")
    b.close()  # the last close lets go of what it attached
    own = duckdb_tpu_torch.connect(ext, device="cpu")
    assert own.sql("SELECT id FROM items ORDER BY id").rows() == [(1,), (2,)]
    own.close()
    a.sql("BEGIN")
    a.sql(f"ATTACH '{ext}' AS ext")
    a.sql("ROLLBACK")  # the attaching database still holds the directory ...
    with pytest.raises(ConnectionException, match="attached to another database"):
        duckdb_tpu_torch.connect(ext, device="cpu")
    a.sql(f"ATTACH '{ext}' AS ext")  # ... and may attach it again
    a.sql("BEGIN")
    a.sql("DETACH ext")
    a.sql("COMMIT")
    duckdb_tpu_torch.connect(ext, device="cpu").close()
    a.close()


def test_a_read_after_use_of_an_attached_database_recovers(tmp_path):
    """After USE of an attached database an unqualified name reads that
    database, which a replay could not: the commit checkpoints instead of
    logging, and the row is there after a crash."""
    from duckdb_tpu_torch.api import connection as C

    ext, main = str(tmp_path / "ext_db"), str(tmp_path / "main_db")
    c = duckdb_tpu_torch.connect(ext, device="cpu")
    c.sql("CREATE TABLE t (a INT)")
    c.sql("INSERT INTO t VALUES (7)")
    c.close()
    m = duckdb_tpu_torch.connect(main, device="cpu")
    m.sql("CREATE TABLE t (a INT)")
    m.sql(f"ATTACH '{ext}' AS ext")
    m.sql("USE ext")
    m.sql("INSERT INTO main.t SELECT * FROM t")
    C._OPEN_DBS.clear()
    again = duckdb_tpu_torch.connect(main, device="cpu")
    assert again.sql("SELECT * FROM t").rows() == [(7,)]
    again.close()
