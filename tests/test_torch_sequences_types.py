"""Sequences, ENUM and user types of duckdb_tpu_torch (device="cpu")
against the JAX package.

The counterparts of tests/test_ddl_ext.py's sequences and
tests/test_enum_uuid.py: CREATE SEQUENCE with START and INCREMENT,
nextval once per live row, currval, setval, DROP SEQUENCE; CREATE TYPE …
AS ENUM with its casts (an unknown value raises, TRY_CAST gives NULL),
enum_range / enum_first / enum_last / enum_code / enum_range_boundary, an
ENUM column, DROP TYPE, a type alias, UUID columns. Rows, Counts and
exception classes must agree (tests/_torch_parity.py). The JAX package
passes these through module globals; the port reads them from the
statement's catalog, so two databases never see each other's (tested).
Where the JAX package differs from DuckDB the port follows DuckDB: currval
before any nextval raises, and CREATE SEQUENCE of a name that exists
raises. The case that reopens a database file waits for ROADMAP item 33.
"""

import os
import sys

import pytest
import torch

import duckdb_tpu
import duckdb_tpu_torch
from duckdb_tpu_torch.errors import ConnectionException
from duckdb_tpu_torch.planner.bound import BindError

sys.path.insert(0, os.path.dirname(__file__))
from _torch_parity import run_both  # noqa: E402

torch.set_num_threads(1)

SCRIPTS = {
    "sequence": [
        "CREATE TABLE t (a INT)", "INSERT INTO t VALUES (1),(2)",
        "CREATE SEQUENCE seq START 5 INCREMENT BY 2",
        "SELECT nextval('seq')",
        "SELECT nextval('seq'), currval('seq')",
        "SELECT a, nextval('seq') FROM t ORDER BY a",
        "SELECT currval('seq')",
        "SELECT a, nextval('seq') FROM t WHERE a > 1",
        "SELECT setval('seq', 100)",
        "SELECT nextval('seq')",
        "CREATE SEQUENCE IF NOT EXISTS seq",
        "SELECT nextval('seq')",
        "DROP SEQUENCE seq",
        "DROP SEQUENCE seq",
        "DROP SEQUENCE IF EXISTS seq",
    ],
    "sequence_defaults": [
        "CREATE SEQUENCE ids START 10",
        "CREATE TABLE u (id BIGINT DEFAULT nextval('ids'), s VARCHAR)",
        "INSERT INTO u (s) VALUES ('a'), ('b')",
        "INSERT INTO u VALUES (1, 'explicit')",
        "SELECT * FROM u ORDER BY id",
    ],
    "enum_casts": [
        "CREATE TYPE mood AS ENUM ('sad', 'ok', 'happy')",
        "SELECT 'ok'::mood",
        "SELECT 'angry'::mood",
        "SELECT TRY_CAST('angry' AS mood)",
        "CREATE TYPE mood AS ENUM ('x')",
        "CREATE TYPE IF NOT EXISTS mood AS ENUM ('x')",
        "SELECT enum_range(NULL::mood)",
    ],
    "enum_functions": [
        "CREATE TYPE mood AS ENUM ('sad', 'ok', 'happy')",
        "SELECT enum_range(NULL::mood)",
        "SELECT enum_first(NULL::mood), enum_last(NULL::mood)",
        "SELECT enum_code('happy'::mood)",
        "SELECT enum_range_boundary('sad'::mood, 'ok'::mood)",
        "SELECT enum_first('a')",
    ],
    "enum_column": [
        "CREATE TYPE mood AS ENUM ('sad', 'ok', 'happy')",
        "CREATE TABLE people (name VARCHAR, m mood)",
        "INSERT INTO people VALUES ('a', 'happy'), ('b', 'sad'), ('c', NULL)",
        "SELECT count(*) FROM people WHERE m = 'happy'",
        "SELECT name, enum_code(CAST(m AS mood)) FROM people ORDER BY name",
        "UPDATE people SET m = 'ok' WHERE name = 'c'",
        "SELECT m, count(*) FROM people GROUP BY m ORDER BY m",
    ],
    "drop_type_and_alias": [
        "CREATE TYPE mood AS ENUM ('sad')",
        "DROP TYPE mood",
        "SELECT 'sad'::mood",
        "DROP TYPE mood",
        "DROP TYPE IF EXISTS mood",
        "CREATE TYPE money AS DECIMAL(18, 2)",
        "SELECT '1.5'::money, typeof('1.5'::money)",
        "CREATE TABLE acct (m money)",
        "INSERT INTO acct VALUES (1.25), ('2.5')",
        "SELECT sum(m) FROM acct",
    ],
    "uuid": [
        "SELECT uuid_extract_version('550e8400-e29b-41d4-a716-446655440000')",
        "CREATE TABLE ids (id UUID)",
        "INSERT INTO ids VALUES ('550e8400-e29b-41d4-a716-446655440000'), (gen_random_uuid())",
        "SELECT count(DISTINCT id), count(*) FROM ids",
    ],
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_script_matches_jax(name):
    run_both(SCRIPTS[name])


def test_currval_before_nextval_held_to_duckdb():
    """The JAX package gives the start less the increment; DuckDB raises."""
    jcon = duckdb_tpu.connect()
    tcon = duckdb_tpu_torch.connect(device="cpu")
    for con in (jcon, tcon):
        con.sql("CREATE SEQUENCE s START 5")
    assert jcon.sql("SELECT currval('s')").rows() == [(4,)]
    with pytest.raises(ValueError, match="currval: sequence \"s\" is not yet defined"):
        tcon.sql("SELECT currval('s')")
    assert tcon.sql("SELECT nextval('s'), currval('s')").rows() == [(5, 5)]


def test_default_sequence_across_statements_held_to_duckdb():
    """D5: in the JAX package an auto-commit INSERT's DEFAULT nextval()
    advances the published sequence, and the statement's commit puts back
    its snapshot's copy, so the next INSERT gives the same ids again.
    DuckDB (and the port) go on counting."""
    jcon = duckdb_tpu.connect()
    tcon = duckdb_tpu_torch.connect(device="cpu")
    for con in (jcon, tcon):
        con.sql("CREATE SEQUENCE ids START 10")
        con.sql("CREATE TABLE u (id BIGINT DEFAULT nextval('ids'), s VARCHAR)")
        con.sql("INSERT INTO u (s) VALUES ('a'), ('b')")
        con.sql("INSERT INTO u (s) SELECT 'c' FROM range(3)")
    assert [r[0] for r in jcon.sql("SELECT id FROM u ORDER BY id").rows()] == [
        10, 10, 11, 11, 12]
    assert tcon.sql("SELECT id, s FROM u ORDER BY id").rows() == [
        (10, "a"), (11, "b"), (12, "c"), (13, "c"), (14, "c")]


def test_create_sequence_twice_held_to_duckdb():
    """The JAX package starts the sequence again; DuckDB raises."""
    jcon = duckdb_tpu.connect()
    tcon = duckdb_tpu_torch.connect(device="cpu")
    for con in (jcon, tcon):
        con.sql("CREATE SEQUENCE s")
        con.sql("SELECT nextval('s'), nextval('s')")
    jcon.sql("CREATE SEQUENCE s")
    assert jcon.sql("SELECT nextval('s')").rows() == [(1,)]
    with pytest.raises(ConnectionException, match='Sequence with name "s" already exists'):
        tcon.sql("CREATE SEQUENCE s")
    assert tcon.sql("SELECT nextval('s')").rows() == [(3,)]


def test_two_databases_keep_their_own_types_sequences_and_macros():
    """Types, sequences and macros live in each database's catalog, not in
    module globals: a second database sees none of the first's."""
    a = duckdb_tpu_torch.connect(device="cpu")
    b = duckdb_tpu_torch.connect(device="cpu")
    a.sql("CREATE TYPE mood AS ENUM ('sad', 'ok')")
    a.sql("CREATE SEQUENCE s START 7")
    a.sql("CREATE MACRO plus1(x) AS x + 1")
    b.sql("CREATE TYPE mood AS ENUM ('x', 'y', 'z')")
    assert a.sql("SELECT enum_range(NULL::mood)").rows() == [(["sad", "ok"],)]
    assert b.sql("SELECT enum_range(NULL::mood)").rows() == [(["x", "y", "z"],)]
    with pytest.raises(ValueError, match='Sequence with name "s" does not exist'):
        b.sql("SELECT nextval('s')")
    with pytest.raises(BindError):
        b.sql("SELECT plus1(1)")
    assert a.sql("SELECT nextval('s'), plus1(1)").rows() == [(7, 2)]
    # a cursor is the same database
    assert a.cursor().sql("SELECT 'ok'::mood, nextval('s')").rows() == [("ok", 8)]


def test_type_defined_in_a_transaction_is_its_own_until_commit():
    con = duckdb_tpu_torch.connect(device="cpu")
    c2 = con.cursor()
    con.sql("BEGIN")
    con.sql("CREATE TYPE mood AS ENUM ('a')")
    assert con.sql("SELECT 'a'::mood").rows() == [("a",)]
    with pytest.raises(BindError, match="unknown type name mood"):
        c2.sql("SELECT 'a'::mood")
    con.sql("COMMIT")
    assert c2.sql("SELECT 'a'::mood").rows() == [("a",)]
