"""TPC-H schema registration from dbgen_tbl binary-columnar directories.

Schema matches the reference tpch extension's DDL
(duckdb/extension/tpch/dbgen/dbgen.cpp table Info structs):
keys BIGINT, money DECIMAL(15,2), dates DATE, flags VARCHAR.
Columns load lazily — untouched columns (e.g. l_comment for most queries)
never leave disk.
"""

from __future__ import annotations

import os
from functools import partial

from duckdb_tpu_torch.catalog.catalog import Catalog, ColumnDef, TableEntry
from duckdb_tpu_torch.storage import binary_dir
from duckdb_tpu_torch.types import (
    BIGINT,
    DATE,
    INTEGER,
    VARCHAR,
    decimal,
)

_DEC = decimal(15, 2)

TPCH_SCHEMA = {
    "region": [
        ("r_regionkey", INTEGER),
        ("r_name", VARCHAR),
        ("r_comment", VARCHAR),
    ],
    "nation": [
        ("n_nationkey", INTEGER),
        ("n_name", VARCHAR),
        ("n_regionkey", INTEGER),
        ("n_comment", VARCHAR),
    ],
    "supplier": [
        ("s_suppkey", BIGINT),
        ("s_name", VARCHAR),
        ("s_address", VARCHAR),
        ("s_nationkey", INTEGER),
        ("s_phone", VARCHAR),
        ("s_acctbal", _DEC),
        ("s_comment", VARCHAR),
    ],
    "customer": [
        ("c_custkey", BIGINT),
        ("c_name", VARCHAR),
        ("c_address", VARCHAR),
        ("c_nationkey", INTEGER),
        ("c_phone", VARCHAR),
        ("c_acctbal", _DEC),
        ("c_mktsegment", VARCHAR),
        ("c_comment", VARCHAR),
    ],
    "part": [
        ("p_partkey", BIGINT),
        ("p_name", VARCHAR),
        ("p_mfgr", VARCHAR),
        ("p_brand", VARCHAR),
        ("p_type", VARCHAR),
        ("p_size", INTEGER),
        ("p_container", VARCHAR),
        ("p_retailprice", _DEC),
        ("p_comment", VARCHAR),
    ],
    "partsupp": [
        ("ps_partkey", BIGINT),
        ("ps_suppkey", BIGINT),
        ("ps_availqty", INTEGER),
        ("ps_supplycost", _DEC),
        ("ps_comment", VARCHAR),
    ],
    "orders": [
        ("o_orderkey", BIGINT),
        ("o_custkey", BIGINT),
        ("o_orderstatus", VARCHAR),
        ("o_totalprice", _DEC),
        ("o_orderdate", DATE),
        ("o_orderpriority", VARCHAR),
        ("o_clerk", VARCHAR),
        ("o_shippriority", INTEGER),
        ("o_comment", VARCHAR),
    ],
    "lineitem": [
        ("l_orderkey", BIGINT),
        ("l_partkey", BIGINT),
        ("l_suppkey", BIGINT),
        ("l_linenumber", INTEGER),
        ("l_quantity", _DEC),
        ("l_extendedprice", _DEC),
        ("l_discount", _DEC),
        ("l_tax", _DEC),
        ("l_returnflag", VARCHAR),
        ("l_linestatus", VARCHAR),
        ("l_shipdate", DATE),
        ("l_commitdate", DATE),
        ("l_receiptdate", DATE),
        ("l_shipinstruct", VARCHAR),
        ("l_shipmode", VARCHAR),
        ("l_comment", VARCHAR),
    ],
}


def _load_col(table_dir: str, name: str, kind: str):
    if kind == "str":
        codes, uniq = binary_dir.load_string_dict(table_dir, name)
        return codes, None, uniq
    return binary_dir.read_numeric_column(table_dir, name, kind), None, None


def register_tpch(catalog: Catalog, data_dir: str):
    """Register all TPC-H tables found under data_dir (dbgen_tbl output)."""
    for tname, cols in TPCH_SCHEMA.items():
        tdir = os.path.join(data_dir, tname)
        if not os.path.isdir(tdir):
            continue
        meta = binary_dir.read_meta(tdir)
        kinds = {c["name"]: c["kind"] for c in meta["columns"]}
        entry = TableEntry(tname, [ColumnDef(n, t) for n, t in cols])
        entry.nrows = meta["rows"]
        for cname, _ in cols:
            entry.set_lazy_column(cname, partial(_load_col, tdir, cname, kinds[cname]))
        catalog.create_table(entry, or_replace=True)
