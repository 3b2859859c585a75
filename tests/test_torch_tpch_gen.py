"""The port's TPC-H generator: all eight tables, keys that join, and a
lineitem that does not move.

lineitem at SF 0.01, seed 7 is pinned by a sha256 of its files, taken when
the generator wrote lineitem alone: the other tables draw from streams of
their own, so Q1's data is the same whichever tables are written. Primary
keys must be unique and every foreign key must resolve, and the text
columns that TPC-H's LIKE predicates read follow the specification.
"""

import hashlib
import itertools
import os

import numpy as np
import pytest

from duckdb_tpu_torch.testing import tpch_gen
from duckdb_tpu_torch.testing.tpch_gen import write_lineitem, write_tables

LINEITEM_SF001_SEED7_SHA256 = "0fae3321fb05e98cf84f635fde76bec47c6504db1856db6a1e3dc742d94484b5"


def _digest(table_dir):
    h = hashlib.sha256()
    for name in sorted(os.listdir(table_dir)):
        if name.endswith((".codes.i32", ".dict.len", ".dict.bytes")):
            continue  # the readers' dictionary sidecars
        with open(os.path.join(table_dir, name), "rb") as f:
            h.update(name.encode())
            h.update(f.read())
    return h.hexdigest()


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tpch_gen_keys"))
    write_tables(root, 0.01, seed=7)
    return root


def _col(root, table, col):
    base = os.path.join(root, table, col)
    if os.path.exists(base + ".i64"):
        return np.fromfile(base + ".i64", dtype=np.int64)
    if os.path.exists(base + ".i32"):
        return np.fromfile(base + ".i32", dtype=np.int32).astype(np.int64)
    lens = np.fromfile(base + ".len", dtype=np.uint32)
    blob = np.fromfile(base + ".bytes", dtype=np.uint8).tobytes()
    ends = np.cumsum(lens)
    return np.array([blob[e - n:e].decode() for e, n in zip(ends, lens)], dtype=object)


@pytest.mark.parametrize("writer", ["lineitem_only", "all_tables"])
def test_lineitem_is_pinned(tmp_path, writer):
    if writer == "lineitem_only":
        tdir = write_lineitem(str(tmp_path), 0.01, seed=7)
    else:
        tdir = os.path.join(write_tables(str(tmp_path), 0.01, seed=7), "lineitem")
    assert _digest(tdir) == LINEITEM_SF001_SEED7_SHA256


@pytest.mark.parametrize("table,cols", [
    ("region", ["r_regionkey"]), ("nation", ["n_nationkey"]),
    ("supplier", ["s_suppkey"]), ("customer", ["c_custkey"]), ("part", ["p_partkey"]),
    ("partsupp", ["ps_partkey", "ps_suppkey"]), ("orders", ["o_orderkey"]),
    ("lineitem", ["l_orderkey", "l_linenumber"]),
])
def test_primary_keys_unique(tables, table, cols):
    keys = np.stack([_col(tables, table, c) for c in cols], axis=1)
    assert len(keys) and len(np.unique(keys, axis=0)) == len(keys)


@pytest.mark.parametrize("child,fk,parent,pk", [
    ("lineitem", ["l_orderkey"], "orders", ["o_orderkey"]),
    ("lineitem", ["l_partkey", "l_suppkey"], "partsupp", ["ps_partkey", "ps_suppkey"]),
    ("partsupp", ["ps_partkey"], "part", ["p_partkey"]),
    ("partsupp", ["ps_suppkey"], "supplier", ["s_suppkey"]),
    ("orders", ["o_custkey"], "customer", ["c_custkey"]),
    ("customer", ["c_nationkey"], "nation", ["n_nationkey"]),
    ("supplier", ["s_nationkey"], "nation", ["n_nationkey"]),
    ("nation", ["n_regionkey"], "region", ["r_regionkey"]),
])
def test_foreign_keys_resolve(tables, child, fk, parent, pk):
    radix = 1 << 20
    key = sum(_col(tables, child, c) * radix ** i for i, c in enumerate(fk))
    ref = sum(_col(tables, parent, c) * radix ** i for i, c in enumerate(pk))
    assert np.isin(key, ref).all()


def test_specification_distributions(tables):
    orders = {c: _col(tables, "orders", c) for c in
              ("o_orderkey", "o_custkey", "o_orderstatus", "o_orderdate",
               "o_orderpriority", "o_shippriority")}
    assert (orders["o_custkey"] % 3 != 0).all()
    assert (orders["o_shippriority"] == 0).all()
    assert set(orders["o_orderpriority"]) == set(tpch_gen.PRIORITIES)
    # each order's key and date are the ones its lines carry; its status
    # follows its lines' l_linestatus
    lkey = _col(tables, "lineitem", "l_orderkey")
    status = _col(tables, "lineitem", "l_linestatus")
    row = np.searchsorted(orders["o_orderkey"], lkey)
    assert (orders["o_orderkey"][row] == lkey).all()
    assert (_col(tables, "lineitem", "l_shipdate") > orders["o_orderdate"][row]).all()
    for want, lines in (("F", "F"), ("O", "O")):
        only = np.ones(len(orders["o_orderkey"]), dtype=bool)
        np.logical_and.at(only, row, status == lines)
        assert (orders["o_orderstatus"][only] == want).all()
    assert set(orders["o_orderstatus"]) <= {"F", "O", "P"}
    cust_nation = _col(tables, "customer", "c_nationkey")
    phone = _col(tables, "customer", "c_phone")
    assert all(p.startswith(f"{n + 10}-") for p, n in zip(phone, cust_nation))
    assert set(_col(tables, "customer", "c_mktsegment")) == set(tpch_gen.SEGMENTS)
    bal = _col(tables, "customer", "c_acctbal")
    assert bal.min() >= -99_999 and bal.max() <= 999_999
    names = _col(tables, "nation", "n_name")
    assert list(names) == [n for n, _ in tpch_gen.NATIONS]
    assert list(_col(tables, "region", "r_name")) == tpch_gen.REGIONS


def test_table_sizes_follow_scale():
    sizes = tpch_gen.table_sizes(1.0)
    assert sizes == {"part": 200_000, "supplier": 10_000, "customer": 150_000,
                     "lineitem": 6_001_215}


def test_text_columns_follow_specification(tables):
    """p_name: five distinct colors of the 92; p_type: the 6 × 5 × 5 syllable
    triples; o_comment: 19 to 78 characters, near-unique, some holding
    "special" and later "requests" (Q13's NOT LIKE); s_comment: 25 to 100
    characters."""
    colors = set(tpch_gen.COLORS)
    assert len(colors) == 92
    names = _col(tables, "part", "p_name")
    words = [n.split(" ") for n in names]
    assert all(len(w) == 5 and len(set(w)) == 5 and set(w) <= colors for w in words)
    types = set(_col(tables, "part", "p_type"))
    triples = {" ".join(t) for t in itertools.product(*tpch_gen.TYPE_SYLLABLES)}
    assert len(triples) == 150 and types <= triples and len(types) > 140
    comments = _col(tables, "orders", "o_comment")
    lens = np.array([len(c) for c in comments])
    assert lens.min() >= 19 and lens.max() <= 78
    assert len(set(comments)) > 0.99 * len(comments)
    assert any("special" in c and "requests" in c[c.index("special"):] for c in comments)
    supp = _col(tables, "supplier", "s_comment")
    assert all(25 <= len(c) <= 100 for c in supp)


def test_supplier_remarks_per_10000():
    """At SF1's 10,000 suppliers, 5 comments hold "Customer" and then
    "Complaints", and 5 others "Customer" and then "Recommends"."""
    mat, lens = tpch_gen._supplier_comments(np.random.default_rng(0), 10_000)
    text = [bytes(m[:n]).decode() for m, n in zip(mat, lens)]

    def has(c, tail):
        return "Customer" in c and tail in c[c.index("Customer") + 8:]

    assert sum(has(c, "Complaints") for c in text) == 5
    assert sum(has(c, "Recommends") for c in text) == 5
    assert all(25 <= len(c) <= 100 for c in text)
