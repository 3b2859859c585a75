"""Seeded numpy generator of the TPC-H `lineitem` table.

Writes the dbgen_tbl directory format that storage/binary_dir.py reads
(and that the JAX package's reader reads too), so both packages can load
one generated directory:

    <out>/lineitem/meta.json           {"rows": N, "columns": [{name, kind}]}
    <out>/lineitem/<col>.i64 | .i32    raw little-endian values
    <out>/lineitem/<col>.len + .bytes  u32 lengths + utf-8 payload (VARCHAR)

The columns TPC-H Q1 reads follow the TPC-H specification §4.2.3:
l_quantity uniform in [1, 50]; l_extendedprice = quantity × the part's
retail price; l_discount in [0.00, 0.10]; l_tax in [0.00, 0.08];
l_shipdate = order date + [1, 121] days with order dates uniform in
[1992-01-01, 1998-08-02]; l_receiptdate = ship date + [1, 30];
l_returnflag R or A when the receipt date is on or before 1995-06-17,
else N; l_linestatus O when the ship date is after 1995-06-17, else F.
The other columns are well-formed but cheap. Scale factor 1 holds the
specification's 6,001,215 rows.

Run as a script:  python -m duckdb_tpu_torch.testing.tpch_gen SF OUT_DIR [SEED]
"""

from __future__ import annotations

import datetime
import json
import os
import sys

import numpy as np

SF1_LINEITEM_ROWS = 6_001_215
_EPOCH = datetime.date(1970, 1, 1)
START_DATE = (datetime.date(1992, 1, 1) - _EPOCH).days
LAST_ORDER_DATE = (datetime.date(1998, 8, 2) - _EPOCH).days
CURRENT_DATE = (datetime.date(1995, 6, 17) - _EPOCH).days

_INSTRUCT = ["COLLECT COD", "DELIVER IN PERSON", "NONE", "TAKE BACK RETURN"]
_MODES = ["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"]
_WORDS = ["furiously", "carefully", "quickly", "blithely", "slyly", "ironic",
          "regular", "final", "express", "pending", "bold", "special",
          "deposits", "requests", "accounts", "packages", "theodolites",
          "instructions", "foxes", "pinto", "beans", "sleep", "nag", "haggle",
          "wake", "cajole", "about", "above", "among", "along"]

# (name, kind) in schema order (catalog/tpch.py)
LINEITEM_COLUMNS = [
    ("l_orderkey", "i64"), ("l_partkey", "i64"), ("l_suppkey", "i64"),
    ("l_linenumber", "i32"), ("l_quantity", "i64"), ("l_extendedprice", "i64"),
    ("l_discount", "i64"), ("l_tax", "i64"), ("l_returnflag", "str"),
    ("l_linestatus", "str"), ("l_shipdate", "date"), ("l_commitdate", "date"),
    ("l_receiptdate", "date"), ("l_shipinstruct", "str"), ("l_shipmode", "str"),
    ("l_comment", "str"),
]


def retail_price_cents(partkey: np.ndarray) -> np.ndarray:
    """P_RETAILPRICE in cents (TPC-H §4.2.3)."""
    return 90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)


def generate_lineitem(sf: float, seed: int = 0) -> dict:
    """→ {column: numpy array}; a VARCHAR column is (sorted pool of
    strings, int codes into it)."""
    rng = np.random.default_rng(seed)
    n = max(1, int(round(SF1_LINEITEM_ROWS * sf)))
    # orders of 1..7 lines each, cut at n rows
    lines = rng.integers(1, 8, size=n // 2 + 8)
    ends = np.cumsum(lines)
    norders = int(np.searchsorted(ends, n)) + 1
    lines = lines[:norders].copy()
    lines[-1] -= int(ends[norders - 1]) - n
    order_idx = np.repeat(np.arange(norders), lines)
    first = np.concatenate([[0], np.cumsum(lines)[:-1]])
    linenumber = (np.arange(n) - first[order_idx] + 1).astype(np.int32)
    # sparse order keys, as dbgen's: 8 keys used out of every 32
    orderkey = (order_idx // 8) * 32 + order_idx % 8 + 1
    orderdate = rng.integers(START_DATE, LAST_ORDER_DATE + 1, size=norders)[order_idx]

    nparts = max(1, int(200_000 * sf))
    nsupp = max(1, int(10_000 * sf))
    partkey = rng.integers(1, nparts + 1, size=n)
    suppkey = (partkey + rng.integers(0, 4, size=n) * (nsupp // 4 + 1)) % nsupp + 1
    quantity = rng.integers(1, 51, size=n)
    shipdate = orderdate + rng.integers(1, 122, size=n)
    receiptdate = shipdate + rng.integers(1, 31, size=n)
    returned = rng.integers(0, 2, size=n).astype(bool)
    # flags as codes into sorted pools: A=0, N=1, R=2 and F=0, O=1
    returnflag = np.where(receiptdate <= CURRENT_DATE, np.where(returned, 2, 0), 1)
    linestatus = (shipdate > CURRENT_DATE).astype(np.int64)
    comments = sorted({" ".join(rng.choice(_WORDS, size=int(k)))
                       for k in rng.integers(2, 6, size=512)})
    return {
        "l_orderkey": orderkey.astype(np.int64),
        "l_partkey": partkey.astype(np.int64),
        "l_suppkey": suppkey.astype(np.int64),
        "l_linenumber": linenumber,
        "l_quantity": (quantity * 100).astype(np.int64),
        "l_extendedprice": (quantity * retail_price_cents(partkey)).astype(np.int64),
        "l_discount": rng.integers(0, 11, size=n).astype(np.int64),
        "l_tax": rng.integers(0, 9, size=n).astype(np.int64),
        "l_returnflag": (["A", "N", "R"], returnflag),
        "l_linestatus": (["F", "O"], linestatus),
        "l_shipdate": shipdate.astype(np.int32),
        "l_commitdate": (orderdate + rng.integers(30, 91, size=n)).astype(np.int32),
        "l_receiptdate": receiptdate.astype(np.int32),
        "l_shipinstruct": (_INSTRUCT, rng.integers(0, len(_INSTRUCT), size=n)),
        "l_shipmode": (_MODES, rng.integers(0, len(_MODES), size=n)),
        "l_comment": (comments, rng.integers(0, len(comments), size=n)),
    }


def _write_strings(path_base: str, pool, codes: np.ndarray):
    """Write the VARCHAR column pool[codes] as .len + .bytes."""
    enc = [s.encode("utf-8") for s in pool]
    plens = np.array([len(e) for e in enc], dtype=np.uint32)
    plens[codes].tofile(path_base + ".len")
    width = max(1, int(plens.max()))
    mat = np.zeros((len(enc), width), dtype=np.uint8)
    for i, e in enumerate(enc):
        mat[i, :len(e)] = np.frombuffer(e, dtype=np.uint8)
    keep = np.arange(width)[None, :] < plens[codes][:, None]
    mat[codes][keep].tofile(path_base + ".bytes")


def write_lineitem(out_dir: str, sf: float, seed: int = 0) -> str:
    """Generate lineitem at scale factor `sf` into out_dir/lineitem; → that dir."""
    cols = generate_lineitem(sf, seed)
    tdir = os.path.join(out_dir, "lineitem")
    os.makedirs(tdir, exist_ok=True)
    for name, kind in LINEITEM_COLUMNS:
        base = os.path.join(tdir, name)
        if kind == "str":
            _write_strings(base, *cols[name])
        elif kind == "i64":
            cols[name].astype(np.int64).tofile(base + ".i64")
        else:
            cols[name].astype(np.int32).tofile(base + ".i32")
    meta = {"rows": int(len(cols["l_orderkey"])),
            "columns": [{"name": n, "kind": k} for n, k in LINEITEM_COLUMNS]}
    with open(os.path.join(tdir, "meta.json"), "w") as f:
        json.dump(meta, f)
    return tdir


if __name__ == "__main__":
    write_lineitem(sys.argv[2], float(sys.argv[1]),
                   int(sys.argv[3]) if len(sys.argv) > 3 else 0)
