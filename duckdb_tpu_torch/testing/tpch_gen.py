"""Seeded numpy generator of the eight TPC-H tables.

Writes the dbgen_tbl directory format that storage/binary_dir.py reads
(and that the JAX package's reader reads too), so both packages can load
one generated directory:

    <out>/<table>/meta.json           {"rows": N, "columns": [{name, kind}]}
    <out>/<table>/<col>.i64 | .i32    raw little-endian values
    <out>/<table>/<col>.len + .bytes  u32 lengths + utf-8 payload (VARCHAR)

The columns the ported queries read follow the TPC-H specification §4.2.3:
l_quantity uniform in [1, 50]; l_extendedprice = quantity × the part's
retail price; l_discount in [0.00, 0.10]; l_tax in [0.00, 0.08];
l_shipdate = order date + [1, 121] days with order dates uniform in
[1992-01-01, 1998-08-02]; l_receiptdate = ship date + [1, 30];
l_returnflag R or A when the receipt date is on or before 1995-06-17,
else N; l_linestatus O when the ship date is after 1995-06-17, else F.
Each order has 1 to 7 lines; its key and date are the ones its lines
carry; o_custkey is never a multiple of 3; o_orderstatus is F or O when
all its lines are, else P; o_orderpriority and c_mktsegment are uniform
over their five values; p_brand is Brand#MN with M the manufacturer in
[1, 5] and N in [1, 5]; p_container is uniform over the 40 containers;
o_shippriority is 0; c_nationkey and s_nationkey
are uniform in [0, 24]; c_acctbal is uniform in [-999.99, 9999.99];
c_phone starts with the nation key + 10; nation and region hold the
specification's fixed 25 and 5 rows; partsupp holds, for each part, the
four suppliers lineitem's l_suppkey formula can pick. The text columns
that TPC-H's LIKE predicates read: p_name is five distinct words of the
92 colors; p_type one of the 150 syllable triples; s_comment holds
"Customer … Complaints" in 5 of every 10,000 suppliers and "Customer …
Recommends" in 5 others; o_comment is 19 to 78 characters of word text,
near-unique (about 1.5M distinct values at SF1). The other columns are
well-formed but cheap. Scale factor 1 holds the specification's 6,001,215
lineitem rows, 150,000 customers, 200,000 parts, 800,000 partsupp rows
and 10,000 suppliers.

lineitem (and its orders' keys and dates) comes from the seed's own
stream; every other table draws from a stream of its own, and p_name,
p_type, s_comment and o_comment each from one of their own, so lineitem
is the same for every (sf, seed) whichever tables are written, and the
other columns of part, supplier and orders kept their values when those
four came to follow the specification.

Run as a script:  python -m duckdb_tpu_torch.testing.tpch_gen SF OUT_DIR [SEED]
"""

from __future__ import annotations

import datetime
import itertools
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
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
# (n_name, n_regionkey) for n_nationkey 0..24 (specification §4.2.3)
NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4), ("JAPAN", 2),
    ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0), ("MOZAMBIQUE", 0),
    ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3), ("SAUDI ARABIA", 4),
    ("VIETNAM", 2), ("RUSSIA", 3), ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
# P_CONTAINER: one of 5 sizes × 8 kinds (specification §4.2.2.13)
_CONTAINERS = sorted(f"{size} {kind}" for size in ("SM", "LG", "MED", "JUMBO", "WRAP")
                     for kind in ("CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"))
# the pools the generator drew p_type and p_name from before they followed
# the specification; their draws stay in the part stream so that the later
# part columns keep their values
_OLD_TYPES = 6
_OLD_NAME_DRAWS = 2048
# P_TYPE: one of 6 × 5 × 5 syllable triples (specification §4.2.2.13)
TYPE_SYLLABLES = (("STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"),
                  ("ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"),
                  ("TIN", "NICKEL", "BRASS", "STEEL", "COPPER"))
# P_NAME: five distinct words of this list (specification §4.2.3)
COLORS = [
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
    "blanched", "blue", "blush", "brown", "burlywood", "burnished", "chartreuse",
    "chiffon", "chocolate", "coral", "cornflower", "cornsilk", "cream", "cyan",
    "dark", "deep", "dim", "dodger", "drab", "firebrick", "floral", "forest",
    "frosted", "gainsboro", "ghost", "goldenrod", "green", "grey", "honeydew",
    "hot", "indian", "ivory", "khaki", "lace", "lavender", "lawn", "lemon",
    "light", "lime", "linen", "magenta", "maroon", "medium", "metallic",
    "midnight", "mint", "misty", "moccasin", "navajo", "navy", "olive", "orange",
    "orchid", "pale", "papaya", "peach", "peru", "pink", "plum", "powder", "puff",
    "purple", "red", "rose", "rosy", "royal", "saddle", "salmon", "sandy",
    "seashell", "sienna", "sky", "slate", "smoke", "snow", "spring", "steel",
    "tan", "thistle", "tomato", "turquoise", "violet", "wheat", "white", "yellow",
]
# suppliers per 10,000 whose S_COMMENT holds "Customer ... Complaints", and
# as many with "Customer ... Recommends" (specification §4.2.3)
SUPPLIER_REMARKS_PER_10000 = 5

# (name, kind) in schema order (catalog/tpch.py)
LINEITEM_COLUMNS = [
    ("l_orderkey", "i64"), ("l_partkey", "i64"), ("l_suppkey", "i64"),
    ("l_linenumber", "i32"), ("l_quantity", "i64"), ("l_extendedprice", "i64"),
    ("l_discount", "i64"), ("l_tax", "i64"), ("l_returnflag", "str"),
    ("l_linestatus", "str"), ("l_shipdate", "date"), ("l_commitdate", "date"),
    ("l_receiptdate", "date"), ("l_shipinstruct", "str"), ("l_shipmode", "str"),
    ("l_comment", "str"),
]
TABLE_COLUMNS = {
    "region": [("r_regionkey", "i32"), ("r_name", "str"), ("r_comment", "str")],
    "nation": [("n_nationkey", "i32"), ("n_name", "str"), ("n_regionkey", "i32"),
               ("n_comment", "str")],
    "supplier": [("s_suppkey", "i64"), ("s_name", "str"), ("s_address", "str"),
                 ("s_nationkey", "i32"), ("s_phone", "str"), ("s_acctbal", "i64"),
                 ("s_comment", "str")],
    "customer": [("c_custkey", "i64"), ("c_name", "str"), ("c_address", "str"),
                 ("c_nationkey", "i32"), ("c_phone", "str"), ("c_acctbal", "i64"),
                 ("c_mktsegment", "str"), ("c_comment", "str")],
    "part": [("p_partkey", "i64"), ("p_name", "str"), ("p_mfgr", "str"),
             ("p_brand", "str"), ("p_type", "str"), ("p_size", "i32"),
             ("p_container", "str"), ("p_retailprice", "i64"), ("p_comment", "str")],
    "partsupp": [("ps_partkey", "i64"), ("ps_suppkey", "i64"), ("ps_availqty", "i32"),
                 ("ps_supplycost", "i64"), ("ps_comment", "str")],
    "orders": [("o_orderkey", "i64"), ("o_custkey", "i64"), ("o_orderstatus", "str"),
               ("o_totalprice", "i64"), ("o_orderdate", "date"),
               ("o_orderpriority", "str"), ("o_clerk", "str"),
               ("o_shippriority", "i32"), ("o_comment", "str")],
    "lineitem": LINEITEM_COLUMNS,
}
# each table's own stream, and one for each text column that follows the
# specification: default_rng([seed, _STREAM[name]])
_STREAM = {"orders": 1, "customer": 2, "supplier": 3, "part": 4, "partsupp": 5,
           "nation": 6, "region": 7, "p_name": 8, "p_type": 9, "s_comment": 10,
           "o_comment": 11}


def retail_price_cents(partkey: np.ndarray) -> np.ndarray:
    """P_RETAILPRICE in cents (TPC-H §4.2.3)."""
    return 90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)


def table_sizes(sf: float) -> dict:
    """Rows of the tables whose size scales (lineitem's is about 4 per order)."""
    return {"part": max(1, int(200_000 * sf)), "supplier": max(1, int(10_000 * sf)),
            "customer": max(1, int(150_000 * sf)),
            "lineitem": max(1, int(round(SF1_LINEITEM_ROWS * sf)))}


def _lineitem_and_orders(sf: float, seed: int):
    """→ (lineitem columns, the order each line belongs to, each order's
    date). Draws from the seed's stream only."""
    rng = np.random.default_rng(seed)
    sizes = table_sizes(sf)
    n = sizes["lineitem"]
    # orders of 1..7 lines each, cut at n rows
    lines = rng.integers(1, 8, size=n // 2 + 8)
    ends = np.cumsum(lines)
    norders = int(np.searchsorted(ends, n)) + 1
    lines = lines[:norders].copy()
    lines[-1] -= int(ends[norders - 1]) - n
    order_idx = np.repeat(np.arange(norders), lines)
    first = np.concatenate([[0], np.cumsum(lines)[:-1]])
    linenumber = (np.arange(n) - first[order_idx] + 1).astype(np.int32)
    orderkey = order_key(order_idx)
    order_dates = rng.integers(START_DATE, LAST_ORDER_DATE + 1, size=norders)
    orderdate = order_dates[order_idx]

    nparts, nsupp = sizes["part"], sizes["supplier"]
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
    cols = {
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
    return cols, order_idx, order_dates


def order_key(order_idx: np.ndarray) -> np.ndarray:
    """Sparse order keys, as dbgen's: 8 keys used out of every 32."""
    return (order_idx // 8) * 32 + order_idx % 8 + 1


def generate_lineitem(sf: float, seed: int = 0) -> dict:
    """→ {column: numpy array}; a VARCHAR column is (pool of strings, int
    codes into it)."""
    return _lineitem_and_orders(sf, seed)[0]


def _stream(seed: int, table: str) -> np.random.Generator:
    return np.random.default_rng([seed, _STREAM[table]])


def _digits(values: np.ndarray, width: int) -> np.ndarray:
    """Non-negative ints → (n, width) uint8 zero-padded decimal ASCII."""
    v = np.asarray(values, dtype=np.int64)[:, None]
    powers = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    return (ord("0") + (v // powers) % 10).astype(np.uint8)


def _text(*parts) -> tuple:
    """Concatenate fixed-width pieces (bytes constants or (n, w) uint8
    matrices) into one (matrix, lengths) VARCHAR value per row."""
    n = next(p.shape[0] for p in parts if isinstance(p, np.ndarray))
    mats = [np.broadcast_to(np.frombuffer(p, np.uint8), (n, len(p)))
            if isinstance(p, bytes) else p for p in parts]
    mat = np.concatenate(mats, axis=1)
    return mat, np.full(n, mat.shape[1], dtype=np.uint32)


def _random_text(rng, n: int, lo: int, hi: int) -> tuple:
    """n strings of [lo, hi] random letters, digits and spaces."""
    alphabet = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz0123456789 ,", np.uint8)
    mat = alphabet[rng.integers(0, len(alphabet), size=(n, hi))]
    lens = rng.integers(lo, hi + 1, size=n).astype(np.uint32)
    mat[:, 0] = alphabet[rng.integers(0, 26, size=n)]  # no leading blank
    return mat, lens


def _pool(rng, values, n: int) -> tuple:
    return (list(values), rng.integers(0, len(values), size=n))


def _join_words(words, idx: np.ndarray, width: int = 0, chunk: int = 1 << 16) -> tuple:
    """Row i = the words idx[i, 0], idx[i, 1], ... joined by single spaces,
    cut to `width` bytes when given → (uint8 matrix zero-padded past each
    row's length, lengths)."""
    enc = [w.encode("ascii") + b" " for w in words]
    wlen = np.array([len(e) for e in enc], dtype=np.int64)
    woff = np.cumsum(wlen) - wlen
    blob = np.frombuffer(b"".join(enc), np.uint8)
    row_len = wlen[idx].sum(axis=1) - 1  # no trailing space
    if width:
        row_len = np.minimum(row_len, width)
    width = max(1, int(row_len.max()))
    mat = np.zeros((len(idx), width), dtype=np.uint8)
    for lo in range(0, len(idx), chunk):
        part = idx[lo:lo + chunk]
        lens = wlen[part].ravel()
        # byte k of the chunk's stream comes from blob[start of its word + offset]
        starts = np.repeat(woff[part.ravel()] - (np.cumsum(lens) - lens), lens)
        stream = blob[starts + np.arange(len(starts))]
        rl = wlen[part].sum(axis=1)
        row_start = np.cumsum(rl) - rl
        col = np.arange(width)
        keep = col[None, :] < row_len[lo:lo + len(part), None]
        mat[lo:lo + len(part)] = np.where(
            keep, stream[np.minimum(row_start[:, None] + col[None, :], len(stream) - 1)], 0)
    return mat, row_len.astype(np.uint32)


def generate_orders(sf: float, seed: int, lineitem: dict, order_idx, order_dates) -> dict:
    rng = _stream(seed, "orders")
    norders = len(order_dates)
    ncust = table_sizes(sf)["customer"]
    first = np.flatnonzero(np.r_[True, order_idx[1:] != order_idx[:-1]])
    # o_custkey: uniform over the keys that are not multiples of 3
    pick = rng.integers(0, ncust - ncust // 3, size=norders)
    open_lines = np.add.reduceat(lineitem["l_linestatus"][1], first)
    nlines = np.diff(np.r_[first, len(order_idx)])
    status = np.where(open_lines == 0, 0, np.where(open_lines == nlines, 1, 2))
    ext, disc = lineitem["l_extendedprice"], lineitem["l_discount"]
    charge = ext * (100 - disc) * (100 + lineitem["l_tax"])
    nclerks = max(1, int(1000 * sf))
    clerks = [f"Clerk#{i:09d}" for i in range(1, nclerks + 1)]
    for k in rng.integers(3, 8, size=1024):  # the old comment pool's draws
        rng.choice(_WORDS, size=int(k))
    return {
        "o_orderkey": order_key(np.arange(norders)).astype(np.int64),
        "o_custkey": (pick + pick // 2 + 1).astype(np.int64),
        "o_orderstatus": (["F", "O", "P"], status),
        "o_totalprice": (np.add.reduceat(charge, first) // 10_000).astype(np.int64),
        "o_orderdate": order_dates.astype(np.int32),
        "o_orderpriority": _pool(rng, PRIORITIES, norders),
        "o_clerk": _pool(rng, clerks, norders),
        "o_shippriority": np.zeros(norders, dtype=np.int32),
        "o_comment": _order_comments(_stream(seed, "o_comment"), norders),
    }


def _order_comments(rng, n: int) -> tuple:
    """O_COMMENT: 19 to 78 characters of word text, cut at a random length
    as dbgen cuts its text pool: near-unique (about 1.5M distinct values at
    SF1), with "special" and "requests" among the words."""
    mat, lens = _join_words(_WORDS, rng.integers(0, len(_WORDS), size=(n, 14)), width=78)
    lens = np.minimum(lens, rng.integers(19, 79, size=n).astype(np.uint32))
    return mat, lens


def generate_customer(sf: float, seed: int) -> dict:
    rng = _stream(seed, "customer")
    n = table_sizes(sf)["customer"]
    key = np.arange(1, n + 1, dtype=np.int64)
    nation = rng.integers(0, 25, size=n)
    return {
        "c_custkey": key,
        "c_name": _text(b"Customer#", _digits(key, 9)),
        "c_address": _random_text(rng, n, 10, 40),
        "c_nationkey": nation.astype(np.int32),
        "c_phone": _phone(rng, nation),
        "c_acctbal": rng.integers(-99_999, 1_000_000, size=n).astype(np.int64),
        "c_mktsegment": _pool(rng, SEGMENTS, n),
        "c_comment": _random_text(rng, n, 29, 116),
    }


def _phone(rng, nation: np.ndarray) -> tuple:
    """'CC-LLL-LLL-LLLL' with country code CC = nation key + 10."""
    n = len(nation)
    return _text(_digits(nation + 10, 2), b"-", _digits(rng.integers(100, 1000, n), 3),
                 b"-", _digits(rng.integers(100, 1000, n), 3), b"-",
                 _digits(rng.integers(1000, 10000, n), 4))


def generate_supplier(sf: float, seed: int) -> dict:
    rng = _stream(seed, "supplier")
    n = table_sizes(sf)["supplier"]
    key = np.arange(1, n + 1, dtype=np.int64)
    nation = rng.integers(0, 25, size=n)
    return {
        "s_suppkey": key,
        "s_name": _text(b"Supplier#", _digits(key, 9)),
        "s_address": _random_text(rng, n, 10, 40),
        "s_nationkey": nation.astype(np.int32),
        "s_phone": _phone(rng, nation),
        "s_acctbal": rng.integers(-99_999, 1_000_000, size=n).astype(np.int64),
        "s_comment": _supplier_comments(_stream(seed, "s_comment"), n),
    }


def _supplier_comments(rng, n: int) -> tuple:
    """S_COMMENT: 25 to 100 random characters; in SUPPLIER_REMARKS_PER_10000
    of every 10,000 suppliers "Customer" and, after it, "Complaints" are
    written over the text, and in as many others "Customer" and
    "Recommends"."""
    mat, lens = _random_text(rng, n, 25, 100)
    k = n * SUPPLIER_REMARKS_PER_10000 // 10_000
    rows = rng.choice(n, size=2 * k, replace=False)
    for i, row in enumerate(rows):
        tail = b"Complaints" if i < k else b"Recommends"
        start = int(rng.integers(0, 41))  # "Customer" in [start, start + 8)
        at = int(rng.integers(start + 9, 91))  # the tail ends by byte 100
        mat[row, start:start + 8] = np.frombuffer(b"Customer", np.uint8)
        mat[row, at:at + 10] = np.frombuffer(tail, np.uint8)
        lens[row] = max(int(lens[row]), at + 10)
    return mat, lens


def generate_part(sf: float, seed: int) -> dict:
    rng = _stream(seed, "part")
    n = table_sizes(sf)["part"]
    key = np.arange(1, n + 1, dtype=np.int64)
    mfgr = rng.integers(1, 6, size=n)
    brand = mfgr * 10 + rng.integers(1, 6, size=n)
    # the old p_name pool, p_name and p_type draws
    old_names = {" ".join(rng.choice(_WORDS, size=5)) for _ in range(_OLD_NAME_DRAWS)}
    rng.integers(0, len(old_names), size=n)
    rng.integers(0, _OLD_TYPES, size=n)
    name_rng = _stream(seed, "p_name")
    # five distinct colors: the first five of a random order of the 92
    colors = np.argsort(name_rng.random((n, len(COLORS))), axis=1)[:, :5]
    syl = _stream(seed, "p_type").integers(0, [6, 5, 5], size=(n, 3))
    types = [" ".join(t) for t in itertools.product(*TYPE_SYLLABLES)]
    return {
        "p_partkey": key,
        "p_name": _join_words(COLORS, colors),
        "p_mfgr": _text(b"Manufacturer#", _digits(mfgr, 1)),
        "p_brand": _text(b"Brand#", _digits(brand, 2)),
        "p_type": (types, (syl[:, 0] * 5 + syl[:, 1]) * 5 + syl[:, 2]),
        "p_size": rng.integers(1, 51, size=n).astype(np.int32),
        "p_container": _pool(rng, _CONTAINERS, n),
        "p_retailprice": retail_price_cents(key).astype(np.int64),
        "p_comment": _random_text(rng, n, 5, 22),
    }


def generate_partsupp(sf: float, seed: int) -> dict:
    """For each part, the (up to) four suppliers lineitem's l_suppkey can
    pick for it, so every (l_partkey, l_suppkey) has a partsupp row."""
    rng = _stream(seed, "partsupp")
    sizes = table_sizes(sf)
    nparts, nsupp = sizes["part"], sizes["supplier"]
    part = np.repeat(np.arange(1, nparts + 1, dtype=np.int64), 4)
    supp = (part + np.tile(np.arange(4), nparts) * (nsupp // 4 + 1)) % nsupp + 1
    pairs = np.unique(part * (nsupp + 1) + supp)  # fewer than 4 suppliers: dedupe
    part, supp = pairs // (nsupp + 1), pairs % (nsupp + 1)
    n = len(pairs)
    return {
        "ps_partkey": part,
        "ps_suppkey": supp,
        "ps_availqty": rng.integers(1, 10_000, size=n).astype(np.int32),
        "ps_supplycost": rng.integers(100, 100_001, size=n).astype(np.int64),
        "ps_comment": _random_text(rng, n, 49, 198),
    }


def generate_nation(seed: int) -> dict:
    rng = _stream(seed, "nation")
    return {
        "n_nationkey": np.arange(25, dtype=np.int32),
        "n_name": ([name for name, _ in NATIONS], np.arange(25)),
        "n_regionkey": np.array([r for _, r in NATIONS], dtype=np.int32),
        "n_comment": _random_text(rng, 25, 31, 114),
    }


def generate_region(seed: int) -> dict:
    rng = _stream(seed, "region")
    return {
        "r_regionkey": np.arange(5, dtype=np.int32),
        "r_name": (list(REGIONS), np.arange(5)),
        "r_comment": _random_text(rng, 5, 31, 115),
    }


def generate_tables(sf: float, seed: int = 0) -> dict:
    """→ {table: {column: values}} for all eight tables; a VARCHAR column is
    (pool of strings, int codes into it) or (uint8 matrix of the values'
    bytes, their lengths)."""
    lineitem, order_idx, order_dates = _lineitem_and_orders(sf, seed)
    return {
        "lineitem": lineitem,
        "orders": generate_orders(sf, seed, lineitem, order_idx, order_dates),
        "customer": generate_customer(sf, seed),
        "supplier": generate_supplier(sf, seed),
        "part": generate_part(sf, seed),
        "partsupp": generate_partsupp(sf, seed),
        "nation": generate_nation(seed),
        "region": generate_region(seed),
    }


def _write_string_matrix(path_base: str, mat: np.ndarray, lens: np.ndarray):
    """Write row i's first lens[i] bytes of mat as .len + .bytes."""
    lens = np.asarray(lens, dtype=np.uint32)
    lens.tofile(path_base + ".len")
    keep = np.arange(mat.shape[1])[None, :] < lens[:, None]
    mat[keep].tofile(path_base + ".bytes")


def _write_strings(path_base: str, pool, codes: np.ndarray):
    """Write the VARCHAR column pool[codes] as .len + .bytes."""
    enc = [s.encode("utf-8") for s in pool]
    plens = np.array([len(e) for e in enc], dtype=np.uint32)
    width = max(1, int(plens.max()))
    mat = np.zeros((len(enc), width), dtype=np.uint8)
    for i, e in enumerate(enc):
        mat[i, :len(e)] = np.frombuffer(e, dtype=np.uint8)
    _write_string_matrix(path_base, mat[codes], plens[codes])


def _write_table(out_dir: str, table: str, cols: dict) -> str:
    tdir = os.path.join(out_dir, table)
    os.makedirs(tdir, exist_ok=True)
    for name, kind in TABLE_COLUMNS[table]:
        base = os.path.join(tdir, name)
        if kind == "str":
            values, codes_or_lens = cols[name]
            if isinstance(values, np.ndarray):
                _write_string_matrix(base, values, codes_or_lens)
            else:
                _write_strings(base, values, codes_or_lens)
        elif kind == "i64":
            cols[name].astype(np.int64).tofile(base + ".i64")
        else:
            cols[name].astype(np.int32).tofile(base + ".i32")
    first = cols[TABLE_COLUMNS[table][0][0]]
    meta = {"rows": int(len(first)),
            "columns": [{"name": n, "kind": k} for n, k in TABLE_COLUMNS[table]]}
    with open(os.path.join(tdir, "meta.json"), "w") as f:
        json.dump(meta, f)
    return tdir


def write_lineitem(out_dir: str, sf: float, seed: int = 0) -> str:
    """Generate lineitem at scale factor `sf` into out_dir/lineitem; → that dir."""
    return _write_table(out_dir, "lineitem", generate_lineitem(sf, seed))


def write_tables(out_dir: str, sf: float, seed: int = 0) -> str:
    """Generate all eight tables at scale factor `sf` into out_dir/<table>."""
    for table, cols in generate_tables(sf, seed).items():
        _write_table(out_dir, table, cols)
    return out_dir


if __name__ == "__main__":
    write_tables(sys.argv[2], float(sys.argv[1]),
                 int(sys.argv[3]) if len(sys.argv) > 3 else 0)
