"""The port's column compression (duckdb_tpu_torch/storage/compression.py)
against the JAX package's (duckdb_tpu/storage/compression.py).

Every scheme on seeded numpy arrays (constants, runs, FOR-bitpacking at
every width, negatives, int64 extremes, NaN, -0.0, inf, dictionaries,
validity) gives the JAX package's meta and payload bytes where zstd is
installed, and decodes back exactly; the zlib codec (used where zstandard
does not import) round-trips and names itself in the meta; a column whose
codec is unknown or not installed raises naming it. A checkpoint through
the compressed format shrinks a lineitem-like table and reopens equal,
in both packages.
"""

import os
import sys

import numpy as np
import pytest
import torch

from duckdb_tpu.storage import compression as J
from duckdb_tpu_torch.storage import compression as T

sys.path.insert(0, os.path.dirname(__file__))
from _torch_parity import run_both_files  # noqa: E402

torch.set_num_threads(1)

RNG = np.random.default_rng(16)
INT_CASES = {
    "constant": np.full(10000, 42, dtype=np.int64),
    "empty": np.zeros(0, dtype=np.int64),
    "one": np.array([-7], dtype=np.int64),
    "for_narrow": RNG.integers(1_000_000, 1_000_400, 50001).astype(np.int64),
    "negatives": RNG.integers(-5000, 5000, 4099).astype(np.int64),
    "int64_extremes": np.array([-(2**63), 2**63 - 1, 0, -1, 1], dtype=np.int64),
    "full_range": RNG.integers(-(2**63), 2**63 - 1, 777, dtype=np.int64),
    "runs": np.repeat(np.arange(50, dtype=np.int64) * 7, 1000),
    "runs_negative": np.repeat(RNG.integers(-(2**40), 2**40, 300), 20).astype(np.int64),
    "sorted_keys": np.sort(RNG.integers(0, 6_000_000, 100_003)).astype(np.int64),
}


@pytest.mark.parametrize("name", sorted(INT_CASES))
def test_ints_match_reference(name):
    a = INT_CASES[name]
    jm, jb = J.compress_ints(a)
    tm, tb = T.compress_ints(a)
    assert tm == jm and tb == jb
    np.testing.assert_array_equal(T.decompress_ints(tm, tb), a)
    np.testing.assert_array_equal(T.decompress_ints(jm, jb), J.decompress_ints(jm, jb))


def test_scheme_choice():
    m, b = T.compress_ints(INT_CASES["constant"])
    assert m["s"] == "const" and b == b""
    m, b = T.compress_ints(INT_CASES["for_narrow"])
    assert m["s"] == "for" and m["w"] <= 9 and len(b) < INT_CASES["for_narrow"].nbytes / 7
    m, b = T.compress_ints(INT_CASES["runs"])
    assert m["s"] == "rle" and len(b) < 2000


@pytest.mark.parametrize("width", [1, 3, 7, 8, 13, 31, 32, 33, 57, 63, 64])
def test_bitpacking_every_length(width):
    """The 64-value-block packer gives the JAX package's bitstream at every
    length around a block, and unpacks it."""
    hi = (1 << width) - 1
    a = RNG.integers(0, 2**63, 200, dtype=np.uint64)
    a = (a * np.uint64(2) + np.uint64(1)) if width == 64 else (a & np.uint64(hi))
    for n in (1, 7, 8, 63, 64, 65, 127, 128, 200):
        packed = T._pack_uint(a[:n], width)
        assert packed == J._pack_uint(a[:n], width)
        np.testing.assert_array_equal(T._unpack_uint(packed, n, width), a[:n])
        np.testing.assert_array_equal(T._unpack_uint(packed, n, width),
                                      J._unpack_uint(packed, n, width))


def _floats():
    a = RNG.standard_normal(30000)
    a[::7] = np.inf
    a[1::17] = -np.inf
    a[3::11] = -0.0
    a[5::13] = np.nan
    return a


@pytest.mark.parametrize("a", [_floats(), np.zeros(0), np.array([1.5])],
                         ids=["special_values", "empty", "one"])
def test_floats_match_reference_bit_exact(a):
    jm, jb = J.compress_floats(a)
    tm, tb = T.compress_floats(a)
    assert tm == jm and tb == jb
    got = T.decompress_floats(tm, tb)
    np.testing.assert_array_equal(got.view(np.uint64), a.view(np.uint64))


@pytest.mark.parametrize("case", ["small", "empty_string", "large"])
def test_strings_match_reference(case):
    if case == "large":
        dvals = np.array(sorted({f"w{int(x):07d}" for x in RNG.integers(0, 10**6, 5000)}),
                         dtype=object)
        codes = RNG.integers(0, len(dvals), 20000).astype(np.int32)
    else:
        dvals = np.array(["aa", "bb", "ccc", "ñ-utf8", ""] if case == "small" else [""],
                         dtype=object)
        codes = (np.array([0, 1, 2, 2, 3, 4, 0], dtype=np.int32) if case == "small"
                 else np.zeros(3, dtype=np.int32))
    jm, jb = J.compress_strings(codes, dvals)
    tm, tb = T.compress_strings(codes, dvals)
    assert tm == jm and tb == jb
    c2, d2 = T.decompress_strings(tm, tb)
    np.testing.assert_array_equal(c2, codes)
    assert list(d2) == list(dvals)


def test_validity_matches_reference():
    v = RNG.random(999) < 0.5
    assert T.compress_validity(v) == J.compress_validity(v)
    assert np.array_equal(T.decompress_validity(T.compress_validity(v), 999), v)


def test_zlib_round_trip(monkeypatch):
    """Where zstandard does not import the port writes zlib and says so."""
    monkeypatch.setattr(T, "CODEC", "zlib")
    a = _floats()
    m, b = T.compress_floats(a)
    assert m["codec"] == "zlib"
    np.testing.assert_array_equal(T.decompress_floats(m, b).view(np.uint64), a.view(np.uint64))
    dvals = np.array(["x", "yy", "zzz"], dtype=object)
    m, b = T.compress_strings(np.array([2, 0, 1], np.int32), dvals)
    assert m["codec"] == "zlib"
    codes, d2 = T.decode_column(m, b)
    assert list(d2) == list(dvals) and codes.tolist() == [2, 0, 1]


def test_unknown_or_missing_codec_raises(monkeypatch):
    m, b = T.compress_floats(np.arange(4.0))
    with pytest.raises(ValueError, match="unknown codec 'lz9'"):
        T.decompress_floats(dict(m, codec="lz9"), b)
    monkeypatch.setattr(T, "_zstd", None)
    with pytest.raises(RuntimeError, match="zstd"):
        T.decompress_floats(m, b)  # no codec named: zstd, not installed


def test_checkpoint_compression_e2e(tmp_path):
    """A lineitem-like table shrinks below a third of its raw planes and
    reopens with the same sums, in both packages."""
    rows = []

    def scenario(side):
        con = side.connect("db")
        con.sql("CREATE TABLE t AS SELECT range AS id, range % 5 AS flag, range * 0.25 AS x, "
                "CASE WHEN range % 3 = 0 THEN 'alpha' WHEN range % 3 = 1 THEN 'beta' "
                "ELSE NULL END AS s FROM range(50000)")
        q = "SELECT sum(id), sum(flag), sum(x), count(s) FROM t"
        out = [(q, side.sql(con, q))]
        con.sql("CHECKPOINT")
        data = [d for d in os.listdir(side.path("db")) if d.startswith("data")]
        tdir = os.path.join(side.path("db"), data[0], "t")
        disk = sum(os.path.getsize(os.path.join(tdir, f)) for f in os.listdir(tdir))
        rows.append(disk)
        side.crash()
        con2 = side.connect("db")
        for q in (q, "SELECT s FROM t WHERE id = 3", "SELECT s FROM t WHERE id = 2"):
            out.append((q, side.sql(con2, q)))
        return out

    j, t = run_both_files(tmp_path, scenario)
    assert t[0][1] == t[1][1] and t[2][1] == ("rows", [("alpha",)])
    raw = 50000 * (8 + 8 + 8 + 4)
    assert all(d < raw / 3 for d in rows), (rows, raw)
