"""Scalar functions, batch 3: math, string codecs and hashes, the LIKE-escape
family, graphemes, similarity metrics, regexp additions, readable byte
sizes, date/time constructors and parts, interval builders, and system
introspection.

The JAX package's duckdb_tpu/planner/functions_more.py (DuckDB's
core_functions scalar families) in torch, in the dictionary model: a
VARCHAR or BLOB function runs in Python once per distinct dictionary value
and reaches the rows as one gather of codes on the column's device
(functions.dict_transform / dict_predicate / dict_int, whose lookup tables
are cached per dictionary and function, so warm runs of a plan read them).
Numeric and temporal functions are torch ops over the whole column on its
device; a number formatted as text (to_base, bin, formatReadableSize) is
formatted once per distinct value (bound.format_distinct). No step is
Python per row.

current_database(), current_schema(), current_query(), txid_current()
and setseed() read and change the running connection's Session
(planner/session.py), not a module global: current_query() gives the text
of the statement running, a plan-cache hit too. current_setting(name)
reads the database's setting when the statement runs, as duckdb_settings()
shows it (the JAX package gives '' whatever was SET: ROADMAP S1).

Where DuckDB and the JAX package differ, the port follows DuckDB (ROADMAP
Queue 3, (h), (i), (m), (n)): epoch_ms(BIGINT) is the TIMESTAMP that many
milliseconds after the epoch (the reference gives an integer), and
epoch_us/epoch_ns take no integer; epoch_ms of a time before 1970
truncates toward zero as Timestamp::GetEpochMs does (the reference
floors); to_base of a negative number raises (the reference prints a
minus sign); millennium of a year before 1 counts as date_part.cpp does.
timezone(), timezone_hour() and timezone_minute() follow the session's
time zone, UTC (the port's TIMESTAMPTZ): timezone('UTC', ts) converts between
TIMESTAMP and TIMESTAMPTZ as DuckDB's ICU extension does, one argument is
the offset in seconds (0), and another zone is not ported.
"""

from __future__ import annotations

import base64 as _b64
import datetime
import hashlib
import math
import os
import re
import unicodedata
import urllib.parse

import numpy as np
import torch

from duckdb_tpu_torch.errors import ValueCatalogError, ValueInputError
from duckdb_tpu_torch.blocks import Column
from duckdb_tpu_torch.blocks.nested import obj_array
from duckdb_tpu_torch.ops import strings as dstr
from duckdb_tpu_torch.planner import session
from duckdb_tpu_torch.planner.bound import (
    BindError,
    _and_validity,
    _to_double,
    bcast,
    civil_from_days,
    format_distinct,
    format_varchar,
    not_ported,
)
from duckdb_tpu_torch.planner.functions import (
    REGISTRY,
    _dict_lut,
    _null_column,
    dict_int,
    dict_predicate,
    dict_transform,
    per_value,
    raise_if_read,
    register,
)
from duckdb_tpu_torch.planner.functions_ext import (
    _const_varchar,
    _full,
    _valid_of,
    civil_to_days,
)
from duckdb_tpu_torch.planner.functions_nested import _const_py
from duckdb_tpu_torch.types import (
    BIGINT,
    BLOB,
    BOOLEAN,
    DOUBLE,
    HUGEINT,
    INTERVAL,
    SQLNULL,
    TIME,
    TIMESTAMP,
    TIMESTAMPTZ,
    VARCHAR,
    LogicalType,
    TypeId,
    implicit_cast_cost,
    list_of,
)

_US_DAY = 86_400_000_000
VERSION = "v1.4.4-tpu"


# -- helpers -----------------------------------------------------------------
def dict_double(col: Column, fn, key: str, env=None) -> Column:
    return _dict_lut(col, fn, None, key, DOUBLE, np.float64, env)


def _dict_str(name, pyfn, ret=VARCHAR, aliases=()):
    """A unary VARCHAR (or BLOB) function computed once per distinct value."""
    def binder(arg_exprs):

        def impl(env, cols, node):
            c = cols[0]
            if ret.id is TypeId.VARCHAR:
                return dict_transform(c, pyfn, device_key=name, env=env)
            if ret.id is TypeId.BOOLEAN:
                return dict_predicate(c, pyfn, device_key=name, env=env)
            if ret.id is TypeId.DOUBLE:
                return dict_double(c, pyfn, name, env)
            return dict_int(c, pyfn, device_key=name, env=env)
        return ret, impl, arg_exprs

    for n in (name, *aliases):
        register(n, 1)(binder)
    return binder


def _const_arg(e):
    """A constant argument's value, a non-VARCHAR one as its text (the
    reference casts it, as in instr(s, -2))."""
    v = e.const_value()
    if v is not None and e.ltype.id is not TypeId.VARCHAR:
        v = format_varchar(v, e.ltype)
    return v


def _dict_str2(name, pyfn, ret=VARCHAR):
    """A binary string function whose second argument is a constant (a
    pair of columns would be work per row: DuckDB answers it, this port and
    the reference refuse it)."""
    def binder(arg_exprs):
        other = _const_arg(arg_exprs[1])
        key = f"{name}:{other!r}"

        def impl(env, cols, node):
            c = cols[0]
            if other is None:
                return _null_column(c, ret, np.array([""], dtype=object)
                                    if ret.id is TypeId.VARCHAR else None)
            fn = lambda s: pyfn(s, other)  # noqa: E731
            if ret.id is TypeId.VARCHAR:
                return dict_transform(c, fn, device_key=key, env=env)
            if ret.id is TypeId.DOUBLE:
                return dict_double(c, fn, key, env)
            return dict_int(c, fn, device_key=key, env=env)
        return ret, impl, arg_exprs[:1]

    register(name, 2)(binder)
    return binder


def _live_values(c: Column, env) -> Column:
    """c with the rows no live, valid row holds set to 0, so that a format
    that raises on a value sees only the values the statement reads."""
    keep = env.live
    if c.validity is not None:
        keep = keep & bcast(c.validity, env.plen)
    data = torch.where(keep, bcast(c.data, env.plen), torch.zeros((), dtype=c.data.dtype,
                                                                  device=c.data.device))
    return Column(data=data, ltype=c.ltype, validity=c.validity)


def _dict_blob(col: Column, fn, key: str, env) -> Column:
    """A function to BLOB once per distinct value: a sorted dictionary of
    the results, the codes remapped by one gather (cached per dictionary);
    failures as in functions.dict_transform."""
    if col.dict_values is None:
        return _null_column(col, BLOB, np.array([b""], dtype=object))
    dev = col.data.device

    def compute():
        vals, errs = per_value(fn, col.dict_values, b"")
        uniq, inv = np.unique(np.array(vals or [b""], dtype=object), return_inverse=True)
        return (torch.from_numpy(inv.reshape(-1).astype(np.int32)).to(dev),
                uniq.astype(object), errs)

    remap, uniq, errs = dstr.cached_lut(col.dict_values, ("blob", key, str(dev)), compute)
    raise_if_read(col, errs, env)
    return Column(data=remap[col.data.long().clamp(0, len(remap) - 1)], ltype=BLOB,
                  validity=col.validity, dict_values=uniq)


def _dict_list(col: Column, fn, key: str, lt: LogicalType) -> Column:
    """A function to a LIST once per distinct value, its codes into the
    lists' own dictionary (cached per dictionary)."""
    if col.dict_values is None:
        return _null_column(col, lt, obj_array([()]))
    dev = col.data.device

    def compute():
        from duckdb_tpu_torch.blocks.nested import encode_objects

        inv, dvals = encode_objects([fn(s) for s in col.dict_values])
        lut = torch.from_numpy(inv if len(inv) else np.zeros(1, np.int32)).to(dev)
        return lut, dvals

    lut, dvals = dstr.cached_lut(col.dict_values, ("list", key, str(dev)), compute)
    return Column(data=lut[col.data.long().clamp(0, len(lut) - 1)], ltype=lt,
                  validity=col.validity, dict_values=dvals)


# -- math --------------------------------------------------------------------
def _double_fn(name, fn, ret=DOUBLE):
    def binder(arg_exprs):

        def impl(env, cols, node):
            return Column(data=fn(_to_double(cols[0])), ltype=ret, validity=cols[0].validity)
        return ret, impl, arg_exprs

    register(name, 1)(binder)


_double_fn("acosh", torch.acosh)
_double_fn("asinh", torch.asinh)
_double_fn("atanh", torch.atanh)
_double_fn("cot", lambda x: 1.0 / torch.tan(x))
_double_fn("signbit", torch.signbit, BOOLEAN)


@register("binom", 2)
def _bind_binom(arg_exprs):
    """binom(n, k): exp of lgamma differences, rounded; 0 outside 0 ≤ k ≤ n."""

    def impl(env, cols, node):
        n, k = _to_double(cols[0]), _to_double(cols[1])
        v = torch.exp(torch.lgamma(n + 1) - torch.lgamma(k + 1) - torch.lgamma(n - k + 1))
        d = torch.where((k >= 0) & (k <= n), torch.round(v), 0.0).to(torch.int64)
        return Column(data=d, ltype=BIGINT, validity=_valid_of(cols))
    return BIGINT, impl, arg_exprs


_DIGITS = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"


@register("to_base", (2, 3))
def _bind_to_base(arg_exprs):
    """to_base(n, radix[, min_length]) as DuckDB's to_base.cpp: a negative n
    raises (fault (m): the reference prints a minus sign)."""
    consts = [a.const_value() for a in arg_exprs[1:]]
    if any(v is None for v in consts):  # a NULL radix or length: NULL
        def null(env, cols, node):
            return _null_column(cols[0], VARCHAR, np.array([""], dtype=object))
        return VARCHAR, null, arg_exprs[:1]
    radix = int(consts[0])
    min_len = int(consts[1]) if len(consts) > 1 else 0
    if not 2 <= radix <= 36:
        raise BindError("Invalid Input Error: 'to_base' radix must be between 2 and 36")

    def conv(v):
        v = int(v)
        if v < 0:
            raise ValueError("Invalid Input Error: 'to_base' number must be greater than or "
                             "equal to 0")
        out = []
        while True:
            out.append(_DIGITS[v % radix])
            v //= radix
            if not v:
                break
        return "".join(reversed(out)).rjust(min_len, "0")

    def impl(env, cols, node):
        return format_distinct(_live_values(cols[0], env), env, conv, null_text="")
    return VARCHAR, impl, arg_exprs[:1]


# -- string length and codecs ---------------------------------------------------
REGISTRY["char_length"] = REGISTRY["character_length"] = REGISTRY["length"]


def _as_bytes(s):
    return s.encode() if isinstance(s, str) else bytes(s)


def _length_with_bit(name, byte_fn, bit_fn):
    """A BIT argument counts its bits (DuckDB's bit.cpp), any other its bytes."""
    def binder(arg_exprs):
        fn = bit_fn if arg_exprs[0].ltype.id is TypeId.BIT else byte_fn
        key = f"{name}:{arg_exprs[0].ltype.id is TypeId.BIT}"

        def impl(env, cols, node):
            return dict_int(cols[0], fn, device_key=key)
        return BIGINT, impl, arg_exprs

    register(name, 1)(binder)


_length_with_bit("bit_length", lambda s: len(_as_bytes(s)) * 8, lambda b: len(str(b)))
_length_with_bit("octet_length", lambda s: len(_as_bytes(s)), lambda b: (len(str(b)) + 7) // 8)
_dict_str("to_base64", lambda s: _b64.b64encode(_as_bytes(s)).decode(), aliases=("base64",))
_dict_str("from_base64", lambda s: _b64.b64decode(s).decode("utf-8", "surrogateescape"))
_dict_str("sha1", lambda s: hashlib.sha1(_as_bytes(s)).hexdigest())
_dict_str("sha256", lambda s: hashlib.sha256(_as_bytes(s)).hexdigest())
_dict_str("nfc_normalize", lambda s: unicodedata.normalize("NFC", s))
_dict_str("strip_accents", lambda s: "".join(ch for ch in unicodedata.normalize("NFD", s)
                                             if not unicodedata.combining(ch)))
_dict_str("url_encode", lambda s: urllib.parse.quote(s, safe=""))
_dict_str("url_decode", lambda s: urllib.parse.unquote(s))
_dict_str("regexp_escape", re.escape)


def _slashed(s: str) -> str:
    return s.replace("\\", "/")


def _parse_dirpath(s: str) -> str:
    p = _slashed(s).rstrip("/")
    return p.rsplit("/", 1)[0] if "/" in p else ""


_dict_str("parse_filename", lambda s: _slashed(s).rstrip("/").rsplit("/", 1)[-1])
_dict_str("parse_dirname", lambda s: next((p for p in _slashed(s).split("/") if p), ""))
_dict_str("parse_dirpath", _parse_dirpath)


@register("md5_number", 1)
def _bind_md5_number(arg_exprs):
    """The MD5 digest as a 128-bit integer, its 16 bytes read little-endian
    (DuckDB's md5.cpp stores the digest as a uhugeint_t), in the port's
    HUGEINT planes: data the low 64 bits, data_hi the high 64, both int64,
    as in the reference."""

    def compute(dvals, dev):
        n = max(len(dvals), 1)
        lo = np.zeros(n, dtype=np.uint64)
        hi = np.zeros(n, dtype=np.uint64)
        for i, s in enumerate(dvals):
            v = int.from_bytes(hashlib.md5(_as_bytes(s)).digest(), "little")
            lo[i], hi[i] = v & ((1 << 64) - 1), v >> 64
        return (torch.from_numpy(lo.view(np.int64)).to(dev),
                torch.from_numpy(hi.view(np.int64)).to(dev))

    def impl(env, cols, node):
        c = cols[0]
        if c.dict_values is None:
            return _null_column(c, HUGEINT)
        dev = c.data.device
        lo, hi = dstr.cached_lut(c.dict_values, ("md5_number", str(dev)),
                                 lambda: compute(c.dict_values, dev))
        idx = c.data.long().clamp(0, len(lo) - 1)
        return Column(data=lo[idx], ltype=HUGEINT, validity=c.validity, data_hi=hi[idx])
    return HUGEINT, impl, arg_exprs


def _bin_of_int(v):
    # DuckDB prints the 64-bit two's-complement pattern of a negative number
    v = int(v)
    return bin(v)[2:] if v >= 0 else bin((1 << 64) + v)[2:]


@register("bin", 1)
@register("to_binary", 1)
def _bind_bin(arg_exprs):
    if arg_exprs[0].ltype.id is TypeId.VARCHAR:
        def impl(env, cols, node):
            return dict_transform(cols[0], lambda s: "".join(format(b, "08b")
                                                             for b in s.encode()),
                                  device_key="bin")
        return VARCHAR, impl, arg_exprs

    def impl(env, cols, node):
        return format_distinct(cols[0], env, _bin_of_int)
    return VARCHAR, impl, arg_exprs


def _blob_fn(name, pyfn, aliases=()):
    """VARCHAR → BLOB once per distinct value."""
    def binder(arg_exprs):

        def impl(env, cols, node):
            return _dict_blob(cols[0], lambda s: pyfn(str(s)), name, env)
        return BLOB, impl, arg_exprs

    for n in (name, *aliases):
        register(n, 1)(binder)


def _unbin_bytes(s):
    pad = (8 - len(s) % 8) % 8
    return int(s, 2).to_bytes((len(s) + pad) // 8 or 1, "big") if s else b""


_blob_fn("unbin", _unbin_bytes, aliases=("from_binary",))
_blob_fn("unhex", bytes.fromhex, aliases=("from_hex",))
_blob_fn("encode", str.encode)
_dict_str("decode", lambda s: s if isinstance(s, str) else bytes(s).decode())


# -- the LIKE-escape family -------------------------------------------------------
def _like_to_re(pattern: str, escape: str):
    out = []
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if escape and ch == escape and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        out.append(".*" if ch == "%" else "." if ch == "_" else re.escape(ch))
        i += 1
    return re.compile("^" + "".join(out) + "$", re.DOTALL)


def _like_escape(name, negate, fold):
    def binder(arg_exprs):
        pat = str(arg_exprs[1].const_value())
        esc = str(arg_exprs[2].const_value()) if len(arg_exprs) > 2 else ""
        rx = _like_to_re(pat.lower() if fold else pat, esc)

        def impl(env, cols, node):
            return dict_predicate(cols[0], lambda s: bool(rx.match(s.lower() if fold else s))
                                  != negate, device_key=f"{name}:{pat!r}:{esc!r}")
        return BOOLEAN, impl, arg_exprs[:1]

    register(name, (2, 3))(binder)


_like_escape("like_escape", False, False)
_like_escape("not_like_escape", True, False)
_like_escape("ilike_escape", False, True)
_like_escape("not_ilike_escape", True, True)


# -- graphemes --------------------------------------------------------------------
def _graphemes(s: str):
    """Grapheme clusters as a base character and its combining marks (the
    reference's approximation of UAX #29)."""
    out = []
    for ch in s:
        if out and unicodedata.combining(ch):
            out[-1] += ch
        else:
            out.append(ch)
    return out


_dict_str("length_grapheme", lambda s: len(_graphemes(s)), ret=BIGINT)
_dict_str2("left_grapheme", lambda s, n: "".join(_graphemes(s)[:int(n)]))
_dict_str2("right_grapheme", lambda s, n: "".join(_graphemes(s)[-int(n):]) if int(n) else "")


@register("substring_grapheme", (2, 3))
def _bind_substring_grapheme(arg_exprs):
    s0 = int(arg_exprs[1].const_value()) - 1
    length = int(arg_exprs[2].const_value()) if len(arg_exprs) > 2 else None

    def f(s):
        g = _graphemes(s)
        return "".join(g[s0:] if length is None else g[s0:s0 + length])

    def impl(env, cols, node):
        return dict_transform(cols[0], f, device_key=f"substring_grapheme:{s0}:{length}")
    return VARCHAR, impl, arg_exprs[:1]


# -- similarity metrics ---------------------------------------------------------
def damerau(a: str, b: str) -> int:
    """Optimal string alignment distance (DuckDB's damerau_levenshtein.cpp)."""
    la, lb = len(a), len(b)
    d = [[0] * (lb + 1) for _ in range(la + 1)]
    for i in range(la + 1):
        d[i][0] = i
    for j in range(lb + 1):
        d[0][j] = j
    for i in range(1, la + 1):
        for j in range(1, lb + 1):
            cost = 0 if a[i - 1] == b[j - 1] else 1
            d[i][j] = min(d[i - 1][j] + 1, d[i][j - 1] + 1, d[i - 1][j - 1] + cost)
            if i > 1 and j > 1 and a[i - 1] == b[j - 2] and a[i - 2] == b[j - 1]:
                d[i][j] = min(d[i][j], d[i - 2][j - 2] + 1)
    return d[la][lb]


def jaccard(a: str, b: str) -> float:
    sa, sb = set(a), set(b)
    if not sa and not sb:
        return 1.0
    return len(sa & sb) / len(sa | sb)


def _jaro(a: str, b: str) -> float:
    la, lb = len(a), len(b)
    if la == 0 and lb == 0:
        return 1.0
    if la == 0 or lb == 0:
        return 0.0
    match_dist = max(la, lb) // 2 - 1
    a_matched = [False] * la
    b_matched = [False] * lb
    matches = 0
    for i in range(la):
        for j in range(max(0, i - match_dist), min(lb, i + match_dist + 1)):
            if not b_matched[j] and a[i] == b[j]:
                a_matched[i] = b_matched[j] = True
                matches += 1
                break
    if matches == 0:
        return 0.0
    t = k = 0
    for i in range(la):
        if a_matched[i]:
            while not b_matched[k]:
                k += 1
            t += a[i] != b[k]
            k += 1
    t //= 2
    return (matches / la + matches / lb + (matches - t) / matches) / 3.0


def _jaro_winkler(a: str, b: str) -> float:
    j = _jaro(a, b)
    if j <= 0.7:
        return j
    prefix = 0
    for x, y in zip(a, b):
        if x != y or prefix == 4:
            break
        prefix += 1
    return j + prefix * 0.1 * (1.0 - j)


_dict_str2("damerau_levenshtein", lambda s, o: damerau(s, str(o)), ret=BIGINT)
_dict_str2("jaccard", lambda s, o: jaccard(s, str(o)), ret=DOUBLE)
_dict_str2("jaro_similarity", lambda s, o: _jaro(s, str(o)), ret=DOUBLE)
_dict_str2("jaro_winkler_similarity", lambda s, o: _jaro_winkler(s, str(o)), ret=DOUBLE)


@register("overlay", (3, 4))
def _bind_overlay(arg_exprs):
    """overlay(s PLACING r FROM pos [FOR len]), parsed as overlay(s, r, pos[, len])."""
    repl = str(arg_exprs[1].const_value())
    pos = int(arg_exprs[2].const_value())
    ln = int(arg_exprs[3].const_value()) if len(arg_exprs) > 3 else len(repl)

    def impl(env, cols, node):
        return dict_transform(cols[0], lambda s: s[:pos - 1] + repl + s[pos - 1 + ln:],
                              device_key=f"overlay:{repl!r}:{pos}:{ln}")
    return VARCHAR, impl, arg_exprs[:1]


# -- regexp additions ---------------------------------------------------------------
@register("regexp_full_match", (2, 3))
def _bind_regexp_full_match(arg_exprs):
    rx = re.compile(str(arg_exprs[1].const_value()))

    def impl(env, cols, node):
        return dict_predicate(cols[0], lambda s: rx.fullmatch(s) is not None,
                              device_key=f"regexp_full_match:{rx.pattern}")
    return BOOLEAN, impl, arg_exprs[:1]


def _list_fn(name, make, nconst=1, maxconst=None, aliases=()):
    """A VARCHAR → VARCHAR[] function of constant arguments, once per
    distinct value (cached per dictionary)."""
    lt = list_of(VARCHAR)

    def binder(arg_exprs):
        consts = [a.const_value() for a in arg_exprs[1:]]
        fn = make(*consts)
        key = f"{name}:{consts!r}"

        def impl(env, cols, node):
            return _dict_list(cols[0], lambda s: tuple(fn(str(s))), key, lt)
        return lt, impl, arg_exprs[:1]

    for n in (name, *aliases):
        register(n, (1 + nconst, 1 + (maxconst or nconst)))(binder)


def _extract_all(pat, group=0):
    rx = re.compile(str(pat))
    if not 0 <= int(group) <= rx.groups:
        raise ValueInputError(f"Invalid Input Error: Pattern has fewer than {group} groups")
    return lambda s: [(m.group(int(group)) or "") for m in rx.finditer(s)]


def _split_regex(pat):
    rx = re.compile(str(pat))
    return rx.split


def _path_parts(s):
    p = _slashed(s)
    parts = [x for x in p.split("/") if x]
    return (["/"] if p.startswith("/") else []) + parts


_list_fn("regexp_extract_all", _extract_all, 1, 2)
_list_fn("string_split_regex", _split_regex,
         aliases=("regexp_split_to_array", "str_split_regex"))
_list_fn("parse_path", lambda: _path_parts, 0)


# -- readable byte sizes -----------------------------------------------------------
def fmt_size(v, binary: bool) -> str:
    """format_bytes / formatReadableSize / formatReadableDecimalSize of a
    byte count, as DuckDB's StringUtil::BytesToHumanReadableString: the
    largest unit the count reaches and one decimal, truncated."""
    v = int(v)
    if v < 0:
        return "-" + fmt_size(-v, binary)
    base = 1024 if binary else 1000
    units = ("KiB", "MiB", "GiB", "TiB", "PiB") if binary else ("kB", "MB", "GB", "TB", "PB")
    parts = [v]
    for _ in units:
        parts.append(parts[-1] // base)
        parts[-2] %= base
    for i in range(len(units), 0, -1):
        if parts[i]:
            return f"{parts[i]}.{parts[i - 1] * 10 // base} {units[i - 1]}"
    return "1 byte" if v == 1 else f"{v} bytes"


def format_sizes(c: Column, env, binary: bool) -> Column:
    """A byte count per row as text, once per distinct count; a DECIMAL
    count rounds to an integer first, as its cast to BIGINT does."""
    if c.ltype.id is TypeId.DECIMAL:
        scale = 10 ** c.ltype.scale
        return format_distinct(c, env, lambda v: fmt_size(
            (abs(int(v)) * 2 + scale) // (2 * scale) * (1 if v >= 0 else -1), binary))
    if c.ltype.is_float:
        return format_distinct(c, env, lambda v: fmt_size(math.copysign(
            math.floor(abs(v) + 0.5), v), binary))
    return format_distinct(c, env, lambda v: fmt_size(v, binary))


def _readable(name, binary):
    def binder(arg_exprs):
        if arg_exprs[0].ltype.id is TypeId.HUGEINT:  # DuckDB's takes a BIGINT
            raise BindError(f"Binder Error: No function matches the given name and argument "
                            f"types '{name}(HUGEINT)'. You might need to add explicit type "
                            f"casts.")

        def impl(env, cols, node):
            return format_sizes(cols[0], env, binary)
        return VARCHAR, impl, arg_exprs

    register(name, 1)(binder)


# DuckDB's format_bytes is formatReadableSize; the JAX package registers
# the camel-case names too, which the binder reaches lowercased
for _n in ("formatreadablesize", "formatReadableSize", "format_bytes"):
    _readable(_n, True)
for _n in ("formatreadabledecimalsize", "formatReadableDecimalSize"):
    _readable(_n, False)


def parse_bytes(s: str) -> int:
    m = re.match(r"\s*([\d.]+)\s*([A-Za-z]*)\s*$", s)
    if not m:
        raise ValueError(f"cannot parse byte string {s!r}")
    mult = {"": 1, "B": 1, "BYTE": 1, "BYTES": 1, "KB": 1000, "MB": 1000**2, "GB": 1000**3,
            "TB": 1000**4, "PB": 1000**5, "KIB": 1024, "MIB": 1024**2, "GIB": 1024**3,
            "TIB": 1024**4, "PIB": 1024**5}.get(m.group(2).upper())
    if mult is None:
        raise ValueError(f"unknown byte unit {m.group(2)!r}")
    return int(float(m.group(1)) * mult)


_dict_str("parse_formatted_bytes", parse_bytes, ret=BIGINT)


# -- date/time -------------------------------------------------------------------------
_TEMPORAL = (TypeId.DATE, TypeId.TIMESTAMP, TypeId.TIMESTAMPTZ)


def _us_of(c: Column, plen: int) -> torch.Tensor:
    """Microseconds since the epoch of a DATE, TIMESTAMP or INTERVAL column."""
    d = bcast(c.data, plen).to(torch.int64)
    return d * _US_DAY if c.ltype.id is TypeId.DATE else d


def _days_of(c: Column, plen: int) -> torch.Tensor:
    d = bcast(c.data, plen).to(torch.int64)
    if c.ltype.id in (TypeId.TIMESTAMP, TypeId.TIMESTAMPTZ):
        return torch.div(d, _US_DAY, rounding_mode="floor")
    return d


def _epoch(name, us_per_unit, from_int):
    """epoch_us/ms/ns of a DATE or TIMESTAMP: the units since the epoch,
    truncated toward zero as Timestamp::GetEpochMs does (fault (i)); an
    integer argument is epoch_ms's only, milliseconds to a TIMESTAMP
    (fault (h))."""
    def binder(arg_exprs):
        t = arg_exprs[0].ltype
        if t.is_integer:
            if not from_int:
                raise BindError(f"Binder Error: No function matches the given name and "
                                f"argument types '{name}({t})'")

            def impl_ts(env, cols, node):
                c = cols[0]
                return Column(data=bcast(c.data, env.plen).to(torch.int64) * 1000,
                              ltype=TIMESTAMP, validity=c.validity)
            return TIMESTAMP, impl_ts, arg_exprs
        if t.id not in _TEMPORAL + (TypeId.INTERVAL,):
            raise BindError(f"Binder Error: No function matches the given name and argument "
                            f"types '{name}({t})'")

        def impl(env, cols, node):
            us = _us_of(cols[0], env.plen)
            out = (torch.div(us, us_per_unit, rounding_mode="trunc") if us_per_unit >= 1
                   else us * round(1 / us_per_unit))
            return Column(data=out, ltype=BIGINT, validity=cols[0].validity)
        return BIGINT, impl, arg_exprs

    register(name, 1)(binder)


_epoch("epoch_us", 1, False)
_epoch("epoch_ms", 1000, True)
_epoch("epoch_ns", 1e-3, False)


@register("to_timestamp", 1)
def _bind_to_timestamp(arg_exprs):

    def impl(env, cols, node):
        us = (_to_double(cols[0]) * 1e6).to(torch.int64)
        return Column(data=us, ltype=TIMESTAMP, validity=cols[0].validity)
    return TIMESTAMP, impl, arg_exprs


def _seconds_us(s: torch.Tensor) -> torch.Tensor:
    """Seconds as DuckDB's MakeTimeOperator takes them: whole seconds
    truncated, the fraction rounded to the nearest microsecond."""
    whole = torch.trunc(s)
    return whole.to(torch.int64) * 1_000_000 + torch.floor((s - whole) * 1e6 + 0.5).to(torch.int64)


def _ints(cols, plen):
    return [bcast(c.data, plen).to(torch.int64) for c in cols]


@register("make_time", 3)
def _bind_make_time(arg_exprs):

    def impl(env, cols, node):
        h, mi = _ints(cols[:2], env.plen)
        us = (h * 3600 + mi * 60) * 1_000_000 + _seconds_us(bcast(_to_double(cols[2]), env.plen))
        return Column(data=us, ltype=TIME, validity=_valid_of(cols))
    return TIME, impl, arg_exprs


@register("make_timestamp", {1, 6})
def _bind_make_timestamp(arg_exprs):
    """make_timestamp(micros) or make_timestamp(y, m, d, h, mi, s double)."""
    if len(arg_exprs) == 1:
        def impl1(env, cols, node):
            return Column(data=_ints(cols, env.plen)[0], ltype=TIMESTAMP,
                          validity=cols[0].validity)
        return TIMESTAMP, impl1, arg_exprs

    def impl(env, cols, node):
        y, m, d, h, mi = _ints(cols[:5], env.plen)
        days = civil_to_days(y, m, d)
        us = (days * 86400 + h * 3600 + mi * 60) * 1_000_000 \
            + _seconds_us(bcast(_to_double(cols[5]), env.plen))
        return Column(data=us, ltype=TIMESTAMP, validity=_valid_of(cols))
    return TIMESTAMP, impl, arg_exprs


def _make_ts_scaled(name, mult):
    def binder(arg_exprs):

        def impl(env, cols, node):
            x = _ints(cols, env.plen)[0]
            us = x * mult if mult >= 1 else torch.div(x, round(1 / mult), rounding_mode="floor")
            return Column(data=us, ltype=TIMESTAMP, validity=cols[0].validity)
        return TIMESTAMP, impl, arg_exprs

    register(name, 1)(binder)


_make_ts_scaled("make_timestamp_ms", 1000)
_make_ts_scaled("make_timestamp_ns", 1e-3)


def _iso_year_week(days: torch.Tensor):
    """The ISO-8601 (year, week) of each day: those of its week's Thursday."""
    thursday = days - torch.remainder(days + 3, 7) + 3
    ty, _, _ = civil_from_days(thursday)
    jan1 = civil_to_days(ty, torch.ones_like(ty), torch.ones_like(ty))
    return ty, torch.div(thursday - jan1, 7, rounding_mode="floor") + 1


def _millennium(y: torch.Tensor) -> torch.Tensor:
    # DuckDB's date_part.cpp: year > 0 ? (year - 1) / 1000 + 1 : -((-year) / 1000 + 1)
    return torch.where(y > 0, torch.div(y - 1, 1000, rounding_mode="floor") + 1,
                       -(torch.div(-y, 1000, rounding_mode="floor") + 1))


def _part(name, fn):
    """A date part of a DATE or TIMESTAMP, from (y, m, d, days)."""
    def binder(arg_exprs):

        def impl(env, cols, node):
            c = cols[0]
            days = _days_of(c, env.plen)
            y, m, d = civil_from_days(days)
            return Column(data=fn(y, m, d, days).to(torch.int64), ltype=BIGINT,
                          validity=c.validity)
        return BIGINT, impl, arg_exprs

    register(name, 1)(binder)


_part("era", lambda y, m, d, days: (y > 0).to(torch.int64))
_part("millennium", lambda y, m, d, days: _millennium(y))
_part("weekday", lambda y, m, d, days: torch.remainder(days + 4, 7))
_part("dayofmonth", lambda y, m, d, days: d)
_part("isoyear", lambda y, m, d, days: _iso_year_week(days)[0])
_part("yearweek", lambda y, m, d, days: (lambda yw: yw[0] * 100 + yw[1])(_iso_year_week(days)))
REGISTRY["datepart"] = REGISTRY["date_part"]


@register("julian", 1)
def _bind_julian(arg_exprs):
    """The Julian day as a DOUBLE, with a TIMESTAMP's fraction of a day."""

    def impl(env, cols, node):
        c = cols[0]
        d = bcast(c.data, env.plen).to(torch.float64)
        if c.ltype.id in (TypeId.TIMESTAMP, TypeId.TIMESTAMPTZ):
            d = d / 86400e6
        return Column(data=d + 2440588.0, ltype=DOUBLE, validity=c.validity)
    return DOUBLE, impl, arg_exprs


_SUB_US = {"second": 1_000_000, "seconds": 1_000_000, "minute": 60_000_000,
           "minutes": 60_000_000, "hour": 3_600_000_000, "hours": 3_600_000_000,
           "day": _US_DAY, "days": _US_DAY, "millisecond": 1000, "milliseconds": 1000,
           "microsecond": 1, "microseconds": 1, "week": 7 * _US_DAY, "weeks": 7 * _US_DAY}


@register("date_sub", 3)
@register("datesub", 3)
def _bind_date_sub(arg_exprs):
    """date_sub(part, start, end): the whole parts from start to end
    (DuckDB's date_sub.cpp), truncated toward zero. Month-based parts
    need calendar arithmetic that neither package has here."""
    part = str(arg_exprs[0].const_value()).lower()
    us = _SUB_US.get(part)
    if us is None:
        raise not_ported(f"date_sub('{part}', …), which the JAX package refuses too")

    def impl(env, cols, node):
        diff = _us_of(cols[1], env.plen) - _us_of(cols[0], env.plen)
        return Column(data=torch.div(diff, us, rounding_mode="trunc"), ltype=BIGINT,
                      validity=_valid_of(cols))
    return BIGINT, impl, arg_exprs[1:]


def _to_interval(name, us_per):
    def binder(arg_exprs):

        def impl(env, cols, node):
            return Column(data=_ints(cols, env.plen)[0] * us_per, ltype=INTERVAL,
                          validity=cols[0].validity)
        return INTERVAL, impl, arg_exprs

    register(name, 1)(binder)


for _n, _us in (("to_microseconds", 1), ("to_milliseconds", 1000), ("to_seconds", 1_000_000),
                ("to_minutes", 60_000_000), ("to_hours", 3_600_000_000), ("to_days", _US_DAY),
                ("to_weeks", 7 * _US_DAY)):
    _to_interval(_n, _us)


@register("try_strptime", 2)
def _bind_try_strptime(arg_exprs):
    """VARCHAR → TIMESTAMP once per distinct value; NULL where it does not parse."""
    fmt = str(arg_exprs[1].const_value())
    epoch = datetime.datetime(1970, 1, 1)

    def compute(dvals, dev):
        n = max(len(dvals), 1)
        us = np.zeros(n, dtype=np.int64)
        ok = np.zeros(n, dtype=np.bool_)
        for i, s in enumerate(dvals):
            try:
                d = datetime.datetime.strptime(str(s), fmt) - epoch
            except ValueError:
                continue
            us[i] = (d.days * 86400 + d.seconds) * 1_000_000 + d.microseconds
            ok[i] = True
        return torch.from_numpy(us).to(dev), torch.from_numpy(ok).to(dev)

    def impl(env, cols, node):
        c = cols[0]
        if c.dict_values is None:
            return _null_column(c, TIMESTAMP)
        dev = c.data.device
        us, ok = dstr.cached_lut(c.dict_values, ("try_strptime", fmt, str(dev)),
                                 lambda: compute(c.dict_values, dev))
        idx = c.data.long().clamp(0, len(us) - 1)
        return Column(data=us[idx], ltype=TIMESTAMP, validity=_and_validity(ok[idx], c.validity))
    return TIMESTAMP, impl, arg_exprs[:1]


def _utc_zone(name, e):
    zone = e.const_value()
    if zone is None or str(zone).upper() not in ("UTC", "GMT", "Z", "ETC/UTC"):
        raise not_ported(f"{name}() in the time zone {zone!r} (the session is UTC)")


@register("timezone", (1, 2))
def _bind_timezone(arg_exprs):
    """timezone(ts): the offset in seconds, 0 in the UTC session;
    timezone('UTC', TIMESTAMP) is the TIMESTAMPTZ of that UTC time and
    timezone('UTC', TIMESTAMPTZ) its UTC TIMESTAMP (DuckDB's ICU)."""
    if len(arg_exprs) == 1:
        def impl0(env, cols, node):
            return Column(data=_full(env, 0, torch.int64), ltype=BIGINT,
                          validity=cols[0].validity)
        return BIGINT, impl0, arg_exprs
    _utc_zone("timezone", arg_exprs[0])
    src = arg_exprs[1].ltype
    if src.id is TypeId.DATE:
        src = TIMESTAMP
    if src.id not in (TypeId.TIMESTAMP, TypeId.TIMESTAMPTZ):
        raise BindError(f"Binder Error: timezone() of a {src}")
    out = TIMESTAMPTZ if src.id is TypeId.TIMESTAMP else TIMESTAMP

    def impl(env, cols, node):
        c = cols[0]
        return Column(data=_us_of(c, env.plen), ltype=out, validity=c.validity)
    return out, impl, arg_exprs[1:]


def _tz_part(name):
    def binder(arg_exprs):

        def impl(env, cols, node):
            return Column(data=_full(env, 0, torch.int64), ltype=BIGINT,
                          validity=cols[0].validity)
        return BIGINT, impl, arg_exprs

    register(name, 1)(binder)


_tz_part("timezone_hour")
_tz_part("timezone_minute")


# -- system and introspection -----------------------------------------------------------
def _session_text(name, read):
    def binder(arg_exprs):

        def impl(env, cols, node):
            return _const_varchar(env, read(session.active()))
        return VARCHAR, impl, []

    register(name, 0)(binder)


_session_text("current_database", lambda s: s.database)
_session_text("current_schema", lambda s: s.schema)
_session_text("current_query", lambda s: s.query)
_session_text("version", lambda s: VERSION)


@register("current_schemas")
def _bind_current_schemas(arg_exprs):
    lt = list_of(VARCHAR)

    def impl(env, cols, node):
        return Column(data=_full(env, 0, torch.int32), ltype=lt,
                      dict_values=obj_array([(session.active().schema,)]))
    return lt, impl, []


@register("current_setting", 1)
def _bind_current_setting(arg_exprs):
    from duckdb_tpu_torch.main.settings import SettingsManager, canonical

    e = arg_exprs[0]
    if not e.is_const() or e.ltype.id is not TypeId.VARCHAR or e.const_value() is None:
        raise BindError("Binder Error: current_setting() takes a constant setting name")
    try:
        name = canonical(str(e.const_value()))
    except ValueError as err:  # an unknown name: DuckDB's Catalog Error
        raise ValueCatalogError(str(err)) from None

    def impl(env, cols, node):
        settings = getattr(session.active().catalog, "settings", None) or SettingsManager()
        return _const_varchar(env, settings.text(name))
    return VARCHAR, impl, []


def _session_int(name, read):
    def binder(arg_exprs):
        def impl(env, cols, node):
            return Column(data=_full(env, read(session.active()), torch.int64), ltype=BIGINT)
        return BIGINT, impl, []

    REGISTRY[name] = binder


_session_int("txid_current", lambda s: s.next_txid())
_session_int("current_transaction_id", lambda s: s.next_txid())
_session_int("current_connection_id", lambda s: s.connection_id)


@register("getenv", 1)
def _bind_getenv(arg_exprs):
    name = str(arg_exprs[0].const_value())

    def impl(env, cols, node):
        return _const_varchar(env, os.environ.get(name, ""))
    return VARCHAR, impl, []


@register("setseed", 1)
def _bind_setseed(arg_exprs):
    """setseed(x): the connection's random() and uuid generators restart
    from x (planner/session.py); the value is NULL."""
    seed = float(_const_py(arg_exprs[0])[0])

    def impl(env, cols, node):
        session.active().set_seed(seed)
        return Column(data=_full(env, 0, torch.int32), ltype=SQLNULL,
                      validity=_full(env, False, torch.bool))
    return SQLNULL, impl, []


@register("error", 1)
def _bind_error(arg_exprs):
    msg = str(arg_exprs[0].const_value())

    def impl(env, cols, node):
        raise ValueInputError(f"Invalid Input Error: {msg}")
    return SQLNULL, impl, []


@register("constant_or_null")
def _bind_constant_or_null(arg_exprs):
    """The first argument where every other is not NULL, else NULL."""
    if len(arg_exprs) < 2:
        raise BindError("Binder Error: constant_or_null takes at least 2 arguments")
    t = arg_exprs[0].ltype

    def impl(env, cols, node):
        c0 = cols[0]
        valid = _valid_of(cols)
        return Column(data=bcast(c0.data, env.plen), ltype=t,
                      validity=None if valid is None else bcast(valid, env.plen),
                      dict_values=c0.dict_values, data_hi=c0.data_hi)
    return t, impl, arg_exprs


@register("can_cast_implicitly", 2)
def _bind_can_cast_implicitly(arg_exprs):
    ok = implicit_cast_cost(arg_exprs[0].ltype, arg_exprs[1].ltype) is not None

    def impl(env, cols, node):
        return Column(data=_full(env, ok, torch.bool), ltype=BOOLEAN)
    return BOOLEAN, impl, []


@register("alias", 1)
def _bind_alias(arg_exprs):
    """The name of the argument expression (a function's name, else 'expr')."""
    name = getattr(arg_exprs[0], "name", None) or "expr"

    def impl(env, cols, node):
        return _const_varchar(env, str(name))
    return VARCHAR, impl, []
