"""The string plane ops of ops/strings, each beside the host function it
must equal, run over one dictionary.

`check_dictionary(dvals, device)` packs the dictionary into its byte plane
on `device`, runs every op of TRANSFORMS (plane → plane, then the one
transfer and decode of `_decode_plane`) and VALUES (plane → bool or int
LUT), and compares each result, decoded, with the host function applied to
every value: the string the planner's host loop would give. chip_smoke.py
runs it on the card over c_phone, p_name and o_comment at SF1;
tests/test_torch_gpu.py over SF 0.01's dictionaries.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np

from duckdb_tpu_torch.ops import strings as TS
from duckdb_tpu_torch.planner.functions import duckdb_substring
from duckdb_tpu_torch.planner.functions_ext import _host_pad, _left, _right

# (name, plane op, host function): str → str
TRANSFORMS: List[Tuple[str, Callable, Callable]] = [
    ("substring(s, 1, 2)", lambda p, le: TS.op_substring(p, le, 0, 2),
     lambda s: duckdb_substring(s, 1, 2)),
    ("substring(s, 5)", lambda p, le: TS.op_substring(p, le, 4, None),
     lambda s: duckdb_substring(s, 5, None)),
    ("substring(s, 0, 4)", lambda p, le: TS.op_substring(p, le, 0, 3),
     lambda s: duckdb_substring(s, 0, 4)),
    ("upper", lambda p, le: TS.op_case(p, le, True), str.upper),
    ("lower", lambda p, le: TS.op_case(p, le, False), str.lower),
    ("trim", lambda p, le: TS.op_trim(p, le, b" ", True, True), lambda s: s.strip(" ")),
    ("ltrim(s, 'a ')", lambda p, le: TS.op_trim(p, le, b"a ", True, False),
     lambda s: s.lstrip("a ")),
    ("rtrim(s, 's.')", lambda p, le: TS.op_trim(p, le, b"s.", False, True),
     lambda s: s.rstrip("s.")),
    ("s || '-x'", lambda p, le: TS.op_concat_const(p, le, "", "-x"), lambda s: s + "-x"),
    ("'<' || s || '>'", lambda p, le: TS.op_concat_const(p, le, "<", ">"),
     lambda s: "<" + s + ">"),
    ("left(s, 5)", lambda p, le: TS.op_left(p, le, 5), lambda s: _left(s, 5)),
    ("left(s, -3)", lambda p, le: TS.op_left(p, le, -3), lambda s: _left(s, -3)),
    ("right(s, 4)", lambda p, le: TS.op_right(p, le, 4), lambda s: _right(s, 4)),
    ("right(s, -2)", lambda p, le: TS.op_right(p, le, -2), lambda s: _right(s, -2)),
    ("reverse", TS.op_reverse, lambda s: s[::-1]),
    ("initcap", TS.op_initcap, lambda s: s[:1].upper() + s[1:].lower()),
    ("initcap(reverse(s))", lambda p, le: TS.op_initcap(*TS.op_reverse(p, le)),
     lambda s: s[::-1][:1].upper() + s[::-1][1:].lower()),
    ("lpad(s, 12, '*')", lambda p, le: TS.op_pad(p, le, 12, "*", True),
     lambda s: _host_pad(s, 12, "*", True)),
    ("rpad(s, 30, 'xy')", lambda p, le: TS.op_pad(p, le, 30, "xy", False),
     lambda s: _host_pad(s, 30, "xy", False)),
    ("repeat(s, 2)", lambda p, le: TS.op_repeat(p, le, 2), lambda s: s * 2),
]

# (name, plane op, host function): str → bool / int
VALUES: List[Tuple[str, Callable, Callable]] = [
    ("length", lambda p, le: le, len),
    ("contains(s, 'the')", lambda p, le: TS.op_contains(p, le, "the"), lambda s: "the" in s),
    ("contains(s, '-9')", lambda p, le: TS.op_contains(p, le, "-9"), lambda s: "-9" in s),
    ("prefix(s, '1')", lambda p, le: TS.op_prefix(p, le, "1"), lambda s: s.startswith("1")),
    ("prefix(s, 'for')", lambda p, le: TS.op_prefix(p, le, "for"),
     lambda s: s.startswith("for")),
    ("suffix(s, 's')", lambda p, le: TS.op_suffix(p, le, "s"), lambda s: s.endswith("s")),
    ("suffix(s, 'ly.')", lambda p, le: TS.op_suffix(p, le, "ly."), lambda s: s.endswith("ly.")),
    ("strpos(s, 'special')", lambda p, le: TS.op_strpos(p, le, "special"),
     lambda s: s.find("special") + 1),
    ("strpos(s, 'green')", lambda p, le: TS.op_strpos(p, le, "green"),
     lambda s: s.find("green") + 1),
    ("strpos(s, '-')", lambda p, le: TS.op_strpos(p, le, "-"), lambda s: s.find("-") + 1),
    ("ascii", TS.op_ascii, lambda s: ord(s[0]) if s else 0),
    ("ascii(right(s, 4))", lambda p, le: TS.op_ascii(*TS.op_right(p, le, 4)),
     lambda s: ord(_right(s, 4)[0]) if s else 0),
]


def check_dictionary(dvals: np.ndarray, device) -> List[str]:
    """Every op over `dvals` on `device` against its host function → the
    names of the ops that disagree (empty when all agree). Raises if the
    dictionary cannot be packed (non-ASCII)."""
    packed = TS._pack_dict(dvals, device)
    if packed is None:
        raise ValueError("the dictionary has no byte plane (non-ASCII or embedded NUL)")
    bad = []
    for name, op, host in TRANSFORMS:
        remap, uniq = TS._decode_plane(*op(*packed))
        if list(uniq[remap]) != [host(s) for s in dvals]:
            bad.append(name)
    for name, op, host in VALUES:
        got = op(*packed).cpu().numpy()
        if got.tolist() != [host(s) for s in dvals]:
            bad.append(name)
    return bad
