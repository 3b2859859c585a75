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
