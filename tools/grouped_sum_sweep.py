#!/usr/bin/env python3
"""Time one checkout's grouped int64 sum kernel over chip_smoke.py's sweep.

    python3 tools/grouped_sum_sweep.py [--root DIR] [--sass]

--root names the checkout whose duckdb_tpu_torch is built and timed (this
one by default), so that two commits can be compared on one card: run it
for each, in turns, in one job. --sass prints, for every kernel in the
built library, the atomic instructions cuobjdump finds in its SASS (a
native shared add shows as ATOMS.ADD, a compare-and-swap loop as
ATOMS.CAST.SPIN). The last line is the sweep as JSON. Needs a CUDA device and
the CUDA toolkit; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def sass_atomics(library: str) -> dict:
    """{kernel name: {atomic opcode: count}} from cuobjdump -sass."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", library], capture_output=True, text=True,
                          check=True).stdout
    found = collections.defaultdict(collections.Counter)
    kernel = "?"
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            kernel = m.group(1)
            continue
        for op in re.findall(r"\b((?:ATOMS|ATOMG|ATOM|REDG|RED)\.[A-Z0-9_.]+)", line):
            found[kernel][op] += 1
    return {k: dict(v) for k, v in found.items()}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    import torch

    if not torch.cuda.is_available():
        print("grouped_sum_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    # this repository's chip_smoke, the other checkout's package
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    sys.path.insert(0, root)
    from duckdb_tpu_torch.ops import grouped_sum as GS

    card = chip_smoke.card_line()
    print(f"card: {card}; checkout {root}")
    GS.build(force=True)
    if args.sass:
        for kernel, ops in sass_atomics(GS.LIBRARY).items():
            print(f"SASS atomics of {kernel}: {ops}")
    rows = chip_smoke.sweep(GS, card)
    print(json.dumps({"root": root, "card": card, "sweep": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
