#!/usr/bin/env python3
"""Warm times of the port's out-of-core queries, for one or more trees in turns.

    python3 tools/ooc_timing.py [--roots DIR [DIR ...]] [--runs 7]

Runs chip_smoke.py's phase-16 queries (Q1, Q3, Q6 and the select … ORDER
BY … LIMIT 100) at TPC-H SF1, seed 0, under chip_smoke.OOC_LIMIT, and each
once in memory. Each root (a checkout holding `duckdb_tpu_torch/`; the
default is this repository) runs in a process of its own, in the order
given, so `--roots build/parent . . build/parent` compares two trees on one
card in turns (parent, change, change, parent). Tables come from the
generator of this repository into data/, as chip_smoke.py makes them.
Prints, per root and query, the median and every time of `runs` warm runs
after one warm-up (each ends in a synchronize), the chunk count, and
whether the rows equal the in-memory run's; and the card's name and power
limit. Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(root: str, runs: int) -> dict:
    """One root's times: → {query: {"median_ms", "runs_ms", "in_memory_ms",
    "chunks", "equal"}}."""
    sys.path.insert(0, os.path.abspath(root))
    sys.path.insert(1, ROOT)
    import torch

    import chip_smoke as S
    import duckdb_tpu_torch
    from duckdb_tpu_torch.catalog import catalog as C
    from duckdb_tpu_torch.testing import tpch_oracle
    from duckdb_tpu_torch.testing.tpch_gen import TABLE_COLUMNS, write_tables

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    if not all(os.path.exists(os.path.join(S.DATA, t, "meta.json")) for t in TABLE_COLUMNS):
        write_tables(S.DATA, S.SF, S.SEED)
    con = duckdb_tpu_torch.connect()
    con.load_tpch(S.DATA)
    queries = {"q01": S.Q1, "q03": tpch_oracle.QUERIES["q03"],
               "q06": tpch_oracle.GENERAL_QUERIES["q06"], "ooc_select": S.OOC_SELECT}

    def times(sql, n):
        out = []
        for _ in range(n + 1):
            t0 = time.perf_counter()
            rows = con.sql(sql).rows()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return rows, out[1:]

    res = {}
    for name, sql in queries.items():
        C.set_memory_limit(0)
        want, mem = times(sql, runs)
        C.set_memory_limit(S.OOC_LIMIT)
        con.routes.clear()
        got, ooc = times(sql, runs)
        chunks = con.routes.get("out_of_core_chunks", 0) // (runs + 1)
        C.set_memory_limit(0)
        res[name] = {"median_ms": statistics.median(ooc), "runs_ms": ooc,
                     "in_memory_ms": statistics.median(mem), "chunks": chunks,
                     "equal": got == want}
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--roots", nargs="+", default=[ROOT])
    ap.add_argument("--runs", type=int, default=7)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print("RESULT " + json.dumps(child(args.child, args.runs)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    bad = 0
    for i, root in enumerate(args.roots):
        p = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root,
                            "--runs", str(args.runs)], capture_output=True, text=True)
        lines = [ln for ln in p.stdout.splitlines() if ln.startswith("RESULT ")]
        if p.returncode or not lines:
            print(f"turn {i} {root}: failed (rc {p.returncode})\n{p.stderr[-3000:]}")
            bad += 1
            continue
        for q, r in json.loads(lines[-1][7:]).items():
            bad += not r["equal"]
            print(f"turn {i} {root} {q} on {card}: under the limit median {r['median_ms']:.3f} ms "
                  f"(runs {', '.join(f'{t:.3f}' for t in r['runs_ms'])}), {r['chunks']} chunks, "
                  f"in memory {r['in_memory_ms']:.3f} ms, rows equal: {r['equal']}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
