#!/usr/bin/env python3
"""Where a TPC-H query's time goes in the PyTorch/CUDA port, on one GPU.

    python3 tools/profile_torch_query.py [--query q01] [--sf 1] [--runs 3] [--out DIR]

`--query` is q01 (bench.py's Q1) or a key of testing/tpch_oracle's query
dicts. Generates the eight tables with the port's seeded generator (into
data/, as chip_smoke.py does), warms the query twice, times `runs` runs
split into `con.sql()` (plan, execution, the device-to-host transfer; ends
in a synchronize) and `Result.rows()` (Python values on the host), then
profiles `runs` executions with torch.profiler (CPU and CUDA activities).
Prints the medians of the split, the wall time per query under the
profiler, the device-busy share (summed CUDA kernel time over wall time),
and the top operators by CUDA time; writes the full table and a Chrome
trace under --out. Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--query", default="q01")
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "profile"))
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_query: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    import duckdb_tpu_torch
    from duckdb_tpu_torch.testing import tpch_oracle
    from duckdb_tpu_torch.testing.tpch_gen import TABLE_COLUMNS, write_tables

    queries = {"q01": chip_smoke.Q1, **tpch_oracle.QUERIES, **tpch_oracle.SUBQUERY_QUERIES,
               **tpch_oracle.FROM_QUERIES, **tpch_oracle.LIKE_QUERIES,
               **tpch_oracle.GENERAL_QUERIES, **tpch_oracle.FUNCTION_QUERIES,
               **tpch_oracle.NESTED_QUERIES, **tpch_oracle.MORE_QUERIES,
               **tpch_oracle.SELECT_FORM_QUERIES, **tpch_oracle.WINDOW_QUERIES}
    sql = queries[args.query]

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    data = os.path.join(ROOT, "data", f"tpch_gen_sf{args.sf:g}_seed0")
    if not all(os.path.exists(os.path.join(data, t, "meta.json")) for t in TABLE_COLUMNS):
        write_tables(data, args.sf, 0)
    con = duckdb_tpu_torch.connect()
    con.load_tpch(data)
    for _ in range(2):
        con.sql(sql).rows()
    torch.cuda.synchronize()

    sql_ms, rows_ms = [], []
    for _ in range(args.runs):
        t0 = time.perf_counter()
        result = con.sql(sql)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rows = result.rows()
        sql_ms.append((t1 - t0) * 1e3)
        rows_ms.append((time.perf_counter() - t1) * 1e3)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.runs):
            con.sql(sql).rows()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.runs

    events = prof.key_averages()
    # kernels are the CUDA-side events; CPU ops also carry their kernels'
    # time, so only the CUDA-side ones are summed
    device_ms = sum(e.self_device_time_total for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / args.runs
    os.makedirs(args.out, exist_ok=True)
    table = events.table(sort_by="self_device_time_total", row_limit=40)
    with open(os.path.join(args.out, f"profile_{args.query}_table.txt"), "w") as f:
        f.write(table)
    prof.export_chrome_trace(os.path.join(args.out, f"profile_{args.query}_trace.json"))
    print(f"card: {card}")
    print(f"{args.query} SF{args.sf:g}, {len(rows)} rows, {args.runs} runs: con.sql() median "
          f"{statistics.median(sql_ms):.3f} ms, Result.rows() median "
          f"{statistics.median(rows_ms):.3f} ms")
    print(f"{args.query} SF{args.sf:g}, {args.runs} profiled runs: wall {wall_ms:.3f} ms/query "
          f"(under the profiler), CUDA kernel time {device_ms:.3f} ms/query, "
          f"device busy {100 * device_ms / wall_ms:.1f}%")
    print(events.table(sort_by="self_device_time_total", row_limit=20))
    return 0


if __name__ == "__main__":
    sys.exit(main())
