#!/usr/bin/env python3
"""Phase 26 of chip_smoke.py alone: G1-G3's forms, then median,
quantile_cont, stddev_samp and var_pop over frames, and count(DISTINCT),
median(DISTINCT) and stddev(DISTINCT) over ROWS frames at SF1 on one card, each held to a numpy oracle, its outer
count(*) through the grouped-sum kernel.

    python3 tools/chip_phase26.py

Builds the grouped-sum kernel, makes chip_smoke.py's SF1 tables (seed 0)
under data/ unless they are there, loads lineitem and orders on a card
connection and runs chip_smoke.frame_windows_phase. Exits non-zero on the
first failure.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        return CS.fail("no CUDA device")
    import duckdb_tpu_torch
    from duckdb_tpu_torch.ops import grouped as grouped_mod
    from duckdb_tpu_torch.ops import grouped_sum as GS
    from duckdb_tpu_torch.testing.tpch_gen import TABLE_COLUMNS, write_tables

    card = CS.card_line()
    print(card)
    t0 = time.perf_counter()
    GS.build(True)
    print(f"built the kernel in {time.perf_counter() - t0:.1f} s")
    if not all(os.path.exists(os.path.join(CS.DATA, t, "meta.json")) for t in TABLE_COLUMNS):
        write_tables(CS.DATA, CS.SF, CS.SEED)
    con = duckdb_tpu_torch.connect()
    con.load_tpch(CS.DATA, tables=["lineitem", "orders"])
    recorded = []

    def recording(dense, vectors, nseg):
        recorded.append((dense, list(vectors), nseg))
        return GS.grouped_sum_i64(dense, vectors, nseg)

    launches, shapes = {}, []
    t0 = time.perf_counter()
    try:
        bad = CS.frame_windows_phase(con, card, recording, recorded, launches, shapes, 20)
    finally:
        grouped_mod.grouped_sum_i64 = GS.grouped_sum_i64
    if bad:
        return CS.fail(bad)
    print(f"phase 26 took {time.perf_counter() - t0:.1f} s; grouped_sum_i64 launches {launches}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
