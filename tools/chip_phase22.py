#!/usr/bin/env python3
"""Phase 22 of chip_smoke.py alone: settings, the profile, the log and the
clients at SF1 on one card.

    python3 tools/chip_phase22.py

Builds the grouped-sum kernel and the C API (capi/capi.cpp, with the host
compiler) side by side, makes chip_smoke.py's SF1 tables (seed 0) under
data/ unless they are there, registers lineitem on a card connection, and
runs chip_smoke.main_clients_phase: SET / current_setting / RESET of
temp_directory, join_order and default_null_order and duckdb_settings()'
187 rows; EXPLAIN ANALYZE of Q1 through the kernel; Q1's QueryLog line,
then the out-of-core select under a 48 MiB limit with temp_directory set
and its out_of_core lines; Q1 under pallas_grouped_sum = 'off' (no
launch) and after RESET; lineitem into a file database, Q1 through the
CLI in a subprocess and through the C API in this process, each held to
numpy. Exits non-zero on the first failure.
"""

import concurrent.futures
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
    import duckdb_tpu_torch.capi
    from duckdb_tpu_torch.ops import grouped as grouped_mod
    from duckdb_tpu_torch.ops import grouped_sum as GS
    from duckdb_tpu_torch.testing.tpch_gen import TABLE_COLUMNS, write_tables

    card = CS.card_line()
    print(card)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(GS.build, True), pool.submit(duckdb_tpu_torch.capi.library, True)]:
            f.result()
    if not all(os.path.exists(os.path.join(CS.DATA, t, "meta.json")) for t in TABLE_COLUMNS):
        write_tables(CS.DATA, CS.SF, CS.SEED)
    con = duckdb_tpu_torch.connect()
    con.load_tpch(CS.DATA, tables=["lineitem"])
    recorded = []

    def recording(dense, vectors, nseg):
        recorded.append((dense, list(vectors), nseg))
        return GS.grouped_sum_i64(dense, vectors, nseg)

    launches, shapes = {}, []
    t0 = time.perf_counter()
    try:
        bad = CS.main_clients_phase(con, card, recording, recorded, launches, shapes, 20)
    finally:
        grouped_mod.grouped_sum_i64 = GS.grouped_sum_i64
    if bad:
        return CS.fail(bad)
    print(f"phase 22 took {time.perf_counter() - t0:.1f} s; grouped_sum_i64 launches {launches}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
