#!/usr/bin/env python3
"""Phase 25 of chip_smoke.py alone: the faults' forms and C1-C5, lineitem
at SF1 through the port's own Arrow export and import, the nested and TIME
Parquet columns, and the configuration matrix at SF 0.01, on one card.

    python3 tools/chip_phase25.py

Builds the grouped-sum kernel, the C API and the Arrow library
(csrc/arrow_c.cpp) side by side, makes chip_smoke.py's SF1 tables (seed 0)
under data/ unless they are there, registers lineitem on a card connection,
and runs chip_smoke.faults_arrow_matrix_phase. Needs neither pyarrow nor
pandas. Exits non-zero on the first failure.
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
    from duckdb_tpu_torch.storage import host_lib
    from duckdb_tpu_torch.testing.tpch_gen import TABLE_COLUMNS, write_tables

    card = CS.card_line()
    print(card)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        for f in [pool.submit(GS.build, True), pool.submit(duckdb_tpu_torch.capi.library, True),
                  pool.submit(host_lib.load, "arrow_c", True),
                  pool.submit(host_lib.load, "parquet_codec", True)]:
            f.result()
    print(f"built the kernel and the host libraries in {time.perf_counter() - t0:.1f} s")
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
        bad = CS.faults_arrow_matrix_phase(con, card, recording, recorded, launches, shapes, 20)
    finally:
        grouped_mod.grouped_sum_i64 = GS.grouped_sum_i64
    if bad:
        return CS.fail(bad)
    print(f"phase 25 took {time.perf_counter() - t0:.1f} s; grouped_sum_i64 launches {launches}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
