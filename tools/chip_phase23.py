#!/usr/bin/env python3
"""Phase 23 of chip_smoke.py alone: the grammar fuzzer on a card connection
against a CPU connection of the port.

    python3 tools/chip_phase23.py

Builds the grouped-sum kernel and runs chip_smoke.fuzz_phase: SETUP's
tables and seeds 1, 7 and 11 × 400 queries, then t1 and t2 by SETUP's
formulas at 1,000,000 and 400,000 rows and seed 1 × 200 queries, every
answer compared card against CPU and every grouped-sum launch held to its
plain version. Needs no TPC-H data. Exits non-zero on the first failure.
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
    from duckdb_tpu_torch.ops import grouped as grouped_mod
    from duckdb_tpu_torch.ops import grouped_sum as GS

    card = CS.card_line()
    print(card)
    GS.build(True)
    launches, shapes = {}, []
    t0 = time.perf_counter()
    try:
        bad = CS.fuzz_phase(card, launches, shapes, 20)
    finally:
        grouped_mod.grouped_sum_i64 = GS.grouped_sum_i64
    if bad:
        return CS.fail(bad)
    for r in shapes:
        print(f"grouped_sum_i64 at {r['query']}'s shape N={r['n']} K={r['k']} nseg={r['nseg']} "
              f"on {card}: kernel {r['kernel_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"index_add_ {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']}")
    print(f"phase 23 took {time.perf_counter() - t0:.1f} s; grouped_sum_i64 launches {launches}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
