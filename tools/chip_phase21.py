#!/usr/bin/env python3
"""Phase 21 of chip_smoke.py alone: MERGE, ALTER and PIVOT at SF1 on one card.

    python3 tools/chip_phase21.py

Builds the grouped-sum kernel, makes chip_smoke.py's SF1 tables (seed 0)
under data/ unless they are there, and runs chip_smoke.merge_alter_phase:
a MERGE of a staging table into a copy of lineitem (delete, update and
insert) held to numpy, a MERGE refused for a duplicate source key, four
ALTERs (ADD COLUMN … DEFAULT, RENAME COLUMN, ALTER … TYPE, DROP COLUMN),
a rolled-back DROP COLUMN and MERGE, Q1 through the kernel after each,
PIVOT and UNPIVOT held to numpy, and 200,000 rows through the appender
into a table with a key; each step with its wall ms, host syncs and
host<->device bytes. Exits non-zero on the first failure.
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
    from duckdb_tpu_torch.testing.tpch_gen import TABLE_COLUMNS, write_tables

    card = CS.card_line()
    print(card)
    GS.build(force=True)
    if not all(os.path.exists(os.path.join(CS.DATA, t, "meta.json")) for t in TABLE_COLUMNS):
        write_tables(CS.DATA, CS.SF, CS.SEED)
    recorded = []

    def recording(dense, vectors, nseg):
        recorded.append((dense, list(vectors), nseg))
        return GS.grouped_sum_i64(dense, vectors, nseg)

    launches, shapes = {}, []
    t0 = time.perf_counter()
    try:
        bad = CS.merge_alter_phase(card, recording, recorded, launches, shapes, 20)
    finally:
        grouped_mod.grouped_sum_i64 = GS.grouped_sum_i64
    if bad:
        return CS.fail(bad)
    print(f"phase 21 took {time.perf_counter() - t0:.1f} s; grouped_sum_i64 launches {launches}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
