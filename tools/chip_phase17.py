#!/usr/bin/env python3
"""Phase 17 of chip_smoke.py alone: the sharded steps on the visible cards.

    python3 tools/chip_phase17.py

Builds the grouped-sum kernel, makes chip_smoke.py's SF1 tables (seed 0)
under data/ unless they are there, loads them on one connection pinned to
one device, and runs chip_smoke.sharded_phase: the card count and the
shard -> device map of chip_smoke.SHARDS shards, q1_local_partial, then
each of chip_smoke.SHARD_QUERIES on a fresh connection with SHARDS shards
against its single-device run and numpy, and one Q1 under AUTO. On a host
with as many cards as shards each shard has its own card, so this is the
quick way to drive the cross-card copies and per-card kernel launches.
Exits non-zero on the first failure.
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
    GS.build(force=True)
    if not all(os.path.exists(os.path.join(CS.DATA, t, "meta.json")) for t in TABLE_COLUMNS):
        write_tables(CS.DATA, CS.SF, CS.SEED)
    con = duckdb_tpu_torch.connect()
    con.load_tpch(CS.DATA)
    con.sql("SET num_shards = 1")
    recorded = []

    def recording(dense, vectors, nseg):
        recorded.append((dense, list(vectors), nseg))
        return GS.grouped_sum_i64(dense, vectors, nseg)

    launches, shapes = {}, []
    t0 = time.perf_counter()
    try:
        bad = CS.sharded_phase(con, card, recording, recorded, launches, shapes, 20)
    finally:
        grouped_mod.grouped_sum_i64 = GS.grouped_sum_i64
    if bad:
        return CS.fail(bad)
    print(f"phase 17 took {time.perf_counter() - t0:.1f} s; grouped_sum_i64 launches {launches}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
