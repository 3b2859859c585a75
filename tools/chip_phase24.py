#!/usr/bin/env python3
"""Phase 24 of chip_smoke.py alone: the sharded programs over a mesh of
several processes (duckdb_tpu_torch/parallel/shard.ProcessMesh).

    python3 tools/chip_phase24.py                          # gloo, 2 ranks on one card
    python3 tools/chip_phase24.py --backend nccl --world 4  # one card per rank

Builds the grouped-sum kernel, makes chip_smoke.py's SF1 tables (seed 0)
under data/ unless they are there, and runs chip_smoke.process_mesh_phase:
`world` ranks started by spawn, each with two shards, Q1's partial through
the kernel and an all_reduce, the exchange join, the duplicate-key join,
the sharded sort and a TopN of 100, held to numpy. NCCL needs one card per
rank (a host with four cards). Exits non-zero on the
first failure.
"""

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    ap.add_argument("--world", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        return CS.fail("no CUDA device")
    from duckdb_tpu_torch.ops import grouped_sum as GS
    from duckdb_tpu_torch.testing.tpch_gen import TABLE_COLUMNS, write_tables

    card = CS.card_line()
    print(card)
    print(f"{torch.cuda.device_count()} card(s): "
          f"{[torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]}")
    GS.build(True)
    if not all(os.path.exists(os.path.join(CS.DATA, t, "meta.json")) for t in TABLE_COLUMNS):
        write_tables(CS.DATA, CS.SF, CS.SEED)
    launches = {}
    t0 = time.perf_counter()
    bad = CS.process_mesh_phase(card, launches, backend=args.backend, world=args.world)
    if bad:
        return CS.fail(bad)
    print(f"phase 24 took {time.perf_counter() - t0:.1f} s; grouped_sum_i64 launches {launches}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
