#!/usr/bin/env python3
"""Phase 27 of chip_smoke.py alone: H1-H4's forms on a card connection, then
the JAX package's recorded test statements replayed through the port on the
card against the CPU.

    python3 tools/chip_phase27.py

Builds the grouped-sum kernel and runs chip_smoke.replay_phase over the
whole corpus (tests/data/torch_replay/corpus.jsonl.gz): every statement of
a sequence on a card connection and a CPU connection of the port
(testing/replay.py), every grouped-sum launch held to its plain version. Needs no TPC-H data. Exits
non-zero on the first failure.
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
    from duckdb_tpu_torch.ops import grouped_sum as GS

    card = CS.card_line()
    print(card)
    t0 = time.perf_counter()
    GS.build(True)
    print(f"built the kernel in {time.perf_counter() - t0:.1f} s")
    launches, shapes = {}, []
    t0 = time.perf_counter()
    bad = CS.replay_phase(card, launches, shapes, 20)
    if bad:
        return CS.fail(bad)
    for r in shapes:
        print(f"grouped_sum_i64 at {r['query']}'s shape N={r['n']} K={r['k']} nseg={r['nseg']} "
              f"on {card}: kernel {r['kernel_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"index_add_ {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']}")
    print(f"phase 27 took {time.perf_counter() - t0:.1f} s; grouped_sum_i64 launches {launches}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
