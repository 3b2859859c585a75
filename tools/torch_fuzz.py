"""Open-ended fuzz sweep through the PyTorch port:
python tools/torch_fuzz.py [n_per_seed] [n_seeds] [--device cuda|cpu].

Prints every non-typed failure with its full SQL (candidates for
tests/test_torch_fuzz.py regressions); exits 1 if there was one. The
counterpart of tools/fuzz.py. The default device is the card, as
duckdb_tpu_torch.connect()'s; pass --device cpu on a host without one.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import duckdb_tpu_torch  # noqa: E402
from duckdb_tpu_torch.testing.fuzz import run_fuzz, setup_connection  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=1000, help="queries per seed")
    ap.add_argument("seeds", nargs="?", type=int, default=10, help="seeds 0 .. seeds-1")
    ap.add_argument("--device", default="cuda", help="the connection's device (default cuda)")
    args = ap.parse_args(argv)
    total = fails = 0
    for seed in range(args.seeds):
        con = setup_connection(duckdb_tpu_torch.connect(device=args.device))
        ok, rej, failures = run_fuzz(args.n, seed=seed, con=con)
        total += args.n
        fails += len(failures)
        print(f"seed={seed}: ok={ok} rejected={rej} failures={len(failures)}", flush=True)
        for sql, e in failures:
            print(f"  {type(e).__name__}: {e}")
            print(f"  SQL: {sql}")
    print(f"TOTAL: {total} queries, {fails} failures")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
