#!/usr/bin/env python3
"""Two subquery faults of the JAX package, held against the port and
numpy, on the CPU.

    python3 tools/subquery_reference_probe.py [--sf 0.1] [--seed 7] [--data DIR]

Writes the eight tables with the port's seeded generator (into --data,
default data/tpch_gen_sf<sf>_seed<seed>), then prints
- Q21's first rows from the JAX package, the port (device="cpu") and the
  numpy oracle, and a count(*) for each of a few EXISTS / NOT EXISTS forms
  with a `<>` correlation, with and without a local filter in the
  subquery, from both packages and from numpy;
- the customers without orders, and the JAX package's and the port's
  count of customers with `0 = (SELECT count(*) FROM orders WHERE
  o_custkey = c_custkey)` (SQL counts the same customers; the port plans
  the subquery through a LEFT join);
- the JAX package's answers to the correlated NOT IN cases of
  tests/test_torch_tpch_subqueries.py beside SQL's, which the port gives.
Runs the JAX package, so it needs JAX and runs on its CPU platform.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# l3 lines of l1's order from another supplier, with the subquery's filter
_FORMS = {
    "EXISTS, no filter": ("EXISTS", ""),
    "NOT EXISTS, no filter": ("NOT EXISTS", ""),
    "EXISTS, l_orderkey > 0 (always true)": ("EXISTS", "l3.l_orderkey > 0"),
    "EXISTS, late lines": ("EXISTS", "l3.l_receiptdate > l3.l_commitdate"),
    "NOT EXISTS, late lines": ("NOT EXISTS", "l3.l_receiptdate > l3.l_commitdate"),
}


def _numpy_count(t, exists: bool, filt: str) -> int:
    import numpy as np

    from duckdb_tpu_torch.testing.tpch_oracle import _lookup

    k = t("lineitem", "l_orderkey")
    s = t("lineitem", "l_suppkey")
    keep = np.ones(len(k), dtype=bool)
    if filt == "l3.l_receiptdate > l3.l_commitdate":
        keep = t("lineitem", "l_receiptdate") > t("lineitem", "l_commitdate")
    elif filt:
        keep = k > 0
    # per order, the filtered lines; per (order, supplier), the same
    pair = k * (int(s.max()) + 1) + s

    def count_of(keys, sel):
        u, c = np.unique(keys[sel], return_counts=True)
        row = _lookup(u, keys)
        return np.where(row >= 0, c[row], 0)

    other = count_of(k, keep) - count_of(pair, keep) > 0
    return int(other.sum() if exists else (~other).sum())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sf", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--data", default=None)
    args = ap.parse_args()
    data = args.data or os.path.join(ROOT, "data", f"tpch_gen_sf{args.sf}_seed{args.seed}")

    import jax

    jax.config.update("jax_platforms", "cpu")
    import duckdb_tpu
    import duckdb_tpu_torch
    from duckdb_tpu_torch.testing import tpch_oracle
    from duckdb_tpu_torch.testing.tpch_gen import write_tables

    if not os.path.isdir(os.path.join(data, "lineitem")):
        write_tables(data, args.sf, seed=args.seed)
    jcon = duckdb_tpu.connect()
    jcon.load_tpch(data)
    tcon = duckdb_tpu_torch.connect(device="cpu")
    tcon.load_tpch(data)

    sql = tpch_oracle.SUBQUERY_QUERIES["q21"]
    want = tpch_oracle.answer("q21", data)
    for name, rows in (("JAX package", jcon.sql(sql).rows()),
                       ("port", tcon.sql(sql).rows()), ("numpy", want)):
        print(f"q21 SF {args.sf} seed {args.seed}, {name}: {len(rows)} rows, "
              f"equal to numpy {rows == want}, first {rows[:3]}")

    t = tpch_oracle._Tables(data)
    for name, (kind, filt) in _FORMS.items():
        cond = " AND ".join(["l3.l_orderkey = l1.l_orderkey",
                             "l3.l_suppkey <> l1.l_suppkey"] + ([filt] if filt else []))
        q = f"SELECT count(*) FROM lineitem l1 WHERE {kind} (SELECT * FROM lineitem l3 WHERE {cond})"
        j = jcon.sql(q).rows()[0][0]
        p = tcon.sql(q).rows()[0][0]
        n = _numpy_count(t, kind == "EXISTS", filt)
        print(f"{name}: JAX package {j}, port {p}, numpy {n}")

    import numpy as np

    no_orders = int((~np.isin(t("customer", "c_custkey"), t("orders", "o_custkey"))).sum())
    q = ("SELECT count(*) FROM customer WHERE 0 = "
         "(SELECT count(*) FROM orders WHERE o_custkey = c_custkey)")
    print(f"customers without orders: numpy {no_orders}; correlated count(*) = 0: "
          f"JAX package {jcon.sql(q).rows()[0][0]}, port {tcon.sql(q).rows()[0][0]}")

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_torch_tpch_subqueries import BUILD_CORR, PROBE_CORR, SQL_ONLY_CASES

    ncon = duckdb_tpu.connect()
    for name, cols, rows in (("tpc", "id, g, x", PROBE_CORR), ("tbc", "g, y", BUILD_CORR)):
        ncon.sql(f"CREATE TABLE {name} ({', '.join(c + ' INTEGER' for c in cols.split(', '))})")
        ncon.sql(f"INSERT INTO {name} VALUES " + ", ".join(
            "(" + ", ".join("NULL" if v is None else str(v) for v in r) + ")" for r in rows))
    for q, want in SQL_ONLY_CASES.items():
        if "tpc" in q:
            print(f"{q}: SQL {want}, JAX package {ncon.sql(q).rows()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
