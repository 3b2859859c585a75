#!/usr/bin/env python3
"""Outer-join faults of the JAX package, held against the port and SQL's
answers, on the CPU.

    python3 tools/outer_join_reference_probe.py

Makes two 4-row tables, a(k, x) and b(k, y) (and bu(k, y), whose keys are
unique and one is NULL), in both packages, and prints for each query the
rows SQL gives (written out by hand), the JAX package's and the port's
(device="cpu"):
- `a LEFT JOIN b ON a.k = b.k AND a.x > 5`: the JAX package pushes the
  conjunct over the preserved side a into a's input and loses (1, 1, NULL,
  NULL);
- `a FULL JOIN b ON a.k = b.k AND b.y < 300`: the same on b's side loses
  (NULL, NULL, 4, 400);
- `a FULL JOIN bu ON a.k = bu.k`: the JAX package drops the build row whose
  key is NULL;
- `a ANTI JOIN b ON a.k = b.k AND a.x > 5`: the pushed conjunct drops the
  probe row (1, 1), which no match removes;
- two cases the JAX package gets right, for contrast (the conjunct reads
  the side that is not preserved).
Runs the JAX package, so it needs JAX and runs on its CPU platform.
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

A = [(1, 1), (2, 10), (3, 10), (None, 10)]
B = [(1, 100), (2, 200), (2, 201), (4, 400)]
BU = [(1, 100), (2, 200), (4, 400), (None, 500)]
# query → the rows SQL gives
CASES = {
    "SELECT a.k, a.x, b.k, b.y FROM a LEFT JOIN b ON a.k = b.k AND a.x > 5":
        [(1, 1, None, None), (2, 10, 2, 200), (2, 10, 2, 201), (3, 10, None, None),
         (None, 10, None, None)],
    "SELECT a.k, a.x, b.k, b.y FROM a FULL JOIN b ON a.k = b.k AND b.y < 300":
        [(1, 1, 1, 100), (2, 10, 2, 200), (2, 10, 2, 201), (3, 10, None, None),
         (None, None, 4, 400), (None, 10, None, None)],
    "SELECT a.k, a.x, bu.k, bu.y FROM a FULL JOIN bu ON a.k = bu.k":
        [(1, 1, 1, 100), (2, 10, 2, 200), (3, 10, None, None), (None, None, 4, 400),
         (None, 10, None, None), (None, None, None, 500)],
    "SELECT a.k, a.x FROM a ANTI JOIN b ON a.k = b.k AND a.x > 5":
        [(1, 1), (3, 10), (None, 10)],
    "SELECT a.k, a.x, b.k, b.y FROM a RIGHT JOIN b ON a.k = b.k AND a.x > 5":
        [(None, None, 1, 100), (2, 10, 2, 200), (2, 10, 2, 201), (None, None, 4, 400)],
    "SELECT a.k, a.x, b.k, b.y FROM a LEFT JOIN b ON a.k = b.k AND b.y > 150":
        [(1, 1, None, None), (2, 10, 2, 200), (2, 10, 2, 201), (3, 10, None, None),
         (None, 10, None, None)],
}


def _sorted(rows):
    return sorted(rows, key=lambda r: tuple((v is None, v or 0) for v in r))


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    import duckdb_tpu
    import duckdb_tpu_torch
    from duckdb_tpu_torch.catalog.catalog import ColumnDef, TableEntry
    from duckdb_tpu_torch.types import INTEGER

    jcon = duckdb_tpu.connect()
    tcon = duckdb_tpu_torch.connect(device="cpu")
    for name, cols, rows in (("a", ("k", "x"), A), ("b", ("k", "y"), B),
                             ("bu", ("k", "y"), BU)):
        jcon.sql(f"CREATE TABLE {name} ({', '.join(c + ' INTEGER' for c in cols)})")
        jcon.sql(f"INSERT INTO {name} VALUES " + ", ".join(
            "(" + ", ".join("NULL" if v is None else str(v) for v in r) + ")" for r in rows))
        entry = TableEntry(name, [ColumnDef(c, INTEGER) for c in cols])
        entry.nrows = len(rows)
        for col, values in zip(cols, zip(*rows)):
            valid = np.array([v is not None for v in values])
            entry.set_host_column(col, np.array([v or 0 for v in values], dtype=np.int32),
                                  None if valid.all() else valid)
        tcon.catalog.create_table(entry)
    for q, want in CASES.items():
        j = _sorted(jcon.sql(q).rows())
        p = _sorted(tcon.sql(q).rows())
        print(q)
        print(f"  SQL         {len(want)} rows {_sorted(want)}")
        print(f"  JAX package {len(j)} rows {j}  ({'right' if j == _sorted(want) else 'WRONG'})")
        print(f"  port        {len(p)} rows {p}  ({'right' if p == _sorted(want) else 'WRONG'})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
