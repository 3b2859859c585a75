#!/usr/bin/env python3
"""The appender's ingest into a file database, against the same ingest in memory.

    python3 tools/appender_ingest.py [--rows 1048576]

A flush of the appender (one every 262,144 rows) has no statement text for
the WAL, so in a file database its commit checkpoints the whole database.
This times that on one card. The same Python tuples go into a table
`ap (k BIGINT PRIMARY KEY, v VARCHAR, d DATE, x DECIMAL(12,2))`, as in
phase 21 of chip_smoke.py, three times:

1. in memory;
2. into an empty file database;
3. into a file database that holds chip_smoke.py's lineitem at SF1
   (seed 0, 6,001,215 rows), after a CHECKPOINT of it.

Each flush is timed on its own. The third also times a CHECKPOINT of
lineitem alone, which is what each of its flushes repeats. After each
ingest the table's count and sums are held to Python's. The files are
written under build/, and every read of them is warm. Exits non-zero on
the first failure.
"""

import argparse
import datetime
import decimal
import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402

DB_DIR = os.path.join(ROOT, "build", "appender_ingest")
DAY0 = datetime.date(1992, 1, 1)


def tuples_of(n: int) -> list:
    return [(i, f"v{i % 1000}", DAY0 + datetime.timedelta(days=i % 2500),
             decimal.Decimal(i % 100000).scaleb(-2)) for i in range(n)]


def ingest(con, rows: list) -> list:
    """The rows through the appender in whole flushes → each flush's ms."""
    from duckdb_tpu_torch.api.appender import Appender

    every = Appender.FLUSH_EVERY
    con.sql("CREATE TABLE ap (k BIGINT PRIMARY KEY, v VARCHAR, d DATE, x DECIMAL(12,2))")
    ms = []
    with con.appender("ap") as app:
        for lo in range(0, len(rows), every):
            t0 = time.perf_counter()
            app.append_rows(rows[lo:lo + every])
            app.flush()
            ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def held_to_python(con, rows: list) -> str:
    have = con.sql("SELECT count(*), sum(k), sum(x) FROM ap").rows()[0]
    want = (len(rows), sum(r[0] for r in rows), sum(r[3] for r in rows))
    return "" if have == want else f"ap holds {have}, Python {want}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1 << 20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        return CS.fail("no CUDA device")
    import duckdb_tpu_torch
    from duckdb_tpu_torch.testing.tpch_gen import TABLE_COLUMNS, write_tables

    card = CS.card_line()
    print(card)
    if not all(os.path.exists(os.path.join(CS.DATA, t, "meta.json")) for t in TABLE_COLUMNS):
        write_tables(CS.DATA, CS.SF, CS.SEED)
    rows = tuples_of(args.rows)
    out = {"card": card, "rows": args.rows}
    shutil.rmtree(DB_DIR, ignore_errors=True)
    os.makedirs(DB_DIR)

    def run(label, con):
        ms = ingest(con, rows)
        bad = held_to_python(con, rows)
        if bad:
            raise SystemExit(CS.fail(f"{label}: {bad}"))
        total = sum(ms)
        print(f"appender of {args.rows} rows {label} on {card}: flushes "
              f"{', '.join(f'{m:.3f}' for m in ms)} ms, {total:.3f} ms in all, "
              f"{args.rows / total * 1e3:.0f} rows/s; count and sums equal Python's")
        out[label] = {"flush_ms": ms, "rows_per_s": args.rows / total * 1e3}

    con = duckdb_tpu_torch.connect()
    run("in memory", con)
    con.close()
    con = duckdb_tpu_torch.connect(os.path.join(DB_DIR, "empty"))
    run("into an empty file database", con)
    con.close()
    con = duckdb_tpu_torch.connect(os.path.join(DB_DIR, "lineitem"))
    con.load_tpch(CS.DATA, tables=["lineitem"])
    for label in ("the first (columns read from the generated files)", "again"):
        t0 = time.perf_counter()
        con.sql("CHECKPOINT")
        ck = (time.perf_counter() - t0) * 1e3
        print(f"CHECKPOINT of lineitem at SF1, {label}, on {card}: {ck:.3f} ms")
        out.setdefault("checkpoint_ms", []).append(ck)
    run("into a file database holding lineitem at SF1", con)
    con.close()
    shutil.rmtree(DB_DIR, ignore_errors=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
