#!/usr/bin/env python3
"""Write the small file fixtures of the port's file readers, with pyarrow.

    python3 tools/make_torch_io_fixtures.py [--out tests/data/torch_io]

The machine with the card has no pyarrow, so these committed files are
the only pyarrow-written input that chip_smoke.py's phase 20 and the card
test read there; tests/test_torch_parquet.py holds the port's reader
against pyarrow on the CPU. Each fixture has `<name>.expected.json` beside
it: {"file", "order_by", "rows"}, the rows as the port's Result.rows()
gives them, with DECIMAL, DATE and TIMESTAMP values tagged
({"decimal": text}, {"date": iso}, {"timestamp": iso}). The expected rows
come from pyarrow's and Python's json's own reading of what was written.
Seeded: running it again writes the same values.
"""

import argparse
import datetime
import decimal
import json
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

N = 200


def _tag(v):
    if isinstance(v, decimal.Decimal):
        return {"decimal": str(v)}
    if isinstance(v, datetime.datetime):
        return {"timestamp": v.replace(tzinfo=None).isoformat(sep=" ")}
    if isinstance(v, datetime.date):
        return {"date": v.isoformat()}
    return v


def _expected(out, name, table: pa.Table, order_by: str):
    cols = []
    for c in table.columns:
        values = c.to_pylist()
        if pa.types.is_timestamp(c.type) and c.type.unit == "ns":
            ints = c.cast(pa.int64()).to_pylist()
            values = [None if v is None else datetime.datetime(1970, 1, 1)
                      + datetime.timedelta(microseconds=v // 1000) for v in ints]
        if pa.types.is_timestamp(c.type) and c.type.tz is not None:
            values = [None if v is None else v.astimezone(datetime.timezone.utc)
                      for v in values]
        cols.append(values)
    key = table.column_names.index(order_by)
    rows = sorted(zip(*cols), key=lambda r: r[key])
    with open(os.path.join(out, f"{name}.expected.json"), "w") as f:
        json.dump({"file": name, "order_by": order_by,
                   "rows": [[_tag(v) for v in r] for r in rows]}, f, indent=0)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tests", "data", "torch_io"))
    out = ap.parse_args().out
    os.makedirs(out, exist_ok=True)
    rng = np.random.default_rng(17)
    dec = decimal.Decimal

    def nulls(values, every):
        return [None if i % every == 0 else v for i, v in enumerate(values)]

    # snappy, dictionary pages, NULLs, several row groups
    t = pa.table({
        "k": pa.array(np.arange(N), pa.int64()),
        "s": pa.array(nulls([f"name {x}" for x in rng.integers(0, 12, N)], 9)),
        "i": pa.array(nulls([int(x) for x in rng.integers(-10**6, 10**6, N)], 7), pa.int32()),
        "f": pa.array([float(x) for x in np.round(rng.standard_normal(N), 6)]),
        "b": pa.array(nulls([bool(x) for x in rng.integers(0, 2, N)], 5)),
        "t8": pa.array(rng.integers(-128, 128, N), pa.int8()),
    })
    pq.write_table(t, os.path.join(out, "snappy_dict.parquet"), compression="snappy",
                   row_group_size=64)
    _expected(out, "snappy_dict.parquet", t, "k")

    # DECIMAL in FIXED_LEN_BYTE_ARRAY (38, 10) and INT32 (9, 2), negatives, gzip
    t = pa.table({
        "k": pa.array(np.arange(N), pa.int32()),
        "d38": pa.array(nulls([dec(int(x)).scaleb(-10) for x in
                               rng.integers(-10**17, 10**17, N)], 11), pa.decimal128(38, 10)),
        "d9": pa.array([dec(int(x)).scaleb(-2) for x in rng.integers(-10**8, 10**8, N)],
                       pa.decimal128(9, 2)),
    })
    pq.write_table(t, os.path.join(out, "decimal_flba.parquet"), compression="gzip",
                   use_dictionary=False)
    _expected(out, "decimal_flba.parquet", t, "k")

    # TIMESTAMP in micros, millis, nanos and with a time zone, DATE; data
    # pages v2
    t = pa.table({
        "k": pa.array(np.arange(N), pa.int64()),
        "ts_us": pa.array(nulls([int(x) for x in rng.integers(0, 2**50, N)], 6),
                          pa.timestamp("us")),
        "ts_ms": pa.array(rng.integers(-2**40, 2**40, N), pa.timestamp("ms")),
        "ts_ns": pa.array(rng.integers(0, 2**60, N), pa.timestamp("ns")),
        "ts_tz": pa.array(rng.integers(0, 2**50, N), pa.timestamp("us", tz="UTC")),
        "day": pa.array(rng.integers(-1000, 20000, N).astype(np.int32), pa.date32()),
    })
    pq.write_table(t, os.path.join(out, "timestamps_v2.parquet"), compression="snappy",
                   data_page_version="2.0")
    _expected(out, "timestamps_v2.parquet", t, "k")

    # newline-delimited JSON: integers, numbers, booleans, text, NULLs and a
    # nested value (VARCHAR JSON text, as the port types it)
    docs = []
    for i in range(N):
        d = {"k": i, "v": float(np.round(rng.random() * 100, 3)), "ok": bool(i % 3),
             "name": f"e{i % 17}"}
        if i % 4 == 0:
            d["tags"] = [int(x) for x in rng.integers(0, 9, 2)]
        if i % 5 == 0:
            d["name"] = None
        docs.append(d)
    with open(os.path.join(out, "events.ndjson"), "w") as f:
        f.write("".join(json.dumps(d) + "\n" for d in docs))
    keys = ["k", "v", "ok", "name", "tags"]
    rows = [[d.get(k) if k != "tags" or k not in d else
             json.dumps(d[k], separators=(",", ":")) for k in keys] for d in docs]
    with open(os.path.join(out, "events.ndjson.expected.json"), "w") as f:
        json.dump({"file": "events.ndjson", "order_by": "k", "rows": rows}, f, indent=0)


if __name__ == "__main__":
    main()
