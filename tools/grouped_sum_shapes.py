#!/usr/bin/env python3
"""Time the grouped int64 sum's wrapper call by call at the shapes the
kernel's first design never aimed at: small inputs, sparse live rows, int64
slot ids and vectors that are views off a 16-byte boundary.

    python3 tools/grouped_sum_shapes.py [--root DIR ...] [--crossover] [--variants]
        [--json FILE]

For each shape it prints the device launches of one wrapper call and their
names (torch.profiler), the kernel's own device time per call (the
profiler's kernel events), the whole call's device time (CUDA events after a
spin of the card, as chip_smoke.cuda_ms), the host's enqueue time per call
(host clock while the card spins), the bytes bound both as chip_smoke.py
counts it now (ids at their own width) and at 4 bytes an id, and one
index_add_ over a stacked matrix with remapped ids. Every call is checked
bit for bit against the plain version.

Several --root checkouts (this one by default) are timed in turns, each in
a process of its own, in the order given and then reversed (A B B A), so
that two commits compare on one card. --crossover also times the single
regime (one block per group of vectors) against the persistent grid at
growing N, to place the threshold; --variants times the small regime's
group of vectors against the next larger where K is not a multiple of it.
Both force a plan by standing in for the wrapper's `launch_plan` (in a
checkout that has the single regime). Needs a CUDA device and nvcc;
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

Q1_N = 6_291_456
# (name, n, k, nseg, live share or live row count, live slots, id dtype,
# row offset or (the ids' offset, the vectors'))
SHAPES = (
    ("q1", Q1_N, 16, 20, 0.9405, (0, 1, 4, 5), "int32", 0),
    ("spill_4mb_chunk", 32_768, 19, 20, 1.0, None, "int32", 1),
    ("spill_4mb_chunk_aligned", 32_768, 19, 20, 1.0, None, "int32", 0),
    ("ooc_q1_merge", 128, 23, 20, 1.0, None, "int32", 0),
    ("cross_small", 128, 4, 7, 1.0, None, "int32", 0),
    ("q22_occupancy", 7_168, 1, 26, 0.5, None, "int64", 0),
    ("q22_count", 7_168, 1, 7, 0.9, None, "int64", 0),
    ("q22_sum_halves", 7_168, 2, 7, 0.9, None, "int64", 0),
    ("nested_pack_agg", 10_240, 1, 26, 1.0, None, "int32", 0),
    ("replay_16", 16, 1, 1, 1.0, None, "int32", 0),
    ("replay_1024", 1_024, 4, 8, 0.8, None, "int64", 0),
    ("replay_65536", 65_536, 8, 16, 0.9, None, "int32", 0),
    ("replay_229376", 229_376, 2, 5, 0.9, None, "int64", 0),
    ("q6", Q1_N, 3, 1, 0.0174, None, "int32", 0),
    ("q19", Q1_N, 3, 1, 0.0001, None, "int32", 0),
    ("q4", 1_572_864, 2, 7, 0.9, None, "int32", 0),
    ("q11", 917_504, 3, 1, 0.9, None, "int32", 0),
    ("sample_rows", Q1_N, 2, 1, 100_000, None, "int32", 0),
    ("general_k1", Q1_N, 1, 12, 0.98, None, "int64", 0),
    ("general_k2", Q1_N, 2, 7, 0.98, None, "int64", 0),
    ("win_rank_lineitem", Q1_N, 5, 20, 1_499_535, None, "int32", 0),
    ("notin_residual", Q1_N, 4, 1, 1_531_141, None, "int32", 0),
    ("q9", 327_680, 4, 216, 0.9, None, "int32", 0),
    ("nested_words", 1_048_576, 2, 95, 1.0, None, "int32", 0),
    ("recursive_months", 1_572_864, 2, 85, 1.0, None, "int32", 0),
    ("win_median_part", 229_376, 3, 27, 1.0, None, "int32", 0),
    ("mixed_alignment_1000", 1_000, 4, 20, 0.9, None, "int32", (0, 1)),
    ("mixed_alignment_100000", 100_000, 5, 20, 0.9, None, "int64", (0, 1)),
)
# (k, nseg) pairs and the N at which --crossover times both regimes
CROSS_KN = ((1, 7), (2, 26), (4, 20), (16, 20), (19, 20))
CROSS_N = (128, 512, 1_024, 1_536, 2_048, 4_096, 8_192)


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_inputs(torch, n, k, nseg, live, slots, dtype, offset, seed):
    """Slot ids (dead ones -1 or past nseg) and k vectors whose dead rows
    hold full-range junk; with offset > 0 every tensor is a view that
    starts `offset` rows into a larger one (an (ids, vectors) pair of
    offsets sets them apart)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n_live = int(live if live > 1 else round(live * n))
    ids_at, offset = offset if isinstance(offset, tuple) else (offset, offset)
    total = n + max(ids_at, offset)
    keep = torch.zeros(total, dtype=torch.bool, device="cuda")
    keep[ids_at + torch.randperm(n, generator=gen, device="cuda")[:n_live]] = True
    if slots is None:
        ids = torch.randint(0, nseg, (total,), generator=gen, device="cuda")
    else:
        pick = torch.randint(0, len(slots), (total,), generator=gen, device="cuda")
        ids = torch.tensor(slots, device="cuda")[pick]
    junk = torch.randint(0, 2, (total,), generator=gen, device="cuda")
    dead_id = torch.where(junk == 0, -1, nseg + 1)
    dense = torch.where(keep, ids, dead_id).to(getattr(torch, dtype))[ids_at:ids_at + n]
    vecs = [torch.randint(-(2**63 - 1), 2**63 - 1, (total,), generator=gen, device="cuda",
                          dtype=torch.int64)[offset:offset + n] for _ in range(k)]
    return dense, vecs


def device_ops(fn, calls: int = 1, launched=None):
    """The device events (kernels, copies, fills) of `calls` calls of fn
    after a warm one, by torch.profiler, or None where every one of 5
    traces lost events. A marker kernel (torch.cuda._sleep's spin_kernel)
    runs first in each trace and is left out: a trace without it lost
    events, and so does one with fewer grouped_sum kernels than
    `launched()` (the wrapper's launch count) rose by; such a trace is
    taken again after a pause."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(5):
        before = launched() if launched is not None else 0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        ours = [e for e in events if "spin_kernel" not in e.name]
        whole = len(ours) < len(events) and (
            launched is None
            or sum("grouped_sum" in e.name for e in ours) >= launched() - before)
        if whole:
            return ours
        time.sleep(0.05 * (attempt + 1))
    return None


def profile_call(GS, fn, calls):
    """(device launches per call, their names, kernel device µs per call),
    None for each where the profiler lost events in every trace."""
    events = device_ops(fn, calls, launched=lambda: GS.grouped_sum_i64.launches)
    if events is None:
        return None, [], None
    names = sorted({e.name[:60] for e in events})
    kernel_us = sum(e.time_range.elapsed_us() for e in events if "grouped_sum" in e.name)
    return len(events) / calls, names, kernel_us / calls


def host_us(torch, fn, reps):
    """Host µs to enqueue one call while the card spins ahead of it."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000 * max(1, reps // 10))
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e6


def one_root(root: str, crossover: bool, variants: bool = False) -> list:
    import torch

    CS = load_chip_smoke()
    sys.path.insert(0, root)
    from duckdb_tpu_torch.ops import grouped_sum as GS

    t0 = time.perf_counter()
    GS.build(force=True)
    print(f"[{root}] built in {time.perf_counter() - t0:.1f} s", flush=True)
    rows = []
    for seed, (name, n, k, nseg, live, slots, dtype, offset) in enumerate(SHAPES):
        dense, vecs = make_inputs(torch, n, k, nseg, live, slots, dtype, offset, seed)
        call = lambda: GS.grouped_sum_i64(dense, vecs, nseg)  # noqa: E731
        err = CS.max_abs_err(call(), GS.grouped_sum_i64_plain(dense, vecs, nseg))
        reps = 50 if n >= 1 << 20 else 200
        launches, names, kernel_us = profile_call(GS, call, 10)
        call_ms = CS.cuda_ms(call, reps)
        enqueue_us = host_us(torch, call, reps)
        bound_ms, _, bytes_now, _ = CS.bound_of(dense, vecs, nseg)
        n_live = int(((dense >= 0) & (dense < nseg)).sum())
        bytes_old = n * 4 + n_live * 8 * k + nseg * k * 8
        d64 = dense.to(torch.int64)
        d64 = torch.where((d64 < 0) | (d64 >= nseg), nseg, d64)
        mat = torch.stack(vecs, dim=1)
        acc = torch.zeros((nseg + 1, k), dtype=torch.int64, device="cuda")
        library_ms = CS.cuda_ms(lambda: acc.index_add_(0, d64, mat), reps)
        narrow = getattr(GS.grouped_sum_i64, "narrow_launches", 0)
        call()
        narrow = getattr(GS.grouped_sum_i64, "narrow_launches", 0) - narrow
        row = {"root": root, "name": name, "n": n, "k": k, "nseg": nseg, "ids": dtype,
               "offset": offset, "narrow_launches": narrow, "live_share": n_live / max(n, 1), "max_abs_err": err,
               "launches_per_call": launches, "device_ops": names,
               "kernel_us": kernel_us, "call_ms": call_ms, "host_us": enqueue_us,
               "bound_ms": bound_ms, "bound_ms_4b_ids": bytes_old / CS.HBM_BYTES_PER_S * 1e3,
               "roofline": bound_ms / call_ms, "index_add_ms": library_ms}
        if hasattr(GS, "launch_plan"):
            try:
                row["regime"] = GS.launch_plan(nseg, k, n).regime
            except TypeError:
                row["regime"] = GS.launch_plan(nseg, k).regime
        print(f"[{os.path.basename(root)}] {name} N={n} K={k} nseg={nseg} ids {dtype} "
              f"offset {offset} live {100 * row['live_share']:.2f}%: err {err}, "
              f"{'not measured' if launches is None else f'{launches:g}'} device ops/call "
              f"{names}, kernel "
              f"{'not measured' if kernel_us is None else f'{kernel_us:.2f} µs'}, call "
              f"{call_ms:.4f} ms, host {enqueue_us:.1f} µs/call, bound {bound_ms:.4f} ms "
              f"({bound_ms / call_ms:.1%}; 4-byte ids {row['bound_ms_4b_ids']:.4f}), "
              f"index_add_ {library_ms:.4f} ms, regime {row.get('regime')}, "
              f"{narrow} launches of 8-byte loads", flush=True)
        if err:
            raise SystemExit(f"{name}: kernel disagrees with the plain version")
        rows.append(row)
        del dense, vecs, mat, d64, acc
    if crossover and hasattr(GS, "SINGLE_MAX_ROWS"):
        rows += crossover_rows(torch, CS, GS, root)
    if variants and hasattr(GS, "SINGLE_MAX_ROWS"):
        rows += variant_rows(torch, CS, GS, root)
    return rows


def forced(GS, plan, fn):
    """fn() with every launch planned as `plan` (the wrapper's launch_plan
    stood in for while it runs)."""
    chosen = GS.launch_plan
    GS.launch_plan = lambda nseg, k, n=None: plan._replace(vectors=min(k, plan.vectors))
    try:
        return fn()
    finally:
        GS.launch_plan = chosen


def crossover_rows(torch, CS, GS, root):
    """The single regime against the persistent grid (small) at each
    CROSS_N: one device time per regime, forced."""
    out = []
    for k, nseg in CROSS_KN:
        for n in CROSS_N:
            dense, vecs = make_inputs(torch, n, k, nseg, 0.9, None, "int32", 0, n + k)
            want = GS.grouped_sum_i64_plain(dense, vecs, nseg)
            persistent = GS.launch_plan(nseg, k)
            plans = {"single": persistent._replace(regime="single"), "persistent": persistent}
            times = {}
            for regime, plan in plans.items():
                call = lambda: GS.grouped_sum_i64(dense, vecs, nseg)  # noqa: E731
                if CS.max_abs_err(forced(GS, plan, call), want):
                    raise SystemExit(f"crossover {regime} N={n} K={k}: kernel disagrees")
                times[regime] = forced(GS, plan, lambda: CS.cuda_ms(call, 100))
            print(f"[{os.path.basename(root)}] crossover N={n} K={k} nseg={nseg}: single "
                  f"{times['single']:.4f} ms, persistent {times['persistent']:.4f} ms",
                  flush=True)
            out.append({"root": root, "crossover": True, "n": n, "k": k, "nseg": nseg,
                        **{f"{r}_ms": t for r, t in times.items()}})
    return out


# shapes at which --variants times the small regime's groups of vectors:
# the plan's, and where K is not a multiple of it the next larger (ids read
# once for K <= 4, at the cost of registers for the unused vectors)
VARIANT_SHAPES = ("q1", "q6", "q19", "q11", "spill_4mb_chunk_aligned", "win_rank_lineitem")


def variant_rows(torch, CS, GS, root):
    """Device ms of the plan's group and the next larger at VARIANT_SHAPES."""
    out = []
    for seed, (name, n, k, nseg, live, slots, dtype, offset) in enumerate(SHAPES):
        if name not in VARIANT_SHAPES:
            continue
        dense, vecs = make_inputs(torch, n, k, nseg, live, slots, dtype, offset, seed)
        want = GS.grouped_sum_i64_plain(dense, vecs, nseg)
        base = GS.launch_plan(nseg, k, n)
        groups = [base.group] + [g for g in GS.GROUPS if g > base.group][-1:] \
            if k % base.group else [base.group]
        times = {}
        for group in groups:
            smem = GS.WARPS * 32 * 8 * (nseg + 1) * group
            if smem > GS.SMEM_BLOCK_MAX:
                continue
            plan = base._replace(group=group, smem=smem)
            call = lambda: GS.grouped_sum_i64(dense, vecs, nseg)  # noqa: E731
            if CS.max_abs_err(forced(GS, plan, call), want):
                raise SystemExit(f"variant {name} G={group}: kernel disagrees with the plain "
                                 "version")
            times[f"G{group}"] = forced(
                GS, plan, lambda: CS.cuda_ms(call, 50 if n >= 1 << 20 else 200))
        print(f"[{os.path.basename(root)}] variants {name} N={n} K={k} nseg={nseg} ids {dtype}: "
              + ", ".join(f"{v} {t:.4f} ms" for v, t in times.items()), flush=True)
        out.append({"root": root, "variants": True, "name": name, "n": n, "k": k,
                    "nseg": nseg, "ids": dtype, **{f"{v}_ms": t for v, t in times.items()}})
        del dense, vecs, want
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", action="append")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--crossover", action="store_true")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--json", help="write every row to this file")
    args = ap.parse_args()
    if args.one:
        rows = one_root(os.path.abspath(args.one), args.crossover, args.variants)
        print("ROWS " + json.dumps(rows))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("grouped_sum_shapes: needs a CUDA device", file=sys.stderr)
        return 1
    CS = load_chip_smoke()
    print(f"card: {CS.card_line()}", flush=True)
    roots = [os.path.abspath(r) for r in (args.root or [HERE])]
    order = roots + roots[::-1] if len(roots) > 1 else roots
    rows = []
    for root in order:
        cmd = [sys.executable, os.path.abspath(__file__), "--one", root]
        if args.crossover:
            cmd.append("--crossover")
        if args.variants:
            cmd.append("--variants")
        proc = subprocess.run(cmd, capture_output=True, text=True)
        for line in proc.stdout.splitlines():
            if line.startswith("ROWS "):
                rows += json.loads(line[5:])
            else:
                print(line)
        if proc.returncode:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": CS.card_line(), "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
