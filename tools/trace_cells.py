#!/usr/bin/env python3
"""Split the benchmark's cells by the program's own spans, on one CUDA card.

    python3 tools/trace_cells.py [--cells NAME ...] [--seed S] [--pairs 4]
        [--profiled 1] [--total-mbp X] [--device cuda:0] [--out PATH]

For each cell of BENCHMARK.json (all of them by default) the collection is
generated from the seed as mumbench/run.py does, and engine.find_matches
is called on it:

- a cold call and a warm one with tracing on (mumemto_tpu_torch.trace):
  each call's stages and the load spans (kernels.load, native.load),
  seconds by span name, logged to stderr;
- one call under the engine's phase hook, which synchronizes the card at
  each stage's end: each stage's seconds and the peak of allocated device
  memory inside it (the peak statistics reset at each stage's start), so
  the stage that sets a cell's peak_gib is named;
- `--pairs` pairs of calls, tracing off then on, each timed to the card's
  end: the median wall of each and what tracing costs (and, once, the
  host time of one span with tracing off, on, and on under a recording
  profiler);
- `--profiled` calls under torch.profiler with no enable(), as the
  benchmark's traced window makes them (a call opened under a recording
  profiler is traced): seconds per call by span, the busiest card's idle
  inside each span (mumbench/spans.py), the idle-gap painting of
  mumbench/run.py's breakdown with the share left to "host code outside
  torch operations" and the share painted only by the root span,
  engine.readbacks against the trace's device-to-host copies (in total,
  and by the innermost span and torch operation of each copy's launch).

One JSON line per cell on stdout, and the whole record in the file --out
(trace_cells.json). --total-mbp cuts the collection (a CPU run with
--device cpu is plumbing only: it has no device events).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "mumbench")
for _p in (ROOT, BENCH):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import run  # noqa: E402
import spans as bench_spans  # noqa: E402


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def collection(cell: str, seed: int, total_mbp=None):
    """(rb, opts, config, mix) of the cell, as mumbench/run.py makes them."""
    import numpy as np
    from mumemto_tpu_torch import options
    from mumemto_tpu_torch.refbuilder import RefBuilder, revcomp
    spec = run.cell_spec(cell)
    config = dict(spec["config"])
    if total_mbp:
        config["total_mbp"] = total_mbp
    docs = run.generate(config, seed)
    dollar = np.frombuffer(b"$", np.uint8)
    pieces, seq_lengths = [], []
    for fwd in docs:
        pieces += [fwd, dollar, revcomp(fwd), dollar]
        seq_lengths.append(2 * (fwd.size + 1))
    rb = RefBuilder(text=np.concatenate(pieces), seq_lengths=seq_lengths,
                    num_docs=len(docs), use_revcomp=True, input_files=[],
                    multifasta_names=[], multifasta_lengths=[])
    opts = options.normalize(len(docs), quiet=True,
                             min_match_len=config["min_len"],
                             **spec["mix"]["options"])
    return rb, opts, config, spec["mix"]


def by_name(kept: dict) -> dict:
    """Seconds by span name, and the number of spans, of drained records."""
    got = collections.defaultdict(float)
    for s in kept["spans"]:
        if s["end_ns"] is not None:
            got[s["name"]] += (s["end_ns"] - s["start_ns"]) / 1e9
    return {k: round(v, 6) for k, v in sorted(got.items(),
                                               key=lambda kv: -kv[1])}


def copies_by_site(events: list) -> dict:
    """The device-to-host copies of a trace by (innermost span, innermost
    torch operation) around the CUDA call that launched each."""
    runtime = {}
    host = collections.defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat == "cuda_runtime" and "correlation" in e.get("args", {}):
            runtime[e["args"]["correlation"]] = e
        elif cat in ("cpu_op", "user_annotation"):
            host[e.get("tid")].append(e)
    sites = collections.Counter()
    for e in events:
        if not (e.get("cat") == "gpu_memcpy" and "DtoH" in e.get("name", "")):
            continue
        r = runtime.get(e.get("args", {}).get("correlation"))
        if r is None:
            sites[("?", "?")] += 1
            continue
        t = float(r["ts"])
        inner = {"cpu_op": (None, float("inf")),
                 "user_annotation": (None, float("inf"))}
        for h in host[r.get("tid")]:
            a, d = float(h["ts"]), float(h.get("dur", 0))
            if a <= t <= a + d and d < inner[h["cat"]][1]:
                inner[h["cat"]] = (h["name"], d)
        sites[(inner["user_annotation"][0], inner["cpu_op"][0])] += 1
    return {f"{k[0]} | {k[1]}": v for k, v in sites.most_common()}


def span_cost(n: int = 20000) -> dict:
    """Host nanoseconds of one span (enter and exit, a count inside it)
    with tracing off, on, and on under a recording torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    from mumemto_tpu_torch import trace

    def loop():
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with trace.span("cost"):
                trace.count("cost")
        return (time.perf_counter_ns() - t0) / n
    out = {"off_ns": loop()}
    trace.enable()
    with trace.call("cost.root"):
        out["on_ns"] = loop()
        with profile(activities=[ProfilerActivity.CPU]):
            out["on_profiled_ns"] = loop()
    trace.disable()
    trace.drain()
    return {k: round(v, 1) for k, v in out.items()}


def one_cell(cell: str, seed: int, pairs: int, profiled: int, dev,
             total_mbp=None) -> dict:
    import torch
    from mumemto_tpu_torch import engine, trace
    rb, opts, config, mix = collection(cell, seed, total_mbp)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def call():
        t0 = time.perf_counter()
        engine.find_matches(rb, opts, device=dev, pfp_w=config["w"],
                            pfp_mod=config["mod"], backend=mix["backend"],
                            show_progress=False)
        sync()
        return time.perf_counter() - t0

    out = {"cell": cell, "seed": seed, "n_text": int(rb.text.size)}
    # set-up: cold then warm, traced
    for label in ("cold", "warm"):
        trace.enable()
        wall = call()
        trace.disable()
        kept = trace.drain()
        split = by_name(kept)
        out[label] = {"wall_s": round(wall, 4), "spans_s": split,
                      "n_spans": len(kept["spans"])}
        log(f"[trace_cells] {cell} {label} call {wall:.3f} s: "
            + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))

    # each stage's seconds and peak, the card synchronized at its end
    stages = {}
    mark = [time.perf_counter()]

    def hook(name):
        sync()
        now = time.perf_counter()
        peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
        stages[name] = {"s": round(now - mark[0], 4),
                        "peak_gib": round(peak / 2**30, 3)}
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        mark[0] = time.perf_counter()
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    mark[0] = time.perf_counter()
    engine.find_matches(rb, opts, device=dev, pfp_w=config["w"],
                        pfp_mod=config["mod"], backend=mix["backend"],
                        phase=hook, show_progress=False)
    out["stages"] = stages
    log(f"[trace_cells] {cell} stages (s, peak GiB): " + ", ".join(
        f"{k} {v['s']:.3f} {v['peak_gib']:.3f}" for k, v in stages.items()))

    # what tracing costs: off, on, off, on ...
    walls = {"off": [], "on": []}
    for _ in range(pairs):
        walls["off"].append(call())
        trace.enable()
        walls["on"].append(call())
        trace.disable()
        trace.drain()
    if pairs:
        med = {k: statistics.median(v) for k, v in walls.items()}
        out["cost"] = {"walls_off_s": [round(w, 4) for w in walls["off"]],
                       "walls_on_s": [round(w, 4) for w in walls["on"]],
                       "median_off_s": round(med["off"], 4),
                       "median_on_s": round(med["on"], 4),
                       "on_over_off_pct": round(
                           100 * (med["on"] / med["off"] - 1), 3)}
        log(f"[trace_cells] {cell} tracing off / on: {med['off']:.4f} / "
            f"{med['on']:.4f} s a call ({out['cost']['on_over_off_pct']}%)")
    if not profiled:
        return out

    # the benchmark's traced window: calls under the profiler, no enable()
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if on_card else [])
    prof = profile(activities=acts)
    prof.start()
    try:
        t0 = time.perf_counter()
        for _ in range(profiled):
            call()
        window = time.perf_counter() - t0
    finally:
        prof.stop()
    kept = trace.drain()
    summed = bench_spans.summed(kept)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        painted = run.read_trace(path)
    finally:
        os.remove(path)
    n = summed["traced_calls"]
    gaps = painted["idle_gaps"]
    gap_s = sum(v[0] for v in gaps.values())
    busy = max(painted["busy_s"].values()) if painted["busy_s"] else 0.0
    d2h = sum(1 for e in events if e.get("cat") == "gpu_memcpy"
              and "DtoH" in e.get("name", ""))
    idle = bench_spans.span_idle(events)
    out["profiled"] = {
        "calls": n, "window_s": round(window, 4),
        "idle_pct": round(100 * (1 - busy / window), 3) if window else None,
        "spans_s_per_call": {k: round(v / n, 6) for k, v in sorted(
            summed["spans"].items(), key=lambda kv: -kv[1])},
        "idle_s_per_call": {k: round(v / n, 6) for k, v in sorted(
            idle.items(), key=lambda kv: -kv[1])},
        "readbacks_per_call": summed["counters"].get(trace.READBACKS, 0) / n,
        "d2h_copies_per_call": d2h / n,
        "d2h_by_site": copies_by_site(events),
        "gap_s": round(gap_s, 6),
        "gaps_outside_pct": round(100 * gaps.get(run.OUTSIDE, [0])[0]
                                  / gap_s, 3) if gap_s else None,
        "gaps_root_only_pct": round(100 * gaps.get(bench_spans.ROOT, [0])[0]
                                    / gap_s, 3) if gap_s else None,
        "gaps_by_name": {k: round(v[0], 6) for k, v in sorted(
            gaps.items(), key=lambda kv: -kv[1][0])[:15]},
        "spans_per_call": len(kept["spans"]) / n,
    }
    p = out["profiled"]
    log(f"[trace_cells] {cell} profiled: idle {p['idle_pct']}%, readbacks "
        f"{p['readbacks_per_call']} vs D2H copies {p['d2h_copies_per_call']}"
        f" a call; gaps outside {p['gaps_outside_pct']}%, root only "
        f"{p['gaps_root_only_pct']}%")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", nargs="*")
    ap.add_argument("--seed", type=int, default=2**32 + 16001)
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--profiled", type=int, default=1)
    ap.add_argument("--total-mbp", type=float)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out", default="trace_cells.json",
                    help="the report's path")
    args = ap.parse_args(argv)
    import torch
    dev = torch.device(args.device)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cells = args.cells or [w["name"] for w in json.load(f)["workloads"]]
    card = {"torch": torch.__version__, "cuda": torch.version.cuda}
    if dev.type == "cuda":
        card["name"] = torch.cuda.get_device_name(dev)
        try:
            card["power_limit"] = subprocess.run(
                ["nvidia-smi", "--query-gpu=power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=60).stdout.strip()
        except (OSError, subprocess.TimeoutExpired):
            card["power_limit"] = "not read"
    card["span_cost"] = span_cost()
    log(f"[trace_cells] {card}")
    report = {"card": card, "cells": []}
    for i, cell in enumerate(cells):
        rec = one_cell(cell, args.seed + i, args.pairs, args.profiled, dev,
                       args.total_mbp)
        report["cells"].append(rec)
        line = {"cell": cell, "cold_s": rec["cold"]["wall_s"],
                "warm_s": rec["warm"]["wall_s"], "cost": rec.get("cost")}
        if "profiled" in rec:
            line["profiled"] = {k: rec["profiled"][k] for k in (
                "idle_pct", "readbacks_per_call", "d2h_copies_per_call",
                "gaps_outside_pct", "gaps_root_only_pct")}
        print(json.dumps(line), flush=True)
        if os.path.dirname(args.out):
            os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
