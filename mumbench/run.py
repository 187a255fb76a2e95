"""Run one cell of the benchmark once and print its result.

    python mumbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

A cell is an entry of `workloads` in BENCHMARK.json: a configuration
(mumbench/configs/<config>.json, the collection and its parse settings,
made by mumbench/generators/<generator>.py from the seed) under a traffic
mix (mumbench/mixes/<traffic>.json, the match options and the backend).
The run generates the collection, hands it to the program
(mumemto_tpu_torch.engine.find_matches, on cuda:0) as a RefBuilder, makes
a cold call and a warm one, and then calls it in a closed loop, one
caller, until --seconds have passed; the last call is counted whole. With --trace 0
the metrics are the cell's end-to-end ones. With --trace 1 the window is
split in two: first calls under the engine's stage hook (which
synchronizes the card at each stage), then calls under torch.profiler
with no hook; the metrics are the cell's per-layer ones, read from those
records by mumbench/metrics/<metric>.py.

Once the window has closed, every call's match set is compared with the
plain reference (mumbench/reference.py) on the same documents: `correct`
is true when no call failed and every call's set equals the reference's.

The last line of stdout is one JSON object: correct, attempted, failed,
metrics, device, with --trace 1 breakdown, and last `checks`, each number
compared with its limit (also the last lines of stderr). Without a CUDA
card, or with fewer cards than the cell asks for, the run exits 2 and
prints no result; it exits 1 with no result if jax, jaxlib, flax or
mumemto_tpu is loaded in the process once everything else has run.
"""

import time

T_START = time.perf_counter()  # set-up is timed from the process's start

import argparse  # noqa: E402
import collections  # noqa: E402
import gc  # noqa: E402
import hashlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for _p in (ROOT, HERE):  # the program, and the benchmark's own modules
    if _p not in sys.path:
        sys.path.insert(0, _p)
from records import load_module  # noqa: E402

BANNED = ("jax", "jaxlib", "flax", "mumemto_tpu")
TOP_ENTRIES = 10
LONGEST_GAPS = 500  # the idle gaps that are named by the host's operation

# build and kernel caches at fixed paths inside the checkout
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ.setdefault(_var, os.path.join(ROOT, ".mumbench_cache", _sub))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def cell_spec(workload: str) -> dict:
    """The cell's entry in BENCHMARK.json with its configuration, its mix
    and the metrics it reports: {"cell", "config", "mix", "end_to_end",
    "per_layer"}."""
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}: "
                         f"{', '.join(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(ROOT, configs[cell["config"]]["file"]))
    mix = load_json(os.path.join(HERE, "mixes", cell["traffic"] + ".json"))

    def mine(metrics):
        return [m for m in metrics
                if workload in m.get("workloads", [workload])]
    return {"cell": cell, "config": config, "mix": mix,
            "end_to_end": mine(bench["end_to_end"]),
            "per_layer": mine(bench["per_layer"])}


def generate(config: dict, seed: int):
    """The configuration's documents (uint8 arrays) from the seed."""
    gen_dir = os.path.join(HERE, "generators")
    if gen_dir not in sys.path:
        sys.path.insert(0, gen_dir)
    gen = load_module(os.path.join(gen_dir, config["generator"] + ".py"),
                  config["generator"])
    return gen.generate(config, seed)


def reference_options(config: dict, mix: dict) -> dict:
    o = mix["options"]
    return {"min_len": config["min_len"], "k": o["num_distinct_docs"],
            "f": o["rare_freq"], "F": o["max_mem_freq"]}


def parse_output(data: bytes, mum_mode: bool) -> list:
    """The match set of .mums or .mems bytes, as reference.match_set
    gives it: (L, offsets, strands) or (L, positions, docs, strands)."""
    out = []
    for line in data.decode().splitlines():
        f = line.split("\t")
        if mum_mode:
            out.append((int(f[0]),
                        tuple(int(x) if x else -1 for x in f[1].split(",")),
                        tuple(f[2].split(","))))
        else:
            out.append((int(f[0]), tuple(int(x) for x in f[1].split(",")),
                        tuple(int(x) for x in f[2].split(",")),
                        tuple(f[3].split(","))))
    return out


def mismatches(got: list, want: list) -> int:
    """Matches in one set and not in the other, counted with repeats."""
    a, b = collections.Counter(got), collections.Counter(want)
    return sum(((a - b) + (b - a)).values())


def result_digest(out) -> bytes:
    """A digest of everything a call's output bytes are made from: the
    match arrays in MUM mode, the emitted lines in MEM mode."""
    import numpy as np
    h = hashlib.blake2b()
    if out.opts.mum_mode:
        for a in (out.lengths, out.offsets, out.strands):
            a = np.ascontiguousarray(a)
            h.update(f"{a.dtype.str}{a.shape}".encode())
            h.update(a.tobytes())
    else:
        for line in out.mem_lines:
            h.update(len(line).to_bytes(8, "little"))
            h.update(line)
    return h.digest()


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


# --- the profiler's trace --------------------------------------------------

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


def short_name(name: str, width: int = 160) -> str:
    """A kernel's name without its argument list, at most `width` long."""
    depth = 0
    for i, ch in enumerate(name):
        if ch in "<{":
            depth += 1
        elif ch in ">}":
            depth -= 1
        elif (ch == "(" and depth == 0 and i > 0 and name[i - 1] != " "
              and not name.startswith("(anonymous namespace)", i)):
            name = name[:i]
            break
    return name[:width]


def _union(spans):
    runs = []
    for a, b in sorted(spans):
        if runs and a <= runs[-1][1]:
            runs[-1][1] = max(runs[-1][1], b)
        else:
            runs.append([a, b])
    return runs


def _paint(g0, g1, ops):
    """Seconds of the interval [g0, g1] (us) under each of `ops` [(start,
    end, name)], the innermost (shortest) first; the rest of it under
    OUTSIDE."""
    free = [(g0, g1)]
    got = collections.defaultdict(float)
    for a, b, name in sorted(ops, key=lambda o: o[1] - o[0]):
        left = []
        for f0, f1 in free:
            lo, hi = max(f0, a), min(f1, b)
            if lo < hi:
                got[name] += (hi - lo) / 1e6
                left += [iv for iv in ((f0, lo), (hi, f1)) if iv[0] < iv[1]]
            else:
                left.append((f0, f1))
        free = left
    rest = sum(f1 - f0 for f0, f1 in free) / 1e6
    if rest > 0:
        got[OUTSIDE] += rest
    return got


OUTSIDE = "host code outside torch operations"


def read_trace(path: str) -> dict:
    """From a chrome trace of torch.profiler: each card's busy seconds (the
    union of its kernel, copy and memset spans), the device operations'
    seconds and launches by (shortened) name, and the seconds of the
    busiest card's longest idle gaps by what the host was doing meanwhile:
    the innermost torch operation or CUDA call running at each instant, or
    none (host code outside torch operations), with the number of gaps
    each name was seen in."""
    import numpy as np
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    by_card, ops, host = {}, {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        a = float(e["ts"])
        b = a + float(e.get("dur", 0))
        if cat in DEVICE_CATS and "device" in e.get("args", {}):
            by_card.setdefault(int(e["args"]["device"]), []).append((a, b))
            tot = ops.setdefault(short_name(e.get("name", "?")), [0.0, 0])
            tot[0] += (b - a) / 1e6
            tot[1] += 1
        elif cat in HOST_CATS:
            host.append((a, b, e.get("name", "?")))
    runs = {c: _union(s) for c, s in by_card.items()}
    busy = {c: sum(b - a for a, b in r) / 1e6 for c, r in runs.items()}
    gaps = []
    if runs:
        r = runs[max(busy, key=busy.get)]
        gaps = sorted(((r[i][1], r[i + 1][0]) for i in range(len(r) - 1)),
                      key=lambda g: g[0] - g[1])[:LONGEST_GAPS]
    hs = np.array([h[0] for h in host])
    he = np.array([h[1] for h in host])
    named = collections.defaultdict(lambda: [0.0, 0])
    for g0, g1 in gaps:
        near = np.flatnonzero((hs < g1) & (he > g0)) if host else []
        for name, sec in _paint(g0, g1, [host[i] for i in near]).items():
            named[name][0] += sec
            named[name][1] += 1
    return {"busy_s": busy, "device_ops": ops, "idle_gaps": dict(named)}


# --- the run ---------------------------------------------------------------

def execute(workload: str, seed: int, seconds: float, trace: int,
            device: str = "cuda:0", config_override: dict = None,
            find=None):
    """One run of a cell; returns (result, checks). config_override
    replaces configuration values (the tests' small sizes); find stands
    in for the program's find_matches (the tests' planted faults)."""
    import numpy as np
    import torch

    spec = cell_spec(workload)
    config = dict(spec["config"], **(config_override or {}))
    mix = spec["mix"]
    dev = torch.device(device)
    on_card = dev.type == "cuda"

    from mumemto_tpu_torch import engine, options
    from mumemto_tpu_torch.refbuilder import RefBuilder, revcomp
    find = find or engine.find_matches

    docs = generate(config, seed % 2**64)
    dollar = np.frombuffer(b"$", np.uint8)
    pieces, seq_lengths = [], []
    for fwd in docs:
        pieces += [fwd, dollar, revcomp(fwd), dollar]
        seq_lengths.append(2 * (fwd.size + 1))
    rb = RefBuilder(text=np.concatenate(pieces), seq_lengths=seq_lengths,
                    num_docs=len(docs), use_revcomp=True, input_files=[],
                    multifasta_names=[], multifasta_lengths=[])
    del pieces
    opts = options.normalize(len(docs), quiet=True,
                             min_match_len=config["min_len"], **mix["options"])
    mbp = sum(int(d.size) for d in docs) / 1e6

    def call(phase=None):
        return find(rb, opts, device=dev, pfp_w=config["w"],
                    pfp_mod=config["mod"], phase=phase,
                    backend=mix["backend"], show_progress=False)

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    outputs, calls, errors = [], [], []

    def timed(phase=None):
        t0 = time.perf_counter()
        try:
            out = call(phase)
            sync()
        except Exception as e:  # a failed call is counted, not fatal
            errors.append(f"{type(e).__name__}: {str(e)[:300]}")
            out = None
        t1 = time.perf_counter()
        calls.append({"start": t0, "end": t1, "ok": out is not None})
        if out is not None:
            outputs.append(out)
        return out is not None

    # set-up: a cold call (kernel build and load, the allocator's first
    # blocks), then a warm one: on an H100 the first call after a cold one
    # ran 3-10% slower than the rest in most trial runs
    warm = []
    for _ in range(2):
        t0 = time.perf_counter()
        call()
        sync()
        warm.append(time.perf_counter() - t0)
    log(f"[mumbench] {workload}: {mbp:g} Mbp, {len(docs)} docs, "
        f"{rb.text.size} chars, set-up calls "
        + " ".join(f"{s:.3f}" for s in warm) + " s")
    gc.collect()
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)

    use0 = resource.getrusage(resource.RUSAGE_SELF)
    rec = {"card": torch.cuda.get_device_name(dev) if on_card else "cpu",
           "mbp": mbp, "n_text": int(rb.text.size), "w": config["w"],
           "stages": [], "profile": None}
    start = time.perf_counter()
    rec["setup_s"] = start - T_START
    if not trace:
        while timed() and time.perf_counter() < start + seconds:
            pass
    else:
        half = start + seconds / 2
        stages = {}
        mark = [0.0]

        def hook(name):
            sync()
            now = time.perf_counter()
            stages[name] = stages.get(name, 0.0) + now - mark[0]
            mark[0] = now
        while True:
            stages = {}
            mark[0] = time.perf_counter()
            if not timed(hook):
                break
            rec["stages"].append(stages)
            if time.perf_counter() >= half:
                break
        if not errors:
            rec["profile"] = profiled(torch, dev, timed, start + seconds)
    end = time.perf_counter()
    rec["calls"] = calls
    rec["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                         if on_card else 0)
    log(f"[mumbench] {workload}: {len(calls)} calls in {end - start:.3f} s, "
        f"peak {rec['peak_bytes'] / 2**30:.3f} GiB; call walls "
        + " ".join(f"{c['end'] - c['start']:.3f}" for c in calls))
    use1 = resource.getrusage(resource.RUSAGE_SELF)
    log(f"[mumbench] window host: user {use1.ru_utime - use0.ru_utime:.3f}"
        f" s, sys {use1.ru_stime - use0.ru_stime:.3f} s, minor faults "
        f"{use1.ru_minflt - use0.ru_minflt}, involuntary switches "
        f"{use1.ru_nivcsw - use0.ru_nivcsw}, voluntary "
        f"{use1.ru_nvcsw - use0.ru_nvcsw}; {len(os.sched_getaffinity(0))}"
        f" cpus, {torch.get_num_threads()} torch threads")
    for e in errors:
        log(f"[mumbench] failed call: {e}")

    # the program's state goes before the reference runs; calls whose
    # match arrays are equal give equal bytes, so each distinct result is
    # formatted and judged once
    distinct = {}
    while outputs:
        out = outputs.pop()
        distinct.setdefault(result_digest(out), [out, 0])[1] += 1
    for entry in distinct.values():
        entry[0] = entry[0].output_bytes()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    import reference
    want = reference.match_set(docs, device=dev,
                               **reference_options(config, mix))
    worst = 0
    for data, _n in distinct.values():
        worst = max(worst, mismatches(parse_output(data, opts.mum_mode),
                                      want))
    log(f"[mumbench] reference: {len(want)} matches in "
        f"{time.perf_counter() - t_ref:.3f} s; {len(distinct)} distinct "
        f"outputs over {len(calls)} calls")

    failed = sum(not c["ok"] for c in calls)
    checks = {"mismatched_matches": {"value": worst, "limit": 0},
              "failed_calls": {"value": failed, "limit": 0}}
    correct = (failed == 0 and worst == 0 and bool(distinct)
               and len(calls) > 0)

    metrics_dir = os.path.join(HERE, "metrics")
    metrics = {}
    for m in spec["per_layer"] if trace else spec["end_to_end"]:
        reader = load_module(os.path.join(metrics_dir, m["name"] + ".py"),
                         "metric_" + m["name"].replace(".", "_"))
        value = reader.read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    result = {"correct": correct, "attempted": len(calls), "failed": failed,
              "metrics": metrics,
              "device": device_record(torch, dev, rec["peak_bytes"])}
    if trace and rec["profile"]:
        p = rec["profile"]
        result["device"]["busy_s"] = p["busy_s"]
        result["device"]["window_s"] = p["window_s"]
        result["breakdown"] = {
            "device_ops": [[n, v[0]] for n, v in sorted(
                p["device_ops"].items(), key=lambda kv: -kv[1][0])
                [:TOP_ENTRIES]],
            "idle_gaps": [[f"{n} x{v[1]}", v[0]] for n, v in sorted(
                p["idle_gaps"].items(), key=lambda kv: -kv[1][0])
                [:TOP_ENTRIES]]}
    result["checks"] = checks
    return result, checks


def profiled(torch, dev, timed, deadline) -> dict:
    """Calls under torch.profiler (the card's activity and the host's
    operations) until the deadline, at least one; the trace read by
    read_trace, with the window's wall seconds and the busy seconds
    averaged over the cards used."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    try:
        t0 = time.perf_counter()
        n = 0
        while timed():
            n += 1
            if time.perf_counter() >= deadline:
                break
        window = time.perf_counter() - t0
    finally:
        prof.stop()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        log(f"[mumbench] profiled {n} calls in {window:.3f} s; trace "
            f"{os.path.getsize(path) / 2**20:.1f} MiB")
        got = read_trace(path)
    finally:
        os.remove(path)
    busy = got["busy_s"]
    return {"window_s": window, "calls": n,
            "busy_s": sum(busy.values()) / max(len(busy), 1),
            "device_ops": got["device_ops"], "idle_gaps": got["idle_gaps"]}


def device_record(torch, dev, peak) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": peak}
    rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
           "count": 1, "memory_peak_bytes": peak}
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(dev.index or 0),
             "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        rec["power_limit"] = out.stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        rec["power_limit"] = "not read"
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    chips = cell_spec(args.workload)["cell"]["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"[mumbench] {args.workload} needs {chips} CUDA card(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            " visible")
        return 2
    result, checks = execute(args.workload, args.seed, args.seconds,
                             args.trace)
    # last, once the reference and every metric reader have run
    banned = banned_modules()
    if banned:
        log(f"[mumbench] loaded in this process: {', '.join(banned)}")
        return 1
    for name, c in checks.items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
