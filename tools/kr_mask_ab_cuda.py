#!/usr/bin/env python3
"""Time the Karp-Rabin break-mask kernel beside other forms of it on one
CUDA card.

    python3 tools/kr_mask_ab_cuda.py [--reps 50] [--rounds 3]

Builds the port's kernel and tools/kr_mask_ab.cu (the first version of the
kernel, the linear form, and a probe without hashing) with nvcc for
sm_90a, checks every form but the probe against the plain PyTorch version
(mask and count exactly equal) on a grid of w, mod, ne and byte values,
and times them in turns with CUDA events at ne = 2^24 and 2^26 on ACGT
text, at w = 10, mod = 100 (the port's kernel also at w = 17, which takes
its shared-memory path). Each is launched through its C entry point on
preallocated outputs, so the times are the launcher's memset and the
kernel, with no PyTorch call between launches; `cold` rotates over copies
of the inputs larger than the L2 cache together, `warm` launches on one
copy. Beside each time: the share of the memory
bound (2 bytes per position over 3.35 TB/s) and the bytes per second.
Then the host time of each step of the wrapper (what bounds a run of
back-to-back wrapper calls at ne = 2^24), and the register and
shared-memory use and the SASS opcode counts of the port's kernels, from
cuobjdump (the whole listing goes to chiprun_out/kr_mask_ab.sass). Prints one JSON object last and writes it to
chiprun_out/kr_mask_ab.json.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

HBM_BYTES_PER_S = 3.35e12
LINEAR_MAX_W = 1024  # kLinearMaxW of tools/kr_mask_ab.cu
FIRST_MAX_W = 48 * 1024 - 255  # the first version's tile: 48 KiB
# name: (what, entry point, variant number there, w when timed)
PORT, TOOL = "kr_break_mask", "kr_break_mask_variant"
VARIANTS = {
    "port": ("the port's kernel: rolling FP64, 32 positions x 128 threads",
             PORT, None, 10),
    "port w=17": ("the port's kernel on its shared-memory path", PORT, None,
                  17),
    "first": ("first version: 1 position/thread, w x 64-bit % p", TOOL, 0, 10),
    "linear": ("linear form, int64, 16 positions x 256 threads", TOOL, 1, 10),
    "probe": ("probe (wrong mask): the port's loads, stores and count, no "
              "hashing", TOOL, 2, 10)}


def _ext(rng, ne, n_text, w, kind):
    import numpy as np
    ext = np.zeros(ne, np.uint8)
    ext[0] = 2
    if kind == "acgt":
        body = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n_text)]
    elif kind == "ff":
        body = np.full(n_text, 255, np.uint8)
    else:
        body = rng.integers(0, 256, n_text).astype(np.uint8)
    ext[1:n_text + 1] = body
    ext[n_text + 1:n_text + 1 + w] = 2
    return ext


def _sass(lib_path, nvcc):
    """{kernel: {"registers", "shared", "instructions", "by_opcode"}} of
    the library's kernels, from cuobjdump."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    out = {}
    res = subprocess.run([tool, "-res-usage", lib_path], capture_output=True,
                         text=True, timeout=300)
    name = None
    for line in res.stdout.splitlines():
        m = re.match(r"\s*Function (\S+):", line)
        if m:
            name = m.group(1)
        m = re.search(r"REG:(\d+).*SHARED:(\d+)", line)
        if m and name:
            out.setdefault(name, {}).update(registers=int(m.group(1)),
                                            shared=int(m.group(2)))
    res = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                         text=True, timeout=300)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "kr_mask_ab.sass"), "w") as f:
        f.write(res.stdout)
    name = None
    for line in res.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})["by_opcode"] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\d+\s+)?([A-Z][A-Z0-9_.]*)",
                     line)
        if m and name:
            out[name]["by_opcode"][m.group(1).split(".")[0]] += 1
    for rec in out.values():
        ops = rec.get("by_opcode", {})
        rec["instructions"] = sum(ops.values())
        rec["by_opcode"] = dict(sorted(ops.items(), key=lambda kv: -kv[1]))
    return out


def _host_split(torch, kr_mask, build, reps: int = 200) -> dict:
    """Host microseconds per call of each step of the wrapper break_mask at
    ne = 2^24 (time.perf_counter_ns over `reps` calls, few enough that the
    launch queue never fills; the card is drained outside the clock)."""
    import time
    ne = 1 << 24
    ext = torch.randint(65, 85, (ne,), dtype=torch.uint8, device="cuda")
    mask = torch.empty(ne, dtype=torch.bool, device="cuda")
    count = torch.empty((), dtype=torch.int32, device="cuda")
    fn, _ = kr_mask.launcher()
    steps = [
        ("_check", lambda: kr_mask._check(ext, 10, 100)),
        ("torch.empty(ne, bool)",
         lambda: torch.empty(ne, dtype=torch.bool, device=ext.device)),
        ("torch.empty((), int32)",
         lambda: torch.empty((), dtype=torch.int32, device=ext.device)),
        ("build.launch on preallocated outputs (memset + kernel)",
         lambda: build.launch(fn, ext, ext.data_ptr(), mask.data_ptr(),
                              count.data_ptr(), ne, ne - 64, 10, 100,
                              counter=kr_mask.COUNTER)),
        ("break_mask", lambda: kr_mask.break_mask(ext, ne - 64, 10, 100))]
    out = {}
    for name, step in steps:
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(reps):
            step()
        t1 = time.perf_counter_ns()
        torch.cuda.synchronize()
        out[name] = (t1 - t0) / reps / 1e3
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kr_mask_ab_cuda: CUDA is not available", file=sys.stderr)
        return 1
    from mumemto_tpu_torch.kernels import build, kr_mask
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[card] {smi}", flush=True)
    tool_fn = ctypes.CFUNCTYPE(
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p)((TOOL, ctypes.CDLL(build.build(
            "kr_mask_ab", src=os.path.join(ROOT, "tools", "kr_mask_ab.cu")))))
    port_fn, _ = kr_mask.launcher()
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run(name, ext, mask, count, n_real, w, mod):
        _, entry, number, _ = VARIANTS[name]
        args = (ext.data_ptr(), mask.data_ptr(), count.data_ptr(),
                ext.numel(), n_real, w, mod, stream)
        rc = port_fn(*args) if entry == PORT else tool_fn(number, *args)
        if rc != 0:
            raise RuntimeError(f"{name}: CUDA error {rc}")

    rng = np.random.default_rng(0)
    cases = [(1 << 20, (1 << 20) - 40, 10, 100, "acgt"),
             (300001, 299000, 10, 100, "bytes"), (64, 5, 10, 100, "acgt")]
    cases += [(77777, 70000, w, mod, kind)
              for w in (1, 2, 4, 16, 17, 33)
              for mod in (1, 7, 100, 2**31 - 1)
              for kind in ("bytes", "ff")]
    cases += [(50021, 45000, 700, 100, "bytes"), (9000, 4600, 4500, 3, "ff"),
              (120007, 110000, 50000, 3, "bytes")]  # > 48 KiB of shared memory
    checked = collections.Counter()
    for ne, n_text, w, mod, kind in cases:
        ext = torch.from_numpy(_ext(rng, ne, n_text, w, kind)).to(dev)
        want, want_n = kr_mask.break_mask_plain(ext, n_text, w, mod)
        for variant in ("port", "first", "linear"):
            if ((variant == "linear" and w > LINEAR_MAX_W)
                    or (variant == "first" and w > FIRST_MAX_W)):
                continue
            mask = torch.empty(ne, dtype=torch.bool, device=dev)
            count = torch.empty((), dtype=torch.int32, device=dev)
            run(variant, ext, mask, count, n_text, w, mod)
            torch.cuda.synchronize()
            bad = int((mask != want).sum()) + abs(int(count) - int(want_n))
            if bad:
                raise AssertionError(
                    f"variant {variant} != plain: ne={ne} w={w} mod={mod} "
                    f"{kind}: {bad}")
            checked[variant] += 1
    print(f"[check] port, first and linear == plain on {len(cases)} cases: "
          f"{dict(checked)}", flush=True)

    timings = {}
    for log2 in (24, 26):
        ne = 1 << log2
        n_text = ne - 4096
        copies = max(2, (160 << 20) // (2 * ne) + 1)  # > 50 MB L2 together
        exts = [torch.from_numpy(_ext(rng, ne, n_text, 17, "acgt")).to(dev)
                for _ in range(copies)]
        masks = [torch.empty(ne, dtype=torch.bool, device=dev)
                 for _ in range(copies)]
        count = torch.empty((), dtype=torch.int32, device=dev)
        bound_ms = 2 * ne / HBM_BYTES_PER_S * 1e3

        def timed(variant, cold):
            n = copies if cold else 1
            w = VARIANTS[variant][3]
            for i in range(n):
                run(variant, exts[i], masks[i], count, n_text, w, 100)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(args.reps):
                run(variant, exts[i % n], masks[i % n], count, n_text, w, 100)
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / args.reps

        runs = collections.defaultdict(list)
        order = list(VARIANTS) + list(reversed(VARIANTS))
        for _ in range(args.rounds):
            for variant in order:
                for cold in (True, False):
                    runs[variant, cold].append(timed(variant, cold))
        rec = {"ne": ne, "bound_ms": bound_ms, "copies": copies}
        for variant, (label, _, _, _) in VARIANTS.items():
            cold = statistics.median(runs[variant, True])
            warm = statistics.median(runs[variant, False])
            rec[variant] = {
                "what": label, "cold_ms": cold, "warm_ms": warm,
                "cold_share_of_bound": bound_ms / cold,
                "cold_gb_per_s": 2 * ne / cold / 1e6,
                "cold_ms_runs": runs[variant, True],
                "warm_ms_runs": runs[variant, False]}
            print(f"[time] ne=2^{log2} {variant} ({label}): cold "
                  f"{cold:.4f} ms ({bound_ms / cold:.1%} of the {bound_ms:.4f} "
                  f"ms bound, {2 * ne / cold / 1e6:.0f} GB/s), warm "
                  f"{warm:.4f} ms", flush=True)
        timings[f"2^{log2}"] = rec
        del exts, masks

    host = _host_split(torch, kr_mask, build)
    print("[host] us per call of the wrapper's steps at ne = 2^24: "
          + json.dumps(host), flush=True)
    sass = _sass(build.build("kr_mask"), build.nvcc_path())
    for name, rec in sass.items():
        print(f"[sass] {name}: {rec.get('registers')} registers, "
              f"{rec.get('instructions')} instructions: "
              f"{json.dumps(rec.get('by_opcode'))}", flush=True)
    report = {"card": smi, "torch": torch.__version__, "reps": args.reps,
              "rounds": args.rounds, "cases_checked": len(cases),
              "timings": timings, "host_split_us": host, "sass": sass}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "kr_mask_ab.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"card": smi, "timings": {
        k: {v: {"cold_ms": r[v]["cold_ms"], "warm_ms": r[v]["warm_ms"]}
            for v in VARIANTS} | {"bound_ms": r["bound_ms"]}
        for k, r in timings.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
