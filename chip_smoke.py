#!/usr/bin/env python3
"""Drive the PyTorch port (mumemto_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):
  1. the card, the toolkit and the software versions;
  2. build the CUDA kernel from the sources in this checkout;
  3. the KR break-mask kernel against its plain PyTorch version on the card
     (mask and count exactly equal), with CUDA-event timings;
  4. the main path end to end on the bench input (bench.synth_collection,
     8 docs, 0.1% SNP, revcomp, strict multi-MUMs) at 8 and 32 Mbp: stage
     times, Mbp/s, peak device memory, and the match count against a live
     run of native/baseline_cpu;
  5. .mums bytes on the card against the port's CPU path (1 Mbp) and
     against mumemto_tpu.oracle.naive (tiny collections, with and without
     N bases).
The line before the last is the kernels' JSON record, the last line is
{"ok": true, "device": {...}}. Everything is also written to
chiprun_out/chip_smoke.json. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
KR_SOURCE = "mumemto_tpu_torch/kernels/csrc/kr_mask.cu"
KR_REPLACES = "mumemto_tpu/ops/pallas_kernels.py:103"
N_DOCS = 8
EXPECT_8MBP = 6759  # bench tier match count (README.md, BASELINE.md)


def log(*a):
    print(*a, flush=True)


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


class StageTimer:
    """phase(name) callback: synchronizes the card and records the wall
    time since the previous call."""

    def __init__(self, torch):
        self.torch = torch
        self.stages = {}
        self.t = time.perf_counter()

    def __call__(self, name):
        self.torch.cuda.synchronize()
        now = time.perf_counter()
        self.stages[name] = now - self.t
        self.t = now


def _event_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bench_rb(mbp: float, seed: int = 0):
    """bench.py's collection and RefBuilder at `mbp` Mbp."""
    import numpy as np
    import bench
    from mumemto_tpu.refbuilder import RefBuilder, revcomp
    docs = bench.synth_collection(mbp, N_DOCS, seed=seed, snp_rate=0.001)
    pieces, seq_lengths = [], []
    dollar = np.frombuffer(b"$", dtype=np.uint8)
    for fwd in docs:
        pieces += [fwd, dollar, revcomp(fwd), dollar]
        seq_lengths.append(2 * (fwd.size + 1))
    text = np.concatenate(pieces)
    return RefBuilder(text=text, seq_lengths=seq_lengths, num_docs=N_DOCS,
                      use_revcomp=True, input_files=[], multifasta_names=[],
                      multifasta_lengths=[])


def _ext_of(text, w: int):
    """The device ext layout build_pfp uploads for `text`."""
    import numpy as np
    from mumemto_tpu_torch.ops import pfp as ops_pfp
    ext_np = np.concatenate([np.full(1, ops_pfp.DOLLAR_PFP, np.uint8), text,
                             np.full(w, ops_pfp.DOLLAR_PFP, np.uint8)])
    ext = np.zeros(ops_pfp.bucket(ext_np.size), np.uint8)
    ext[:ext_np.size] = ext_np
    return ext


def phase_card(torch, report):
    from mumemto_tpu_torch.kernels import build
    smi = _smi()
    nvcc = build.nvcc_path()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[-1]
    try:
        import triton
        tri = triton.__version__
    except ImportError:
        tri = None
    report["card"] = {"nvidia_smi": smi, "torch": torch.__version__,
                      "cuda": torch.version.cuda, "nvcc": nvcc,
                      "nvcc_version": ver, "triton": tri,
                      "device_name": torch.cuda.get_device_name(0),
                      "device_count": torch.cuda.device_count()}
    log(f"[card] {smi}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"nvcc {nvcc} ({ver}); triton {tri}")


def phase_build(report):
    from mumemto_tpu_torch.kernels import kr_mask
    t0 = time.perf_counter()
    kr_mask._lib()
    report["build_s"] = time.perf_counter() - t0
    log(f"[build] kr_mask built and loaded in {report['build_s']:.2f}s")


def phase_kernel(torch, report):
    """Kernel vs plain on the card: exact mask and count."""
    import numpy as np
    from mumemto_tpu_torch.kernels import kr_mask
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    acgt = np.frombuffer(b"ACGT", np.uint8)

    def synth(ne, n_text, w, random_bytes=False):
        ext = np.zeros(ne, np.uint8)
        ext[0] = 2
        body = (rng.integers(0, 256, n_text).astype(np.uint8) if random_bytes
                else acgt[rng.integers(0, 4, n_text)])
        ext[1:n_text + 1] = body
        ext[n_text + 1:n_text + 1 + w] = 2
        return torch.from_numpy(ext).to(dev)

    cases = [("acgt 2^24", 1 << 24, (1 << 24) - 64, 10, False),
             ("acgt 2^26", 1 << 26, (1 << 26) - 64, 10, False),
             ("random bytes 2^20", 1 << 20, (1 << 20) - 40, 10, True),
             ("odd ne", 300001, 299000, 10, True),
             ("small ne", 1000, 700, 10, False),
             ("n_text < w", 64, 5, 10, False),
             ("w=4", 77777, 70000, 4, False),
             ("w=16", 77777, 70000, 16, True),
             ("w=16 mod 7", 4097, 4000, 16, False)]
    max_err = 0
    for name, ne, n_text, w, rb in cases:
        mod = 7 if name.endswith("mod 7") else 100
        ext = synth(ne, n_text, w, rb)
        m_k, c_k = kr_mask.break_mask(ext, n_text, w, mod)
        torch.cuda.synchronize()
        m_p, c_p = kr_mask.break_mask_plain(ext, n_text, w, mod)
        err = max(int((m_k != m_p).sum()), abs(int(c_k) - int(c_p)))
        max_err = max(max_err, err)
        log(f"[kernel] {name}: ne={ne} n_text={n_text} w={w} mod={mod} "
            f"count kernel={int(c_k)} plain={int(c_p)} mismatches={err}")
        if err:
            raise AssertionError(f"kr_mask kernel != plain on {name}")
    report["kernel_max_abs_err"] = max_err

    # timings at the main path's shapes: the real 8/32 Mbp ext arrays
    timings = {}
    for mbp in (8, 32):
        text = _bench_rb(mbp).text
        ext = torch.from_numpy(_ext_of(text, 10)).to(dev)
        n_text = int(text.size)
        m_k, c_k = kr_mask.break_mask(ext, n_text, 10, 100)
        m_p, c_p = kr_mask.break_mask_plain(ext, n_text, 10, 100)
        if not (bool((m_k == m_p).all()) and int(c_k) == int(c_p)):
            raise AssertionError(f"kr_mask kernel != plain at {mbp} Mbp")
        ms = _event_ms(torch, lambda: kr_mask.break_mask(ext, n_text, 10, 100),
                       20)
        plain_ms = _event_ms(
            torch, lambda: kr_mask.break_mask_plain(ext, n_text, 10, 100), 5)
        ms2 = _event_ms(torch,
                        lambda: kr_mask.break_mask(ext, n_text, 10, 100), 20)
        timings[f"{mbp}mbp"] = {"ne": int(ext.numel()), "ms": min(ms, ms2),
                                "ms_runs": [ms, ms2], "plain_ms": plain_ms,
                                "breaks": int(c_k)}
        log(f"[kernel] {mbp} Mbp ext ne={ext.numel()}: kernel {ms:.4f} / "
            f"{ms2:.4f} ms, plain {plain_ms:.4f} ms ({int(c_k)} breaks)")
    report["kernel_timings"] = timings


def phase_end_to_end(torch, report):
    import bench
    from mumemto_tpu import options
    from mumemto_tpu_torch import engine
    from mumemto_tpu_torch.kernels import kr_mask

    kr_mask.launches = 0  # count only the main path's launches from here
    report["e2e"] = {}
    for mbp in (8, 32):
        rb = _bench_rb(mbp)
        opts = options.normalize(N_DOCS, quiet=True)
        before = kr_mask.launches
        t0 = time.perf_counter()
        cold = engine.find_matches(rb, opts, device="cuda")
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        timer = StageTimer(torch)
        t0 = time.perf_counter()
        res = engine.find_matches(rb, opts, device="cuda", phase=timer)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        runs = kr_mask.launches - before
        if runs < 2:
            raise AssertionError(f"KR kernel launched {runs} times in two "
                                 f"{mbp} Mbp runs")
        if res.output_bytes() != cold.output_bytes():
            raise AssertionError(f"{mbp} Mbp: two runs disagree")
        cpu = bench.run_cpu_baseline(rb.text, rb.seq_lengths, opts, mbp,
                                     reps=1)
        if cpu is None:
            raise AssertionError("native/baseline_cpu did not build or run")
        base_mbp_s, base_matches = cpu
        entry = {"mbp": mbp, "text_chars": int(rb.text.size),
                 "matches": res.num_matches,
                 "baseline_matches": base_matches,
                 "wall_s": wall, "cold_wall_s": cold_s,
                 "mbp_per_s": mbp / wall, "stages_s": timer.stages,
                 "baseline_s": mbp / base_mbp_s,
                 "baseline_mbp_per_s": base_mbp_s,
                 "peak_alloc_bytes": peak, "kr_launches": runs}
        report["e2e"][f"{mbp}mbp"] = entry
        log(f"[e2e] {mbp} Mbp: {json.dumps(entry)}")
        if res.num_matches != base_matches:
            raise AssertionError(f"{mbp} Mbp: {res.num_matches} matches, "
                                 f"baseline_cpu {base_matches}")
        if mbp == 8 and res.num_matches != EXPECT_8MBP:
            raise AssertionError(f"8 Mbp: {res.num_matches} matches, "
                                 f"expected {EXPECT_8MBP}")
    report["main_path_launches"] = kr_mask.launches


def phase_bytes(torch, report):
    import numpy as np
    from mumemto_tpu import options, refbuilder
    from mumemto_tpu.oracle import naive
    from mumemto_tpu_torch import engine

    rb = _bench_rb(1, seed=1)
    opts = options.normalize(N_DOCS, quiet=True)
    gpu = engine.find_matches(rb, opts, device="cuda").output_bytes()
    t0 = time.perf_counter()
    cpu = engine.find_matches(rb, opts, device="cpu").output_bytes()
    log(f"[bytes] 1 Mbp: cuda {len(gpu)} B, cpu {len(cpu)} B "
        f"(cpu path {time.perf_counter() - t0:.1f}s)")
    if gpu != cpu or not gpu:
        raise AssertionError("1 Mbp .mums bytes differ between cuda and cpu")

    import bench
    rng = np.random.default_rng(3)
    checked = []
    for label, with_n in (("acgt", False), ("with N", True)):
        docs = bench.synth_collection(0.003, 3, seed=2, snp_rate=0.004)
        if with_n:
            docs = [np.where(rng.random(d.size) < 0.02, ord("N"), d
                             ).astype(np.uint8) for d in docs]
        tiny = refbuilder.build_from_sequences([[d] for d in docs])
        for k in (0, -1):
            topts = options.normalize(tiny.num_docs, num_distinct_docs=k,
                                      quiet=True)
            got = engine.find_matches(tiny, topts, device="cuda")
            want = naive.oracle_output(tiny, topts)
            log(f"[bytes] tiny {label} k={k}: {got.num_matches} matches, "
                f"{len(want)} oracle bytes")
            if got.output_bytes() != want or not want:
                raise AssertionError(f"tiny {label} k={k}: cuda .mums != "
                                     "oracle.naive")
            checked.append(f"{label} k={k}")
    report["bytes"] = {"1mbp_cuda_eq_cpu": True, "oracle": checked}


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "mumemto_tpu_torch")):
        print("chip_smoke: mumemto_tpu_torch not found beside this script; "
              "run it from the repository root", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one "
              "CUDA card", file=sys.stderr)
        return 1
    report = {}
    t_all = time.perf_counter()
    phase_card(torch, report)
    phase_build(report)
    phase_kernel(torch, report)
    phase_end_to_end(torch, report)
    phase_bytes(torch, report)
    if "jax" in sys.modules:
        raise AssertionError("chip_smoke imported jax")
    report["total_s"] = time.perf_counter() - t_all

    t8 = report["kernel_timings"]["8mbp"]
    kernels = {"kernels": [{
        "name": "kr_break_mask", "route": "cuda", "source": KR_SOURCE,
        "replaces": KR_REPLACES, "launches": report["main_path_launches"],
        "max_abs_err": report["kernel_max_abs_err"], "ms": t8["ms"],
        "plain_ms": t8["plain_ms"]}]}
    device = {"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"report": report, **kernels}, f, indent=1)
    log(f"[done] {report['total_s']:.1f}s")
    log(report["card"]["nvidia_smi"])
    log(json.dumps(kernels))
    log(json.dumps(device))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:  # any failed phase: report it and exit non-zero
        traceback.print_exc()
        rc = 1
    sys.exit(rc)
