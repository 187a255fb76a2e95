#!/usr/bin/env python3
"""Drive the PyTorch port (mumemto_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):
  1. the card, the toolkit and the software versions;
  2. the toolchain probe: `python -m mumemto_tpu_torch.kernels.probe` in a
     subprocess under a timeout, then the add_one kernel against its plain
     version (exactly equal) on the (8, 128) tile, the int32 edges, 2^26
     elements, odd lengths and misaligned views, with CUDA-event timings at
     (8, 128) and 2^26 and the host time of each step of its launch path;
  3. build every CUDA kernel from the sources in this checkout, one nvcc
     per source, all started together;
  4. the KR break-mask kernel against its plain PyTorch version on the card
     (mask and count exactly equal), with CUDA-event timings;
  5. the main path end to end on the bench input (bench.synth_collection,
     8 docs, 0.1% SNP, revcomp, strict multi-MUMs) at 8 and 32 Mbp: stage
     times, Mbp/s, peak device memory, and the match count against a live
     run of native/baseline_cpu;
  6. multi-MEMs on the same input: -f 3 at 8 and 32 Mbp (windowed scan,
     global prev-same-doc chain) and -f 0 -F 0 at 8 Mbp (uncapped scan),
     each against a live baseline_cpu run with the same -f/-F;
  7. 128 docs of 62.5 kbp, strict MUMs: the size cap is 256, so the scan
     takes the probe-guarded walk; against a live baseline_cpu run;
  8. the other entry routes on the 8 Mbp input: -g (direct backend; a cold
     and a warm run against a live baseline_cpu run, its index stages
     alone), -P then -p, -A then -a; every route's .mums bytes must equal
     the PFP path's of phase 5;
  9. output bytes on the card against the port's CPU path at 1 Mbp (.mums,
     .mems with -f 3, .bumbl with -b, .thresh/.thresh_rev with -M,
     .athresh with -M -n, .sa/.lcp/.bwt with -A, .dict/.parse with -P,
     -g's .mums and .mems with -f 3) and against mumemto_tpu.oracle.naive
     on tiny collections (.mums with and without N bases, .mems for five
     k/f/F settings, the -M threshold arrays).
Every path of phases 5-8 is driven with the kernels' launch counts set to
0 just before it and read just after; each PFP path (and -P, -A) must have
launched the KR kernel, and -g, -p and -a must have launched none. The
line before the last is the kernels' JSON record, the last line is
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
PROBE_SOURCE = "mumemto_tpu_torch/kernels/csrc/add_one.cu"
PROBE_REPLACES = "tools/mosaic_probe.py:25"
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


def _bench_rb(mbp: float, seed: int = 0, n_docs: int = N_DOCS):
    """bench.py's collection and RefBuilder at `mbp` Mbp."""
    import numpy as np
    import bench
    from mumemto_tpu.refbuilder import RefBuilder, revcomp
    docs = bench.synth_collection(mbp, n_docs, seed=seed, snp_rate=0.001)
    pieces, seq_lengths = [], []
    dollar = np.frombuffer(b"$", dtype=np.uint8)
    for fwd in docs:
        pieces += [fwd, dollar, revcomp(fwd), dollar]
        seq_lengths.append(2 * (fwd.size + 1))
    text = np.concatenate(pieces)
    return RefBuilder(text=text, seq_lengths=seq_lengths, num_docs=n_docs,
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


def phase_probe(torch, report):
    """The toolchain probe's entry point, then its kernel against the plain
    version."""
    from mumemto_tpu_torch.kernels import probe
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "mumemto_tpu_torch.kernels.probe", "300"],
        cwd=ROOT, capture_output=True, text=True, timeout=360)
    probe_s = time.perf_counter() - t0
    log(f"[probe] rc={run.returncode} in {probe_s:.1f}s: "
        f"{run.stdout.strip()}")
    if run.returncode != 0 or "CUDA_PROBE_OK" not in run.stdout:
        raise AssertionError(f"toolchain probe failed: {run.stdout} "
                             f"{run.stderr[-2000:]}")
    # the probe's own path, in this process: its launches are counted
    probe.launches = 0
    name = probe.check()
    launches = probe.launches
    if launches != 1:
        raise AssertionError(f"probe.check launched add_one {launches} times")
    dev = torch.device("cuda")
    max_err = 0
    big = torch.randint(-2**31, 2**31 - 1, (1 << 26,), dtype=torch.int32,
                        device=dev)
    odd = torch.randint(-2**31, 2**31 - 1, (1000003,), dtype=torch.int32,
                        device=dev)
    cases = [("(8, 128)", torch.arange(8 * 128, dtype=torch.int32,
                                       device=dev).reshape(8, 128)),
             ("int32 edges", torch.tensor([2**31 - 1, -(2**31), -1, 0],
                                          dtype=torch.int32, device=dev)),
             ("2^20", big[:1 << 20]), ("2^26", big),
             ("odd length 1000003", odd),
             ("misaligned view x[1:]", odd[1:]),
             ("misaligned odd x[3:10]", odd[3:10])]
    cases += [(f"length {k}", odd[:k]) for k in (1, 2, 3, 5, 7)]
    for label, xc in cases:
        got = probe.add_one(xc)
        torch.cuda.synchronize()
        err = int((got != probe.add_one_plain(xc)).sum())
        max_err = max(max_err, err)
        if err:
            raise AssertionError(f"add_one kernel != plain on {label}: "
                                 f"{err} mismatches")
    if odd[1:].data_ptr() % 16 == 0:
        raise AssertionError("x[1:] is 16-byte aligned: the scalar path "
                             "was not exercised")
    tile = torch.arange(8 * 128, dtype=torch.int32, device=dev).reshape(8, 128)
    tile_t = _turns(torch, lambda: probe.add_one(tile),
                    lambda: probe.add_one_plain(tile), 500, 5)
    gb = 2 * big.numel() * 4 / 1e9  # bytes read + written per call
    big_t = _turns(torch, lambda: probe.add_one(big),
                   lambda: probe.add_one_plain(big), 20, 3)
    big_t.update(n=big.numel(), gb_per_s=gb / (big_t["ms"] / 1e3),
                 plain_gb_per_s=gb / (big_t["plain_ms"] / 1e3),
                 hbm_peak_gb_per_s=3350.0)
    report["probe"] = {"rc": run.returncode, "wall_s": probe_s,
                       "stdout": run.stdout.strip(), "device": name,
                       "launches": launches, "max_abs_err": max_err,
                       "cases": [c[0] for c in cases], "shape": [8, 128],
                       **tile_t, "2^26": big_t,
                       "host_split_us": _host_split(torch, probe, tile)}
    log(f"[probe] add_one == plain on {len(cases)} cases; (8, 128) median "
        f"kernel {tile_t['ms']:.5f} ms, plain {tile_t['plain_ms']:.5f} ms "
        f"({json.dumps(tile_t)})")
    log(f"[probe] 2^26 int32: median kernel {big_t['ms']:.4f} ms "
        f"({big_t['gb_per_s']:.1f} GB/s), plain {big_t['plain_ms']:.4f} ms "
        f"({big_t['plain_gb_per_s']:.1f} GB/s) of 3350 GB/s HBM peak")
    log("[probe] host us per call: "
        + json.dumps(report["probe"]["host_split_us"]))


def _turns(torch, kernel, plain, reps: int, rounds: int) -> dict:
    """CUDA-event ms per call of kernel and plain, timed in turns (kernel,
    plain, plain, kernel) for `rounds` rounds of `reps` calls each; the
    medians and every run."""
    import statistics
    runs = {"kernel": [], "plain": []}
    for _ in range(rounds):
        for name in ("kernel", "plain", "plain", "kernel"):
            runs[name].append(_event_ms(
                torch, kernel if name == "kernel" else plain, reps))
    return {"ms": statistics.median(runs["kernel"]),
            "plain_ms": statistics.median(runs["plain"]),
            "ms_runs": runs["kernel"], "plain_ms_runs": runs["plain"]}


def _host_split(torch, probe, tile, reps: int = 10000) -> dict:
    """Host microseconds per call of each step of add_one's launch path on
    the (8, 128) tile, by time.perf_counter_ns over `reps` calls: the steps
    the earlier wrapper took on every call (a _lib() lookup, the device
    guard, a Stream object for the stream handle) and the ones the wrapper
    takes now, the bare ctypes launch, and the whole wrapper beside x + 1.
    Steps that launch work synchronize after the loop, outside the clock."""
    import ctypes
    from mumemto_tpu_torch.kernels import build
    dev = tile.device
    idx = tile.get_device()
    fn = probe._kernel()
    out = torch.empty_like(tile)
    xp, op, n = tile.data_ptr(), out.data_ptr(), tile.numel()
    stream = build.current_stream(idx)
    lib = build.load("add_one")
    lib.add_one_i32.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_int64, ctypes.c_void_p]
    lib.add_one_i32.restype = ctypes.c_int

    def old_lib():  # the earlier per-call _lib(): import, load, attribute
        from mumemto_tpu_torch.kernels import build as b
        return b.load("add_one")

    def guard():
        with torch.cuda.device(dev):
            pass

    def old_wrapper():  # the earlier add_one after _check, step by step
        lb = old_lib()
        with torch.cuda.device(dev):
            o = torch.empty_like(tile)
            s = torch.cuda.current_stream(dev).cuda_stream
            lb.add_one_i32(tile.data_ptr(), o.data_ptr(), tile.numel(), s)
        return o

    steps = [
        ("_check", lambda: probe._check(tile)),
        ("_lib() (earlier, per call)", old_lib),
        ("torch.cuda.device enter+exit (earlier)", guard),
        ("torch.empty_like", lambda: torch.empty_like(tile)),
        ("torch.cuda.current_stream(dev).cuda_stream (earlier)",
         lambda: torch.cuda.current_stream(dev).cuda_stream),
        ("build.current_stream (now)", lambda: build.current_stream(idx)),
        ("torch.cuda.current_device", torch.cuda.current_device),
        ("torch._C._cuda_getDevice (now)", torch._C._cuda_getDevice),
        ("tensor.get_device (now)", tile.get_device),
        ("2x data_ptr", lambda: (tile.data_ptr(), out.data_ptr())),
        ("bare ctypes call, prototyped (now)", lambda: fn(xp, op, n, stream)),
        ("bare ctypes call, CDLL attribute (earlier)",
         lambda: lib.add_one_i32(xp, op, n, stream)),
        ("earlier wrapper, rebuilt", lambda: (probe._check(tile),
                                              old_wrapper())),
        ("add_one (now)", lambda: probe.add_one(tile)),
        ("x + 1", lambda: probe.add_one_plain(tile)),
    ]
    out_us = {}
    for name, step in steps:
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(reps):
            step()
        t1 = time.perf_counter_ns()
        torch.cuda.synchronize()
        out_us[name] = (t1 - t0) / reps / 1e3
    return out_us


def phase_build(report):
    """Every kernel source of the port, one nvcc each, started together."""
    from concurrent.futures import ThreadPoolExecutor
    from mumemto_tpu_torch.kernels import build, kr_mask, probe
    names = sorted(f[:-3] for f in os.listdir(build.CSRC) if f.endswith(".cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(build.build, names))
    kr_mask._kernel()
    probe._kernel()
    report["build_s"] = time.perf_counter() - t0
    report["kernel_sources"] = names
    log(f"[build] {', '.join(names)} built and loaded in "
        f"{report['build_s']:.2f}s")


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


def _drive(torch, label, rb, opts, mbp, backend="pfp"):
    """One path end to end on the card: a cold and a warm find_matches with
    the kernels' launch counts set to 0 just before and read just after,
    then a live native/baseline_cpu run with the same options. The match
    count must equal the baseline's and be above 0. The PFP backend must
    have launched the KR kernel in both runs, the direct backend never.
    Returns (record, warm result)."""
    import bench
    from mumemto_tpu_torch import engine
    from mumemto_tpu_torch.kernels import kr_mask, probe
    kr_mask.launches = probe.launches = 0
    t0 = time.perf_counter()
    cold = engine.find_matches(rb, opts, device="cuda", backend=backend)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    timer = StageTimer(torch)
    t0 = time.perf_counter()
    res = engine.find_matches(rb, opts, device="cuda", phase=timer,
                              backend=backend)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {"kr_break_mask": kr_mask.launches, "add_one": probe.launches}
    if backend == "pfp" and launches["kr_break_mask"] < 2:
        raise AssertionError(f"{label}: KR kernel launched "
                             f"{launches['kr_break_mask']} times in two runs")
    if backend == "direct" and any(launches.values()):
        raise AssertionError(f"{label}: the direct backend launched "
                             f"kernels: {launches}")
    if res.output_bytes() != cold.output_bytes():
        raise AssertionError(f"{label}: two runs disagree")
    cpu = bench.run_cpu_baseline(rb.text, rb.seq_lengths, opts, mbp, reps=1)
    if cpu is None:
        raise AssertionError("native/baseline_cpu did not build or run")
    base_mbp_s, base_matches = cpu
    entry = {"label": label, "backend": backend, "mbp": mbp,
             "num_docs": rb.num_docs, "text_chars": int(rb.text.size),
             "f": opts.max_doc_freq, "F": opts.max_total_freq,
             "k": opts.num_distinct, "matches": res.num_matches,
             "baseline_matches": base_matches,
             "wall_s": wall, "cold_wall_s": cold_s,
             "mbp_per_s": mbp / wall, "stages_s": timer.stages,
             "baseline_s": mbp / base_mbp_s,
             "baseline_mbp_per_s": base_mbp_s,
             "peak_alloc_bytes": peak, "launches": launches}
    log(f"[{label}] {json.dumps(entry)}")
    if res.num_matches != base_matches or res.num_matches == 0:
        raise AssertionError(f"{label}: {res.num_matches} matches, "
                             f"baseline_cpu {base_matches}")
    return entry, res


def phase_end_to_end(torch, report) -> bytes:
    """Strict multi-MUMs at 8 and 32 Mbp (windowed scan, cap 16); returns
    the 8 Mbp .mums bytes."""
    from mumemto_tpu import options
    report["e2e"] = {}
    for mbp in (8, 32):
        entry, res = _drive(torch, f"e2e {mbp} Mbp", _bench_rb(mbp),
                            options.normalize(N_DOCS, quiet=True), mbp)
        report["e2e"][f"{mbp}mbp"] = entry
        if mbp == 8:
            if entry["matches"] != EXPECT_8MBP:
                raise AssertionError(f"8 Mbp: {entry['matches']} matches, "
                                     f"expected {EXPECT_8MBP}")
            mums_8mbp = res.output_bytes()
    return mums_8mbp


def phase_mem(torch, report):
    """Multi-MEMs: -f 3 (cap 32, windowed with the global prev-same-doc
    chain) at 8 and 32 Mbp, -f 0 -F 0 (uncapped) at 8 Mbp."""
    from mumemto_tpu import options
    report["mem"] = {}
    for f, mbp in ((3, 8), (0, 8), (3, 32)):
        opts = options.normalize(N_DOCS, rare_freq=f, max_mem_freq=0,
                                 quiet=True)
        report["mem"][f"f{f} {mbp}mbp"] = _drive(
            torch, f"mem -f {f} -F 0 {mbp} Mbp", _bench_rb(mbp), opts,
            mbp)[0]


def phase_walk(torch, report):
    """128 docs of 62.5 kbp, strict MUMs: cap 256, the probe-guarded walk."""
    from mumemto_tpu import options
    from mumemto_tpu_torch import engine
    rb = _bench_rb(8, n_docs=128)
    opts = options.normalize(rb.num_docs, quiet=True)
    if engine.interval_size_cap(opts, rb.num_docs) != 256:
        raise AssertionError("the 128-doc run does not take the walk")
    report["walk"] = _drive(torch, "walk 128 docs 8 Mbp", rb, opts, 8)[0]


def _written(engine, rb, opts, device, tmp, tag, backend="pfp",
             arrays_out=False, parse_only=False):
    """{extension: bytes} of the files one run writes: find_matches +
    write_outputs (with the .sa/.lcp/.bwt files when arrays_out), or the
    .dict/.parse files of write_parse_files when parse_only."""
    from mumemto_tpu_torch.ops import pfp as ops_pfp
    prefix = os.path.join(tmp, tag)
    if parse_only:
        ops_pfp.write_parse_files(rb, prefix, engine.resolve(device))
    else:
        engine.write_outputs(engine.find_matches(
            rb, opts, device=device, backend=backend,
            arrays_out_prefix=prefix if arrays_out else None), rb, prefix)
    out = {}
    for name in os.listdir(tmp):
        if name.startswith(tag + "."):
            with open(os.path.join(tmp, name), "rb") as fh:
                out[name[len(tag):]] = fh.read()
    return out


def _tiny_mem_docs(seed: int):
    """3 mutated copies of a 150 bp base with a 60 bp repeat planted 1-3
    times in each: multi-MEMs exist for every k/f/F setting."""
    import numpy as np
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    base = acgt[rng.integers(0, 4, 150)]
    rep = acgt[rng.integers(0, 4, 60)]
    docs = []
    for _ in range(3):
        d = base.copy()
        pos = rng.integers(0, d.size, int(rng.integers(1, 8)))
        d[pos] = acgt[rng.integers(0, 4, pos.size)]
        for _ in range(int(rng.integers(1, 4))):
            cut = int(rng.integers(0, d.size))
            d = np.concatenate([d[:cut], rep, d[cut:]])
        docs.append(d)
    return docs


def _counted(torch, fn):
    """(fn(), seconds, launch counts) with the counts set to 0 just before
    fn and read just after."""
    from mumemto_tpu_torch.kernels import kr_mask, probe
    kr_mask.launches = probe.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, {"kr_break_mask": kr_mask.launches,
                                           "add_one": probe.launches}


def _direct_index(torch, rb) -> dict:
    """The -g index stages alone on the padded bench text: doubling rounds
    and history size, and the PLCP deep-row count against deep_cap."""
    import numpy as np
    from mumemto_tpu_torch import engine
    from mumemto_tpu_torch.ops import pfp as ops_pfp
    from mumemto_tpu_torch.ops import suffix as ops_suffix
    n_real = int(rb.text.size)
    n = engine.pad_size(n_real)
    text_np = np.zeros(n, np.uint8)
    text_np[:n_real] = rb.text
    seed_thr, _ = ops_pfp.seed_thresholds(
        set(ops_pfp._alphabet(rb.text)) | {0})
    text = torch.from_numpy(text_np).to(engine.resolve("cuda"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sa, hist, num_lvl = ops_suffix._suffix_array_impl(
        text, n, packed_init=True, alpha_thresholds=seed_thr)
    torch.cuda.synchronize()
    sa_s = time.perf_counter() - t0
    stats = {}
    ops_suffix._lcp_plcp_impl(sa, hist, text, n, hist.shape[0], seed_thr,
                              deep_cap=max(n // 4, 1024), num_lvl=num_lvl,
                              stats=stats)
    torch.cuda.synchronize()
    stats.update(n=n, filled_rows=num_lvl, hist_rows=int(hist.shape[0]),
                 doubling_sorts=num_lvl - 4 + 1,
                 hist_bytes=int(hist.numel()) * 4, sa_s=sa_s,
                 lcp_s=time.perf_counter() - t0 - sa_s,
                 peak_alloc_bytes=torch.cuda.max_memory_allocated())
    return stats


def phase_routes(torch, report, pfp_mums: bytes):
    """The other single-device entry routes on the 8 Mbp bench input, each
    against the PFP path's .mums bytes (pfp_mums): -g (the direct backend,
    against a live baseline_cpu run as well), -P then -p, -A then -a. -P
    and -A must launch the KR kernel; -g, -p and -a launch no kernel."""
    import tempfile
    import numpy as np
    from mumemto_tpu import formats, options
    from mumemto_tpu.refbuilder import RefBuilder
    from mumemto_tpu_torch import engine
    from mumemto_tpu_torch.ops import pfp as ops_pfp
    rb = _bench_rb(8)
    opts = options.normalize(N_DOCS, quiet=True)
    out = {}
    entry, res = _drive(torch, "-g 8 Mbp", rb, opts, 8, backend="direct")
    if entry["matches"] != EXPECT_8MBP or res.output_bytes() != pfp_mums:
        raise AssertionError("-g 8 Mbp: .mums != the PFP path's")
    entry["index"] = _direct_index(torch, rb)
    log(f"[routes] -g index stages: {json.dumps(entry['index'])}")
    out["-g"] = entry
    # what -p and -a see: the .lengths metadata, no text
    rb_meta = RefBuilder(text=None, seq_lengths=rb.seq_lengths,
                         num_docs=rb.num_docs, use_revcomp=True,
                         input_files=[], multifasta_names=[],
                         multifasta_lengths=[])
    cuda = engine.resolve("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        pre = os.path.join(tmp, "ck")
        _, s_P, l_P = _counted(
            torch, lambda: ops_pfp.write_parse_files(rb, pre, cuda))
        t_p = StageTimer(torch)
        res_p, s_p, l_p = _counted(torch, lambda: engine.find_matches(
            rb_meta, opts, device=cuda, parse_prefix=pre, phase=t_p))
        sizes_P = {ext: os.path.getsize(pre + ext)
                   for ext in (".dict", ".parse")}
        t_A = StageTimer(torch)
        res_A, s_A, l_A = _counted(torch, lambda: engine.find_matches(
            rb, opts, device=cuda, arrays_out_prefix=pre, phase=t_A))
        sizes_A = {ext: os.path.getsize(pre + ext)
                   for ext in (".sa", ".lcp", ".bwt")}

        def replay():
            sa = formats.read_5byte(pre + ".sa").astype(np.int64)
            lcp = formats.read_5byte(pre + ".lcp").astype(np.int64)
            bwt = formats.read_rl_bwt(pre + ".bwt")
            return engine.find_matches_from_arrays(
                sa, lcp, bwt, rb_meta.doc_array(sa), rb_meta, opts,
                device=cuda)
        res_a, s_a, l_a = _counted(torch, replay)
    rows = int(rb.text.size)
    out["-P -p"] = {"-P_s": s_P, "-P_launches": l_P, "-p_s": s_p,
                    "-p_stages_s": t_p.stages, "-p_launches": l_p,
                    "sizes": sizes_P,
                    "matches": res_p.num_matches,
                    "text_length": res_p.text_length}
    out["-A -a"] = {"-A_s": s_A, "-A_stages_s": t_A.stages,
                    "-A_launches": l_A, "-a_s": s_a,
                    "-a_launches": l_a, "sizes": sizes_A, "real_rows": rows,
                    "matches": res_a.num_matches}
    log(f"[routes] {json.dumps(out['-P -p'])}")
    log(f"[routes] {json.dumps(out['-A -a'])}")
    if l_P["kr_break_mask"] < 1 or l_A["kr_break_mask"] < 1:
        raise AssertionError(f"-P/-A did not launch the KR kernel: {l_P} "
                             f"{l_A}")
    if any(l_p.values()) or any(l_a.values()):
        raise AssertionError(f"-p/-a launched kernels: {l_p} {l_a}")
    for label, r in (("-p", res_p), ("-A", res_A), ("-a", res_a)):
        if r.output_bytes() != pfp_mums:
            raise AssertionError(f"{label} 8 Mbp: .mums != the PFP path's")
    if res_p.text_length != sum(rb.seq_lengths):
        raise AssertionError("-p: text_length != the .lengths total")
    if sizes_A[".sa"] != 5 * rows or sizes_A[".lcp"] != 5 * rows:
        raise AssertionError(f"-A: .sa/.lcp sizes {sizes_A} != 5 x {rows}")
    report["routes"] = out


def phase_bytes(torch, report):
    import tempfile
    import numpy as np
    from mumemto_tpu import options, refbuilder
    from mumemto_tpu.oracle import naive
    from mumemto_tpu_torch import engine

    rb = _bench_rb(1, seed=1)
    same = {}
    for label, kw, run_kw, exts in (
            ("mums", {}, {}, {".mums"}),
            ("-f 3", {"rare_freq": 3}, {}, {".mems"}),
            ("-b", {"binary": True}, {}, {".bumbl"}),
            ("-M", {"merge": True}, {}, {".mums", ".thresh", ".thresh_rev"}),
            ("-M -n", {"merge": True, "anchor_merge": True}, {},
             {".mums", ".athresh"}),
            ("-A", {}, {"arrays_out": True},
             {".mums", ".sa", ".lcp", ".bwt"}),
            ("-P", {}, {"parse_only": True}, {".dict", ".parse"}),
            ("-g", {}, {"backend": "direct"}, {".mums"}),
            ("-g -f 3", {"rare_freq": 3}, {"backend": "direct"},
             {".mems"})):
        opts = options.normalize(N_DOCS, quiet=True, **kw)
        with tempfile.TemporaryDirectory() as tmp:
            gpu = _written(engine, rb, opts, "cuda", tmp, "cuda", **run_kw)
            t0 = time.perf_counter()
            cpu = _written(engine, rb, opts, "cpu", tmp, "cpu", **run_kw)
            cpu_s = time.perf_counter() - t0
        sizes = {ext: len(b) for ext, b in sorted(gpu.items())}
        log(f"[bytes] 1 Mbp {label}: cuda {sizes} (cpu path {cpu_s:.1f}s)")
        if gpu != cpu or set(gpu) != exts or not all(gpu.values()):
            raise AssertionError(f"1 Mbp {label}: cuda files != cpu files")
        same[label] = sizes

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

    tiny = refbuilder.build_from_sequences([[d] for d in _tiny_mem_docs(4)])
    for k, f, F in ((0, 2, 0), (0, 3, 0), (2, 2, 0), (0, 0, 0), (0, 2, -1)):
        topts = options.normalize(tiny.num_docs, num_distinct_docs=k,
                                  rare_freq=f, max_mem_freq=F, quiet=True)
        got = engine.find_matches(tiny, topts, device="cuda").output_bytes()
        want = naive.oracle_output(tiny, topts)
        log(f"[bytes] tiny .mems k={k} f={f} F={F}: {len(want)} oracle bytes")
        if got != want or (F >= 0 and not want):
            raise AssertionError(f"tiny k={k} f={f} F={F}: cuda .mems != "
                                 "oracle.naive")
        checked.append(f".mems k={k} f={f} F={F}")
    topts = options.normalize(tiny.num_docs, merge=True, quiet=True)
    got = engine.find_matches(tiny, topts, device="cuda")
    finder = naive.run_finder(tiny, topts)
    fwd, rev = engine.thresh_arrays(got, tiny.seq_lengths[0] // 2)
    fo, ro = finder.thresh_arrays()
    if not ((got.candidate_thresh == np.asarray(finder.candidate_thresh)
             ).all() and np.array_equal(fwd, fo) and np.array_equal(rev, ro)
            and fwd.any()):
        raise AssertionError("tiny -M: cuda threshold arrays != oracle.naive")
    log(f"[bytes] tiny -M: thresholds == oracle ({fwd.size} slots)")
    checked.append("-M thresholds")
    report["bytes"] = {"1mbp_cuda_eq_cpu": same, "oracle": checked}


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
    phase_probe(torch, report)
    phase_build(report)
    phase_kernel(torch, report)
    mums_8mbp = phase_end_to_end(torch, report)
    phase_mem(torch, report)
    phase_walk(torch, report)
    phase_routes(torch, report, mums_8mbp)
    phase_bytes(torch, report)
    if "jax" in sys.modules:
        raise AssertionError("chip_smoke imported jax")
    report["total_s"] = time.perf_counter() - t_all

    t8 = report["kernel_timings"]["8mbp"]
    paths = [*report["e2e"].values(), *report["mem"].values(),
             report["walk"], report["routes"]["-g"]]
    report["path_launches"] = {p["label"]: p["launches"] for p in paths}
    for label in ("-P", "-p", "-A", "-a"):
        report["path_launches"][label] = report["routes"][
            "-P -p" if label in ("-P", "-p") else "-A -a"][label + "_launches"]
    pr = report["probe"]
    kernels = {"kernels": [{
        "name": "kr_break_mask", "route": "cuda", "source": KR_SOURCE,
        "replaces": KR_REPLACES,
        "launches": sum(v["kr_break_mask"]
                        for v in report["path_launches"].values()),
        "max_abs_err": report["kernel_max_abs_err"], "ms": t8["ms"],
        "plain_ms": t8["plain_ms"]}, {
        "name": "add_one", "route": "cuda", "source": PROBE_SOURCE,
        "replaces": PROBE_REPLACES, "launches": pr["launches"],
        "max_abs_err": pr["max_abs_err"], "ms": pr["ms"],
        "plain_ms": pr["plain_ms"]}]}
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
