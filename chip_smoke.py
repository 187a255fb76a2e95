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
     (mask and count exactly equal) over w, mod, ne, all-255 bytes and
     misaligned views, with CUDA-event timings on the 8 and 32 Mbp ext
     arrays beside the memory bound (share of it, bytes per second);
  5. the main path end to end on the bench input (_synth_collection,
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
     -g's .mums and .mems with -f 3) and against the port's oracle.naive
     on tiny collections (.mums with and without N bases, .mems for five
     k/f/F settings, the -M threshold arrays);
 10. the library, MumemtoM and the OOM fallback: library.mum on phase 5's
     8 Mbp collection (its arrays must equal phase 5's), library.mem with
     max_doc_freq=3 (phase 6's count), the oracle-free property checks of
     phase 5's and phase 6's -f 3 results; the CLI's union run from 8
     FASTAs, then MumemtoM runs of 2 partitions, anchor and string merged,
     whose MUM sets must equal the union's except for MUMs that touch a
     document's first or last base (counted); the CLI under a device
     memory cap between the union's and the largest partition's peak,
     which must hit a real torch.cuda.OutOfMemoryError, fall back to
     partitions and give the anchor-merged set; and the merge
     subcommand's files at 1 Mbp on cuda against --device cpu;
 11. the sharded scan, the collective merge and the C ABI, every shard on
     the one card: find_matches_seq_sharded with 2, 4 and 8 shards on
     phase 5's 8 Mbp input (bytes equal to phase 5's; wall, time per stage
     and peak memory beside a single-device run of the same call), -f 3
     and -M with 4 shards (bytes equal to phase 6's, .thresh/.thresh_rev
     equal to a single-device -M run's), the 32 Mbp tier with 8 shards
     (bytes equal to phase 5's), the CLI with --seq-shards 4 on phase 10's
     FASTAs (.mums equal to phase 10's union), merge --collective on phase
     10's anchor partitions (files equal to phase 10's host anchor merge;
     the fold timed on the card), and a C program (native/test_capi.c
     built against the port's libmumemto_tpu_torch.so) whose lines must
     equal library.mum's, or "capi: skipped" where Python has no shared
     library or there is no gcc/g++;
 12. the sharded dictionary index, the partition mesh program and the
     multi-process placement: find_matches_seq_sharded(shard_dict=True)
     with 2, 4 and 8 shards at 8 Mbp, -f 3 and -M with 4 shards and the 32
     Mbp tier with 8, every shard on the one card (bytes equal to phase
     5's and 6's; wall, the dict_index stage and the peak beside phase
     11's run of the same shard count, the counted block sorts), the
     sharded index's tables against the single-device index's at 8 Mbp;
     parallel/partition's match program on 4 partitions of 2 x 0.5 Mbp
     (each partition's bytes equal to the direct backend's, the step's
     total, the one-collection scan, a WindowCapacityError at M = 4); and
     parallel/dcn with two worker processes that share the card, gloo over
     127.0.0.1, on phase 10's FASTAs, host fold and collective fold (files
     equal to phase 10's MumemtoM anchor run's).
`python3 chip_smoke.py --cards` is another, shorter program for a machine
with several cards: the 8-shard scan spread over them with the dictionary
index on one device and sharded, wall and peak per card (cards_main).
Every path of phases 5-8 and 10-12 is driven with the kernels' launch counts
set to 0 just before it and read just after; each PFP path (and -P, -A,
and every path of phase 10) must have launched the KR kernel, and -g, -p
and -a must have launched none. The
line before the last is the kernels' JSON record, the last line is
{"ok": true, "device": {...}}. Everything is also written to
chiprun_out/chip_smoke.json. Imports nothing of JAX and nothing of the
JAX package, mumemto_tpu; native/baseline_cpu is run as a program.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
KR_SOURCE = "mumemto_tpu_torch/kernels/csrc/kr_mask.cu"
KR_REPLACES = "mumemto_tpu/ops/pallas_kernels.py:103"
PROBE_SOURCE = "mumemto_tpu_torch/kernels/csrc/add_one.cu"
PROBE_REPLACES = "tools/mosaic_probe.py:25"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (the data sheet's peak)
N_DOCS = 8
EXPECT_8MBP = 6759  # bench tier match count (README.md, BASELINE.md)
EXPECT_F3_8MBP = 13522  # -f 3 on the same input (native/baseline_cpu)
EXPECT_32MBP = 27119  # the 32 Mbp tier (native/baseline_cpu)


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


class SumTimer(StageTimer):
    """A StageTimer that adds up the stages called more than once (the
    sharded scan's analyze and compact, once per shard)."""

    def __call__(self, name):
        before = self.stages.get(name, 0.0)
        super().__call__(name)
        self.stages[name] += before


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


def _synth_collection(total_mbp: float, n_docs: int, seed: int = 0,
                      snp_rate: float = 0.001):
    """The bench collection (the same bytes as bench.py's synth_collection
    for the same arguments): n_docs mutated copies of one random base
    sequence, ~total_mbp Mbp in all before revcomp, 0.1% SNPs by default
    (the pairwise divergence of human haplotypes)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    base_len = int(total_mbp * 1e6 / n_docs)
    base = rng.integers(0, 4, base_len, dtype=np.int8)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    docs = []
    for _ in range(n_docs):
        s = base.copy()
        n_mut = max(1, int(base_len * snp_rate))
        pos = rng.integers(0, base_len, n_mut)
        s[pos] = (s[pos] + rng.integers(1, 4, n_mut)) % 4
        docs.append(acgt[s])
    return docs


def _run_cpu_baseline(text, seq_lengths, opts, mbp):
    """(Mbp/s, matches) of one run of native/baseline_cpu, the single-core
    C++ SA-IS + Kasai + LCP-interval scan, on the same input; the binary
    is built first by native/build_baseline.py when missing or stale."""
    import tempfile
    built = subprocess.run(
        [sys.executable, os.path.join(ROOT, "native", "build_baseline.py")],
        capture_output=True, text=True, timeout=600)
    if built.returncode != 0:
        raise AssertionError(f"native/baseline_cpu did not build: "
                             f"{built.stdout} {built.stderr[-2000:]}")
    with tempfile.TemporaryDirectory() as td:
        tf = os.path.join(td, "text.bin")
        lf = os.path.join(td, "lens.txt")
        with open(tf, "wb") as f:
            f.write(text.tobytes())
        with open(lf, "w") as f:
            f.write("".join(f"{n}\n" for n in seq_lengths))
        out = subprocess.run(
            [os.path.join(ROOT, "native", "baseline_cpu"), tf, lf,
             str(opts.min_match_len), str(opts.num_distinct),
             str(opts.max_doc_freq), str(opts.max_total_freq),
             str(int(opts.no_max_freq)), str(int(opts.use_revcomp)), "1"],
            capture_output=True, text=True, timeout=3600)
    if out.returncode != 0:
        raise AssertionError(f"native/baseline_cpu failed: "
                             f"{out.stderr[-2000:]}")
    r = json.loads(out.stdout)
    return mbp / r["t_total"], r["matches"]


def _bench_rb(mbp: float, seed: int = 0, n_docs: int = N_DOCS):
    """The bench collection as a RefBuilder at `mbp` Mbp."""
    import numpy as np
    from mumemto_tpu_torch.refbuilder import RefBuilder, revcomp
    docs = _synth_collection(mbp, n_docs, seed=seed)
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
    # the one PyTorch call for the same function, timed for the kernels line
    # only: the port calls it nowhere
    library_ms = statistics.median(
        _event_ms(torch, lambda: torch.add(tile, 1), 500) for _ in range(5))
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
                       **tile_t, "library_ms": library_ms, "2^26": big_t,
                       "host_split_us": _host_split(torch, probe, tile)}
    log(f"[probe] add_one == plain on {len(cases)} cases; (8, 128) median "
        f"kernel {tile_t['ms']:.5f} ms, plain {tile_t['plain_ms']:.5f} ms, "
        f"torch.add {library_ms:.5f} ms "
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
    kr_mask.launcher()
    probe._kernel()
    report["build_s"] = time.perf_counter() - t0
    report["kernel_sources"] = names
    log(f"[build] {', '.join(names)} built and loaded in "
        f"{report['build_s']:.2f}s")


def phase_kernel(torch, report):
    """Kernel vs plain on the card: exact mask and count on a grid of w,
    mod, ne and byte values and on misaligned views; then timings on the
    real 8 and 32 Mbp ext arrays beside the memory bound (ext read once,
    the mask written once, over HBM_BYTES_PER_S)."""
    import numpy as np
    from mumemto_tpu_torch.kernels import kr_mask
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    acgt = np.frombuffer(b"ACGT", np.uint8)

    def synth(ne, n_text, w, kind):
        ext = np.zeros(ne, np.uint8)
        ext[0] = 2
        if kind == "acgt":
            body = acgt[rng.integers(0, 4, n_text)]
        elif kind == "ff":  # the largest partial sums
            body = np.full(n_text, 255, np.uint8)
        else:
            body = rng.integers(0, 256, n_text).astype(np.uint8)
        ext[1:n_text + 1] = body
        ext[n_text + 1:n_text + 1 + w] = 2
        return torch.from_numpy(ext).to(dev)

    cases = [("acgt 2^24", 1 << 24, (1 << 24) - 64, 10, 100, "acgt"),
             ("acgt 2^26", 1 << 26, (1 << 26) - 64, 10, 100, "acgt"),
             ("random bytes 2^20", 1 << 20, (1 << 20) - 40, 10, 100, "bytes"),
             ("odd ne", 300001, 299000, 10, 100, "bytes"),
             ("small ne", 1000, 700, 10, 100, "acgt"),
             ("n_text < w", 64, 5, 10, 100, "acgt"),
             ("w=4", 77777, 70000, 4, 100, "acgt"),
             ("w=16", 77777, 70000, 16, 100, "bytes"),
             ("w=16 mod 7", 4097, 4000, 16, 7, "acgt"),
             ("w=700", 50021, 45000, 700, 100, "bytes"),
             ("w=50000 (above 48 KiB of shared memory)", 120007, 110000,
              50000, 3, "bytes")]
    cases += [(f"w={w} mod={mod} {kind}", 77777, 70000, w, mod, kind)
              for w in (1, 2, 17, 33) for mod in (1, 7, 100, 2**31 - 1)
              for kind in ("bytes", "ff")]
    max_err = 0

    def check(name, ext, n_text, w, mod):
        nonlocal max_err
        m_k, c_k = kr_mask.break_mask(ext, n_text, w, mod)
        torch.cuda.synchronize()
        m_p, c_p = kr_mask.break_mask_plain(ext, n_text, w, mod)
        err = max(int((m_k != m_p).sum()), abs(int(c_k) - int(c_p)))
        max_err = max(max_err, err)
        log(f"[kernel] {name}: ne={ext.numel()} n_text={n_text} w={w} "
            f"mod={mod} count kernel={int(c_k)} plain={int(c_p)} "
            f"mismatches={err}")
        if err:
            raise AssertionError(f"kr_mask kernel != plain on {name}")

    for name, ne, n_text, w, mod, kind in cases:
        check(name, synth(ne, n_text, w, kind), n_text, w, mod)
    # views that start off a 16-byte boundary: the kernel's byte loads
    whole = synth(100003, 99000, 10, "bytes")
    for off in (1, 3, 8):
        view = whole[off:]
        if view.data_ptr() % 16 == 0:
            raise AssertionError("the view is 16-byte aligned: the byte "
                                 "path was not exercised")
        check(f"misaligned view ext[{off}:]", view, 99000 - off, 10, 100)
    report["kernel_max_abs_err"] = max_err
    report["kernel_cases"] = len(cases) + 3

    # timings at the main path's shapes: the real 8/32 Mbp ext arrays
    fn, _ = kr_mask.launcher()
    timings = {}
    for mbp in (8, 32):
        text = _bench_rb(mbp).text
        ext_np = _ext_of(text, 10)
        ext = torch.from_numpy(ext_np).to(dev)
        n_text = int(text.size)
        ne = int(ext.numel())
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
        # the launcher alone (memset + kernel) on preallocated outputs: on
        # one ext, and on copies that exceed the 50 MB L2 together
        copies = max(2, (160 << 20) // (2 * ne) + 1)
        exts = [ext] + [ext.clone() for _ in range(copies - 1)]
        masks = [torch.empty(ne, dtype=torch.bool, device=dev) for _ in exts]
        count = torch.empty((), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        turn = [0]

        def bare(n):
            i = turn[0] = (turn[0] + 1) % n
            rc = fn(exts[i].data_ptr(), masks[i].data_ptr(), count.data_ptr(),
                    ne, n_text, 10, 100, stream)
            if rc != 0:
                raise RuntimeError(f"kr_break_mask: CUDA error {rc}")
        warm_ms = min(_event_ms(torch, lambda: bare(1), 50) for _ in range(3))
        cold_ms = min(_event_ms(torch, lambda: bare(copies), 50)
                      for _ in range(3))
        if not bool((masks[turn[0]] == m_p).all()) or int(count) != int(c_p):
            raise AssertionError(f"bare launch != plain at {mbp} Mbp")
        del exts, masks
        bound_ms = 2 * ne / HBM_BYTES_PER_S * 1e3
        best = min(ms, ms2)
        timings[f"{mbp}mbp"] = {
            "ne": ne, "ms": best, "ms_runs": [ms, ms2], "plain_ms": plain_ms,
            "breaks": int(c_k), "bound_ms": bound_ms, "bound_by": "bytes",
            "share_of_bound": bound_ms / best, "gb_per_s": 2 * ne / best / 1e6,
            "launcher_ms_one_ext": warm_ms, "launcher_ms_cold_l2": cold_ms,
            "launcher_cold_share_of_bound": bound_ms / cold_ms,
            "launcher_cold_gb_per_s": 2 * ne / cold_ms / 1e6}
        log(f"[kernel] {mbp} Mbp ext ne={ne}: wrapper {ms:.4f} / {ms2:.4f} "
            f"ms ({bound_ms / best:.1%} of the {bound_ms:.4f} ms bound, "
            f"{2 * ne / best / 1e6:.0f} GB/s), plain {plain_ms:.4f} ms "
            f"({int(c_k)} breaks); launcher alone {warm_ms:.4f} ms on one "
            f"ext, {cold_ms:.4f} ms with a cold L2 "
            f"({bound_ms / cold_ms:.1%} of the bound, "
            f"{2 * ne / cold_ms / 1e6:.0f} GB/s)")
    report["kernel_timings"] = timings


def _drive(torch, label, rb, opts, mbp, backend="pfp"):
    """One path end to end on the card: a cold and a warm find_matches with
    the kernels' launch counts set to 0 just before and read just after,
    then a live native/baseline_cpu run with the same options. The match
    count must equal the baseline's and be above 0. The PFP backend must
    have launched the KR kernel in both runs, the direct backend never.
    Returns (record, warm result)."""
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
    base_mbp_s, base_matches = _run_cpu_baseline(rb.text, rb.seq_lengths,
                                                 opts, mbp)
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


def phase_end_to_end(torch, report):
    """Strict multi-MUMs at 8 and 32 Mbp (windowed scan, cap 16); returns
    the 8 Mbp result and the 32 Mbp run's .mums bytes."""
    from mumemto_tpu_torch import options
    report["e2e"] = {}
    for mbp in (8, 32):
        entry, res = _drive(torch, f"e2e {mbp} Mbp", _bench_rb(mbp),
                            options.normalize(N_DOCS, quiet=True), mbp)
        report["e2e"][f"{mbp}mbp"] = entry
        if mbp == 8:
            if entry["matches"] != EXPECT_8MBP:
                raise AssertionError(f"8 Mbp: {entry['matches']} matches, "
                                     f"expected {EXPECT_8MBP}")
            res_8mbp = res
    return res_8mbp, res.output_bytes()


def phase_mem(torch, report):
    """Multi-MEMs: -f 3 (cap 32, windowed with the global prev-same-doc
    chain) at 8 and 32 Mbp, -f 0 -F 0 (uncapped) at 8 Mbp; returns the
    -f 3 8 Mbp result."""
    from mumemto_tpu_torch import options
    report["mem"] = {}
    for f, mbp in ((3, 8), (0, 8), (3, 32)):
        opts = options.normalize(N_DOCS, rare_freq=f, max_mem_freq=0,
                                 quiet=True)
        entry, res = _drive(torch, f"mem -f {f} -F 0 {mbp} Mbp",
                            _bench_rb(mbp), opts, mbp)
        report["mem"][f"f{f} {mbp}mbp"] = entry
        if (f, mbp) == (3, 8):
            res_f3 = res
    return res_f3


def phase_walk(torch, report):
    """128 docs of 62.5 kbp, strict MUMs: cap 256, the probe-guarded walk."""
    from mumemto_tpu_torch import options
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
    from mumemto_tpu_torch import formats, options
    from mumemto_tpu_torch.refbuilder import RefBuilder
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
    from mumemto_tpu_torch import options, refbuilder
    from mumemto_tpu_torch.oracle import naive
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

    rng = np.random.default_rng(3)
    checked = []
    for label, with_n in (("acgt", False), ("with N", True)):
        docs = _synth_collection(0.003, 3, seed=2, snp_rate=0.004)
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


def _kr_used(label, launches):
    """A path of the slice must have launched the KR kernel, and nothing
    of it the probe kernel."""
    if launches["kr_break_mask"] < 1 or launches["add_one"]:
        raise AssertionError(f"{label}: kernel launches {launches}")


def _write_fastas(docs, tmp):
    paths = []
    for i, fwd in enumerate(docs):
        path = os.path.join(tmp, f"d{i}.fa")
        with open(path, "wb") as fh:
            fh.write(b">d%d\n" % i + fwd.tobytes() + b"\n")
        paths.append(path)
    return paths


def _mums_set(path, num_docs):
    """The .mums file as a set of (length, offsets, strands) records."""
    from mumemto_tpu_torch import formats
    L, S, T = formats.parse_mums(path, num_docs)
    return {(int(l), tuple(s.tolist()), tuple(t.tolist()))
            for l, s, t in zip(L, S, T)}


def _touches_terminal(rec, doc_lens) -> bool:
    """A MUM some occurrence of which holds its doc's first or last base
    or crosses its '$' (forward coordinates [off, off + L))."""
    length, offs, _ = rec
    return any(o == 0 or o + length >= dl
               for o, dl in zip(offs, doc_lens) if o >= 0)


def _partition_spy(torch, mumemtom, kr_mask, parts):
    """A scan_partition that records each partition's docs, seconds, KR
    launches and peak device memory (allocated and reserved, from an
    emptied cache) in `parts`."""
    real = mumemtom.scan_partition

    def scan(files, pfx, **kw):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = kr_mask.launches
        t0 = time.perf_counter()
        out = real(files, pfx, **kw)
        torch.cuda.synchronize()
        parts.append({"docs": len(files), "s": time.perf_counter() - t0,
                      "kr_launches": kr_mask.launches - before,
                      "peak_alloc_bytes": torch.cuda.max_memory_allocated(),
                      "peak_reserved_bytes":
                          torch.cuda.max_memory_reserved()})
        return out
    return real, scan


def phase_slice(torch, report, res_8mbp, res_f3, work):
    """The library, MumemtoM and the OOM fallback on the 8 Mbp bench
    collection, and the merge subcommand's bytes at 1 Mbp (cuda against
    cpu). Each path's kernel launches are counted around it. The FASTAs,
    the union run's and the partitions' files are left in the directory
    `work` for the next phase."""
    import contextlib
    import io
    import tempfile
    import numpy as np
    from mumemto_tpu_torch import cli, library, properties
    from mumemto_tpu_torch.kernels import kr_mask
    from mumemto_tpu_torch.parallel import mumemtom
    out = {"paths": {}}
    docs = _synth_collection(8, N_DOCS)
    seqs = [[fwd.tobytes()] for fwd in docs]
    lib, s, lm = _counted(torch, lambda: library.mum(seqs, device="cuda"))
    same = (np.array_equal(lib.match_lengths, res_8mbp.lengths)
            and np.array_equal(lib.offsets, res_8mbp.offsets)
            and np.array_equal(lib.strands, res_8mbp.strands > 0))
    out["library.mum"] = {"s": s, "matches": len(lib), "launches": lm,
                          "arrays_equal_phase5": same}
    lib_m, s, lmm = _counted(torch, lambda: library.mem(
        seqs, max_doc_freq=3, device="cuda"))
    out["library.mem -f 3"] = {"s": s, "matches": len(lib_m),
                               "launches": lmm}
    log(f"[slice] library.mum {json.dumps(out['library.mum'])}")
    log(f"[slice] library.mem {json.dumps(out['library.mem -f 3'])}")
    if len(lib) != EXPECT_8MBP or not same:
        raise AssertionError("library.mum 8 Mbp != the main path's result")
    if len(lib_m) != EXPECT_F3_8MBP:
        raise AssertionError(f"library.mem -f 3: {len(lib_m)} matches, "
                             f"expected {EXPECT_F3_8MBP}")
    rb = _bench_rb(8)
    t0 = time.perf_counter()
    n_mum = properties.check_mum_properties(res_8mbp, rb, max_checked=200)
    n_mem = properties.check_mem_properties(res_f3, rb, max_checked=200)
    out["properties"] = {"mums_checked": n_mum, "mems_checked": n_mem,
                         "s": time.perf_counter() - t0}
    log(f"[slice] properties: {json.dumps(out['properties'])}")
    out["paths"].update({"library.mum": lm, "library.mem": lmm})

    doc_lens = [int(d.size) for d in docs]
    with contextlib.nullcontext(work) as tmp:
        fastas = _write_fastas(docs, tmp)
        union = os.path.join(tmp, "union")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        rc, s, lu = _counted(torch, lambda: cli.main(
            fastas + ["-o", union]))
        peak_union = torch.cuda.max_memory_allocated()
        want = _mums_set(union + ".mums", N_DOCS)
        out["union"] = {"rc": rc, "s": s, "launches": lu,
                        "matches": len(want), "peak_alloc_bytes": peak_union}
        log(f"[slice] cli union: {json.dumps(out['union'])}")
        if rc != 0 or len(want) != EXPECT_8MBP:
            raise AssertionError("cli union 8 Mbp failed")
        out["paths"]["cli union"] = lu
        merged = {}
        for anchor in (True, False):
            label = "mumemtom " + ("anchor" if anchor else "string")
            parts = []
            real, spy = _partition_spy(torch, mumemtom, kr_mask, parts)
            mumemtom.scan_partition = spy
            try:
                path, s, lp = _counted(
                    torch, lambda: mumemtom.run_partitioned_files(
                        fastas, os.path.join(tmp, label.split()[1]),
                        num_partitions=2, anchor=anchor, device="cuda"))
            finally:
                mumemtom.scan_partition = real
            got = _mums_set(path, N_DOCS)
            diff = want ^ got
            terminal = [r for r in diff if _touches_terminal(r, doc_lens)]
            merged[anchor] = got
            out[label] = {"s": s, "launches": lp, "partitions": parts,
                          "merge_kr_launches": lp["kr_break_mask"] - sum(
                              p["kr_launches"] for p in parts),
                          "matches": len(got), "only_union": len(want - got),
                          "only_merged": len(got - want),
                          "terminal_touching_differences": len(terminal),
                          "union_terminal_touching": sum(
                              _touches_terminal(r, doc_lens) for r in want)}
            log(f"[slice] {label} 8 Mbp: {json.dumps(out[label])}")
            if len(terminal) != len(diff) or any(p["kr_launches"] < 1
                                                 for p in parts):
                raise AssertionError(f"{label}: {len(diff) - len(terminal)} "
                                     "MUMs differ from the union's away "
                                     "from the terminators")
            out["paths"][label] = lp

        # the OOM fallback: a cap between the union's and the largest
        # partition's peak, so the union scan fails and partitions fit
        anchor_parts = out["mumemtom anchor"]["partitions"]
        part_alloc = max(p["peak_alloc_bytes"] for p in anchor_parts)
        part_reserved = max(p["peak_reserved_bytes"] for p in anchor_parts)
        lo = part_reserved if part_reserved < peak_union else part_alloc
        if not lo < peak_union:
            raise AssertionError(
                f"no memory cap separates the largest partition's peak "
                f"({part_alloc} B) from the union's ({peak_union} B)")
        cap = int(lo + 0.6 * (peak_union - lo))
        total = torch.cuda.get_device_properties(0).total_memory
        seen = []
        real_is = cli._is_device_oom

        def is_oom(e):
            seen.append(type(e).__name__)
            return real_is(e)
        oom_out = os.path.join(tmp, "oom")
        err = io.StringIO()
        torch.cuda.empty_cache()
        ooms0 = torch.cuda.memory_stats().get("num_ooms", 0)
        cli._is_device_oom = is_oom
        torch.cuda.set_per_process_memory_fraction(cap / total)
        try:
            with contextlib.redirect_stderr(err):
                rc, s, lf = _counted(torch, lambda: cli.main(
                    fastas + ["-o", oom_out]))
        finally:
            torch.cuda.set_per_process_memory_fraction(1.0)
            cli._is_device_oom = real_is
        ooms = torch.cuda.memory_stats().get("num_ooms", 0) - ooms0
        got = _mums_set(oom_out + ".mums", N_DOCS) if rc == 0 else set()
        out["oom fallback"] = {
            "rc": rc, "s": s, "launches": lf, "cap_bytes": cap,
            "union_peak_alloc_bytes": peak_union,
            "partition_peak_alloc_bytes": part_alloc,
            "partition_peak_reserved_bytes": part_reserved,
            "allocator_ooms": ooms, "errors_seen": seen,
            "two_partitions": "retrying as 2 MumemtoM" in err.getvalue()
            and "retrying as 4" not in err.getvalue(),
            "equals_anchor_merge": got == merged[True]}
        log(f"[slice] OOM fallback: {json.dumps(out['oom fallback'])}")
        if (rc != 0 or ooms < 1 or "OutOfMemoryError" not in seen
                or got != merged[True]):
            raise AssertionError(f"OOM fallback failed: {err.getvalue()}")
        out["paths"]["oom fallback"] = lf

    # the merge subcommand at 1 Mbp: its files on cuda == on cpu
    docs1 = _synth_collection(1, N_DOCS, seed=1)
    out["merge 1mbp"] = {}
    with tempfile.TemporaryDirectory() as tmp:
        fastas = _write_fastas(docs1, tmp)
        for anchor, exts in ((True, (".mums", ".lengths", ".athresh")),
                             (False, (".mums", ".lengths", ".thresh",
                                      ".thresh_rev"))):
            label = "anchor" if anchor else "string"
            pre = os.path.join(tmp, label)
            _, s, lp = _counted(torch, lambda: mumemtom.run_partitioned_files(
                fastas, pre, num_partitions=2, anchor=anchor, device="cuda"))
            t0 = time.perf_counter()
            rc = cli.main(["merge", f"{pre}_part0.mums", f"{pre}_part1.mums",
                           "-o",
                           pre + "_cpu", "--device", "cpu"])
            cpu_s = time.perf_counter() - t0
            sizes = {}
            for ext in exts:
                with open(pre + ext, "rb") as a, \
                        open(pre + "_cpu" + ext, "rb") as b:
                    ga, gb = a.read(), b.read()
                if rc != 0 or ga != gb or not ga:
                    raise AssertionError(f"merge 1 Mbp {label}: {ext} on "
                                         "cuda != cpu")
                sizes[ext] = len(ga)
            out["merge 1mbp"][label] = {"s": s, "cpu_merge_s": cpu_s,
                                        "launches": lp, "sizes": sizes}
            log(f"[slice] merge 1 Mbp {label}: cuda == cpu "
                f"{json.dumps(out['merge 1mbp'][label])}")
            out["paths"][f"merge 1 Mbp {label}"] = lp
    for label, launches in out["paths"].items():
        _kr_used(label, launches)
    report["slice"] = out


def _drive_sharded(torch, label, rb, opts, nshards, want_bytes, M,
                   shard_dict=False):
    """One sharded scan on the card, every shard on cuda:0: a cold and a
    warm find_matches_seq_sharded (with the dictionary index sharded too
    when shard_dict), each with the kernels' launch counts
    set to 0 just before and read just after (each must launch the KR
    kernel exactly once and the probe kernel never), the warm one under a
    per-stage timer and a fresh peak-memory counter. The output bytes of
    both runs must equal want_bytes. Returns (record, warm result)."""
    from mumemto_tpu_torch.parallel import mesh, seqpfp
    devices = mesh.seq_devices(nshards, "cuda")
    cold, cold_s, l_cold = _counted(
        torch, lambda: seqpfp.find_matches_seq_sharded(
            rb, opts, devices, M=M, shard_dict=shard_dict))
    torch.cuda.reset_peak_memory_stats()
    timer = SumTimer(torch)
    res, wall, l_warm = _counted(
        torch, lambda: seqpfp.find_matches_seq_sharded(
            rb, opts, devices, M=M, phase=timer, shard_dict=shard_dict))
    entry = {"label": label, "shards": nshards, "shard_dict": shard_dict,
             "devices": sorted({str(d) for d in devices}),
             "sort_rounds": seqpfp.sort_rounds(nshards), "M": M,
             "matches": res.num_matches, "wall_s": wall,
             "cold_wall_s": cold_s, "stages_s": timer.stages,
             "peak_alloc_bytes": torch.cuda.max_memory_allocated(),
             "launches": l_warm, "cold_launches": l_cold,
             "bytes_equal_single_device":
                 res.output_bytes() == want_bytes == cold.output_bytes()}
    log(f"[sharded] {label}: {json.dumps(entry)}")
    for launches in (l_cold, l_warm):
        if launches != {"kr_break_mask": 1, "add_one": 0}:
            raise AssertionError(f"{label}: kernel launches {launches}, "
                                 "expected exactly 1 KR launch")
    if not entry["bytes_equal_single_device"]:
        raise AssertionError(f"{label}: bytes != the single-device run's")
    return entry, res


def _capi(torch, report_out):
    """The C ABI on the card: build the port's shared library, compile
    native/test_capi.c against it unchanged, feed it 3 documents with
    MUMEMTO_TORCH_DEVICE=cuda and hold every line against library.mum on
    the same documents. Skipped, with the reason recorded, where this
    Python has no shared library or a compiler is missing; any failure
    after that check raises. The documents are 60 kbp: test_capi.c reads
    lines of at most 65535 characters."""
    import shutil
    import sysconfig
    from mumemto_tpu_torch import library
    missing = [what for what, ok in (
        ("Py_ENABLE_SHARED", sysconfig.get_config_var("Py_ENABLE_SHARED")),
        ("g++", shutil.which("g++")), ("gcc", shutil.which("gcc")))
        if not ok]
    if missing:
        log(f"capi: skipped ({', '.join(missing)} missing)")
        report_out["capi"] = {"skipped": missing}
        return
    capi = os.path.join(ROOT, "mumemto_tpu_torch", "capi")
    t0 = time.perf_counter()
    built = subprocess.run(
        [sys.executable, os.path.join(capi, "build_capi.py"), "--force"],
        capture_output=True, text=True, timeout=300)
    if built.returncode != 0:
        raise AssertionError(f"capi: the library did not build: "
                             f"{built.stdout} {built.stderr[-2000:]}")
    docs = [d.tobytes().decode() for d in
            _synth_collection(0.18, 3, seed=5, snp_rate=0.002)]
    with tempfile.TemporaryDirectory() as tmp:
        exe = os.path.join(tmp, "test_capi")
        cc = subprocess.run(
            ["gcc", "-O2", "-o", exe,
             os.path.join(ROOT, "native", "test_capi.c"),
             "-I" + os.path.join(ROOT, "native"), "-L" + capi,
             "-Wl,-rpath," + capi, "-lmumemto_tpu_torch"],
            capture_output=True, text=True, timeout=300)
        if cc.returncode != 0:
            raise AssertionError(f"capi: test_capi.c did not compile: "
                                 f"{cc.stderr[-2000:]}")
        build_s = time.perf_counter() - t0
        env = dict(os.environ, MUMEMTO_TPU_PYROOT=ROOT,
                   MUMEMTO_TORCH_DEVICE="cuda")
        env.pop("MUMEMTO_TPU_CABI_PRELUDE", None)
        t0 = time.perf_counter()
        run = subprocess.run([exe], input="\n".join(docs) + "\n",
                             capture_output=True, text=True, env=env,
                             timeout=600)
        run_s = time.perf_counter() - t0
    if run.returncode != 0:
        raise AssertionError(f"capi: the C program failed: "
                             f"{run.stderr[-2000:]}")
    want, s, launches = _counted(
        torch, lambda: library.mum([[d] for d in docs], device="cuda"))
    lines = run.stdout.splitlines()
    if len(lines) != len(want) or not lines:
        raise AssertionError(f"capi: {len(lines)} lines, library.mum has "
                             f"{len(want)} matches")
    for i, line in enumerate(lines):
        L, offs, strands = want.match_at(i)
        expect = "%d\t%s\t%s" % (L, ",".join(str(int(o)) for o in offs),
                                 "".join("+" if t else "-" for t in strands))
        if line != expect:
            raise AssertionError(f"capi: line {i} {line!r} != {expect!r}")
    report_out["capi"] = {"docs": [len(d) for d in docs], "build_s": build_s,
                          "process_s": run_s, "lines": len(lines),
                          "library_mum_s": s, "library_launches": launches}
    report_out["paths"]["library.mum (capi's documents)"] = launches
    log(f"[sharded] capi: {json.dumps(report_out['capi'])}")


def phase_sharded(torch, report, res_8mbp, res_f3, mums_32mbp, work):
    """The sharded scan (--seq-shards), the collective merge and the C ABI
    on one card; `work` holds phase 10's FASTAs, union run and anchor
    partitions. Every comparison is of bytes, and any mismatch raises."""
    from mumemto_tpu_torch import cli, engine, options
    from mumemto_tpu_torch.analysis import merge as merge_mod
    from mumemto_tpu_torch.parallel import collective_merge
    out = {"paths": {}, "scans": {}}
    rb = _bench_rb(8)
    opts = options.normalize(N_DOCS, quiet=True)

    # the same call unsharded, for the wall and the peak beside it
    torch.cuda.reset_peak_memory_stats()
    timer = StageTimer(torch)
    single, s, l1 = _counted(torch, lambda: engine.find_matches(
        rb, opts, device="cuda", phase=timer))
    out["single device 8 Mbp"] = {
        "wall_s": s, "stages_s": timer.stages, "launches": l1,
        "peak_alloc_bytes": torch.cuda.max_memory_allocated()}
    log(f"[sharded] single device 8 Mbp: "
        f"{json.dumps(out['single device 8 Mbp'])}")
    want = res_8mbp.output_bytes()
    if single.output_bytes() != want:
        raise AssertionError("the single-device rerun != phase 5's bytes")
    for nshards in (2, 4, 8):
        label = f"MUM 8 Mbp, {nshards} shards"
        entry, res = _drive_sharded(torch, label, rb, opts, nshards, want,
                                    M=8192)
        if entry["matches"] != EXPECT_8MBP or \
                res.bwt_runs != res_8mbp.bwt_runs:
            raise AssertionError(f"{label}: {entry['matches']} matches, "
                                 f"{res.bwt_runs} BWT runs")
        out["scans"][label] = entry
        out["paths"][label] = entry["launches"]

    opts_f3 = options.normalize(N_DOCS, rare_freq=3, max_mem_freq=0,
                                quiet=True)
    label = "-f 3 8 Mbp, 4 shards"
    entry, res = _drive_sharded(torch, label, rb, opts_f3, 4,
                                res_f3.output_bytes(), M=1 << 16)
    if entry["matches"] != EXPECT_F3_8MBP:
        raise AssertionError(f"{label}: {entry['matches']} matches")
    out["scans"][label] = entry
    out["paths"][label] = entry["launches"]

    # -M: the sharded run's .thresh/.thresh_rev against a single-device
    # run. M bounds a shard's candidates too, and every suffix of a MUM
    # that is still 20 long is one: about a million in all here
    opts_m = options.normalize(N_DOCS, merge=True, quiet=True)
    label = "-M 8 Mbp, 4 shards"
    with tempfile.TemporaryDirectory() as tmp:
        files = _written(engine, rb, opts_m, "cuda", tmp, "single")
        entry, res = _drive_sharded(torch, label, rb, opts_m, 4,
                                    files[".mums"], M=1 << 20)
        engine.write_outputs(res, rb, os.path.join(tmp, "sharded"))
        for ext in (".mums", ".thresh", ".thresh_rev"):
            with open(os.path.join(tmp, "sharded" + ext), "rb") as fh:
                if fh.read() != files[ext] or not files[ext]:
                    raise AssertionError(f"{label}: {ext} != the "
                                         "single-device run's")
        entry["thresh_bytes"] = len(files[".thresh"])
    out["scans"][label] = entry
    out["paths"][label] = entry["launches"]

    # the slice's full width: the 32 Mbp tier, nr = 2^26, 8 shards
    label = "MUM 32 Mbp, 8 shards"
    entry, res = _drive_sharded(torch, label, _bench_rb(32), opts, 8,
                                mums_32mbp, M=8192)
    if entry["matches"] != EXPECT_32MBP:
        raise AssertionError(f"{label}: {entry['matches']} matches, "
                             f"expected {EXPECT_32MBP}")
    out["scans"][label] = entry
    out["paths"][label] = entry["launches"]
    del res

    # the CLI: --seq-shards 4 on phase 10's FASTAs against its union run
    fastas = [os.path.join(work, f"d{i}.fa") for i in range(N_DOCS)]
    sharded = os.path.join(work, "seq4")
    rc, s, lc = _counted(torch, lambda: cli.main(
        fastas + ["-o", sharded, "--seq-shards", "4"]))
    with open(sharded + ".mums", "rb") as a, \
            open(os.path.join(work, "union.mums"), "rb") as b:
        same = a.read() == b.read()
    out["cli --seq-shards 4"] = {"rc": rc, "s": s, "launches": lc,
                                 "mums_equal_union": same}
    log(f"[sharded] cli --seq-shards 4: "
        f"{json.dumps(out['cli --seq-shards 4'])}")
    if rc != 0 or not same or lc["kr_break_mask"] != 1:
        raise AssertionError("cli --seq-shards 4: .mums != the union run's")
    out["paths"]["cli --seq-shards 4"] = lc

    # merge --collective on phase 10's anchor partitions (5 + 4 docs)
    parts = [os.path.join(work, f"anchor_part{i}.mums") for i in range(2)]
    coll = os.path.join(work, "anchor_collective")
    rc, s, lm = _counted(torch, lambda: cli.main(
        ["merge", *parts, "-o", coll, "--collective", "--device", "cuda"]))
    sizes = {}
    for ext in (".mums", ".athresh", ".lengths"):
        with open(coll + ext, "rb") as a, \
                open(os.path.join(work, "anchor" + ext), "rb") as b:
            ga, gb = a.read(), b.read()
        if rc != 0 or ga != gb or not ga:
            raise AssertionError(f"merge --collective: {ext} != the host "
                                 "anchor merge's")
        sizes[ext] = len(ga)
        if ext == ".mums":
            merged_mums = ga.count(b"\n")
    if any(lm.values()):
        raise AssertionError(f"merge --collective launched kernels: {lm}")
    # the fold alone, on the card, at these partitions' n_anchor
    cands = [merge_mod.parse_candidate(p) for p in parts]
    n_anchor = int(cands[0][4].size)
    dense = collective_merge._dense_arrays(cands, n_anchor)
    devices = [torch.device("cuda", 0)] * len(parts)
    fold_ms = _event_ms(torch, lambda: collective_merge.collective_fold(
        *dense, devices), 20)
    placed = [torch.from_numpy(a).to(devices[0]) for a in dense]
    fold_only_ms = _event_ms(
        torch, lambda: collective_merge._fold_all(*placed), 20)
    t0 = time.perf_counter()
    merge_mod.anchor_merge(parts, os.path.join(work, "anchor_host_again"))
    host_s = time.perf_counter() - t0
    out["merge --collective"] = {
        "rc": rc, "s": s, "launches": lm, "sizes": sizes,
        "n_anchor": n_anchor, "partitions": len(parts),
        "merged_mums": merged_mums,
        "upload_gather_fold_ms": fold_ms, "fold_ms": fold_only_ms,
        "host_anchor_merge_s": host_s}
    log(f"[sharded] merge --collective: "
        f"{json.dumps(out['merge --collective'])}")

    _capi(torch, out)
    report["sharded"] = out


class _IndexSpy:
    """Counts parallel/sharddict's distributed block sorts and records the
    sizes of each sharded index built while it is active."""

    def __init__(self):
        from mumemto_tpu_torch.parallel import sharddict
        self.mod = sharddict
        self.sorts = 0
        self.built = []

    def __enter__(self):
        mod = self.mod
        self.real = (mod._bitonic_block_sort, mod.compile_sharded_dict_index)

        def sort(blocks, devices, num_keys=2):
            self.sorts += 1
            return self.real[0](blocks, devices, num_keys=num_keys)

        def compile_index(devices, nd, ne, w, lvl_cap, lvl_static, *thr):
            self.built.append({
                "shards": len(devices), "nd": nd, "lvl_cap": lvl_cap,
                "lvl_static": lvl_static,
                "block_sorts_expected": mod.block_sorts(nd, lvl_cap,
                                                        lvl_static)})
            return self.real[1](devices, nd, ne, w, lvl_cap, lvl_static,
                                *thr)
        mod._bitonic_block_sort = sort
        mod.compile_sharded_dict_index = compile_index
        return self

    def __exit__(self, *exc):
        self.mod._bitonic_block_sort, \
            self.mod.compile_sharded_dict_index = self.real


def _shard_dict_scans(torch, out, phase11, res_8mbp, res_f3, mums_32mbp):
    """find_matches_seq_sharded(shard_dict=True) at this slice's full
    width, every shard on cuda:0, each beside phase 11's run of the same
    configuration with the index on one device."""
    from mumemto_tpu_torch import engine, options
    rb = _bench_rb(8)
    opts = options.normalize(N_DOCS, quiet=True)
    opts_f3 = options.normalize(N_DOCS, rare_freq=3, max_mem_freq=0,
                                quiet=True)
    opts_m = options.normalize(N_DOCS, merge=True, quiet=True)
    with tempfile.TemporaryDirectory() as tmp:
        files_m = _written(engine, rb, opts_m, "cuda", tmp, "single")
    configs = [(f"MUM 8 Mbp, {n} shards", rb, opts, n,
                res_8mbp.output_bytes(), 8192, EXPECT_8MBP)
               for n in (2, 4, 8)]
    configs += [("-f 3 8 Mbp, 4 shards", rb, opts_f3, 4,
                 res_f3.output_bytes(), 1 << 16, EXPECT_F3_8MBP),
                ("-M 8 Mbp, 4 shards", rb, opts_m, 4, files_m[".mums"],
                 1 << 20, EXPECT_8MBP),
                ("MUM 32 Mbp, 8 shards", None, opts, 8, mums_32mbp, 8192,
                 EXPECT_32MBP)]
    for label, crb, copts, nshards, want, M, expect in configs:
        crb = crb if crb is not None else _bench_rb(32)
        with _IndexSpy() as spy:
            entry, res = _drive_sharded(torch, label + ", shard_dict", crb,
                                        copts, nshards, want, M,
                                        shard_dict=True)
        if entry["matches"] != expect:
            raise AssertionError(f"{label}, shard_dict: {entry['matches']} "
                                 f"matches, expected {expect}")
        if copts.merge:
            with tempfile.TemporaryDirectory() as tmp:
                engine.write_outputs(res, crb, os.path.join(tmp, "sd"))
                for ext in (".thresh", ".thresh_rev"):
                    with open(os.path.join(tmp, "sd" + ext), "rb") as fh:
                        if fh.read() != files_m[ext] or not files_m[ext]:
                            raise AssertionError(
                                f"{label}, shard_dict: {ext} != the "
                                "single-device run's")
        # a cold and a warm run: two indexes of the same sizes
        built = spy.built
        if len(built) != 2 or built[0] != built[1] or \
                spy.sorts != 2 * built[0]["block_sorts_expected"]:
            raise AssertionError(f"{label}, shard_dict: {spy.sorts} block "
                                 f"sorts for {built}")
        before = phase11[label]
        entry.update(built[0], block_sorts=spy.sorts // 2,
                     replicated={
                         "wall_s": before["wall_s"],
                         "dict_index_s": before["stages_s"]["dict_index"],
                         "peak_alloc_bytes": before["peak_alloc_bytes"]})
        log(f"[shard_dict] {label}: wall {entry['wall_s']:.3f} s "
            f"(index on one device {before['wall_s']:.3f}), dict_index "
            f"{entry['stages_s']['dict_index']:.3f} s "
            f"({before['stages_s']['dict_index']:.3f}), peak "
            f"{entry['peak_alloc_bytes'] / 2**30:.2f} GiB "
            f"({before['peak_alloc_bytes'] / 2**30:.2f}), nd {entry['nd']}, "
            f"lvl_cap {entry['lvl_cap']}, {entry['block_sorts']} block sorts")
        out["scans"][label] = entry
        out["paths"][label + ", shard_dict"] = entry["launches"]
        del res


def _shard_dict_tables(torch, out):
    """The sharded index's tables against the single-device index's on the
    8 Mbp dictionary, in the form that does not depend on the order inside
    a tie block: d, grp_of_pos, grp_cross exactly, lcpD clamped at
    maxlen + 1, isaD at whole-phrase starts."""
    from mumemto_tpu_torch import engine
    from mumemto_tpu_torch.ops import pfp as ops_pfp
    from mumemto_tpu_torch.parallel import mesh, sharddict
    rb = _bench_rb(8)
    dev = engine.resolve("cuda")
    pfp = ops_pfp.build_pfp(rb.text, dev)
    h = ops_pfp._host_prep(pfp, rb.doc_ends)
    arrays = (pfp.ext, h["phrase_st"], h["phrase_ln"], h["d_starts"],
              h["npz"], h["total_real"])
    static = (h["nd"], h["ne"], h["w"], h["lvl_cap"], h["lvl_static"],
              h["seed_thr"], h["lcp_thr"])
    clamp = int(pfp.phrase_ln.max()) + 1
    starts = h["d_starts"][1:h["npz"] + 1].long()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = ops_pfp._dict_index(*arrays, *static)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    entry = {"nd": h["nd"], "lvl_cap": h["lvl_cap"],
             "lvl_static": h["lvl_static"], "clamp": clamp,
             "phrases": h["npz"], "single_device_s": ref_s, "shards": {}}
    for nshards in (1, 4):
        fn = sharddict.compile_sharded_dict_index(
            mesh.seq_devices(nshards, "cuda"), *static)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got = fn(*arrays)
        torch.cuda.synchronize()
        entry["shards"][nshards] = {
            "s": time.perf_counter() - t0,
            "peak_alloc_bytes": torch.cuda.max_memory_allocated()}
        same = {
            "d": torch.equal(ref[0], got[0]),
            "lcpD clamped": torch.equal(torch.clamp(ref[1], max=clamp),
                                        torch.clamp(got[1], max=clamp)),
            "isaD at phrase starts": torch.equal(ref[2][starts],
                                                 got[2][starts]),
            "grp_of_pos": torch.equal(ref[3], got[3]),
            "grp_cross": torch.equal(ref[4], got[4])}
        if not all(same.values()):
            raise AssertionError(f"sharded index, {nshards} shards != the "
                                 f"single-device index: {same}")
        del got
    log(f"[shard_dict] tables 8 Mbp == single-device index: "
        f"{json.dumps(entry)}")
    out["tables 8 Mbp"] = entry


def _partition_mesh(torch, out):
    """parallel/partition on 4 partitions of 2 documents x 0.5 Mbp: each
    partition's windows through the writer against the direct backend's
    bytes, the step's total, the one-collection scan, the capacity error."""
    import numpy as np
    from mumemto_tpu_torch import engine, options
    from mumemto_tpu_torch.parallel import partition
    num_docs, M = 2, 1 << 14
    rbs = [_bench_rb(1, seed=seed, n_docs=num_docs) for seed in range(4)]
    n = engine.pad_size(max(int(rb.text.size) for rb in rbs))
    texts = np.zeros((len(rbs), n), np.uint8)
    doc_ends = np.zeros((len(rbs), num_docs), np.int32)
    for p, rb in enumerate(rbs):
        texts[p, :rb.text.size] = rb.text
        doc_ends[p] = rb.doc_ends
    mesh = partition.make_mesh(4)
    fn = partition.compile_partitioned_matches(mesh, num_docs, M=M)
    torch.cuda.reset_peak_memory_stats()
    got, s, launches = _counted(torch, lambda: fn(texts, doc_ends))
    peak = torch.cuda.max_memory_allocated()
    counts, ps, pe, pL, w_sa, w_da = (x.cpu().numpy() for x in got)
    opts = options.normalize(num_docs, quiet=True)
    matches, sizes = [], []
    for p, rb in enumerate(rbs):
        m = int(counts[p])
        results = engine.MatchResults(opts=opts, num_docs=num_docs)
        doc_offsets, doc_lens = engine._doc_metadata(rb, opts)
        valid = (ps[p, :m, None] + np.arange(num_docs)) < pe[p, :m, None]
        engine._emit_mums(results, ps[p, :m], pe[p, :m], pL[p, :m],
                          w_sa[p, :m], w_da[p, :m].astype(np.int32), valid,
                          opts, doc_offsets, doc_lens, num_docs)
        want = engine.find_matches(rb, opts, backend="direct", device="cuda")
        if results.output_bytes() != want.output_bytes() or \
                not want.num_matches:
            raise AssertionError(f"partition {p}: bytes != the direct "
                                 "backend's")
        matches.append(want.num_matches)
        sizes.append(len(want.output_bytes()))
    step = partition.compile_partitioned_step(mesh, texts.shape, num_docs)
    (total, step_counts, longest), step_s, l_step = _counted(
        torch, lambda: step(texts, doc_ends))
    if int(total) != int(counts.sum()) or \
            step_counts.cpu().tolist() != counts.tolist():
        raise AssertionError(f"partitioned step: total {int(total)}, "
                             f"counts {counts.tolist()}")
    scan = partition.compile_sharded_scan(mesh, n, num_docs, M=M)
    one, scan_s, l_scan = _counted(torch, lambda: scan(texts[0],
                                                       doc_ends[0]))
    m0 = int(counts[0])
    valid = (ps[0, :m0, None] + np.arange(num_docs)) < pe[0, :m0, None]
    row0 = [ps[0, :m0], pe[0, :m0], pL[0, :m0], w_sa[0, :m0][valid],
            w_da[0, :m0][valid]]
    mine = [x.cpu().numpy()[:m0] for x in one[1:]]
    mine[3], mine[4] = mine[3][valid], mine[4][valid]
    if int(one[0][0]) != m0 or not all(
            np.array_equal(a, b) for a, b in zip(row0, mine)):
        raise AssertionError("compile_sharded_scan on partition 0 != row 0 "
                             "of the match program")
    try:
        partition.compile_partitioned_matches(mesh, num_docs, M=4)(
            texts, doc_ends)
    except partition.WindowCapacityError as e:
        refused = str(e)
    else:
        raise AssertionError("M = 4 raised no WindowCapacityError")
    for what, got_l in (("match program", launches), ("step", l_step),
                        ("one-collection scan", l_scan)):
        if any(got_l.values()):
            raise AssertionError(f"partition {what} launched kernels: "
                                 f"{got_l}")
    out["partition mesh"] = {
        "mesh_shape": list(mesh.shape), "axis_names": list(mesh.axis_names),
        "partitions": len(rbs), "docs": num_docs, "n": n, "M": M,
        "counts": counts.tolist(), "matches": matches, "mums_bytes": sizes,
        "longest": longest.cpu().tolist(), "total": int(total),
        "matches_s": s, "step_s": step_s, "sharded_scan_s": scan_s,
        "peak_alloc_bytes": peak, "launches": launches, "refused": refused}
    log(f"[partition] {json.dumps(out['partition mesh'])}")


_DCN_WORKER = r"""
import json, os, sys, time
t0 = time.perf_counter()
sys.path.insert(0, sys.argv[5])
from mumemto_tpu_torch.kernels import kr_mask, probe
from mumemto_tpu_torch.parallel import dcn, mumemtom
rank, port, prefix = int(sys.argv[1]), sys.argv[2], sys.argv[3]
files = open(sys.argv[4]).read().split()
collective = sys.argv[6] == "1"
scanned = []
real = mumemtom.scan_partition
def scan(pfiles, pfx, **kw):
    scanned.append(int(pfx.rsplit("_part", 1)[1]))
    return real(pfiles, pfx, **kw)
mumemtom.scan_partition = scan
kr_mask.launches = probe.launches = 0
dcn.initialize("127.0.0.1:" + port, 2, rank)
t1 = time.perf_counter()
dcn.run_partitioned_dcn(files, prefix, anchor=True, num_partitions=2,
                        collective=collective, device="cuda")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "mumemto_tpu", "bench"))
assert not bad, bad
print("DCN_WORKER " + json.dumps({
    "rank": rank, "scanned": scanned, "kr_break_mask": kr_mask.launches,
    "add_one": probe.launches, "start_s": t1 - t0,
    "run_s": time.perf_counter() - t1}))
"""


def _dcn_pair(worker, prefix, filelist, collective, env):
    """Two workers of one gloo group on a free port of 127.0.0.1, run to
    their end: (the processes, each one's (stdout, stderr))."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, worker, str(rank), str(port), prefix, filelist,
         ROOT, "1" if collective else "0"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env) for rank in (0, 1)]
    ends = []
    try:
        for p in procs:
            ends.append(p.communicate(timeout=300))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return procs, ends


def _dcn_pairs(out, work, anchor_s):
    """parallel/dcn with two worker processes that share the card: gloo
    over 127.0.0.1 on a free port, phase 10's 8 FASTAs, anchor partitions,
    the host fold and the collective fold. Each run's files must equal
    phase 10's MumemtoM anchor run's, which are in `work`."""
    fastas = [os.path.join(work, f"d{i}.fa") for i in range(N_DOCS)]
    filelist = os.path.join(work, "dcn_files.txt")
    with open(filelist, "w") as fh:
        fh.write("\n".join(fastas))
    worker = os.path.join(work, "dcn_worker.py")
    with open(worker, "w") as fh:
        fh.write(_DCN_WORKER)
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    for k in ("MUMEMTO_COORDINATOR", "MUMEMTO_NUM_PROCESSES",
              "MUMEMTO_PROCESS_ID", "MUMEMTO_SHARD_DICT"):
        env.pop(k, None)
    out["dcn"] = {"single_process_anchor_s": anchor_s}
    for collective in (False, True):
        label = "dcn collective" if collective else "dcn host fold"
        prefix = os.path.join(work, label.replace(" ", "_"))
        # one retry on a fresh port: another job on the machine can take
        # the port between its probe and the workers' bind, and a loaded
        # host can miss gloo's connect window; a real fault shows again
        for attempt in (0, 1):
            t0 = time.perf_counter()
            procs, ends = _dcn_pair(worker, prefix, filelist, collective, env)
            wall = time.perf_counter() - t0
            if all(p.returncode == 0 for p in procs):
                break
            log(f"[dcn] {label}: attempt {attempt} exited "
                f"{[p.returncode for p in procs]}: "
                f"{' | '.join(se[-600:] for _so, se in ends)}")
        ranks = []
        for rank, (p, (so, se)) in enumerate(zip(procs, ends)):
            lines = [ln for ln in so.splitlines()
                     if ln.startswith("DCN_WORKER ")]
            if p.returncode != 0 or len(lines) != 1:
                raise AssertionError(f"{label}: rank {rank} exited "
                                     f"{p.returncode}: {so[-1000:]} "
                                     f"{se[-3000:]}")
            rec = json.loads(lines[0][len("DCN_WORKER "):])
            if rec["scanned"] != [rank] or rec["kr_break_mask"] != 1 or \
                    rec["add_one"]:
                raise AssertionError(f"{label}: rank {rank} reports {rec}")
            ranks.append(rec)
        sizes = {}
        for ext in (".mums", ".athresh", ".lengths"):
            with open(prefix + ext, "rb") as a, \
                    open(os.path.join(work, "anchor" + ext), "rb") as b:
                ga, gb = a.read(), b.read()
            if ga != gb or not ga:
                raise AssertionError(f"{label}: {ext} != the single-process "
                                     "MumemtoM anchor run's")
            sizes[ext] = len(ga)
        out["dcn"][label] = {"wall_s": wall, "ranks": ranks, "sizes": sizes}
        log(f"[dcn] {label}: pair {wall:.3f} s beside {anchor_s:.3f} s in "
            f"one process; {json.dumps(out['dcn'][label])}")
        out["paths"][label] = {
            "kr_break_mask": sum(r["kr_break_mask"] for r in ranks),
            "add_one": sum(r["add_one"] for r in ranks)}


def phase_modules(torch, report, res_8mbp, res_f3, mums_32mbp, work):
    """The sharded dictionary index, the partition mesh program and the
    multi-process placement on one card. Every comparison is of bytes or
    of exact tables, and any mismatch raises."""
    out = {"paths": {}, "scans": {}}
    _shard_dict_scans(torch, out, report["sharded"]["scans"], res_8mbp,
                      res_f3, mums_32mbp)
    _shard_dict_tables(torch, out)
    _partition_mesh(torch, out)
    torch.cuda.empty_cache()
    _dcn_pairs(out, work, report["slice"]["mumemtom anchor"]["s"])
    report["modules"] = out


def _sync_all(torch):
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


class _AllCardsTimer(SumTimer):
    """A SumTimer that waits for every visible card, not the current one,
    and keeps each card's peak allocation within each stage."""

    def __init__(self, torch):
        super().__init__(torch)
        self.stage_peaks = {}

    def __call__(self, name):
        torch = self.torch
        _sync_all(torch)
        super().__call__(name)
        before = self.stage_peaks.get(name, [0] * torch.cuda.device_count())
        self.stage_peaks[name] = [
            max(b, torch.cuda.max_memory_allocated(i))
            for i, b in enumerate(before)]
        for i in range(len(before)):
            torch.cuda.reset_peak_memory_stats(i)


def cards_main() -> int:
    """`python3 chip_smoke.py --cards`: the sharded scan with its 8 shards
    spread over every visible card (two a card on four), the dictionary
    index on one device and sharded, in the order off, on, on, off; per
    run the wall, the stages and each card's peak, over the run and within
    each stage (dict_index above all). MUM 8 Mbp and
    MUM 32 Mbp (nr = 2^26); the bytes must equal a single-device run's.
    Writes chiprun_out/chip_smoke_cards.json."""
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from mumemto_tpu_torch import engine, options
    from mumemto_tpu_torch.parallel import mesh, seqpfp
    ncards = torch.cuda.device_count()
    report = {"card": _smi(), "cards": ncards, "runs": []}
    phase_build(report)
    opts = options.normalize(N_DOCS, quiet=True)
    nshards = 8
    devices = mesh.seq_devices(nshards, "cuda")

    def peaks():
        return [torch.cuda.max_memory_allocated(i) for i in range(ncards)]

    for mbp, expect in ((8, EXPECT_8MBP), (32, EXPECT_32MBP)):
        rb = _bench_rb(mbp)
        engine.find_matches(rb, opts, device="cuda")        # warm-up
        for i in range(ncards):
            torch.cuda.reset_peak_memory_stats(i)
        t0 = time.perf_counter()
        single = engine.find_matches(rb, opts, device="cuda")
        _sync_all(torch)
        entry = {"mbp": mbp, "shards": 1, "shard_dict": False,
                 "wall_s": time.perf_counter() - t0,
                 "peak_alloc_bytes": peaks()}
        report["runs"].append(entry)
        log(f"[cards] {json.dumps(entry)}")
        want = single.output_bytes()
        if single.num_matches != expect:
            raise AssertionError(f"{mbp} Mbp: {single.num_matches} matches")
        del single
        for shard_dict in (False, True):                    # warm-up
            seqpfp.find_matches_seq_sharded(rb, opts, devices, M=8192,
                                            shard_dict=shard_dict)
        for shard_dict in (False, True, True, False):
            for i in range(ncards):
                torch.cuda.reset_peak_memory_stats(i)
            _sync_all(torch)
            timer = _AllCardsTimer(torch)
            t0 = time.perf_counter()
            res = seqpfp.find_matches_seq_sharded(
                rb, opts, devices, M=8192, phase=timer,
                shard_dict=shard_dict)
            _sync_all(torch)
            entry = {"mbp": mbp, "shards": nshards,
                     "devices": [str(d) for d in devices],
                     "shard_dict": shard_dict,
                     "wall_s": time.perf_counter() - t0,
                     "stages_s": timer.stages,
                     "stage_peak_alloc_bytes": timer.stage_peaks,
                     "peak_alloc_bytes": [
                         max(p) for p in zip(*timer.stage_peaks.values())],
                     "matches": res.num_matches}
            report["runs"].append(entry)
            log(f"[cards] {json.dumps(entry)}")
            if res.output_bytes() != want:
                raise AssertionError(f"{mbp} Mbp, shard_dict={shard_dict}: "
                                     "bytes != the single-device run's")
            del res
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_cards.json"),
              "w") as f:
        json.dump(report, f, indent=1)
    log(report["card"])
    log(json.dumps({"ok": True, "cards": ncards}))
    return 0


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
    res_8mbp, mums_32mbp = phase_end_to_end(torch, report)
    res_f3 = phase_mem(torch, report)
    phase_walk(torch, report)
    phase_routes(torch, report, res_8mbp.output_bytes())
    phase_bytes(torch, report)
    with tempfile.TemporaryDirectory() as work:
        phase_slice(torch, report, res_8mbp, res_f3, work)
        phase_sharded(torch, report, res_8mbp, res_f3, mums_32mbp, work)
        phase_modules(torch, report, res_8mbp, res_f3, mums_32mbp, work)
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "mumemto_tpu", "bench"))
    if foreign:
        raise AssertionError(f"chip_smoke imported {foreign}")
    report["total_s"] = time.perf_counter() - t_all

    t8 = report["kernel_timings"]["8mbp"]
    paths = [*report["e2e"].values(), *report["mem"].values(),
             report["walk"], report["routes"]["-g"]]
    report["path_launches"] = {p["label"]: p["launches"] for p in paths}
    for label in ("-P", "-p", "-A", "-a"):
        report["path_launches"][label] = report["routes"][
            "-P -p" if label in ("-P", "-p") else "-A -a"][label + "_launches"]
    report["path_launches"].update(report["slice"]["paths"])
    report["path_launches"].update(report["sharded"]["paths"])
    report["path_launches"].update(report["modules"]["paths"])
    pr = report["probe"]
    # add_one's bound: the (8, 128) int32 tile read once and written once
    probe_bound_ms = 2 * 8 * 128 * 4 / HBM_BYTES_PER_S * 1e3
    kernels = {"kernels": [{
        "name": "kr_break_mask", "route": "cuda", "source": KR_SOURCE,
        "replaces": KR_REPLACES,
        "launches": sum(v["kr_break_mask"]
                        for v in report["path_launches"].values()),
        "max_abs_err": report["kernel_max_abs_err"], "ms": t8["ms"],
        "plain_ms": t8["plain_ms"], "bound_ms": t8["bound_ms"],
        "bound_by": t8["bound_by"], "library_ms": None}, {
        "name": "add_one", "route": "cuda", "source": PROBE_SOURCE,
        "replaces": PROBE_REPLACES, "launches": pr["launches"],
        "max_abs_err": pr["max_abs_err"], "ms": pr["ms"],
        "plain_ms": pr["plain_ms"], "bound_ms": probe_bound_ms,
        "bound_by": "bytes", "library_ms": pr["library_ms"]}]}
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
        rc = cards_main() if sys.argv[1:] == ["--cards"] else main()
    except Exception:  # any failed phase: report it and exit non-zero
        traceback.print_exc()
        rc = 1
    sys.exit(rc)
