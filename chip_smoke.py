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
 4b. the running max / min kernel (phase_scan) against its plain version
     (torch.cummax / cummin) at 2^26 and 2^28 int32 and 2^27 int64, both
     ops, forward and reverse, 0 mismatches; CUDA-event times of the
     kernel, the plain version and torch.cummax(x, 0) beside the bytes
     bound; and its launches in one call of the PFP path (MUM mode and -f
     3) and of -g on the 8 Mbp bench collection;
 4c. the phrase sort on the card (phase_phrases) at the record counts of
     the benchmark's three collections (20 x 6.6 Mbp at 0.1% SNPs, 10 x
     3.6 and 10 x 5 Mbp at 1%): ops/pfp.sort_phrases's wall beside the
     native host sort's (the same ranks, exactly), each phrase kernel
     against its plain version on the sort's own inputs (mismatches
     counted), the fingerprint and verify kernels timed beside their bytes
     bound, the tail kernel's time and largest group, rounds, collisions
     and launches; every path below must launch the phrase kernels once a
     KR launch (_sorted), and the kernels line sums them over the paths;
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
     equal to phase 10's MumemtoM anchor run's);
 13. the real-alphabet variant of the main path (any input with an N takes
     it: the 7-bit seed, the rank-descent dictionary LCP) on
     bench.synth_collection_real, the bench collection with assembly gaps
     written over it as runs of N (100 to 50 000 long, ~1.5% of the bases)
     and, for one row, the ten IUPAC ambiguity codes: (a) strict MUMs at 8
     Mbp, (b) at 32 Mbp, (c) -f 3 at 8 Mbp, (d) the IUPAC input at 8 Mbp
     (over 16 letters: the descent runs unpacked), each count against a
     live baseline_cpu run on the same bytes, with the stage times, Mbp/s,
     peak memory and sizes beside phase 5's and 6's ACGT run; (e) -g on
     both inputs against rows a's and d's bytes (7 letters with the pad
     keep the 3-bit seed; the IUPAC text takes the 7-bit seed and the
     unpacked descent); (f) the 4-shard scan against row a's bytes (and
     shard_dict=True refused for this alphabet); (g) .mums, .mems, .thresh and -g's .mums
     at 1 Mbp on the card against the port's CPU path, both inputs; and
     the KR kernel against its plain version on the ACGTN ext;
 14. the main path at BASELINE.md's sizes (phase_scale): bench.synth_collection
     with 10 and 20 documents of 5 Mbp (a bacterial genome), 0.1% SNPs:
     (a) 10 docs, partial multi-MUMs (-k -1), (b) -f 3, (c) 20 docs from 20
     FASTAs through cli.main, strict MUMs, (d) MumemtoM on row c's FASTAs,
     2 anchor partitions (11 and 10 docs) and the anchor merge in one
     process, whose MUM set must equal row c's except for MUMs that touch
     a document's first or last base (counted), (d2) parallel/dcn with two
     worker processes sharing the card (files equal to row d's), (e) the
     8-doc bench collection at 64 and 96 Mbp, (f) row a's documents at 1%
     SNPs with -k -1 (nd = 0.75 x 2^27, 28 levels: past the range-min's
     int32 flat index, so _rmq_query reads the dictionary's table level by
     level), and a text of 2^31 characters, which build_pfp must refuse
     with ScanSizeError before any upload, in words the CLI's partition
     fallback takes, (k) the KR kernel on row
     c's ext (0.75 x 2^28 bytes) against its plain version, timed beside
     its bound. Each row prints nd, the range-min levels and their product
     against 2^31, nr, walls, stage times, Mbp/s, peak memory and KR
     launches (exactly 1 a scan); the counts of a, b, c, f and the 96 Mbp
     tier must equal live baseline_cpu runs, started together at the end;
 15. the throughput harness (python -m mumemto_tpu_torch.bench, run
     in-process: phase_bench) on mum8 (strict MUMs at 8 Mbp), real8 (the
     gapped collection) and f3_8 (-f 3), 3 timed calls each after a cold
     one, the stage call and the traced call, each count against the one
     on record and a live baseline_cpu run; its records go in the report.
`python3 chip_smoke.py --cards` is another, shorter program for a machine
with several cards: the 8-shard scan spread over them with the dictionary
index on one device and sharded, wall and peak per card (cards_main).
`python3 chip_smoke.py --cards ROW ...` runs the named rows instead
(phase_wide): s a probe of host-bound work through the per-card threads,
then the 8-shard scan of the bench collection at 8 and 32 Mbp over every
card and on cuda:0 alone, each traced (every card's busy time and the
time cards were busy together); p the partition program on
make_mesh(4), the card of each partition; then, on 215 genomes of 4.41
Mbp at 0.01% SNPs (1.9 G rows, a 2^31-row bucket): wr the sharded scan
at 1/8 of that size on one card, wbase native/baseline_cpu on the whole
collection, w the KR kernel on its 2^31-byte ext (kw: that alone) and the
sharded scan over every card, a trace of its shard stages, then the CLI
with --seq-shards, f1 the default CLI on one card (the union refused,
then the partition fallback), w2 MumemtoM as dcn ranks, m3 113 genomes
of 5 Mbp at 0.1% SNPs as dcn ranks.
Every path of phases 5-8 and 10-15 is driven with the kernels' launch counts
set to 0 just before it and read just after; each PFP path (and -P, -A,
and every path of phase 10) must have launched the KR kernel, and -g, -p
and -a must have launched none; every PFP path, -g, -p, -A, -a, the
sharded scans and merge --collective must have launched the running max /
min kernel. The
line before the last is the kernels' JSON record, the last line is
{"ok": true, "device": {...}}. Everything is also written to
chiprun_out/chip_smoke.json. Imports nothing of JAX and nothing of the
JAX package, mumemto_tpu; native/baseline_cpu is run as a program.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
if __name__ == "__main__" and not os.path.isdir(
        os.path.join(ROOT, "mumemto_tpu_torch")):
    sys.exit("chip_smoke: mumemto_tpu_torch not found beside this script; "
             "run it from the repository root")

from mumemto_tpu_torch import bench  # noqa: E402

LAUNCH_KEYS = ("kr_break_mask", "add_one", "running_scan",  # bench.counted's
               "phrase_fingerprint", "phrase_verify", "phrase_tail_rank")
KR_SOURCE = "mumemto_tpu_torch/kernels/csrc/kr_mask.cu"
KR_REPLACES = "mumemto_tpu/ops/pallas_kernels.py:103"
SCAN_SOURCE = "mumemto_tpu_torch/kernels/csrc/scan.cu"
PHRASES_SOURCE = "mumemto_tpu_torch/kernels/csrc/phrases.cu"
PROBE_SOURCE = "mumemto_tpu_torch/kernels/csrc/add_one.cu"
PROBE_REPLACES = "tools/mosaic_probe.py:25"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (the data sheet's peak)
N_DOCS = 8
EXPECT_8MBP = bench.CONFIGS["mum8"].expected  # the bench tier (6759)
EXPECT_F3_8MBP = bench.CONFIGS["f3_8"].expected  # -f 3 on the same input
EXPECT_32MBP = bench.CONFIGS["mum32"].expected  # the 32 Mbp tier


def log(*a):
    print(*a, flush=True)


def _event_ms(torch, fn, reps: int, device=None) -> float:
    """CUDA-event ms per call of fn, on `device`'s current stream (the
    current device's by default: an event is recorded on the stream of the
    device that is current when it is recorded)."""
    with _current(torch, device):
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


def _current(torch, device):
    """A context in which `device` (a CUDA torch.device) is the current
    device; for None or a CPU device it does nothing."""
    if device is None or device.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _bench_rb(mbp: float, seed: int = 0, n_docs: int = N_DOCS):
    """The bench collection as a RefBuilder at `mbp` Mbp."""
    return bench.rb_of(bench.synth_collection(mbp, n_docs, seed=seed))


def _real_rb(mbp: float, seed: int = 0, iupac: bool = False):
    """bench.synth_collection_real's collection as a RefBuilder at `mbp`
    Mbp."""
    return bench.rb_of(bench.synth_collection_real(mbp, N_DOCS, seed=seed,
                                                   iupac=iupac))


def _ext_of(text, w: int):
    """The device ext layout build_pfp uploads for `text`."""
    import numpy as np
    from mumemto_tpu_torch.ops import pfp as ops_pfp
    from mumemto_tpu_torch.ops import suffix as ops_suffix
    ext_np = np.concatenate([np.full(1, ops_pfp.DOLLAR_PFP, np.uint8), text,
                             np.full(w, ops_pfp.DOLLAR_PFP, np.uint8)])
    ext = np.zeros(ops_suffix.bucket(ext_np.size, lo=1024), np.uint8)
    ext[:ext_np.size] = ext_np
    return ext


def phase_card(torch, report):
    from mumemto_tpu_torch.kernels import build
    smi = bench.smi()
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
    name, _s, launches = bench.counted(torch, probe.check)
    if launches["add_one"] != 1:
        raise AssertionError(f"probe.check launched add_one "
                             f"{launches['add_one']} times")
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
    """Every kernel source of the port, one nvcc each, started together
    (the first build.build of a stale source builds them all)."""
    from mumemto_tpu_torch.kernels import build, kr_mask, phrases, probe, scan
    names = sorted(f[:-3] for f in os.listdir(build.CSRC) if f.endswith(".cu"))
    t0 = time.perf_counter()
    for name in names:
        build.build(name)
    kr_mask.launcher()
    probe._kernel()
    scan.launcher()
    phrases.launcher()
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


def _blocked_scan(torch, x, op, tile=4096):
    """The running max (op "max") or min of a 1-D x in plain PyTorch over
    a (rows, tile) view: torch.cummax / cummin along each row (a block for
    every 32 rows), the same over the rows' last values, then each row
    combined with the rows before it. The simpler design that phase_scan
    times the kernel against."""
    fn = {"max": torch.cummax, "min": torch.cummin}[op]
    info = torch.iinfo(x.dtype)
    ident = info.min if op == "max" else info.max
    n = x.numel()
    rows = -(-n // tile)
    if n % tile:
        x = torch.cat([x, x.new_full((rows * tile - n,), ident)])
    inner = fn(x.view(rows, tile), 1).values
    carry = fn(inner[:, -1].contiguous(), 0).values
    before = torch.cat([carry.new_full((1,), ident), carry[:-1]])
    both = {"max": torch.maximum, "min": torch.minimum}[op]
    return both(inner, before[:, None]).view(-1)[:n]


def phase_scan(torch, report):
    """The running max / min kernel against its plain version on the card
    (exactly equal), its CUDA-event times beside the plain version's, the
    library call torch.cummax(x, 0)'s (the port calls it nowhere), a
    blocked plain PyTorch scan's (_blocked_scan) and the bound (each
    element read once and written once over HBM_BYTES_PER_S), then its
    launches in one call of each main-path route at 8 Mbp."""
    from mumemto_tpu_torch import engine, options
    from mumemto_tpu_torch.kernels import scan
    dev = torch.device("cuda")
    fns = {"max": scan.running_max, "min": scan.running_min}
    shapes = [("2^26 int32", 1 << 26, torch.int32),
              ("2^28 int32", 1 << 28, torch.int32),
              ("2^27 int64", 1 << 27, torch.int64)]
    out = {"cases": {}, "max_abs_err": 0}
    for label, n, dtype in shapes:
        g = torch.Generator(device=dev).manual_seed(n)
        hi = 2**31 - 1 if dtype == torch.int32 else 2**62
        x = torch.randint(-hi, hi, (n,), dtype=dtype, device=dev, generator=g)
        # sparse and dense runs of new maxima: where(mask, idx, -1) as the
        # dictionary's group scan makes it
        x[: n // 2] = torch.where(
            torch.rand(n // 2, device=dev, generator=g) < 0.3,
            torch.arange(n // 2, dtype=dtype, device=dev), -1)
        for op in ("max", "min"):
            for reverse in (False, True):
                got, _s, launched = bench.counted(
                    torch, lambda: fns[op](x, reverse=reverse))
                err = int((got != scan.running_plain(x, op, reverse)).sum())
                out["max_abs_err"] = max(out["max_abs_err"], err)
                if err or launched["running_scan"] != 1:
                    raise AssertionError(
                        f"running_{op} reverse={reverse} at {label}: "
                        f"{err} mismatches, {launched['running_scan']} "
                        "launches")
                del got
        bound_ms = 2 * n * x.element_size() / HBM_BYTES_PER_S * 1e3
        case = {"n": n, "dtype": str(dtype), "bound_ms": bound_ms,
                "bound_by": "bytes"}
        for op, reverse in (("max", False), ("min", True)):
            t = _turns(torch, lambda: fns[op](x, reverse=reverse),
                       lambda: scan.running_plain(x, op, reverse), 3, 3)
            key = f"{op}{'_rev' if reverse else ''}"
            case[key] = {**t, "share_of_bound": bound_ms / t["ms"],
                         "gb_per_s": 2 * n * x.element_size() / t["ms"] / 1e6}
        case["library_ms"] = statistics.median(
            _event_ms(torch, lambda: torch.cummax(x, 0), 3) for _ in range(3))
        blocked = int((_blocked_scan(torch, x, "max")
                       != scan.running_max(x)).sum())
        if blocked:
            raise AssertionError(f"_blocked_scan at {label}: {blocked} "
                                 "mismatches")
        case["blocked_plain_ms"] = statistics.median(
            _event_ms(torch, lambda: _blocked_scan(torch, x, "max"), 3)
            for _ in range(3))
        out["cases"][label] = case
        f, r = case["max"], case["min_rev"]
        log(f"[scan] {label}: running_max {f['ms']:.4f} ms "
            f"({f['share_of_bound']:.1%} of the {bound_ms:.4f} ms bound, "
            f"{f['gb_per_s']:.0f} GB/s), plain {f['plain_ms']:.2f} ms; "
            f"running_min reverse {r['ms']:.4f} ms "
            f"({r['share_of_bound']:.1%}), plain {r['plain_ms']:.2f} ms; "
            f"torch.cummax(x, 0) {case['library_ms']:.2f} ms; blocked plain "
            f"{case['blocked_plain_ms']:.4f} ms; 0 mismatches")
        del x
        torch.cuda.empty_cache()
    rb = _bench_rb(8)
    out["launches_per_call"] = {}
    for label, kw, backend in (("pfp", {}, "pfp"),
                               ("pfp -f 3", {"rare_freq": 3}, "pfp"),
                               ("-g", {}, "direct")):
        opts = options.normalize(rb.num_docs, quiet=True, **kw)
        engine.find_matches(rb, opts, device=dev, backend=backend,
                            show_progress=False)
        _, _s, launched = bench.counted(torch, lambda: engine.find_matches(
            rb, opts, device=dev, backend=backend, show_progress=False))
        out["launches_per_call"][label] = launched["running_scan"]
        if launched["running_scan"] == 0:
            raise AssertionError(f"{label} launched no running_scan")
    log(f"[scan] launches a call at 8 Mbp: "
        f"{json.dumps(out['launches_per_call'])}")
    report["scan"] = out


PHRASE_SETS = (("human20x6.6mbp", 132, 20, 0.001),
               ("ecoli10x3.6mbp", 36, 10, 0.01),
               ("ecoli10x5mbp", 50, 10, 0.01))


def phase_phrases(torch, report):
    """The phrase sort on the card (ops/pfp.sort_phrases) against the
    native host sort (native/mumemto_native.cc's std::sort, what the JAX
    package's build_pfp calls) on the records of each collection: parse,
    phrase_st and phrase_ln exactly equal; the device sort's wall (median
    of 3 warm calls, its readbacks included) beside the host sort's; each
    kernel against its plain version on the inputs the sort gives it, its
    mismatches counted (fingerprints that differ, the difference of the
    verify counts, buckets the tail ranks otherwise); the fingerprint and
    verify kernels timed by CUDA events beside their bound at
    HBM_BYTES_PER_S (the records' bytes once, and st, ln and the
    fingerprint, or order, head, st and ln, 16 bytes a record); the tail
    kernel's time in one call, its groups, members and largest group; the
    rounds, collisions and launches of that call (counted from 0 just
    before it). Written also to chiprun_out/chip_smoke_phrases.json."""
    import numpy as np
    from mumemto_tpu_torch import native, trace
    from mumemto_tpu_torch.kernels import phrases
    from mumemto_tpu_torch.ops import pfp as ops_pfp
    dev = torch.device("cuda")
    nat = native.get_native()
    out = {"card": bench.smi(), "sets": {}}
    for label, mbp, docs, snp in PHRASE_SETS:
        rb = bench.rb_of(bench.synth_collection(mbp, docs, seed=0,
                                                snp_rate=snp))
        ext_np = _ext_of(rb.text, 10)
        ext = torch.from_numpy(ext_np).to(dev)
        n_text = int(rb.text.size)
        st, ln = ops_pfp.phrase_records(
            ops_pfp.compute_breaks(ext, n_text, 10, 100), n_text, 10)
        m = st.numel()
        row = {"text": n_text, "records": m,
               "record_bytes": int(ln.sum(dtype=torch.int64))}
        # the native host sort, once, and its fields
        st_np, ln_np = st.cpu().numpy(), ln.cpu().numpy()
        t = time.perf_counter()
        order_b, grp_b = nat.sort_phrases(ext_np, st_np, ln_np)
        row["host_sort_s"] = time.perf_counter() - t
        order = np.frombuffer(order_b, np.int32)
        grp = np.frombuffer(grp_b, np.int32)
        rep = order[np.concatenate([[True], grp[1:] != grp[:-1]])]
        want_parse = np.zeros(m, np.int32)
        want_parse[order] = grp + 1
        # the device sort: one traced call, its tail timed and checked
        # against the plain version on a copy of the same buckets
        tails = []
        real_tail = phrases.tail_rank

        def timed_tail(ext_, st_, ln_, rec, active, starts, d, bucket):
            want = bucket.clone()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            real_tail(ext_, st_, ln_, rec, active, starts, d, bucket)
            end.record()
            torch.cuda.synchronize()
            phrases.tail_rank_plain(ext_, st_, ln_, rec, active, starts, d,
                                    want)
            tails.append({"ms": start.elapsed_time(end),
                          "groups": starts.numel() - 1,
                          "members": active.numel(),
                          "largest_group": int((starts[1:]
                                                - starts[:-1]).max()),
                          "depth": d,
                          "mismatches": int((bucket != want).sum())})
        phrases.tail_rank = timed_tail
        trace.drain()
        trace.enable()
        try:
            with trace.call("engine.find_matches"):
                parse, phrase_st, phrase_ln = ops_pfp.sort_phrases(
                    ext, st, ln)
        finally:
            trace.disable()
            phrases.tail_rank = real_tail
        launches = bench.launch_counts(trace.totals())
        (counters,) = trace.drain()["counters"].values()
        row["launches"] = {k: v for k, v in launches.items()
                           if k in phrases.KERNELS}
        row["rounds"] = counters[ops_pfp.SORT_ROUNDS_COUNTER]
        row["collisions"] = counters[ops_pfp.SORT_COLLISIONS]
        row["readbacks"] = counters[trace.READBACKS]
        row["tail"] = tails[0] if tails else None
        if not (np.array_equal(parse, want_parse)
                and np.array_equal(phrase_st[1:], st_np[rep])
                and np.array_equal(phrase_ln[1:], ln_np[rep])):
            raise AssertionError(f"[phrases] {label}: the device sort "
                                 "differs from the native sort")
        if not bench.sorted_on_card(row["launches"], 1) or \
                row["launches"]["phrase_tail_rank"] != len(tails):
            raise AssertionError(f"[phrases] {label}: launches "
                                 f"{row['launches']}")
        row["phrases"] = int(phrase_st.size - 1)
        walls = []
        for _ in range(4):
            torch.cuda.synchronize()
            t = time.perf_counter()
            ops_pfp.sort_phrases(ext, st, ln)
            walls.append(time.perf_counter() - t)
        row["device_sort_s"] = statistics.median(walls[1:])
        row["device_sort_s_runs"] = walls
        # the kernels against their plain versions, and timed
        fp = phrases.fingerprint(ext, st, ln)
        srt, _run, head = ops_pfp.fingerprint_runs(fp, ln)
        bad = phrases.verify(ext, st, ln, srt, head)
        row["mismatches"] = {
            "fingerprint": int((fp != phrases.fingerprint_plain(
                ext, st, ln)).sum()),
            "verify": abs(int(bad) - int(phrases.verify_plain(
                ext, st, ln, srt, head))),
            "tail_rank": row["tail"]["mismatches"] if tails else 0}
        if any(row["mismatches"].values()):
            raise AssertionError(f"[phrases] {label}: kernels differ from "
                                 f"their plain versions: {row['mismatches']}")
        rb_bytes = row["record_bytes"]
        for name, fn in (
                ("fingerprint", lambda: phrases.fingerprint(ext, st, ln)),
                ("verify", lambda: phrases.verify(ext, st, ln, srt, head))):
            ms = statistics.median(_event_ms(torch, fn, 5) for _ in range(3))
            moved = rb_bytes + 16 * m
            bound = moved / HBM_BYTES_PER_S * 1e3
            row[name] = {"ms": ms, "bound_ms": bound, "bytes": moved,
                         "share_of_bound": bound / ms}
        out["sets"][label] = row
        tail = row["tail"] or {"groups": 0, "largest_group": 0, "ms": 0.0}
        log(f"[phrases] {label}: {m} records, {row['phrases']} phrases, "
            f"device sort {row['device_sort_s']:.4f} s against the host's "
            f"{row['host_sort_s']:.3f} s; rounds {row['rounds']}, "
            f"collisions {row['collisions']}, tail {tail['groups']} groups "
            f"(largest {tail['largest_group']}) {tail['ms']:.3f} ms; "
            f"fingerprint {row['fingerprint']['ms']:.4f} ms "
            f"({row['fingerprint']['share_of_bound']:.1%} of "
            f"{row['fingerprint']['bound_ms']:.4f}), verify "
            f"{row['verify']['ms']:.4f} ms "
            f"({row['verify']['share_of_bound']:.1%} of "
            f"{row['verify']['bound_ms']:.4f}); readbacks {row['readbacks']}; "
            f"mismatches {row['mismatches']}")
        del ext, st, ln, fp, srt, _run, head, bad
        torch.cuda.empty_cache()
    report["phrases"] = out
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_phrases.json"),
              "w") as f:
        json.dump(out, f, indent=1)


def _drive(torch, label, rb, opts, mbp, backend="pfp"):
    """One path end to end on the card: a cold and a warm find_matches,
    their kernel launches counted (bench.counted), then a live
    native/baseline_cpu run with the same options. The match count must
    equal the baseline's and be above 0. The PFP backend must
    have launched the KR kernel in both runs, the direct backend never;
    both must have launched the running max / min kernel.
    Returns (record, warm result)."""
    from mumemto_tpu_torch import engine
    cold, cold_s, l_cold = bench.counted(torch, lambda: engine.find_matches(
        rb, opts, device="cuda", backend=backend))
    torch.cuda.reset_peak_memory_stats()
    timer = bench.StageTimer(torch)
    res, wall, l_warm = bench.counted(torch, lambda: engine.find_matches(
        rb, opts, device="cuda", phase=timer, backend=backend))
    peak = torch.cuda.max_memory_allocated()
    launches = {k: l_cold[k] + l_warm[k] for k in l_cold}
    if backend == "pfp" and launches["kr_break_mask"] < 2:
        raise AssertionError(f"{label}: KR kernel launched "
                             f"{launches['kr_break_mask']} times in two runs")
    if backend == "direct" and any(_kr_of(launches).values()):
        raise AssertionError(f"{label}: the direct backend launched "
                             f"kernels: {launches}")
    _scanned(label, launches)
    if res.output_bytes() != cold.output_bytes():
        raise AssertionError(f"{label}: two runs disagree")
    base_mbp_s, base_matches = bench.run_cpu_baseline(rb.text, rb.seq_lengths,
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


def _direct_index(torch, rb) -> dict:
    """The -g index stages alone on the padded text: doubling rounds and
    history size, and, where the alphabet takes the PLCP (<= 8 letters),
    its deep-row count against deep_cap; otherwise the rank descent."""
    import numpy as np
    from mumemto_tpu_torch import engine
    from mumemto_tpu_torch.ops import pfp as ops_pfp
    from mumemto_tpu_torch.ops import suffix as ops_suffix
    n_real = int(rb.text.size)
    n = ops_suffix.bucket(n_real + 4, lo=4096)  # the direct backend's pad
    text_np = np.zeros(n, np.uint8)
    text_np[:n_real] = rb.text
    seed_thr, lcp_thr = ops_pfp.seed_thresholds(
        set(ops_pfp._alphabet(rb.text)) | {0})
    text = torch.from_numpy(text_np).to(engine.resolve("cuda"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sa, hist, num_lvl = ops_suffix._suffix_array_impl(
        text, n, packed_init=True, alpha_thresholds=seed_thr)
    torch.cuda.synchronize()
    sa_s = time.perf_counter() - t0
    stats = {"lcp": "plcp" if seed_thr is not None else "descent"}
    if seed_thr is not None:
        ops_suffix._lcp_plcp_impl(sa, hist, text, n, hist.shape[0], seed_thr,
                                  deep_cap=max(n // 4, 1024),
                                  num_lvl=num_lvl, stats=stats)
    else:
        ops_suffix._lcp_impl(sa, hist, num_lvl, n, text=text,
                             bottom_thresholds=lcp_thr)
    torch.cuda.synchronize()
    first_round = 4 if seed_thr is not None else 3
    stats.update(n=n, filled_rows=num_lvl, hist_rows=int(hist.shape[0]),
                 doubling_sorts=num_lvl - first_round + 1,
                 exits_early=num_lvl < int(hist.shape[0]),
                 hist_bytes=int(hist.numel()) * 4, sa_s=sa_s,
                 lcp_s=time.perf_counter() - t0 - sa_s,
                 peak_alloc_bytes=torch.cuda.max_memory_allocated())
    return stats


def phase_routes(torch, report, pfp_mums: bytes):
    """The other single-device entry routes on the 8 Mbp bench input, each
    against the PFP path's .mums bytes (pfp_mums): -g (the direct backend,
    against a live baseline_cpu run as well), -P then -p, -A then -a. -P
    and -A must launch the KR kernel, -g, -p and -a must not; every route
    but -P (which scans nothing) must launch the running max / min
    kernel."""
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
        _, s_P, l_P = bench.counted(
            torch, lambda: ops_pfp.write_parse_files(rb, pre, cuda))
        t_p = bench.StageTimer(torch)
        res_p, s_p, l_p = bench.counted(torch, lambda: engine.find_matches(
            rb_meta, opts, device=cuda, parse_prefix=pre, phase=t_p))
        sizes_P = {ext: os.path.getsize(pre + ext)
                   for ext in (".dict", ".parse")}
        t_A = bench.StageTimer(torch)
        res_A, s_A, l_A = bench.counted(torch, lambda: engine.find_matches(
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
        res_a, s_a, l_a = bench.counted(torch, replay)
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
    if any(_kr_of(l_p).values()) or any(_kr_of(l_a).values()):
        raise AssertionError(f"-p/-a launched kernels: {l_p} {l_a}")
    for label, launches in (("-p", l_p), ("-A", l_A), ("-a", l_a)):
        _scanned(label, launches)
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


def _kr_used(label, launches):
    """A path of the slice must have launched the KR kernel and the
    running max / min kernel, and nothing of it the probe kernel."""
    if launches["kr_break_mask"] < 1 or launches["add_one"]:
        raise AssertionError(f"{label}: kernel launches {launches}")
    _scanned(label, launches)


def _kr_of(launches) -> dict:
    """The KR and probe kernels' part of a path's launch counts (the
    running max / min kernel's count varies with the route: _scanned)."""
    return {k: launches[k] for k in ("kr_break_mask", "add_one")}


def _scanned(label, launches):
    """A path that scans on the card must have launched the running max /
    min kernel, and _sorted's phrase kernels."""
    if launches["running_scan"] < 1:
        raise AssertionError(f"{label}: no running_scan launch: {launches}")
    _sorted(label, launches)


def _sorted(label, launches):
    """Each build_pfp of a path (one a KR launch) must have ranked its
    phrases on the card: one phrase_fingerprint and one phrase_verify
    launch, at most one phrase_tail_rank; a path without a KR launch
    (-g, -p, -a) none of them."""
    if not bench.sorted_on_card(launches, launches["kr_break_mask"]):
        raise AssertionError(f"{label}: phrase kernel launches {launches}, "
                             f"{launches['kr_break_mask']} KR launches")


def _mums_set(path, num_docs, order=None):
    """The .mums file as a set of (length, offsets, strands) records; with
    `order` (column j of the file is document order[j]) the columns are
    put in document order."""
    from mumemto_tpu_torch import formats
    L, S, T = formats.parse_mums(path, num_docs)
    if order is not None:
        cols = [order.index(d) for d in range(num_docs)]
        S, T = S[:, cols], T[:, cols]
    return {(int(l), tuple(s.tolist()), tuple(t.tolist()))
            for l, s, t in zip(L, S, T)}


def _touches_terminal(rec, doc_lens) -> bool:
    """A MUM some occurrence of which holds its doc's first or last base
    or crosses its '$' (forward coordinates [off, off + L))."""
    length, offs, _ = rec
    return any(o == 0 or o + length >= dl
               for o, dl in zip(offs, doc_lens) if o >= 0)


def _partition_spy(torch, mumemtom, parts):
    """A scan_partition that records each partition's docs, seconds, KR
    launches and peak device memory (allocated and reserved, from an
    emptied cache) in `parts`."""
    real = mumemtom.scan_partition

    def scan(files, pfx, **kw):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out, s, launched = bench.counted(torch,
                                         lambda: real(files, pfx, **kw))
        parts.append({"docs": len(files), "s": s,
                      "kr_launches": launched["kr_break_mask"],
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
    from mumemto_tpu_torch.parallel import mumemtom
    out = {"paths": {}}
    docs = bench.synth_collection(8, N_DOCS)
    seqs = [[fwd.tobytes()] for fwd in docs]
    lib, s, lm = bench.counted(torch, lambda: library.mum(seqs, device="cuda"))
    same = (np.array_equal(lib.match_lengths, res_8mbp.lengths)
            and np.array_equal(lib.offsets, res_8mbp.offsets)
            and np.array_equal(lib.strands, res_8mbp.strands > 0))
    out["library.mum"] = {"s": s, "matches": len(lib), "launches": lm,
                          "arrays_equal_phase5": same}
    lib_m, s, lmm = bench.counted(torch, lambda: library.mem(
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
        fastas = bench.write_fastas(docs, tmp)
        union = os.path.join(tmp, "union")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        rc, s, lu = bench.counted(torch, lambda: cli.main(
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
            real, spy = _partition_spy(torch, mumemtom, parts)
            mumemtom.scan_partition = spy
            try:
                path, s, lp = bench.counted(
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
                rc, s, lf = bench.counted(torch, lambda: cli.main(
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
    docs1 = bench.synth_collection(1, N_DOCS, seed=1)
    out["merge 1mbp"] = {}
    with tempfile.TemporaryDirectory() as tmp:
        fastas = bench.write_fastas(docs1, tmp)
        for anchor, exts in ((True, (".mums", ".lengths", ".athresh")),
                             (False, (".mums", ".lengths", ".thresh",
                                      ".thresh_rev"))):
            label = "anchor" if anchor else "string"
            pre = os.path.join(tmp, label)
            _, s, lp = bench.counted(
                torch, lambda: mumemtom.run_partitioned_files(
                    fastas, pre, num_partitions=2, anchor=anchor,
                    device="cuda"))
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
    kernel exactly once, the running max / min kernel at least once and
    the probe kernel never), the warm one under a
    per-stage timer and a fresh peak-memory counter. The output bytes of
    both runs must equal want_bytes. Returns (record, warm result)."""
    from mumemto_tpu_torch.parallel import mesh, seqpfp
    devices = mesh.seq_devices(nshards, "cuda")
    cold, cold_s, l_cold = bench.counted(
        torch, lambda: seqpfp.find_matches_seq_sharded(
            rb, opts, devices, M=M, shard_dict=shard_dict))
    torch.cuda.reset_peak_memory_stats()
    timer = bench.SumTimer(torch)
    res, wall, l_warm = bench.counted(
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
        if _kr_of(launches) != {"kr_break_mask": 1, "add_one": 0}:
            raise AssertionError(f"{label}: kernel launches {launches}, "
                                 "expected exactly 1 KR launch")
        _scanned(label, launches)
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
            bench.synth_collection(0.18, 3, seed=5, snp_rate=0.002)]
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
    want, s, launches = bench.counted(
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
    timer = bench.StageTimer(torch)
    single, s, l1 = bench.counted(torch, lambda: engine.find_matches(
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
    rc, s, lc = bench.counted(torch, lambda: cli.main(
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
    _scanned("cli --seq-shards 4", lc)
    out["paths"]["cli --seq-shards 4"] = lc

    # merge --collective on phase 10's anchor partitions (5 + 4 docs)
    parts = [os.path.join(work, f"anchor_part{i}.mums") for i in range(2)]
    coll = os.path.join(work, "anchor_collective")
    rc, s, lm = bench.counted(torch, lambda: cli.main(
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
    if any(_kr_of(lm).values()):
        raise AssertionError(f"merge --collective launched kernels: {lm}")
    _scanned("merge --collective", lm)
    out["paths"]["merge --collective"] = lm
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
    from mumemto_tpu_torch.ops import suffix as ops_suffix
    from mumemto_tpu_torch.parallel import partition
    num_docs, M = 2, 1 << 14
    rbs = [_bench_rb(1, seed=seed, n_docs=num_docs) for seed in range(4)]
    n = ops_suffix.bucket(max(int(rb.text.size) for rb in rbs) + 4, lo=4096)
    texts = np.zeros((len(rbs), n), np.uint8)
    doc_ends = np.zeros((len(rbs), num_docs), np.int32)
    for p, rb in enumerate(rbs):
        texts[p, :rb.text.size] = rb.text
        doc_ends[p] = rb.doc_ends
    mesh = partition.make_mesh(4)
    fn = partition.compile_partitioned_matches(mesh, num_docs, M=M)
    torch.cuda.reset_peak_memory_stats()
    got, s, launches = bench.counted(torch, lambda: fn(texts, doc_ends))
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
    (total, step_counts, longest), step_s, l_step = bench.counted(
        torch, lambda: step(texts, doc_ends))
    if int(total) != int(counts.sum()) or \
            step_counts.cpu().tolist() != counts.tolist():
        raise AssertionError(f"partitioned step: total {int(total)}, "
                             f"counts {counts.tolist()}")
    scan = partition.compile_sharded_scan(mesh, n, num_docs, M=M)
    one, scan_s, l_scan = bench.counted(torch, lambda: scan(texts[0],
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
        if any(_kr_of(got_l).values()):
            raise AssertionError(f"partition {what} launched kernels: "
                                 f"{got_l}")
    out["partition mesh"] = {
        "mesh_shape": list(mesh.shape), "axis_names": list(mesh.axis_names),
        "partitions": len(rbs), "docs": num_docs, "n": n, "M": M,
        "counts": counts.tolist(), "matches": matches, "mums_bytes": sizes,
        "longest": longest.cpu().tolist(), "total": int(total),
        "matches_s": s, "step_s": step_s, "sharded_scan_s": scan_s,
        "peak_alloc_bytes": peak, "launches": launches, "refused": refused}
    out["paths"]["partition mesh"] = launches
    log(f"[partition] {json.dumps(out['partition mesh'])}")


_DCN_WORKER = r"""
import json, os, sys, time
t0 = time.perf_counter()
sys.path.insert(0, sys.argv[5])
import torch
import chip_smoke
from mumemto_tpu_torch import bench, trace
from mumemto_tpu_torch.kernels import kr_mask
from mumemto_tpu_torch.parallel import dcn, mumemtom
rank, port, prefix = int(sys.argv[1]), sys.argv[2], sys.argv[3]
files = open(sys.argv[4]).read().split()
collective, device = sys.argv[6] == "1", sys.argv[7]
nproc, nparts = int(sys.argv[8]), int(sys.argv[9])
card = torch.device(device).type == "cuda"
if card:
    torch.cuda.init()  # a card's memory counters exist only after it
scanned, parts, kr_devices = [], [], []
real_scan, real_kr = mumemtom.scan_partition, kr_mask.break_mask
def scan(pfiles, pfx, **kw):
    if card:
        torch.cuda.reset_peak_memory_stats(device)
    t = time.perf_counter()
    with chip_smoke._PrepSpy() as spy:
        out = real_scan(pfiles, pfx, **kw)
    if card:
        torch.cuda.synchronize(device)
    scanned.append(int(pfx.rsplit("_part", 1)[1]))
    flat = chip_smoke._flat_sizes(spy)
    parts.append({
        "docs": len(pfiles), "s": time.perf_counter() - t,
        "peak_alloc_bytes":
            torch.cuda.max_memory_allocated(device) if card else 0,
        **{k: spy.sizes[0][k] for k in ("d_len", "nd", "nr", "lvl_cap")},
        **{k: flat[k] for k in ("dict_levels", "dict_flat_share")}})
    return out
def break_mask(ext, *a):
    if ext.device.type == "cuda":
        kr_devices.append(str(ext.device))
    return real_kr(ext, *a)
mumemtom.scan_partition = scan
kr_mask.break_mask = break_mask
dcn.initialize("127.0.0.1:" + port, nproc, rank)
trace.enable()
t1 = time.perf_counter()
dcn.run_partitioned_dcn(files, prefix, anchor=True, num_partitions=nparts,
                        collective=collective, device=device)
launches = bench.launch_counts(trace.totals())
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "mumemto_tpu", "bench"))
assert not bad, bad
print("DCN_WORKER " + json.dumps({
    "rank": rank, "device": device, "scanned": scanned, "partitions": parts,
    **launches, "kr_devices": kr_devices, "start_s": t1 - t0,
    "run_s": time.perf_counter() - t1,
    "peak_alloc_bytes":
        torch.cuda.max_memory_allocated(device) if card else 0}))
"""


def _dcn_group(worker, prefix, filelist, collective, env, devices, nparts):
    """One worker per entry of `devices` (rank r on devices[r]), one gloo
    group on a free port of 127.0.0.1, run to their end: (the processes,
    each one's (stdout, stderr))."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, worker, str(rank), str(port), prefix, filelist,
         ROOT, "1" if collective else "0", device, str(len(devices)),
         str(nparts)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env) for rank, device in enumerate(devices)]
    ends = []
    try:
        for p in procs:
            ends.append(p.communicate(timeout=900))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return procs, ends


def _dcn_setup(work, fastas, tag):
    """The worker script, the file list and the environment of a dcn pair
    on `fastas`, written into `work`."""
    filelist = os.path.join(work, f"{tag}_files.txt")
    with open(filelist, "w") as fh:
        fh.write("\n".join(fastas))
    worker = os.path.join(work, "dcn_worker.py")
    with open(worker, "w") as fh:
        fh.write(_DCN_WORKER)
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    for k in ("MUMEMTO_COORDINATOR", "MUMEMTO_NUM_PROCESSES",
              "MUMEMTO_PROCESS_ID", "MUMEMTO_SHARD_DICT"):
        env.pop(k, None)
    return worker, filelist, env


def _dcn_run(label, worker, prefix, filelist, collective, env, devices,
             want_files, nparts=2):
    """One dcn group to its end, rank r on devices[r] (one retry on a fresh
    port: another job on the machine can take the port between its probe
    and the workers' bind, and a loaded host can miss gloo's connect
    window; a real fault shows again). Of nparts anchor partitions, rank r
    must have scanned r, r + P, ..., launching the KR kernel and sorting
    the phrases (_sorted) once a partition on its own card ("cuda" is
    cuda:0 in every process) and never on the CPU; with want_files (a
    prefix) the merged files must equal its. Returns (group seconds, the
    ranks' records, the files' sizes)."""
    for attempt in (0, 1):
        t0 = time.perf_counter()
        procs, ends = _dcn_group(worker, prefix, filelist, collective, env,
                                 devices, nparts)
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
        mine = list(range(rank, nparts, len(devices)))
        card = devices[rank] if ":" in devices[rank] else \
            devices[rank] + ":0"
        want_kr = [card] * len(mine) if card.startswith("cuda") else []
        if rec["scanned"] != mine or rec["kr_devices"] != want_kr or \
                rec["kr_break_mask"] != len(want_kr) or rec["add_one"] or \
                (rec["running_scan"] > 0) != bool(want_kr) or \
                not bench.sorted_on_card(rec, len(want_kr)):
            raise AssertionError(f"{label}: rank {rank} on "
                                 f"{devices[rank]} reports {rec}")
        ranks.append(rec)
    sizes = {}
    if want_files is None:
        return wall, ranks, sizes
    for ext in (".mums", ".athresh", ".lengths"):
        with open(prefix + ext, "rb") as a, open(want_files + ext, "rb") as b:
            ga, gb = a.read(), b.read()
        if ga != gb or not ga:
            raise AssertionError(f"{label}: {ext} != the single-process "
                                 "MumemtoM anchor run's")
        sizes[ext] = len(ga)
    return wall, ranks, sizes


def _dcn_pairs(torch, out, work, anchor_s):
    """parallel/dcn with two worker processes that share the card: gloo
    over 127.0.0.1 on a free port, phase 10's 8 FASTAs, anchor partitions,
    the host fold and the collective fold. Each run's files must equal
    phase 10's MumemtoM anchor run's, which are in `work`. Then four
    workers on 4 partitions (_dcn_four)."""
    fastas = [os.path.join(work, f"d{i}.fa") for i in range(N_DOCS)]
    worker, filelist, env = _dcn_setup(work, fastas, "dcn")
    out["dcn"] = {"single_process_anchor_s": anchor_s}
    for collective in (False, True):
        label = "dcn collective" if collective else "dcn host fold"
        prefix = os.path.join(work, label.replace(" ", "_"))
        wall, ranks, sizes = _dcn_run(label, worker, prefix, filelist,
                                      collective, env, ["cuda"] * 2,
                                      os.path.join(work, "anchor"))
        out["dcn"][label] = {"wall_s": wall, "ranks": ranks, "sizes": sizes}
        log(f"[dcn] {label}: pair {wall:.3f} s beside {anchor_s:.3f} s in "
            f"one process; {json.dumps(out['dcn'][label])}")
        out["paths"][label] = {k: sum(r[k] for r in ranks)
                               for k in LAUNCH_KEYS}
    _dcn_four(torch, out, work, fastas)


def _dcn_four(torch, out, work, fastas):
    """parallel/dcn with four worker processes that share the card (the
    P-rank path of `--cards` rows m1 and m2) on the same FASTAs in 4
    anchor partitions, host fold: files equal to a single-process
    run_partitioned_files with 4 partitions."""
    from mumemto_tpu_torch.parallel import mumemtom
    single = os.path.join(work, "anchor4")
    path, s, launches = bench.counted(
        torch, lambda: mumemtom.run_partitioned_files(
            fastas, single, num_partitions=4, anchor=True, device="cuda"))
    _kr_used("MumemtoM 4 anchor partitions", launches)
    out["paths"]["MumemtoM 4 anchor partitions"] = launches
    worker, filelist, env = _dcn_setup(work, fastas, "dcn4")
    label = "dcn 4 ranks"
    wall, ranks, sizes = _dcn_run(label, worker, os.path.join(work, "dcn4"),
                                  filelist, False, env, ["cuda"] * 4, single,
                                  4)
    out["dcn"][label] = {"wall_s": wall, "single_process_s": s,
                         "ranks": ranks, "sizes": sizes}
    log(f"[dcn] {label}: {wall:.3f} s beside {s:.3f} s in one process; "
        f"{json.dumps(out['dcn'][label])}")
    out["paths"][label] = {k: sum(r[k] for r in ranks)
                           for k in LAUNCH_KEYS}


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
    _dcn_pairs(torch, out, work, report["slice"]["mumemtom anchor"]["s"])
    report["modules"] = out


class _PrepSpy:
    """Records the sizes ops/pfp._host_prep gives every scan prepared while
    it is active: the dictionary's and the row space's sizes, the doubling
    depth and the alphabet variant; and in `rmq` the (entries, levels) of
    every range-min table ops/pfp._rmq_query is asked to query."""

    def __init__(self):
        from mumemto_tpu_torch.ops import pfp as ops_pfp
        self.mod = ops_pfp
        self.sizes = []
        self.rmq = []

    def __enter__(self):
        self.real = self.mod._host_prep
        self.real_rmq = self.mod._rmq_query

        def rmq(table, lo, hi):
            self.rmq.append((int(table[0].shape[0]), len(table)))
            return self.real_rmq(table, lo, hi)
        self.mod._rmq_query = rmq

        def host_prep(pfp, doc_ends):
            h = self.real(pfp, doc_ends)
            self.sizes.append({
                "d_len": h["total_real"] + 1, "nd": h["nd"], "nr": h["nr"],
                "rows": h["total_rows"],
                "lvl_cap": h["lvl_cap"],
                "lvl_static": h["lvl_static"], "phrases": h["npz"],
                "parse_entries": h["m"],
                "longest_phrase": int(pfp.phrase_ln.max()),
                "alphabet": len(set(pfp.alpha) | {0, 1, 2}),
                "seed_thr_is_none": h["seed_thr"] is None,
                "lcp_thr_is_none": h["lcp_thr"] is None})
            return h
        self.mod._host_prep = host_prep
        return self

    def __exit__(self, *exc):
        self.mod._host_prep = self.real
        self.mod._rmq_query = self.real_rmq


STAGES = ("build_pfp", "dict_index", "parse_side", "expand_sort_analyze",
          "compact", "emit")


def _real_line(tag, entry, acgt):
    """One line for a row of the real-alphabet phase: the stage split, wall,
    Mbp/s, peak, matches and sizes, each with the ACGT run's figure of the
    same call in brackets where there is one."""
    def pair(fmt, get):
        out = fmt % get(entry)
        return out + (" [" + fmt % get(acgt) + "]" if acgt else "")
    parts = [f"{k} " + pair("%.3f", lambda e, k=k: e["stages_s"][k])
             for k in STAGES]
    parts += ["wall " + pair("%.3f", lambda e: e["wall_s"]) + " s",
              pair("%.2f", lambda e: e["mbp"] / e["wall_s"]) + " Mbp/s",
              "peak " + pair("%.2f", lambda e: e["peak_alloc_bytes"] / 2**30)
              + " GiB", "matches " + pair("%d", lambda e: e["matches"])]
    parts += [f"{k} {entry[k]}" for k in ("nd", "nr", "lvl_cap",
                                          "longest_phrase") if k in entry]
    log(f"[real] {tag}: " + ", ".join(parts) + " ([ACGT, same call])")


def _real_row(torch, tag, label, rb, opts, mbp, acgt, variant):
    """One PFP row of the real-alphabet phase through _drive (a cold and a
    warm run, the match count against a live baseline_cpu run), with the
    sizes of the run and the alphabet variant it must take: `variant` is
    (seed_thr is None, lcp_thr is None). Exactly 1 KR launch a run."""
    with _PrepSpy() as spy:
        entry, res = _drive(torch, label, rb, opts, mbp)
    if len(spy.sizes) != 2 or spy.sizes[0] != spy.sizes[1]:
        raise AssertionError(f"{label}: two runs prepared {spy.sizes}")
    entry.update(spy.sizes[0])
    if _kr_of(entry["launches"]) != {"kr_break_mask": 2, "add_one": 0}:
        raise AssertionError(f"{label}: kernel launches {entry['launches']} "
                             "in two runs, expected 1 KR launch a run")
    got = (entry["seed_thr_is_none"], entry["lcp_thr_is_none"])
    if got != variant:
        raise AssertionError(f"{label}: (seed_thr, lcp_thr) is None = {got}, "
                             f"expected {variant}")
    _real_line(tag, entry, acgt)
    return entry, res


def phase_real(torch, report, mbp=8, mbp_big=32, mbp_bytes=1):
    """The real-alphabet variant of the main path on
    bench.synth_collection_real (N gaps; with iupac the ten ambiguity
    codes): the 7-bit seed and the rank-descent dictionary LCP, which any
    input with an N takes. Rows a-g
    of the module docstring's phase 13; every comparison raises on a
    difference and nothing is caught. report["e2e"] and report["mem"] hold
    the ACGT runs of the same call that each row is printed beside."""
    import numpy as np
    from mumemto_tpu_torch import engine, options, refbuilder
    from mumemto_tpu_torch.kernels import kr_mask
    from mumemto_tpu_torch.parallel import mesh, seqpfp
    t_phase = time.perf_counter()
    out = {"paths": {}, "rows": {}}
    opts = options.normalize(N_DOCS, quiet=True)
    opts_f3 = options.normalize(N_DOCS, rare_freq=3, max_mem_freq=0,
                                quiet=True)
    acgt = {"mum": report.get("e2e", {}).get(f"{mbp}mbp"),
            "big": report.get("e2e", {}).get(f"{mbp_big}mbp"),
            "f3": report.get("mem", {}).get(f"f3 {mbp}mbp")}

    # the complement table on the codes: R<->Y, K<->M, B<->V, D<->H, S, W, N
    codes = np.frombuffer(b"N" + bench.IUPAC_CODES, np.uint8)
    if refbuilder.revcomp(codes).tobytes() != b"BDHVWSKMRYN":
        raise AssertionError("refbuilder.revcomp on the IUPAC codes: "
                             f"{refbuilder.revcomp(codes).tobytes()}")

    rb = _real_rb(mbp)
    n_share = float((rb.text == ord("N")).mean())
    out["n_share"] = n_share
    log(f"[real] ACGTN {mbp} Mbp: {rb.text.size} chars, {n_share:.4%} N")

    # the KR kernel on a text with runs of equal bytes, where a rolling
    # hash that drops a term would show: mask and count exactly equal
    ext = torch.from_numpy(_ext_of(rb.text, 10)).to(engine.resolve("cuda"))
    m_k, c_k = kr_mask.break_mask(ext, int(rb.text.size), 10, 100)
    m_p, c_p = kr_mask.break_mask_plain(ext, int(rb.text.size), 10, 100)
    err = max(int((m_k != m_p).sum()), abs(int(c_k) - int(c_p)))
    out["kernel"] = {"ne": int(ext.numel()), "breaks": int(c_k),
                     "mismatches": err}
    log(f"[real] KR kernel on the ACGTN ext: {json.dumps(out['kernel'])}")
    if err:
        raise AssertionError("kr_mask kernel != plain on the ACGTN ext")
    report["kernel_max_abs_err"] = max(report.get("kernel_max_abs_err", 0),
                                       err)
    del ext, m_k, m_p

    # a, c: ACGTN, strict MUMs and -f 3; d: IUPAC; b: the large tier
    row_a, res_a = _real_row(torch, "a", f"real ACGTN {mbp} Mbp", rb, opts,
                             mbp, acgt["mum"], (True, False))
    out["rows"]["a"] = row_a
    bytes_a = res_a.output_bytes()
    out["rows"]["c"], res_c = _real_row(
        torch, "c", f"real ACGTN -f 3 {mbp} Mbp", rb, opts_f3, mbp,
        acgt["f3"], (True, False))
    del res_c
    rb_d = _real_rb(mbp, iupac=True)
    out["rows"]["d"], res_d = _real_row(
        torch, "d", f"real IUPAC {mbp} Mbp", rb_d, opts, mbp, acgt["mum"],
        (True, True))
    bytes_d = res_d.output_bytes()
    if out["rows"]["d"]["alphabet"] != 19 or row_a["alphabet"] != 9:
        raise AssertionError(f"alphabets of {row_a['alphabet']} and "
                             f"{out['rows']['d']['alphabet']} bytes, "
                             "expected 9 and 19")
    del res_d
    out["rows"]["b"], res_b = _real_row(
        torch, "b", f"real ACGTN {mbp_big} Mbp", _real_rb(mbp_big), opts,
        mbp_big, acgt["big"], (True, False))
    del res_b
    for key in "abcd":
        out["paths"][out["rows"][key]["label"]] = out["rows"][key]["launches"]

    # e: the direct backend against the PFP rows' bytes. Its text holds no
    # parse bytes, so ACGTN with the pad's 0 is 7 letters and keeps the
    # 3-bit seed and the PLCP; the IUPAC input takes the 7-bit seed and the
    # unpacked descent
    acgt_g = report.get("routes", {}).get("-g")
    for key, alpha, rb_g, want in (("e", "ACGTN", rb, bytes_a),
                                   ("e2", "IUPAC", rb_d, bytes_d)):
        label = f"real {alpha} -g {mbp} Mbp"
        engine.find_matches(rb_g, opts, device="cuda", backend="direct")
        torch.cuda.reset_peak_memory_stats()
        timer = bench.StageTimer(torch)
        res_g, wall, lg = bench.counted(torch, lambda: engine.find_matches(
            rb_g, opts, device="cuda", backend="direct", phase=timer))
        row_e = {"label": label, "mbp": mbp, "wall_s": wall,
                 "stages_s": timer.stages, "matches": res_g.num_matches,
                 "peak_alloc_bytes": torch.cuda.max_memory_allocated(),
                 "launches": lg,
                 "bytes_equal_pfp_row": res_g.output_bytes() == want}
        del res_g
        row_e["index"] = _direct_index(torch, rb_g)
        if acgt_g:
            row_e["acgt"] = {k: acgt_g[k] for k in (
                "wall_s", "matches", "peak_alloc_bytes", "index")}
        log(f"[real] {key}: {json.dumps(row_e)}")
        if not row_e["bytes_equal_pfp_row"] or any(_kr_of(lg).values()):
            raise AssertionError(f"{label}: bytes != the PFP row's, or "
                                 f"kernels launched: {lg}")
        _scanned(label, lg)
        if (row_e["index"]["lcp"] == "descent") != (alpha == "IUPAC"):
            raise AssertionError(f"{label}: the index took the "
                                 f"{row_e['index']['lcp']} LCP")
        out["rows"][key] = row_e
        out["paths"][label] = lg
    del rb_d

    # f: the sharded scan, 4 shards on the card, against row a's bytes;
    # the sharded dictionary index must refuse this alphabet
    label = f"real ACGTN {mbp} Mbp, 4 shards"
    row_f, res_f = _drive_sharded(torch, label, rb, opts, 4, bytes_a, M=8192)
    del res_f
    try:
        seqpfp.find_matches_seq_sharded(rb, opts,
                                        mesh.seq_devices(4, "cuda"), M=8192,
                                        shard_dict=True)
    except AssertionError as e:
        row_f["shard_dict_refused"] = str(e)
    else:
        raise AssertionError(f"{label}: shard_dict=True was not refused")
    if "packed <=8-byte alphabet" not in row_f["shard_dict_refused"]:
        raise AssertionError(f"{label}: shard_dict=True refused with "
                             f"{row_f['shard_dict_refused']!r}")
    log(f"[real] f: shard_dict=True refused: "
        f"{row_f['shard_dict_refused']}")
    out["rows"]["f"] = row_f
    out["paths"][label] = row_f["launches"]

    # g: output bytes on the card against the port's CPU path
    same = {}
    for alpha, iupac in (("ACGTN", False), ("IUPAC", True)):
        rb_small = _real_rb(mbp_bytes, seed=1, iupac=iupac)
        for name, kw, run_kw, exts in (
                ("mums", {}, {}, {".mums"}),
                ("-f 3", {"rare_freq": 3}, {}, {".mems"}),
                ("-M", {"merge": True}, {},
                 {".mums", ".thresh", ".thresh_rev"}),
                ("-g", {}, {"backend": "direct"}, {".mums"})):
            o = options.normalize(N_DOCS, quiet=True, **kw)
            with tempfile.TemporaryDirectory() as tmp:
                gpu = _written(engine, rb_small, o, "cuda", tmp, "cuda",
                               **run_kw)
                cpu = _written(engine, rb_small, o, "cpu", tmp, "cpu",
                               **run_kw)
            sizes = {ext: len(b) for ext, b in sorted(gpu.items())}
            log(f"[real] g: {alpha} {mbp_bytes} Mbp {name}: cuda {sizes}")
            if gpu != cpu or set(gpu) != exts or not all(gpu.values()):
                raise AssertionError(f"{alpha} {mbp_bytes} Mbp {name}: cuda "
                                     "files != cpu files")
            same[f"{alpha} {name}"] = sizes
    out["rows"]["g"] = same
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[real] the phase took {out['phase_s']:.1f} s")
    report["real"] = out


BENCH_ARGV = ["--config", "mum8", "real8", "f3_8", "--reps", "3",
              "--baseline"]


def phase_bench(torch, report, argv=BENCH_ARGV):
    """The throughput harness on the card (module docstring, phase 15):
    bench.run on `argv`. The harness counts every call's kernel launches
    from 0 and raises unless each call launched the KR kernel as its route
    must and the count equals the one on record and the live baseline's;
    each configuration's launches go in the main path's record."""
    out = {"paths": {}, "records": {}}
    for rec in bench.run(torch, bench.parse_args(argv)):
        log(f"[bench] {json.dumps(rec)}")
        if rec["matches"] != rec["expected"] or \
                rec["baseline"]["matches"] != rec["matches"]:
            raise AssertionError(f"bench {rec['config']}: {rec['matches']} "
                                 f"matches, {rec['expected']} on record, "
                                 f"baseline {rec['baseline']}")
        out["records"][rec["config"]] = rec
        out["paths"][f"bench {rec['config']}"] = {
            "kr_break_mask": rec["kr_launches"] * rec["calls"], "add_one": 0,
            "running_scan": rec["scan_launches"], **rec["phrase_launches"]}
    report["bench"] = out


# a range-min table of n entries x levels past this has no int32 flat
# index: the JAX package refuses it, the port reads it level by level
FLAT_INDEX_LIMIT = 2**31
SCALE_DOCS = (10, 20)  # BASELINE.md configs 2-3 and 4: E. coli-like genomes


def _flat_sizes(spy) -> dict:
    """The dictionary's range-min table (the one over nd entries) of the
    scans `spy` saw: entries, levels, their product against 2^31."""
    nd = spy.sizes[0]["nd"]
    levels = {lv for n, lv in spy.rmq if n == nd}
    if len(levels) != 1:
        raise AssertionError(f"range-min tables {spy.rmq} for nd {nd}")
    lv = levels.pop()
    return {"dict_levels": lv, "dict_flat": nd * lv,
            "dict_flat_share": nd * lv / FLAT_INDEX_LIMIT,
            "rmq_tables": sorted(set(spy.rmq))}


def _scale_line(tag, e):
    """One line for a row of the scale phase."""
    stages = ", ".join(f"{k} {v:.3f}" for k, v in e["stages_s"].items())
    top = max(e["stage_peak_bytes"], key=e["stage_peak_bytes"].get)
    log(f"[scale] {tag}: {e['label']}: nd {e['nd']} x {e['dict_levels']} "
        f"levels = {e['dict_flat']} ({e['dict_flat_share']:.1%} of 2^31), "
        f"nr {e['nr']}, wall {e['wall_s']:.3f} s (runs "
        f"{', '.join('%.3f' % w for w in e['walls_s'])}), "
        f"{e['mbp_per_s']:.2f} Mbp/s, peak "
        f"{e['peak_alloc_bytes'] / 2**30:.2f} GiB (in {top}), KR launches "
        f"{e['launches']['kr_break_mask']} in {len(e['walls_s'])} runs, "
        f"{e['matches']} matches; {stages}")


def _scale_runs(torch, label, run, mbp, split=None):
    """A cold and a warm run of `run` (the first at a new size), each with the
    kernels' launch counts set to 0 just before and read just after: every
    run must launch the KR kernel exactly once (one PFP scan) and the
    probe kernel never. Each runs under a stage timer that also keeps each
    stage's peak allocation (_AllCardsTimer, one card here): `run` takes
    the timer as its phase, or with `split` ({name: (module, attribute)})
    a bench.Split times those functions and hands the timer to find_matches.
    Returns (record of the last run, its result)."""
    walls, launches = [], []
    with _PrepSpy() as spy:
        for last in (False, True):
            timer = _AllCardsTimer(torch)
            spl = bench.Split(torch, split, phase=timer) if split else None
            torch.cuda.reset_peak_memory_stats()
            with spl or contextlib.nullcontext():
                res, s, lc = bench.counted(torch, lambda: run(timer))
            walls.append(s)
            launches.append(lc)
            if not last:
                del res
    if len(spy.sizes) != 2 or spy.sizes[0] != spy.sizes[1]:
        raise AssertionError(f"{label}: two runs prepared {spy.sizes}")
    if any(_kr_of(lc) != {"kr_break_mask": 1, "add_one": 0}
           for lc in launches):
        raise AssertionError(f"{label}: kernel launches {launches}, "
                             "expected 1 KR launch a run")
    for lc in launches:
        _scanned(label, lc)
    stage_peaks = {k: v[0] for k, v in timer.stage_peaks.items()}
    entry = {"label": label, "mbp": mbp, "wall_s": walls[-1],
             "walls_s": walls, "mbp_per_s": mbp / walls[-1],
             "stages_s": timer.stages, "stage_peak_bytes": stage_peaks,
             "peak_alloc_bytes": max(torch.cuda.max_memory_allocated(),
                                     *stage_peaks.values()),
             "launches": {k: sum(lc[k] for lc in launches)
                          for k in launches[0]},
             **spy.sizes[0], **_flat_sizes(spy)}
    if spl:
        entry["split_s"] = spl.s
    return entry, res


def _scale_scan(torch, tag, label, rb, opts, mbp):
    """A row of the scale phase through engine.find_matches; the count is
    held against baseline_cpu later (_baselines_together)."""
    from mumemto_tpu_torch import engine
    entry, res = _scale_runs(
        torch, label, lambda timer: engine.find_matches(
            rb, opts, device="cuda", phase=timer), mbp)
    entry.update(num_docs=rb.num_docs, text_chars=int(rb.text.size),
                 k=opts.num_distinct, f=opts.max_doc_freq,
                 F=opts.max_total_freq, matches=res.num_matches,
                 size_cap=engine.interval_size_cap(opts, rb.num_docs))
    _scale_line(tag, entry)
    return entry, res


def _baselines_together(jobs) -> dict:
    """Live native/baseline_cpu runs for jobs [(label, rb, opts, mbp)], all
    started together, one core each (the binary built first, so that no two
    builds race): {label: (seconds, matches)}."""
    from concurrent.futures import ThreadPoolExecutor
    bench.build_cpu_baseline()

    def one(job):
        _label, rb, opts, mbp = job
        mbp_s, matches = bench.run_cpu_baseline(rb.text, rb.seq_lengths,
                                                opts, mbp)
        return mbp / mbp_s, matches
    with ThreadPoolExecutor(len(jobs)) as pool:
        outs = list(pool.map(one, jobs))
    return {job[0]: out for job, out in zip(jobs, outs)}


def _refused(torch, tag, label, rb, opts):
    """One scan of a collection past one card: find_matches on the card,
    refused by size (ScanSizeError) or by the card's memory, in the words
    the CLI's partition fallback takes (cli._too_big), after exactly one KR
    launch and at most one phrase sort (_sorted). Returns its record with
    `refused` False when the scan ran to its end (a finding, printed as
    such)."""
    import gc
    from mumemto_tpu_torch import cli, engine

    def scan():
        """(None, the match count), or (the refusal, None)."""
        try:
            res = engine.find_matches(rb, opts, device="cuda")
        except Exception as e:
            err = cli._too_big(e)
            if err is None:
                raise
            return err, None
        return None, res.num_matches
    with _PrepSpy() as spy:
        t0 = time.perf_counter()
        (err, matches), _s, launches = bench.counted(torch, scan)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        s = time.perf_counter() - t0
    nd = spy.sizes[0]["nd"]
    flat = _flat_sizes(spy) if any(n == nd for n, _ in spy.rmq) else {}
    entry = {"label": label, "num_docs": rb.num_docs,
             "text_chars": int(rb.text.size), "s": s, "launches": launches,
             **spy.sizes[0], **flat, "refused": err is not None,
             "error": err}
    sorts = launches["phrase_fingerprint"]
    if _kr_of(launches) != {"kr_break_mask": 1, "add_one": 0} or sorts > 1 \
            or not bench.sorted_on_card(launches, sorts):
        raise AssertionError(f"{label}: kernel launches {launches}")
    if err is None:
        entry["matches"] = matches
        log(f"[scale] {tag}: FINDING: {label} ran to its end on one card, "
            f"nd {nd}, nr {entry['nr']} ({matches} matches, {s:.1f} s)")
        return entry
    log(f"[scale] {tag}: {label} refused after {s:.1f} s: nd {nd}, nr "
        f"{entry['nr']}; {err}")
    return entry


def _refused_text(torch, num_docs: int):
    """A refusal the port keeps, at the card's size: a text of 2^31
    characters (a zero-copy view: build_pfp reads its length alone, so
    nothing is made or uploaded) through find_matches on the card must be
    refused by ScanSizeError before the KR kernel, in the words the CLI's
    partition fallback takes."""
    import numpy as np
    from mumemto_tpu_torch import cli, engine, options
    from mumemto_tpu_torch.ops import pfp as ops_pfp
    from mumemto_tpu_torch.refbuilder import RefBuilder
    per_doc = 2**31 // num_docs + 1
    n = per_doc * num_docs
    rb = RefBuilder(text=np.broadcast_to(np.uint8(ord("A")), (n,)),
                    seq_lengths=[per_doc] * num_docs, num_docs=num_docs,
                    use_revcomp=True, input_files=[], multifasta_names=[],
                    multifasta_lengths=[])
    opts = options.normalize(num_docs, quiet=True)

    def refused():
        try:
            engine.find_matches(rb, opts, device="cuda")
        except ops_pfp.ScanSizeError as e:
            return str(e), cli._too_big(e)
        raise AssertionError(f"a text of {n} characters was not refused")
    (err, why), s, launches = bench.counted(torch, refused)
    entry = {"label": f"a text of 2^31 characters, {num_docs} docs",
             "text_chars": n, "s": s, "launches": launches, "refused": True,
             "error": err}
    if "int32 phrase coordinates" not in err or why != err or \
            _kr_of(entry["launches"]) != {"kr_break_mask": 0, "add_one": 0}:
        raise AssertionError(f"text refusal: {err!r}, the CLI's answer "
                             f"{why!r}, launches {entry['launches']}")
    log(f"[scale] f: {entry['label']} refused after {entry['s']:.3f} s: "
        f"{err}")
    return entry


def phase_scale(torch, report, doc_mbp=5.0, bench_mbp=(64, 96),
                dcn_device="cuda"):
    """The main path at BASELINE.md's sizes on one card (module docstring,
    phase 14): 10 and 20 genome-sized documents of doc_mbp Mbp (rows a-d2),
    the 8-doc bench collection at bench_mbp (e), row a's documents at 1%
    SNPs past the range-min's flat index and a text past the phrase
    coordinates, refused (f), and the KR kernel on the largest ext (k).
    Every comparison raises on a difference; nothing is caught but the
    refusal that row f expects. dcn_device: the device of row d2's
    workers."""
    import numpy as np
    from mumemto_tpu_torch import cli, engine, options, refbuilder
    from mumemto_tpu_torch.analysis import merge as merge_mod
    from mumemto_tpu_torch.kernels import kr_mask
    from mumemto_tpu_torch.ops import pfp as ops_pfp
    from mumemto_tpu_torch.parallel import mumemtom
    t_phase = time.perf_counter()
    out = {"paths": {}, "rows": {}, "refused": {}}
    jobs = []
    n_small, n_big = SCALE_DOCS

    # a, b: 10 documents, partial multi-MUMs (-k -1) and -f 3
    docs_a = bench.synth_collection(n_small * doc_mbp, n_small, seed=0)
    rb_a = bench.rb_of(docs_a)
    for key, kw in (("a", {"num_distinct_docs": -1}),
                    ("b", {"rare_freq": 3, "max_mem_freq": 0})):
        opts = options.normalize(n_small, quiet=True, **kw)
        flags = "-k -1" if key == "a" else "-f 3"
        label = f"{n_small} docs x {doc_mbp:g} Mbp {flags}"
        entry, res = _scale_scan(torch, key, label, rb_a, opts,
                                 n_small * doc_mbp)
        del res
        if key == "a" and opts.num_distinct != n_small - 1:
            raise AssertionError(f"-k -1 resolved to k = {opts.num_distinct}")
        out["rows"][key] = entry
        jobs.append((key, rb_a, opts, n_small * doc_mbp))

    # c: 20 documents from 20 FASTAs through the CLI, strict MUMs
    docs_c = bench.synth_collection(n_big * doc_mbp, n_big, seed=0)
    rb_c = bench.rb_of(docs_c)
    doc_lens = [int(d.size) for d in docs_c]
    opts_c = options.normalize(n_big, quiet=True)
    with tempfile.TemporaryDirectory() as work:
        fastas = bench.write_fastas(docs_c, work)
        union = os.path.join(work, "union")

        cli_fns = {"fasta": (refbuilder, "build_from_files"),
                   "scan": (engine, "find_matches"),
                   "write": (engine, "write_outputs")}
        label = f"{n_big} docs x {doc_mbp:g} Mbp, cli.main from FASTA"
        entry, rc = _scale_runs(torch, label, lambda _t: cli.main(
            fastas + ["-o", union]), n_big * doc_mbp, cli_fns)
        want = _mums_set(union + ".mums", n_big)
        entry.update(num_docs=n_big, text_chars=int(rb_c.text.size), rc=rc,
                     matches=len(want),
                     size_cap=engine.interval_size_cap(opts_c, n_big),
                     union_terminal_touching=sum(
                         _touches_terminal(r, doc_lens) for r in want))
        _scale_line("c", entry)
        if rc != 0:
            raise AssertionError(f"{label}: exit {rc}")
        out["rows"]["c"] = entry
        jobs.append(("c", rb_c, opts_c, n_big * doc_mbp))

        # d: MumemtoM, 2 anchor partitions in one process, anchor merge
        parts = []
        real, spy = _partition_spy(torch, mumemtom, parts)
        timer = bench.SumTimer(torch)
        split = bench.Split(torch, {
            **cli_fns,
            "merge": (mumemtom, "merge_partition_outputs"),
            "merge_read": (merge_mod, "parse_candidate"),
            "merge_fold": (merge_mod, "merge_partitions")}, phase=timer)
        anchor = os.path.join(work, "anchor")
        mumemtom.scan_partition = spy
        try:
            with split, _PrepSpy() as prep:
                path, s, lp = bench.counted(
                    torch, lambda: mumemtom.run_partitioned_files(
                        fastas, anchor, num_partitions=2, anchor=True,
                        device="cuda"))
        finally:
            mumemtom.scan_partition = real
        split_parts = mumemtom.auto_partition(fastas, 2, anchor=True)
        order = [fastas.index(f) for f in split_parts[0]] + [
            fastas.index(f) for p in split_parts[1:] for f in p[1:]]
        got = _mums_set(path, n_big, order)
        diff = want ^ got
        terminal = [r for r in diff if _touches_terminal(r, doc_lens)]
        row_d = {"label": f"{n_big} docs, MumemtoM 2 anchor partitions",
                 "s": s, "launches": lp, "partitions": parts,
                 "partition_docs": [len(p) for p in split_parts],
                 "partition_sizes": [
                     {k: z[k] for k in ("nd", "nr", "lvl_cap", "phrases")}
                     for z in prep.sizes],
                 "rmq_tables": sorted(set(prep.rmq)),
                 "split_s": split.s, "calls": split.calls,
                 "stages_s": timer.stages, "matches": len(got),
                 "only_union": len(want - got),
                 "only_merged": len(got - want),
                 "terminal_touching_differences": len(terminal)}
        log(f"[scale] d: {json.dumps(row_d)}")
        if len(terminal) != len(diff) or [p["kr_launches"] for p in parts] \
                != [1, 1] or _kr_of(lp) != {"kr_break_mask": 2, "add_one": 0} \
                or not lp["running_scan"]:
            raise AssertionError(f"MumemtoM at {n_big} docs: "
                                 f"{len(diff) - len(terminal)} MUMs differ "
                                 "from the union's away from the "
                                 f"terminators, launches {lp}, {parts}")
        out["rows"]["d"] = row_d

        # d2: parallel/dcn, two worker processes sharing the card
        torch.cuda.empty_cache()
        worker, filelist, env = _dcn_setup(work, fastas, "scale")
        prefix = os.path.join(work, "scale_dcn")
        wall, ranks, sizes = _dcn_run("scale dcn", worker, prefix, filelist,
                                      False, env, [dcn_device] * 2, anchor)
        out["rows"]["d2"] = {"label": f"{n_big} docs, dcn pair", "wall_s": wall,
                             "ranks": ranks, "sizes": sizes,
                             "single_process_s": s}
        log(f"[scale] d2: pair {wall:.3f} s beside {s:.3f} s in one "
            f"process; {json.dumps(out['rows']['d2'])}")
    for key in "abc":
        out["paths"][out["rows"][key]["label"]] = out["rows"][key]["launches"]
    out["paths"][out["rows"]["d"]["label"]] = lp
    out["paths"][out["rows"]["d2"]["label"]] = {
        k: sum(r[k] for r in ranks) for k in LAUNCH_KEYS}

    # k: the KR kernel on row c's ext against its plain version
    ext = torch.from_numpy(_ext_of(rb_c.text, 10)).to(engine.resolve("cuda"))
    n_c = int(rb_c.text.size)
    m_k, c_k = kr_mask.break_mask(ext, n_c, 10, 100)
    m_p, c_p = kr_mask.break_mask_plain(ext, n_c, 10, 100)
    err = max(int((m_k != m_p).sum()), abs(int(c_k) - int(c_p)))
    del m_k, m_p
    ne = int(ext.numel())
    out["kernel"] = {
        "ne": ne, "breaks": int(c_k), "mismatches": err,
        "ms": min(_event_ms(torch, lambda: kr_mask.break_mask(
            ext, n_c, 10, 100), 20) for _ in range(2)),
        "plain_ms": _event_ms(torch, lambda: kr_mask.break_mask_plain(
            ext, n_c, 10, 100), 2),
        "bound_ms": 2 * ne / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    log(f"[scale] k: KR kernel on row c's ext: {json.dumps(out['kernel'])}")
    if err:
        raise AssertionError("kr_mask kernel != plain on row c's ext")
    report["kernel_max_abs_err"] = max(report.get("kernel_max_abs_err", 0),
                                       err)
    del ext

    # e: the 8-doc bench collection at the largest sizes run so far
    opts_e = options.normalize(N_DOCS, quiet=True)
    for mbp in bench_mbp:
        rb_e = _bench_rb(mbp)
        entry, res = _scale_scan(torch, "e", f"bench {mbp:g} Mbp", rb_e,
                                 opts_e, mbp)
        del res
        out["rows"][f"e {mbp:g}"] = entry
        out["paths"][entry["label"]] = entry["launches"]
    jobs.append((f"e {mbp:g}", rb_e, opts_e, mbp))

    # f: past the range-min's int32 flat index, row a's documents at 1%
    # divergence (BASELINE config 2 as published); then a refusal that
    # remains, a text past the int32 phrase coordinates
    rb = bench.rb_of(bench.synth_collection(n_small * doc_mbp, n_small, seed=0,
                                            snp_rate=0.01))
    opts = options.normalize(n_small, quiet=True, num_distinct_docs=-1)
    entry, res = _scale_scan(torch, "f", f"{n_small} docs x {doc_mbp:g} Mbp "
                             "at 1% SNPs -k -1", rb, opts, n_small * doc_mbp)
    del res
    if entry["dict_flat"] < ops_pfp.RMQ_FLAT_LIMIT:
        raise AssertionError(f"f: nd {entry['nd']} x {entry['dict_levels']} "
                             "levels stays under the flat index's bound")
    out["rows"]["f"] = entry
    out["paths"][entry["label"]] = entry["launches"]
    jobs.append(("f", rb, opts, n_small * doc_mbp))
    text = _refused_text(torch, n_small)
    out["refused"]["text"] = text
    out["paths"][text["label"]] = text["launches"]

    # the counts of a, b, c, e and f against live baseline_cpu runs
    del rb_a, rb
    t0 = time.perf_counter()
    base = _baselines_together(jobs)
    out["baseline_wall_s"] = time.perf_counter() - t0
    for key, (b_s, b_matches) in base.items():
        row = out["rows"][key]
        row.update(baseline_s=b_s, baseline_matches=b_matches)
        log(f"[scale] {key}: {row['matches']} matches, baseline_cpu "
            f"{b_matches} in {b_s:.1f} s (runs started together)")
        if row["matches"] != b_matches or not b_matches:
            raise AssertionError(f"{row['label']}: {row['matches']} matches, "
                                 f"baseline_cpu {b_matches}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[scale] the phase took {out['phase_s']:.1f} s (baselines "
        f"{out['baseline_wall_s']:.1f} s)")
    report["scale"] = out


class _AllCardsTimer(bench.SumTimer):
    """A bench.SumTimer that waits for every visible card, not the current one,
    and keeps each card's peak allocation within each stage."""

    def __init__(self, torch):
        super().__init__(torch)
        self.stage_peaks = {}

    def __call__(self, name):
        torch = self.torch
        bench.sync_all(torch)
        super().__call__(name)
        before = self.stage_peaks.get(name, [0] * torch.cuda.device_count())
        self.stage_peaks[name] = [
            max(b, torch.cuda.max_memory_allocated(i))
            for i, b in enumerate(before)]
        for i in range(len(before)):
            torch.cuda.reset_peak_memory_stats(i)

    def peaks(self):
        """Each card's peak allocation over every stage so far."""
        return [max(p) for p in zip(*self.stage_peaks.values())]


CARD_DOCS = (20, 40)  # C20 (BASELINE.md config 4) and C40, past one card
RANKS = 4  # dcn ranks of rows m1 and m2, one card each on four cards
KR_MBP = 8  # row k's first ext: the bench collection at 8 Mbp (ne = 2^24)


def _pow2_at_least(x: int, floor: int) -> int:
    """The least power of two >= max(x, floor), floor a power of two."""
    p = floor
    while p < x:
        p *= 2
    return p


def _card_peaks(torch):
    return [torch.cuda.max_memory_allocated(i)
            for i in range(torch.cuda.device_count())]


def _reset_peaks(torch):
    bench.sync_all(torch)
    for i in range(torch.cuda.device_count()):
        torch.cuda.reset_peak_memory_stats(i)


def _gib(peaks):
    return "[" + ", ".join(f"{p / 2**30:.2f}" for p in peaks) + "] GiB"


def _order_of(fastas, parts):
    """Column j of an anchor-merged .mums is document order[j]."""
    return [fastas.index(f) for f in parts[0]] + [
        fastas.index(f) for p in parts[1:] for f in p[1:]]


def _cards_kr(torch, out, cards, c40, ranks, kr_mbp):
    """Row k: the KR kernel against its plain version on every card, on
    the bench collection's ext at kr_mbp (ne = 2^24 at 8 Mbp) and on one
    C40 partition's (the anchor and every ranks-th document after it, as
    mumemtom.auto_partition makes partition 0); CUDA-event times on the
    card beside the memory bound."""
    from mumemto_tpu_torch.kernels import kr_mask
    rows = []
    inputs = ((f"bench {kr_mbp:g} Mbp", _bench_rb(kr_mbp).text),
              (f"C{len(c40)} partition 0",
               bench.rb_of([c40[0]] + c40[1::ranks]).text))
    for tag, text in inputs:
        ext_np, n_real = _ext_of(text, 10), int(text.size)
        for dev in cards:
            ext = torch.from_numpy(ext_np).to(dev)
            (m_k, c_k), _s, launches = bench.counted(
                torch, lambda: kr_mask.break_mask(ext, n_real, 10, 100))
            launched = launches["kr_break_mask"]
            m_p, c_p = kr_mask.break_mask_plain(ext, n_real, 10, 100)
            err = max(int((m_k != m_p).sum()), abs(int(c_k) - int(c_p)))
            del m_k, m_p
            rec = {"input": tag, "card": str(dev), "ne": int(ext.numel()),
                   "breaks": int(c_k), "mismatches": err,
                   "launches": launched,
                   "ms": min(_event_ms(torch, lambda: kr_mask.break_mask(
                       ext, n_real, 10, 100), 20, dev) for _ in range(2)),
                   "plain_ms": _event_ms(
                       torch, lambda: kr_mask.break_mask_plain(
                           ext, n_real, 10, 100), 2, dev),
                   "bound_ms": 2 * ext.numel() / HBM_BYTES_PER_S * 1e3,
                   "bound_by": "bytes"}
            del ext
            log(f"[cards] k: {json.dumps(rec)}")
            if err or launched != 1:
                raise AssertionError(f"k: KR kernel on {dev}, {tag}: {rec}")
            rows.append(rec)
    out["k"] = rows


def _cards_m1(torch, out, work, docs, doc_mbp, devices):
    """Row m1, BASELINE.md config 4 as deployed: dcn with one rank per
    entry of `devices`, in as many anchor partitions, on the C20 FASTAs,
    with the host fold and with the collective fold. Each run's files must
    equal mumemtom.run_partitioned_files' in one process on one card, and
    its MUM set the union's on one card but for MUMs that touch a
    document's first or last base (counted). Returns what rows s and c
    take from it."""
    from mumemto_tpu_torch import engine, options
    from mumemto_tpu_torch.parallel import mumemtom
    n, nparts = len(docs), len(devices)
    d = os.path.join(work, "m1")
    os.makedirs(d)
    fastas = bench.write_fastas(docs, d)
    doc_lens = [int(x.size) for x in docs]
    rb = bench.rb_of(docs)
    opts = options.normalize(n, quiet=True)
    _reset_peaks(torch)
    with _PrepSpy() as prep:
        res, union_s, lu = bench.counted(torch, lambda: engine.find_matches(
            rb, opts, device="cuda"))
    union_peaks = _card_peaks(torch)
    _kr_used("m1 union", lu)
    union = os.path.join(d, "union")
    engine.write_outputs(res, rb, union)
    union_bytes = res.output_bytes()
    del res
    want = _mums_set(union + ".mums", n)
    parts = []
    real, spy = _partition_spy(torch, mumemtom, parts)
    single = os.path.join(d, "single")
    mumemtom.scan_partition = spy
    try:
        _, single_s, ls = bench.counted(
            torch, lambda: mumemtom.run_partitioned_files(
                fastas, single, num_partitions=nparts, anchor=True,
                device="cuda"))
    finally:
        mumemtom.scan_partition = real
    if _kr_of(ls) != {"kr_break_mask": nparts, "add_one": 0}:
        raise AssertionError(f"m1: one-process MumemtoM launches {ls}")
    _scanned("m1: one-process MumemtoM", ls)
    split = mumemtom.auto_partition(fastas, nparts, anchor=True)
    order = _order_of(fastas, split)
    torch.cuda.empty_cache()
    worker, filelist, env = _dcn_setup(d, fastas, "m1")
    runs = {}
    for collective in (False, True):
        label = "collective fold" if collective else "host fold"
        prefix = os.path.join(d, "dcn_" + label.split()[0])
        wall, ranks, _sizes = _dcn_run(f"m1 {label}", worker, prefix,
                                       filelist, collective, env, devices,
                                       single, nparts)
        got = _mums_set(prefix + ".mums", n, order)
        diff = want ^ got
        terminal = [r for r in diff if _touches_terminal(r, doc_lens)]
        runs[label] = {"wall_s": wall, "ranks": ranks, "matches": len(got),
                       "only_union": len(want - got),
                       "only_merged": len(got - want),
                       "terminal_touching_differences": len(terminal)}
        log(f"[cards] m1 {label}: {nparts} ranks {wall:.3f} s beside "
            f"{single_s:.3f} s in one process; ranks' s to initialize's "
            f"end {[round(r['start_s'], 3) for r in ranks]}, run s "
            f"{[round(r['run_s'], 3) for r in ranks]} (phase 14 row d2: "
            f"9.20 / 12.53 s a rank on a shared card), peaks "
            f"{_gib([r['peak_alloc_bytes'] for r in ranks])} on "
            f"{[r['device'] for r in ranks]}; {len(got)} MUMs, "
            f"{len(diff)} differ from the union's, {len(terminal)} of them "
            "at document ends")
        if len(terminal) != len(diff):
            raise AssertionError(f"m1 {label}: {len(diff) - len(terminal)} "
                                 "MUMs differ from the union's away from "
                                 "the document ends")
    out["m1"] = {
        "docs": n, "mbp": n * doc_mbp, "partitions": nparts,
        "devices": devices, "partition_docs": [len(p) for p in split],
        "union": {"s": union_s, "peak_alloc_bytes": union_peaks,
                  "matches": len(want), **prep.sizes[0],
                  "terminal_touching": sum(_touches_terminal(r, doc_lens)
                                           for r in want)},
        "single_process": {"s": single_s, "partitions": parts},
        "runs": runs}
    # the dictionary's growth a document, between the largest partition
    # and the union
    big = max((p for r in runs["host fold"]["ranks"]
               for p in r["partitions"]), key=lambda p: p["docs"])
    out["m1"]["d_len_per_doc"] = ((prep.sizes[0]["d_len"] - big["d_len"])
                                  / (n - big["docs"]))
    log(f"[cards] m1: {json.dumps(out['m1'])}")
    return {"rb": rb, "union_bytes": union_bytes, "single": single,
            "parts": [f"{single}_part{i}.mums" for i in range(nparts)],
            "d_len_per_doc": out["m1"]["d_len_per_doc"]}


def _cards_m2(torch, out, work, docs, doc_mbp, devices, per_doc,
              key="m2", rb=None):
    """Row m2 (or `key`), a collection past one card: the union on one
    card (rb, or made from docs), refused by size or by the card's memory
    (_refused; one that runs is printed as a finding, as C40's may since
    the range-min reads past its int32 flat index); then dcn with one rank
    per entry of `devices` on as many anchor
    partitions, host fold. The merged .mums's count, sum of lengths and
    occurrence hash are held against native/baseline_cpu on the union
    later (_cards_baseline). The largest collection this takes is reasoned
    from the partitions' dictionaries, which grow by per_doc (m1's
    measure) a document."""
    from mumemto_tpu_torch import options
    from mumemto_tpu_torch.parallel import mumemtom
    n, nparts = len(docs), len(devices)
    d = os.path.join(work, key)
    os.makedirs(d)
    fastas = bench.write_fastas(docs, d)
    rb = rb or bench.rb_of(docs)
    opts = options.normalize(n, quiet=True)
    refused = _refused(torch, key, f"C{n} union on one card", rb, opts)
    worker, filelist, env = _dcn_setup(d, fastas, key)
    prefix = os.path.join(d, "dcn")
    wall, ranks, _ = _dcn_run(f"{key} host fold", worker, prefix, filelist,
                              False, env, devices, None, nparts)
    split = mumemtom.auto_partition(fastas, nparts, anchor=True)
    got = bench.occ_stats(prefix + ".mums", n, _order_of(fastas, split))
    parts = [p for r in ranks for p in r["partitions"]]
    # the docs a partition may hold with nd <= 2^26 (27 levels), the
    # dictionary growing linearly in its documents
    big = max(parts, key=lambda p: p["d_len"])
    docs_max = big["docs"] + int((2**26 - big["d_len"]) // max(per_doc, 1))
    entry = {"docs": n, "mbp": n * doc_mbp, "devices": devices,
             "refused": refused, "wall_s": wall, "ranks": ranks,
             "merged": got, "d_len_per_doc": per_doc,
             "partition_docs_max": docs_max,
             "collection_docs_max": nparts * (docs_max - 1) + 1}
    log(f"[cards] {key}: {nparts} ranks {wall:.3f} s; partitions (docs, nd, "
        f"levels, nr, peak GiB, s): "
        f"{[(p['docs'], p['nd'], p['dict_levels'], p['nr'], round(p['peak_alloc_bytes'] / 2**30, 2), round(p['s'], 3)) for p in parts]}; "
        f"ranks' s to initialize's end "
        f"{[round(r['start_s'], 3) for r in ranks]}, run s "
        f"{[round(r['run_s'], 3) for r in ranks]}; merged {got}; "
        f"dictionary {per_doc:.0f} a document, so a partition takes "
        f"{docs_max} documents under nd = 2^26 and {nparts} cards "
        f"{entry['collection_docs_max']} genomes of {doc_mbp:g} Mbp")
    out[key] = entry
    return {"rb": rb, "opts": opts, "got": got}


class _CapacitySpy:
    """The per-shard match counts every sharded scan checks against its M
    while active (seqpfp._check_capacity wrapped)."""

    def __init__(self):
        from mumemto_tpu_torch.parallel import seqpfp
        self.mod = seqpfp
        self.counts = []

    def __enter__(self):
        self.real = self.mod._check_capacity

        def check(counts, M, what):
            self.counts.append([int(c) for c in counts])
            return self.real(counts, M, what)
        self.mod._check_capacity = check
        return self

    def __exit__(self, *exc):
        self.mod._check_capacity = self.real


def _runner_probe(torch, cards, launches=4096) -> list:
    """Host-bound work through mesh.run_per_device, the kind a sharded
    scan's stages are at 8 Mbp: on each card `launches` in-place adds to
    a 4096-element tensor, with a readback (a host sync) after every 32 or
    after the last, each card's share on its own thread, beside the same
    work launched from the caller's thread card after card; then the same
    adds on host tensors, one thread each, beside one thread. Walls after
    every card's sync, best of 3."""
    from mumemto_tpu_torch.parallel import mesh
    keys = list(range(len(cards)))
    recs = []
    for where, devs, sync_every in (("cards", cards, 32),
                                    ("cards", cards, launches),
                                    ("host", keys, launches)):
        xs = [torch.zeros(4096, device=d if where == "cards" else "cpu")
              for d in devs]

        def work(i):
            x = xs[i]
            for k in range(launches):
                x.add_(1)
                if k % sync_every == sync_every - 1:
                    float(x[0])

        def timed(fn):
            walls = []
            for _ in range(3):
                bench.sync_all(torch)
                t0 = time.perf_counter()
                fn()
                bench.sync_all(torch)
                walls.append(time.perf_counter() - t0)
            return min(walls)
        recs.append({
            "tensors": where, "threads": len(devs),
            "launches_per_thread": launches, "sync_every": sync_every,
            "threads_s": timed(lambda: mesh.run_per_device(work, keys,
                                                           devs)),
            "one_thread_s": timed(lambda: [work(i) for i in keys])})
        log(f"[cards] s runner probe: {json.dumps(recs[-1])}")
    return recs


def _cards_sharded(torch, out, inputs, shards, tmp, one_card=False,
                   trace_all=False):
    """Row s: the sharded scan over mesh.seq_devices(n, "cuda") for each n
    of `shards` (the first twice) on each input (label, rb, mbp, the
    single-card bytes or None), M a power of two >= 2^16 above the
    single-card count (which bounds every shard's); bytes equal to a
    single-card run in this call; wall, stages, each card's peak, the
    largest shard's count against the CLI's M = 4096; with one_card, each
    n also with every shard on cuda:0 (one thread, shard after shard).
    Then torch.profiler traces of the first n, of the whole call and of
    its shard stages (operands to analyze), on the first input (on every
    input with trace_all): each card's busy time and the time two or more
    cards were busy at once. With one_card, _runner_probe on every card
    first."""
    from mumemto_tpu_torch import engine, options
    from mumemto_tpu_torch.parallel import mesh, seqpfp
    rows, traces = [], []
    trace = None
    probe = _runner_probe(torch, list(dict.fromkeys(mesh.spread(
        max(torch.cuda.device_count(), 1), "cuda")))) if one_card else None
    for label, rb, mbp, want in inputs:
        opts = options.normalize(rb.num_docs, quiet=True)
        _reset_peaks(torch)
        timer = _AllCardsTimer(torch)
        res, s, lc = bench.counted(torch, lambda: engine.find_matches(
            rb, opts, device="cuda", phase=timer))
        if want is not None and res.output_bytes() != want:
            raise AssertionError(f"s {label}: single-card bytes differ "
                                 "between two runs")
        want, matches = res.output_bytes(), res.num_matches
        del res
        M = _pow2_at_least(matches, 1 << 16)
        single = {"input": label, "mbp": mbp, "shards": 1, "wall_s": s,
                  "stages_s": timer.stages,
                  "peak_alloc_bytes": timer.peaks(),
                  "matches": matches, "launches": lc}
        rows.append(single)
        log(f"[cards] s {label}: one card {s:.3f} s, peaks "
            f"{_gib(single['peak_alloc_bytes'])}, {matches} matches; M = {M}")

        def sharded(devs, timer):
            return seqpfp.find_matches_seq_sharded(rb, opts, devs, M=M,
                                                   phase=timer)
        runs = [(n, "cuda") for n in (shards[0], *shards)]
        if one_card:
            runs += [(n, "cuda:0") for n in shards]
        for n, where in runs:
            devs = mesh.seq_devices(n, where)
            _reset_peaks(torch)
            timer = _AllCardsTimer(torch)
            with _CapacitySpy() as cap:
                res, s, lc = bench.counted(torch, lambda: sharded(devs, timer))
            same = res.output_bytes() == want
            del res
            worst = max(cap.counts[0])
            rec = {"input": label, "mbp": mbp, "shards": n,
                   "devices": [str(x) for x in devs], "M": M, "wall_s": s,
                   "single_wall_s": single["wall_s"],
                   "stages_s": timer.stages,
                   "peak_alloc_bytes": timer.peaks(),
                   "stage_peak_alloc_bytes": timer.stage_peaks,
                   "shard_matches": cap.counts[0],
                   "cli_M_4096_refuses": worst > 4096, "launches": lc,
                   "bytes_equal": same}
            rows.append(rec)
            log(f"[cards] s {label}: {n} shards on {len(set(devs))} "
                f"card(s) {s:.3f} s beside {single['wall_s']:.3f} s, "
                f"peaks {_gib(rec['peak_alloc_bytes'])} beside "
                f"{_gib(single['peak_alloc_bytes'])}, shard matches "
                f"{cap.counts[0]} (M = 4096 refuses: {worst > 4096}); "
                + ", ".join(f"{k} {v:.3f}" for k, v in timer.stages.items()))
            if not same or _kr_of(lc) != {"kr_break_mask": 1, "add_one": 0}:
                raise AssertionError(f"s {label}, {n} shards: bytes equal "
                                     f"{same}, launches {lc}")
            _scanned(f"s {label}, {n} shards", lc)
        if trace is None or trace_all:
            n = shards[0]
            devs = mesh.seq_devices(n, "cuda")
            for stages in (None, ("parse_side", "analyze")):
                t0 = time.perf_counter()
                res, spans = bench.trace_cards(
                    torch, lambda phase: sharded(devs, phase), tmp, stages)
                rec = {"input": label, "shards": n,
                       "window": "shard stages" if stages else "whole call",
                       "wall_s": time.perf_counter() - t0,
                       "bytes_equal": res.output_bytes() == want,
                       "device_spans": len(spans), **bench.busy_overlap(spans)}
                del res
                traces.append(rec)
                log(f"[cards] s trace: {json.dumps(rec)}")
                if not rec["bytes_equal"]:
                    raise AssertionError("s: the traced run's bytes differ")
            trace = traces[0]
    out["s"] = {"runs": rows, "trace": trace, "traces": traces,
                "runner_probe": probe}


def _cards_collective(torch, out, m1):
    """Row c: merge --collective on m1's one-process partitions (one
    partition a card by mesh.spread) against the host anchor merge of the
    same files and m1's merged files; the fold's wall on the cards and
    its device time on the first."""
    from mumemto_tpu_torch import cli
    from mumemto_tpu_torch.analysis import merge as merge_mod
    from mumemto_tpu_torch.parallel import collective_merge
    parts = m1["parts"]
    base = os.path.dirname(m1["single"])
    host = os.path.join(base, "c_host")
    rc_h, host_s, _ = bench.counted(torch, lambda: cli.main(
        ["merge", *parts, "-o", host]))
    seen = []
    real = collective_merge.collective_fold

    def fold(bv, nb, ln, devices):
        bench.sync_all(torch)
        t0 = time.perf_counter()
        got = real(bv, nb, ln, devices)
        bench.sync_all(torch)
        seen.append({"devices": [str(d) for d in devices],
                     "n_anchor": int(bv.shape[1]),
                     "s": time.perf_counter() - t0})
        return got
    coll = os.path.join(base, "c_collective")
    collective_merge.collective_fold = fold
    try:
        rc, s, lm = bench.counted(torch, lambda: cli.main(
            ["merge", *parts, "-o", coll, "--collective", "--device",
             "cuda"]))
    finally:
        collective_merge.collective_fold = real
    for ext in (".mums", ".athresh", ".lengths"):
        with open(coll + ext, "rb") as a, open(host + ext, "rb") as b, \
                open(m1["single"] + ext, "rb") as c:
            ga, gb, gc = a.read(), b.read(), c.read()
        if rc or rc_h or ga != gb or gb != gc or not ga or \
                any(_kr_of(lm).values()):
            raise AssertionError(f"c: {ext} of merge --collective != the "
                                 f"host merge's (rc {rc}, {rc_h}; {lm})")
    _scanned("c: merge --collective", lm)
    cands = [merge_mod.parse_candidate(p) for p in parts]
    dense = collective_merge._dense_arrays(cands, seen[0]["n_anchor"])
    dev0 = torch.device(seen[0]["devices"][0])
    placed = [torch.from_numpy(a).to(dev0) for a in dense]
    entry = {"rc": rc, "s": s, "host_merge_s": host_s, "fold": seen[0],
             "fold_ms": _event_ms(torch, lambda: collective_merge._fold_all(
                 *placed), 20, dev0),
             "partitions": len(parts)}
    log(f"[cards] c: merge --collective {s:.3f} s (host merge {host_s:.3f} "
        f"s; phase 11 0.092 s at n_anchor 10^6, phase 14 row d's merge "
        f"2.074 s), fold {seen[0]['s']:.4f} s over {seen[0]['devices']} at "
        f"n_anchor {seen[0]['n_anchor']}, {entry['fold_ms']:.3f} ms of it "
        "on the first card; files equal")
    out["c"] = entry


def _windows_bytes(rb, opts, num_docs, m, ps, pe, pL, w_sa, w_da):
    """A partition's compacted windows (m rows) through the writer's
    emitter: the .mums bytes."""
    import numpy as np
    from mumemto_tpu_torch import engine
    results = engine.MatchResults(opts=opts, num_docs=num_docs)
    doc_offsets, doc_lens = engine._doc_metadata(rb, opts)
    valid = (ps[:m, None] + np.arange(num_docs)) < pe[:m, None]
    engine._emit_mums(results, ps[:m], pe[:m], pL[:m], w_sa[:m],
                      w_da[:m].astype(np.int32), valid, opts, doc_offsets,
                      doc_lens, num_docs)
    return results.output_bytes()


def _cards_partition(torch, out, doc_mbp, nparts=4, num_docs=2,
                     runs=1):
    """Row p: parallel/partition's match program on make_mesh(4) (a (2, 2)
    ('part', 'seq') mesh on four cards) over nparts partitions of num_docs
    bench documents of doc_mbp Mbp, `runs` times; M from the direct
    backend's counts on one card; each partition's windows through the
    writer must equal the direct backend's bytes; which card each
    partition ran on (mesh.part_device), the cards and the host threads
    the scans saw, every card's peak."""
    import threading
    import numpy as np
    from mumemto_tpu_torch import engine, options
    from mumemto_tpu_torch.ops import suffix as ops_suffix
    from mumemto_tpu_torch.parallel import partition
    rbs = [_bench_rb(num_docs * doc_mbp, seed=seed, n_docs=num_docs)
           for seed in range(nparts)]
    n = ops_suffix.bucket(max(int(rb.text.size) for rb in rbs) + 4, lo=4096)
    texts = np.zeros((nparts, n), np.uint8)
    doc_ends = np.zeros((nparts, num_docs), np.int32)
    for p, rb in enumerate(rbs):
        texts[p, :rb.text.size] = rb.text
        doc_ends[p] = rb.doc_ends
    opts = options.normalize(num_docs, quiet=True)
    wants = [engine.find_matches(rb, opts, backend="direct", device="cuda")
             for rb in rbs]
    # the program keeps a MUM's window once a strand; the emitter keeps one
    M = _pow2_at_least(2 * max(w.num_matches for w in wants), 1 << 10)
    mesh = partition.make_mesh(4)
    ran_on = [str(mesh.part_device(p)) for p in range(nparts)]
    seen = []
    real = partition._partition_scan_matches

    def scan(text, *a):
        seen.append((str(text.device), threading.current_thread()))
        return real(text, *a)
    fn = partition.compile_partitioned_matches(mesh, num_docs, M=M)
    walls, peaks = [], []
    partition._partition_scan_matches = scan
    try:
        for _ in range(runs):
            seen.clear()
            _reset_peaks(torch)
            got, s, launches = bench.counted(torch,
                                             lambda: fn(texts, doc_ends))
            walls.append(s)
            peaks.append(_card_peaks(torch))
            if any(_kr_of(launches).values()):
                raise AssertionError(f"p: the partition program launched "
                                     f"{launches}")
    finally:
        partition._partition_scan_matches = real
    threads = {}
    for dev, ident in seen:
        threads.setdefault(ident, set()).add(dev)
    if sorted(d for d, _ in seen) != sorted(ran_on) or \
            len(threads) != len(set(ran_on)) or \
            any(len(v) != 1 for v in threads.values()):
        raise AssertionError(f"p: partitions ran on {seen}, placed on "
                             f"{ran_on}")
    counts, ps, pe, pL, w_sa, w_da = (x.cpu().numpy() for x in got)
    for p, (rb, want) in enumerate(zip(rbs, wants)):
        if _windows_bytes(rb, opts, num_docs, int(counts[p]), ps[p], pe[p],
                          pL[p], w_sa[p], w_da[p]) != want.output_bytes() \
                or not want.num_matches:
            raise AssertionError(f"p: partition {p}'s bytes != the direct "
                                 "backend's")
    entry = {"mesh_shape": list(mesh.shape),
             "mesh_devices": [str(d) for d in mesh.devices],
             "partitions": nparts, "docs": num_docs, "n": n, "M": M,
             "ran_on": ran_on, "threads": len(threads),
             "counts": counts.tolist(), "s": walls[0], "walls_s": walls,
             "peak_alloc_bytes": peaks[0], "run_peaks": peaks}
    log(f"[cards] p: {json.dumps(entry)}")
    out["p"] = entry


def _cards_shard_dict(torch, out, mbps):
    """The 8-shard scan spread over every visible card (two a card on
    four), the dictionary index on one device and sharded, in the order
    off, on, on, off, at each of `mbps` (MUM 8 and 32 Mbp: nr = 2^24 and
    2^26): wall, stages and each card's peak, over the run and within
    each stage (dict_index above all); bytes equal to a single-device
    run's."""
    from mumemto_tpu_torch import engine, options
    from mumemto_tpu_torch.parallel import mesh, seqpfp
    expect = {8: EXPECT_8MBP, 32: EXPECT_32MBP}
    opts = options.normalize(N_DOCS, quiet=True)
    nshards = 8
    devices = mesh.seq_devices(nshards, "cuda")
    runs = []
    for mbp in mbps:
        rb = _bench_rb(mbp)
        engine.find_matches(rb, opts, device="cuda")        # warm-up
        _reset_peaks(torch)
        t0 = time.perf_counter()
        single = engine.find_matches(rb, opts, device="cuda")
        bench.sync_all(torch)
        entry = {"mbp": mbp, "shards": 1, "shard_dict": False,
                 "wall_s": time.perf_counter() - t0,
                 "peak_alloc_bytes": _card_peaks(torch)}
        runs.append(entry)
        log(f"[cards] {json.dumps(entry)}")
        want = single.output_bytes()
        if single.num_matches != expect.get(mbp, single.num_matches):
            raise AssertionError(f"{mbp} Mbp: {single.num_matches} matches")
        del single
        for shard_dict in (False, True):                    # warm-up
            seqpfp.find_matches_seq_sharded(rb, opts, devices, M=8192,
                                            shard_dict=shard_dict)
        for shard_dict in (False, True, True, False):
            _reset_peaks(torch)
            timer = _AllCardsTimer(torch)
            t0 = time.perf_counter()
            res = seqpfp.find_matches_seq_sharded(
                rb, opts, devices, M=8192, phase=timer,
                shard_dict=shard_dict)
            bench.sync_all(torch)
            entry = {"mbp": mbp, "shards": nshards,
                     "devices": [str(d) for d in devices],
                     "shard_dict": shard_dict,
                     "wall_s": time.perf_counter() - t0,
                     "stages_s": timer.stages,
                     "stage_peak_alloc_bytes": timer.stage_peaks,
                     "peak_alloc_bytes": timer.peaks(),
                     "matches": res.num_matches}
            runs.append(entry)
            log(f"[cards] {json.dumps(entry)}")
            if res.output_bytes() != want:
                raise AssertionError(f"{mbp} Mbp, shard_dict={shard_dict}: "
                                     "bytes != the single-device run's")
            del res
    out["shard_dict"] = runs


def _cards_baseline(out, m2):
    """m2's merged .mums against one native/baseline_cpu run on the union
    text (the bytes bench.run_cpu_baseline writes): match count, sum of
    lengths and occurrence hash must agree."""
    t0 = time.perf_counter()
    base = bench.cpu_baseline(m2["rb"].text, m2["rb"].seq_lengths, m2["opts"])
    wall = time.perf_counter() - t0
    want = bench.triple(base)
    out["m2"]["baseline"] = {**base, "wall_s": wall}
    log(f"[cards] m2: baseline_cpu on the union {want} in {wall:.1f} s; "
        f"merged {m2['got']}")
    if m2["got"] != want or not want["matches"]:
        raise AssertionError(f"m2: merged {m2['got']} != baseline_cpu {want}")


def phase_cards(torch, report, doc_mbp=5.0, card_docs=CARD_DOCS,
                ranks=RANKS, bench_mbp=96, shards=(4, 8), part_doc_mbp=4.0,
                shard_dict_mbp=(8, 32), kr_mbp=KR_MBP, dcn_device=None):
    """The rows of `--cards` (cards_main), in order: k, m1, m2, s, c, p,
    the shard_dict runs, and m2's baseline last. Collections:
    bench.synth_collection(doc_mbp * N, N, seed=0) for N in card_docs (C20 and
    C40); rank r of m1 and m2 on cuda:{r % cards} (dcn_device: every rank
    there instead). Every comparison raises on a difference."""
    from mumemto_tpu_torch import engine
    t0 = time.perf_counter()
    ncards = torch.cuda.device_count()
    cards = [engine.resolve(f"cuda:{i}") for i in range(ncards)]
    devices = [dcn_device or f"cuda:{r % ncards}" for r in range(ranks)]
    n20, n40 = card_docs
    c20 = bench.synth_collection(n20 * doc_mbp, n20, seed=0)
    c40 = bench.synth_collection(n40 * doc_mbp, n40, seed=0)
    out = report.setdefault("rows", {})
    with tempfile.TemporaryDirectory() as work:
        _cards_kr(torch, out, cards, c40, ranks, kr_mbp)
        m1 = _cards_m1(torch, out, work, c20, doc_mbp, devices)
        m2 = _cards_m2(torch, out, work, c40, doc_mbp, devices,
                       m1["d_len_per_doc"])
        del c20, c40
        torch.cuda.empty_cache()
        _cards_sharded(torch, out, [
            (f"C{n20}", m1["rb"], n20 * doc_mbp, m1["union_bytes"]),
            (f"bench {bench_mbp:g} Mbp", _bench_rb(bench_mbp), bench_mbp,
             None)], shards, work)
        _cards_collective(torch, out, m1)
        torch.cuda.empty_cache()
        _cards_partition(torch, out, part_doc_mbp)
        _cards_shard_dict(torch, out, shard_dict_mbp)
        _cards_baseline(out, m2)
    report["cards_s"] = time.perf_counter() - t0
    log(f"[cards] the rows took {report['cards_s']:.1f} s")


# the named rows of `--cards`: the sharded scan at the row space it was
# built for. 215 isolates of one bacterial species (the size of M.
# tuberculosis H37Rv, 4.41 Mbp) at lineage-level divergence (0.01% SNPs):
# 948.15 Mbp, ~1.9 G rows with revcomp, a 2^31-row bucket, a dictionary
# under 2^26 characters, and within native/baseline_cpu's int32 text
WIDE_DOCS = 215
WIDE_DOC_MBP = 4.41
WIDE_SNP = 1e-4
WIDE_SHARDS = 16         # B = 2^27 rows a shard at nr = 2^31
WIDE_M = 1 << 14         # the per-shard window capacity the library gets
REHEARSAL_MBP = 118.5    # row wr: 1/8 of the collection, nr 2^28
W2_PARTS = 8             # row w2: anchor partitions over the dcn ranks
M3_DOCS = 113            # row m3: genomes of 5 Mbp at 0.1% SNPs
M3_PER_DOC = 1928119     # the dictionary's growth a genome at 0.1% (m1)
# native/baseline_cpu on row w's collection: count, sum of lengths and
# occurrence hash from `--cards wbase` (599.4 s on the host of a machine
# with an NVIDIA H100 80GB HBM3, PERF.md); a live wbase in the same call
# replaces it (the harness's configuration w holds the same triple)
W_BASELINE = dict(zip(("matches", "sum_len", "occ_hash"),
                      bench.CONFIGS["w"].expected_triple))
CARD_ROWS = ("s", "p", "wr", "wbase", "kw", "w", "f1", "w2", "m3")
S_MBP = (8, 32)      # row s: the bench collection, 8 shards over the cards
S_SHARDS = (8,)
P_DOC_MBP = 4.0      # row p: 4 partitions of 2 bench documents
P_RUNS = 3


def _free_gib() -> str:
    """The host's memory as `free -g` prints it."""
    out = subprocess.run(["free", "-g"], capture_output=True, text=True,
                         timeout=60)
    return out.stdout.strip()


def _wide_docs(total_mbp: float, n_docs: int = WIDE_DOCS):
    return bench.synth_collection(total_mbp, n_docs, seed=0, snp_rate=WIDE_SNP)


def _empty_caches(torch):
    """Garbage collected, then every card's cached blocks handed back."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def _wide_kr(torch, text, cards, w: int = 10, mod: int = 100) -> dict:
    """The KR kernel on the collection's whole ext, once on cards[0], its
    mask and count against break_mask_plain in 8 chunks on the other cards
    (cards[0] when alone): the chunk at ext offset o > 0 carries the w
    bytes before it, so from its local position w on its plain mask is the
    kernel's from o on, with n_real - o + w as the end of its real text.
    CUDA-event times: the kernel's on the whole ext beside its byte bound,
    the plain version's summed over the chunks."""
    from mumemto_tpu_torch.kernels import kr_mask
    n_real = int(text.size)
    ext = torch.from_numpy(_ext_of(text, w)).to(cards[0])
    ne = int(ext.numel())
    (m_k, c_k), _s, launches = bench.counted(
        torch, lambda: kr_mask.break_mask(ext, n_real, w, mod))
    launched = launches["kr_break_mask"]
    others = cards[1:] or cards[:1]
    chunk = ne // 8
    mism = total = 0
    plain_ms = 0.0
    for i, o in enumerate(range(0, ne, chunk)):
        dev = others[i % len(others)]
        lo = max(o - w, 0)
        piece = ext[lo:o + chunk].to(dev)
        m_p, _ = kr_mask.break_mask_plain(piece, n_real - lo, w, mod)
        got = m_k[o:o + chunk].to(dev)
        mism += int((m_p[o - lo:] != got).sum())
        total += int(m_p[o - lo:].sum())
        del m_p, got
        plain_ms += _event_ms(torch, lambda: kr_mask.break_mask_plain(
            piece, n_real - lo, w, mod), 1, dev)
        del piece
    rec = {"card": str(cards[0]), "ne": ne, "n_real": n_real,
           "breaks": int(c_k), "launches": launched,
           "mismatches": mism + abs(total - int(c_k)),
           "chunks": ne // chunk,
           "chunk_cards": sorted({str(d) for d in others}),
           "ms": min(_event_ms(torch, lambda: kr_mask.break_mask(
               ext, n_real, w, mod), 20, cards[0]) for _ in range(2)),
           "plain_ms_chunked": plain_ms,
           "bound_ms": 2 * ne / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    del m_k, ext
    log(f"[wide] KR: {json.dumps(rec)}")
    if rec["mismatches"] or launched != 1:
        raise AssertionError(f"KR kernel on the whole ext: {rec}")
    return rec


def _wide_scan(torch, label, rb, opts, nshards, M, cards):
    """find_matches_seq_sharded with shard r on cards[r % len(cards)]:
    wall, stages (emit split from assemble), each card's peak over the
    run and within each stage, sizes, the per-shard counts, KR launches.
    Out of device memory, the shard count doubles; on a window capacity
    refusal the scan reruns with the M it names. Returns (record, the
    MatchResults)."""
    import re
    from mumemto_tpu_torch import cli, engine
    from mumemto_tpu_torch.parallel import seqpfp
    from mumemto_tpu_torch.parallel.partition import WindowCapacityError
    tries = []
    while True:
        devs = [cards[r % len(cards)] for r in range(nshards)]
        _reset_peaks(torch)
        timer = _AllCardsTimer(torch)
        split = bench.Split(torch, {"emit": (engine, "_emit_mums")}, timer)
        err = None
        with _PrepSpy() as spy, _CapacitySpy() as cap, split:
            try:
                res, s, lc = bench.counted(torch, lambda: (
                    seqpfp.find_matches_seq_sharded(rb, opts, devs, M=M,
                                                    phase=timer)))
            except WindowCapacityError as e:
                err = str(e)
            except Exception as e:
                if not cli._is_device_oom(e):
                    raise
                err = f"device OOM: {str(e)[:300]}"
        if err is None:
            break
        tries.append({"shards": nshards, "M": M, "error": err,
                      "peak_alloc_bytes": _card_peaks(torch)})
        log(f"[wide] {label}: {nshards} shards, M {M}: {err[:300]}")
        _empty_caches(torch)
        need = re.search(r"rerun with M >= (\d+)", err)
        if need:
            M = _pow2_at_least(int(need[1]), M)
        elif nshards >= 64:
            raise AssertionError(f"{label}: out of memory at {nshards} "
                                 "shards")
        else:
            nshards *= 2
    rec = {"label": label, "shards": nshards, "M": M,
           "devices": [str(d) for d in devs], "wall_s": s,
           "stages_s": {**timer.stages, "emit (in assemble)": split.s["emit"]},
           "peak_alloc_bytes": timer.peaks(),
           "stage_peak_alloc_bytes": timer.stage_peaks,
           "shard_matches": cap.counts[0],
           "cli_M_4096_refuses": max(cap.counts[0]) > 4096,
           "launches": lc, "matches": res.num_matches, "retries": tries,
           **spy.sizes[0], **_flat_sizes(spy)}
    log(f"[wide] {label}: {nshards} shards on {len(set(devs))} card(s), "
        f"{s:.3f} s, peaks {_gib(rec['peak_alloc_bytes'])}, "
        f"{res.num_matches} matches, rows {rec['rows']} (nr {rec['nr']}), "
        f"nd {rec['nd']} x {rec['dict_levels']} levels "
        f"({rec['dict_flat_share']:.1%} of 2^31); "
        + ", ".join(f"{k} {v:.3f}" for k, v in rec["stages_s"].items()))
    if _kr_of(lc) != {"kr_break_mask": 1, "add_one": 0}:
        raise AssertionError(f"{label}: kernel launches {lc}")
    _scanned(label, lc)
    return rec, res


def _written_triple(torch, rec, res, rb, prefix):
    """Writes res (timed into rec["write_s"]) and returns the .mums
    file's count, sum of lengths and occurrence hash."""
    from mumemto_tpu_torch import engine
    t0 = time.perf_counter()
    engine.write_outputs(res, rb, prefix)
    rec["write_s"] = time.perf_counter() - t0
    rec["triple"] = bench.occ_stats(prefix + ".mums", rb.num_docs)
    return rec["triple"]


def _wide_rehearsal(torch, out, work, cards, mbp, n_docs, nshards, M):
    """Row wr: the sharded scan of row w on one card at 1/8 of its size
    (n_docs documents, mbp Mbp), every shard on cards[0]: bytes equal to
    the single-device engine's in this call, count, sum and hash equal to
    a live baseline_cpu run, the KR check of row w on this ext."""
    from mumemto_tpu_torch import engine, options
    docs = _wide_docs(mbp, n_docs)
    rb = bench.rb_of(docs)
    opts = options.normalize(rb.num_docs, quiet=True)
    base = bench.Baseline(rb.text, rb.seq_lengths, opts)
    try:
        _reset_peaks(torch)
        timer = _AllCardsTimer(torch)
        single, s1, l1 = bench.counted(torch, lambda: engine.find_matches(
            rb, opts, device=cards[0], phase=timer))
        one = {"wall_s": s1, "stages_s": timer.stages,
               "peak_alloc_bytes": timer.peaks(), "launches": l1,
               "matches": single.num_matches}
        want = single.output_bytes()
        del single
        _empty_caches(torch)
        rec, res = _wide_scan(torch, f"wr {mbp:g} Mbp", rb, opts, nshards,
                              M, cards[:1])
        rec["bytes_equal_single"] = res.output_bytes() == want
        rec["single"] = one
        got = _written_triple(torch, rec, res, rb,
                              os.path.join(work, "wr"))
        del res
        _empty_caches(torch)
        rec["kr"] = _wide_kr(torch, rb.text, cards[:1])
        rec["baseline"] = base.result()
    finally:
        base.close()
    rec["mbp"] = mbp
    out["wr"] = rec
    log(f"[wide] wr: one card {s1:.3f} s ({one['matches']} matches, peak "
        f"{_gib(one['peak_alloc_bytes'])}); triple {got}, baseline_cpu "
        f"{bench.triple(rec['baseline'])} in "
        f"{rec['baseline']['wall_s']:.1f} s")
    if not rec["bytes_equal_single"] or got != bench.triple(rec["baseline"]) \
            or not got["matches"]:
        raise AssertionError(f"wr: bytes equal {rec['bytes_equal_single']}, "
                             f"{got} != baseline_cpu {rec['baseline']}")


def _wide_trace(torch, rb, opts, rec, mums, tmp) -> dict:
    """Row w's scan once more (the shards and M of `rec`) under
    torch.profiler, from the end of parse_side to the end of analyze (the
    shard stages): each card's busy time and the time k or more cards were
    busy at once. Its bytes must equal `mums`; a trace that cannot be
    taken is recorded, not raised."""
    from mumemto_tpu_torch.parallel import seqpfp
    devs = [torch.device(d) for d in rec["devices"]]
    t0 = time.perf_counter()
    try:
        res, spans = bench.trace_cards(
            torch, lambda phase: seqpfp.find_matches_seq_sharded(
                rb, opts, devs, M=rec["M"], phase=phase),
            tmp, ("parse_side", "analyze"))
    except Exception as e:  # the row's numbers stand without the trace
        trace = {"error": f"{type(e).__name__}: {str(e)[:500]}"}
        log(f"[wide] w trace: {json.dumps(trace)}")
        return trace
    with open(mums, "rb") as f:
        same = res.output_bytes() == f.read()
    del res
    trace = {"window": "shard stages", "wall_s": time.perf_counter() - t0,
             "bytes_equal": same, "device_spans": len(spans),
             **bench.busy_overlap(spans)}
    log(f"[wide] w trace: {json.dumps(trace)}")
    if not same:
        raise AssertionError("w: the traced scan's bytes differ")
    return trace


def _wide_row(torch, out, work, rb, fastas, cards, nshards, M):
    """Row w: the KR kernel on the whole ext (_wide_kr), then
    find_matches_seq_sharded over every card (_wide_scan), its .mums
    written; then the CLI with --seq-shards on the FASTAs, whose .mums
    must equal the library's, or which must refuse with the per-shard
    M = 4096 in the JAX package's words (which one is recorded). Returns
    the library's triple for the baseline check."""
    import re
    from mumemto_tpu_torch import cli, options
    from mumemto_tpu_torch.parallel.partition import WindowCapacityError
    opts = options.normalize(rb.num_docs, quiet=True)
    kr = _wide_kr(torch, rb.text, cards)
    _empty_caches(torch)
    rec, res = _wide_scan(torch, "w", rb, opts, nshards, M, cards)
    rec["kr"] = kr
    lib = os.path.join(work, "w_lib")
    got = _written_triple(torch, rec, res, rb, lib)
    del res
    _empty_caches(torch)
    rec["trace"] = _wide_trace(torch, rb, opts, rec, lib + ".mums", work)
    _empty_caches(torch)
    prefix = os.path.join(work, "w_cli")
    argv = fastas + ["-o", prefix, "--seq-shards", str(rec["shards"])]
    t0 = time.perf_counter()
    try:
        rc = cli.main(argv)
        refused = None
    except WindowCapacityError as e:
        rc, refused = None, str(e)
    bench.sync_all(torch)
    route = {"argv_tail": argv[-4:], "s": time.perf_counter() - t0,
             "rc": rc, "refused": refused}
    if refused is None:
        with open(prefix + ".mums", "rb") as a, open(lib + ".mums", "rb") as b:
            route["mums_equal_library"] = a.read() == b.read()
        if rc != 0 or not route["mums_equal_library"]:
            raise AssertionError(f"w: the CLI route {route}")
    elif not re.fullmatch(r"seq-sharded scan: \d+ matches exceed the window "
                          r"capacity M=4096; rerun with M >= \d+", refused):
        raise AssertionError(f"w: the CLI refused with {refused!r}")
    rec["cli"] = route
    log(f"[wide] w: CLI --seq-shards {rec['shards']}: {json.dumps(route)}")
    out["w"] = rec
    return got


class _Attempts:
    """Every union or partition scan (engine.find_matches) and every
    MumemtoM round (mumemtom.run_partitioned_files) while active: what
    ran, seconds, cards[0]'s peak and how it ended."""

    def __init__(self, torch, card):
        from mumemto_tpu_torch import engine
        from mumemto_tpu_torch.parallel import mumemtom
        self.torch, self.card, self.log = torch, card, []
        self.targets = {"scan": (engine, "find_matches"),
                        "partitions": (mumemtom, "run_partitioned_files")}

    def __enter__(self):
        self.real = {n: getattr(m, a) for n, (m, a) in self.targets.items()}
        for name, (mod, attr) in self.targets.items():
            setattr(mod, attr, self._wrap(name, self.real[name]))
        return self

    def _wrap(self, name, real):
        torch = self.torch

        def run(*a, **kw):
            rb_or_files = a[0]
            what = (f"{kw.get('num_partitions', 2)} partitions"
                    if name == "partitions"
                    else f"scan of {rb_or_files.num_docs} docs")
            bench.sync_all(torch)
            torch.cuda.reset_peak_memory_stats(self.card)
            t0 = time.perf_counter()
            end = "ok"
            try:
                return real(*a, **kw)
            except Exception as e:
                end = f"{type(e).__name__}: {str(e)[:300]}"
                raise
            finally:
                bench.sync_all(torch)
                self.log.append({
                    "what": what, "s": time.perf_counter() - t0,
                    "peak_alloc_bytes":
                        torch.cuda.max_memory_allocated(self.card),
                    "end": end})
        return run

    def __exit__(self, *exc):
        for name, (mod, attr) in self.targets.items():
            setattr(mod, attr, self.real[name])


def _cli_one_card(torch, out, work, fastas, card):
    """Row f1: the default CLI (no --seq-shards) on the FASTAs on one
    card: the union scan, then the partition fallback. Every attempt
    recorded; either the fallback's merged .mums (its triple, in document
    order) or a clean non-zero exit. Returns the triple, or None."""
    from mumemto_tpu_torch import cli
    from mumemto_tpu_torch.parallel import mumemtom
    prefix = os.path.join(work, "f1")
    with _PrepSpy() as spy, _Attempts(torch, card) as att:
        rc, s, lc = bench.counted(torch,
                                  lambda: cli.main(fastas + ["-o", prefix]))
    rec = {"rc": rc, "wall_s": s, "launches": lc, "attempts": att.log,
           "sizes": spy.sizes}
    rounds = [a for a in att.log if a["what"].endswith("partitions")]
    got = None
    if rc == 0 and rounds:
        nparts = int(rounds[-1]["what"].split()[0])
        order = _order_of(fastas, mumemtom.auto_partition(
            fastas, nparts, anchor=True))
        got = rec["triple"] = bench.occ_stats(prefix + ".mums", len(fastas),
                                              order)
    log(f"[wide] f1: exit {rc} in {s:.1f} s; attempts "
        + "; ".join(f"{a['what']} {a['s']:.1f} s peak "
                    f"{a['peak_alloc_bytes'] / 2**30:.2f} GiB: "
                    f"{a['end'][:160]}" for a in att.log))
    out["f1"] = rec
    if rc == 0 and got is None:
        raise AssertionError("f1: the union scan on one card ran to its end")
    if lc["kr_break_mask"] != len(att.log) - len(rounds) or lc["add_one"]:
        raise AssertionError(f"f1: launches {lc} for {att.log}")
    return got


def _wide_dcn(torch, out, work, fastas, devices, nparts):
    """Row w2: MumemtoM of nparts anchor partitions as one dcn rank per
    entry of `devices` (partitions r, r + P, ... on rank r), host fold;
    returns the merged .mums's triple in document order."""
    from mumemto_tpu_torch.parallel import mumemtom
    worker, filelist, env = _dcn_setup(work, fastas, "w2")
    prefix = os.path.join(work, "w2")
    wall, ranks, _ = _dcn_run("w2", worker, prefix, filelist, False, env,
                              devices, None, nparts)
    split = mumemtom.auto_partition(fastas, nparts, anchor=True)
    got = bench.occ_stats(prefix + ".mums", len(fastas),
                          _order_of(fastas, split))
    out["w2"] = {"wall_s": wall, "ranks": ranks, "devices": devices,
                 "partition_docs": [len(p) for p in split], "triple": got}
    log(f"[wide] w2: {len(devices)} ranks, {nparts} partitions, {wall:.3f} "
        f"s; partitions (docs, nd, nr, peak GiB, s): "
        f"{[(p['docs'], p['nd'], p['nr'], round(p['peak_alloc_bytes'] / 2**30, 2), round(p['s'], 3)) for r in ranks for p in r['partitions']]}; "
        f"merged {got}")
    return got


def phase_wide(torch, report, rows, doc_mbp=WIDE_DOC_MBP, n_docs=WIDE_DOCS,
               rehearsal_mbp=REHEARSAL_MBP, nshards=WIDE_SHARDS, M=WIDE_M,
               baseline=W_BASELINE, w2_parts=W2_PARTS, ranks=RANKS,
               m3_docs=M3_DOCS, m3_doc_mbp=5.0, dcn_device=None,
               s_mbp=S_MBP, s_shards=S_SHARDS, p_doc_mbp=P_DOC_MBP,
               p_runs=P_RUNS):
    """The named rows of `--cards` (cards_main), in this order whatever
    the order given: s (_cards_sharded: the bench collection at each of
    s_mbp, shards over every card and on cuda:0 alone, each input traced)
    and p (_cards_partition on make_mesh(4), p_runs times), then wr, then
    on row w's collection (n_docs genomes of
    doc_mbp Mbp at 0.01% SNPs, written as FASTAs) kw (row w's KR check
    alone), w, f1 and w2, whose triples (count, sum of lengths,
    occurrence hash) must equal native/baseline_cpu's: the live run of
    wbase, started before the rows and read after them (also when a row
    fails, so its triple is printed), or `baseline`; then m3 (m3_docs
    genomes at 0.1% SNPs as dcn ranks, with the one-card refusal, as row
    m2), whose live baseline starts before every other row. Rank r of w2
    and m3 on cuda:{r % cards} (dcn_device: all there)."""
    from mumemto_tpu_torch import engine, options
    rows = set(rows)
    if {"w", "f1", "w2"} & rows and baseline is None and "wbase" not in rows:
        raise AssertionError(f"rows {sorted(rows)} need baseline_cpu's "
                             "triple: add wbase, or set W_BASELINE from a "
                             "wbase run")
    t0 = time.perf_counter()
    ncards = torch.cuda.device_count()
    cards = [engine.resolve(f"cuda:{i}") for i in range(ncards)]
    devices = [dcn_device or f"cuda:{r % ncards}" for r in range(ranks)]
    out = report.setdefault("rows", {})
    report["host_memory_before"] = _free_gib()
    log(f"[wide] host memory before the rows:\n{report['host_memory_before']}")
    triples = {}
    with tempfile.TemporaryDirectory() as work, \
            contextlib.ExitStack() as running:
        if "s" in rows:
            _cards_sharded(torch, out, [
                (f"bench {mbp:g} Mbp", _bench_rb(mbp), mbp, None)
                for mbp in s_mbp], s_shards, work, one_card=True,
                trace_all=True)
            _empty_caches(torch)
        if "p" in rows:
            _cards_partition(torch, out, p_doc_mbp, runs=p_runs)
            _empty_caches(torch)
        if "m3" in rows:
            m3_coll = bench.synth_collection(m3_docs * m3_doc_mbp, m3_docs,
                                             seed=0)
            m3_rb = bench.rb_of(m3_coll)
            m3_base = bench.Baseline(m3_rb.text, m3_rb.seq_lengths,
                                     options.normalize(m3_docs, quiet=True))
            running.callback(m3_base.close)
        if "wr" in rows:
            _wide_rehearsal(torch, out, work, cards, rehearsal_mbp, n_docs,
                            nshards, M)
            _empty_caches(torch)
        base = None
        if {"w", "wbase", "kw", "f1", "w2"} & rows:
            docs = _wide_docs(n_docs * doc_mbp, n_docs)
            rb = bench.rb_of(docs)
            fastas = bench.write_fastas(docs, work)
            del docs
            report["collection"] = {
                "docs": n_docs, "mbp": n_docs * doc_mbp,
                "text_chars": int(rb.text.size), "snp_rate": WIDE_SNP}
            log(f"[wide] collection: {json.dumps(report['collection'])}")
            if "wbase" in rows:
                base = bench.Baseline(rb.text, rb.seq_lengths,
                                      options.normalize(n_docs, quiet=True))
                running.callback(base.close)
        try:
            if "kw" in rows:
                out["kw"] = _wide_kr(torch, rb.text, cards)
                _empty_caches(torch)
            if "w" in rows:
                triples["w"] = _wide_row(torch, out, work, rb, fastas, cards,
                                         nshards, M)
                _empty_caches(torch)
            if "f1" in rows:
                triples["f1"] = _cli_one_card(torch, out, work, fastas,
                                              cards[0])
                _empty_caches(torch)
            if "w2" in rows:
                triples["w2"] = _wide_dcn(torch, out, work, fastas, devices,
                                          w2_parts)
        finally:
            if base is not None:
                rec = out["wbase"] = base.result()
                log(f"[wide] wbase: baseline_cpu {bench.triple(rec)}, its own "
                    f"t_total {rec.get('t_total')} s, {rec['wall_s']:.1f} s "
                    "from its start to its end")
                baseline = bench.triple(rec)
        if triples:
            for key, got in triples.items():
                if got is not None and got != baseline:
                    raise AssertionError(f"{key}: {got} != baseline_cpu "
                                         f"{baseline}")
            log(f"[wide] {sorted(k for k, v in triples.items() if v)} equal "
                f"baseline_cpu's {baseline}")
        if "m3" in rows:
            m3 = _cards_m2(torch, out, work, m3_coll, m3_doc_mbp, devices,
                           M3_PER_DOC, key="m3", rb=m3_rb)
            rec = out["m3"]["baseline"] = m3_base.result()
            log(f"[wide] m3: merged {m3['got']}, baseline_cpu "
                f"{bench.triple(rec)}, its own t_total {rec.get('t_total')} s")
            if m3["got"] != bench.triple(rec) or not rec["matches"]:
                raise AssertionError(f"m3: merged {m3['got']} != "
                                     f"baseline_cpu {bench.triple(rec)}")
    report["rows_s"] = time.perf_counter() - t0
    log(f"[wide] the rows took {report['rows_s']:.1f} s")


def cards_main(rows=None) -> int:
    """`python3 chip_smoke.py --cards [ROW ...]`: phase_cards on every
    visible card, or with row names (CARD_ROWS) phase_wide's rows. Writes
    its report as chip_smoke_cards.json, or chip_smoke_cards_<rows>.json,
    in the output directory beside chip_smoke.json."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    ncards = torch.cuda.device_count()
    report = {"card": bench.smi(), "cards": ncards, "peer_access": {
        f"{i}->{j}": torch.cuda.can_device_access_peer(i, j)
        for i in range(ncards) for j in range(ncards) if i != j}}
    log(f"peer access: {json.dumps(report['peer_access'])}")
    phase_build(report)
    try:
        if rows:
            phase_wide(torch, report, rows)
        else:
            phase_cards(torch, report)
    finally:
        # the rows that ran are kept also when a later one fails
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        name = "_".join(["chip_smoke_cards", *(rows or ())]) + ".json"
        with open(os.path.join(ROOT, "chiprun_out", name), "w") as f:
            json.dump(report, f, indent=1)
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "mumemto_tpu", "bench"))
    if foreign:
        raise AssertionError(f"chip_smoke imported {foreign}")
    log(report["card"])
    log(json.dumps({"ok": True, "cards": ncards}))
    return 0


def main() -> int:
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
    phase_scan(torch, report)
    phase_phrases(torch, report)
    res_8mbp, mums_32mbp = phase_end_to_end(torch, report)
    res_f3 = phase_mem(torch, report)
    phase_walk(torch, report)
    phase_routes(torch, report, res_8mbp.output_bytes())
    phase_bytes(torch, report)
    with tempfile.TemporaryDirectory() as work:
        phase_slice(torch, report, res_8mbp, res_f3, work)
        phase_sharded(torch, report, res_8mbp, res_f3, mums_32mbp, work)
        phase_modules(torch, report, res_8mbp, res_f3, mums_32mbp, work)
    phase_real(torch, report)
    phase_bench(torch, report)
    phase_scale(torch, report)
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
    report["path_launches"].update(report["real"]["paths"])
    report["path_launches"].update(report["bench"]["paths"])
    report["path_launches"].update(report["scale"]["paths"])
    for label, launches in report["path_launches"].items():
        _sorted(label, launches)
    pr = report["probe"]
    big = report["phrases"]["sets"][PHRASE_SETS[0][0]]
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
        "name": "running_scan", "route": "cuda", "source": SCAN_SOURCE,
        "replaces": None,
        "launches": sum(v["running_scan"]
                        for v in report["path_launches"].values()),
        "max_abs_err": report["scan"]["max_abs_err"],
        "ms": report["scan"]["cases"]["2^28 int32"]["max"]["ms"],
        "plain_ms": report["scan"]["cases"]["2^28 int32"]["max"]["plain_ms"],
        "bound_ms": report["scan"]["cases"]["2^28 int32"]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": report["scan"]["cases"]["2^28 int32"]["library_ms"]}, {
        "name": "add_one", "route": "cuda", "source": PROBE_SOURCE,
        "replaces": PROBE_REPLACES, "launches": pr["launches"],
        "max_abs_err": pr["max_abs_err"], "ms": pr["ms"],
        "plain_ms": pr["plain_ms"], "bound_ms": probe_bound_ms,
        "bound_by": "bytes", "library_ms": pr["library_ms"]}] + [{
        "name": f"phrase_{k}", "route": "cuda", "source": PHRASES_SOURCE,
        "replaces": None, "launches": sum(
            v[f"phrase_{k}"] for v in report["path_launches"].values()),
        "max_abs_err": max(r["mismatches"][k]
                           for r in report["phrases"]["sets"].values()),
        "ms": big[k]["ms"] if k != "tail_rank" else big["tail"]["ms"],
        "plain_ms": None,
        "bound_ms": big[k]["bound_ms"] if k != "tail_rank" else None,
        "bound_by": "bytes" if k != "tail_rank" else "comparisons",
        "library_ms": None} for k in ("fingerprint", "verify", "tail_rank")]}
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
        if sys.argv[1:2] == ["--cards"]:
            rows = sys.argv[2:]
            unknown = sorted(set(rows) - set(CARD_ROWS))
            if unknown:
                raise SystemExit(f"chip_smoke: no --cards rows {unknown}; "
                                 f"the rows are {', '.join(CARD_ROWS)}")
            rc = cards_main(rows)
        else:
            rc = main()
    except Exception:  # any failed phase: report it and exit non-zero
        traceback.print_exc()
        rc = 1
    sys.exit(rc)
