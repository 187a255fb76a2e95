"""Throughput harness of the PyTorch port: pangenome multi-MUM/MEM Mbp/s on
a CUDA card, the counterpart of the JAX package's bench.py.

    python -m mumemto_tpu_torch.bench [--config NAME ... | all-one-card]
        [--reps N] [--baseline | --no-baseline] [--device cuda|cpu]
        [--mbp X] [--docs N] [--seed S] [--snp R] [--w W] [--mod M]
        [--verify]

Each named configuration (CONFIGS, in the order of PERF.md's candidate
cells) is a generated collection, its options, the route that scans it
and the match count it must give (native/baseline_cpu's on record). For
each one the harness makes one cold call (kernel load and allocator
warm-up), `reps` timed calls, one call under the engine's stage hook and,
on a card, one call under torch.profiler, and prints one JSON line on
stdout: walls (median, best, max, spread), Mbp/s, the stage split, each
card's peak allocation over the timed calls, the device's busy share, the
KR kernel's launches per call, the running max / min kernel's and the
phrase kernels' launches over all calls (each call must have sorted its
phrases on the card once a KR launch), the count against the one on
record and,
where it ran, against a live native/baseline_cpu run on the same bytes
(on by default below 100 Mbp). The last line has bench.py's keys for the
first configuration: {"metric", "value" (Mbp/s of the best call), "unit",
"vs_baseline"}.

Nothing falls back: the CPU runs only when --device cpu asks for it, a
baseline that was asked for and fails is an error, and a count that
differs from the one on record or from the baseline's, a kernel launch
count that is off, or a device that runs out of memory stops the run with
a non-zero exit after the lines of the configurations that passed.
--mbp, --docs, --seed and --snp (defaults from MUMEMTO_BENCH_MBP, _DOCS,
_SEED, _SNP) resize every chosen configuration; then its count is held
against a live baseline only, which must run. MUMEMTO_BENCH_REPS, _W and
_MOD are the defaults of --reps, --w and --mod; MUMEMTO_BENCH_VERIFY=1
(--verify) runs the oracle-free property checks on the warm result
(MUMEMTO_BENCH_VERIFY_MAX caps the matches checked).

The module also holds the workload and measurement helpers that
chip_smoke.py uses: the collections, native/baseline_cpu, the stage
timers and the profiler's busy time. It imports torch and the port,
never jax and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE_BIN = os.path.join(ROOT, "native", "baseline_cpu")
BASELINE_BELOW_MBP = 100  # a live baseline runs by default below this size


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# --- the collections -------------------------------------------------------

def synth_collection(total_mbp: float, n_docs: int, seed: int = 0,
                     snp_rate: float = 0.001):
    """The bench collection (the same bytes as bench.py's synth_collection
    for the same arguments): n_docs mutated copies of one random base
    sequence, ~total_mbp Mbp in all before revcomp, 0.1% SNPs by default
    (the pairwise divergence of human haplotypes)."""
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


GAP_LENGTHS = (100, 1000, 10_000, 50_000)
GAP_PROBS = (0.6, 0.25, 0.1, 0.05)
IUPAC_CODES = b"RYKMSWBDHV"


def synth_collection_real(total_mbp: float, n_docs: int, seed: int = 0,
                          iupac: bool = False, snp_rate: float = 0.001):
    """The bench collection with the alphabet of a real assembly:
    synth_collection's documents for the same arguments (the same lengths,
    so Mbp stays comparable) with assembly gaps written over them as runs
    of N and, with iupac, the ten IUPAC ambiguity codes.

    Per document, independently (gaps differ between assemblies),
    max(1, doc_len // 250_000) gaps overwrite (never insert) bases:
    positions uniform, lengths drawn from GAP_LENGTHS with GAP_PROBS. 100
    is NCBI's convention for a gap of unknown size and by far the most
    common, 1000 and 10 000 are scaffolding gaps, 50 000 is what GRCh38
    writes for its largest unsized gaps (heterochromatin, short arms). The
    mean is 3810 bases a gap, so about 1.5% of the bases are N. A gap is
    clipped to the document and to a tenth of its length (which bites below
    500 kbp a document: the 1 Mbp byte checks). Document 0 always holds one
    gap of 50 000 (so clipped); one gap of document 1 starts at its first
    base and one of document 2 ends at its last, a run that meets the '$'.
    With N the text has 9 distinct bytes with the parse's 0, 1, 2 and '$':
    one more than the 3-bit seed takes.

    iupac: single non-N bases at rate 1e-5 (at least one a document) become
    a code drawn from RYKMSWBDHV, and document 0 gets each code once more,
    so all ten occur: 19 distinct bytes, over the 16 of the packed LCP
    bottom. The gaps are the same with and without iupac."""
    docs = synth_collection(total_mbp, n_docs, seed=seed, snp_rate=snp_rate)
    rng = np.random.default_rng([seed, 0x4E])       # the gaps
    rng_c = np.random.default_rng([seed, 0x49])     # the codes
    codes = np.frombuffer(IUPAC_CODES, np.uint8)
    for i, d in enumerate(docs):
        n = int(d.size)
        n_gaps = max(1, n // 250_000)
        lens = rng.choice(GAP_LENGTHS, n_gaps, p=GAP_PROBS)
        if i == 0:
            lens[0] = GAP_LENGTHS[-1]
        lens = np.minimum(lens, max(1, n // 10))
        pos = (rng.random(n_gaps) * (n - lens + 1)).astype(np.int64)
        if i == 1:
            pos[0] = 0
        if i == 2:
            pos[0] = n - lens[0]
        if iupac:
            n_codes = max(1, int(round(n * 1e-5)))
            where = rng_c.integers(0, n, n_codes)
            what = codes[rng_c.integers(0, codes.size, n_codes)]
            if i == 0:
                where = np.concatenate([where,
                                        rng_c.integers(0, n, codes.size)])
                what = np.concatenate([what, codes])
        for p, ln in zip(pos.tolist(), lens.tolist()):
            d[p:p + ln] = ord("N")
        if iupac:
            # after the gaps, so no code breaks a run: a code drawn into a
            # gap (or onto another code) moves to the next free base
            for p, c in zip(where.tolist(), what.tolist()):
                while d[p % n] == ord("N") or d[p % n] in codes:
                    p += 1
                d[p % n] = c
    return docs


def rb_of(docs):
    """Documents (uint8 arrays) as a RefBuilder: fwd $ revcomp $ each."""
    from mumemto_tpu_torch.refbuilder import RefBuilder, revcomp
    pieces, seq_lengths = [], []
    dollar = np.frombuffer(b"$", dtype=np.uint8)
    for fwd in docs:
        pieces += [fwd, dollar, revcomp(fwd), dollar]
        seq_lengths.append(2 * (fwd.size + 1))
    text = np.concatenate(pieces)
    return RefBuilder(text=text, seq_lengths=seq_lengths, num_docs=len(docs),
                      use_revcomp=True, input_files=[], multifasta_names=[],
                      multifasta_lengths=[])


def write_fastas(docs, tmp):
    """One FASTA a document, d{i}.fa in tmp; returns their paths."""
    paths = []
    for i, fwd in enumerate(docs):
        path = os.path.join(tmp, f"d{i}.fa")
        with open(path, "wb") as fh:
            fh.write(b">d%d\n" % i + fwd.tobytes() + b"\n")
        paths.append(path)
    return paths


# --- native/baseline_cpu ---------------------------------------------------

def build_cpu_baseline():
    """native/baseline_cpu, built by native/build_baseline.py when missing
    or stale."""
    built = subprocess.run(
        [sys.executable, os.path.join(ROOT, "native", "build_baseline.py")],
        capture_output=True, text=True, timeout=600)
    if built.returncode != 0:
        raise AssertionError(f"native/baseline_cpu did not build: "
                             f"{built.stdout} {built.stderr[-2000:]}")


class Baseline:
    """One run of native/baseline_cpu, the single-core C++ SA-IS + Kasai +
    LCP-interval scan, on the same input, in a process of its own: started
    here (the binary built first when missing or stale), read by
    result(), killed by close() if still running (a run on 1.9 G
    characters takes minutes, so the caller works meanwhile)."""

    def __init__(self, text, seq_lengths, opts):
        build_cpu_baseline()
        self.dir = tempfile.TemporaryDirectory()
        tf = os.path.join(self.dir.name, "text.bin")
        lf = os.path.join(self.dir.name, "lens.txt")
        with open(tf, "wb") as f:
            text.tofile(f)
        with open(lf, "w") as f:
            f.write("".join(f"{n}\n" for n in seq_lengths))
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [BASELINE_BIN, tf, lf,
             str(opts.min_match_len), str(opts.num_distinct),
             str(opts.max_doc_freq), str(opts.max_total_freq),
             str(int(opts.no_max_freq)), str(int(opts.use_revcomp)), "1"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def result(self, timeout: float = 3600) -> dict:
        """Its JSON record (matches, sum_len, occ_hash, t_total, ...) and
        wall_s, the seconds from its start to its end."""
        try:
            out, err = self.proc.communicate(timeout=timeout)
        finally:
            self.close()
        if self.proc.returncode != 0:
            raise AssertionError(f"native/baseline_cpu failed: {err[-2000:]}")
        return {**json.loads(out), "wall_s": time.perf_counter() - self.t0}

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()
        self.dir.cleanup()


def cpu_baseline(text, seq_lengths, opts) -> dict:
    """The JSON record of one run of native/baseline_cpu (Baseline) on
    the same input, waited for."""
    return Baseline(text, seq_lengths, opts).result()


def run_cpu_baseline(text, seq_lengths, opts, mbp):
    """(Mbp/s, matches) of one run of native/baseline_cpu (cpu_baseline)."""
    r = cpu_baseline(text, seq_lengths, opts)
    return mbp / r["t_total"], r["matches"]


def triple(rec) -> dict:
    """Match count, sum of lengths and occurrence hash of a record."""
    return {k: rec[k] for k in ("matches", "sum_len", "occ_hash")}


def occ_stats(path, num_docs, order=None) -> dict:
    """The match count, the sum of lengths and native/baseline_cpu's
    occurrence hash (its emit_mum: an order-free uint64 sum of
    mix(offset * 131 + doc * 7 + (3 if '-') + length) over every
    occurrence) of a .mums file; with `order` (column j of the file is
    document order[j]) the columns are put in document order first."""
    from mumemto_tpu_torch import formats
    L, S, T = formats.parse_mums(path, num_docs)
    if order is not None:
        cols = [order.index(d) for d in range(num_docs)]
        S, T = S[:, cols], T[:, cols]
    u = np.uint64
    x = (S.astype(u) * u(131) + np.arange(num_docs, dtype=u) * u(7)
         + np.where(T, 0, 3).astype(u) + L.astype(u)[:, None])[S >= 0]
    x ^= x >> u(33)
    x *= u(0xff51afd7ed558ccd)
    x ^= x >> u(33)
    return {"matches": int(L.size), "sum_len": int(L.astype(np.int64).sum()),
            "occ_hash": int(x.sum(dtype=u))}


# --- timers, counters and the profiler -------------------------------------

def smi() -> str:
    """The first card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def sync_all(torch):
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


class StageTimer:
    """phase(name) callback: synchronizes the card and records the wall
    time since the previous call."""

    def __init__(self, torch):
        self.torch = torch
        self.stages = {}
        self.t = time.perf_counter()

    def __call__(self, name):
        sync_all(self.torch)
        now = time.perf_counter()
        self.stages[name] = now - self.t
        self.t = now


class SumTimer(StageTimer):
    """A StageTimer that adds up the stages called more than once."""

    def __call__(self, name):
        before = self.stages.get(name, 0.0)
        super().__call__(name)
        self.stages[name] += before


class Split:
    """Seconds of named module functions while active, each call between
    two synchronizations of every card (targets: {name: (module,
    attribute)}); every find_matches call also gets `phase` (a SumTimer,
    restarted at the call) for its stage split."""

    def __init__(self, torch, targets, phase):
        self.torch, self.targets, self.phase = torch, targets, phase
        self.s = dict.fromkeys(targets, 0.0)
        self.calls = dict.fromkeys(targets, 0)

    def __enter__(self):
        self.real = {n: getattr(m, a) for n, (m, a) in self.targets.items()}
        for name, (mod, attr) in self.targets.items():
            setattr(mod, attr, self._timed(name, self.real[name],
                                           attr == "find_matches"))
        return self

    def _timed(self, name, real, scan):
        def timed(*a, **kw):
            sync_all(self.torch)
            if scan:
                kw["phase"] = self.phase
                self.phase.t = time.perf_counter()
            t0 = time.perf_counter()
            try:
                return real(*a, **kw)
            finally:
                sync_all(self.torch)
                self.s[name] += time.perf_counter() - t0
                self.calls[name] += 1
        return timed

    def __exit__(self, *exc):
        for name, (mod, attr) in self.targets.items():
            setattr(mod, attr, self.real[name])


def counted(torch, fn):
    """(fn(), seconds, launch counts): fn with tracing on (left as it was
    found after), its kernel launches read from the counters tracing kept
    meanwhile. When counted turned tracing on, what was kept is drained
    before fn and after; otherwise nothing is drained, so calls nest."""
    from mumemto_tpu_torch import trace
    was = trace.enable()
    if not was:
        trace.drain()
    before = launch_counts(trace.totals())
    try:
        t0 = time.perf_counter()
        out = fn()
        sync_all(torch)
        s = time.perf_counter() - t0
        after = launch_counts(trace.totals())
    finally:
        if not was:
            trace.disable()
            trace.drain()
    return out, s, {k: n - before[k] for k, n in after.items()}


def launch_counts(totals: dict) -> dict:
    """Every kernel's launches in trace.totals()'s counts, by the kernel's
    name."""
    from mumemto_tpu_torch.kernels import kr_mask, phrases, probe, scan
    counters = {"kr_break_mask": kr_mask.COUNTER, "add_one": probe.COUNTER,
                "running_scan": scan.COUNTER, **phrases.COUNTERS}
    return {k: totals.get(c, 0) for k, c in counters.items()}


def sorted_on_card(launches: dict, sorts: int) -> bool:
    """Whether launch counts show `sorts` phrase sorts on the card, and
    nothing else of the phrase kernels: one fingerprint and one verify
    launch each, and at most one tail launch."""
    return (launches["phrase_fingerprint"] == launches["phrase_verify"]
            == sorts and launches["phrase_tail_rank"] <= sorts)


def busy_overlap(spans) -> dict:
    """Device activity [(card, start_us, end_us)] summed up: each card's
    busy us (the union of its spans), the us in which at least one and at
    least two cards were busy, the us in which at least k cards were busy
    for every k, and the span from first start to last end."""
    by_card = {}
    for card, a, b in spans:
        by_card.setdefault(card, []).append((a, b))
    merged = {}
    for card, ivs in by_card.items():
        runs = []
        for a, b in sorted(ivs):
            if runs and a <= runs[-1][1]:
                runs[-1][1] = max(runs[-1][1], b)
            else:
                runs.append([a, b])
        merged[card] = runs
    edges = sorted((t, step) for runs in merged.values() for a, b in runs
                   for t, step in ((a, 1), (b, -1)))
    at_least = [0.0] * (len(merged) + 1)
    depth, prev = 0, None
    for t, step in edges:
        if prev is not None:
            for k in range(1, depth + 1):
                at_least[k] += t - prev
        depth, prev = depth + step, t
    return {"busy_us": {str(c): sum(b - a for a, b in runs)
                        for c, runs in sorted(merged.items())},
            "any_busy_us": at_least[1] if merged else 0.0,
            "overlap_us": at_least[2] if len(merged) > 1 else 0.0,
            "cards_busy_us": {str(k): at_least[k]
                              for k in range(1, len(merged) + 1)},
            "span_us": (max(b for _c, _a, b in spans)
                        - min(a for _c, a, _b in spans)) if spans else 0.0}


def trace_cards(torch, fn, tmp, stages=None):
    """(fn(phase), device spans): fn under torch.profiler (the cards'
    activity, the CPU's where there is no card), over the whole call, or
    with stages = (a, b) from the phase hook's call for stage a to its
    call for stage b (the stages after a up to b); the spans [(card,
    start_us, end_us)] of the kernels, copies and memsets of its chrome
    trace."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CUDA]
                   if torch.cuda.is_available() else [ProfilerActivity.CPU])
    on = []

    def switch(start):
        sync_all(torch)
        if start and not on:
            prof.start()
            on.append(True)
        elif on and not start:
            prof.stop()
            on.clear()

    def phase(name):
        if name in stages:
            switch(name == stages[0])
    try:
        if stages is None:
            switch(True)
        out = fn(phase if stages else None)
        switch(False)
    finally:
        if on:
            prof.stop()
    path = os.path.join(tmp, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    os.remove(path)
    spans = [(int(e["args"]["device"]), float(e["ts"]),
              float(e["ts"]) + float(e["dur"])) for e in events
             if e.get("ph") == "X" and e.get("cat") in (
                 "kernel", "gpu_memcpy", "gpu_memset")
             and "device" in e.get("args", {})]
    return out, spans


# --- the configurations ----------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Config:
    """One measured configuration: the collection (mbp, docs, seed, snp,
    alphabet: "acgt", "real" or "iupac"), the options (flags for
    options.normalize), the route ("engine", "direct": the -g backend,
    "sharded": find_matches_seq_sharded with `shards` shards and window
    capacity M over `cards` cards, "cli": cli.main on one FASTA a
    document, "mtom": MumemtoM of 2 anchor partitions then the merge), and
    what it must give: `expected` matches (native/baseline_cpu's count on
    record) and, where recorded, the .mums file's count, sum of lengths
    and occurrence hash (`expected_triple`)."""
    name: str
    mbp: float
    docs: int
    expected: int
    route: str = "engine"
    flags: tuple = ()
    alphabet: str = "acgt"
    seed: int = 0
    snp: float = 0.001
    shards: int = 0
    M: int = 4096
    cards: int = 1
    expected_triple: tuple | None = None


_F3 = (("rare_freq", 3), ("max_mem_freq", 0))
CONFIGS = {c.name: c for c in (
    Config("mum8", 8, 8, 6759),
    Config("mum32", 32, 8, 27119),
    Config("f3_8", 8, 8, 13522, flags=_F3),
    Config("g8", 8, 8, 6759, route="direct"),
    Config("g32", 32, 8, 27119, route="direct"),
    Config("real8", 8, 8, 5095, alphabet="real"),
    Config("real32", 32, 8, 23829, alphabet="real"),
    Config("iupac8", 8, 8, 5136, alphabet="iupac"),
    Config("M32", 32, 8, 27119, flags=(("merge", True),)),
    Config("shards8_32", 32, 8, 27119, route="sharded", shards=8, M=8192),
    Config("c10_k1", 50, 10, 84768, flags=(("num_distinct_docs", -1),)),
    Config("c10_f3", 50, 10, 81814, flags=_F3),
    Config("c20_cli", 100, 20, 66379, route="cli"),
    Config("c20_mtom", 100, 20, 66379, route="mtom"),
    Config("mum96", 96, 8, 81305),
    # 215 isolates of 4.41 Mbp at 0.01% SNPs: 1.896 G rows, a 2^31-row
    # bucket one device's scan refuses; baseline_cpu takes ~600 s on it
    Config("w", 948.15, 215, 61110, route="sharded", snp=1e-4, shards=16,
           M=1 << 14, cards=4,
           expected_triple=(61110, 4029012, 15288323120970386319)),
)}
ALL_ONE_CARD = "all-one-card"
FILE_ROUTES = ("cli", "mtom")


def _launches_per_call(cfg) -> int:
    """KR kernel launches of one call on a card: one a PFP scan (each
    MumemtoM partition is one), none on the direct backend."""
    return {"direct": 0, "mtom": 2}.get(cfg.route, 1)


def _collection(cfg, mbp, docs, seed, snp):
    if cfg.alphabet == "acgt":
        return synth_collection(mbp, docs, seed=seed, snp_rate=snp)
    return synth_collection_real(mbp, docs, seed=seed, snp_rate=snp,
                                 iupac=cfg.alphabet == "iupac")


def _devices(torch, cfg, dev):
    """The devices a configuration runs on: cfg.cards cards from cuda:0
    (or dev's card for one card), or the CPU."""
    if dev.type == "cpu":
        return [dev]
    if cfg.cards > torch.cuda.device_count():
        raise RuntimeError(f"{cfg.name} needs {cfg.cards} cards, "
                           f"{torch.cuda.device_count()} are visible")
    if cfg.cards == 1:
        return [torch.device("cuda", 0 if dev.index is None else dev.index)]
    return [torch.device("cuda", i) for i in range(cfg.cards)]


class _Route:
    """A configuration's call on its collection: run(phase) scans and
    returns what count() reads the match count from."""

    def __init__(self, cfg, rb, opts, docs, devices, work, w, mod):
        self.cfg, self.rb, self.opts, self.w, self.mod = cfg, rb, opts, w, mod
        self.devices, self.prefix = devices, os.path.join(work, "out")
        if cfg.route in FILE_ROUTES:
            if cfg.route == "mtom" and (w, mod) != (10, 100):
                raise ValueError("the MumemtoM route scans with w = 10 and "
                                 "mod = 100 only")
            self.fastas = write_fastas(docs, work)

    def run(self, phase=None):
        from mumemto_tpu_torch import cli, engine
        from mumemto_tpu_torch.parallel import mumemtom, seqpfp
        cfg, dev = self.cfg, self.devices[0]
        if cfg.route in ("engine", "direct"):
            return engine.find_matches(
                self.rb, self.opts, device=dev, pfp_w=self.w,
                pfp_mod=self.mod, phase=phase, backend=(
                    "direct" if cfg.route == "direct" else "pfp"),
                show_progress=False)
        if cfg.route == "sharded":
            devs = [self.devices[r % len(self.devices)]
                    for r in range(cfg.shards)]
            return seqpfp.find_matches_seq_sharded(
                self.rb, self.opts, devs, pfp_w=self.w, pfp_mod=self.mod,
                M=cfg.M, phase=phase)
        # the file routes print to stdout, which holds the records
        with contextlib.redirect_stdout(sys.stderr):
            if cfg.route == "cli":
                rc = cli.main(self.fastas + [
                    "-o", self.prefix, "--device", str(dev),
                    "-w", str(self.w), "-m", str(self.mod)])
                if rc != 0:
                    raise RuntimeError(f"{cfg.name}: cli.main exit {rc}")
                return self.prefix + ".mums"
            return mumemtom.run_partitioned_files(
                self.fastas, self.prefix, num_partitions=2, anchor=True,
                device=dev)

    def count(self, out) -> int:
        if self.cfg.route in FILE_ROUTES:
            from mumemto_tpu_torch import formats
            return int(formats.parse_mums(out, self.rb.num_docs)[0].size)
        return out.num_matches

    def split_targets(self):
        """The functions a file route's stage call times (Split)."""
        from mumemto_tpu_torch import engine, refbuilder
        from mumemto_tpu_torch.parallel import mumemtom
        targets = {"fasta": (refbuilder, "build_from_files"),
                   "scan": (engine, "find_matches"),
                   "write": (engine, "write_outputs")}
        if self.cfg.route == "mtom":
            targets["merge"] = (mumemtom, "merge_partition_outputs")
        return targets


def _fail(cfg, what):
    raise AssertionError(f"{cfg.name}: {what}")


def run_config(torch, cfg, dev, args) -> dict:
    """One configuration (module docstring) on `dev`: its record, after
    every check passed; raises on the first that fails."""
    from mumemto_tpu_torch import options, properties
    from mumemto_tpu_torch.kernels import phrases
    mbp = cfg.mbp if args.mbp is None else args.mbp
    ndocs = cfg.docs if args.docs is None else args.docs
    seed = cfg.seed if args.seed is None else args.seed
    snp = cfg.snp if args.snp is None else args.snp
    resized = (mbp, ndocs, seed, snp) != (cfg.mbp, cfg.docs, cfg.seed,
                                          cfg.snp)
    expected = None if resized else cfg.expected
    want_triple = None if resized or not cfg.expected_triple else dict(zip(
        ("matches", "sum_len", "occ_hash"), cfg.expected_triple))
    live = args.baseline if args.baseline is not None else \
        mbp < BASELINE_BELOW_MBP
    if expected is None and not live:
        raise ValueError(f"{cfg.name} resized to {mbp:g} Mbp, {ndocs} docs, "
                         f"seed {seed}, snp {snp:g}: no count on record, so "
                         "a live baseline must run (--baseline)")
    on_card = dev.type == "cuda"
    devices = _devices(torch, cfg, dev)
    per_call = _launches_per_call(cfg) if on_card else 0

    t0 = time.perf_counter()
    docs = _collection(cfg, mbp, ndocs, seed, snp)
    rb = rb_of(docs)
    opts = options.normalize(ndocs, quiet=True, **dict(cfg.flags))
    with tempfile.TemporaryDirectory() as work:
        route = _Route(cfg, rb, opts, docs, devices, work, args.w, args.mod)
        del docs
        log(f"[bench] {cfg.name}: {mbp:g} Mbp, {ndocs} docs, "
            f"{rb.text.size} chars, set up in {time.perf_counter() - t0:.1f} s")
        n_calls = scans = 0
        phrase_launches = dict.fromkeys(phrases.KERNELS, 0)

        def call(fn):
            nonlocal n_calls, scans
            out, s, launches = counted(torch, fn)
            n_calls += 1
            scans += launches["running_scan"]
            for k in phrase_launches:
                phrase_launches[k] += launches[k]
            got = route.count(out)
            if (launches["kr_break_mask"], launches["add_one"]) != \
                    (per_call, 0) or not sorted_on_card(launches, per_call):
                _fail(cfg, f"kernel launches {launches} in one call, "
                      f"expected {per_call} KR launches and phrase sorts "
                      "and no add_one")
            if expected is not None and got != expected:
                _fail(cfg, f"{got} matches, {expected} on record")
            return out, s, got

        out, cold_s, matches = call(route.run)
        log(f"[bench] {cfg.name}: cold {cold_s:.3f} s, {matches} matches")
        verified = None
        if args.verify:
            if cfg.route in FILE_ROUTES:
                log(f"[bench] {cfg.name}: the {cfg.route} route writes "
                    "files, so no property check")
            else:
                cap = int(os.environ.get("MUMEMTO_BENCH_VERIFY_MAX", 0)) or None
                check = (properties.check_mum_properties if opts.mum_mode
                         else properties.check_mem_properties)
                verified = check(out, rb, max_checked=cap)
        del out
        if on_card:
            sync_all(torch)
            for d in devices:
                torch.cuda.reset_peak_memory_stats(d)
        walls = []
        for rep in range(args.reps):
            out, s, got = call(route.run)
            del out
            walls.append(s)
            if got != matches:
                _fail(cfg, f"rep {rep}: {got} matches, the cold call "
                      f"{matches}")
            log(f"[bench] {cfg.name}: rep {rep} {s:.3f} s")
        peaks = [torch.cuda.max_memory_allocated(d) / 2**30
                 for d in devices] if on_card else None

        timer = SumTimer(torch)
        calls_s = None
        if cfg.route in FILE_ROUTES:
            with Split(torch, route.split_targets(), timer) as split:
                out = call(route.run)[0]
            calls_s = split.s
        else:
            out = call(lambda: route.run(timer))[0]
        triple_got = None
        if want_triple is not None or (cfg.expected_triple and live):
            from mumemto_tpu_torch import engine
            engine.write_outputs(out, rb, route.prefix)
            triple_got = occ_stats(route.prefix + ".mums", rb.num_docs)
            if want_triple is not None and triple_got != want_triple:
                _fail(cfg, f"triple {triple_got}, {want_triple} on record")
        del out

        busy = None
        if on_card:
            span = {}

            def traced(_phase):
                t = time.perf_counter()
                got = route.count(route.run())
                sync_all(torch)
                span["s"] = time.perf_counter() - t
                return got
            (got, spans), _s, launches = counted(
                torch, lambda: trace_cards(torch, traced, work))
            n_calls += 1
            scans += launches["running_scan"]
            for k in phrase_launches:
                phrase_launches[k] += launches[k]
            if launches["kr_break_mask"] != per_call or got != matches or \
                    not sorted_on_card(launches, per_call):
                _fail(cfg, f"the traced call: {got} matches, launches "
                      f"{launches}")
            ov = busy_overlap(spans)
            busy = {"busy_s": ov["any_busy_us"] / 1e6, "traced_s": span["s"]}
            if len(devices) > 1:
                busy["card_busy_s"] = {c: v / 1e6
                                       for c, v in ov["busy_us"].items()}
                busy["cards_busy_share"] = {
                    k: v / 1e6 / span["s"]
                    for k, v in ov["cards_busy_us"].items()}
    del route
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    base = None
    if live:
        rec = cpu_baseline(rb.text, rb.seq_lengths, opts)
        base = {"matches": rec["matches"], "s": rec["t_total"],
                "mbp_per_s": mbp / rec["t_total"]}
        if rec["matches"] != matches:
            _fail(cfg, f"{matches} matches, baseline_cpu {rec['matches']}")
        if triple_got is not None and triple(rec) != triple_got:
            _fail(cfg, f"triple {triple_got}, baseline_cpu {triple(rec)}")
    median = statistics.median(walls)
    best = min(walls)
    record = {
        "config": cfg.name, "route": cfg.route,
        "device": smi() if on_card else "cpu",
        "cards": len(devices) if on_card else 0,
        "mbp": mbp, "docs": ndocs, "text_chars": int(rb.text.size),
        "reps": args.reps, "cold_s": cold_s, "walls_s": walls,
        "median_s": median, "best_s": best, "max_s": max(walls),
        "spread": (max(walls) - best) / median,
        "mbp_per_s": mbp / median, "best_mbp_per_s": mbp / best,
        "stages_s": timer.stages, "peak_gib": peaks,
        "busy_share": busy["busy_s"] / busy["traced_s"] if busy else None,
        "busy": busy, "kr_launches": per_call,
        "scan_launches": scans, "phrase_launches": phrase_launches,
        "calls": n_calls,
        "matches": matches, "expected": expected, "baseline": base,
        "vs_baseline": mbp / best / base["mbp_per_s"] if base else None}
    if calls_s is not None:
        record["calls_s"] = calls_s
    if triple_got is not None:
        record["triple"] = triple_got
    if verified is not None:
        record["verified"] = verified
    return record


def _env(name, kind):
    value = os.environ.get(name)
    return None if value is None else kind(value)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m mumemto_tpu_torch.bench",
        description="Throughput of the PyTorch port on named "
                    "configurations; one JSON line each, then bench.py's "
                    "last line.")
    ap.add_argument("--config", nargs="+", default=["mum8"],
                    choices=[*CONFIGS, ALL_ONE_CARD], metavar="NAME",
                    help=f"configurations to run, in order ({', '.join(CONFIGS)}"
                         f"), or {ALL_ONE_CARD}: every one-card one")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback")
    ap.add_argument("--reps", type=int,
                    default=_env("MUMEMTO_BENCH_REPS", int) or 5)
    ap.add_argument("--baseline", action=argparse.BooleanOptionalAction,
                    default=None, help="a live native/baseline_cpu run on "
                    f"the same input (default: below {BASELINE_BELOW_MBP} "
                    "Mbp)")
    ap.add_argument("--mbp", type=float, default=_env("MUMEMTO_BENCH_MBP",
                                                      float))
    ap.add_argument("--docs", type=int, default=_env("MUMEMTO_BENCH_DOCS",
                                                     int))
    ap.add_argument("--seed", type=int, default=_env("MUMEMTO_BENCH_SEED",
                                                     int))
    ap.add_argument("--snp", type=float, default=_env("MUMEMTO_BENCH_SNP",
                                                      float))
    ap.add_argument("--w", type=int, default=_env("MUMEMTO_BENCH_W", int) or 10)
    ap.add_argument("--mod", type=int,
                    default=_env("MUMEMTO_BENCH_MOD", int) or 100)
    ap.add_argument("--verify", action="store_true",
                    default=bool(os.environ.get("MUMEMTO_BENCH_VERIFY")))
    args = ap.parse_args(argv)
    if args.reps < 1:
        ap.error("--reps must be at least 1")
    names = []
    for name in args.config:
        names += [n for n, c in CONFIGS.items() if c.cards == 1] \
            if name == ALL_ONE_CARD else [name]
    args.config = list(dict.fromkeys(names))
    return args


def run(torch, args):
    """The records of args.config's configurations, one at a time
    (run_config), on args.device; raises at the first that fails."""
    from mumemto_tpu_torch.device import resolve
    dev = resolve(args.device)
    if dev.type == "cuda":
        from mumemto_tpu_torch.kernels import kr_mask
        t0 = time.perf_counter()
        kr_mask.launcher()
        log(f"[bench] KR kernel built and loaded in "
            f"{time.perf_counter() - t0:.1f} s")
    for name in args.config:
        cfg = CONFIGS[name]
        try:
            yield run_config(torch, cfg, dev, args)
        except BaseException as e:
            # what was reached, for the record of a run that failed
            peaks = [torch.cuda.max_memory_allocated(i) / 2**30
                     for i in range(torch.cuda.device_count())] \
                if dev.type == "cuda" else None
            failed = {"config": name, "peak_gib": peaks,
                      "error": f"{type(e).__name__}: {str(e)[:500]}"}
            log(f"[bench] FAILED {json.dumps(failed)}")
            raise


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch
    first = None
    for rec in run(torch, args):
        print(json.dumps(rec), flush=True)
        first = first or rec
    cfg = CONFIGS[first["config"]]
    kind = (f"{first['cards']} x {torch.cuda.get_device_name(0)}"
            if first["cards"] else "the CPU")
    mode = "multi-MUM" if dict(cfg.flags).get("rare_freq", 1) == 1 \
        else "multi-MEM"
    print(json.dumps({
        "metric": f"pangenome {mode} throughput (mumemto_tpu_torch, "
                  f"{cfg.name}, {kind})",
        "value": first["best_mbp_per_s"], "unit": "Mbp/s",
        "vs_baseline": first["vs_baseline"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
