"""The main path at the shapes of BASELINE.md's configurations 2-4, small:
10 and 20 genome-like documents (t_bench.synth_collection: mutated
copies of one random base, 0.1% SNPs), partial multi-MUMs (-k -1), -f 3,
strict MUMs on 20 documents, MumemtoM with two anchor partitions, and the
range-min query past its int32 flat index, where the JAX package refuses;
then a CPU rehearsal of chip_smoke's phase_scale.

Both packages get the same numpy bytes, made from a seed; the JAX side runs
on its CPU backend, as its own tests run it. The range-min is asked at the
sizes the card meets (nd = 0.75 x 2^27 with 28 levels, 2^28 with 29) on
zero-copy broadcast tables: the port reads them level by level, the JAX
package reads only their length and level count before it refuses.
Tolerance: none (counts and bytes).
"""

import collections
import functools
import importlib
import os
import sys

import numpy as np
import pytest
import torch

from mumemto_tpu import engine as jax_engine
from mumemto_tpu import options
from mumemto_tpu.ops import pfp as jax_pfp
from mumemto_tpu.ops import suffix as jax_suffix
from mumemto_tpu.parallel import mumemtom as jax_mumemtom
from mumemto_tpu_torch import bench as t_bench
from mumemto_tpu_torch import device as t_device
from mumemto_tpu_torch import engine as t_engine
from mumemto_tpu_torch import trace
from mumemto_tpu_torch.kernels import (alphabet, kr_mask, mem_render,
                                       phrases, scan)
from mumemto_tpu_torch.ops import intervals as t_intervals
from mumemto_tpu_torch.ops import pfp as t_pfp
from mumemto_tpu_torch.ops import suffix as t_suffix
from mumemto_tpu_torch.parallel import mumemtom

# several test workers share the machine's cores
torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOC_MBP = 0.008  # 8 kbp a document


def _chip_smoke():
    sys.path.insert(0, ROOT)
    try:
        return importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(ROOT)


@pytest.fixture(scope="module")
def chip_smoke():
    return _chip_smoke()


@functools.lru_cache(maxsize=None)
def _docs(n_docs):
    return t_bench.synth_collection(n_docs * DOC_MBP, n_docs, seed=0)


def _rb(n_docs):
    return t_bench.rb_of(_docs(n_docs))


@pytest.mark.parametrize("n_docs,kw", [
    (10, {"num_distinct_docs": -1}),
    (10, {"rare_freq": 3, "max_mem_freq": 0}),
    (20, {})], ids=["10 docs -k -1", "10 docs -f 3", "20 docs strict"])
def test_find_matches_bytes(n_docs, kw):
    """Rows a, b and c of phase_scale, small: the same bytes from both
    packages; -k -1 resolves to k = N - 1, the size cap is 16 for 10
    documents and 32 for 20 (or -f 3 on 10)."""
    rb = _rb(n_docs)
    opts = options.normalize(n_docs, quiet=True, **kw)
    want = jax_engine.find_matches(rb, opts, show_progress=False)
    got = t_engine.find_matches(rb, opts, device="cpu")
    assert got.output_bytes() == want.output_bytes()
    assert got.num_matches == want.num_matches > 0
    assert got.bwt_runs == want.bwt_runs
    if "num_distinct_docs" in kw:
        assert opts.num_distinct == n_docs - 1
        # partial: some MUM misses a document (an empty offset field)
        assert any(b"" in ln.split(b"\t")[1].split(b",")
                   for ln in got.output_bytes().splitlines())
    cap = t_engine.interval_size_cap(opts, n_docs)
    assert cap == jax_engine.interval_size_cap(opts, n_docs)
    assert cap == (16 if n_docs == 10 and not opts.max_doc_freq > 1 else 32)


def test_mumemtom_anchor_partitions(chip_smoke, tmp_path):
    """Row d, small: 20 FASTAs in 2 anchor partitions (11 and 10 documents)
    merged by both packages: the same merged files, and the merged MUM set
    equal to the union's (strict MUMs on all 20) apart from MUMs that
    touch a document's first or last base."""
    docs = _docs(20)
    fastas = t_bench.write_fastas(docs, str(tmp_path))
    parts = mumemtom.auto_partition(fastas, 2, anchor=True)
    assert [len(p) for p in parts] == [11, 10]
    assert parts == jax_mumemtom.auto_partition(fastas, 2, anchor=True)
    jax_mumemtom.run_partitioned_files(fastas, str(tmp_path / "jax"),
                                       num_partitions=2, anchor=True)
    mumemtom.run_partitioned_files(fastas, str(tmp_path / "torch"),
                                   num_partitions=2, anchor=True,
                                   device="cpu")
    for ext in (".mums", ".athresh", ".lengths"):
        a = (tmp_path / ("jax" + ext)).read_bytes()
        assert a and (tmp_path / ("torch" + ext)).read_bytes() == a, ext
    union = t_engine.find_matches(_rb(20), options.normalize(20, quiet=True),
                                  device="cpu")
    t_engine.write_outputs(union, _rb(20), str(tmp_path / "union"))
    want = chip_smoke._mums_set(str(tmp_path / "union.mums"), 20)
    order = [fastas.index(f) for f in parts[0]] + [
        fastas.index(f) for f in parts[1][1:]]
    got = chip_smoke._mums_set(str(tmp_path / "torch.mums"), 20, order)
    doc_lens = [int(d.size) for d in docs]
    diff = want ^ got
    assert all(chip_smoke._touches_terminal(r, doc_lens) for r in diff)
    assert len(got & want) > 0.9 * len(want) > 0


@pytest.mark.parametrize("n,levels", [
    (3 << 25, 28),      # nd = 0.75 x 2^27: 10 genomes of 5 Mbp at 1% SNPs
    (1 << 28, 29),      # nd = 2^28
    (-(-2**31 // 27), 27)])  # the first entry count past 2^31 at 27 levels
def test_rmq_guard_refuses_in_both_packages(n, levels):
    """Range-min tables past the int32 flat index, at the sizes
    phase_scale's row f meets, on zero-copy broadcast tables whose levels
    hold distinct constants: the port answers every query exactly (the
    constant of its level, with ranges reaching the table's last entry)
    with no copy of the table and nothing counted in RMQ_BYTES; the JAX
    package still asserts."""
    assert n * levels >= 2**31
    t_table = [torch.full((1,), 7 * k + 3, dtype=torch.int32).expand(n)
               for k in range(levels)]
    j_table = [np.broadcast_to(np.zeros(1, np.int32), (n,))] * levels
    length = torch.tensor([1, 2, 3, 5, 1 << 20, (1 << 20) + 7, n // 2, n],
                          dtype=torch.int64)
    lo = torch.cat([torch.zeros_like(length), n - length])
    hi = lo + torch.cat([length, length]) - 1
    lvl = torch.clamp(torch.floor(torch.log2(
        torch.cat([length, length]).double())).long(), max=levels - 1)
    trace.enable()
    with trace.call("engine.find_matches"):
        got = t_pfp._rmq_query(t_table, lo.to(torch.int32),
                               hi.to(torch.int32))
    trace.disable()
    counters = trace.drain()["counters"]
    assert got.dtype == torch.int32
    assert got.tolist() == (7 * lvl + 3).tolist()
    assert all(t_pfp.RMQ_BYTES not in c for c in counters.values())
    with pytest.raises(AssertionError, match="overflow int32"):
        jax_pfp._rmq_query(j_table, np.zeros(4, np.int32),
                           np.ones(4, np.int32))


def _reference():
    """mumbench/reference.py, the benchmark's plain reference."""
    sys.path.insert(0, os.path.join(ROOT, "mumbench"))
    try:
        return importlib.import_module("reference")
    finally:
        sys.path.remove(os.path.join(ROOT, "mumbench"))


def _match_set(data: bytes, mum_mode: bool) -> collections.Counter:
    """.mums or .mems bytes as reference.match_set's tuples, counted (as
    mumbench/run.py's parse_output reads them, without importing the
    harness, which sets up its own paths and caches)."""
    out = []
    for line in data.decode().splitlines():
        f = line.split("\t")
        if mum_mode:
            out.append((int(f[0]), tuple(int(x) if x else -1
                                         for x in f[1].split(",")),
                        tuple(f[2].split(","))))
        else:
            out.append((int(f[0]), tuple(int(x) for x in f[1].split(",")),
                        tuple(int(x) for x in f[2].split(",")),
                        tuple(f[3].split(","))))
    return collections.Counter(out)


@pytest.mark.parametrize("seed", [3, 2**31 + 11, 2**33 + 7])
@pytest.mark.parametrize("mix", [dict(k=-1, f=1, F=0), dict(k=0, f=3, F=0)],
                         ids=["-k -1", "-f 3"])
def test_range_min_by_level_through_a_whole_scan(monkeypatch, mix, seed):
    """engine.find_matches on a seeded 1% collection (10 documents of 3
    kbp), with RMQ_FLAT_LIMIT lowered so that every range-min table, the
    dictionary's and the parse's, is read level by level: the output bytes
    equal the flat path's, and the match set equals mumbench/reference.py's
    (the plain reference the benchmark's correct rests on)."""
    docs = t_bench.synth_collection(0.03, 10, seed=seed, snp_rate=0.01)
    rb = t_bench.rb_of(docs)
    opts = options.normalize(10, quiet=True, num_distinct_docs=mix["k"],
                             rare_freq=mix["f"], max_mem_freq=mix["F"])

    def scan():
        return t_engine.find_matches(rb, opts, device="cpu",
                                     show_progress=False).output_bytes()
    flat = scan()
    monkeypatch.setattr(t_pfp, "RMQ_FLAT_LIMIT", 1)
    by_level = scan()
    assert by_level == flat
    want = _reference().match_set(docs, min_len=20, **mix)
    assert len(want) > 10
    assert _match_set(by_level, opts.mum_mode) == collections.Counter(want)


@pytest.mark.parametrize("nd", [3 << 24, 1 << 26, 3 << 25])
def test_rmq_levels_at_the_card_sizes(nd):
    """The level count of the dictionary's range-min table at the bucketed
    nd of the runs on the card: 27 levels up to 2^26 entries (under the
    int32 flat index), 28 from 0.75 x 2^27 (past it), the same in both
    packages."""
    small = nd >> 14
    assert len(t_intervals._sparse_min_table(
        torch.zeros(small, dtype=torch.int32))) == \
        t_suffix._num_levels(small) + 1
    levels = t_suffix._num_levels(nd) + 1
    assert levels == jax_suffix._num_levels(nd) + 1
    assert (nd * levels < 2**31) == (nd <= 1 << 26)
    assert t_suffix.bucket(nd, lo=1024) == nd == jax_pfp.bucket(nd)


class _NoCard:
    """torch.cuda's part in the phase, without a card."""

    def synchronize(self, *a):
        pass

    def reset_peak_memory_stats(self, *a):
        pass

    def empty_cache(self):
        pass

    def max_memory_allocated(self, *a):
        return 0

    def max_memory_reserved(self, *a):
        return 0

    def device_count(self):
        return 1

    class Event:
        """A host-clock stand-in for a CUDA event."""

        def __init__(self, enable_timing=False):
            self.t = None

        def record(self):
            import time
            self.t = time.perf_counter()

        def elapsed_time(self, end):
            return (end.t - self.t) * 1e3


class _TorchOnCpu:
    """torch, with _NoCard for torch.cuda."""
    cuda = _NoCard()

    def __getattr__(self, name):
        return getattr(torch, name)


def _count_scans(monkeypatch):
    """The running max / min, the phrase kernels, the MEM text kernel and
    the presence kernel as the rehearsals see them: their plain versions,
    each call counted in the kernel's trace counter as a launch on the
    card is."""
    def counted(op):
        def run(x, reverse=False):
            trace.count(scan.COUNTER)
            return scan.running_plain(x, op, reverse)
        return run
    monkeypatch.setattr(scan, "running_max", counted("max"))
    monkeypatch.setattr(scan, "running_min", counted("min"))

    def counted_phrases(name, plain):
        def run(*a):
            trace.count(phrases.COUNTERS[name])
            return plain(*a)
        return run
    for name, plain in (("fingerprint", phrases.fingerprint_plain),
                        ("verify", phrases.verify_plain),
                        ("tail_rank", phrases.tail_rank_plain)):
        monkeypatch.setattr(phrases, name,
                            counted_phrases(f"phrase_{name}", plain))
    render = mem_render.render  # on CPU tensors, its twin

    def counted_render(*a):
        trace.count(mem_render.COUNTER)
        return render(*a)
    monkeypatch.setattr(mem_render, "render", counted_render)

    def counted_presence(t):
        trace.count(alphabet.COUNTER)
        return alphabet.byte_presence_plain(t)
    monkeypatch.setattr(alphabet, "byte_presence", counted_presence)


def _kr_part(launches):
    """A launch record's KR and probe counts."""
    return {k: launches[k] for k in ("kr_break_mask", "add_one")}


def _dict_flat(rb):
    """nd x range-min levels of the dictionary of rb's PFP scan."""
    pfp = t_pfp.build_pfp(rb.text, torch.device("cpu"))
    nd = t_pfp._pad_phrase_arrays(pfp)[-1]
    return nd * (t_suffix._num_levels(nd) + 1)


def test_phase_mem_render_rehearsal(chip_smoke, monkeypatch):
    """chip_smoke's phase 4d at 400 lines on the CPU: "cuda" resolves to
    the CPU, so render runs its twin, CUDA events are host clocks, and
    nvidia-smi is not asked."""
    monkeypatch.setattr(t_engine, "resolve", lambda device:
                        torch.device("cpu"))
    monkeypatch.setattr(chip_smoke.bench, "smi", lambda: "no card")
    report = {}
    chip_smoke.phase_mem_render(_TorchOnCpu(), report, lines=400)
    out = report["mem_render"]
    assert out["mismatched_bytes"] == 0
    assert set(out["cases"]) == {"mem_f3 size", "4096 wide"}
    main = out["cases"]["mem_f3 size"]
    assert main["lines"] == 400 and main["occurrences"] >= 800
    assert 0 < main["bound_ms"] and main["ms"] == out["ms"] > 0
    wide = out["cases"]["4096 wide"]
    assert wide["W"] == 4096 and wide["mismatched_bytes"] == 0
    assert wide["bytes"] > 300 * 4096  # lines of thousands of occurrences


def test_phase_alphabet_rehearsal(chip_smoke, monkeypatch):
    """chip_smoke's phase 4e at 2^12, 2^14 and 2^15 + 3 bytes on the CPU:
    "cuda" resolves to the CPU, so byte_presence runs its twin, CUDA
    events are host clocks, and nvidia-smi is not asked."""
    monkeypatch.setattr(t_engine, "resolve", lambda device:
                        torch.device("cpu"))
    monkeypatch.setattr(chip_smoke.bench, "smi", lambda: "no card")
    report = {}
    chip_smoke.phase_alphabet(_TorchOnCpu(), report,
                              sizes=(2**12, 2**14, 2**15 + 3))
    out = report["alphabet"]
    assert out["mismatches"] == 0 and len(out["cases"]) == 6
    whole = out["cases"]["2^14 from byte 0"]
    assert whole["values"] == [1, 2, 36, 65, 68, 71, 74, 78]
    assert out["cases"]["2^15 from byte 1"]["values"] == \
        [1, 36, 65, 68, 71, 74, 78]
    assert 0 < out["bound_ms"] and out["ms"] == whole["ms"] > 0
    assert out["plain_ms"] == whole["plain_ms"] > 0


def test_phase_scale_rehearsal(chip_smoke, monkeypatch):
    """phase_scale's rows at 8 kbp a document (0.08 / 0.16 Mbp), the bench
    collection at 0.12 / 0.16 Mbp and row f's documents at 1% SNPs, on the
    CPU with the stand-ins of the real-alphabet rehearsal: device "cuda"
    resolves to the CPU, torch.cuda's calls do nothing, the KR wrapper
    counts a launch around its plain version, and the range-min's flat
    index bound (RMQ_FLAT_LIMIT) is lowered to the rehearsal's scale, so
    that row f's dictionary table alone is read level by level, as on the
    card. Row f's refusal is the card's own: a zero-copy text of 2^31
    characters."""
    doc_mbp, bench = DOC_MBP, (0.12, 0.16)
    synth, rb_of = t_bench.synth_collection, t_bench.rb_of
    accepted = [rb_of(synth(n * doc_mbp, n)) for n in (10, 20)] + [
        chip_smoke._bench_rb(m) for m in bench]
    limit = _dict_flat(rb_of(synth(10 * doc_mbp, 10, snp_rate=0.01)))
    assert max(_dict_flat(rb) for rb in accepted) < limit

    def on_cpu(device):
        return torch.device("cpu")

    def counted_plain(ext, n_real, w, mod):
        trace.count(kr_mask.COUNTER)
        return kr_mask.break_mask_plain(ext, n_real, w, mod)
    monkeypatch.setattr(t_engine, "resolve", on_cpu)
    monkeypatch.setattr(t_device, "resolve", on_cpu)
    monkeypatch.setattr(kr_mask, "break_mask", counted_plain)
    _count_scans(monkeypatch)
    monkeypatch.setattr(t_pfp, "RMQ_FLAT_LIMIT", limit)
    # row d2's two worker processes inherit it: two threads each
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    report = {}
    chip_smoke.phase_scale(_TorchOnCpu(), report, doc_mbp=doc_mbp,
                           bench_mbp=bench, dcn_device="cpu")
    out = report["scale"]
    rows = out["rows"]
    assert set(rows) == {"a", "b", "c", "d", "d2", "e 0.12", "e 0.16",
                         "f"}
    for key in ("a", "b", "c", "e 0.16", "f"):
        assert rows[key]["matches"] == rows[key]["baseline_matches"] > 0
    for key in ("a", "b", "c", "e 0.12", "e 0.16", "f"):
        assert _kr_part(rows[key]["launches"]) == {"kr_break_mask": 2,
                                                   "add_one": 0}
        assert rows[key]["launches"]["running_scan"] > 0
        assert (rows[key]["dict_flat"] >= limit) == (key == "f")
        assert rows[key]["dict_levels"] == \
            t_suffix._num_levels(rows[key]["nd"]) + 1
        assert set(rows[key]["stage_peak_bytes"]) == set(
            rows[key]["stages_s"])
    assert rows["a"]["k"] == rows["f"]["k"] == 9
    assert rows["a"]["size_cap"] == 16
    assert rows["b"]["size_cap"] == 32 and rows["c"]["size_cap"] == 32
    assert set(rows["c"]["split_s"]) == {"fasta", "scan", "write"}
    assert rows["d"]["partition_docs"] == [11, 10]
    assert _kr_part(rows["d"]["launches"]) == {"kr_break_mask": 2,
                                               "add_one": 0}
    assert rows["d"]["launches"]["running_scan"] > 0
    assert rows["d"]["only_union"] + rows["d"]["only_merged"] == \
        rows["d"]["terminal_touching_differences"]
    assert rows["d"]["calls"]["merge_fold"] == 1
    assert [r["scanned"] for r in rows["d2"]["ranks"]] == [[0], [1]]
    assert out["kernel"]["mismatches"] == 0 and out["kernel"]["breaks"] > 0
    text = out["refused"]["text"]
    assert text["refused"] and text["text_chars"] >= 2**31
    assert "int32 phrase coordinates" in text["error"]
    assert _kr_part(text["launches"]) == {"kr_break_mask": 0, "add_one": 0}
    # every driven path is in the launch record: 6 scans of 2 runs, the
    # MumemtoM run, the dcn pair (no launch on the CPU), the refusal
    assert len(out["paths"]) == 9
    assert sum(p["kr_break_mask"] for p in out["paths"].values()) == 14
