"""The port's throughput harness (mumemto_tpu_torch/bench.py) on the CPU at
small sizes: its collection against bench.py's bytes, scaled-down
configurations against the JAX package's engine, oracle.naive and
native/baseline_cpu, the record's keys and the last line's, and each way
a run must fail (a count off the record, a failing baseline, no card, an
unknown name), with chip_smoke.py's private names bound to the module's.

Tolerance: exact equality of bytes and counts.
"""

import dataclasses
import importlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from mumemto_tpu import engine as j_engine
from mumemto_tpu import options as j_options
from mumemto_tpu.oracle import naive
from mumemto_tpu.refbuilder import RefBuilder, revcomp
from mumemto_tpu_torch import bench as t_bench
from mumemto_tpu_torch import engine as t_engine
from mumemto_tpu_torch import options as t_options

# several test workers share the machine's cores
torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MBP, DOCS = 0.006, 3
SMALL = ["--mbp", str(MBP), "--docs", str(DOCS), "--device", "cpu",
         "--reps", "3"]
F3 = {"rare_freq": 3, "max_mem_freq": 0}
RECORD_KEYS = {"config", "device", "cards", "mbp", "text_chars", "reps",
               "cold_s", "walls_s", "median_s", "best_s", "max_s", "spread",
               "mbp_per_s", "best_mbp_per_s", "stages_s", "peak_gib",
               "busy_share", "kr_launches", "matches", "expected",
               "baseline", "vs_baseline"}


def _root(name):
    sys.path.insert(0, ROOT)
    try:
        return importlib.import_module(name)
    finally:
        sys.path.remove(ROOT)


def _jax_rb(docs):
    """bench.py's RefBuilder of the documents (the JAX package's class)."""
    pieces, seq_lengths = [], []
    dollar = np.frombuffer(b"$", dtype=np.uint8)
    for fwd in docs:
        pieces += [fwd, dollar, revcomp(fwd), dollar]
        seq_lengths.append(2 * (fwd.size + 1))
    return RefBuilder(text=np.concatenate(pieces), seq_lengths=seq_lengths,
                      num_docs=len(docs), use_revcomp=True, input_files=[],
                      multifasta_names=[], multifasta_lengths=[])


def _lines(capsys):
    return [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines() if line]


def _small(monkeypatch, name, expected):
    """CONFIGS[name] cut to MBP and DOCS, with `expected` on record."""
    cfg = dataclasses.replace(t_bench.CONFIGS[name], mbp=MBP, docs=DOCS,
                              expected=expected)
    monkeypatch.setitem(t_bench.CONFIGS, name, cfg)


def _count(flags, real=False):
    make = t_bench.synth_collection_real if real else t_bench.synth_collection
    rb = t_bench.rb_of(make(MBP, DOCS))
    opts = t_options.normalize(DOCS, quiet=True, **flags)
    return t_engine.find_matches(rb, opts, device="cpu").num_matches


@pytest.mark.parametrize("args", [(0.02, 4, 0, 0.001), (0.003, 3, 2, 0.004),
                                  (0.05, 8, 1, 0.001), (0.4, 2, 7, 0.01)])
def test_synth_collection_is_bench_py(args):
    """The harness's collection is bench.py's, byte for byte."""
    mbp, n_docs, seed, snp = args
    got = t_bench.synth_collection(mbp, n_docs, seed=seed, snp_rate=snp)
    want = _root("bench").synth_collection(mbp, n_docs, seed=seed,
                                           snp_rate=snp)
    assert len(got) == len(want) == n_docs
    assert all(a.tobytes() == b.tobytes() for a, b in zip(got, want))


@pytest.mark.parametrize("name,backend,flags", [
    ("mum8", "pfp", {}), ("f3_8", "pfp", F3), ("g8", "direct", {})])
def test_small_config_matches_jax_and_oracle(capsys, name, backend, flags):
    """A configuration cut to 3 documents of 2 kbp on the CPU: its count
    equals the JAX package's engine and oracle.naive on bench.py's bytes
    and the live baseline's; the record and the last line are whole."""
    assert t_bench.main(["--config", name, *SMALL]) == 0
    rec, last = _lines(capsys)
    rb = _jax_rb(_root("bench").synth_collection(MBP, DOCS))
    opts = j_options.normalize(DOCS, quiet=True, **flags)
    want = j_engine.find_matches(rb, opts, backend=backend,
                                 show_progress=False)
    oracle = naive.oracle_output(rb, opts).count(b"\n")
    assert rec["matches"] == want.num_matches == oracle > 0
    assert rec["baseline"]["matches"] == rec["matches"]
    assert RECORD_KEYS <= set(rec) and rec["config"] == name
    assert rec["best_s"] <= rec["median_s"] <= rec["max_s"]
    assert len(rec["walls_s"]) == rec["reps"] == 3
    assert rec["spread"] == (rec["max_s"] - rec["best_s"]) / rec["median_s"]
    assert rec["text_chars"] == rb.text.size and rec["expected"] is None
    # the CPU: no card, no kernel launch, no device metric
    assert rec["device"] == "cpu" and rec["cards"] == 0
    assert rec["peak_gib"] is None and rec["busy_share"] is None
    assert rec["kr_launches"] == 0 and rec["calls"] == 5
    assert rec["stages_s"] and all(v >= 0 for v in rec["stages_s"].values())
    assert last["value"] == rec["best_mbp_per_s"] == MBP / rec["best_s"]
    assert last["vs_baseline"] == rec["vs_baseline"] > 0
    assert last["unit"] == "Mbp/s" and "mumemto_tpu_torch" in last["metric"]


def test_last_line_has_bench_py_keys(capsys):
    """The last line has the keys of bench.py's emit, and no more."""
    _root("bench").emit(3.0, 1.5)
    want = json.loads(capsys.readouterr().out)
    assert t_bench.main(["--config", "mum8", *SMALL, "--reps", "1"]) == 0
    last = _lines(capsys)[-1]
    assert set(last) == set(want)
    assert isinstance(last["value"], float) and isinstance(
        last["vs_baseline"], float)


@pytest.mark.parametrize("name", ["real8", "iupac8", "M32", "shards8_32",
                                  "c10_k1", "c20_cli", "c20_mtom", "w"])
def test_small_routes_agree_with_baseline(capsys, name):
    """Every other route and collection, cut to 3 documents: the count
    equals a live baseline_cpu run's, and the file routes time their
    calls."""
    assert t_bench.main(["--config", name, *SMALL, "--reps", "1"]) == 0
    rec, _last = _lines(capsys)
    cfg = t_bench.CONFIGS[name]
    assert rec["route"] == cfg.route
    assert rec["matches"] == rec["baseline"]["matches"] > 0
    if cfg.route in t_bench.FILE_ROUTES:
        assert set(rec["calls_s"]) >= {"fasta", "scan", "write"}
        assert ("merge" in rec["calls_s"]) == (cfg.route == "mtom")
    if name == "M32":
        assert "merge" in rec["stages_s"]
    if name == "w":  # written and hashed, held to the baseline's triple
        assert rec["triple"]["matches"] == rec["matches"]
        assert set(rec["stages_s"]) >= {"operands", "sort", "analyze"}


def test_count_off_the_record_stops_the_run(capsys, monkeypatch):
    """The first configuration holds its count, the second does not: the
    first one's line is printed, then the run raises with no last line."""
    _small(monkeypatch, "mum8", _count({}))
    _small(monkeypatch, "f3_8", _count(F3) + 1)
    with pytest.raises(AssertionError, match="f3_8: .* on record"):
        t_bench.main(["--config", "mum8", "f3_8", "--device", "cpu",
                      "--reps", "1", "--no-baseline"])
    lines = _lines(capsys)
    assert [rec.get("config") for rec in lines] == ["mum8"]
    assert lines[0]["matches"] == lines[0]["expected"]
    assert lines[0]["baseline"] is None and lines[0]["vs_baseline"] is None


def test_failing_baseline_stops_the_run(capsys, monkeypatch):
    """A baseline that was asked for and fails is an error, not a
    constant."""
    monkeypatch.setattr(t_bench, "BASELINE_BIN", shutil.which("false"))
    with pytest.raises(AssertionError, match="baseline_cpu failed"):
        t_bench.main(["--config", "mum8", *SMALL, "--reps", "1"])
    assert _lines(capsys) == []


def test_resized_without_baseline_is_refused(capsys):
    """A resized configuration has no count on record, so it needs the
    live baseline."""
    with pytest.raises(ValueError, match="--baseline"):
        t_bench.main(["--config", "mum8", *SMALL, "--no-baseline"])
    assert _lines(capsys) == []


def test_no_card_exits_nonzero_without_a_number():
    """--device cuda (the default) with no visible card: a non-zero exit,
    the device's refusal on stderr, nothing on stdout."""
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    run = subprocess.run(
        [sys.executable, "-m", "mumemto_tpu_torch.bench", "--mbp", "0.006"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode != 0
    assert run.stdout == ""
    assert "CUDA is not available" in run.stderr


def test_unknown_config_is_refused_with_the_names(capsys):
    with pytest.raises(SystemExit) as exit_:
        t_bench.main(["--config", "mum9", "--device", "cpu"])
    assert exit_.value.code != 0
    err = capsys.readouterr()
    assert err.out == ""
    assert "mum9" in err.err and all(n in err.err for n in t_bench.CONFIGS)


def test_config_names_expand_in_order():
    one_card = [n for n, c in t_bench.CONFIGS.items() if c.cards == 1]
    assert "w" not in one_card and one_card[0] == "mum8"
    assert t_bench.parse_args([]).config == ["mum8"]
    assert t_bench.parse_args(["--config", "all-one-card"]).config == \
        one_card
    assert t_bench.parse_args(["--config", "w", "mum32",
                               "all-one-card"]).config == \
        ["w", "mum32"] + [n for n in one_card if n != "mum32"]


def test_env_defaults(monkeypatch):
    """bench.py's MUMEMTO_BENCH_* variables are the flags' defaults."""
    for key, value in (("MBP", "0.5"), ("DOCS", "4"), ("REPS", "2"),
                       ("SNP", "0.01"), ("W", "12"), ("MOD", "50"),
                       ("SEED", "3"), ("VERIFY", "1")):
        monkeypatch.setenv(f"MUMEMTO_BENCH_{key}", value)
    args = t_bench.parse_args([])
    assert (args.mbp, args.docs, args.reps, args.snp, args.w, args.mod,
            args.seed, args.verify) == (0.5, 4, 2, 0.01, 12, 50, 3, True)


def test_verify_checks_the_result(capsys):
    assert t_bench.main(["--config", "mum8", *SMALL, "--reps", "1",
                         "--verify"]) == 0
    rec = _lines(capsys)[0]
    assert rec["verified"] == rec["matches"] > 0


@pytest.mark.parametrize("outer", ["counted", "enabled"])
def test_counted_reads_the_launch_counters(outer):
    """bench.counted counts a call's launches from the trace counters:
    inside another counted call it counts its own and leaves the outer
    call's whole; inside an enabled window it drains nothing; tracing is
    left as it was found."""
    from mumemto_tpu_torch import trace
    from mumemto_tpu_torch.kernels import kr_mask, scan

    def launch(counter, n):
        for _ in range(n):
            trace.count(counter)

    def body():
        launch(kr_mask.COUNTER, 2)
        _, _s, inner = t_bench.counted(torch,
                                       lambda: launch(scan.COUNTER, 3))
        assert inner["running_scan"] == 3 and inner["kr_break_mask"] == 0
        launch(kr_mask.COUNTER, 1)
    trace.disable()
    trace.drain()
    try:
        if outer == "counted":
            _, _s, got = t_bench.counted(torch, body)
            assert (got["kr_break_mask"], got["running_scan"]) == (3, 3)
            assert trace.drain() == {"spans": [], "counters": {}}
            assert trace.span("a") is trace.span("b")  # off again
        else:
            trace.enable()
            with trace.call("engine.find_matches") as root:
                body()
            trace.disable()
            assert trace.drain()["counters"] == {
                root.id: {kr_mask.COUNTER: 3, scan.COUNTER: 3}}
    finally:
        trace.disable()
        trace.drain()


def test_chip_smoke_names_are_the_modules():
    """chip_smoke.py keeps one copy: it calls the harness's helpers as
    bench.<name> and defines none of them, nor an alias of one, itself."""
    chip_smoke = _root("chip_smoke")
    names = ("synth_collection", "synth_collection_real", "rb_of",
             "write_fastas", "build_cpu_baseline", "Baseline", "cpu_baseline",
             "run_cpu_baseline", "triple", "occ_stats", "StageTimer",
             "SumTimer", "Split", "sync_all", "counted", "smi",
             "busy_overlap", "trace_cards", "IUPAC_CODES")
    assert chip_smoke.bench is t_bench
    for name in names:
        assert hasattr(t_bench, name), name
        for own in (name, "_" + name):
            assert not hasattr(chip_smoke, own), own
    assert chip_smoke.EXPECT_8MBP == 6759
    assert chip_smoke.W_BASELINE == {"matches": 61110, "sum_len": 4029012,
                                     "occ_hash": 15288323120970386319}


def test_chip_smoke_phase_bench_rehearsal(monkeypatch):
    """chip_smoke's phase 15 on the CPU, its three configurations cut to 3
    documents with their counts on record: every record held to the count
    and to the live baseline, its launches in the path record."""
    for name, flags, real in (("mum8", {}, False), ("real8", {}, True),
                              ("f3_8", F3, False)):
        _small(monkeypatch, name, _count(flags, real))
    report = {}
    _root("chip_smoke").phase_bench(torch, report, argv=[
        *_root("chip_smoke").BENCH_ARGV, "--device", "cpu"])
    assert list(report["bench"]["records"]) == ["mum8", "real8", "f3_8"]
    assert all(r["reps"] == 3 and r["baseline"]["matches"] == r["matches"]
               for r in report["bench"]["records"].values())
    assert report["bench"]["paths"] == {
        f"bench {n}": {"kr_break_mask": 0, "add_one": 0, "running_scan": 0,
                       "phrase_fingerprint": 0, "phrase_verify": 0,
                       "phrase_tail_rank": 0}
        for n in ("mum8", "real8", "f3_8")}


@pytest.mark.gpu
def test_harness_on_the_card(capsys):
    """mum8 on the card, one timed call: its count on record, one KR launch
    a call, a peak and a busy share measured."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert t_bench.main(["--config", "mum8", "--reps", "1",
                         "--no-baseline"]) == 0
    rec, last = _lines(capsys)
    assert rec["matches"] == rec["expected"] == 6759
    assert rec["kr_launches"] == 1 and rec["calls"] == 4
    assert rec["cards"] == 1 and rec["peak_gib"][0] > 0
    assert 0 < rec["busy_share"] <= 1
    assert torch.cuda.get_device_name(0) in last["metric"]
