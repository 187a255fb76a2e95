"""mumbench/run.py on the CPU at a tiny size: a run of every cell prints
the contract's keys with `correct` true and loads no module whose
top-level name is jax, jaxlib, flax or mumemto_tpu (compared whole: the
program's mumemto_tpu_torch is not one); the timed path broken underneath
(an answer altered where it is produced, half of the answers left out)
turns `correct` false; without a card, or without the program beside it,
the run exits non-zero and prints no result; the trace reader and the
metric readers on records made by hand. One `gpu` test runs a short window
of each cell on the card."""

import json
import os
import shutil
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH_DIR)
for _p in (ROOT, BENCH_DIR):
    sys.path.insert(0, _p)

import run  # noqa: E402

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)
CELLS = [w["name"] for w in BENCH["workloads"]]
TINY = {"total_mbp": 0.03}
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]
DEVICE_KEYS = {"platform", "kind", "count", "memory_peak_bytes"}
BANNED = ("jax", "jaxlib", "flax", "mumemto_tpu")

CPU_RUN = """
import json, sys
sys.path.insert(0, {bench!r})
import torch
torch.set_num_threads(2)
import run
result, checks = run.execute({cell!r}, {seed!r}, {seconds!r}, {trace!r},
                             device="cpu", config_override={tiny!r})
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}}
                        & set({banned!r}))))
print(json.dumps(result))
"""


def _cpu_run(cell, seed, seconds, trace):
    code = CPU_RUN.format(bench=BENCH_DIR, cell=cell, seed=seed,
                          seconds=seconds, trace=trace, tiny=TINY,
                          banned=BANNED)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    return json.loads(lines[-2]), json.loads(lines[-1])


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_a_cpu_run_of_each_cell(cell, trace):
    banned, result = _cpu_run(cell, 2**33 + 17, 1.0, trace)
    assert banned == []
    keys = list(result)
    assert keys[:5] == RESULT_KEYS and keys[-1] == "checks"
    assert set(keys) <= set(RESULT_KEYS) | {"breakdown", "checks"}
    assert result["correct"] is True
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert DEVICE_KEYS <= set(result["device"])
    for c in result["checks"].values():
        assert c["value"] <= c["limit"]
    spec = run.cell_spec(cell)
    want = spec["per_layer"] if trace else spec["end_to_end"]
    for name, m in result["metrics"].items():
        entry = next(x for x in want if x["name"] == name)
        assert m["unit"] == entry["unit"] and isinstance(m["value"], float)
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        # a CPU run has no device metric: the device readers give nothing
        assert "device.idle_pct" not in result["metrics"]
        assert "kr_mask.roofline_pct" not in result["metrics"]
    else:
        # host-clock metrics are there; peak_gib needs a card
        assert {"mbp_per_s", "setup_s"} <= set(result["metrics"])


def _altered(results):
    if results.opts.mum_mode:
        results.lengths = results.lengths.copy()
        results.lengths[len(results.lengths) // 2] += 1
    else:
        results.mem_lines = list(results.mem_lines)
        line = results.mem_lines[0].split(b"\t", 1)
        results.mem_lines[0] = b"%d\t" % (int(line[0]) + 1) + line[1]
    return results


def _half(results):
    if results.opts.mum_mode:
        h = len(results.lengths) // 2
        results.lengths = results.lengths[:h]
        results.offsets = results.offsets[:h]
        results.strands = results.strands[:h]
    else:
        results.mem_lines = results.mem_lines[:len(results.mem_lines) // 2]
    return results


@pytest.mark.parametrize("fault", ["altered", "half"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(cell, fault):
    import torch
    torch.set_num_threads(2)
    from mumemto_tpu_torch import engine
    broken = {"altered": _altered, "half": _half}[fault]

    def find(*a, **kw):
        return broken(engine.find_matches(*a, **kw))
    result, checks = run.execute(cell, 5, 0.5, 0, device="cpu",
                                 config_override=TINY, find=find)
    assert result["correct"] is False
    assert checks["mismatched_matches"]["value"] > 0


def test_a_failing_call_is_counted_and_not_correct():
    from mumemto_tpu_torch import engine
    calls = []

    def find(*a, **kw):
        calls.append(1)
        if len(calls) == 4:
            raise RuntimeError("CUDA out of memory (planted)")
        return engine.find_matches(*a, **kw)
    result, checks = run.execute(CELLS[0], 5, 5.0, 0, device="cpu",
                                 config_override=TINY, find=find)
    assert result["correct"] is False
    assert result["failed"] == 1 and checks["failed_calls"]["value"] == 1


def test_whole_top_level_names_are_compared(monkeypatch):
    import types
    monkeypatch.setitem(sys.modules, "mumemto_tpu_torch_fake",
                        types.ModuleType("mumemto_tpu_torch_fake"))
    monkeypatch.setitem(sys.modules, "jaxtyping_fake",
                        types.ModuleType("jaxtyping_fake"))
    assert run.banned_modules() == []
    monkeypatch.setitem(sys.modules, "mumemto_tpu.engine",
                        types.ModuleType("mumemto_tpu.engine"))
    assert run.banned_modules() == ["mumemto_tpu"]


@pytest.mark.parametrize("mix", ["mum", "mem_f3"])
def test_equal_digests_mean_equal_bytes(mix):
    """Calls are judged once per distinct digest: equal results share one,
    and an altered answer or half the answers left out get another."""
    import copy

    import torch
    torch.set_num_threads(2)
    from mumemto_tpu_torch import engine
    got = {}

    def find(*a, **kw):
        out = engine.find_matches(*a, **kw)
        got.setdefault("out", out)
        return out
    cell = next(w["name"] for w in BENCH["workloads"] if w["traffic"] == mix)
    run.execute(cell, 9, 0.2, 0, device="cpu", config_override=TINY,
                find=find)
    out = got["out"]
    same = copy.deepcopy(out)
    assert run.result_digest(same) == run.result_digest(out)
    assert same.output_bytes() == out.output_bytes()
    for broken in (_altered, _half):
        other = broken(copy.deepcopy(out))
        assert other.output_bytes() != out.output_bytes()
        assert run.result_digest(other) != run.result_digest(out)


def test_a_module_loaded_after_the_window_is_caught(monkeypatch, capsys):
    """A banned module that the reference or a metric reader loads, after
    the window, still stops the result from being printed."""
    import types

    import torch

    def execute(*a, **kw):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return {"correct": True}, {}
    monkeypatch.setattr(run, "execute", execute)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    out = capsys.readouterr()
    assert rc == 1 and out.out == ""
    assert "loaded in this process: jax" in out.err


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    out = subprocess.run(
        [sys.executable, "mumbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 2 and out.stdout == ""
    assert "needs 1 CUDA card" in out.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "mumbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "mumbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""


def _trace_file(tmp_path):
    """Three kernels and a copy (busy 100-160, 400-500 and 600-630 us),
    three nested host operations; idle 160-400 and 500-600 us."""
    ev = [
        {"ph": "X", "cat": "kernel", "name": "void kr::break_mask_kernel"
         "<false>(unsigned char const*)", "ts": 100, "dur": 50,
         "args": {"device": 0}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> "
         "Pageable)", "ts": 140, "dur": 20, "args": {"device": 0}},
        {"ph": "X", "cat": "kernel", "name": "sortKernel<int>(int*)",
         "ts": 400, "dur": 100, "args": {"device": 0}},
        {"ph": "X", "cat": "kernel", "name": "void kr::break_mask_kernel"
         "<false>(unsigned char const*)", "ts": 600, "dur": 30,
         "args": {"device": 0}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 150,
         "dur": 200},
        {"ph": "X", "cat": "cpu_op", "name": "aten::to", "ts": 150,
         "dur": 300},
        {"ph": "X", "cat": "cpu_op", "name": "aten::sort", "ts": 390,
         "dur": 20},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return str(path)


def test_read_trace(tmp_path):
    got = run.read_trace(_trace_file(tmp_path))
    assert got["busy_s"] == {0: pytest.approx(190e-6)}
    assert got["device_ops"]["void kr::break_mask_kernel<false>"] == [
        pytest.approx(80e-6), 2]
    # the gap 160-400 us: aten::sort (innermost) 390-400, aten::copy_
    # 160-350, aten::to the rest; the gap 500-600 us under no host operation
    gaps = got["idle_gaps"]
    assert gaps["aten::sort"] == [pytest.approx(10e-6), 1]
    assert gaps["aten::copy_"] == [pytest.approx(190e-6), 1]
    assert gaps["aten::to"] == [pytest.approx(40e-6), 1]
    assert gaps[run.OUTSIDE] == [pytest.approx(100e-6), 1]


def test_short_kernel_names():
    assert run.short_name("void at::native::(anonymous namespace)::f<int>"
                          "(int*, float)") == \
        "void at::native::(anonymous namespace)::f<int>"
    assert run.short_name("Memcpy HtoD (Pageable -> Device)") == \
        "Memcpy HtoD (Pageable -> Device)"
    assert len(run.short_name("k<" + "x" * 400 + ">(int)")) == 160


def _reader(name):
    return run.load_module(os.path.join(BENCH_DIR, "metrics", name + ".py"),
                       "t_" + name.replace(".", "_"))


def test_metric_readers_on_records_made_by_hand(tmp_path):
    got = run.read_trace(_trace_file(tmp_path))
    rec = {"card": "NVIDIA H100 80GB HBM3", "n_text": 64_000_016, "w": 10,
           "mbp": 32.0, "setup_s": 9.5, "peak_bytes": 3 * 2**30,
           "calls": [{"start": 1.0, "end": 2.5, "ok": True},
                     {"start": 2.5, "end": 4.0, "ok": True}],
           "stages": [{"build_pfp": 0.5, "emit": 0.1, "dict_index": 0.2,
                       "parse_side": 0.1},
                      {"build_pfp": 0.7, "emit": 0.1, "dict_index": 0.2,
                       "parse_side": 0.1}],
           "profile": {"window_s": 1e-3, "busy_s": 2e-4,
                       "device_ops": got["device_ops"],
                       "idle_gaps": got["idle_gaps"]}}
    assert _reader("mbp_per_s").read(rec) == pytest.approx(64 / 3)
    assert _reader("peak_gib").read(rec) == 3
    assert _reader("setup_s").read(rec) == 9.5
    assert _reader("pfp.build_s").read(rec) == pytest.approx(0.6)
    assert _reader("pfp.dict_s").read(rec) == pytest.approx(0.3)
    assert _reader("engine.emit_s").read(rec) == pytest.approx(0.1)
    assert _reader("direct.scan_s").read(rec) is None
    assert _reader("device.idle_pct").read(rec) == pytest.approx(80)
    # 2 * (64_000_016 + 11) + 4 bytes at 3.35e12 B/s over 40 us a launch
    want = 100 * (2 * 64_000_027 + 4) / 3.35e12 / 40e-6
    assert _reader("kr_mask.roofline_pct").read(rec) == pytest.approx(want)
    assert _reader("kr_mask.roofline_pct").read(dict(rec, card="cpu")) \
        is None
    assert _reader("device.idle_pct").read(dict(rec, profile=None)) is None


@pytest.mark.gpu
def test_a_short_window_of_each_cell_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    for cell in CELLS:
        out = subprocess.run(
            [sys.executable, "mumbench/run.py", "--workload", cell,
             "--seed", str(2**31 + 11), "--seconds", "3", "--trace", "0"],
            capture_output=True, text=True, timeout=600, cwd=ROOT)
        assert out.returncode == 0, out.stderr[-3000:]
        result = json.loads(out.stdout.strip().splitlines()[-1])
        assert result["correct"] is True, out.stderr[-3000:]
        assert result["device"]["platform"] == "gpu"
        assert set(result["metrics"]) == {"mbp_per_s", "peak_gib",
                                          "setup_s"}
