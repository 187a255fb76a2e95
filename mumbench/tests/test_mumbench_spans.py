"""The readers of the program's spans and counters (mumbench/spans.py and
the metrics that read through it): on records made by hand; the card's
idle time inside a span on a trace made by hand; a traced CPU run of each
cell reports the cell's span and counter metrics; and with the program's
trace module hidden from the readers, as in a program older than it, the
run reports exactly the metrics it reported before."""

import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH_DIR)
for _p in (ROOT, BENCH_DIR):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import run  # noqa: E402
import spans  # noqa: E402

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)
CELLS = [w["name"] for w in BENCH["workloads"]]
PROGRAM = ("program_span", "program_counter")
# the per-layer metrics that read no span or counter of the program
BEFORE = {"engine.emit_s", "pfp.build_s", "pfp.dict_s",
          "pfp.expand_sort_analyze_s", "direct.scan_s",
          "kr_mask.roofline_pct", "device.idle_pct"}
NEW = [m for m in BENCH["per_layer"] if m["name"] not in BEFORE]


def _reader(name):
    return run.load_module(os.path.join(BENCH_DIR, "metrics", name + ".py"),
                           "t_" + name.replace(".", "_"))


def _kept():
    """trace.drain()'s form: two calls (roots 1 and 5), a span outside
    any call (9), and a counter outside any call."""
    def s(i, name, a, b, parent, call):
        return {"id": i, "name": name, "start_ns": a, "end_ns": b,
                "parent": parent, "call": call, "thread": 1}
    return {"spans": [
        s(1, spans.ROOT, 0, 10**9, None, 1),
        s(2, "pfp.build", 0, 6 * 10**8, 1, 1),
        s(3, "pfp.build.sort", 10**8, 4 * 10**8, 2, 1),
        s(4, "pfp.build.records", 4 * 10**8, 5 * 10**8, 2, 1),
        s(5, spans.ROOT, 2 * 10**9, 3 * 10**9, None, 5),
        s(6, "pfp.build", 2 * 10**9, 26 * 10**8, 5, 5),
        s(7, "pfp.build.sort", 21 * 10**8, 22 * 10**8, 6, 5),
        s(8, "pfp.build.records", 22 * 10**8, 23 * 10**8, 6, 5),
        s(10, "pfp.build.records", 24 * 10**8, 25 * 10**8, 6, 5),
        s(9, "native.load", 5 * 10**9, 6 * 10**9, None, None)],
        "counters": {1: {"engine.readbacks": 40},
                     5: {"engine.readbacks": 42},
                     None: {"engine.readbacks": 7}}}


def test_summed_keeps_the_calls_alone():
    got = spans.summed(_kept())
    assert got["traced_calls"] == 2
    assert got["spans"]["pfp.build"] == pytest.approx(1.2)
    assert got["spans"]["pfp.build.sort"] == pytest.approx(0.4)
    assert got["spans"]["pfp.build.records"] == pytest.approx(0.3)
    assert "native.load" not in got["spans"]
    assert got["counters"] == {"engine.readbacks": 82}


def test_span_readers_on_records_made_by_hand():
    prof = {"window_s": 2.0, "busy_s": 1.0, "calls": 2,
            "device_ops": {}, "idle_gaps": {}}
    prof.update(spans.summed(_kept()))
    rec = {"profile": prof}
    assert _reader("pfp.build.sort_s").read(rec) == pytest.approx(0.2)
    assert _reader("pfp.build.records_s").read(rec) == pytest.approx(0.15)
    assert _reader("engine.readbacks").read(rec) == 41.0
    assert isinstance(_reader("engine.readbacks").read(rec), float)
    for m in NEW:  # a span no call opened reads nothing
        if m["name"] not in ("pfp.build.sort_s", "pfp.build.records_s",
                             "engine.readbacks"):
            assert _reader(m["name"]).read(rec) is None, m["name"]
    assert _reader("pfp.build.sort_s").read({"profile": None}) is None
    empty = dict(prof, **spans.summed({"spans": [], "counters": {}}))
    assert _reader("engine.readbacks").read({"profile": empty}) is None


def test_each_new_metric_reads_the_program():
    for m in NEW:
        assert m["source"] in PROGRAM and m["moves"] == "mbp_per_s"
        assert os.path.exists(os.path.join(BENCH_DIR, "metrics",
                                           m["name"] + ".py"))


def test_span_idle_on_a_trace_made_by_hand():
    """Card 0 busy 100-160, 400-500 and 600-630 us, card 1 busy 0-10 us;
    pfp.dict_index spans 150-450 and 590-700 (idle 240 + 80 us), a
    nested part 200-300 (all idle), a span on no card's work 800-900."""
    ev = [
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 100, "dur": 50,
         "args": {"device": 0}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 140,
         "dur": 20, "args": {"device": 0}},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 400, "dur": 100,
         "args": {"device": 0}},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 600,
         "dur": 30, "args": {"device": 0}},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 0, "dur": 10,
         "args": {"device": 1}},
        {"ph": "X", "cat": "user_annotation", "name": "pfp.dict_index",
         "ts": 150, "dur": 300},
        {"ph": "X", "cat": "user_annotation", "name": "pfp.dict_index",
         "ts": 590, "dur": 110},
        {"ph": "X", "cat": "user_annotation", "name": "part", "ts": 200,
         "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "late", "ts": 800,
         "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::sort", "ts": 150,
         "dur": 300},
    ]
    got = spans.span_idle(ev)
    assert got == {"pfp.dict_index": pytest.approx(320e-6),
                   "part": pytest.approx(100e-6),
                   "late": pytest.approx(100e-6)}
    assert spans.span_idle(ev, names={"part"}) == {
        "part": pytest.approx(100e-6)}
    assert spans.span_idle([e for e in ev if "args" not in e]) == {}


CPU_RUN = """
import json, sys
sys.path.insert(0, {bench!r})
import torch
torch.set_num_threads(2)
from mumemto_tpu_torch import engine
if {hide!r}:
    # the readers cannot import the module; the program keeps its own
    sys.modules["mumemto_tpu_torch.trace"] = None
import run
result, checks = run.execute({cell!r}, {seed!r}, 1.0, 1, device="cpu",
                             config_override={{"total_mbp": 0.03}})
print(json.dumps(result))
"""


def _traced_cpu_run(cell, hide):
    code = CPU_RUN.format(bench=BENCH_DIR, cell=cell, seed=2**33 + 29,
                          hide=hide)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_cpu_run_reports_the_cells_span_metrics(cell):
    result = _traced_cpu_run(cell, False)
    assert result["correct"] is True
    got = result["metrics"]
    for m in NEW:
        if cell in m["workloads"]:
            assert m["name"] in got, m["name"]
            assert got[m["name"]]["unit"] == m["unit"]
            assert got[m["name"]]["value"] > 0
        else:
            assert m["name"] not in got, m["name"]
    # a CPU run has no device metric
    assert not any(m["source"] == "device_trace" and m["name"] in got
                   for m in BENCH["per_layer"])


@pytest.mark.parametrize("cell", CELLS)
def test_without_the_trace_module_the_run_reports_what_it_did(cell):
    result = _traced_cpu_run(cell, True)
    assert result["correct"] is True
    want = {m["name"] for m in BENCH["per_layer"]
            if m["name"] in BEFORE and m["source"] != "device_trace"
            and cell in m["workloads"]}
    assert set(result["metrics"]) == want
