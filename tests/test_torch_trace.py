"""mumemto_tpu_torch.trace: spans and counters of the port's own work.

Off by default (a call records nothing, every span is one shared no-op);
the span tree of a call on every route (one root, the stages in the phase
hook's order, each part under its stage, children inside their parents,
every span closed, also when the call raises); spans opened on
run_per_device's worker threads nest in their own thread; the spans'
copies in a torch.profiler trace lie on the same clock; the
engine.readbacks counter repeats and equals the device-to-host copies the
call makes, counted here by hand at the Python level (on the card, by the
trace's copies). The phase hook's names and order do not change with
tracing on.

Tolerance: none (names, order, counts and bytes equal), but for the
clock: a span's profiler copy within 1 ms of its own stamps.
"""

import dataclasses
import json
import threading

import numpy as np
import pytest
import torch

from mumemto_tpu_torch import engine, native, options, trace
from mumemto_tpu_torch.ops import pfp as ops_pfp
from mumemto_tpu_torch.parallel import mesh, seqpfp
from mumemto_tpu_torch.refbuilder import build_from_sequences

# several test workers share the machine's cores
torch.set_num_threads(2)

ROOT = "engine.find_matches"
# stage span -> the phase hook's name for it
STAGES = {
    "pfp.build": "build_pfp", "pfp.read_parse": "read_parse",
    "pfp.dict_index": "dict_index", "pfp.parse_side": "parse_side",
    "pfp.expand_sort_analyze": "expand_sort_analyze",
    "direct.suffix_array": "suffix_array", "direct.lcp": "lcp",
    "direct.analyze": "analyze", "engine.arrays_out": "arrays_out",
    "engine.compact": "compact", "engine.emit": "emit",
    "engine.merge": "merge",
}
# a part -> the spans it may open under
PARTS = {
    "pfp.build.text": {"pfp.build"}, "pfp.build.breaks": {"pfp.build"},
    "pfp.build.sort": {"pfp.build"}, "pfp.build.records": {"pfp.build"},
    "pfp.alphabet": {"pfp.build", "pfp.read_parse", ROOT},
    "direct.text": {ROOT},
    "engine.emit_mems.positions": {"engine.emit"},
    "engine.emit_mems.format": {"engine.emit"},
    "engine.emit_mems.join": {"engine.emit"},
    "kernels.load": {"pfp.build.breaks", "pfp.build.sort"},
    "pfp.rmq": {"pfp.parse_side", "pfp.expand_sort_analyze"},
}
PFP = ["build_pfp", "dict_index", "parse_side", "expand_sort_analyze"]
DIRECT = ["suffix_array", "lcp", "analyze"]
# route -> (options, backend, -A, -p, the hook's names in order)
ROUTES = {
    "mum": ({}, "pfp", False, False, PFP + ["compact", "emit"]),
    "mem_f3": ({"rare_freq": 3}, "pfp", False, False,
               PFP + ["compact", "emit"]),
    "partial_k1": ({"num_distinct_docs": -1}, "pfp", False, False,
                   PFP + ["compact", "emit"]),
    "merge": ({"merge": True}, "pfp", False, False,
              PFP + ["compact", "emit", "merge"]),
    "direct": ({}, "direct", False, False, DIRECT + ["compact", "emit"]),
    "direct_mem": ({"rare_freq": 3}, "direct", False, False,
                   DIRECT + ["compact", "emit"]),
    "arrays_out": ({}, "pfp", True, False,
                   PFP + ["arrays_out", "compact", "emit"]),
    "read_parse": ({}, "pfp", False, True,
                   ["read_parse"] + PFP[1:] + ["compact", "emit"]),
}


@pytest.fixture(autouse=True)
def _clean():
    """Each test starts and ends with tracing off and nothing kept."""
    trace.disable()
    trace.drain()
    yield
    trace.disable()
    trace.drain()


def _rb(seed=7, n_docs=4, base_len=900):
    rng = np.random.default_rng(seed)
    base = "".join(rng.choice(list("ACGT"), base_len))
    rep = "".join(rng.choice(list("ACGT"), 40))
    docs = []
    for _ in range(n_docs):
        s = list(base)
        for _ in range(6):
            s[int(rng.integers(0, len(s)))] = str(rng.choice(list("ACGT")))
        s = "".join(s)
        docs.append([s[:300] + rep + s[300:600] + rep + s[600:]])
    return build_from_sequences(docs, use_revcomp=True)


def _call(route, tmp_path, device="cpu", phase=None, rb=None):
    kw, backend, arrays_out, resume, _ = ROUTES[route]
    rb = rb or _rb()
    opts = options.normalize(rb.num_docs, quiet=True, **kw)
    extra = {}
    if arrays_out:
        extra["arrays_out_prefix"] = str(tmp_path / "ck")
    if resume:
        prefix = str(tmp_path / "pp")
        if not (tmp_path / "pp.parse").exists():
            ops_pfp.write_parse_files(rb, prefix, torch.device(device))
        rb = dataclasses.replace(rb, text=None)
        extra["parse_prefix"] = prefix
    return engine.find_matches(rb, opts, device=device, backend=backend,
                               phase=phase, show_progress=False, **extra)


def _tree(spans):
    by_id = {s["id"]: s for s in spans}
    return by_id, {s["id"]: by_id.get(s["parent"]) for s in spans}


# --- off by default -----------------------------------------------------------

def test_off_by_default_records_nothing(tmp_path):
    out = _call("mum", tmp_path)
    assert out.num_matches > 0
    assert trace.drain() == {"spans": [], "counters": {}}
    assert trace.span("a") is trace.span("b") is trace.call(ROOT)
    assert trace.count("x") is None
    with trace.span("a") as s:
        assert s is None
    assert trace.drain() == {"spans": [], "counters": {}}


def test_enable_and_disable(tmp_path):
    trace.enable()
    assert trace.span("a") is not trace.span("a")
    trace.disable()
    assert trace.span("a") is trace.span("b")
    trace.enable()
    with trace.call("c"):
        trace.count("n", 3)
    trace.disable()
    with trace.call("c"):
        trace.count("n", 5)
    got = trace.drain()
    assert [s["name"] for s in got["spans"]] == ["c"]
    assert got["counters"] == {got["spans"][0]["id"]: {"n": 3}}
    assert trace.drain() == {"spans": [], "counters": {}}


# --- the span tree of a call -------------------------------------------------

@pytest.mark.parametrize("route", list(ROUTES))
def test_span_tree_of_a_call(route, tmp_path):
    seen = []
    _call(route, tmp_path)  # the -p route writes its files first
    trace.enable()
    out = _call(route, tmp_path, phase=seen.append)
    trace.disable()
    got = trace.drain()
    spans = got["spans"]
    assert out.num_matches > 0
    roots = [s for s in spans if s["name"] == ROOT]
    assert len(roots) == 1 and spans[0] is roots[0]
    root = roots[0]
    assert root["parent"] is None
    by_id, parent = _tree(spans)
    me = threading.get_ident()
    for s in spans:
        assert s["end_ns"] is not None, s["name"]
        assert s["call"] == root["id"] and s["thread"] == me
        p = parent[s["id"]]
        if p is not None:
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= p["end_ns"], (s["name"], p["name"])
        if s["name"] in STAGES:
            assert p is root, s["name"]
        elif s["name"] in PARTS:
            assert p["name"] in PARTS[s["name"]], (s["name"], p["name"])
        else:
            assert s is root, f"a span no test knows: {s['name']}"
    stages = [STAGES[s["name"]] for s in spans if s["name"] in STAGES]
    assert stages == seen == ROUTES[route][4]
    names = {s["name"] for s in spans}
    if ROUTES[route][1] == "pfp" and not ROUTES[route][3]:
        assert {"pfp.build.text", "pfp.alphabet", "pfp.build.breaks",
                "pfp.build.sort", "pfp.build.records"} <= names
    if ROUTES[route][1] == "direct":
        assert {"direct.text", "pfp.alphabet"} <= names
    pfp = ROUTES[route][1] == "pfp"
    assert ("pfp.rmq" in names) == pfp
    assert (ops_pfp.RMQ_BYTES in got["counters"][root["id"]]) == pfp
    mem = "rare_freq" in ROUTES[route][0]
    assert ({"engine.emit_mems.positions", "engine.emit_mems.format",
             "engine.emit_mems.join"} <= names) == mem
    assert set(got["counters"]) == {root["id"]}
    assert got["counters"][root["id"]][trace.READBACKS] > 0


@pytest.mark.parametrize("where", ["pfp.build.sort", "engine.emit"])
def test_a_raising_call_closes_its_spans(where, tmp_path, monkeypatch):
    def boom(*a, **kw):
        raise RuntimeError("planted")
    if where == "pfp.build.sort":
        monkeypatch.setattr(ops_pfp, "sort_phrases", boom)
        route = "mum"
    else:
        monkeypatch.setattr(engine, "_emit_mems", boom)
        route = "mem_f3"
    trace.enable()
    with pytest.raises(RuntimeError, match="planted"):
        _call(route, tmp_path)
    with trace.span("after"):
        pass
    trace.disable()
    spans = trace.drain()["spans"]
    assert all(s["end_ns"] is not None for s in spans)
    assert spans[-1]["name"] == "after" and spans[-1]["parent"] is None
    _, parent = _tree(spans)
    last = [s for s in spans if s["name"] == where][-1]
    assert parent[last["id"]]["name"] in ("pfp.build", ROOT)


# the hook's names on each route as the parent commit's code gave them,
# before stages were trace.stage spans
PARENT_HOOKS = {
    "mum": ["build_pfp", "dict_index", "parse_side", "expand_sort_analyze",
            "compact", "emit"],
    "mem_f3": ["build_pfp", "dict_index", "parse_side",
               "expand_sort_analyze", "compact", "emit"],
    "partial_k1": ["build_pfp", "dict_index", "parse_side",
                   "expand_sort_analyze", "compact", "emit"],
    "merge": ["build_pfp", "dict_index", "parse_side", "expand_sort_analyze",
              "compact", "emit", "merge"],
    "direct": ["suffix_array", "lcp", "analyze", "compact", "emit"],
    "direct_mem": ["suffix_array", "lcp", "analyze", "compact", "emit"],
    "arrays_out": ["build_pfp", "dict_index", "parse_side",
                   "expand_sort_analyze", "arrays_out", "compact", "emit"],
    "read_parse": ["read_parse", "dict_index", "parse_side",
                   "expand_sort_analyze", "compact", "emit"],
    "seq_sharded": ["build_pfp", "dict_index", "parse_side", "operands",
                    "sort", "analyze", "assemble"],
}
SEQ_ROOT = "parallel.find_matches_seq_sharded"
# the sharded call's stage spans, in the order of its hook's names
SEQ_STAGES = ["pfp.build", "pfp.dict_index", "pfp.parse_side",
              "wide.operands", "wide.sort", "wide.analyze", "wide.assemble"]


def _seq_call(phase=None):
    rb = _rb()
    opts = options.normalize(rb.num_docs, quiet=True)
    return seqpfp.find_matches_seq_sharded(
        rb, opts, mesh.seq_devices(2, "cpu"), phase=phase)


@pytest.mark.parametrize("route", list(PARENT_HOOKS))
def test_phase_hook_names_are_those_of_the_parent(route, tmp_path):
    """The hook gets the same names in the same order with tracing off and
    on, and they are the names it got before stages were trace.stage
    spans; on the sharded route each comes where its stage span ends."""
    run = _seq_call if route == "seq_sharded" else \
        lambda phase: _call(route, tmp_path, phase=phase)
    if route == "read_parse":
        _call(route, tmp_path)  # writes the -p files
    off, on = [], []
    a = run(off.append)
    trace.enable()
    b = run(on.append)
    trace.disable()
    assert off == on == PARENT_HOOKS[route]
    assert a.output_bytes() == b.output_bytes()
    if route == "seq_sharded":
        spans = trace.drain()["spans"]
        root = spans[0]
        assert root["name"] == SEQ_ROOT and root["parent"] is None
        stages = [s["name"] for s in spans if s["parent"] == root["id"]
                  and s["name"] in SEQ_STAGES]
        assert stages == SEQ_STAGES


# --- stages and their hook --------------------------------------------------

@pytest.mark.parametrize("on", [False, True])
def test_stage_calls_the_calls_hook(on):
    """A stage calls the hook of the call it runs under, once, where its
    span ends, on its own thread, with tracing off and on; outside a call
    or in a call without a hook it calls none."""
    seen = []
    if on:
        trace.enable()
    with trace.stage("s0", "none"):
        pass
    with trace.call(ROOT, hook=lambda n: seen.append(
            (n, threading.get_ident()))):
        with trace.stage("s1", "one"):
            assert seen == []
        with trace.stage("s2", "two"):
            pass
    with trace.call(ROOT):
        with trace.stage("s3", "three"):
            pass
    trace.disable()
    me = threading.get_ident()
    assert seen == [("one", me), ("two", me)]
    spans = trace.drain()["spans"]
    names = ["s0", ROOT, "s1", "s2", ROOT, "s3"] if on else []
    assert [s["name"] for s in spans] == names
    if on:
        assert spans[2]["parent"] == spans[3]["parent"] == spans[1]["id"]


@pytest.mark.parametrize("on", [False, True])
def test_a_raising_stage_calls_no_hook(on):
    seen = []
    if on:
        trace.enable()
    with pytest.raises(RuntimeError, match="planted"):
        with trace.call(ROOT, hook=seen.append):
            with trace.stage("ok", "ok"):
                pass
            with trace.stage("bad", "bad"):
                raise RuntimeError("planted")
    trace.disable()
    assert seen == ["ok"]
    spans = trace.drain()["spans"]
    assert all(s["end_ns"] is not None for s in spans)
    assert [s["name"] for s in spans] == ([ROOT, "ok", "bad"] if on else [])


def test_a_hooked_call_with_tracing_off_records_nothing(tmp_path):
    """Off, a call with a hook keeps the hook alone: the hook runs, and
    there is nothing to drain; without a hook the call and its stages are
    the shared no-op context."""
    seen = []
    assert trace.stage("a", "b") is trace.call(ROOT) is trace.span("c")
    assert trace.call(ROOT, hook=seen.append) is not trace.span("c")
    _call("mum", tmp_path, phase=seen.append)
    _seq_call(seen.append)
    assert seen == PARENT_HOOKS["mum"] + PARENT_HOOKS["seq_sharded"]
    assert trace.drain() == {"spans": [], "counters": {}}


# --- threads -----------------------------------------------------------------

CPU = torch.device("cpu")
MESHES = {"inline": [CPU, CPU], "two": [CPU, torch.device("cpu:0")],
          "four": [CPU, torch.device("cpu:0")] * 2}


@pytest.mark.parametrize("shape", list(MESHES))
def test_worker_spans_nest_in_their_own_thread(shape):
    devices = MESHES[shape]

    def work(i):
        with trace.span("outer"):
            with trace.span("inner"):
                trace.count("items")
        return threading.get_ident()

    trace.enable()
    with trace.call(ROOT):
        threads = mesh.run_per_device(work, range(len(devices)), devices)
    trace.disable()
    got = trace.drain()
    spans = got["spans"]
    by_id, parent = _tree(spans)
    root = spans[0]
    assert root["name"] == ROOT
    outers = [s for s in spans if s["name"] == "outer"]
    inners = [s for s in spans if s["name"] == "inner"]
    assert len(outers) == len(inners) == len(devices)
    assert {s["thread"] for s in outers} == set(threads)
    for s in inners:
        p = parent[s["id"]]
        assert p["name"] == "outer" and p["thread"] == s["thread"]
    for s in outers:
        want = root if s["thread"] == root["thread"] else None
        assert parent[s["id"]] is want
    assert all(s["call"] == root["id"] for s in spans)
    assert got["counters"] == {root["id"]: {"items": len(devices)}}


def test_many_threads_lose_no_span_and_no_count():
    """16 threads (more than the cores a test worker has) open spans and
    count under one call with a short switch interval: every span is
    kept, nests in its own thread, and no count is lost."""
    import sys
    n_threads, n = 16, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n):
                with trace.span("outer"):
                    with trace.span("inner"):
                        trace.count("items")

        trace.enable()
        with trace.call(ROOT):
            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
        trace.disable()
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    got = trace.drain()
    spans = got["spans"]
    root = spans[0]
    assert len(spans) == 1 + 2 * n_threads * n
    assert got["counters"] == {root["id"]: {"items": n_threads * n}}
    _, parent = _tree(spans)
    for s in spans[1:]:
        p = parent[s["id"]]
        if s["name"] == "inner":
            assert p["name"] == "outer" and p["thread"] == s["thread"]
        else:
            assert p is None and s["call"] == root["id"]


# --- the profiler's clock ------------------------------------------------------

def test_profiler_copies_share_the_clock(tmp_path):
    """Under a torch.profiler a call is traced without enable(), and each
    span's record_function copy in the exported chrome trace lies within
    1 ms of the span's own stamps; outside it, nothing is kept."""
    from torch.profiler import ProfilerActivity, profile
    rb = _rb()
    opts = options.normalize(rb.num_docs, quiet=True, rare_freq=3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.find_matches(rb, opts, device="cpu", show_progress=False)
    engine.find_matches(rb, opts, device="cpu", show_progress=False)
    spans = trace.drain()["spans"]
    assert [s["name"] for s in spans].count(ROOT) == 1
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    base = int(doc.get("baseTimeNanoseconds", 0))
    copies = {}
    for e in doc["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            a = float(e["ts"]) * 1000 + base
            copies.setdefault(e["name"], []).append(
                (a, a + float(e["dur"]) * 1000))
    for s in spans:
        near = min(max(abs(a - s["start_ns"]), abs(b - s["end_ns"]))
                   for a, b in copies[s["name"]])
        assert near < 1e6, (s["name"], near)


# --- the readback counter -------------------------------------------------------

def _bool_index(idx):
    items = idx if isinstance(idx, tuple) else (idx,)
    return any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
               for i in items)


class _Copies:
    """Device-to-host copies a call makes, counted where Python asks for
    them: .cpu(), .item(), .tolist(), int/float/bool/index of a tensor,
    torch.nonzero, and indexing by a boolean tensor (which reads its size
    back). On the CPU these copy nothing, but they are the same calls."""

    def __init__(self, monkeypatch):
        self.n = 0

        def wrap(owner, name, when=None):
            f = getattr(owner, name)

            def counted(*a, **kw):
                if when is None or when(a):
                    self.n += 1
                return f(*a, **kw)
            monkeypatch.setattr(owner, name, counted)
        wrap(torch, "nonzero")
        for name in ("cpu", "item", "tolist", "__int__", "__float__",
                     "__bool__", "__index__"):
            wrap(torch.Tensor, name)
        for name in ("__getitem__", "__setitem__"):
            wrap(torch.Tensor, name, lambda a: _bool_index(a[1]))


@pytest.mark.parametrize("route", list(ROUTES))
def test_readbacks_count_every_copy(route, tmp_path, monkeypatch):
    rb = _rb()
    _call(route, tmp_path, rb=rb)  # the -p route writes its files first
    counts = []
    for _ in range(2):
        copies = _Copies(monkeypatch)
        trace.enable()
        _call(route, tmp_path, rb=rb)
        trace.disable()
        monkeypatch.undo()
        got = trace.drain()
        (call_counts,) = got["counters"].values()
        counts.append(call_counts[trace.READBACKS])
        assert counts[-1] == copies.n > 0
    assert counts[0] == counts[1]


def test_readbacks_pass_the_main_path_sites(tmp_path, monkeypatch):
    """The sites of the PFP path and the engine: the KR count and the
    break list's nonzero (2; the list stays on the device), the phrase
    sort's fingerprint check, its heads and its one readback of the parse
    (3), a round of its refinement and of the parse's uncapped doubling (1
    each), the engine's counts (1), the emit selection's nonzero (1) and
    the five windows (5) are all counted."""
    seen = {}
    real = trace.count

    def spy(name, n=1):
        import inspect
        caller = inspect.stack()[1]
        key = (caller.filename.rsplit("/", 1)[-1], caller.function)
        seen[key] = seen.get(key, 0) + n
        real(name, n)
    monkeypatch.setattr(trace, "count", spy)
    trace.enable()
    _call("mum", tmp_path)
    trace.disable()
    assert seen[("pfp.py", "compute_breaks")] == 1
    assert seen[("pfp.py", "_compact_breaks")] == 1
    # with no fingerprint collision the sort_phrases counters add 0
    assert seen[("pfp.py", "sort_phrases")] == 3
    assert seen[("pfp.py", "_refine")] >= 1
    assert seen[("suffix.py", "_suffix_array_impl")] >= 1
    assert seen[("pipeline.py", "_select_ordered")] == 1
    assert seen[("engine.py", "_to_host")] == 1 + 5


@pytest.mark.parametrize("path", ["flat", "by level"])
def test_rmq_bytes_count_the_tables_and_copies(path, monkeypatch):
    """pfp.rmq.bytes counts a sparse table's levels above level 0 and, on
    the flat path alone, the flat copy a query makes; each table build and
    query is a pfp.rmq span."""
    n = 1000
    values = torch.arange(n, dtype=torch.int32).flip(0)
    levels = len(ops_pfp.ops_intervals._sparse_min_table(values))
    if path == "by level":
        monkeypatch.setattr(ops_pfp, "RMQ_FLAT_LIMIT", n * levels)
    lo = torch.tensor([0, 5, 999], dtype=torch.int32)
    hi = torch.tensor([999, 600, 999], dtype=torch.int32)
    trace.enable()
    with trace.call(ROOT):
        table = ops_pfp._min_table(values)
        got = ops_pfp._rmq_query(table, lo, hi)
    trace.disable()
    kept = trace.drain()
    assert got.tolist() == [0, 399, 0]
    copy = n * levels * 4 if path == "flat" else 0
    (counters,) = kept["counters"].values()
    assert counters == {ops_pfp.RMQ_BYTES: (levels - 1) * n * 4 + copy}
    assert [s["name"] for s in kept["spans"]] == [ROOT, "pfp.rmq",
                                                  "pfp.rmq"]


def test_native_load_is_a_span(monkeypatch):
    monkeypatch.delenv("MUMEMTO_TPU_NO_NATIVE", raising=False)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_native", None)
    trace.enable()
    native.get_native()
    trace.disable()
    names = [s["name"] for s in trace.drain()["spans"]]
    assert names == ["native.load"]


# --- on the card ---------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("route", ["mum", "mem_f3", "direct", "merge"])
def test_readbacks_equal_the_trace_copies_on_the_card(route, tmp_path):
    """engine.readbacks per call equals the device-to-host Memcpy events
    of the call's torch.profiler trace."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile
    rb = _rb(n_docs=6, base_len=20000)
    _call(route, tmp_path, device="cuda", rb=rb)  # loads the kernel
    torch.cuda.synchronize()
    trace.drain()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _call(route, tmp_path, device="cuda", rb=rb)
        torch.cuda.synchronize()
    (counted,) = trace.drain()["counters"].values()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    d2h = [e for e in events if e.get("cat") == "gpu_memcpy"
           and "DtoH" in e.get("name", "")]
    assert counted[trace.READBACKS] == len(d2h)
