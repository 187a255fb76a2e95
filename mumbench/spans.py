"""The program's own spans and counters (mumemto_tpu_torch/trace.py) in a
traced run, for the metric readers; and the card's idle time inside each
span, from a torch.profiler trace.

run.py's profiled window calls the program under torch.profiler, and the
program traces each call it opens while a profiler records. After the run
the first reader takes what the program kept (trace.drain) into the run's
record, once: rec["profile"] gains "spans" (seconds by span name),
"counters" (by name) and "traced_calls" (the number of the calls' root
spans), each summed over the window's calls. A program without the module
(one older than it), or a run in which it kept nothing, gives every reader
None.
"""

from __future__ import annotations

import bisect
import collections
import importlib
import itertools

ROOT = "engine.find_matches"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def taken(rec: dict) -> dict | None:
    """rec["profile"] with the program's spans and counters in it, or None
    when the run has no profile or the program kept nothing."""
    p = rec.get("profile")
    if not p:
        return None
    if "traced_calls" not in p:
        p.update(summed(_drain()))
    return p if p["traced_calls"] else None


def _drain() -> dict:
    try:
        trace = importlib.import_module("mumemto_tpu_torch.trace")
    except ImportError:
        return {"spans": [], "counters": {}}
    return trace.drain()


def summed(kept: dict) -> dict:
    """trace.drain()'s records as seconds by span name and counts by
    counter name, over the spans and counters of its calls."""
    roots = {s["id"] for s in kept["spans"] if s["name"] == ROOT
             and s["parent"] is None}
    spans = collections.defaultdict(float)
    for s in kept["spans"]:
        if s["call"] in roots and s["end_ns"] is not None:
            spans[s["name"]] += (s["end_ns"] - s["start_ns"]) / 1e9
    counters = collections.defaultdict(int)
    for call, named in kept["counters"].items():
        if call in roots:
            for name, n in named.items():
                counters[name] += n
    return {"spans": dict(spans), "counters": dict(counters),
            "traced_calls": len(roots)}


def per_call(rec: dict, kind: str, names) -> float | None:
    """The named spans' seconds (kind "spans") or counters' counts
    ("counters") together, per traced call; None when none was seen."""
    p = taken(rec)
    if p is None:
        return None
    seen = [p[kind][n] for n in names if n in p[kind]]
    if not seen:
        return None
    return float(sum(seen)) / p["traced_calls"]


def _union(spans):
    """Sorted disjoint runs covering `spans` (run.py's own, repeated here:
    the harness imports the readers' modules, so they do not import it)."""
    runs = []
    for a, b in sorted(spans):
        if runs and a <= runs[-1][1]:
            runs[-1][1] = max(runs[-1][1], b)
        else:
            runs.append([a, b])
    return runs


def span_idle(events: list, names=None) -> dict:
    """{span name: seconds}: the busiest card's idle time inside the union
    of the span's intervals, from the events of a torch.profiler chrome
    trace (a card is busy where one of its kernel, copy or memset events
    runs; a span's intervals are its user_annotation copies, on the same
    clock). names limits the spans read; a trace with no device event
    gives {}."""
    by_card = collections.defaultdict(list)
    marks = collections.defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        a = float(e["ts"])
        b = a + float(e.get("dur", 0))
        if e.get("cat") in DEVICE_CATS and "device" in e.get("args", {}):
            by_card[int(e["args"]["device"])].append((a, b))
        elif e.get("cat") == "user_annotation" and (
                names is None or e.get("name") in names):
            marks[e["name"]].append((a, b))
    if not by_card:
        return {}
    runs = {c: _union(s) for c, s in by_card.items()}
    card = max(runs, key=lambda c: sum(b - a for a, b in runs[c]))
    starts = [a for a, _ in runs[card]]
    ends = [b for _, b in runs[card]]
    cum = [0.0, *itertools.accumulate(b - a for a, b in runs[card])]

    def busy_to(x):
        """The card's busy time before x: whole runs, then a part."""
        i = bisect.bisect_right(ends, x)
        part = max(0.0, x - starts[i]) if i < len(starts) else 0.0
        return cum[i] + part

    out = {}
    for name, ivs in marks.items():
        idle = 0.0
        for a, b in _union(ivs):
            idle += (b - a) - (busy_to(b) - busy_to(a))
        out[name] = idle / 1e6
    return out
