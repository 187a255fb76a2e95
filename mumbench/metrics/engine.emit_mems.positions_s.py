"""engine.emit_mems.positions_s: seconds per call of engine._emit_mems"s
numpy work up to the flat occurrence arrays; the program"s span
engine.emit_mems.positions, over the traced run"s profiled calls
(mumbench/spans.py)."""

from spans import per_call

NAMES = ("engine.emit_mems.positions",)


def read(rec):
    return per_call(rec, "spans", NAMES)
