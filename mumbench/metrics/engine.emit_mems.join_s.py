"""engine.emit_mems.join_s: seconds per call of engine._emit_mems"s joins:
_join_ragged, the line assembly, encode and splitlines; the program"s span
engine.emit_mems.join, over the traced run"s profiled calls
(mumbench/spans.py)."""

from spans import per_call

NAMES = ("engine.emit_mems.join",)


def read(rec):
    return per_call(rec, "spans", NAMES)
