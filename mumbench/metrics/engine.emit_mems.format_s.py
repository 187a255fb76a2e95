"""engine.emit_mems.format_s: seconds per call of engine._emit_mems"s
formatting: np.char.mod and np.char.add of the occurrence pieces; the
program"s span engine.emit_mems.format, over the traced run"s profiled
calls (mumbench/spans.py)."""

from spans import per_call

NAMES = ("engine.emit_mems.format",)


def read(rec):
    return per_call(rec, "spans", NAMES)
