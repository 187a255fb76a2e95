"""engine.compact_s: seconds per call of the engine"s compact stage: the
counts" readback, the selection and windows on the device and their
readback; the program"s span engine.compact, over the traced run"s
profiled calls (mumbench/spans.py)."""

from spans import per_call

NAMES = ("engine.compact",)


def read(rec):
    return per_call(rec, "spans", NAMES)
