"""engine.readbacks: count per call of the device-to-host copies a call makes
(each .cpu(), int() of a device scalar, nonzero and boolean-mask index),
counted at their sites; the program"s counter engine.readbacks, over the
traced run"s profiled calls (mumbench/spans.py)."""

from spans import per_call

NAMES = ("engine.readbacks",)


def read(rec):
    return per_call(rec, "counters", NAMES)
