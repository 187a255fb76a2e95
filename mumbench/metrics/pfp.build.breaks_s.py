"""pfp.build.breaks_s: seconds per call of ops/pfp.compute_breaks: the KR
kernel"s launch, the count"s readback, nonzero and the break list"s
readback; the program"s span pfp.build.breaks, over the traced run"s
profiled calls (mumbench/spans.py)."""

from spans import per_call

NAMES = ("pfp.build.breaks",)


def read(rec):
    return per_call(rec, "spans", NAMES)
