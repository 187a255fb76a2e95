"""pfp.build.sort_s: seconds per call of ops/pfp.sort_phrases, the native
phrase sort on the host; the program"s span pfp.build.sort, over the
traced run"s profiled calls (mumbench/spans.py)."""

from spans import per_call

NAMES = ("pfp.build.sort",)


def read(rec):
    return per_call(rec, "spans", NAMES)
