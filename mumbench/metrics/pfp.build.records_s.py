"""pfp.build.records_s: seconds per call of ops/pfp.build_pfp"s phrase
records: st/en/ln before the sort and the scatters after it; the program"s
span pfp.build.records, over the traced run"s profiled calls
(mumbench/spans.py)."""

from spans import per_call

NAMES = ("pfp.build.records",)


def read(rec):
    return per_call(rec, "spans", NAMES)
