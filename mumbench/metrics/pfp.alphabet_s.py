"""pfp.alphabet_s: seconds per call of ops/pfp._alphabet, the byte alphabet"s
presence mask over a uint16 view (in build_pfp, and in the -g branch of
the engine); the program"s span pfp.alphabet, over the traced run"s
profiled calls (mumbench/spans.py)."""

from spans import per_call

NAMES = ("pfp.alphabet",)


def read(rec):
    return per_call(rec, "spans", NAMES)
