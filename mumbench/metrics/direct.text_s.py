"""direct.text_s: seconds per call of the -g branch"s zero-padded text copy
and its upload (engine._find_matches_inner); the program"s span
direct.text, over the traced run"s profiled calls (mumbench/spans.py)."""

from spans import per_call

NAMES = ("direct.text",)


def read(rec):
    return per_call(rec, "spans", NAMES)
