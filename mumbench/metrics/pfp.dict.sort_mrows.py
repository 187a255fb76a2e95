"""pfp.dict.sort_mrows: million rows per call that the PFP dictionary's
prefix doubling passes to a sort, its seed sort included; the program's
counter pfp.dict.sort_rows, over the traced run's profiled calls
(mumbench/spans.py). A program without the counter gives None."""

from spans import per_call

NAMES = ("pfp.dict.sort_rows",)


def read(rec):
    got = per_call(rec, "counters", NAMES)
    return None if got is None else got / 1e6
