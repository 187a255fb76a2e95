"""pfp.dict.descent_mrows: million suffix pairs per call that the PFP
dictionary's LCP gathers by rank descent, one level at a time (a packed
bottom counts as one level; the PLCP of an alphabet of at most 8 letters
sends only its deep rows down the descent); the program's counter
pfp.dict.descent_rows, over the traced run's profiled calls
(mumbench/spans.py). A program without the counter gives None."""

from spans import per_call

NAMES = ("pfp.dict.descent_rows",)


def read(rec):
    got = per_call(rec, "counters", NAMES)
    return None if got is None else got / 1e6
