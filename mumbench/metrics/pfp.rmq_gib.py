"""pfp.rmq_gib: GiB per call of device memory that ops/pfp's range-min
allocates: each sparse table's levels above level 0, and each flat copy of
a table a query makes; the program's counter pfp.rmq.bytes, over the traced
run's profiled calls (mumbench/spans.py). A program without the counter
gives None."""

from spans import per_call

NAMES = ("pfp.rmq.bytes",)


def read(rec):
    got = per_call(rec, "counters", NAMES)
    return None if got is None else got / 2**30
