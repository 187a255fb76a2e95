"""pfp.expand_sort_analyze_s: seconds per call of
ops/pfp._expand_and_analyze: row operands, sort, per-row LCP, interval
analysis; the engine's phase hook stage(s) expand_sort_analyze, over the
traced run's hooked calls."""

from records import stage_mean

STAGES = ("expand_sort_analyze",)


def read(rec):
    return stage_mean(rec, STAGES)
