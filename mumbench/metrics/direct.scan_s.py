"""direct.scan_s: seconds per call of the direct backend (-g): prefix-
doubling SA, LCP and interval analysis; the engine's phase hook stage(s)
suffix_array, lcp, analyze, over the traced run's hooked calls."""

from records import stage_mean

STAGES = ("suffix_array", "lcp", "analyze")


def read(rec):
    return stage_mean(rec, STAGES)
