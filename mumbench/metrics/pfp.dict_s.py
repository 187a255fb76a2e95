"""pfp.dict_s: seconds per call of ops/pfp._dict_index and _parse_side; the
engine's phase hook stage(s) dict_index, parse_side, over the traced run's
hooked calls."""

from records import stage_mean

STAGES = ("dict_index", "parse_side")


def read(rec):
    return stage_mean(rec, STAGES)
