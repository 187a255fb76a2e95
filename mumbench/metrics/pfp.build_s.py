"""pfp.build_s: seconds per call of ops/pfp.build_pfp: text copies, upload,
KR mask, break readback, native phrase sort; the engine's phase hook
stage(s) build_pfp, over the traced run's hooked calls."""

from records import stage_mean

STAGES = ("build_pfp",)


def read(rec):
    return stage_mean(rec, STAGES)
