"""engine.emit_s: seconds per call of the host's match assembly
(engine._emit_mums / _emit_mems); the engine's phase hook stage(s) emit,
over the traced run's hooked calls."""

from records import stage_mean

STAGES = ("emit",)


def read(rec):
    return stage_mean(rec, STAGES)
