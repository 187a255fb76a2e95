"""pfp.build.text_s: seconds per call of ops/pfp.build_pfp"s text copies
(np.concatenate, the bucket pad) and the upload of ext; the program"s span
pfp.build.text, over the traced run"s profiled calls (mumbench/spans.py)."""

from spans import per_call

NAMES = ("pfp.build.text",)


def read(rec):
    return per_call(rec, "spans", NAMES)
