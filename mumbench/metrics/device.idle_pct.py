"""device.idle_pct: 100 x (1 - the card's busy seconds over the profiled
calls' wall seconds); busy is the union of its kernel, copy and memset
spans in the torch.profiler trace of calls made with no stage hook."""


def read(rec):
    p = rec["profile"]
    if not p or p["window_s"] <= 0 or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
