"""kr_mask.roofline_pct: the least time of one KR break-mask launch (its
bytes, rooflines/kr_mask.py, at the card's published memory bandwidth,
peaks.json) over its profiled time per launch, in percent."""

import os

from records import HERE, load_module, peak


def read(rec):
    p = rec["profile"]
    bw = peak(rec["card"], "hbm_bytes_per_s")
    if not p or not bw:
        return None
    roof = load_module(os.path.join(HERE, "rooflines", "kr_mask.py"),
                       "roofline_kr_mask")
    hits = [v for name, v in p["device_ops"].items() if roof.KERNEL in name]
    launches = sum(n for _s, n in hits)
    if not launches:
        return None
    per_launch = sum(s for s, _n in hits) / launches
    least = roof.bytes_moved(rec["n_text"], rec["w"]) / bw
    return 100.0 * least / per_launch
