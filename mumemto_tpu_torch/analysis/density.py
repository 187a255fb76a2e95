"""Per-sequence MEM coverage-depth matrix -> .npy (mumemto/mem_density.py)."""

from __future__ import annotations

import argparse
import os

import numpy as np

from mumemto_tpu_torch import formats


def run(argv) -> int:
    ap = argparse.ArgumentParser(prog="mumemto density",
                                 description="Aggregates MEM density")
    ap.add_argument("--mems", "-m", required=True)
    ap.add_argument("--lengths", "-l", required=True)
    ap.add_argument("--verbose", "-v", action="store_true")
    a = ap.parse_args(argv)
    info = formats.parse_lengths(a.lengths)
    totals = info.totals
    size = max(totals)
    num = len(totals)
    coverage = np.zeros((num, size))
    with open(a.mems) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            l = int(parts[0])
            starts = np.fromstring(parts[1], sep=",", dtype=int)
            idxs = np.fromstring(parts[2], sep=",", dtype=int)
            for start, idx in zip(starts, idxs):
                coverage[idx, start:start + l] += 1
    out = os.path.splitext(a.mems)[0] + "_coverage.npy"
    np.save(out, coverage)
    return 0
