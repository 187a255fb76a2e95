"""Reorder pre-1.3.4 threshold files into MUM-sorted order
(mumemto/convert_thresh.py)."""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from mumemto_tpu_torch import formats
from mumemto_tpu_torch.analysis.mumdata import MUMdata


def run(argv) -> int:
    ap = argparse.ArgumentParser(prog="mumemto convert-thresh",
                                 description="Sort thresholds from mumemto <1.3.4")
    ap.add_argument("input_file")
    ap.add_argument("--output", "-o", default=None)
    ap.add_argument("--verbose", "-v", action="store_true")
    a = ap.parse_args(argv)
    if a.input_file.endswith(".mums"):
        prefix = a.input_file[:-5]
    elif a.input_file.endswith(".bumbl"):
        prefix = a.input_file[:-6]
    else:
        prefix = a.input_file
        a.input_file += ".mums"
    thresh_file = prefix + ".thresh"
    rev_file = prefix + ".thresh_rev"
    if a.output is None:
        a.output = prefix + "_converted"
    for p in (a.input_file, thresh_file, rev_file):
        if not os.path.exists(p):
            print(f"Error: file {p} does not exist.", file=sys.stderr)
            return 1

    thresholds = formats.read_thresh(thresh_file)
    rev_thresholds = formats.read_thresh(rev_file)
    mums = MUMdata(a.input_file, sort=False)
    lengths = mums.lengths.astype(np.int64)
    starts = np.concatenate(([0], np.cumsum(lengths + 1)))
    order = np.argsort(mums.starts[:, 0], kind="stable")
    new_t, new_r = [], []
    for o in order:
        new_t.append(thresholds[starts[o]: starts[o] + lengths[o] + 1])
        new_r.append(rev_thresholds[starts[o]: starts[o] + lengths[o] + 1])
    ct = np.concatenate(new_t)
    cr = np.concatenate(new_r)
    assert ct.size == thresholds.size and cr.size == rev_thresholds.size
    formats.write_thresh(a.output + ".thresh", ct)
    formats.write_thresh(a.output + ".thresh_rev", cr)
    MUMdata.from_arrays(mums.lengths[order], mums.starts[order],
                        mums.strands[order]).write_mums(a.output + ".mums")
    return 0
