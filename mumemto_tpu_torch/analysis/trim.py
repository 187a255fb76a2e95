"""Trim MUMs extending past sequence ends (mumemto/trim_mums.py)."""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from mumemto_tpu_torch import formats
from mumemto_tpu_torch.analysis.mumdata import MUMdata


def trim_mums(mums: MUMdata, seq_lengths, min_length: int = 20,
              verbose: bool = False) -> MUMdata:
    seq_lengths = np.asarray(seq_lengths, dtype=np.int64)
    valid = mums.starts != -1
    excess = mums.starts + mums.lengths[:, None].astype(np.int64) - seq_lengths
    excess[~valid] = np.iinfo(np.int64).min
    max_excess = np.max(excess, axis=1)
    needs = max_excess > 0
    new_lengths = mums.lengths.astype(np.int64).copy()
    new_lengths[needs] -= max_excess[needs]
    below = new_lengths < min_length
    new_lengths[below] = 0
    keep = new_lengths > 0
    if verbose:
        print(f"Trimmed {int(needs.sum())} MUMs", file=sys.stderr)
        if below.sum():
            print(f"Removed {int(below.sum())} MUMs below minimum length "
                  f"({min_length}bp)", file=sys.stderr)
    return MUMdata.from_arrays(new_lengths[keep].astype(mums.lengths.dtype),
                               mums.starts[keep], mums.strands[keep])


def run(argv) -> int:
    ap = argparse.ArgumentParser(prog="mumemto trim",
                                 description="Trim MUMs beyond sequence ends")
    ap.add_argument("-m", "--mumfile", required=True)
    ap.add_argument("-l", "--lengths")
    ap.add_argument("-o", "--output")
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("--min-length", type=int, default=20)
    a = ap.parse_args(argv)
    if not a.mumfile.endswith((".mums", ".bumbl")):
        if os.path.exists(a.mumfile + ".mums"):
            a.mumfile += ".mums"
        elif os.path.exists(a.mumfile + ".bumbl"):
            a.mumfile += ".bumbl"
        else:
            print(f"MUM file {a.mumfile} not found.", file=sys.stderr)
            return 1
    if a.lengths is None:
        a.lengths = os.path.splitext(a.mumfile)[0] + ".lengths"
    if a.output is None:
        base = os.path.splitext(a.mumfile)[0]
        ext = ".mums" if a.mumfile.endswith(".mums") else ".bumbl"
        a.output = base + "_trimmed" + ext

    info = formats.parse_lengths(a.lengths)
    mums = MUMdata(a.mumfile, sort=False, verbose=a.verbose)
    out = trim_mums(mums, info.totals, min_length=a.min_length,
                    verbose=a.verbose)
    if a.output.endswith(".bumbl"):
        out.write_bums(a.output)
    else:
        out.write_mums(a.output, blocks=out.blocks)
    return 0
