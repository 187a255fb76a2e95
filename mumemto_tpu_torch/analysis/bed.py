"""BED export (mumemto/mum_to_bed.py): blocks/MUMs -> BED intervals in
contig-relative coordinates for one sequence."""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from mumemto_tpu_torch import formats
from mumemto_tpu_torch.analysis.mumdata import MUMdata, serialize_coll_blocks


def process_mums(mums: MUMdata, seq_idx: int, min_singleton_length: int):
    """Interval assembly from blocks/MUMs (mum_to_bed.py:38-78)."""
    block_col = (serialize_coll_blocks(mums.blocks, mums.num_mums)
                 if mums.blocks is not None else ["-"] * mums.num_mums)
    has_blocks = mums.blocks is not None
    intervals = []
    last_block = "-"
    last_start = last_end = None
    last_strand = None
    for i in range(mums.num_mums):
        l = int(mums.lengths[i])
        start = int(mums.starts[i, seq_idx])
        strand = bool(mums.strands[i, seq_idx])
        block = block_col[i] if has_blocks else None
        if has_blocks:
            if last_block != "-" and block == last_block:
                if strand:
                    last_end = start + l
                else:
                    last_start = start
            elif last_block != "-" and block != last_block:
                intervals.append((last_start, last_end, last_strand,
                                  f"block_{last_block}"))
                if block != "-":
                    if strand:
                        last_start = start
                    else:
                        last_end = start + l
            elif block != "-":
                if strand:
                    last_start = start
                else:
                    last_end = start + l
            if block == "-" and l >= min_singleton_length:
                intervals.append((start, start + l, strand, f"mum_{i}"))
        elif l >= min_singleton_length:
            intervals.append((start, start + l, strand, f"mum_{i}"))
        last_block = block
        last_strand = strand
    if has_blocks and last_block != "-":
        intervals.append((last_start, last_end, last_strand,
                          f"block_{last_block}"))
    return intervals


def run(argv) -> int:
    ap = argparse.ArgumentParser(prog="mumemto bed",
                                 description="Convert MUMs file to BED file")
    ap.add_argument("mums_file")
    ap.add_argument("--lengths-file", "-l")
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("--min-singleton-length", "-L", type=int, default=100)
    ap.add_argument("--seq-idx", "-s", type=int, default=0)
    ap.add_argument("--output", "-o", default=None)
    a = ap.parse_args(argv)
    if a.lengths_file is None:
        a.lengths_file = os.path.splitext(a.mums_file)[0] + ".lengths"
        if not os.path.exists(a.lengths_file):
            raise FileNotFoundError(f"Lengths file {a.lengths_file} not found")

    info = formats.parse_lengths(a.lengths_file)
    if a.seq_idx >= len(info.totals):
        print(f"Sequence index {a.seq_idx} too large for dataset with "
              f"{len(info.totals)} sequences.", file=sys.stderr)
        return 1
    lengths = np.asarray(info.contig_lengths[a.seq_idx] or
                         [info.totals[a.seq_idx]], dtype=np.int64)
    names = info.contig_names[a.seq_idx] or \
        [os.path.basename(info.paths[a.seq_idx])]

    mums = MUMdata(a.mums_file, sort=True)
    intervals = process_mums(mums, a.seq_idx, a.min_singleton_length)

    offsets = np.cumsum(lengths)
    starts = np.array([i[0] for i in intervals], dtype=np.int64) \
        if intervals else np.zeros(0, dtype=np.int64)
    contig_idx = np.searchsorted(offsets, starts, side="right")
    left_start = np.hstack((0, offsets[:-1]))
    rel = starts - left_start[np.minimum(contig_idx, len(lengths) - 1)]

    out = sys.stdout if a.output is None else open(a.output, "w")
    for i, (s, e, strand, name) in enumerate(intervals):
        ln = e - s
        out.write(f"{names[contig_idx[i]]}\t{rel[i]}\t{rel[i] + ln}\t{name}\t"
                  f"{'+' if strand else '-'}\n")
    if a.output is not None:
        out.close()
    return 0
