"""Inversion detection from collinear blocks (mumemto/find_inversions.py).

Finds maximal stretches of collinear blocks whose order is reversed and
whose strands are all '-' relative to sequence 0 (find_reversals :99-110),
reports per-sequence + reference coordinates (:112-121), with optional AGP
scaffold-break proximity checking (:66-97, 172-182).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from mumemto_tpu_torch import formats
from mumemto_tpu_torch.analysis.mumdata import (MUMdata, find_coll_blocks,
                                          get_coll_block_order)


def find_reversals(coll_block_order, mums, blocks):
    """Candidate inversions per non-reference sequence (re-derived from the
    reference semantics, find_inversions.py:99-110 / SURVEY §2.2-P6).

    Walking the blocks along sequence i, an inversion shows up as a maximal
    stretch where the reference-order block id DECREASES by exactly 1 at
    every step; the stretch is reported only if every spanned block sits on
    the '-' strand in sequence i. Returns (seq, first_pos, last_pos)
    positions into coll_block_order[seq], inclusive.
    """
    lefts = np.asarray([b[0] for b in blocks], dtype=np.int64)
    stretches = []
    for i in range(1, len(coll_block_order)):
        along = np.asarray(coll_block_order[i])
        desc = np.diff(along) == -1  # step down by one
        if not desc.any():
            continue
        # '-' strand (in seq i) of each block's leading MUM, by position
        neg = ~np.asarray(mums.strands)[lefts[along], i]
        edge = np.diff(np.concatenate(
            ([False], desc, [False])).astype(np.int8))
        for a, b in zip(np.flatnonzero(edge == 1), np.flatnonzero(edge == -1)):
            # stretch covers positions a..b (b = one past the last down-step)
            if neg[a:b + 1].all():
                stretches.append((i, int(a), int(b)))
    return stretches


def inversion_coords(coll_block_order, mums, blocks, i, s, e):
    """Coordinates of one reversal stretch: the segment runs backwards along
    sequence i, so its left edge in i-coordinates comes from the RIGHT MUM
    of the first spanned block and its right edge from the LEFT MUM of the
    last (find_inversions.py:112-121 semantics)."""
    along = coll_block_order[i]
    head_mum = blocks[int(along[s])][1]
    tail_mum = blocks[int(along[e])][0]
    tail_len = int(mums.lengths[tail_mum])
    starts = np.asarray(mums.starts)
    return (i,
            int(starts[head_mum, i]),
            int(starts[tail_mum, i]) + tail_len,
            int(starts[head_mum, 0]),
            int(starts[tail_mum, 0]) + tail_len)


def _scaffold_breaks(agp_filelist, chrom, hap_ids, verbose=False):
    breaks, contig_names = {}, {}
    agp_files = {}
    with open(agp_filelist) as f:
        for idx, line in enumerate(f):
            if idx >= len(hap_ids):
                break
            p = line.strip()
            if p:
                agp_files[hap_ids[idx + 1]] = p
    for hap in hap_ids[1:]:
        if hap not in agp_files or not os.path.exists(agp_files[hap]):
            continue
        with open(agp_files[hap]) as f:
            lines = [l for l in f.read().splitlines()
                     if l.startswith("chr" + str(chrom))]
            rows = [l.split() for l in lines if l.split()[4] == "W"]
            breaks[hap] = np.array([int(r[2]) - int(r[1]) + 1 for r in rows])
            contig_names[hap] = [r[5] for r in rows]
    return breaks, contig_names


def run(argv) -> int:
    ap = argparse.ArgumentParser(prog="mumemto inversion",
                                 description="Detect inversions from MUMs")
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--input-prefix", "-i", dest="prefix")
    g.add_argument("--mums", "-m", dest="mumfile")
    ap.add_argument("--agp-filelist", "-a", dest="agp_filelist")
    ap.add_argument("--filelist", "-f", dest="filelist")
    ap.add_argument("--chr", "-c", dest="chrom")
    ap.add_argument("--margin", "-d", type=float, default=0.01)
    ap.add_argument("--max-length", "-L", dest="max_length", type=int)
    ap.add_argument("--max-block-gap-len", "-g", dest="max_block_gap",
                    default=1000, type=int)
    ap.add_argument("--verbose", "-v", action="store_true")
    a = ap.parse_args(argv)
    if bool(a.agp_filelist) ^ bool(a.chrom):
        ap.error("--agp-filelist and --chr must be provided together")
    scaffold = bool(a.agp_filelist) and bool(a.chrom)

    if a.mumfile:
        a.prefix = os.path.splitext(a.mumfile)[0]
    else:
        if a.prefix.endswith((".mums", ".bumbl")):
            a.prefix = os.path.splitext(a.prefix)[0]
        if os.path.exists(a.prefix + ".bumbl"):
            a.mumfile = a.prefix + ".bumbl"
        elif os.path.exists(a.prefix + ".mums"):
            a.mumfile = a.prefix + ".mums"
        else:
            ap.error("No .mums or .bumbl file found for prefix")
    if a.filelist is None:
        a.filelist = a.prefix + ".lengths"

    info = formats.parse_lengths(a.filelist)
    seq_names = list(info.paths)
    if a.chrom:
        hap_ids = [os.path.basename(l).split(f"_chr{a.chrom}")[0]
                   for l in seq_names]
    else:
        hap_ids = [os.path.basename(l) for l in seq_names]

    if scaffold:
        breaks, contig_names = _scaffold_breaks(a.agp_filelist, a.chrom,
                                                hap_ids, a.verbose)

    mums = MUMdata(a.mumfile, verbose=a.verbose)
    if mums.blocks is None:
        mums.filter_pmums()
        if len(mums) == 0:
            print("No strict MUMs found after filtering. Aborting.",
                  file=sys.stderr)
            return 0
        blocks, block_orders = find_coll_blocks(
            mums, max_break=a.max_block_gap, verbose=a.verbose,
            return_order=True)
    else:
        blocks = mums.blocks
        block_orders = get_coll_block_order(mums, blocks)

    stretches = find_reversals(block_orders, mums, blocks)
    ranges = []
    for i, s, e in stretches:
        r = inversion_coords(block_orders, mums, blocks, i, s, e)
        if a.max_length is None or abs(r[2] - r[1]) <= a.max_length:
            ranges.append(r)

    print("hap_id\tstart\tend\tref_start\tref_end"
          + ("\tscaffold_break\tcontig" if scaffold else ""))
    for seq_idx, start, end, ref_start, ref_end in ranges:
        hap = hap_ids[seq_idx]
        if scaffold and hap in breaks:
            ds = np.abs(np.cumsum(breaks[hap]) - start)
            de = np.abs(np.cumsum(breaks[hap]) - end)
            margin = (end - start) * a.margin
            contig_id = []
            if ds.min() < margin:
                contig_id.extend([contig_names[hap][x]
                                  for x in np.where(ds < margin)[0]])
            if de.min() < margin:
                contig_id.extend([contig_names[hap][x]
                                  for x in np.where(de < margin)[0]])
            print(f"{hap}\t{start}\t{end}\t{ref_start}\t{ref_end}\t"
                  f"{bool(contig_id)}\t"
                  f"{','.join(contig_id) if contig_id else 'NA'}")
        else:
            print(f"{hap}\t{start}\t{end}\t{ref_start}\t{ref_end}")
    return 0
