"""Contig labeling (mumemto/get_sequence_info.py): append contig ids and
contig-relative offsets per MUM."""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from mumemto_tpu_torch import formats
from mumemto_tpu_torch.analysis.mumdata import MUMdata, serialize_coll_blocks


def offset_mums(mums, lengths):
    num_seqs = len(lengths)
    contig_idx, rel_offsets = [], []
    for i in range(num_seqs):
        offsets = np.cumsum(lengths[i])
        contig_idx.append(np.searchsorted(offsets, mums.starts[:, i],
                                          side="right"))
        left_start = np.hstack((0, offsets[:-1]))
        rel_offsets.append(mums.starts[:, i] - left_start[contig_idx[i]])
    contig_idx = np.vstack(contig_idx).transpose()
    rel_offsets = np.vstack(rel_offsets).transpose()
    rel_offsets[mums.starts == -1] = -1
    return contig_idx, rel_offsets


def run(argv) -> int:
    ap = argparse.ArgumentParser(prog="mumemto label",
                                 description="Label MUMs with contig info")
    ap.add_argument("-m", "--mumfile", required=True)
    ap.add_argument("-o", "--output")
    ap.add_argument("-l", "--lengths")
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("-n", "--contig-names", dest="contig_names",
                    action="store_true")
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
    if not os.path.exists(a.lengths):
        print(f"Lengths file {a.lengths} not found.", file=sys.stderr)
        return 1
    if a.output is None:
        a.output = os.path.splitext(a.mumfile)[0] + "_labeled.mums"

    info = formats.parse_lengths(a.lengths)
    if not all(len(c) for c in info.contig_lengths):
        print("Multi-FASTA input required for contig ID annotation.",
              file=sys.stderr)
        return 1
    lengths = [np.asarray(c, dtype=np.int64) for c in info.contig_lengths]
    names = info.contig_names

    mums = MUMdata(a.mumfile, sort=False, verbose=a.verbose)
    is_blocked = mums.blocks is not None
    if is_blocked:
        blocks = serialize_coll_blocks(mums.blocks, mums.num_mums)
    contig_idx, rel_offsets = offset_mums(mums, lengths)
    with open(a.output, "w") as out:
        for i in range(mums.num_mums):
            st = ["+" if s else "-" for s in mums.strands[i]]
            if a.contig_names:
                cur = ",".join(names[idx][c]
                               for idx, c in enumerate(contig_idx[i]))
            else:
                cur = ",".join(map(str, contig_idx[i]))
            blk = blocks[i] if is_blocked else "*"
            out.write(f"{mums.lengths[i]}\t"
                      f"{','.join(map(str, mums.starts[i]))}\t"
                      f"{','.join(st)}\t{blk}\t{cur}\t"
                      f"{','.join(map(str, rel_offsets[i]))}\n")
    return 0
