"""Synteny visualization (static matplotlib), mirroring mumemto/viz_mums.py.

Per-MUM or per-collinear-block polygons between sequence rows, with
inversion color switching, centering, region zoom, label/filelist reorder,
and multi-FASTA modes (normal/delineated/gapped). --interactive renders the
same geometry into a self-contained HTML file (analysis/viz_interactive.py,
the viz_mums_interactive.py counterpart without the plotly dependency).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from mumemto_tpu_torch import formats
from mumemto_tpu_torch.analysis.mumdata import MUMdata, find_coll_blocks


def parse_arguments(args):
    ap = argparse.ArgumentParser(prog="mumemto viz",
                                 description="Plots a synteny plot of MUMs")
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--input-prefix", "-i", dest="prefix")
    g.add_argument("--mums", "-m", dest="mumfile")
    ap.add_argument("--lengths", "-l", dest="lens")
    ap.add_argument("--filelist", "-f", dest="filelist")
    ap.add_argument("--labels", "-n", dest="labels")
    ap.add_argument("--len-filter", "-L", dest="lenfilter", default=0, type=int)
    ap.add_argument("--subsample", "-s", dest="subsample", default=1, type=int)
    ap.add_argument("--center", "-c", action="store_true", default=False)
    ap.add_argument("--inversion-color", "-ic", dest="inv_color", default="green")
    ap.add_argument("--mum-color", "-mc", dest="mum_color", default="#00A2FF")
    ap.add_argument("--alpha", "-a", type=float)
    ap.add_argument("--linewidth", "-lw", type=float)
    ap.add_argument("--fout", "-o", dest="filename")
    ap.add_argument("--dims", dest="size", default=(6.4, 4.8), type=float, nargs=2)
    ap.add_argument("--region", default=None, type=float, nargs=2)
    ap.add_argument("--dpi", "-d", default=500, type=int)
    ap.add_argument("--verbose", "-v", action="store_true", default=False)
    ap.add_argument("--no-coll-block", "-b", dest="no_coll_block",
                    action="store_true", default=False)
    ap.add_argument("--max-gap-len", "-g", dest="max_break", default=None, type=int)
    ap.add_argument("--mode", choices=["normal", "delineated", "gapped"],
                    default="normal")
    ap.add_argument("--spacer", default=0.1, type=float)
    ap.add_argument("--interactive", action="store_true", default=False)
    a = ap.parse_args(args)

    if a.mumfile:
        a.prefix = os.path.splitext(a.mumfile)[0]
    elif a.prefix:
        if a.prefix.endswith((".mums", ".bumbl")):
            a.prefix = os.path.splitext(a.prefix)[0]
        if os.path.exists(a.prefix + ".mums"):
            a.mumfile = a.prefix + ".mums"
        elif os.path.exists(a.prefix + ".bumbl"):
            a.mumfile = a.prefix + ".bumbl"
        else:
            ap.error(f"No *.mums or *.bumbl file found for prefix {a.prefix}")
    if a.lens is None:
        a.lens = a.prefix + ".lengths"
        if not os.path.exists(a.lens):
            raise FileNotFoundError(f"Lengths file {a.lens} not found")
    if not a.filename:
        a.filename = a.prefix
    if a.alpha is None:
        a.alpha = 0.05 if a.no_coll_block else 0.8
    if a.linewidth is None:
        a.linewidth = 0.05 if a.no_coll_block else 0
    return a


def _band_poly(lo, hi, rows):
    """Closed band polygon across the given sequence rows: left edge down
    the start coordinates, right edge back up the end coordinates."""
    down = [(float(lo[r]), r) for r in rows]
    up = [(float(hi[r]), r) for r in reversed(rows)]
    return tuple(down + up)


def _emit_row_polygons(left, right, strands, centering, color, inv_color,
                       polygons, colors):
    """Synteny bands for ONE match/block across all sequence rows
    (re-derivation of the reference geometry, viz_mums.py:84-158 /
    SURVEY §2.2-P3).

    The band is drawn as a chain through consecutive sequence rows. The
    chain breaks at absent slots (-1). When a row's strand differs from the
    current orientation, the two rows around the flip become their own band
    in the inversion color and the chain restarts at the flipped row.
    Emission thresholds replicate the reference: a chain cut short by an
    absent slot, or the piece left of a flip, draws only with >= 3 rows; a
    chain closed at the bottom draws with >= 2.
    """
    xs = np.asarray(centering, dtype=np.float64)
    lo = xs + np.asarray(left)
    hi = xs + np.asarray(right)
    orient = bool(strands[0])  # current '+'-equivalent orientation
    chain: list = []
    for row in range(len(strands)):
        if left[row] == -1:
            if len(chain) > 2:
                polygons.append(_band_poly(lo, hi, chain))
                colors.append(color)
            chain = []
            continue
        chain.append(row)
        if bool(strands[row]) != orient:  # orientation flip at this row
            orient = not orient
            if len(chain) > 2:
                polygons.append(_band_poly(lo, hi, chain[:-1]))
                colors.append(color)
            polygons.append(_band_poly(lo, hi, chain[-2:]))
            colors.append(inv_color)
            chain = chain[-1:]
    if len(chain) >= 2:
        polygons.append(_band_poly(lo, hi, chain))
        colors.append(color)


def get_mum_polygons(mums, centering, color="#00A2FF", inv_color="red"):
    polygons, colors = [], []
    L = np.asarray(mums.lengths, dtype=np.int64)
    for i in range(mums.num_mums):
        _emit_row_polygons(mums.starts[i], mums.starts[i] + L[i],
                           mums.strands[i], centering, color, inv_color,
                           polygons, colors)
    return polygons, colors


def get_block_polygons(blocks, mums, centering, color="#00A2FF",
                       inv_color="red"):
    polygons, colors = [], []
    for (l, r) in blocks:
        _emit_row_polygons(mums.starts[l],
                           mums.starts[r] + int(mums.lengths[r]),
                           mums.strands[l], centering, color, inv_color,
                           polygons, colors)
    return polygons, colors


def _plot(a, genome_lengths, polygons, colors, centering, genomes=None):
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt
    from matplotlib.collections import PolyCollection

    fig, ax = plt.subplots()
    max_length = max(genome_lengths)
    if a.mode in ("normal", "delineated"):
        for idx, (c0, g) in enumerate(zip(centering, genome_lengths)):
            ax.plot([c0, c0 + g], [idx, idx], c="black", alpha=0.2,
                    linewidth=0.75)
    elif a.mode == "gapped":
        ml = a.multilengths
        offsets = np.array([0] + (ml.max(axis=0) + a.spacer).cumsum().tolist()[:-1])
        vert_seps = [p - a.spacer / 2 for p in offsets] + [
            ml.max(axis=0).sum() + a.spacer * (ml.shape[1] - 1)]
        for p in vert_seps[1:-1]:
            ax.plot([p, p], [0, len(genome_lengths) - 1], alpha=0.5,
                    linewidth=1, color="black")
        for idx in range(ml.shape[0]):
            for i, off in enumerate(ml[idx]):
                ax.plot([centering[idx] + offsets[i],
                         centering[idx] + offsets[i] + off],
                        [idx, idx], alpha=0.2, linewidth=0.25)
        chr_markers = [vert_seps[i - 1] + (vert_seps[i] - vert_seps[i - 1]) / 2
                       for i in range(1, len(vert_seps))]
        ax.set_xticks(chr_markers)
        ax.set_xticklabels(range(1, len(chr_markers) + 1))

    ax.add_collection(PolyCollection(polygons, linewidths=a.linewidth,
                                     alpha=a.alpha, edgecolors=colors,
                                     facecolors=colors))
    if a.mode == "delineated":
        for idx in range(len(a.multilengths)):
            offsets = np.cumsum(a.multilengths[idx])
            for off in [0] + offsets[:-1].tolist():
                ax.plot([centering[idx] + off, centering[idx] + off],
                        [idx - 0.25, idx + 0.25], alpha=1, linewidth=0.25,
                        color="red")

    ax.yaxis.set_ticks(list(range(len(genome_lengths))))
    ax.tick_params(axis="y", which="both", length=0)
    if genomes:
        ax.set_yticklabels(genomes, fontsize=8)
    else:
        ax.yaxis.set_ticklabels([])
    ax.set_xlabel("chromosome" if a.mode == "gapped" else "genomic position")
    ax.set_ylabel("sequences")
    ax.set_ylim(-0.25, len(genome_lengths) - 1 + 0.25)
    if a.mode == "gapped":
        ax.set_xlim(0, a.multilengths.max(axis=0).sum()
                    + a.spacer * (a.multilengths.shape[1] - 1))
    elif a.region is not None:
        ax.set_xlim(*a.region)
    else:
        ax.set_xlim(0, max_length)
    ax.invert_yaxis()
    fig.set_tight_layout(True)
    if a.size:
        fig.set_size_inches(*a.size)
    filename = a.filename
    if os.path.splitext(filename)[1] not in [".png", ".pdf", ".svg"]:
        filename += ".png"
    if not os.path.dirname(filename):
        filename = os.path.join(os.path.dirname(a.mumfile), filename)
    fig.savefig(filename, dpi=a.dpi)
    plt.close(fig)
    return filename


def _split_blocks_at_contig_edges(blocks, contig_idx):
    """Split collinear blocks at contig transitions for the gapped layout
    (semantics of viz_mums.py:262-281, re-derived — quirks preserved:
    two-MUM blocks spanning an edge are dropped whole; the MUM just past
    an edge is skipped; fragments of fewer than two MUMs are dropped)."""
    out = []
    for l, r in blocks:
        if np.array_equal(contig_idx[l], contig_idx[r]):
            out.append((l, r))
            continue
        if r - l == 1:
            continue
        # first-MUM index of every pair whose contig assignment changes
        change = (contig_idx[l + 1:r + 1] != contig_idx[l:r]).any(axis=1)
        cursor = l
        for p in (np.flatnonzero(change) + l).tolist():
            if p == l:
                cursor = l + 2
                continue
            if cursor < p <= r:
                out.append((cursor, p))
                cursor = p + 2
        if cursor < r:
            out.append((cursor, r))
    return out


def offset_mums(a, mums, spacer=None, blocks=None):
    """Re-coordinate MUMs into the gapped multi-FASTA layout: contig k of
    every sequence is drawn in a shared column of width max_seq(len_k) +
    spacer, so a MUM start becomes column_offset[k] + offset-within-contig
    (viz_mums.py:256-296 semantics). Returns blocks split at contig
    transitions (None when no blocks given)."""
    ml = a.multilengths
    if spacer is None:
        spacer = a.spacer
    nseq = len(ml)
    ends = np.cumsum(ml, axis=1)  # (N, C) contig end positions per seq
    contig_idx = np.stack([
        np.searchsorted(ends[j], mums.starts[:, j], side="right")
        for j in range(nseq)], axis=1)  # (n_mums, N)
    new_blocks = None if blocks is None else \
        _split_blocks_at_contig_edges(blocks, contig_idx)
    contig_start = ends - ml
    col = np.concatenate(([0], np.cumsum(ml.max(axis=0) + spacer)[:-1]))
    within = mums.starts - contig_start[np.arange(nseq), contig_idx]
    gapped = col[contig_idx] + within
    present = mums.starts != -1
    mums.starts[present] = gapped[present]
    return new_blocks


def run(argv) -> int:
    a = parse_arguments(argv)

    info = formats.parse_lengths(a.lens)
    have_multi = any(info.contig_lengths) and all(
        len(c) > 0 for c in info.contig_lengths)
    if a.mode != "normal" and not have_multi:
        print(f"Warning: Multi-FASTA lengths not available in {a.lens}. "
              "Treating input FASTAs as a single sequence instead.",
              file=sys.stderr)
        a.mode = "normal"
    seq_lengths = list(info.totals)
    if a.mode != "normal":
        offset = info.contig_lengths
        if a.mode == "gapped" and len({len(o) for o in offset}) > 1:
            print("Warning: gapped mode requires the same number of sequences "
                  "per input FASTA file. Using delineated mode instead.",
                  file=sys.stderr)
            a.mode = "delineated"
            a.multilengths = offset
        elif a.mode == "gapped":
            a.multilengths = np.array(offset)
        else:
            a.multilengths = offset
    if a.mode == "gapped":
        a.spacer = a.spacer * a.multilengths.max(axis=0).max()

    order = None
    if a.filelist:
        cur_order = list(info.paths)
        file_order = [l.split()[0] for l in
                      open(a.filelist).read().splitlines() if l.split()]
        try:
            order = np.array([cur_order.index(l) for l in file_order])
        except ValueError:
            print("Error: sequence in filelist not found in lengths file.",
                  file=sys.stderr)
            return 1
        seq_lengths = [seq_lengths[i] for i in order]
        if a.mode == "gapped":
            a.multilengths = a.multilengths[order]
        elif a.mode == "delineated":
            a.multilengths = [a.multilengths[i] for i in order]

    genome_names = None
    if a.labels:
        if a.labels.endswith(".lengths"):
            linfo = formats.parse_lengths(a.labels)
            genome_names = [os.path.splitext(os.path.basename(l))[0]
                            for l in linfo.paths]
            if order is not None:
                genome_names = [genome_names[i] for i in order]
        else:
            genome_names = open(a.labels).read().splitlines()

    mums = MUMdata(a.mumfile, lenfilter=a.lenfilter, subsample=a.subsample,
                   verbose=a.verbose)
    if a.verbose:
        print(f"Found {mums.num_mums} MUMs", file=sys.stderr)
    if order is not None:
        mums.starts = mums.starts[:, order]
        mums.strands = mums.strands[:, order]

    max_length = max(seq_lengths)
    if a.center:
        centering = [(max_length - g) / 2 for g in seq_lengths]
    else:
        centering = [0.0] * len(seq_lengths)

    if a.no_coll_block:
        if a.mode == "gapped":
            offset_mums(a, mums)
        polygons, colors = get_mum_polygons(mums, centering, a.mum_color,
                                            a.inv_color)
    else:
        if mums.blocks is None:
            mums.filter_pmums()
            if len(mums) == 0:
                print("No strict MUMs found after filtering. Try "
                      "--no-coll-block", file=sys.stderr)
                return 0
            if a.max_break is None:
                bp_per_inch = max_length / (a.dpi * a.size[0])
                a.max_break = int(min(bp_per_inch, 100000))
            blocks = find_coll_blocks(mums, max_break=a.max_break,
                                      verbose=a.verbose)
        else:
            blocks = mums.blocks
        if a.mode == "gapped":
            blocks = offset_mums(a, mums, spacer=a.spacer, blocks=blocks)
        polygons, colors = get_block_polygons(blocks, mums, centering,
                                              a.mum_color, a.inv_color)

    if a.interactive:
        # interactive HTML output (viz_mums_interactive.py counterpart);
        # self-contained SVG+JS, no plotly dependency
        from mumemto_tpu_torch.analysis.viz_interactive import write_html
        out = write_html(a.filename, seq_lengths, polygons, colors,
                         centering, genome_names, alpha=a.alpha,
                         title=os.path.basename(a.prefix))
    else:
        out = _plot(a, seq_lengths, polygons, colors, centering,
                    genomes=genome_names)
    if a.verbose:
        print(f"Wrote {out}", file=sys.stderr)
    return 0
