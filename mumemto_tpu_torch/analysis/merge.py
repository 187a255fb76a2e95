"""`merge` subcommand: MumemtoM partition merging, anchor- or string-based.

A copy of mumemto_tpu/analysis/merge.py with the string merge's recursive
"MUMs of MUMs" scan on the port's engine, on `device`. `--collective`
runs the anchor fold on `device` (parallel/collective_merge.py).

Mirrors:
  * anchor merge: src/merge_candidates.cpp (parse_candidate :62-95,
    fix_neg_strand :97-104, merge_partitions :106-157, left-fold :211-219)
  * string merge: mumemto/merge_mums.py (remove_start_dollar :119-139,
    threshold filter + recomposition :246-297, threshold re-sort :299-318)
  * lengths merging: merge_mums.py:58-117

Note on ordering: the reference's string-merge chain mixes file-order MUM
extraction with offset-sorted thresholds; it only lines up when partition
.mums are sorted by the first-genome offset. We make that explicit: MUMs are
sorted by first-genome offset before extraction, matching the .thresh layout
(mem_finder.hpp:128-130 sorts thresholds that way).

Known structural limitation (shared with the reference): a MUM that crosses
a document's internal fwd$rc boundary (possible when documents share an
exact terminal k-mer: tail + '$' + mirrored rc head match across docs)
cannot round-trip through STRING merging — extraction reads only the first
genome's forward FASTA (extract_mums.cpp:92-116), so the crossing portion
is lost: the merged set either drops such a MUM or keeps only its
fwd-truncated prefix (whichever the threshold test admits). Anchor
merging carries
per-position thresholds over fwd+rev anchor coordinates and recovers such
matches; prefer -Mn for collections with shared terminal sequence.
tests/test_merge.py::test_string_merge_boundary_crossing_limitation pins
this behavior.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from mumemto_tpu_torch import formats
from mumemto_tpu_torch.analysis.mumdata import MUMdata

MIN_MERGE_LEN = 20


# ---------------------------------------------------------------------------
# anchor merge (merge_candidates.cpp)
# ---------------------------------------------------------------------------

def parse_candidate(mums_path: str):
    """(mums sorted by anchor offset, anchor bitvector, thresholds)."""
    base = mums_path[:-6] if mums_path.endswith(".bumbl") else mums_path[:-5]
    nb = formats.read_thresh(base + ".athresh").astype(np.int64)
    if mums_path.endswith(".bumbl"):
        lengths, starts, strands, _, flags = formats.parse_bumbl(mums_path)
        if flags & formats.FLAG_PARTIAL:
            raise ValueError("Cannot parse partial bumbl for anchor merge")
    else:
        lengths, starts, strands = formats.parse_mums(mums_path)
        if (starts == -1).any():
            raise ValueError("Cannot merge partial MUMs; filter to strict MUMs")
    bv = np.zeros(nb.size, dtype=bool)
    bv[starts[:, 0]] = True
    order = np.argsort(starts[:, 0], kind="stable")
    return (lengths[order].astype(np.int64), starts[order],
            strands[order], bv, nb)


def merge_partitions(p1, p2):
    """One fold of the anchor merge (merge_candidates.cpp:106-157)."""
    l1, s1, t1, bv1, nb1 = p1
    l2, s2, t2, bv2, nb2 = p2
    n_anchor = nb1.size
    new_nb = np.where((nb1 > 0) & (nb2 > 0), np.maximum(nb1, nb2), 0)

    # positions where a candidate check happens
    check = (bv1 | bv2) & (nb1 > 0) & (nb2 > 0)
    pos = np.flatnonzero(check)
    # current MUM per side at each position: index of last start <= pos
    starts1 = s1[:, 0]
    starts2 = s2[:, 0]
    idx1 = np.searchsorted(starts1, pos, side="right") - 1
    idx2 = np.searchsorted(starts2, pos, side="right") - 1
    ok = (idx1 >= 0) & (idx2 >= 0)

    # fully vectorized over the (sparse) event positions: the reference's
    # per-anchor-position scan touches |anchor| positions; candidate
    # emissions only happen at MUM-start events, so everything below is
    # O(#events) numpy
    new_bv = np.zeros(n_anchor, dtype=bool)
    t = np.flatnonzero(ok)
    i = pos[t]
    m1 = idx1[t]
    m2 = idx2[t]
    delta1 = i - starts1[m1]
    delta2 = i - starts2[m2]
    covered = (delta1 <= l1[m1]) & (delta2 <= l2[m2])
    s1_len = l1[m1] - delta1
    s2_len = l2[m2] - delta2
    new_len = np.minimum(s1_len, s2_len)
    emit = covered & (new_len > new_nb[i]) & (new_len >= MIN_MERGE_LEN)

    i, m1, m2 = i[emit], m1[emit], m2[emit]
    delta1, delta2 = delta1[emit], delta2[emit]
    s1_len, s2_len = s1_len[emit], s2_len[emit]
    lengths = new_len[emit].astype(np.int64)
    # '+' offsets shift by the left trim, '-' by the right trim
    # (merge_candidates.cpp:97-104), broadcast over the offset columns
    off1 = s1[m1] + np.where(t1[m1], delta1[:, None],
                             (s1_len - lengths)[:, None])
    off2 = s2[m2] + np.where(t2[m2], delta2[:, None],
                             (s2_len - lengths)[:, None])
    starts = np.concatenate([off1, off2[:, 1:]], axis=1)
    strands = np.concatenate([t1[m1], t2[m2][:, 1:]], axis=1)
    new_bv[off1[:, 0]] = True

    order = np.argsort(starts[:, 0], kind="stable") if lengths.size else \
        np.zeros(0, np.int64)
    return (lengths[order], starts[order], strands[order], new_bv, new_nb)


def anchor_merge(mum_files, output: str, verbose: bool = False):
    cur = parse_candidate(mum_files[0])
    for p in mum_files[1:]:
        if verbose:
            print(f"merging in {os.path.basename(p)}", file=sys.stderr)
        cur = merge_partitions(cur, parse_candidate(p))
    lengths, starts, strands, _bv, nb = cur

    out_path = output
    if not out_path.endswith((".mums", ".bumbl")):
        out_path += ".mums"
    base = out_path[:-6] if out_path.endswith(".bumbl") else out_path[:-5]
    md = MUMdata.from_arrays(lengths.astype(np.uint32), starts, strands)
    if out_path.endswith(".bumbl"):
        md.write_bums(out_path)
    else:
        md.write_mums(out_path)
    formats.write_thresh(base + ".athresh", nb)
    return out_path


# ---------------------------------------------------------------------------
# lengths merging (merge_mums.py:58-117)
# ---------------------------------------------------------------------------

def _normalize_lines(lines):
    counts = np.array([len(l) for l in lines])
    if np.all(counts == 3) or np.all(counts == 2):
        return lines
    out = []
    for l in lines:
        if len(l) == 3:
            out.append(l)
        else:
            out.append([l[0], "*", l[1]])
            out.append([l[0], os.path.basename(l[0]), l[1]])
    return out


def merge_anchor_lengths(paths, output_base: str):
    length_files = [p + ".lengths" for p in paths]
    with open(length_files[0]) as f:
        anchor = os.path.basename(f.readline().split()[0])
    for lf in length_files:
        with open(lf) as f:
            if os.path.basename(f.readline().split()[0]) != anchor:
                raise ValueError(
                    "Cannot perform anchor-merge: anchor sequence is not "
                    "identical in each partition.")
    lines = []
    first = True
    for lf in length_files:
        with open(lf) as f:
            for l in f.read().splitlines():
                l = l.split()
                if l and (first or os.path.basename(l[0]) != anchor):
                    lines.append(l)
        first = False
    with open(output_base + ".lengths", "w") as out:
        out.write("\n".join(" ".join(l) for l in _normalize_lines(lines)))


def merge_lengths(paths, output_base: str):
    lines = []
    for p in paths:
        with open(p + ".lengths") as f:
            for l in f.read().splitlines():
                if l.split():
                    lines.append(l.split())
    with open(output_base + ".lengths", "w") as out:
        out.write("\n".join(" ".join(l) for l in _normalize_lines(lines)))


# ---------------------------------------------------------------------------
# string merge (merge_mums.py main path)
# ---------------------------------------------------------------------------

def _extract_sorted_mums_fasta(mum_file: str, lengths_file: str, out_fa: str):
    """Extract first-genome MUM substrings (sorted by offset) with '#'
    terminators (extract_mums.cpp:92-116 + ordering note above)."""
    from mumemto_tpu_torch.refbuilder import read_fasta

    info = formats.parse_lengths(lengths_file)
    path0 = info.paths[0]
    _names, seqs = read_fasta(path0)
    seq = np.concatenate(seqs)
    mums = MUMdata(mum_file, sort=True)
    if (mums.starts == -1).any():
        raise ValueError("Partial MUMs detected. Aborting merge.")
    with open(out_fa, "w") as f:
        for i in range(mums.num_mums):
            st = int(mums.starts[i, 0])
            f.write(f">mum_{i}\n")
            f.write(bytes(seq[st:st + int(mums.lengths[i])]).decode() + "#\n")


def _split_grand_mum(mum, sep_bv):
    """Split one grand-MUM at '#' record boundaries (semantics of the
    reference's remove_start_dollar, merge_mums.py:119-139, re-derived).

    Separators inside the match (doc-0 coordinates, relative offsets
    seps[]) cut it into segments [a, b); segments shorter than
    MIN_MERGE_LEN are dropped. A segment's start in set i is starts[i] + a
    on the '+' strand and mirrors to starts[i] + (l - a - len) on '-'.
    """
    l, starts, strands = mum
    st = np.asarray(starts, dtype=np.int64)
    fwd = np.asarray(strands, dtype=bool)
    seps = np.flatnonzero(sep_bv[st[0]: st[0] + l])
    if seps.size == 0:
        return [(l, starts, strands)]
    seg_lo = np.concatenate(([0], seps + 1))
    seg_hi = np.concatenate((seps, [l]))
    out = []
    for a, b in zip(seg_lo.tolist(), seg_hi.tolist()):
        seg_len = b - a
        if seg_len >= MIN_MERGE_LEN:
            out.append((seg_len,
                        np.where(fwd, st + a, st + (l - a - seg_len)),
                        strands))
    return out


def string_merge(mum_files, paths, output: str, output_base: str,
                 merged_mums: str | None = None, verbose: bool = False,
                 device="cuda"):
    """merge_mums.py main string-merging path, with the recursive "MUMs of
    MUMs" run (when merged_mums is None) on the port's engine on `device`."""
    merge_lengths(paths, output_base)

    cleanup = merged_mums is None
    if merged_mums is None:
        # extract MUM fastas + run the engine on them
        from mumemto_tpu_torch import engine, options, refbuilder

        fas = []
        for mf, p in zip(mum_files, paths):
            fa = p + "_mums.fa"
            _extract_sorted_mums_fasta(mf, p + ".lengths", fa)
            fas.append(fa)
        rb = refbuilder.build_from_files(fas, use_revcomp=True)
        temp_base = output_base + "_temp_merged"
        rb.write_lengths_file(temp_base)
        opts = options.normalize(rb.num_docs, quiet=not verbose)
        results = engine.find_matches(rb, opts, device=device)
        engine.write_outputs(results, rb, temp_base)
        merged_mums = temp_base + ".mums"

    premerge = [MUMdata(m, sort=True) for m in mum_files]
    info = formats.parse_lengths(os.path.splitext(merged_mums)[0] + ".lengths")
    mum_lens = info.contig_lengths
    num_sets = len(mum_lens)
    assert num_sets == len(paths), (
        "input # of MUM files does not match merged MUM input file")

    mum_starts = [np.cumsum(np.asarray(lens, dtype=np.int64))
                  for lens in mum_lens]
    set1_bv = np.zeros(int(sum(mum_lens[0])) + 1, dtype=bool)
    set1_bv[mum_starts[0] - 1] = True
    # also split at the document terminator '$' right after the last '#'
    # (grand-MUMs can start at/span it; the reference indexes out of bounds
    # on such matches — we split them away instead)
    set1_bv[-1] = True
    mum_offsets = [np.concatenate(([0], st)) for st in mum_starts]

    thresholds = [formats.read_thresh(p + ".thresh").astype(np.int64)
                  for p in paths]
    rev_thresholds = [formats.read_thresh(p + ".thresh_rev").astype(np.int64)
                      for p in paths]

    # stream merged grand-MUMs in file order, split at '#'
    g_lengths, g_starts, g_strands = formats.parse_mums(merged_mums)
    dollar_less = []
    for i in range(len(g_lengths)):
        dollar_less.extend(_split_grand_mum(
            (int(g_lengths[i]), g_starts[i], g_strands[i]), set1_bv))

    merged = []
    mum_positions = []
    new_thresholds = []
    new_thresholds_rev = []
    total0 = int(sum(mum_lens[0]))
    for (l, starts, strands) in dollar_less:
        # segments must lie within the forward MUM-record region of doc 0:
        # matches crossing into the revcomp half are mirror duplicates of
        # forward matches and are dropped (the reference indexes OOB there)
        if starts[0] < 0 or starts[0] + l > total0:
            continue
        offset = []
        ok = True
        mumids = []
        for i in range(num_sets):
            mumid = int(np.searchsorted(mum_starts[i], starts[i], side="right"))
            mumids.append(mumid)
            offset.append((int(starts[i] - mum_offsets[i][mumid]),
                           int(mum_offsets[i][mumid + 1] - starts[i] - l - 1)))
            thresh = thresholds[i][starts[i]]
            if thresh == 0 or l <= thresh:
                ok = False
                break
        if not ok:
            continue
        new_starts = []
        new_strands = []
        for i in range(num_sets):
            m = premerge[i][mumids[i]]
            for s, strand in zip(m.starts, m.strands):
                new_starts.append(int(s) + (offset[i][0] if strand else offset[i][1]))
                new_strands.append(bool(strand) if strands[i] else not strand)
        merged.append((int(l), tuple(new_starts), tuple(new_strands)))
        mum_positions.append(new_starts[0])

        cur_t, cur_r = [], []
        for i in range(num_sets):
            fwd = thresholds[i][starts[i]: starts[i] + l]
            rev = rev_thresholds[i][
                mum_offsets[i][mumids[i]] + offset[i][1]:
                mum_offsets[i][mumids[i] + 1] - 1 - offset[i][0]]
            if strands[i]:
                cur_t.append(fwd)
                cur_r.append(rev)
            else:
                cur_r.append(fwd)
                cur_t.append(rev)
        cur_t = np.array(cur_t)
        cur_r = np.array(cur_r)
        new_thresholds.append(
            np.where(np.all(cur_t > 0, axis=0), np.max(cur_t, axis=0), 0))
        new_thresholds_rev.append(
            np.where(np.all(cur_r > 0, axis=0), np.max(cur_r, axis=0), 0))

    order = np.argsort(np.asarray(mum_positions), kind="stable") \
        if mum_positions else np.zeros(0, dtype=np.int64)
    tm, trm = [], []
    for o in order:
        tm.extend(new_thresholds[o])
        tm.append(0)
        trm.extend(new_thresholds_rev[o])
        trm.append(0)

    ordered = [merged[o] for o in order]
    lengths = np.array([m[0] for m in ordered], dtype=np.uint32)
    n_out_seqs = len(ordered[0][1]) if ordered else sum(
        p.num_seqs for p in premerge)
    starts = np.array([m[1] for m in ordered], dtype=np.int64).reshape(
        len(ordered), n_out_seqs)
    strands = np.array([m[2] for m in ordered], dtype=bool).reshape(
        len(ordered), n_out_seqs)
    md = MUMdata.from_arrays(lengths, starts, strands)
    if output.endswith(".bumbl"):
        md.write_bums(output)
    else:
        md.write_mums(output)
    formats.write_thresh(output_base + ".thresh",
                         np.asarray(tm, dtype=np.uint16))
    formats.write_thresh(output_base + ".thresh_rev",
                         np.asarray(trm, dtype=np.uint16))
    if cleanup:
        for p in paths:
            if os.path.exists(p + "_mums.fa"):
                os.remove(p + "_mums.fa")
        for ext in (".mums", ".lengths"):
            f = output_base + "_temp_merged" + ext
            if os.path.exists(f):
                os.remove(f)
    return output


# ---------------------------------------------------------------------------
# CLI entry (merge_mums.py parse_arguments/main)
# ---------------------------------------------------------------------------

def run(argv) -> int:
    """merge_mums.py parse_arguments/main, as mumemto_tpu's merge.run,
    plus --device for the string merge's scan."""
    ap = argparse.ArgumentParser(prog="mumemto merge",
                                 description="Merge MUMs files")
    ap.add_argument("--merged_mums", "-m",
                    help="Path to MUMs of MUMs file (string merging only)")
    ap.add_argument("mum_files", nargs="+")
    ap.add_argument("--output", "-o", default="merged")
    ap.add_argument("--verbose", "-v", action="store_true")
    ap.add_argument("--collective", action="store_true",
                    help="run the anchor-merge fold on the device: the "
                         "per-partition anchor metadata spread over the "
                         "visible cards, one gather, a vectorized fold "
                         "(anchor mode only)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the string merge's scan and of "
                         "the --collective fold (default: cuda)")
    args = ap.parse_args(argv)
    if len(args.mum_files) < 2:
        ap.error("At least two MUMs files are required for merging")

    output = args.output
    if not output.endswith((".bumbl", ".mums")):
        output += ".mums"
    output_base = output[:-6] if output.endswith(".bumbl") else output[:-5]

    paths = []
    for mf in args.mum_files:
        if mf.endswith(".mums"):
            paths.append(mf[:-5])
        elif mf.endswith(".bumbl"):
            paths.append(mf[:-6])
        else:
            ap.error(f"Invalid input: {mf}. Input must end with .mums or .bumbl.")

    if all(os.path.exists(p + ".athresh") for p in paths):
        if args.merged_mums is not None:
            print("Error: -m is only for string merging, but anchor-based "
                  "merging detected. Ignoring -m.", file=sys.stderr)
        merge_anchor_lengths(paths, output_base)
        if args.collective:
            from mumemto_tpu_torch.parallel import collective_merge
            collective_merge.collective_anchor_merge(
                args.mum_files, output, device=args.device,
                verbose=args.verbose)
        else:
            anchor_merge(args.mum_files, output, verbose=args.verbose)
        return 0

    if args.collective:
        print("Error: --collective applies to anchor-based merging only "
              "(.athresh inputs).", file=sys.stderr)
        return 1

    if not all(os.path.exists(p + ".thresh") for p in paths):
        print("Error: *.thresh or *.athresh files required for all inputs "
              "for merging.", file=sys.stderr)
        return 1
    string_merge(args.mum_files, paths, output, output_base,
                 merged_mums=args.merged_mums, verbose=args.verbose,
                 device=args.device)
    return 0
