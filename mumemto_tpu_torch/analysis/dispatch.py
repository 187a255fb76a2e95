"""Subcommand implementations for the mumemto-compatible CLI.

Each subcommand mirrors the corresponding reference tool:
  collinear -> mumemto/collinear_block.py
  convert/view -> mumemto/mum_to_bumbl.py
  coverage -> mumemto/mum_coverage.py
  extract  -> mumemto/extract_mums.py (and src/extract_mums.cpp)
  lengths  -> src/compute_lengths.cpp
  viz      -> mumemto/viz_mums.py
  inversion-> mumemto/find_inversions.py
  label    -> mumemto/get_sequence_info.py
  bed      -> mumemto/mum_to_bed.py
  merge    -> mumemto/merge_mums.py
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from mumemto_tpu_torch import formats
from mumemto_tpu_torch.analysis.mumdata import MUMdata, find_coll_blocks


def _resolve_mumfile(prefix=None, mumfile=None, parser=None):
    if mumfile:
        return mumfile, os.path.splitext(mumfile)[0]
    if prefix:
        if prefix.endswith((".mums", ".bumbl")):
            prefix = os.path.splitext(prefix)[0]
        if os.path.exists(prefix + ".bumbl"):
            return prefix + ".bumbl", prefix
        if os.path.exists(prefix + ".mums"):
            return prefix + ".mums", prefix
    if parser:
        parser.error("Either --mums or --input-prefix must be provided")
    raise FileNotFoundError("no MUM file found")


def run_collinear(argv) -> int:
    ap = argparse.ArgumentParser(prog="mumemto collinear",
                                 description="Computes collinear blocks of MUMs")
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--input-prefix", "-i", dest="prefix")
    g.add_argument("--mums", "-m", dest="mumfile")
    ap.add_argument("--fout", "-o", dest="filename")
    ap.add_argument("--max-gap-len", "-g", dest="max_break", default=1000, type=int)
    ap.add_argument("--verbose", "-v", action="store_true")
    ap.add_argument("--min-singleton-length", dest="min_singleton_length",
                    type=int, default=None)
    args = ap.parse_args(argv)
    mumfile, _prefix = _resolve_mumfile(args.prefix, args.mumfile, ap)
    if args.filename is None:
        base, ext = os.path.splitext(mumfile)
        args.filename = base + "_sorted" + ext
    mums = MUMdata(mumfile, verbose=args.verbose)
    if args.verbose:
        print(f"Found {mums.num_mums} MUMs", file=sys.stderr)
    mums.filter_pmums()
    if len(mums) == 0:
        print("No strict MUMs found after filtering partial MUMs.",
              file=sys.stderr)
        return 0
    blocks = find_coll_blocks(mums, max_break=args.max_break,
                              verbose=args.verbose,
                              min_singleton_length=args.min_singleton_length)
    if args.verbose:
        print(f"found {len(blocks)} collinear blocks", file=sys.stderr)
    if args.filename.endswith(".mums"):
        mums.write_mums(args.filename, blocks=blocks)
    elif args.filename.endswith(".bumbl"):
        mums.write_bums(args.filename, blocks=blocks)
    else:
        mums.write_mums(args.filename + ".mums", blocks=blocks)
    return 0


def run_convert(argv) -> int:
    ap = argparse.ArgumentParser(prog="mumemto convert",
                                 description="Converts mum and bumbl formats")
    ap.add_argument("--mums", "-m", dest="mumfile")
    ap.add_argument("--bumbl", "-b", dest="bumfile")
    ap.add_argument("--length-upsize", "-l", action="store_true",
                    help="convert a u16-length bumbl to u32 lengths "
                         "(mum_to_bumbl.py:150-159)")
    ap.add_argument("--fout", "-o", dest="out")
    ap.add_argument("--verbose", "-v", action="store_true")
    ap.add_argument("--chunk-size", "-c", type=int, default=8,
                    help="rows per output chunk (accepted for parity; "
                         "writes are vectorized)")
    args = ap.parse_args(argv)
    if args.mumfile is None and args.bumfile is None:
        ap.print_help()
        return 0
    if args.length_upsize:
        if not (args.bumfile and os.path.exists(args.bumfile)):
            ap.error("--length-upsize requires an existing --bumbl input")
        mums = MUMdata(args.bumfile, sort=False)
        out = args.out or args.bumfile
        mums.write_bums(out, blocks=mums.blocks)  # writer emits u32 lengths
        return 0
    to_bum = True
    if args.mumfile and os.path.exists(args.mumfile):
        to_bum = True
        out = args.out or args.bumfile or args.mumfile.replace(".mums", ".bumbl")
    elif args.bumfile and os.path.exists(args.bumfile):
        to_bum = False
        out = args.out or args.mumfile or "-"
    else:
        ap.error("input file does not exist")
    mums = MUMdata(args.mumfile if to_bum else args.bumfile, sort=False)
    if to_bum:
        mums.write_bums(out, blocks=mums.blocks)
    elif out == "-":
        _write_mums_stdout(mums)
    else:
        mums.write_mums(out, blocks=mums.blocks)
    return 0


def _write_mums_stdout(mums: MUMdata):
    for i in range(mums.num_mums):
        st = ["+" if s else "-" for s in mums.strands[i]]
        sys.stdout.write(f"{mums.lengths[i]}\t"
                         f"{','.join(map(str, mums.starts[i]))}\t"
                         f"{','.join(st)}\n")


def run_view(argv) -> int:
    ap = argparse.ArgumentParser(prog="mumemto view",
                                 description="View a bumbl file as text MUMs")
    ap.add_argument("bumfile")
    args = ap.parse_args(argv)
    mums = MUMdata(args.bumfile, sort=False)
    _write_mums_stdout(mums)
    return 0


def _get_lengths_info(lens_path):
    info = formats.parse_lengths(lens_path)
    return info.paths, info.totals


def run_coverage(argv) -> int:
    ap = argparse.ArgumentParser(prog="mumemto coverage",
                                 description="Aggregates MUM coverage")
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--input-prefix", "-i", dest="prefix")
    g.add_argument("--mums", "-m", dest="mumfile")
    ap.add_argument("--lengths", "-l", dest="lens")
    ap.add_argument("--len-filter", "-L", dest="lenfilter", default=0, type=int)
    ap.add_argument("--seq-idx", "-s", dest="seq_idx", default=0, type=int)
    ap.add_argument("--verbose", "-v", action="store_true")
    args = ap.parse_args(argv)
    mumfile, prefix = _resolve_mumfile(args.prefix, args.mumfile, ap)
    lens = args.lens or prefix + ".lengths"
    _, totals = _get_lengths_info(lens)
    if args.seq_idx >= len(totals) or args.seq_idx < 0:
        print(f"Error: sequence index {args.seq_idx} is out of range "
              f"(0-{len(totals)-1})", file=sys.stderr)
        return 1
    target_length = totals[args.seq_idx]
    coverage = np.zeros(target_length, dtype=bool)
    mums = MUMdata(mumfile, sort=False)
    for i in range(mums.num_mums):
        start = int(mums.starts[i, args.seq_idx])
        length = int(mums.lengths[i])
        if start != -1 and length >= args.lenfilter:
            coverage[start:start + length] = True
    pct = np.count_nonzero(coverage) * 100 / target_length
    print(f"seq{args.seq_idx}: {pct:.3f}%", file=sys.stderr)
    return 0


def run_extract(argv) -> int:
    """Extract MUM substrings of one genome to FASTA with '#' terminators
    (extract_mums.py / src/extract_mums.cpp:92-116)."""
    from mumemto_tpu_torch.refbuilder import read_fasta, revcomp

    ap = argparse.ArgumentParser(prog="mumemto extract",
                                 description="Extract the MUM sequences")
    ap.add_argument("-m", "--mumfile", type=str, required=True)
    ap.add_argument("-i", "--index", type=int, default=0)
    ap.add_argument("-o", "--output", type=str)
    ap.add_argument("-f", "--filelist", type=str)
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)
    if args.filelist is None:
        args.filelist = os.path.splitext(args.mumfile)[0] + ".lengths"
        if not os.path.exists(args.filelist):
            raise FileNotFoundError(
                f"Filelist {args.filelist} not found, and no filelist provided")
    if args.output is None:
        args.output = os.path.splitext(args.mumfile)[0] + "_mums.fa"
    if not args.output.endswith((".fa", ".fasta")):
        args.output += ".fa"
    paths, totals = _get_lengths_info(args.filelist)
    path = paths[args.index]
    _names, seqs = read_fasta(path)
    seq = np.concatenate(seqs)
    assert seq.size == totals[args.index], (
        f"Sequence length {seq.size} does not match expected length "
        f"{totals[args.index]}.")
    mums = MUMdata(args.mumfile, sort=False)
    out = []
    for i in range(mums.num_mums):
        out.append(f">mum_{i}")
        st = int(mums.starts[i, args.index])
        cur = seq[st:st + int(mums.lengths[i])]
        if mums.strands[i, args.index]:
            out.append(bytes(cur).decode() + "#")
        else:
            out.append(bytes(revcomp(cur)).decode() + "#")
    with open(args.output, "w") as f:
        f.write("\n".join(out))
    return 0


def run_lengths(argv) -> int:
    """Recompute .lengths for FASTA inputs (src/compute_lengths.cpp:87-170)."""
    from mumemto_tpu_torch.refbuilder import read_fasta

    ap = argparse.ArgumentParser(prog="mumemto lengths",
                                 description="Recompute sequence lengths")
    ap.add_argument("files", nargs="*")
    ap.add_argument("-i", "--input", dest="input_list", default="")
    ap.add_argument("-o", "--output", dest="output_prefix", default="output")
    ap.add_argument("-p", "--processed", action="store_true",
                    help="also write each input's concatenated fwd$rc$ "
                         "sequence as a FASTA (compute_lengths.cpp:150-160)")
    args = ap.parse_args(argv)
    files = args.files
    if args.input_list:
        from mumemto_tpu_torch.cli import read_filelist
        files = read_filelist(args.input_list)
    if not files:
        ap.error("need input FASTA files")
    names, lengths = [], []
    for p in files:
        nn, ss = read_fasta(p)
        names.append(nn)
        lengths.append([int(s.size) for s in ss])
        if args.processed:
            from mumemto_tpu_torch.refbuilder import revcomp
            fwd = np.concatenate(ss) if len(ss) > 1 else ss[0]
            doc = (fwd.tobytes() + b"$" + revcomp(fwd).tobytes() + b"$")
            base = os.path.basename(p)
            for ext in (".fa.gz", ".fasta.gz", ".fna.gz", ".fa", ".fasta",
                        ".fna"):
                if base.endswith(ext):
                    base = base[: -len(ext)]
                    break
            out = os.path.join(os.path.dirname(args.output_prefix) or ".",
                               base + "_processed.fa")
            with open(out, "wb") as f:
                f.write(b">" + base.encode() + b"_processed\n" + doc + b"\n")
    formats.write_lengths(args.output_prefix + ".lengths", files, names, lengths)
    return 0


def run(sub: str, argv) -> int:
    handlers = {
        "collinear": run_collinear,
        "convert": run_convert,
        "view": run_view,
        "coverage": run_coverage,
        "extract": run_extract,
        "lengths": run_lengths,
    }
    if sub in handlers:
        return handlers[sub](argv)
    if sub == "viz":
        from mumemto_tpu_torch.analysis import viz
        return viz.run(argv)
    if sub == "inversion":
        from mumemto_tpu_torch.analysis import inversions
        return inversions.run(argv)
    if sub == "label":
        from mumemto_tpu_torch.analysis import label
        return label.run(argv)
    if sub == "bed":
        from mumemto_tpu_torch.analysis import bed
        return bed.run(argv)
    if sub == "merge":
        from mumemto_tpu_torch.analysis import merge
        return merge.run(argv)
    if sub == "trim":
        from mumemto_tpu_torch.analysis import trim
        return trim.run(argv)
    if sub == "density":
        from mumemto_tpu_torch.analysis import density
        return density.run(argv)
    if sub == "tabix":
        from mumemto_tpu_torch.analysis import tabix
        return tabix.run(argv)
    if sub == "convert-thresh":
        from mumemto_tpu_torch.analysis import convert_thresh
        return convert_thresh.run(argv)
    print(f"Unknown subcommand: {sub}", file=sys.stderr)
    return 1
