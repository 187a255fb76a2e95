"""mumemto-compatible build command for the PyTorch port.

    python -m mumemto_tpu_torch a.fa b.fa ... -o out [--device cuda]

Parses the same build flags as mumemto_tpu/cli.py (src/pfp_mum.cpp:255-313
in the reference) plus --device, and writes PREFIX.lengths and PREFIX.mums
(.mems with -f != 1, .bumbl with -b), plus .thresh/.thresh_rev with -M or
.athresh with -M -n, and .sa/.lcp/.bwt with -A. -P writes .dict/.parse
and stops; -p resumes from them, -a replays .sa/.lcp/.bwt files, -g runs
the direct backend. --seq-shards and the subcommands are not ported yet
and fail with a "not yet ported" error instead of being ignored.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

VERSION = "1.4.0"

SUBCOMMANDS = ("viz", "inversion", "coverage", "collinear", "convert", "view",
               "extract", "label", "lengths", "merge", "bed", "trim",
               "density", "tabix", "convert-thresh", "mori")


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="mumemto_tpu_torch",
        description="mumemto - find maximal [unique | exact] matches using "
                    "PFP (PyTorch port).")
    ap.add_argument("files", nargs="*", help="input FASTA files")
    ap.add_argument("-i", "--input", dest="input_list", default="",
                    help="path to a file-list of genomes (overrides positional args)")
    ap.add_argument("-o", "--output", dest="output_prefix", default="output",
                    help="output prefix path")
    ap.add_argument("-r", "--no-revcomp", dest="use_rcomp", action="store_false",
                    help="do not include the reverse complement")
    ap.add_argument("-b", "--binary", action="store_true",
                    help="output binary format (multi-MUMs only)")
    ap.add_argument("-A", "--arrays-out", action="store_true",
                    help="write LCP, BWT, and SA to file")
    ap.add_argument("-a", "--arrays-in", default="",
                    help="compute matches from precomputed arrays (PREFIX.bwt/sa/lcp)")
    ap.add_argument("-M", "--merge", action="store_true",
                    help="output extra metadata to enable merging multi-MUMs")
    ap.add_argument("-n", "--anchor", dest="anchor_merge", action="store_true",
                    help="use anchor-based merging (requires -M)")
    ap.add_argument("-l", "--min-match-len", type=int, default=20)
    ap.add_argument("-k", "--minimum-genomes", dest="num_distinct_docs",
                    type=int, default=0)
    ap.add_argument("-f", "--per-seq-freq", dest="rare_freq", type=int, default=1)
    ap.add_argument("-F", "--max-total-freq", dest="max_mem_freq", type=int,
                    default=0)
    ap.add_argument("-w", "--window", dest="pfp_w", type=int, default=10)
    ap.add_argument("-m", "--modulus", dest="hash_mod", type=int, default=100)
    ap.add_argument("-p", "--from-parse", dest="parse_prefix", default="")
    ap.add_argument("-K", "--keep-temp-files", action="store_true",
                    help="accepted for reference-CLI compatibility; the PFP "
                         "is in-memory, so no temp .dict/.parse files exist")
    ap.add_argument("-g", "--use-gsacak", action="store_true",
                    help="use the direct suffix-array backend (no PFP)")
    ap.add_argument("-P", "--only-parse", action="store_true")
    ap.add_argument("--seq-shards", type=int, default=0, metavar="N",
                    help="shard one collection's scan over N devices")
    ap.add_argument("-s", "--no-overlap", dest="overlap", action="store_false",
                    help=argparse.SUPPRESS)  # parsed but unused (legacy)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run the scan on (default: cuda)")
    ap.add_argument("--version", action="version", version=VERSION)
    return ap


def read_filelist(path: str) -> list:
    files = []
    with open(path) as f:
        for line in f:
            words = line.split()
            if words:
                files.append(words[0])
    return files


def _unported_flags(args) -> list:
    """The given flags whose code paths the port does not have yet."""
    return ["--seq-shards"] if args.seq_shards != 0 else []


def _options(args, rb):
    from mumemto_tpu import options
    return options.normalize(
        rb.num_docs, min_match_len=args.min_match_len,
        num_distinct_docs=args.num_distinct_docs, rare_freq=args.rare_freq,
        max_mem_freq=args.max_mem_freq, use_revcomp=args.use_rcomp,
        merge=args.merge, anchor_merge=args.anchor_merge, binary=args.binary)


def build_main(argv) -> int:
    from mumemto_tpu import formats, refbuilder
    from mumemto_tpu_torch import engine
    from mumemto_tpu_torch.device import resolve

    args = build_argparser().parse_args(argv)
    unported = _unported_flags(args)
    if unported:
        print("Error: not yet ported to mumemto_tpu_torch: "
              + ", ".join(unported) + " (see ROADMAP.md; use "
              "python -m mumemto_tpu for these)", file=sys.stderr)
        return 2
    if args.input_list:
        if args.files:
            print("[build_main] Using filelist, ignoring positional args",
                  file=sys.stderr)
        files = read_filelist(args.input_list)
    else:
        files = args.files
    if not files and not args.arrays_in and not args.parse_prefix:
        print("Error: Need to provide a file-list or files as positional args "
              "for processing.", file=sys.stderr)
        return 1
    device = resolve(args.device)

    if args.arrays_in:
        # -a: replay PREFIX.sa/.lcp/.bwt (+ .lengths), pfp_mum.cpp:97-110
        rb = refbuilder.build_from_lengths(args.arrays_in,
                                           use_revcomp=args.use_rcomp)
        sa = formats.read_5byte(args.arrays_in + ".sa").astype(np.int64)
        lcp = formats.read_5byte(args.arrays_in + ".lcp").astype(np.int64)
        bwt = formats.read_rl_bwt(args.arrays_in + ".bwt")
        results = engine.find_matches_from_arrays(
            sa, lcp, bwt, rb.doc_array(sa), rb, _options(args, rb),
            device=device)
        engine.write_outputs(results, rb, args.output_prefix)
        print(f"[build_main] {results.num_matches} matches found",
              file=sys.stderr)
        return 0

    if args.parse_prefix:
        # -p: resume from PREFIX.dict/.parse (+ .lengths),
        # pfp_mum.cpp:122-123, ref_builder.cpp:140-169
        rb = refbuilder.build_from_lengths(args.parse_prefix,
                                           use_revcomp=args.use_rcomp)
        results = engine.find_matches(rb, _options(args, rb), device=device,
                                      pfp_w=args.pfp_w,
                                      parse_prefix=args.parse_prefix)
        engine.write_outputs(results, rb, args.output_prefix)
        print(f"[build_main] {results.num_matches} matches found",
              file=sys.stderr)
        return 0

    t_start = time.time()
    rb = refbuilder.build_from_files(files, use_revcomp=args.use_rcomp)
    rb.write_lengths_file(args.output_prefix)
    print(f"[build_main] reference built ({time.time() - t_start:.2f}s, "
          f"{rb.text.size / 1e6:.1f}M chars, {rb.num_docs} docs)",
          file=sys.stderr)
    opts = _options(args, rb)
    if args.only_parse:
        from mumemto_tpu_torch.ops import pfp as ops_pfp
        ops_pfp.write_parse_files(rb, args.output_prefix, device,
                                  w=args.pfp_w, mod=args.hash_mod)
        return 0
    t0 = time.time()
    # -A rides the same scan: the index rows are written out of the run
    # that also emits the matches (pfp_lcp_mum.hpp:323-378)
    results = engine.find_matches(
        rb, opts, device=device, pfp_w=args.pfp_w, pfp_mod=args.hash_mod,
        backend="direct" if args.use_gsacak else "pfp",
        arrays_out_prefix=args.output_prefix if args.arrays_out else None)
    print(f"[build_main] match scan finished on {device} "
          f"({time.time() - t0:.2f}s)", file=sys.stderr)
    engine.write_outputs(results, rb, args.output_prefix)
    print(f"[build_main] {results.num_matches} matches found "
          f"(total {time.time() - t_start:.2f}s)", file=sys.stderr)
    if results.bwt_runs:
        n, r = results.text_length, results.bwt_runs
        print(f"[build_main] n = {n}, r = {r}, n/r = {n / r:.3f}",
              file=sys.stderr)
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in SUBCOMMANDS:
        print(f"Error: the '{argv[0]}' subcommand is not yet ported to "
              "mumemto_tpu_torch (see ROADMAP.md; use python -m mumemto_tpu "
              f"{argv[0]})", file=sys.stderr)
        return 2
    from mumemto_tpu import options
    try:
        return build_main(argv)
    except (options.InputError, FileNotFoundError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
