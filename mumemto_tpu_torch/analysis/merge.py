"""`merge` subcommand: MumemtoM partition merging, anchor- or string-based.

The merge logic is the JAX package's, mumemto_tpu/analysis/merge.py, which
is jax-free at import: anchor merging (merge_anchor_lengths, anchor_merge)
runs no engine, and its string_merge runs one only for the recursive "MUMs
of MUMs" scan when no merged_mums file is given. string_merge below runs
that scan on the port's engine, on `device`, and hands its .mums to the
JAX module's string_merge, so the recomposition stays in one place.
`--collective` (the on-device anchor fold across partitions) is not
ported yet and is refused.
"""

from __future__ import annotations

import argparse
import os
import sys

from mumemto_tpu.analysis import merge as merge_ref
from mumemto_tpu.analysis.merge import anchor_merge, merge_anchor_lengths


def string_merge(mum_files, paths, output: str, output_base: str,
                 merged_mums: str | None = None, verbose: bool = False,
                 device="cuda"):
    """merge_mums.py's string merging path, with the "MUMs of MUMs" scan
    (when merged_mums is None) on the port's engine on `device`."""
    if merged_mums is not None:
        return merge_ref.string_merge(mum_files, paths, output, output_base,
                                      merged_mums=merged_mums,
                                      verbose=verbose)
    from mumemto_tpu import options, refbuilder
    from mumemto_tpu_torch import engine

    temp_base = output_base + "_temp_merged"
    fas = [p + "_mums.fa" for p in paths]
    try:
        for mf, p, fa in zip(mum_files, paths, fas):
            merge_ref._extract_sorted_mums_fasta(mf, p + ".lengths", fa)
        rb = refbuilder.build_from_files(fas, use_revcomp=True)
        rb.write_lengths_file(temp_base)
        opts = options.normalize(rb.num_docs, quiet=not verbose)
        engine.write_outputs(engine.find_matches(rb, opts, device=device),
                             rb, temp_base)
        return merge_ref.string_merge(mum_files, paths, output, output_base,
                                      merged_mums=temp_base + ".mums",
                                      verbose=verbose)
    finally:
        # the call with merged_mums leaves these to its caller
        for f in fas + [temp_base + ".mums", temp_base + ".lengths"]:
            if os.path.exists(f):
                os.remove(f)


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
                    help="not yet ported to mumemto_tpu_torch")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the string merge's scan "
                         "(default: cuda)")
    args = ap.parse_args(argv)
    if args.collective:
        print("Error: merge --collective is not yet ported to "
              "mumemto_tpu_torch (see ROADMAP.md; use python -m "
              "mumemto_tpu merge --collective)", file=sys.stderr)
        return 2
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
        anchor_merge(args.mum_files, output, verbose=args.verbose)
        return 0

    if not all(os.path.exists(p + ".thresh") for p in paths):
        print("Error: *.thresh or *.athresh files required for all inputs "
              "for merging.", file=sys.stderr)
        return 1
    string_merge(args.mum_files, paths, output, output_base,
                 merged_mums=args.merged_mums, verbose=args.verbose,
                 device=args.device)
    return 0
