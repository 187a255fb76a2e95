"""mumemto-compatible build command for the PyTorch port.

    python -m mumemto_tpu_torch a.fa b.fa ... -o out [--device cuda]

Parses the same build flags as mumemto_tpu/cli.py (src/pfp_mum.cpp:255-313
in the reference) plus --device, and writes PREFIX.lengths and PREFIX.mums
(.mems with -f != 1, .bumbl with -b), plus .thresh/.thresh_rev with -M or
.athresh with -M -n, and .sa/.lcp/.bwt with -A. -P writes .dict/.parse
and stops; -p resumes from them, -a replays .sa/.lcp/.bwt files, -g runs
the direct backend. The subcommands run through analysis/dispatch (`merge`
with --device, analysis/merge). A CUDA
out-of-memory error on a strict multi-MUM run over >= 3 files, or a
union one device's scan refuses by size (ops/pfp.ScanSizeError: a row
space past 2^31, a text past the int32 phrase coordinates), is retried as
MumemtoM partitions on the same device; any other run so refused exits
1 with the refusal. --seq-shards N shards the scan
of one collection (the FASTA build or a -p resume) over N shards placed
round-robin on the visible cards (parallel/seqpfp.py, parallel/mesh.py);
on one card, or with --device cpu, every shard runs on that device.
"""

from __future__ import annotations

import argparse
import gc
import sys
import time

import numpy as np
import torch

VERSION = "1.4.0"

SKULL = r"""
                            ,--.
                           {    }
                           K,   }
                          /  ~Y`
                     ,   /   /
                    {_'-K.__/
                      `/-.__L._
                      /  ' /`\_}
                     /  ' /
             ____   /  ' /
      ,-'~~~~    ~~/  ' /_
    ,'             ``~~~  ',
   (                        Y
  {                         I
 {      -                    `,
 |       ',                   )
 |        |   ,..__      __. Y
 |    .,_./  Y ' / ^Y   J   )|
 \           |' /   |   |   ||
  \          L_/    . _ (_,.'(
   \,   ,      ^^""' / |      )
     \_  \          /,L]     /
       '-_~-,       ` `   ./`
          `'{_            )
              ^^\..___,.--`
"""

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
                    help="shard ONE collection's scan into N row blocks "
                         "(power of two), placed round-robin on the "
                         "visible devices; fewer devices than shards run "
                         "several shards each")
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


def _seq_mesh(nshards: int, device):
    """The sharded scan's mesh (one device per shard), or None + error."""
    from mumemto_tpu_torch.parallel import mesh
    try:
        return mesh.seq_devices(nshards, device)
    except ValueError as e:
        print(f"Error: {e}", file=sys.stderr)
        return None


def _options(args, rb):
    from mumemto_tpu_torch import options
    return options.normalize(
        rb.num_docs, min_match_len=args.min_match_len,
        num_distinct_docs=args.num_distinct_docs, rare_freq=args.rare_freq,
        max_mem_freq=args.max_mem_freq, use_revcomp=args.use_rcomp,
        merge=args.merge, anchor_merge=args.anchor_merge, binary=args.binary)


def _is_device_oom(e: Exception) -> bool:
    """A CUDA out-of-memory error (not "CUDA is not available")."""
    return (isinstance(e, torch.cuda.OutOfMemoryError)
            or "CUDA out of memory" in str(e))


def _too_big(e: Exception) -> str | None:
    """What a smaller scan avoids, in words ("device OOM", or a size
    refusal's message), else None. Words, not the error: its traceback
    would keep the failed scan's tensors alive."""
    from mumemto_tpu_torch.ops.pfp import ScanSizeError
    if _is_device_oom(e):
        return "device OOM"
    return str(e) if isinstance(e, ScanSizeError) else None


def _fallback_eligible(opts, files) -> bool:
    """A run the partition fallback reproduces exactly: strict multi-MUMs
    over >= 3 input files, no merge metadata, no .bumbl."""
    return bool(opts.mum_mode and opts.num_distinct == len(files)
                and not opts.merge and not opts.binary
                and files and len(files) >= 3)


def _oom_partition_fallback(args, files, device, why) -> int:
    """Device OOM (or a size refusal; `why` says which) during the union
    scan: rerun as MumemtoM partitions + anchor merge on the same device
    (README.md:124-142 in the reference), doubling the partition count
    while partitions still run out of memory or are refused.
    merge(partitions) == run-on-union is the tested invariant."""
    from mumemto_tpu_torch.parallel import mumemtom
    failed, nparts = "the union scan", 2
    while nparts <= max(2, len(files) - 1):
        print(f"[build_main] {why} on {failed} — retrying as "
              f"{nparts} MumemtoM partitions + anchor merge", file=sys.stderr)
        # the failed scan's tensors are garbage now; hand its cached
        # blocks back, or the caching allocator keeps holding them
        gc.collect()
        torch.cuda.empty_cache()
        try:
            mumemtom.run_partitioned_files(
                files, args.output_prefix, num_partitions=nparts,
                anchor=True, min_match_len=args.min_match_len,
                use_revcomp=args.use_rcomp, device=device)
        except Exception as e:
            why = _too_big(e)
            if why is None:
                raise
            failed = f"{nparts} partitions"
            nparts *= 2
            continue
        print("[build_main] partitioned fallback succeeded", file=sys.stderr)
        return 0
    if why != "device OOM":
        print(f"Error: {why} (even at maximum partitioning)",
              file=sys.stderr)
        return 1
    print("Error: the device ran out of memory even at maximum "
          "partitioning.", file=sys.stderr)
    return 137


def build_main(argv) -> int:
    from mumemto_tpu_torch import formats, refbuilder
    from mumemto_tpu_torch import engine
    from mumemto_tpu_torch.device import resolve

    args = build_argparser().parse_args(argv)
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
    if args.seq_shards and (args.arrays_out or args.arrays_in
                            or args.only_parse or args.use_gsacak):
        # refuse rather than silently dropping either flag: the sharded
        # scan has no array-checkpoint stream-out and the replay/direct
        # paths are single-device programs (-p resume is supported)
        print("Error: --seq-shards is not supported together with "
              "-A/-a/-P/-g; run those single-device (or per-partition "
              "via MumemtoM).", file=sys.stderr)
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
        if args.seq_shards:
            devices = _seq_mesh(args.seq_shards, device)
            if devices is None:
                return 1
            from mumemto_tpu_torch.parallel import seqpfp
            results = seqpfp.find_matches_seq_sharded(
                rb, _options(args, rb), devices, pfp_w=args.pfp_w,
                parse_prefix=args.parse_prefix)
        else:
            results = engine.find_matches(
                rb, _options(args, rb), device=device, pfp_w=args.pfp_w,
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
    try:
        if args.seq_shards:
            # the expansion row space of this one collection sharded
            devices = _seq_mesh(args.seq_shards, device)
            if devices is None:
                return 1
            from mumemto_tpu_torch.parallel import seqpfp
            results = seqpfp.find_matches_seq_sharded(
                rb, opts, devices, pfp_w=args.pfp_w, pfp_mod=args.hash_mod)
        else:
            # -A rides the same scan: the index rows are written out of
            # the run that also emits the matches
            # (pfp_lcp_mum.hpp:323-378)
            results = engine.find_matches(
                rb, opts, device=device, pfp_w=args.pfp_w,
                pfp_mod=args.hash_mod,
                backend="direct" if args.use_gsacak else "pfp",
                arrays_out_prefix=(args.output_prefix if args.arrays_out
                                   else None))
    except Exception as e:
        why = _too_big(e)
        if why is None or not _fallback_eligible(opts, files):
            raise
        results = None
    if results is None:
        # outside the handler: the traceback, and with it the failed
        # scan's tensors, is released first
        return _oom_partition_fallback(args, files, device, why)
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
    if argv and argv[0] == "mori":
        print(SKULL)
        return 0
    if argv and argv[0] == "--version":
        print(VERSION)
        return 0
    if argv and argv[0] in SUBCOMMANDS:
        from mumemto_tpu_torch.analysis import dispatch
        return dispatch.run(argv[0], argv[1:])
    from mumemto_tpu_torch import options
    from mumemto_tpu_torch.ops.pfp import ScanSizeError
    try:
        return build_main(argv)
    except (options.InputError, FileNotFoundError, ScanSizeError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    except MemoryError:
        # out-of-memory heuristic of the reference wrapper
        # (mumemto/mumemto:19-21: SIGKILL -> OOM message)
        print("Error: mumemto ran out of memory. Try a smaller collection, "
              "partitioned runs (mumemto -M per partition + mumemto merge), "
              "or a machine/device with more memory.", file=sys.stderr)
        return 137
    except Exception as e:
        if _is_device_oom(e):
            print("Error: the device ran out of memory during the scan. "
                  "Partition the collection (mumemto -M per partition + "
                  "mumemto merge).", file=sys.stderr)
            return 137
        raise


if __name__ == "__main__":
    sys.exit(main())
