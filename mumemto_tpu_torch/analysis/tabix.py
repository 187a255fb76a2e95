"""Tabix export (mumemto/mum_to_tabix.py): mum lines + contig/start/end
columns -> bgzip + tabix index (falls back to plain gzip without bgzip;
the reference has the same fallback)."""

from __future__ import annotations

import argparse
import gzip
import os
import subprocess
import sys
import tempfile

import numpy as np

from mumemto_tpu_torch import formats


def find_chr_one(start, length, lengths):
    offsets = np.cumsum(lengths)
    contig_idx = int(np.searchsorted(offsets, start, side="right"))
    if contig_idx >= len(offsets):
        contig_idx = len(offsets) - 1
    left_start = np.hstack((0, offsets[:-1]))
    rel_start = int(start - left_start[contig_idx])
    return contig_idx, rel_start, rel_start + length


def _compress_and_index(plain_path, out_gz, run_tabix=True):
    with open(plain_path) as f:
        first = f.readline()
    ncols = len(first.split("\t"))
    seq_col, start_col, end_col = ncols - 3, ncols - 2, ncols - 1
    try:
        with open(out_gz, "wb") as dest:
            subprocess.run(["bgzip", "-c", "-f", plain_path], check=True,
                           stdout=dest, stderr=subprocess.DEVNULL)
    except FileNotFoundError:
        with open(plain_path, "rb") as src, gzip.open(out_gz, "wb") as dst:
            dst.writelines(src)
        if run_tabix:
            sys.stderr.write("bgzip not found; wrote gzip. Tabix requires "
                             "bgzip; skipping index.\n")
        return
    if run_tabix:
        try:
            subprocess.run(["tabix", "-s", str(seq_col + 1),
                            "-b", str(start_col + 1), "-e", str(end_col + 1),
                            "-f", out_gz], check=True, capture_output=True)
        except FileNotFoundError:
            sys.stderr.write("tabix not found; index not created.\n")


def run(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="mumemto tabix",
        description="Convert mum/bumbl to plaintext + contig/start/end "
                    "columns, then bgzip and tabix.")
    ap.add_argument("input", nargs="?")
    ap.add_argument("--mums", "-m", dest="mumfile")
    ap.add_argument("--bumbl", "-b", dest="bumfile")
    ap.add_argument("--seq-idx", "-s", type=int, default=0)
    ap.add_argument("--output", "-o", dest="out")
    ap.add_argument("--lengths-file", "-l", dest="lengths_file")
    ap.add_argument("--verbose", "-v", action="store_true")
    ap.add_argument("--no-tabix", action="store_true")
    ap.add_argument("--chunk-size", "-c", type=int, default=1024,
                    help="rows per processing chunk (streaming)")
    a = ap.parse_args(argv)
    mumfile = a.mumfile or a.bumfile or a.input
    if not mumfile or not os.path.exists(mumfile):
        ap.error("Provide an existing input .mums/.bumbl file")
    if mumfile.endswith(".bumbl"):
        # normalize via text conversion
        from mumemto_tpu_torch.analysis.mumdata import MUMdata
        md = MUMdata(mumfile, sort=False)
        tmp = mumfile[:-6] + ".tabixtmp.mums"
        md.write_mums(tmp, blocks=md.blocks)
        mumfile_txt = tmp
    else:
        mumfile_txt = mumfile
    if a.lengths_file is None:
        base = os.path.splitext(mumfile)[0]
        a.lengths_file = base + ".lengths"
        if not os.path.exists(a.lengths_file):
            raise FileNotFoundError(f"Lengths file {a.lengths_file} not found")
    if a.out is None:
        a.out = os.path.splitext(mumfile)[0] + ".mum.bed.gz"

    info = formats.parse_lengths(a.lengths_file)
    lengths = np.asarray(info.contig_lengths[a.seq_idx] or
                         [info.totals[a.seq_idx]], dtype=np.int64)
    names = info.contig_names[a.seq_idx] or \
        [os.path.basename(info.paths[a.seq_idx])]

    fd, plain = tempfile.mkstemp(suffix=".mum.bed", prefix="mum_to_tabix_")
    with os.fdopen(fd, "w") as out:
        with open(mumfile_txt) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                parts = line.split("\t")
                if len(parts) < 3:
                    continue
                length = int(parts[0])
                starts = parts[1].split(",")
                if a.seq_idx >= len(starts) or not starts[a.seq_idx] or \
                        starts[a.seq_idx] == "-1":
                    continue
                start = int(starts[a.seq_idx])
                ci, rs, re_ = find_chr_one(start, length, lengths)
                out.write(f"{line}\t{names[ci]}\t{rs}\t{re_}\n")
    _compress_and_index(plain, a.out, run_tabix=not a.no_tabix)
    os.unlink(plain)
    if mumfile_txt != mumfile:
        os.unlink(mumfile_txt)
    if a.verbose:
        print(f"Wrote {a.out}", file=sys.stderr)
    return 0
