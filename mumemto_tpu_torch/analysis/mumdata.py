"""MUMdata: columnar container for match sets + collinear-block detection.

Semantics mirror mumemto/utils.py (reference):
  * MUMdata(path): parses .mums text or .bumbl binary; default sorts by the
    first sequence's start column (utils.py:294-331)
  * find_coll_blocks: vectorized collinear-block detection — consecutive
    MUMs whose per-sequence rank increments match strand direction, constant
    strand pattern, optional max-gap truncation and singleton blocks
    (utils.py:9-64)
  * block (de)serialization as a 4th text column / .bumbl block pairs
    (utils.py:270-291)
  * writers: note this layer prints -1 offsets literally (utils.py:627-650),
    unlike the finder's empty-slot .mums rendering.
"""

from __future__ import annotations

import sys
from collections import namedtuple

import numpy as np

from mumemto_tpu_torch import formats

MUM = namedtuple("MUM", ["length", "starts", "strands"])


def deserialize_coll_blocks(coll_blocks):
    vals = np.array([-1 if x == "-" else int(x) for x in coll_blocks])
    change = np.where(np.diff(vals) != 0)[0] + 1
    l_vals = np.concatenate(([0], change))
    r_vals = np.concatenate((change - 1, [len(vals) - 1]))
    return [(l, r) for l, r in zip(l_vals, r_vals) if vals[l] != -1]


def serialize_coll_blocks(coll_blocks, num_mums):
    if not coll_blocks:  # (reference crashes here; emit all-'-' instead)
        return ["-"] * num_mums
    idx = 0
    out = []
    left, right = coll_blocks[idx]
    for i in range(num_mums):
        if i > right:
            idx += 1
            if idx < len(coll_blocks):
                left, right = coll_blocks[idx]
        out.append("-" if (i < left or i > right) else str(idx))
    return out


class MUMdata:
    """Columnar (lengths u32, starts i64 [n,N], strands bool [n,N])."""

    def __init__(self, mumfile: str, lenfilter: int = 0, subsample: int = 1,
                 sort: bool = True, verbose: bool = False):
        if mumfile.endswith(".bumbl"):
            lengths, starts, strands, blocks, _flags = formats.parse_bumbl(mumfile)
            mask = np.zeros(len(lengths), dtype=bool)
            mask[::subsample] = True
            mask &= lengths >= lenfilter
            self.lengths, self.starts, self.strands = (
                lengths[mask], starts[mask], strands[mask])
            self.blocks = None if blocks is None else [tuple(b) for b in blocks]
            self.extra_fields = None
        else:
            self.lengths, self.starts, self.strands, self.blocks, \
                self.extra_fields = self._parse_mums_text(
                    mumfile, lenfilter, subsample)
        if sort:
            self.sort(ref_col=0, copy=False)

    @staticmethod
    def _parse_mums_text(mumfile, lenfilter=0, subsample=1):
        lengths, starts, strands, blocks_col, extra = [], [], [], [], []
        count = 0
        with open(mumfile) as f:
            for line in f:
                if subsample == 1 or count % subsample == 0:
                    parts = line.strip().split()
                    if parts:
                        length = int(parts[0])
                        if length >= lenfilter:
                            strands.append(
                                [s == "+" for s in parts[2].split(",")])
                            starts.append(
                                [int(p) if p != "" else -1
                                 for p in parts[1].split(",")])
                            lengths.append(length)
                            if len(parts) > 3 and parts[3] != "*":
                                blocks_col.append(parts[3])
                            if len(parts) > 4:
                                extra.append("\t".join(parts[4:]))
                count += 1
        lengths = np.array(lengths, dtype=np.uint32)
        starts = np.array(starts, dtype=np.int64) if starts else \
            np.zeros((0, 0), dtype=np.int64)
        strands = np.array(strands, dtype=bool) if len(strands) else \
            np.zeros((0, 0), dtype=bool)
        blocks = deserialize_coll_blocks(blocks_col) if blocks_col else None
        return lengths, starts, strands, blocks, (extra or None)

    @classmethod
    def from_arrays(cls, lengths, starts, strands, blocks=None,
                    extra_fields=None):
        inst = cls.__new__(cls)
        inst.lengths = np.asarray(lengths)
        inst.starts = np.asarray(starts, dtype=np.int64)
        inst.strands = np.asarray(strands, dtype=bool)
        inst.blocks = blocks
        inst.extra_fields = extra_fields
        return inst

    @property
    def num_mums(self):
        return len(self.lengths)

    @property
    def num_seqs(self):
        return self.starts.shape[1] if self.num_mums > 0 else 0

    def __len__(self):
        return self.num_mums

    def __bool__(self):
        return self.num_mums > 0

    def __getitem__(self, idx):
        if isinstance(idx, (int, np.integer)):
            return MUM(self.lengths[idx], self.starts[idx], self.strands[idx])
        return MUMdata.from_arrays(self.lengths[idx], self.starts[idx],
                                   self.strands[idx])

    def __iter__(self):
        for i in range(self.num_mums):
            yield self[i]

    def __add__(self, other):
        if self.num_seqs != other.num_seqs:
            raise ValueError(
                "cannot concatenate MUM sets over different sequence counts")
        return MUMdata.from_arrays(
            np.concatenate([self.lengths, other.lengths]),
            np.concatenate([self.starts, other.starts], axis=0),
            np.concatenate([self.strands, other.strands], axis=0))

    def copy(self):
        return MUMdata.from_arrays(
            self.lengths.copy(), self.starts.copy(), self.strands.copy(),
            blocks=None if self.blocks is None else list(self.blocks),
            extra_fields=None if self.extra_fields is None
            else list(self.extra_fields))

    def sort(self, ref_col: int = 0, copy: bool = False):
        """Order by the given start column, ascending. No-op when already
        ordered; a real re-sort invalidates any attached block ranges."""
        target = self.copy() if copy else self
        if target.num_mums <= 1:
            return target
        col = target.starts[:, ref_col]
        if np.all(col[:-1] <= col[1:]):
            return target
        target.blocks = None
        perm = np.argsort(col, kind="stable")
        target.lengths = target.lengths[perm]
        target.starts = target.starts[perm]
        target.strands = target.strands[perm]
        if target.extra_fields is not None:
            target.extra_fields = [target.extra_fields[i] for i in perm]
        return target

    def filter_pmums(self):
        """Remove MUMs with -1 (absent) start positions."""
        if -1 in self.starts:
            valid = ~np.any(self.starts == -1, axis=1)
            self.lengths = self.lengths[valid]
            self.starts = self.starts[valid]
            self.strands = self.strands[valid]
            if self.extra_fields is not None:
                self.extra_fields = [
                    f for f, v in zip(self.extra_fields, valid) if v]
        return self

    def write_mums(self, filename, blocks=None):
        with open(filename, "w") as f:
            if blocks is None:
                for i in range(self.num_mums):
                    st = ["+" if s else "-" for s in self.strands[i]]
                    f.write(f"{self.lengths[i]}\t"
                            f"{','.join(map(str, self.starts[i]))}\t"
                            f"{','.join(st)}\n")
            else:
                if not np.all(np.diff(self.starts[:, 0]) >= 0):
                    print("MUMs must be sorted by first column to write "
                          "blocks; ignoring blocks.", file=sys.stderr)
                    return self.write_mums(filename)
                block_col = serialize_coll_blocks(blocks, self.num_mums)
                for i in range(self.num_mums):
                    st = ["+" if s else "-" for s in self.strands[i]]
                    line = (f"{self.lengths[i]}\t"
                            f"{','.join(map(str, self.starts[i]))}\t"
                            f"{','.join(st)}\t{block_col[i]}")
                    if self.extra_fields is not None:
                        line += "\t" + self.extra_fields[i]
                    f.write(line + "\n")

    def write_bums(self, filename, blocks=None):
        blk = None
        if blocks is not None:
            if not np.all(np.diff(self.starts[:, 0]) >= 0):
                print("MUMs must be sorted by first column to write blocks; "
                      "ignoring blocks.", file=sys.stderr)
            else:
                blk = np.array(blocks, dtype=np.uint32)
        formats.write_bumbl(
            filename, self.lengths, self.starts, self.strands,
            partial=bool(-1 in self.starts), blocks=blk,
            length32=self.lengths.dtype == np.uint32)


def _true_runs(mask: np.ndarray):
    """Maximal runs of True as (first, last_exclusive) index pairs."""
    edge = np.diff(np.concatenate(([False], mask, [False])).astype(np.int8))
    return np.flatnonzero(edge == 1), np.flatnonzero(edge == -1)


def find_coll_blocks(mums: MUMdata, max_break: int = 0, verbose: bool = False,
                     return_order: bool = False,
                     min_singleton_length: int | None = None):
    """Collinear-block detection (semantics of the reference's
    mumemto/utils.py:9-64, re-derived; SURVEY §2.2-P2).

    MUMs are assumed sorted by the sequence-0 start column. Two adjacent
    MUMs i, i+1 are *collinear* when, in EVERY sequence j, MUM i+1 is the
    immediate neighbor of MUM i along j in the direction of i's strand
    (rank difference +1 on '+', -1 on '-') and the strand pattern is
    unchanged. With max_break > 0 the pair additionally requires the gap
    between the two matches (start distance minus the length of whichever
    comes first in that sequence) to be <= max_break in every sequence.
    Blocks are the maximal runs of collinear pairs, returned as inclusive
    (first_mum, last_mum) index ranges sorted by first index; with
    min_singleton_length, uncovered MUMs at least that long are added as
    one-MUM blocks.
    """
    starts = mums.starts
    strands = mums.strands
    lengths = np.asarray(mums.lengths, dtype=np.int64)
    n = len(lengths)
    blocks: list = []
    if n >= 2:
        # rank[i, j] = position of MUM i when ordered along sequence j
        rank = np.argsort(np.argsort(starts, axis=0, kind="stable"), axis=0)
        step_dir = np.where(strands[:-1], 1, -1)
        pair_ok = ((np.diff(rank, axis=0) == step_dir).all(axis=1)
                   & (strands[1:] == strands[:-1]).all(axis=1))
        if max_break > 0:
            earlier_len = np.where(starts[1:] < starts[:-1],
                                   lengths[1:, None], lengths[:-1, None])
            gap = np.abs(starts[1:] - starts[:-1]) - earlier_len
            pair_ok &= (gap <= max_break).all(axis=1)
        lo, hi = _true_runs(pair_ok)
        # a run of true pairs [a, b) spans MUMs a..b inclusive
        blocks = [(int(a), int(b)) for a, b in zip(lo, hi)]

    if min_singleton_length is not None:
        covered = np.zeros(n, dtype=bool)
        for a, b in blocks:
            covered[a:b + 1] = True
        for i in np.flatnonzero(~covered & (lengths >= min_singleton_length)):
            blocks.append((int(i), int(i)))
        blocks.sort(key=lambda b: b[0])

    if return_order:
        return blocks, get_coll_block_order(mums, blocks)
    return blocks


def get_coll_block_order(mums, blocks):
    """order[j] = block indices in the order their leading MUM appears
    along sequence j (shape (num_seqs, num_blocks))."""
    lefts = np.asarray([b[0] for b in blocks], dtype=np.int64)
    if lefts.size == 0:
        nseq = mums.starts.shape[1] if mums.num_mums else 0
        return np.zeros((nseq, 0), dtype=np.int64)
    return np.argsort(mums.starts[lefts], axis=0, kind="stable").T
