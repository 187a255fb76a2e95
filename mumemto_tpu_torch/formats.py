"""File formats of the mumemto ecosystem, byte-compatible with the reference.

Formats (reference citations):
  .mums   text: "<len>\t<pos_csv>\t<strand_csv>\n" with empty slots for absent
          docs (include/mem_finder.hpp:357-428)
  .mems   text: "<len>\t<pos_csv>\t<doc_csv>\t<strand_csv>\n", one slot per
          occurrence (include/mem_finder.hpp:210-263)
  .bumbl  binary: u16 flags [bit13=partial, bit14=coll_blocks, bit15=length32],
          u64 n_seqs, u64 n_mums, lengths (u32 if length32 else u16),
          starts i64 row-major [n_mums x n_seqs], strands packed bits
          MSB-first ('+' = 1), optional u64 num_blocks + u32 pairs
          (include/mumsio.hpp:100-194, mem_finder.hpp:451-503)
  .lengths text: "<path> * <total>\n" then "<path> <contig> <len>\n" per contig
          (src/ref_builder.cpp:193-209)
  .thresh/.thresh_rev/.athresh  raw little-endian u16 arrays
          (include/mem_finder.hpp:104-157)
  .sa/.lcp 5-byte little-endian ints; .bwt run-length <char u8><len 5B>
          (include/pfp_lcp_mum.hpp:323-378, common.hpp:59-61)
"""

from __future__ import annotations

import io
import os
from dataclasses import dataclass, field

import numpy as np

FLAG_PARTIAL = 1 << 13
FLAG_COLL_BLOCKS = 1 << 14
FLAG_LENGTH32 = 1 << 15

SSABYTES = 5  # common.hpp:59-61
THRBYTES = 5


# ---------------------------------------------------------------------------
# .mums / .mems text format
# ---------------------------------------------------------------------------

def format_mum_line(length: int, offsets, strands) -> bytes:
    """One .mums line. offsets: int per doc, -1 = absent; strands: '+'/'-'/''.

    Mirrors mem_finder.hpp:406-425: docs 0..N-2 always get a trailing comma
    (empty slot renders as just ','), last doc appended only if present.
    """
    pos_parts = []
    strand_parts = []
    n = len(offsets)
    for i in range(n - 1):
        if offsets[i] == -1:
            pos_parts.append(",")
            strand_parts.append(",")
        else:
            pos_parts.append(f"{offsets[i]},")
            strand_parts.append(f"{strands[i]},")
    if offsets[n - 1] != -1:
        pos_parts.append(f"{offsets[n - 1]}")
        strand_parts.append(f"{strands[n - 1]}")
    return (f"{length}\t{''.join(pos_parts)}\t{''.join(strand_parts)}\n").encode()


def format_mem_line(length: int, positions, docs, strands) -> bytes:
    """One .mems line (mem_finder.hpp:210-262): all occurrences, csv columns."""
    pos = ",".join(str(p) for p in positions)
    doc = ",".join(str(d) for d in docs)
    strand = ",".join(strands)
    return f"{length}\t{pos}\t{doc}\t{strand}\n".encode()


def parse_mums(path: str, num_docs: int | None = None):
    """Parse a .mums text file -> (lengths u32, starts i64 [n,N], strands bool [n,N]).

    strands True = '+'. Absent docs: start = -1, strand = False.
    Mirrors mumemto/utils.py MUMdata text parsing + mumsio.hpp:40-98.
    """
    lengths, starts_rows, strand_rows = [], [], []
    with open(path, "rb") as f:
        for raw in f:
            line = raw.rstrip(b"\n")
            if not line:
                continue
            fl, fp, fs = line.split(b"\t")
            lengths.append(int(fl))
            pos = fp.split(b",")
            strands = fs.split(b",")
            row_p = [int(x) if x else -1 for x in pos]
            row_s = [x == b"+" for x in strands]
            # trailing absent final doc: fewer fields than num_docs
            if num_docs is not None:
                while len(row_p) < num_docs:
                    row_p.append(-1)
                    row_s.append(False)
            starts_rows.append(row_p)
            strand_rows.append(row_s)
    if num_docs is None:
        num_docs = max((len(r) for r in starts_rows), default=0)
        for row_p, row_s in zip(starts_rows, strand_rows):
            while len(row_p) < num_docs:
                row_p.append(-1)
                row_s.append(False)
    return (
        np.asarray(lengths, dtype=np.uint32),
        np.asarray(starts_rows, dtype=np.int64).reshape(len(lengths), num_docs),
        np.asarray(strand_rows, dtype=bool).reshape(len(lengths), num_docs),
    )


# ---------------------------------------------------------------------------
# .bumbl binary format
# ---------------------------------------------------------------------------

def pack_strand_bits(strands_plus: np.ndarray) -> bytes:
    """Pack a [n_mums, n_seqs] bool array ('+'=True) MSB-first per byte.

    Mirrors mem_finder.hpp:460-475 / mumsio.hpp write_bumbl.
    """
    flat = strands_plus.reshape(-1).astype(np.uint8)
    return np.packbits(flat).tobytes()


def unpack_strand_bits(buf: bytes, n_mums: int, n_seqs: int) -> np.ndarray:
    bits = np.unpackbits(np.frombuffer(buf, dtype=np.uint8), count=n_mums * n_seqs)
    return bits.reshape(n_mums, n_seqs).astype(bool)


def write_bumbl(path: str, lengths: np.ndarray, starts: np.ndarray,
                strands_plus: np.ndarray, partial: bool = False,
                blocks: np.ndarray | None = None, length32: bool = True) -> None:
    """Write a .bumbl file (layout: mumsio.hpp:100-104, writer mem_finder.hpp:460-503)."""
    n_mums, n_seqs = starts.shape
    flags = 0
    if partial:
        flags |= FLAG_PARTIAL
    if blocks is not None:
        flags |= FLAG_COLL_BLOCKS
    if length32:
        flags |= FLAG_LENGTH32
    out = io.BytesIO()
    out.write(np.uint16(flags).tobytes())
    out.write(np.uint64(n_seqs).tobytes())
    out.write(np.uint64(n_mums).tobytes())
    ldtype = np.uint32 if length32 else np.uint16
    out.write(np.ascontiguousarray(lengths, dtype=ldtype).tobytes())
    out.write(np.ascontiguousarray(starts, dtype=np.int64).tobytes())
    out.write(pack_strand_bits(np.asarray(strands_plus, dtype=bool)))
    if blocks is not None:
        blocks = np.ascontiguousarray(blocks, dtype=np.uint32)
        out.write(np.uint64(blocks.shape[0]).tobytes())
        out.write(blocks.tobytes())
    with open(path, "wb") as f:
        f.write(out.getvalue())


def parse_bumbl(path: str):
    """Parse .bumbl -> (lengths u32, starts i64 [n,N], strands bool, blocks|None, flags)."""
    with open(path, "rb") as f:
        buf = f.read()
    off = 0
    flags = int(np.frombuffer(buf, dtype=np.uint16, count=1, offset=off)[0]); off += 2
    n_seqs = int(np.frombuffer(buf, dtype=np.uint64, count=1, offset=off)[0]); off += 8
    n_mums = int(np.frombuffer(buf, dtype=np.uint64, count=1, offset=off)[0]); off += 8
    ldtype = np.uint32 if flags & FLAG_LENGTH32 else np.uint16
    lengths = np.frombuffer(buf, dtype=ldtype, count=n_mums, offset=off).astype(np.uint32)
    off += n_mums * np.dtype(ldtype).itemsize
    starts = np.frombuffer(buf, dtype=np.int64, count=n_mums * n_seqs, offset=off)
    starts = starts.reshape(n_mums, n_seqs)
    off += n_mums * n_seqs * 8
    nbits = n_mums * n_seqs
    nbytes = (nbits + 7) // 8
    strands = unpack_strand_bits(buf[off:off + nbytes], n_mums, n_seqs)
    off += nbytes
    blocks = None
    if flags & FLAG_COLL_BLOCKS:
        n_blocks = int(np.frombuffer(buf, dtype=np.uint64, count=1, offset=off)[0]); off += 8
        blocks = np.frombuffer(buf, dtype=np.uint32, count=2 * n_blocks, offset=off)
        blocks = blocks.reshape(n_blocks, 2)
    return lengths, starts, strands, blocks, flags


def iter_bumbl(path: str, chunk_size: int = 1 << 16):
    """Stream a .bumbl in chunks of (lengths u32, starts i64, strands bool)
    without loading the whole file (utils.py:69-175 chunked reader).

    Yields (lengths[c], starts[c, n_seqs], strands[c, n_seqs]) tuples.
    Requires n_seqs % 8 == 0 OR chunk boundaries aligned to byte-packed
    strands; we align chunks to multiples of 8 mums to keep the packed
    strand bits byte-aligned.
    """
    chunk_size = max(8, chunk_size - chunk_size % 8)
    with open(path, "rb") as f:
        flags = int(np.frombuffer(f.read(2), dtype=np.uint16)[0])
        n_seqs = int(np.frombuffer(f.read(8), dtype=np.uint64)[0])
        n_mums = int(np.frombuffer(f.read(8), dtype=np.uint64)[0])
        ldtype = np.uint32 if flags & FLAG_LENGTH32 else np.uint16
        lsize = np.dtype(ldtype).itemsize
        base = f.tell()
        starts_base = base + n_mums * lsize
        strands_base = starts_base + n_mums * n_seqs * 8
        from mumemto_tpu_torch.progress import iter_with_progress
        n_chunks = (n_mums + chunk_size - 1) // chunk_size
        for lo in iter_with_progress(range(0, n_mums, chunk_size),
                                     total=n_chunks, desc="read bumbl"):
            hi = min(lo + chunk_size, n_mums)
            c = hi - lo
            f.seek(base + lo * lsize)
            lengths = np.frombuffer(f.read(c * lsize), dtype=ldtype
                                    ).astype(np.uint32)
            f.seek(starts_base + lo * n_seqs * 8)
            starts = np.frombuffer(f.read(c * n_seqs * 8), dtype=np.int64
                                   ).reshape(c, n_seqs)
            bit_lo = lo * n_seqs
            bit_hi = hi * n_seqs
            byte_lo = bit_lo // 8
            f.seek(strands_base + byte_lo)
            nbytes = (bit_hi + 7) // 8 - byte_lo
            bits = np.unpackbits(np.frombuffer(f.read(nbytes), dtype=np.uint8))
            off = bit_lo - byte_lo * 8
            strands = bits[off:off + c * n_seqs].reshape(c, n_seqs).astype(bool)
            yield lengths, starts, strands


def first_offsets(path: str, num_docs: int | None = None):
    """(lengths, first-genome offsets, first-genome strands) without
    materializing the full match table (mumsio.hpp:198-281 streamers)."""
    if path.endswith(".bumbl"):
        lens, offs, strs = [], [], []
        for L, S, T in iter_bumbl(path):
            lens.append(L)
            offs.append(S[:, 0])
            strs.append(T[:, 0])
        if not lens:
            return (np.zeros(0, np.uint32), np.zeros(0, np.int64),
                    np.zeros(0, bool))
        return (np.concatenate(lens), np.concatenate(offs),
                np.concatenate(strs))
    lens, offs, strs = [], [], []
    with open(path, "rb") as f:
        for raw in f:
            line = raw.rstrip(b"\n")
            if not line:
                continue
            cols = line.split(b"\t")  # tolerate extra columns (blocks/labels)
            fl, fp, fs = cols[0], cols[1], cols[2]
            lens.append(int(fl))
            p0 = fp.split(b",", 1)[0]
            s0 = fs.split(b",", 1)[0]
            offs.append(int(p0) if p0 else -1)
            strs.append(s0 == b"+")
    return (np.asarray(lens, np.uint32), np.asarray(offs, np.int64),
            np.asarray(strs, bool))


# ---------------------------------------------------------------------------
# .lengths
# ---------------------------------------------------------------------------

@dataclass
class LengthsInfo:
    """Parsed .lengths content: per input file, total + per-contig entries."""
    paths: list = field(default_factory=list)           # file path per doc
    totals: list = field(default_factory=list)          # total bp per doc
    contig_names: list = field(default_factory=list)    # list[list[str]] per doc
    contig_lengths: list = field(default_factory=list)  # list[list[int]] per doc

    def seq_lengths(self, use_revcomp: bool) -> list:
        """Internal per-doc text lengths incl. '$' terminators.

        Mirrors RefBuilder lengths-file constructor (ref_builder.cpp:140-169):
        total+1, doubled when revcomp.
        """
        out = []
        for t in self.totals:
            n = t + 1
            if use_revcomp:
                n *= 2
            out.append(n)
        return out


def write_lengths(path: str, paths, multifasta_names, multifasta_lengths) -> None:
    """Write .lengths exactly as ref_builder.cpp:193-209 (canonical paths)."""
    with open(path, "w") as f:
        for i in range(len(paths)):
            canon = os.path.realpath(paths[i])
            total = sum(multifasta_lengths[i])
            f.write(f"{canon} * {total}\n")
            for name, ln in zip(multifasta_names[i], multifasta_lengths[i]):
                f.write(f"{canon} {name} {ln}\n")


def parse_lengths(path: str) -> LengthsInfo:
    """Parse .lengths in both simple ("path len") and multilengths formats.

    Mirrors ref_builder.cpp:149-166 and mumemto/utils.py:177-247.
    """
    info = LengthsInfo()
    with open(path) as f:
        for line in f:
            words = line.split()
            if not words:
                continue
            if len(words) == 2:
                info.paths.append(words[0])
                info.totals.append(int(words[1]))
                info.contig_names.append([])
                info.contig_lengths.append([])
            elif len(words) == 3 and words[1] == "*":
                info.paths.append(words[0])
                info.totals.append(int(words[2]))
                info.contig_names.append([])
                info.contig_lengths.append([])
            elif len(words) == 3:
                if info.paths and info.paths[-1] == words[0]:
                    info.contig_names[-1].append(words[1])
                    info.contig_lengths[-1].append(int(words[2]))
    return info


# ---------------------------------------------------------------------------
# threshold metadata (merge)
# ---------------------------------------------------------------------------

def write_thresh(path: str, values: np.ndarray) -> None:
    np.ascontiguousarray(values, dtype=np.uint16).tofile(path)


def read_thresh(path: str) -> np.ndarray:
    return np.fromfile(path, dtype=np.uint16)


# ---------------------------------------------------------------------------
# 5-byte SA/LCP arrays and run-length BWT
# ---------------------------------------------------------------------------

def write_5byte(path: str, values: np.ndarray) -> None:
    """Write values as 5-byte little-endian ints (pfp_lcp_mum.hpp:349-368)."""
    v = np.ascontiguousarray(values, dtype=np.uint64)
    b = v.view(np.uint8).reshape(-1, 8)[:, :SSABYTES]
    b.tofile(path)


def read_5byte(path: str) -> np.ndarray:
    raw = np.fromfile(path, dtype=np.uint8)
    assert raw.size % SSABYTES == 0
    b = raw.reshape(-1, SSABYTES)
    out = np.zeros((b.shape[0], 8), dtype=np.uint8)
    out[:, :SSABYTES] = b
    return out.view(np.uint64).reshape(-1)


def write_rl_bwt(path: str, bwt: np.ndarray) -> None:
    """Run-length BWT: per run, <char u8><run length 5B LE> (pfp_lcp_mum.hpp:371-378
    writes plain chars in the PFP path; the array-replay reader read_arrays.hpp
    expects run-length pairs). We write run-length pairs."""
    bwt = np.asarray(bwt, dtype=np.uint8)
    if bwt.size == 0:
        open(path, "wb").close()
        return
    change = np.flatnonzero(np.r_[True, bwt[1:] != bwt[:-1]])
    run_len = np.diff(np.r_[change, bwt.size]).astype(np.uint64)
    heads = bwt[change]
    rec = np.zeros((heads.size, 1 + SSABYTES), dtype=np.uint8)
    rec[:, 0] = heads
    rec[:, 1:] = run_len.view(np.uint8).reshape(-1, 8)[:, :SSABYTES]
    rec.tofile(path)


def read_rl_bwt(path: str) -> np.ndarray:
    raw = np.fromfile(path, dtype=np.uint8)
    assert raw.size % (1 + SSABYTES) == 0
    rec = raw.reshape(-1, 1 + SSABYTES)
    heads = rec[:, 0]
    lens = np.zeros((rec.shape[0], 8), dtype=np.uint8)
    lens[:, :SSABYTES] = rec[:, 1:]
    lens = lens.view(np.uint64).reshape(-1)
    return np.repeat(heads, lens.astype(np.int64))
