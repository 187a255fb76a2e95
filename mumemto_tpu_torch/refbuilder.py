"""Reference (input collection) text: FASTA ingestion -> concatenated text.

Array-first equivalent of src/ref_builder.cpp: reads each input FASTA (plain or
gzip), uppercases, concatenates all records of a file into one document laid
out as ``fwd $ revcomp $`` (when revcomp is on, the default;
ref_builder.cpp:255-292), and exposes the per-document lengths and document
boundary positions needed by the match scan. The text is produced as a numpy
uint8 array ready to be uploaded to the device.
"""

from __future__ import annotations

import gzip
import os
from dataclasses import dataclass

import numpy as np

from mumemto_tpu_torch.options import InputError

from mumemto_tpu_torch import formats

# Complement table from seqtk (ref_builder.cpp:29-38); identity above 127.
_COMP = np.arange(256, dtype=np.uint8)
for _a, _b in zip(b"ABCDGHKMNRSTUVWXY", b"TVGHCDMKNYSAABWXR"):
    _COMP[_a] = _b
    _COMP[_a + 32] = _b + 32  # lowercase (never hit: we uppercase first)

_UPPER = np.arange(256, dtype=np.uint8)
_UPPER[ord("a"):ord("z") + 1] -= 32

FASTA_EXTS = (".fa", ".fasta", ".fna", ".fa.gz", ".fasta.gz", ".fna.gz")

DOLLAR = ord("$")


def revcomp(seq: np.ndarray) -> np.ndarray:
    """Reverse complement of an uppercase uint8 sequence."""
    return _COMP[seq[::-1]]


def _validate_byte_range(text: np.ndarray, origin: str) -> None:
    """The compute path packs chars into 7-bit lanes (ops/suffix.py packed
    seed; ops/pfp grp/bwt and suf/bwt packs), which requires every text
    byte < 127. Legal FASTA is ASCII so this only rejects binary garbage —
    but reject it loudly instead of corrupting the suffix array."""
    if text.size and int(text.max()) >= 127:
        bad = int(text[text >= 127][0])
        raise InputError(
            f"{origin}: byte value {bad} >= 127 in sequence data; "
            "inputs must be ASCII FASTA characters")


def read_fasta(path: str):
    """Read a FASTA file -> (names, seqs as uint8 arrays), uppercased.

    kseq-equivalent: record name = text up to first whitespace after '>'.
    Handles gzip via magic bytes, multi-line records.
    """
    with open(path, "rb") as f:
        magic = f.read(2)
    opener = gzip.open if magic == b"\x1f\x8b" else open
    names, seqs = [], []
    chunks: list[bytes] = []
    name = None
    with opener(path, "rb") as f:
        for line in f:
            line = line.rstrip(b"\r\n")
            if line.startswith(b">"):
                if name is not None:
                    seqs.append(b"".join(chunks))
                parts = line[1:].split()
                name = parts[0].decode() if parts else ""
                names.append(name)
                chunks = []
            elif line.startswith(b";"):
                continue
            elif name is not None:
                chunks.append(line)
    if name is not None:
        seqs.append(b"".join(chunks))
    arrs = [_UPPER[np.frombuffer(s, dtype=np.uint8)] for s in seqs]
    return names, arrs


@dataclass
class RefBuilder:
    """Concatenated collection text + per-document metadata.

    Attributes mirror the reference RefBuilder (include/ref_builder.hpp):
      text         uint8 concatenation, each doc laid out 'fwd$' or 'fwd$rc$'
      seq_lengths  per-doc text length incl. terminators (x2 when revcomp)
      doc_ends     cumulative end positions (exclusive) per doc; the
                   reference's doc_ends bitvector has a 1 at each
                   cumulative-1 position (ref_builder.cpp:183-190)
      num_docs, use_revcomp, input_files, multifasta_names/lengths
    """
    text: np.ndarray
    seq_lengths: list
    num_docs: int
    use_revcomp: bool
    input_files: list
    multifasta_names: list
    multifasta_lengths: list

    @property
    def total_length(self) -> int:
        return int(self.text.size) if self.text is not None else sum(self.seq_lengths)

    @property
    def doc_ends(self) -> np.ndarray:
        return np.cumsum(np.asarray(self.seq_lengths, dtype=np.int64))

    def doc_array(self, positions: np.ndarray) -> np.ndarray:
        """doc id per text position: sdsl rank over doc-end bitvector
        (= count of doc ends <= pos), clamped for sentinel positions."""
        da = np.searchsorted(self.doc_ends, positions, side="right")
        return np.minimum(da, self.num_docs)

    def write_lengths_file(self, output_prefix: str) -> None:
        formats.write_lengths(output_prefix + ".lengths", self.input_files,
                              self.multifasta_names, self.multifasta_lengths)


def _dedup_preserve_order(files) -> list:
    seen = set()
    out = []
    for f in files:
        norm = os.path.abspath(f)
        if norm not in seen:
            seen.add(norm)
            out.append(norm)
    return out


def build_from_files(files, use_revcomp: bool = True) -> RefBuilder:
    """Build the collection text from FASTA paths (ref_builder.cpp:211-314)."""
    files = _dedup_preserve_order(files)
    if len(files) <= 1:
        raise InputError(
            "Multiple FASTA inputs required. Perhaps split a multi-FASTA into "
            "multiple files?")
    for f in files:
        if not os.path.isfile(f):
            raise FileNotFoundError(f"The following file path is not valid: {f}")
        if not f.endswith(FASTA_EXTS):
            raise InputError(f"The following input-file is not a FASTA file: {f}")

    from mumemto_tpu_torch.native import get_native
    native = get_native()

    pieces = []
    seq_lengths = []
    mf_names, mf_lengths = [], []
    dollar = np.array([DOLLAR], dtype=np.uint8)
    for path in files:
        if native is not None:
            # C++ data-loader: gzip decode + uppercase + fwd$rc$ packing in
            # one native pass (native/mumemto_native.cc, kseq-equivalent)
            doc, names, contig_lens = native.load_fasta_doc(path, use_revcomp)
            total = sum(contig_lens)
            if total == 0:
                raise InputError(f"Empty input file found: {path}")
            mf_names.append(names)
            mf_lengths.append([int(x) for x in contig_lens])
            pieces.append(np.frombuffer(doc, dtype=np.uint8))
            seq_lengths.append(len(doc))
            continue
        names, seqs = read_fasta(path)
        total = sum(int(s.size) for s in seqs)
        if total == 0:
            raise InputError(f"Empty input file found: {path}")
        mf_names.append(names)
        mf_lengths.append([int(s.size) for s in seqs])
        fwd = np.concatenate(seqs) if len(seqs) > 1 else seqs[0]
        doc_len = total + 1
        pieces.append(fwd)
        pieces.append(dollar)
        if use_revcomp:
            pieces.append(revcomp(fwd))
            pieces.append(dollar)
            doc_len *= 2
        seq_lengths.append(doc_len)

    text = np.concatenate(pieces)
    _validate_byte_range(text, "build_from_files")
    return RefBuilder(text=text, seq_lengths=seq_lengths, num_docs=len(files),
                      use_revcomp=use_revcomp, input_files=files,
                      multifasta_names=mf_names, multifasta_lengths=mf_lengths)


def build_from_sequences(sequences, use_revcomp: bool = True) -> RefBuilder:
    """In-memory construction for the library API: one document per
    list-of-strings (ref_builder.cpp:318-384)."""
    pieces = []
    seq_lengths = []
    dollar = np.array([DOLLAR], dtype=np.uint8)
    for doc in sequences:
        arrs = [
            _UPPER[np.frombuffer(s.encode() if isinstance(s, str) else bytes(s),
                                 dtype=np.uint8)]
            for s in doc
        ]
        fwd = np.concatenate(arrs) if len(arrs) > 1 else arrs[0]
        doc_len = int(fwd.size) + 1
        pieces.append(fwd)
        pieces.append(dollar)
        if use_revcomp:
            pieces.append(revcomp(fwd))
            pieces.append(dollar)
            doc_len *= 2
        seq_lengths.append(doc_len)
    text = np.concatenate(pieces)
    _validate_byte_range(text, "build_from_sequences")
    return RefBuilder(text=text, seq_lengths=seq_lengths, num_docs=len(sequences),
                      use_revcomp=use_revcomp, input_files=[],
                      multifasta_names=[], multifasta_lengths=[])


def build_from_lengths(output_prefix: str, use_revcomp: bool = True) -> RefBuilder:
    """Metadata-only RefBuilder from a .lengths file (ref_builder.cpp:140-169);
    used by resume paths that don't need the text."""
    info = formats.parse_lengths(output_prefix + ".lengths")
    return RefBuilder(text=None, seq_lengths=info.seq_lengths(use_revcomp),
                      num_docs=len(info.paths), use_revcomp=use_revcomp,
                      input_files=list(info.paths),
                      multifasta_names=list(info.contig_names),
                      multifasta_lengths=list(info.contig_lengths))
