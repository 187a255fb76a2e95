"""In-memory Python API mirroring the reference library, on one device.

A copy of mumemto_tpu/library.py (which cannot be imported here because
its engine loads jax) with the scan on the port's engine and a `device`
keyword. Reference surfaces: mumemto::mumemto_mum / mumemto_mem
(mumemto_library/mumemto_api.hpp:43-57, impl mumemto_api.cpp:332-411) and
the pybind MumResult/MemResult wrappers
(python_bindings/src/mumemto_pybind.cpp:47-117): match_at(i) returns
(length, offsets int64[num_docs], strands bool[num_docs]) for MUMs and
(length, offsets, seq_ids, strands) per occurrence for MEMs.

Notes matching the reference library (not the CLI):
  * num_distinct == 0 maps to "all documents" (mumemto_api.cpp:344-345,
    387-388); no other CLI-style normalization is applied.
  * mem() rejects max_doc_freq <= 1 (mumemto_api.cpp:381-383).
  * max_total_freq is passed through untouched (0 = unlimited).
  * seq_shards=N runs the sharded scan (parallel/seqpfp.py) over N
    shards placed round-robin on the visible cards; on one card, or with
    device="cpu", every shard runs on that device.
  * The C ABI's shims (_cabi_mum, _cabi_mem) take their device from the
    environment variable MUMEMTO_TORCH_DEVICE (default "cuda"), because a
    C caller passes positional arguments only. mum() and mem() ignore it.
"""

from __future__ import annotations

import os

import numpy as np

from mumemto_tpu_torch import refbuilder
from mumemto_tpu_torch.options import MatchOptions
from mumemto_tpu_torch import engine


class MumResult:
    """Result of mum(): per-match (length, offsets, strands) arrays."""

    def __init__(self, results: engine.MatchResults, lengths):
        self._r = results
        self.lengths = lengths  # per-doc per-record input lengths

    def num_docs(self) -> int:
        return self._r.num_docs

    def num_matches(self) -> int:
        return self._r.num_matches

    def __len__(self) -> int:
        return self.num_matches()

    def match_at(self, idx: int):
        if idx < 0 or idx >= self.num_matches():
            raise IndexError("MumResult index out of range")
        return (int(self._r.lengths[idx]),
                self._r.offsets[idx],
                self._r.strands[idx] > 0)

    def __getitem__(self, idx: int):
        return self.match_at(idx)

    # columnar accessors (engine-native layout, beyond the reference API)
    @property
    def match_lengths(self) -> np.ndarray:
        return self._r.lengths

    @property
    def offsets(self) -> np.ndarray:
        return self._r.offsets

    @property
    def strands(self) -> np.ndarray:
        return self._r.strands > 0


class MemResult:
    """Result of mem(): per-match (length, offsets, seq_ids, strands)."""

    def __init__(self, results: engine.MatchResults, lengths, num_docs):
        self._r = results
        self.lengths = lengths
        self._num_docs = num_docs

    def num_docs(self) -> int:
        return self._num_docs

    def num_matches(self) -> int:
        return len(self._r.mem_records)

    def __len__(self) -> int:
        return self.num_matches()

    def match_at(self, idx: int):
        if idx < 0 or idx >= self.num_matches():
            raise IndexError("MemResult index out of range")
        L, pos, docs, strands = self._r.mem_records[idx]
        return (int(L), pos, docs, strands)

    def __getitem__(self, idx: int):
        return self.match_at(idx)


def _record_lengths(sequences):
    return [[len(s) for s in doc] for doc in sequences]


def _run(rb, opts, seq_shards: int, device):
    """Dispatch a library scan: single-device, or the sharded scan when
    seq_shards > 0 (a power of two)."""
    if seq_shards:
        from mumemto_tpu_torch.parallel import mesh, seqpfp
        return seqpfp.find_matches_seq_sharded(
            rb, opts, mesh.seq_devices(seq_shards, device, "seq_shards"))
    return engine.find_matches(rb, opts, device=device, show_progress=False)


def _cabi_device() -> str:
    """The device of the C ABI's shims: MUMEMTO_TORCH_DEVICE, default
    "cuda". No fallback: "cuda" on a machine without a card fails in
    device.resolve, and the C side reports that error."""
    return os.environ.get("MUMEMTO_TORCH_DEVICE", "cuda")


def mum(sequences, min_match_len: int = 20, use_revcomp: bool = True,
        num_distinct: int = 0, seq_shards: int = 0,
        device="cuda") -> MumResult:
    """Find multi-MUMs across in-memory sequence collections on `device`.

    sequences: list of documents, each a list of str/bytes records.
    seq_shards: shard the scan into that many row blocks (CLI
    --seq-shards).
    """
    rb = refbuilder.build_from_sequences(sequences, use_revcomp=use_revcomp)
    if num_distinct == 0:
        num_distinct = rb.num_docs
    opts = MatchOptions(min_match_len=min_match_len, num_distinct=num_distinct,
                        max_doc_freq=1, max_total_freq=0,
                        use_revcomp=use_revcomp)
    results = _run(rb, opts, seq_shards, device)
    return MumResult(results, _record_lengths(sequences))


def _cabi_mum(sequences, min_match_len, use_revcomp, num_distinct,
              device=None):
    """C-ABI marshalling shim (capi/mumemto_capi.cc): flat bytes out.
    device None: _cabi_device()."""
    r = mum(sequences, min_match_len, bool(use_revcomp), num_distinct,
            device=device or _cabi_device())
    m = r.num_matches()
    n = r.num_docs()
    lengths = np.ascontiguousarray(r.match_lengths, dtype=np.uint32).tobytes()
    offsets = np.ascontiguousarray(r.offsets, dtype=np.int64).tobytes()
    strands = np.ascontiguousarray(r.strands, dtype=np.uint8).tobytes()
    return m, n, lengths, offsets, strands


def _cabi_mem(sequences, min_match_len, use_revcomp, num_distinct,
              max_total_freq, max_doc_freq, device=None):
    """C-ABI marshalling shim: ragged MEM occurrences flattened with a
    prefix-offset table. device None: _cabi_device()."""
    r = mem(sequences, min_match_len, bool(use_revcomp), num_distinct,
            max_total_freq, max_doc_freq,
            device=device or _cabi_device())
    recs = r._r.mem_records
    m = len(recs)
    n = r.num_docs()
    lens = np.asarray([t[0] for t in recs], dtype=np.uint32)
    counts = [len(t[1]) for t in recs]
    occ_off = np.zeros(m + 1, dtype=np.uint64)
    np.cumsum(counts, out=occ_off[1:])
    if m:
        pos = np.concatenate([t[1] for t in recs]).astype(np.int64)
        ids = np.concatenate([t[2] for t in recs]).astype(np.uint32)
        strands = np.concatenate([t[3] for t in recs]).astype(np.uint8)
    else:
        pos = np.zeros(0, np.int64)
        ids = np.zeros(0, np.uint32)
        strands = np.zeros(0, np.uint8)
    return (m, n, lens.tobytes(), occ_off.tobytes(), pos.tobytes(),
            ids.tobytes(), strands.tobytes())


def mem(sequences, min_match_len: int = 20, use_revcomp: bool = True,
        num_distinct: int = 0, max_total_freq: int = 0,
        max_doc_freq: int = 2, seq_shards: int = 0,
        device="cuda") -> MemResult:
    """Find multi-MEMs (per-doc frequency up to max_doc_freq) on
    `device`."""
    if max_doc_freq <= 1:
        raise ValueError(
            "mumemto_mem requires max_doc_freq > 1 (use mumemto_mum for unique matches)")
    rb = refbuilder.build_from_sequences(sequences, use_revcomp=use_revcomp)
    if num_distinct == 0:
        num_distinct = rb.num_docs
    opts = MatchOptions(min_match_len=min_match_len, num_distinct=num_distinct,
                        max_doc_freq=max_doc_freq, max_total_freq=max_total_freq,
                        use_revcomp=use_revcomp)
    results = _run(rb, opts, seq_shards, device)
    return MemResult(results, _record_lengths(sequences), rb.num_docs)
