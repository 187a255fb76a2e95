"""End-to-end match finding: collection text -> .mums output, on one device.

Port of the MUM path of mumemto_tpu/engine.py with the PFP backend: the
scan (ops/pfp.py) and the compaction (ops/pipeline.py) run on the device
given; the host receives only the compacted windows and assembles the
.mums lines. Strict (-k 0) and partial (-k) multi-MUMs are ported; MEM
mode, merge metadata (-M/-Mn), binary output (-b), the direct backend
(-g), parse files (-P/-p) and array checkpoints (-A/-a) are not yet.

The host-side emitters below (MatchResults, _doc_metadata, _emit_mums,
_join_ragged and the MUM branch of write_outputs) are copies of the
numpy code in mumemto_tpu/engine.py, which cannot be imported here because
that module loads jax. Keep the two in step: the .mums bytes must be equal.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from mumemto_tpu.options import MatchOptions
from mumemto_tpu_torch.device import resolve
from mumemto_tpu_torch.ops import pfp as ops_pfp
from mumemto_tpu_torch.ops import pipeline as ops_pipeline


def interval_size_cap(opts: MatchOptions, num_docs: int) -> int | None:
    """Static upper bound on the SA-row count of any interval that can pass
    the occurrence filters (<= f rows per doc, <= F in total), rounded up
    to a power of two; None when both are unlimited."""
    caps = []
    if opts.max_doc_freq > 0:
        caps.append(num_docs * opts.max_doc_freq)
    if opts.max_total_freq > 0:
        caps.append(int(opts.max_total_freq))
    if not caps:
        return None
    cap = min(caps)
    return 1 << max(cap.bit_length(), 2)


@dataclass
class MatchResults:
    """Compacted, emission-ordered match set + merge metadata."""
    opts: MatchOptions
    num_docs: int
    # MUM mode: per-match doc-major arrays
    lengths: np.ndarray = None          # (m,) int64
    offsets: np.ndarray = None          # (m, N) int64, -1 = absent
    strands: np.ndarray = None          # (m, N) int8: +1/-1/0
    # MEM mode: ragged per-match occurrence lists
    mem_lines: list = field(default_factory=list)
    mem_records: list = field(default_factory=list)
    # merge metadata
    candidate_thresh: np.ndarray = None
    mum_positions: np.ndarray = None     # (m, 2) [offset-in-doc0, length]
    # run stats (reference n/r, pfp_mum.cpp:148-150)
    text_length: int = 0
    bwt_runs: int = 0

    @property
    def num_matches(self) -> int:
        if self.opts.mum_mode:
            return 0 if self.lengths is None else len(self.lengths)
        return len(self.mem_lines)

    def mum_lines(self) -> list:
        """Vectorized .mums line assembly (format_mum_line semantics,
        mem_finder.hpp:406-425: docs 0..N-2 always get a trailing comma,
        absent slots render empty, last doc appended only if present)."""
        m = len(self.lengths)
        if m == 0:
            return []
        N = self.offsets.shape[1]
        present = self.offsets != -1
        sep = np.array([","] * (N - 1) + [""])
        pos_p = np.char.add(
            np.where(present, np.char.mod("%d", self.offsets), ""), sep)
        strand_p = np.char.add(
            np.where(present,
                     np.where(self.strands > 0, "+", "-"), ""), sep)
        starts = np.arange(m, dtype=np.int64) * N
        pos_col = _join_ragged(pos_p.ravel(), starts)
        strand_col = _join_ragged(strand_p.ravel(), starts)
        head = np.char.add(np.char.mod("%d", self.lengths), "\t")
        full = head.astype(object) + pos_col + "\t" + strand_col + "\n"
        return "".join(full.tolist()).encode().splitlines(keepends=True)

    def output_bytes(self) -> bytes:
        if self.opts.mum_mode:
            return b"".join(self.mum_lines())
        return b"".join(self.mem_lines)


def _doc_metadata(rb, opts):
    doc_offsets = np.zeros(rb.num_docs, dtype=np.int64)
    doc_offsets[1:] = np.cumsum(np.asarray(rb.seq_lengths))[:-1]
    doc_lens = np.asarray(rb.seq_lengths, dtype=np.int64)
    if opts.use_revcomp:
        doc_lens = doc_lens // 2
    return doc_offsets, doc_lens


def _check_ported(opts: MatchOptions) -> None:
    if not opts.mum_mode:
        raise NotImplementedError(
            "MEM mode (-f != 1) is not yet ported to mumemto_tpu_torch "
            "(ROADMAP.md, queue 1 item 7)")
    if opts.merge or opts.anchor_merge:
        raise NotImplementedError(
            "merge metadata (-M/-Mn) is not yet ported to mumemto_tpu_torch "
            "(ROADMAP.md, queue 1 item 8)")


def find_matches(rb, opts: MatchOptions, device="cuda", pfp_w: int = 10,
                 pfp_mod: int = 100, phase=None) -> MatchResults:
    """Multi-MUMs of one collection with the PFP backend on `device`.
    `phase(name)` is called after each stage (build_pfp, dict_index,
    parse_side, expand_sort_analyze, compact, emit)."""
    _check_ported(opts)
    dev = resolve(device)
    size_cap = interval_size_cap(opts, rb.num_docs)
    res, counts, n = ops_pfp.scan_collection_pfp(
        rb.text, rb.doc_ends, rb.num_docs, opts.min_match_len,
        opts.num_distinct, opts.max_total_freq, opts.max_doc_freq, dev,
        w=pfp_w, mod=pfp_mod, size_cap=size_cap, phase=phase)
    n_emit, _n_cand, n_runs = (int(x) for x in counts.cpu())

    results = MatchResults(opts=opts, num_docs=rb.num_docs)
    results.bwt_runs = n_runs
    results.text_length = int(rb.text.size)
    doc_offsets, doc_lens = _doc_metadata(rb, opts)

    W = rb.num_docs  # distinct docs => window size <= N
    M = ops_pipeline.bucket(n_emit)
    s, e, L, w_sa, w_da = (t.cpu().numpy() for t in
                           ops_pipeline.compact_windows_mum(
                               res, n, M, W, rb.num_docs))
    if phase is not None:
        phase("compact")
    m = n_emit
    valid = (s[:m, None] + np.arange(W)) < e[:m, None]
    _emit_mums(results, s[:m], e[:m], L[:m], w_sa[:m],
               w_da[:m].astype(np.int32), valid, opts,
               doc_offsets, doc_lens, rb.num_docs)
    if phase is not None:
        phase("emit")
    return results


def _emit_mums(results, s, e, L, w_sa, w_da, valid, opts,
               doc_offsets, doc_lens, num_docs):
    """write_mum semantics (mem_finder.hpp:357-428), vectorized over the
    compacted (m, W) windows (W = num_docs; all docs distinct in MUM mode)."""
    m = len(s)
    N = num_docs
    L = L.astype(np.int64)
    if m == 0:
        results.lengths = np.zeros(0, dtype=np.int64)
        results.offsets = np.zeros((0, N), dtype=np.int64)
        results.strands = np.zeros((0, N), dtype=np.int8)
        results.mum_positions = np.zeros((0, 2), dtype=np.int64)
        return
    docs = np.minimum(w_da, N - 1)
    pos = w_sa.astype(np.int64) - doc_offsets[docs]
    dl = doc_lens[docs]
    neg = (valid & (pos >= dl)) if opts.use_revcomp else np.zeros_like(valid)
    # '-'-strand matches crossing the doc's final terminator are dropped
    # whole (mem_finder.hpp:372-373)
    wrap_bad = (neg & (pos + L[:, None] >= 2 * dl)).any(axis=1)
    tpos = np.where(neg, 2 * dl - pos - L[:, None] - 1, pos)

    OFF = np.full((m, N), -1, dtype=np.int64)
    STR = np.zeros((m, N), dtype=np.int8)
    rows = np.broadcast_to(np.arange(m)[:, None], valid.shape)
    OFF[rows[valid], docs[valid]] = tpos[valid]
    STR[rows[valid], docs[valid]] = np.where(neg[valid], -1, 1)

    # canonicalization: first present genome among docs 0..N-2 (or N-1 if
    # none present) must be '+' (mem_finder.hpp:383-391)
    head = STR[:, : N - 1] if N > 1 else STR
    anyset = (head != 0).any(axis=1)
    first = np.where(anyset, np.argmax(head != 0, axis=1), N - 1)
    first_strand = STR[np.arange(m), first]
    keep = ~wrap_bad & (first_strand != -1)

    results.lengths = L[keep]
    results.offsets = OFF[keep]
    results.strands = STR[keep]
    results.mum_positions = np.stack(
        [OFF[keep][:, 0], L[keep]], axis=1) if opts.merge else None


def _join_ragged(pieces, starts):
    """Per-row string concatenation of a flat unicode piece array grouped
    by `starts` (reduceat over object strings)."""
    return np.add.reduceat(pieces.astype(object), starts)


def write_outputs(results: MatchResults, rb, prefix: str) -> None:
    """Write PREFIX.mums (text multi-MUM format, mem_finder.hpp:91-158)."""
    opts = results.opts
    _check_ported(opts)
    if opts.binary:
        raise NotImplementedError(
            "binary output (-b) is not yet ported to mumemto_tpu_torch "
            "(ROADMAP.md, queue 1 item 9)")
    with open(prefix + ".mums", "wb") as f:
        f.write(results.output_bytes())
