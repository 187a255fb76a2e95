"""End-to-end match finding: collection text -> .mums/.mems outputs, on one
device.

Port of mumemto_tpu/engine.py: the scan (the PFP backend in ops/pfp.py,
or the direct -g backend, ops/pipeline.scan_collection) and the
compactions (ops/pipeline.py) run on the device given. In MUM mode the
host receives the compacted windows and assembles the output lines; in
MEM mode the lines' text is written where the windows are
(_emit_mems, kernels/mem_render) and read back once. A scan can also
resume from .dict/.parse files (-p) and write its SA/LCP/BWT rows as
.sa/.lcp/.bwt files (-A); find_matches_from_arrays replays those (-a).

The host-side code below (MatchResults, _doc_metadata, _emit_mums,
_MemRecords, _join_ragged, _merge_thresholds, thresh_arrays,
write_outputs and the host half of find_matches_from_arrays) is a copy of
the numpy code in mumemto_tpu/engine.py, which cannot be imported here
because that module loads jax. Keep the two in step: the output bytes
must be equal. _emit_mems is the port's own and writes the same bytes.
"""

from __future__ import annotations

import os
import sys
import time
from collections.abc import Sequence as _Sequence
from dataclasses import dataclass, field

import numpy as np
import torch

from mumemto_tpu_torch import formats, progress, trace
from mumemto_tpu_torch.options import MatchOptions
from mumemto_tpu_torch.device import resolve
from mumemto_tpu_torch.kernels import mem_render
from mumemto_tpu_torch.ops import intervals as ops_intervals
from mumemto_tpu_torch.ops import pfp as ops_pfp
from mumemto_tpu_torch.ops import pipeline as ops_pipeline
from mumemto_tpu_torch.ops import suffix as ops_suffix

MAX_THRESH = 65535  # mem_finder.hpp:299


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


# the port's phase names -> the progress bar's stage names
# (progress._STAGES, named after the JAX package's phases)
PROGRESS_STAGE = {
    "build_pfp": "build_pfp", "read_parse": "build_pfp",
    "dict_index": "dict_index", "suffix_array": "dict_index",
    "parse_side": "parse_side", "lcp": "parse_side",
    "expand_sort_analyze": "expand_analyze", "analyze": "expand_analyze",
    "arrays_out": "arrays_out", "compact": "compact_readback",
    "emit": "emit_mums", "merge": "emit_mums",
}


def _phase_logger(devices):
    """The default phase hook of a scan on `devices` (a device, or a mesh:
    a list of devices). MUMEMTO_TPU_PROFILE=1 prints each stage's wall time
    to stderr, and an active progress bar advances; each stage then waits
    for every card of `devices` first, so the times are the devices'. With
    neither it is None, and the call's stages add no syncs."""
    prof = bool(os.environ.get("MUMEMTO_TPU_PROFILE"))
    bar = progress.active()
    if not prof and bar is None:
        return None
    if isinstance(devices, torch.device):
        devices = [devices]
    cards = [d for d in dict.fromkeys(devices) if d.type == "cuda"]
    state = {"t": time.time()}

    def log(name):
        for card in cards:
            torch.cuda.synchronize(card)
        now = time.time()
        if prof:
            print(f"[pfp_scan] {name}: {now - state['t']:.2f}s",
                  file=sys.stderr, flush=True)
        if bar is not None:
            bar.advance(PROGRESS_STAGE.get(name, name))
        state["t"] = now
    return log


def find_matches(rb, opts: MatchOptions, device="cuda", pfp_w: int = 10,
                 pfp_mod: int = 100, phase=None, backend: str = "pfp",
                 parse_prefix: str | None = None,
                 arrays_out_prefix: str | None = None,
                 show_progress: bool = True) -> MatchResults:
    """Multi-MUMs or multi-MEMs of one collection on `device`, plus the
    merge metadata when opts.merge.

    backend: "pfp" (the reference's PFP path) or "direct" (full-text
    prefix doubling, the reference's -g path). parse_prefix: resume from
    PREFIX.dict/.parse instead of rb.text (-p, pfp_mum.cpp:122-123).
    arrays_out_prefix: also write .sa/.lcp/.bwt files from the same scan
    (-A). `phase(name)` is called after each stage (PFP: build_pfp or
    read_parse, dict_index, parse_side, expand_sort_analyze; direct:
    suffix_array, lcp, analyze; then arrays_out, compact, emit, merge);
    without one, _phase_logger's hook is. show_progress: draw the phase
    bar when progress.enabled() (library callers pass False).

    Each stage is a trace.stage (pfp.build, ..., engine.merge) under the
    call's root span, engine.find_matches, which carries the hook: the
    hook is called where the stage's span ends."""
    dev = resolve(device)
    # try/finally: a raising scan must not leak the module-global bar
    bar = progress.activate() if show_progress else None
    try:
        hook = phase if phase is not None else _phase_logger(dev)
        with trace.call("engine.find_matches", hook=hook):
            return _find_matches_inner(rb, opts, dev, pfp_w, pfp_mod,
                                       backend, parse_prefix,
                                       arrays_out_prefix)
    finally:
        if bar is not None:
            progress.deactivate()


def _find_matches_inner(rb, opts, dev, pfp_w, pfp_mod, backend,
                        parse_prefix, arrays_out_prefix):
    size_cap = interval_size_cap(opts, rb.num_docs)
    if parse_prefix or backend == "pfp":
        pfp = ops_pfp.collection_pfp(rb, dev, w=pfp_w, mod=pfp_mod,
                                     parse_prefix=parse_prefix)
        res, counts, n = ops_pfp.pfp_scan(
            pfp, rb.doc_ends, rb.num_docs, opts.min_match_len,
            opts.num_distinct, opts.max_total_freq, opts.max_doc_freq,
            size_cap=size_cap, need_ctx=opts.merge)
        del pfp  # its device arrays go before the compaction
    elif backend == "direct":
        with trace.span("direct.text"):
            n_real = int(rb.text.size)
            # at least 4 zero bytes past the text
            n = ops_suffix.bucket(n_real + 4, lo=4096)
            text = _padded_text(rb, n, dev)
            doc_ends = torch.from_numpy(rb.doc_ends).to(dev)
        # the PFP dict stage's alphabet levers; the pad byte 0 is part of
        # the padded text's alphabet
        seed_thr, lcp_thr = ops_pfp.seed_thresholds(
            set(ops_pfp._alphabet(text[:n_real])) | {0})
        res, counts = ops_pipeline.scan_collection(
            text, doc_ends, n, rb.num_docs,
            opts.min_match_len, opts.num_distinct, opts.max_total_freq,
            opts.max_doc_freq, size_cap=size_cap, need_ctx=opts.merge,
            alpha_thresholds=seed_thr, lcp_thresholds=lcp_thr)
        del text, doc_ends
    else:
        raise ValueError(f"unknown backend {backend!r}: use pfp or direct")
    if arrays_out_prefix:
        with trace.stage("engine.arrays_out", "arrays_out"):
            _write_arrays_from_res(res, arrays_out_prefix, rb.num_docs)

    results = MatchResults(opts=opts, num_docs=rb.num_docs)
    # a -p resume has no text
    results.text_length = (int(rb.text.size) if rb.text is not None
                           else sum(rb.seq_lengths))
    doc_offsets, doc_lens = _doc_metadata(rb, opts)

    with trace.stage("engine.compact", "compact"):
        n_emit, n_cand, n_runs = (int(x) for x in _to_host([counts])[0])
        results.bwt_runs = n_runs
        M = ops_suffix.bucket(n_emit, lo=256)
        m = n_emit
        if opts.mum_mode:
            W = rb.num_docs  # distinct docs => window size <= N
            s, e, L, w_sa, w_da = _to_host(ops_pipeline.compact_windows_mum(
                res, n, M, W, rb.num_docs))
        else:
            # the window is as wide as the widest match: one readback of
            # the match fields before the windows are gathered
            _, s0, e0, _, _ = ops_pipeline.compact_fields(res, n, M)
            if m:
                trace.count(trace.READBACKS)
            maxw = int((e0[:m] - s0[:m]).max()) if m else 1
            W = ops_suffix.bucket(maxw, lo=8)
            # the windows stay where they are: _emit_mems renders them
            windows = [t[:m] for t in ops_pipeline.compact_windows_mem(
                res, n, M, W, rb.num_docs)]
    with trace.stage("engine.emit", "emit"):
        if opts.mum_mode:
            valid = (s[:m, None] + np.arange(W)) < e[:m, None]
            _emit_mums(results, s[:m], e[:m], L[:m], w_sa[:m],
                       w_da[:m].astype(np.int32), valid, opts,
                       doc_offsets, doc_lens, rb.num_docs)
        else:
            s, e, L, w_sa, w_da, w_prev = windows
            valid = (s[:, None] + torch.arange(W, device=s.device)) < \
                e[:, None]
            # deferred distinct-count (check_doc_range unique >= k,
            # mem_finder.hpp:265-289)
            unique = (valid & (w_prev < s[:, None])).sum(dim=1)
            trace.count(trace.READBACKS)  # nonzero reads its size back
            keep = torch.nonzero(unique >= opts.num_distinct).flatten()
            _emit_mems(results, s[keep], e[keep], L[keep], w_sa[keep],
                       w_da[keep], valid[keep], opts, doc_offsets, doc_lens)

    if opts.merge:
        with trace.stage("engine.merge", "merge"):
            Mc = ops_suffix.bucket(n_cand, lo=256)
            has0, sa_first0, prev_ctx, next_ctx = _to_host(
                ops_pipeline.compact_cand_thresh(res, n, Mc, rb.num_docs))
            _merge_thresholds(results, has0[:n_cand], sa_first0[:n_cand],
                              prev_ctx[:n_cand], next_ctx[:n_cand],
                              doc_offsets, doc_lens)
    return results


def _to_host(tensors) -> list:
    """numpy copies of device tensors (each one readback)."""
    tensors = list(tensors)
    trace.count(trace.READBACKS, len(tensors))
    return [t.cpu().numpy() for t in tensors]


def _write_arrays_from_res(res, prefix: str, num_docs: int) -> None:
    """-A checkpoint files from the scan's row arrays: PREFIX.sa and .lcp
    (5-byte ints) and .bwt (run-length), real doc rows only (pads and the
    trailing-terminator row carry doc id num_docs). The rows are selected
    on the device, so only the real rows are read back."""
    real = res["da"] < num_docs
    trace.count(trace.READBACKS, 3)  # each mask index reads its size back
    sa, lcp, bwt = _to_host([res["sa"][real], res["lcp"][real],
                             res["bwt"][real]])
    formats.write_5byte(prefix + ".sa", sa.astype(np.uint64))
    formats.write_5byte(prefix + ".lcp", lcp.astype(np.uint64))
    formats.write_rl_bwt(prefix + ".bwt", bwt)


def _padded_text(rb, n: int, dev) -> torch.Tensor:
    """rb's text zero-padded to n bytes on dev: allocated there, its pad
    zeroed there and the text copied in once."""
    n_real = int(rb.text.size)
    text = torch.empty(n, dtype=torch.uint8, device=dev)
    text[n_real:].zero_()
    text[:n_real].copy_(torch.from_numpy(rb.text))
    return text


def compute_arrays(rb, device="cuda", padded_n: int | None = None):
    """The direct index of rb's zero-padded text (padded to padded_n, or
    as the direct backend pads it) on `device`: numpy (sa, lcp, bwt, da)."""
    n = padded_n or ops_suffix.bucket(int(rb.text.size) + 4, lo=4096)
    dev = resolve(device)
    sa, lcp, bwt = ops_suffix.suffix_lcp_arrays(_padded_text(rb, n, dev))
    da = ops_suffix.doc_array(sa, torch.from_numpy(rb.doc_ends).to(dev),
                              rb.num_docs)
    return tuple(_to_host([sa, lcp, bwt, da]))


def find_matches_from_arrays(sa, lcp, bwt, da, rb, opts: MatchOptions,
                             device="cuda") -> MatchResults:
    """Matches of precomputed index arrays (numpy: the -a replay of
    .sa/.lcp/.bwt files, or compute_arrays): the interval analysis on
    `device`, then the host selection and emitters of find_matches."""
    dev = resolve(device)
    n = int(sa.size)

    def up(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).to(dev)
    res = ops_intervals.analyze_intervals(
        up(lcp, torch.int32), up(da, torch.int32), up(bwt, torch.uint8), n,
        opts.min_match_len, opts.num_distinct, opts.max_total_freq,
        opts.max_doc_freq, size_cap=interval_size_cap(opts, rb.num_docs),
        need_ctx=opts.merge)
    cand, emit, s_all, e_all, prev_same = _to_host(
        [res["cand"], res["emit"], res["s"], res["e"], res["prev_same"]])
    lcp = np.asarray(lcp)
    sa = np.asarray(sa)
    da = np.asarray(da)

    def ordered(idx):
        return idx[np.lexsort((-lcp[idx], e_all[idx]))]

    emit_idx = ordered(np.flatnonzero(emit))
    results = MatchResults(opts=opts, num_docs=rb.num_docs)
    doc_offsets, doc_lens = _doc_metadata(rb, opts)

    s = s_all[emit_idx]
    e = e_all[emit_idx]
    L = lcp[emit_idx]
    if opts.mum_mode:
        W = rb.num_docs
    else:
        W = int((e - s).max()) if emit_idx.size else 1
    cols = s[:, None] + np.arange(W)
    valid = cols < e[:, None]
    colc = np.minimum(cols, n - 1)
    w_sa = sa[colc]
    w_da = da[colc]
    if opts.max_doc_freq != 1 and emit_idx.size:
        w_prev = prev_same[colc]
        unique = (valid & (w_prev < s[:, None])).sum(axis=1)
        keep = unique >= opts.num_distinct
        s, e, L = s[keep], e[keep], L[keep]
        w_sa, w_da, valid = w_sa[keep], w_da[keep], valid[keep]

    if opts.mum_mode:
        _emit_mums(results, s, e, L, w_sa, w_da, valid, opts,
                   doc_offsets, doc_lens, rb.num_docs)
    else:
        _emit_mems(results, s, e, L, w_sa, w_da, valid, opts,
                   doc_offsets, doc_lens)

    if opts.merge:
        prev_ctx, next_ctx = _to_host([res["prev_ctx"], res["next_ctx"]])
        cand_idx = ordered(np.flatnonzero(cand))
        sc = s_all[cand_idx]
        ec = e_all[cand_idx]
        colsc = np.minimum(sc[:, None] + np.arange(rb.num_docs), n - 1)
        validc = colsc < ec[:, None]
        is0 = validc & (da[colsc] == 0)
        has0 = is0.any(axis=1)
        first0 = np.argmax(is0, axis=1)
        sa_first0 = sa[np.minimum(sc + first0, n - 1)]
        _merge_thresholds(results, has0, sa_first0, prev_ctx[cand_idx],
                          next_ctx[cand_idx], doc_offsets, doc_lens)
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


class _MemRecords(_Sequence):
    """Lazy list-like view of (L, positions, docs, strands) per match over
    flat occurrence arrays; each record materializes on access."""

    def __init__(self, L, tposf, docf, negf, offs):
        self._L = L
        self._tposf = tposf
        self._docf = docf
        self._negf = negf
        self._offs = offs

    def __len__(self):
        return len(self._L)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        o, o2 = self._offs[i], self._offs[i + 1]
        return (int(self._L[i]), self._tposf[o:o2],
                self._docf[o:o2].astype(np.int64), ~self._negf[o:o2])


def _join_ragged(pieces, starts):
    """Per-row string concatenation of a flat unicode piece array grouped
    by `starts` (reduceat over object strings)."""
    return np.add.reduceat(pieces.astype(object), starts)


def _starts(n: torch.Tensor) -> torch.Tensor:
    """The exclusive scan of the counts n, with their total last."""
    return torch.cat([n.new_zeros(1), torch.cumsum(n, 0)])


def _emit_mems(results, s, e, L, w_sa, w_da, valid, opts,
               doc_offsets, doc_lens):
    """write_mem semantics (mem_finder.hpp:210-263), incl. the last-element
    '-' transform quirk (no -1 at :248), over the compacted (m, W) windows
    (every row with at least one valid column): numpy arrays, or tensors
    of one device. The positions, their text widths and the line offsets
    are computed with PyTorch where the windows are; kernels/mem_render
    writes every line into one byte buffer there (the CUDA kernel on a
    card, its numpy twin on the CPU), which is read back once with the
    flat occurrence arrays of the records."""
    m = len(s)
    if m == 0:
        results.mem_lines = []
        results.mem_records = []
        return
    L, w_sa, w_da, valid = (torch.as_tensor(a) for a in (L, w_sa, w_da,
                                                         valid))
    dev = valid.device
    with trace.span("engine.emit_mems.positions"):
        W = valid.shape[1]
        nv = valid.sum(dim=1)
        L = L.to(torch.int64)
        docs = torch.clamp(w_da.to(torch.int64), max=len(doc_lens) - 1)
        pos = w_sa.to(torch.int64) - torch.as_tensor(doc_offsets,
                                                     device=dev)[docs]
        dl = torch.as_tensor(doc_lens, device=dev)[docs]
        if opts.use_revcomp:
            neg = valid & (pos >= dl)
        else:
            neg = torch.zeros_like(valid)
        is_last = torch.arange(W, device=dev) == (nv[:, None] - 1)
        # '-' transform: 2*len - pos - L - 1, except the LAST occurrence
        # of a match drops the -1 (mem_finder.hpp:248)
        tpos = torch.where(neg, 2 * dl - pos - L[:, None] - 1 + is_last,
                           pos)
        doc_ids = w_da.to(torch.int32)
        line_off = _starts(mem_render.line_lengths(L, tpos, doc_ids, valid))
        offs = _starts(nv)
        n_bytes, n_occ = _to_host([torch.stack([line_off[-1],
                                                offs[-1]])])[0].tolist()
        # flat occurrence arrays, row-major (valid is a prefix mask per
        # row)
        rows = torch.repeat_interleave(torch.arange(m, device=dev), nv,
                                       output_size=n_occ)
        flat = rows * W + torch.arange(n_occ, device=dev) - offs[rows]
        flats = [a.reshape(-1)[flat] for a in (tpos, doc_ids, neg)]
    with trace.span("engine.emit_mems.format"):
        text = mem_render.render(L, tpos, doc_ids, neg, nv, line_off,
                                 n_bytes)
        text, L, tposf, docf, negf, offs = _to_host([text, L, *flats, offs])
    with trace.span("engine.emit_mems.join"):
        results.mem_lines = text.tobytes().splitlines(keepends=True)
    assert len(results.mem_lines) == m, "empty emission window"
    results.mem_records = _MemRecords(L, tposf, docf, negf, offs)


def _merge_thresholds(results, has0, sa_first0, prev_ctx, next_ctx,
                      doc_offsets, doc_lens):
    """candidate_thresh updates (mem_finder.hpp:326-336): for every
    candidate interval (in pop order), next_best = min(max(LCP[s], LCP[e]),
    65535) is written at the first-genome offset of the interval's doc-0
    row. Later writes at the same position win."""
    dl0 = int(doc_lens[0])
    thresh = np.zeros(dl0 * 2, dtype=np.uint16)
    rowpos = sa_first0[has0].astype(np.int64) - doc_offsets[0]
    nb = np.minimum(np.maximum(prev_ctx[has0], next_ctx[has0]), MAX_THRESH)
    if rowpos.size:
        # keep-last-write semantics under duplicate positions
        rev = np.arange(rowpos.size - 1, -1, -1)
        uniq_pos, first_in_rev = np.unique(rowpos[rev], return_index=True)
        thresh[uniq_pos] = nb[rev][first_in_rev]
    results.candidate_thresh = thresh


def thresh_arrays(results: MatchResults, doc_len0: int):
    """Close-time .thresh/.thresh_rev generation (mem_finder.hpp:116-157),
    as one flat ragged expansion (each MUM contributes `length` threshold
    slots + one zero separator slot)."""
    mp = results.mum_positions
    order = np.argsort(mp[:, 0], kind="stable")
    mp = mp[order]
    pos_a = mp[:, 0]
    len_a = mp[:, 1]
    total = int((len_a + 1).sum())
    fwd = np.zeros(total, dtype=np.uint16)
    rev = np.zeros(total, dtype=np.uint16)
    ct = results.candidate_thresh
    nflat = int(len_a.sum())
    if nflat == 0:
        return fwd, rev
    # every per-row-affine flat quantity q_row + jj is
    # repeat(q_row - starts, len) + arange: no rowid gathers
    idx_dt = np.int64 if (nflat >= 2**31 or 2 * doc_len0 >= 2**31
                          or total >= 2**31) else np.int32
    starts = (np.cumsum(len_a) - len_a).astype(idx_dt)
    len_i = len_a.astype(idx_dt)
    pos_i = pos_a.astype(idx_dt)
    ar = np.arange(nflat, dtype=idx_dt)
    revpos = idx_dt(2 * doc_len0) - pos_i - len_i - 1
    out_starts = np.cumsum(len_i + 1) - (len_i + 1)
    ct16 = ct if ct.dtype == np.uint16 else ct.astype(np.uint16)
    fv = ct16[np.repeat(pos_i - starts, len_a) + ar]
    rv = ct16[np.repeat(revpos - starts, len_a) + ar]
    rem = np.repeat(len_i + starts, len_a) - ar
    out = np.repeat((out_starts - starts).astype(idx_dt), len_a) + ar
    sel = fv < rem
    fwd[out[sel]] = fv[sel]
    sel = rv < rem
    rev[out[sel]] = rv[sel]
    return fwd, rev


def write_outputs(results: MatchResults, rb, prefix: str) -> None:
    """Write PREFIX.mums, .mems or .bumbl, plus the merge metadata
    (.thresh/.thresh_rev, or .athresh with -n), like mem_finder's
    constructor and close (mem_finder.hpp:91-158)."""
    opts = results.opts
    if not opts.mum_mode:
        with open(prefix + ".mems", "wb") as f:
            f.write(results.output_bytes())
    elif opts.binary:
        formats.write_bumbl(prefix + ".bumbl",
                            results.lengths.astype(np.uint32),
                            results.offsets,
                            results.strands > 0,
                            partial=opts.num_distinct < results.num_docs)
    else:
        with open(prefix + ".mums", "wb") as f:
            f.write(results.output_bytes())

    if opts.anchor_merge:
        dl0 = int(rb.seq_lengths[0] // (2 if opts.use_revcomp else 1))
        formats.write_thresh(prefix + ".athresh",
                             results.candidate_thresh[:dl0])
    elif opts.merge:
        dl0 = int(rb.seq_lengths[0] // (2 if opts.use_revcomp else 1))
        fwd, rev = thresh_arrays(results, dl0)
        formats.write_thresh(prefix + ".thresh", fwd)
        formats.write_thresh(prefix + ".thresh_rev", rev)
