"""The direct (-g) scan and the compaction of the selected intervals into
host-sized windows, in PyTorch.

Port of mumemto_tpu/ops/pipeline.py. scan_collection builds the full-text
index and runs the interval analysis without a parse. The compactions put
the selected rows in the reference's pop order (close row e ascending,
length L descending) and gather their fields, (M, W) windows of SA values
and doc ids, or merge-threshold inputs on the device, so only O(matches)
data reaches the host.
"""

from __future__ import annotations

import torch

from mumemto_tpu_torch import trace
from mumemto_tpu_torch.ops import intervals as ops_intervals
from mumemto_tpu_torch.ops import suffix as ops_suffix
from mumemto_tpu_torch.ops.suffix import I32, I64


def scan_collection(text: torch.Tensor, doc_ends: torch.Tensor, n: int,
                    num_docs: int, min_match_len: int, num_distinct: int,
                    max_total_freq: int, max_doc_freq: int,
                    size_cap: int | None = None, need_ctx: bool = True,
                    alpha_thresholds=None, lcp_thresholds=None, phase=None):
    """Direct (-g) backend on text's device: uncapped prefix doubling of
    the zero-padded text (n chars), exact LCP, BWT and doc ids, then the
    interval analysis. Returns (res, counts) with counts = [emit, cand,
    BWT runs]. phase(name) is called after the suffix_array, lcp and
    analyze stages, where their spans (direct.suffix_array, direct.lcp,
    direct.analyze) end.

    alpha_thresholds (<= 8 distinct bytes) seed 8-char ranks and take the
    PLCP LCP; otherwise the rank descent with the packed bottom
    (lcp_thresholds). The uncapped history ends with an all-distinct rank
    row, so the LCP is exact on every real row; the zero-pad class is
    pinned by canonicalize_pad_lcp (doc_ends[num_docs-1] + 1 is the first
    pad position). The PLCP runs with probe_words=2, where the JAX backend
    uses 1: the values do not depend on it, and the 18-char probe leaves
    fewer rows to the descent."""
    with trace.span("direct.suffix_array"):
        sa, hist, num_lvl = ops_suffix._suffix_array_impl(
            text, n, packed_init=True, alpha_thresholds=alpha_thresholds)
    if phase is not None:
        phase("suffix_array")
    with trace.span("direct.lcp"):
        if alpha_thresholds is not None:
            # deep_cap n//4, as in JAX: the repetitive full text leaves far
            # more saturated irreducible rows than the dictionary does
            lcp, _isa = ops_suffix._lcp_plcp_impl(
                sa, hist, text, n, hist.shape[0], alpha_thresholds,
                deep_cap=max(n // 4, 1024), num_lvl=num_lvl)
        else:
            lcp = ops_suffix._lcp_impl(sa, hist, num_lvl, n, text=text,
                                       bottom_thresholds=lcp_thresholds)
        del hist
        trace.count(trace.READBACKS)
        lcp = ops_suffix.canonicalize_pad_lcp(
            lcp, sa, int(doc_ends[num_docs - 1]) + 1, n)
    if phase is not None:
        phase("lcp")
    with trace.span("direct.analyze"):
        bwt = ops_suffix.bwt_of(text, sa)
        da = ops_suffix.doc_array(sa, doc_ends, num_docs)
        res = ops_intervals.analyze_intervals(
            lcp, da, bwt, n, min_match_len, num_distinct, max_total_freq,
            max_doc_freq, size_cap=size_cap, need_ctx=need_ctx)
        res["sa"] = sa
        res["da"] = da
        res["lcp"] = lcp
        res["bwt"] = bwt
        # BWT run count over real rows (the reference's n/r stat,
        # pfp_mum.cpp:148-150); pad rows (da == num_docs) excluded
        real = da < num_docs
        change = (bwt[1:] != bwt[:-1]) & real[1:] & real[:-1]
        nruns = change.sum(dtype=I32) + 1
        counts = torch.stack([res["emit"].sum(dtype=I32),
                              res["cand"].sum(dtype=I32), nruns])
    if phase is not None:
        phase("analyze")
    return res, counts


def _select_ordered(mask: torch.Tensor, e: torch.Tensor, lcp: torch.Tensor,
                    n: int, M: int) -> torch.Tensor:
    """Indices of mask=True in pop order (e asc, L desc), padded to M
    entries with n-1 (the pads sort last). Requires M >= mask.sum()."""
    trace.count(trace.READBACKS)  # nonzero reads its size back
    idx = torch.nonzero(mask).flatten()
    if idx.numel() > M:
        raise ValueError(f"{idx.numel()} selected rows do not fit M={M}")
    key = (e[idx].to(I64) << 32) | (2**31 - lcp[idx].to(I64))
    ordered = idx[torch.sort(key, stable=True).indices].to(I32)
    pad = torch.full((M - idx.numel(),), n - 1, dtype=I32, device=mask.device)
    return torch.cat([ordered, pad])


def _first_m(mask: torch.Tensor, M: int) -> torch.Tensor:
    """mask with only its first M set rows kept, for a fixed-capacity
    compaction: the counts are reported whole, and the caller refuses an
    overflow afterwards (parallel/partition._check_capacity)."""
    trace.count(trace.READBACKS)
    if int(mask.sum()) <= M:
        return mask
    return mask & (torch.cumsum(mask, 0) <= M)


def _da_dtype(num_docs: int):
    """Doc-id window dtype: int16 when every id incl. the num_docs pad
    sentinel fits."""
    return torch.int16 if num_docs < 32767 else torch.int32


def _windows(res: dict, idx: torch.Tensor, n: int, W: int):
    """(s, e, L) of the rows `idx` and the clamped window columns: the W
    rows from s, clamped at n-1."""
    s = res["s"][idx]
    cols = s[:, None] + torch.arange(W, dtype=I32, device=s.device)[None, :]
    return s, res["e"][idx], res["L"][idx], torch.clamp(cols, 0, n - 1)


def compact_windows_mum(res: dict, n: int, M: int, W: int, num_docs: int):
    """(s, e, L, w_sa, w_da) of the emitted intervals in pop order."""
    idx = _select_ordered(res["emit"], res["e"], res["L"], n, M)
    s, e, L, colc = _windows(res, idx, n, W)
    return s, e, L, res["sa"][colc], res["da"][colc].to(_da_dtype(num_docs))


def compact_windows_mem(res: dict, n: int, M: int, W: int, num_docs: int):
    """MEM mode: (s, e, L, w_sa, w_da, w_prev) of the emitted intervals in
    pop order; w_prev (prev-same-doc pointers) feeds the host's deferred
    distinct-doc count."""
    idx = _select_ordered(res["emit"], res["e"], res["L"], n, M)
    s, e, L, colc = _windows(res, idx, n, W)
    return (s, e, L, res["sa"][colc], res["da"][colc].to(_da_dtype(num_docs)),
            res["prev_same"][colc])


def compact_fields(res: dict, n: int, M: int):
    """(idx, s, e, L, real) of the emitted intervals in pop order, no
    windows. The pads alias row n-1, so `real` comes from the position:
    the pop order packs the real rows first."""
    idx = _select_ordered(res["emit"], res["e"], res["L"], n, M)
    real = torch.arange(M, device=idx.device) < res["emit"].sum()
    return idx, res["s"][idx], res["e"][idx], res["L"][idx], real


def compact_cand_thresh(res: dict, n: int, M: int, W: int):
    """Merge-threshold inputs of the candidate intervals in pop order:
    (has0, sa_first0, prev_ctx, next_ctx), where has0 says a doc-0 row
    lies in the interval and sa_first0 is the SA value of the first one.
    res must hold the merge contexts (need_ctx)."""
    idx = _select_ordered(res["cand"], res["e"], res["L"], n, M)
    s = res["s"][idx]
    e = res["e"][idx]
    real = torch.arange(M, device=idx.device) < res["cand"].sum()
    cols = s[:, None] + torch.arange(W, dtype=I32, device=s.device)[None, :]
    valid = (cols < e[:, None]) & real[:, None]
    is0 = valid & (res["da"][torch.clamp(cols, 0, n - 1)] == 0)
    has0 = is0.any(dim=1)
    # argmax returns the first maximal index; all-False rows give 0, as in
    # JAX, and has0 masks them
    first0 = torch.argmax(is0.to(torch.uint8), dim=1).to(I32)
    sa_first0 = res["sa"][torch.clamp(s + first0, 0, n - 1)]
    return has0, sa_first0, res["prev_ctx"][idx], res["next_ctx"][idx]


def bucket(m: int, lo: int = 256) -> int:
    """0.75/1.0-of-a-power-of-two bucket for compaction sizes."""
    m = max(m, 1)
    p = 1 << (m - 1).bit_length()
    if p // 2 + p // 4 >= m:
        p = p // 2 + p // 4
    return max(lo, p)
