"""Compaction of the selected intervals into host-sized windows, in PyTorch.

Port of the compactions of mumemto_tpu/ops/pipeline.py: the selected rows
are put in the reference's pop order (close row e ascending, length L
descending) and their fields, (M, W) windows of SA values and doc ids, or
merge-threshold inputs are gathered on the device, so only O(matches)
data reaches the host.
"""

from __future__ import annotations

import torch

from mumemto_tpu_torch.ops.suffix import I32, I64


def _select_ordered(mask: torch.Tensor, e: torch.Tensor, lcp: torch.Tensor,
                    n: int, M: int) -> torch.Tensor:
    """Indices of mask=True in pop order (e asc, L desc), padded to M
    entries with n-1 (the pads sort last). Requires M >= mask.sum()."""
    idx = torch.nonzero(mask).flatten()
    if idx.numel() > M:
        raise ValueError(f"{idx.numel()} selected rows do not fit M={M}")
    key = (e[idx].to(I64) << 32) | (2**31 - lcp[idx].to(I64))
    ordered = idx[torch.sort(key, stable=True).indices].to(I32)
    pad = torch.full((M - idx.numel(),), n - 1, dtype=I32, device=mask.device)
    return torch.cat([ordered, pad])


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
