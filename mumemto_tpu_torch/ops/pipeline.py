"""Compaction of the emitted intervals into host-sized windows, in PyTorch.

Port of the MUM-mode compaction of mumemto_tpu/ops/pipeline.py: the
selected rows are put in the reference's pop order (close row e ascending,
length L descending) and their (M, W) windows of SA values and doc ids are
gathered on the device, so only O(matches) data reaches the host.
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


def compact_windows_mum(res: dict, n: int, M: int, W: int, num_docs: int):
    """(s, e, L, w_sa, w_da) of the emitted intervals in pop order; the
    windows are the W rows from s (clamped at n-1)."""
    idx = _select_ordered(res["emit"], res["e"], res["L"], n, M)
    s = res["s"][idx]
    e = res["e"][idx]
    L = res["L"][idx]
    cols = s[:, None] + torch.arange(W, dtype=I32, device=s.device)[None, :]
    colc = torch.clamp(cols, 0, n - 1)
    w_sa = res["sa"][colc]
    w_da = res["da"][colc].to(_da_dtype(num_docs))
    return s, e, L, w_sa, w_da


def bucket(m: int, lo: int = 256) -> int:
    """0.75/1.0-of-a-power-of-two bucket for compaction sizes."""
    m = max(m, 1)
    p = 1 << (m - 1).bit_length()
    if p // 2 + p // 4 >= m:
        p = p // 2 + p // 4
    return max(lo, p)
