"""LCP-interval analysis (the match scan) as array ops, in PyTorch.

Port of mumemto_tpu/ops/intervals.py, windowed branch only: for a boundary
p with L = lcp[p], the candidate interval is [s, e) with s = PSV(p) and
e = NSV(p); when every interval that can pass the occurrence filters is at
most `size_cap` <= 128 rows wide, PSV/NSV, the leftmost-boundary dedup,
left-maximality and the duplicate-doc check are all found with cap-1
shifted compares instead of gathers. See the JAX module for the semantics
of each condition (mem_finder.hpp:304-355 in the reference).
"""

from __future__ import annotations

import torch

from mumemto_tpu_torch.ops.suffix import I32, _num_levels

INT32_MAX = 2**31 - 1
WINDOW_MAX = 128  # largest size_cap the windowed branch takes

_WALK_ITEM = ("the probe-guarded walk and uncapped sort branches of "
              "analyze_intervals are not yet ported to mumemto_tpu_torch "
              "(ROADMAP.md, queue 1 item 6)")


def _shifted(arr: torch.Tensor, k: int, fill) -> torch.Tensor:
    """out[i] = arr[i + k] (k may be negative), `fill` past the ends."""
    if k == 0:
        return arr
    pad = torch.full((abs(k),), fill, dtype=arr.dtype, device=arr.device)
    if k > 0:
        return torch.cat([arr[k:], pad])
    return torch.cat([pad, arr[:k]])


def _sparse_min_table(values: torch.Tensor,
                      max_level: int | None = None) -> list:
    """table[l][x] = min(values[x : x + 2^l]) with end-clamping."""
    n = values.shape[0]
    L = _num_levels(n)
    if max_level is not None:
        L = min(L, max_level)
    table = [values]
    for lvl in range(1, L + 1):
        half = 1 << (lvl - 1)
        prev = table[-1]
        if half >= n:
            table.append(prev)
            continue
        shifted = torch.cat([prev[half:], prev[-1:].expand(half)])
        table.append(torch.minimum(prev, shifted))
    return table


def _psv_nsv_windowed(lcp: torch.Tensor, n: int, cap: int):
    """PSV/NSV within a +-(cap-1) window; e = n marks open or too wide,
    s is clamped to >= 0."""
    dev = lcp.device
    p = torch.arange(n, dtype=I32, device=dev)
    s = torch.full((n,), -1, dtype=I32, device=dev)
    e = torch.full((n,), n, dtype=I32, device=dev)
    s_found = torch.zeros(n, dtype=torch.bool, device=dev)
    e_found = torch.zeros(n, dtype=torch.bool, device=dev)
    for k in range(1, cap):
        hit = ~s_found & (_shifted(lcp, -k, 0) < lcp)
        s = torch.where(hit, p - k, s)
        s_found |= hit
        hit = ~e_found & (_shifted(lcp, k, -1) < lcp)
        e = torch.where(hit, torch.clamp(p + k, max=n), e)
        e_found |= hit
    e = torch.where(s_found & e_found, e, n)
    s = torch.clamp(s, min=0)
    return s, e


def analyze_intervals(lcp: torch.Tensor, da: torch.Tensor, bwt: torch.Tensor,
                      n: int, min_match_len: int, num_distinct: int,
                      max_total_freq: int, max_doc_freq: int,
                      size_cap: int | None = None, need_ctx: bool = False):
    """Evaluate every candidate LCP interval; returns a dict of n-sized
    tensors: cand (passes every condition except left-maximality), emit
    (cand and left-maximal), s, e, L and prev_same (previous row of the
    same doc within the window, else -1).

    Only the windowed MUM configuration is ported: size_cap <= 128,
    max_doc_freq == 1 and no merge contexts. Anything else raises
    NotImplementedError."""
    if size_cap is None or size_cap > WINDOW_MAX:
        raise NotImplementedError(
            f"size_cap={size_cap}: {_WALK_ITEM}")
    if max_doc_freq != 1:
        raise NotImplementedError(
            f"max_doc_freq={max_doc_freq}: {_WALK_ITEM}")
    if need_ctx:
        raise NotImplementedError(
            "merge contexts (-M/-Mn) are not yet ported to "
            "mumemto_tpu_torch (ROADMAP.md, queue 1 item 8)")
    dev = lcp.device
    p = torch.arange(n, dtype=I32, device=dev)
    Lv = lcp
    is_cand = lcp >= min_match_len
    s, e = _psv_nsv_windowed(lcp, n, size_cap)
    closed = e < n

    # p is leftmost in its interval iff every lcp in (s, p) is > L
    leftmost = torch.ones(n, dtype=torch.bool, device=dev)
    for k in range(1, size_cap):
        inside = (p - k) > s
        leftmost &= ~inside | (_shifted(lcp, -k, 0) > Lv)

    size = e - s
    cond_size = size >= num_distinct
    cond_freq = (size <= max_total_freq) if max_total_freq != 0 else \
        torch.ones(n, dtype=torch.bool, device=dev)

    # left-maximality: the last BWT change at rows <= e-1 must be > s;
    # e - p < cap, so select shift(last_change, k-1) where e == p + k
    changed = torch.ones(n, dtype=I32, device=dev)
    changed[1:] = (bwt[1:] != bwt[:-1]).to(I32)
    last_change = torch.cummax(p * changed, 0).values
    lmv = torch.full((n,), -1, dtype=I32, device=dev)
    for k in range(1, size_cap):
        lmv = torch.where(e == p + k, _shifted(last_change, k - 1, 0), lmv)
    lm = lmv > s

    # f = 1: some doc twice inside [s, e) means some r in (s, e) has a
    # same-doc row at >= s; pairs are < cap rows apart
    prev = torch.full((n,), -1, dtype=I32, device=dev)
    found = torch.zeros(n, dtype=torch.bool, device=dev)
    for k in range(1, size_cap):
        hit = ~found & (_shifted(da, -k, -1) == da)
        prev = torch.where(hit, p - k, prev)
        found |= hit
    bad = torch.zeros(n, dtype=torch.bool, device=dev)
    for delta in range(-(size_cap - 2), size_cap - 1):
        rpos = p + delta
        bad |= (rpos > s) & (rpos < e) & (_shifted(prev, delta, -1) >= s)

    cand = is_cand & leftmost & closed & cond_size & cond_freq & ~bad
    return {"cand": cand, "emit": cand & lm, "s": s, "e": e, "L": Lv,
            "prev_same": prev}
