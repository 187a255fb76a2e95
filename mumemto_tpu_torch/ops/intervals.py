"""LCP-interval analysis (the match scan) as array ops, in PyTorch.

Port of mumemto_tpu/ops/intervals.py, every branch: for a boundary p with
L = lcp[p], the candidate interval is [s, e) with s = PSV(p) and
e = NSV(p). Three ways to find them, chosen by `size_cap` (the widest
interval that can pass the occurrence filters):

  windowed  size_cap <= 128: PSV/NSV, the leftmost-boundary dedup,
            left-maximality and the merge contexts by cap-1 shifted
            compares instead of gathers;
  walk      128 < size_cap < n: binary descents over a range-min table
            of log2(cap) levels, every probe guarded to p +- cap;
  uncapped  size_cap None (-f 0 -F 0): full-height descents and the
            (e, L) sort dedup.

The per-doc frequency check is the shifted-compare form for windowed
f = 1 and the global prev-same-doc pointer chain otherwise. See the JAX
module for the semantics of each condition (mem_finder.hpp:304-355 in the
reference).
"""

from __future__ import annotations

import torch

from mumemto_tpu_torch.kernels import scan
from mumemto_tpu_torch.ops.suffix import I32, I64, _num_levels

INT32_MAX = 2**31 - 1
WINDOW_MAX = 128  # largest size_cap the windowed branch takes


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


def _psv_walk(table_min: list, p: torch.Tensor, thresh: torch.Tensor,
              max_dist: int | None = None) -> torch.Tensor:
    """max q < p with lcp[q] < thresh (exists whenever lcp[0] < thresh).
    max_dist bounds every probe to positions >= p - max_dist; a walk whose
    PSV lies farther stops on a >= thresh position (the caller's
    found-check invalidates it)."""
    n = table_min[0].shape[0]
    cur = p - 1
    for lvl in range(len(table_min) - 1, -1, -1):
        width = 1 << lvl
        start = cur - width + 1
        ok = start >= 0
        if max_dist is not None:
            ok &= start >= p - max_dist
        blockmin = table_min[lvl][torch.clamp(start, 0, n - 1)]
        cur = torch.where(ok & (blockmin >= thresh), cur - width, cur)
    return cur


def _nsv_walk(table_min: list, p: torch.Tensor, thresh: torch.Tensor,
              max_dist: int | None = None) -> torch.Tensor:
    """min q > p with lcp[q] < thresh, or n if none (open interval);
    max_dist is the mirror of _psv_walk's probe guard."""
    n = table_min[0].shape[0]
    cur = p + 1
    for lvl in range(len(table_min) - 1, -1, -1):
        width = 1 << lvl
        ok = cur + width <= n
        if max_dist is not None:
            ok &= cur + width <= p + 1 + max_dist
        blockmin = table_min[lvl][torch.clamp(cur, 0, n - 1)]
        cur = torch.where(ok & (blockmin >= thresh), cur + width, cur)
    return cur


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


def prev_same_doc(da: torch.Tensor) -> torch.Tensor:
    """prev[r] = largest r' < r with da[r'] == da[r], else -1."""
    n = da.shape[0]
    d_sorted, i_sorted = torch.sort(da, stable=True)
    prev_sorted = torch.full((n,), -1, dtype=I32, device=da.device)
    prev_sorted[1:] = torch.where(d_sorted[1:] == d_sorted[:-1],
                                  i_sorted[:-1].to(I32), -1)
    out = torch.empty(n, dtype=I32, device=da.device)
    out[i_sorted] = prev_sorted
    return out


def _compose_prev(prev: torch.Tensor, times: int) -> torch.Tensor:
    """times-fold composition of the prev-pointer (per-doc freq > f)."""
    out = prev
    for _ in range(times - 1):
        out = torch.where(out >= 0, prev[torch.clamp(out, min=0)], -1)
    return out


def _first_violation_from(prevf: torch.Tensor) -> torch.Tensor:
    """mindup[s] = min{ r : prevf[r] >= s }, or INT32_MAX if none: one
    scatter-min and one reverse cummin. [s, e) violates the per-doc cap
    iff mindup[s] < e."""
    n = prevf.shape[0]
    r = torch.arange(n, dtype=I32, device=prevf.device)
    a = torch.full((n,), INT32_MAX, dtype=I32, device=prevf.device)
    a.scatter_reduce_(0, torch.clamp(prevf, 0, n - 1).to(I64),
                      torch.where(prevf >= 0, r, INT32_MAX),
                      reduce="amin", include_self=True)
    return scan.running_min(a, reverse=True)


def _leftmost_mask(e: torch.Tensor, lcp: torch.Tensor, n: int
                   ) -> torch.Tensor:
    """keep[p] = True iff p is the smallest boundary of its interval; all
    boundaries of one interval share (e, L). The JAX code sorts on
    (e, L, p); p is the position, so one stable sort of (e << 31) | L
    orders the same. The key is exact in int64: 0 <= e <= n < 2^31 and
    0 <= L < 2^31."""
    key = (e.to(I64) << 31) | lcp.to(I64)
    key_s, perm = torch.sort(key, stable=True)
    first = torch.ones(n, dtype=torch.bool, device=e.device)
    first[1:] = key_s[1:] != key_s[:-1]
    out = torch.empty(n, dtype=torch.bool, device=e.device)
    out[perm] = first
    return out


def analyze_intervals(lcp: torch.Tensor, da: torch.Tensor, bwt: torch.Tensor,
                      n: int, min_match_len: int, num_distinct: int,
                      max_total_freq: int, max_doc_freq: int,
                      size_cap: int | None = None, need_ctx: bool = False):
    """Evaluate every candidate LCP interval; returns a dict of n-sized
    tensors: cand (passes every condition except left-maximality), emit
    (cand and left-maximal), s, e, L, prev_same (previous row of the same
    doc: window-local for windowed f = 1, global otherwise) and, with
    need_ctx, the merge contexts prev_ctx = lcp[s] and next_ctx = lcp[e].

    For max_doc_freq != 1 the distinct-count (unique >= k) check is left
    to the host over the compacted matches, as in the JAX package."""
    dev = lcp.device
    p = torch.arange(n, dtype=I32, device=dev)
    Lv = lcp
    is_cand = lcp >= min_match_len

    windowed = size_cap is not None and size_cap <= WINDOW_MAX
    walk_levels = None
    if windowed:
        s, e = _psv_nsv_windowed(lcp, n, size_cap)
    else:
        if size_cap is not None and size_cap < n:
            # levels 0..walk_levels cover walk distances up to
            # 2^(walk_levels+1) - 1 >= size_cap
            walk_levels = max((size_cap + 1).bit_length() - 1, 1)
        guard = size_cap if walk_levels is not None else None
        tmin = _sparse_min_table(lcp, max_level=walk_levels)
        s = _psv_walk(tmin, p, Lv, max_dist=guard)
        e = _nsv_walk(tmin, p, Lv, max_dist=guard)
        if walk_levels is not None:
            # a walk endpoint that is not a smaller value means the
            # interval is wider than the cap: invalidate (e = n), and
            # reject widths over the cap explicitly, as the JAX code does
            s_found = (lcp[torch.clamp(s, 0, n - 1)] < Lv) | (s < 0)
            e_found = (e < n) & (lcp[torch.clamp(e, 0, n - 1)] < Lv)
            e = torch.where(s_found & e_found & (e - s <= size_cap), e, n)
    closed = e < n

    if windowed:
        # p is leftmost iff every lcp in (s, p) is > L
        leftmost = torch.ones(n, dtype=torch.bool, device=dev)
        for k in range(1, size_cap):
            inside = (p - k) > s
            leftmost &= ~inside | (_shifted(lcp, -k, 0) > Lv)
    elif walk_levels is not None:
        # the max q < p with lcp[q] <= L (PSV at threshold L + 1) is <= s;
        # the clamp keeps L + 1 inside int32
        thr = torch.clamp(Lv, max=INT32_MAX - 1) + 1
        leftmost = _psv_walk(tmin, p, thr, max_dist=size_cap) <= s
    else:
        leftmost = _leftmost_mask(e, lcp, n)

    size = e - s
    cond_size = size >= num_distinct
    cond_freq = (size <= max_total_freq) if max_total_freq != 0 else \
        torch.ones(n, dtype=torch.bool, device=dev)

    # left-maximality: the last BWT change at rows <= e-1 must be > s
    changed = torch.ones(n, dtype=I32, device=dev)
    changed[1:] = (bwt[1:] != bwt[:-1]).to(I32)
    last_change = scan.running_max(p * changed)
    if windowed:
        # e - p < cap: select shift(last_change, k-1) where e == p + k
        lmv = torch.full((n,), -1, dtype=I32, device=dev)
        for k in range(1, size_cap):
            lmv = torch.where(e == p + k, _shifted(last_change, k - 1, 0),
                              lmv)
        lm = lmv > s
    else:
        lm = last_change[torch.clamp(e - 1, 0, n - 1)] > s

    if windowed and max_doc_freq == 1:
        # some doc twice inside [s, e) means some r in (s, e) has a
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
        doc_freq_ok = ~bad
    elif max_doc_freq > 0:
        prev = prev_same_doc(da)
        mindup = _first_violation_from(_compose_prev(prev, max_doc_freq))
        doc_freq_ok = mindup[torch.clamp(s, 0, n - 1)] >= e
    else:
        prev = prev_same_doc(da)
        doc_freq_ok = torch.ones(n, dtype=torch.bool, device=dev)

    cand = is_cand & leftmost & closed & cond_size & cond_freq & doc_freq_ok
    res = {"cand": cand, "emit": cand & lm, "s": s, "e": e, "L": Lv,
           "prev_same": prev}
    if need_ctx and windowed:
        # p - s and e - p are < cap: shifted selects replace two gathers
        # (open rows keep 0; they are never candidates)
        prev_ctx = torch.zeros(n, dtype=I32, device=dev)
        next_ctx = torch.zeros(n, dtype=I32, device=dev)
        for k in range(1, size_cap):
            prev_ctx = torch.where(s == p - k, _shifted(lcp, -k, 0),
                                   prev_ctx)
            next_ctx = torch.where(e == p + k, _shifted(lcp, k, 0),
                                   next_ctx)
        res["prev_ctx"], res["next_ctx"] = prev_ctx, next_ctx
    elif need_ctx:
        res["prev_ctx"] = lcp[torch.clamp(s, 0, n - 1)]
        res["next_ctx"] = lcp[torch.clamp(e, 0, n - 1)]
    return res
