"""Suffix array and LCP construction by prefix doubling, in PyTorch.

Port of mumemto_tpu/ops/suffix.py (what the PFP path and the direct -g
backend run): O(log n) doubling rounds, each a stable sort of composite int64
(rank, rank-at-offset) keys; the per-round rank rows are kept as a "rank
history" from which the LCP array is computed exactly by rank descent.
All row arrays are int32; sort keys are int64.

Ties: the JAX package sorts with an unstable lax.sort and stops the
dictionary doubling at a depth cap, so the order of suffixes that share
more than 2^cap characters is implementation-defined there. The port
stops each dictionary suffix one character past its phrase separator
(_bounded_rounds), where its consumers stop reading; its order and LCPs
are exact up to that point.
"""

from __future__ import annotations

import math

import torch

from mumemto_tpu_torch import trace
from mumemto_tpu_torch.kernels import scan

I32 = torch.int32
I64 = torch.int64


def bucket(n: int, lo: int) -> int:
    """The least 0.75 or 1.0 multiple of a power of two >= max(n, lo), lo a
    power of two: the padded sizes of arrays (the JAX package's shapes)."""
    n = max(n, lo)
    p = 1 << (n - 1).bit_length()
    return p // 2 + p // 4 if p // 2 + p // 4 >= n else p


def route_set(target_idx: torch.Tensor, *values: torch.Tensor):
    """out_k[target_idx] = values_k, where target_idx is a permutation of
    0..n-1: one scatter per value."""
    n = target_idx.shape[0]
    outs = []
    for v in values:
        out = torch.empty(n, dtype=v.dtype, device=v.device)
        out[target_idx] = v
        outs.append(out)
    return outs[0] if len(outs) == 1 else tuple(outs)


def _num_levels(n: int) -> int:
    """Number of doubling rounds so that 2^rounds >= n."""
    return max(1, math.ceil(math.log2(max(n, 2))))


def _shift_static(r: torch.Tensor, k: int, n: int, fill: int) -> torch.Tensor:
    """r shifted left by k, filled past the end."""
    if k >= n:
        return torch.full((n,), fill, dtype=r.dtype, device=r.device)
    return torch.cat([r[k:], torch.full((k,), fill, dtype=r.dtype,
                                        device=r.device)])


def _codes(text: torch.Tensor, thresholds) -> torch.Tensor:
    """Order-preserving alphabet code #{t in thresholds : t < char}."""
    code = torch.zeros(text.shape[0], dtype=I32, device=text.device)
    for t in thresholds:
        code += (text > t).to(I32)
    return code


def _seed_packed8(text: torch.Tensor, n: int, alpha_thresholds):
    """3-bit alphabet-coded seed: exact 1/2/4/8-char rank rows from shifts
    (valid for <= 8 distinct byte values; a beyond-the-array slot codes
    as 0)."""
    code = _codes(text, alpha_thresholds)
    rank8 = code
    for j in range(1, 8):
        rank8 = (rank8 << 3) | _shift_static(code, j, n, 0)
    return code, rank8 >> 18, rank8 >> 12, rank8


def _round(rank: torch.Tensor, key2: torch.Tensor, n: int):
    """One doubling round: stable sort by (rank, key2), new dense ranks in
    text order, and whether every rank is now distinct. rank < 2^28 and
    -1 <= key2 < 2^28, so the composite key fits int64."""
    key = (rank.to(I64) << 32) | (key2.to(I64) + 1)
    skey, perm = torch.sort(key, stable=True)
    changed = torch.ones(n, dtype=I32, device=rank.device)
    changed[0] = 0
    changed[1:] = (skey[1:] != skey[:-1]).to(I32)
    new_rank_sorted = torch.cumsum(changed, 0, dtype=I32)
    return (route_set(perm, new_rank_sorted), perm.to(I32),
            new_rank_sorted[-1])


def _seed_history(text: torch.Tensor, n: int, L: int,
                  packed_init: bool = False,
                  alpha_thresholds: tuple | None = None):
    """The doubling's history (L + 1 rows of n) with its seed rows filled:
    (hist, start_lvl), the first round still to run; hist[start_lvl - 1]
    is the seed's rank. See _suffix_array_impl for the seeds."""
    rank0 = text.to(I32)
    hist = torch.zeros((L + 1, n), dtype=I32, device=text.device)
    if alpha_thresholds is not None and L >= 3:
        code, rank2, rank4, rank8 = _seed_packed8(text, n, alpha_thresholds)
        hist[0], hist[1], hist[2], hist[3] = code, rank2, rank4, rank8
        return hist, 4
    if packed_init:
        # chars stored as char+1 so a beyond-the-array slot packs as 0,
        # which sorts before every real char
        tp = rank0 + 1
        rank2 = (tp << 7) | _shift_static(tp, 1, n, 0)
        rank4 = (rank2 << 14) | _shift_static(rank2, 2, n, 0)
        hist[0], hist[1], hist[2] = rank0, rank2, rank4
        return hist, 3
    hist[0] = rank0
    return hist, 1


def _suffix_array_impl(text: torch.Tensor, n: int, packed_init: bool = False,
                       max_lvl: int | None = None,
                       alpha_thresholds: tuple | None = None):
    """Prefix-doubling SA; returns (sa, hist, filled_rows).

    packed_init (every element < 127) seeds the history with packed 1-, 2-
    and 4-char ranks; alpha_thresholds (<= 7 split points of a <= 8-letter
    alphabet) seeds exact 8-char ranks instead. max_lvl caps the doubling
    depth: the order is then exact up to 2^max_lvl-char prefixes, and all
    L+1 history rows are filled. Without a cap the loop stops as soon as
    every rank is distinct (one host check per round); history rows past
    `filled_rows` stay zero."""
    L = _num_levels(n)
    if max_lvl is not None:
        L = min(L, max_lvl)
    hist, lvl = _seed_history(text, n, L, packed_init, alpha_thresholds)
    rank = hist[lvl - 1]
    sa = torch.sort(rank, stable=True).indices.to(I32)
    while lvl <= L:
        key2 = _shift_static(rank, 1 << (lvl - 1), n, -1)
        rank, sa, last = _round(rank, key2, n)
        hist[lvl] = rank
        lvl += 1
        if max_lvl is None:
            trace.count(trace.READBACKS)
            if int(last) == n - 1:
                break
    return sa, hist, (L + 1 if max_lvl is not None else lvl)


def _first_of_runs(keys: torch.Tensor) -> torch.Tensor:
    """out[j]: the index of the first element of j's run of equal keys
    (keys sorted), int32."""
    m = keys.shape[0]
    j = torch.arange(m, dtype=I32, device=keys.device)
    new = torch.ones(m, dtype=torch.bool, device=keys.device)
    new[1:] = keys[1:] != keys[:-1]
    return scan.running_max(torch.where(new, j, 0))


def _compact(values: torch.Tensor, keep: torch.Tensor, k: int):
    """values[keep], in order, where the host knows k = keep.sum(): a
    scatter to the kept rows' places, so nothing is read back. A k that
    disagrees with keep stops the device (an asynchronous assert), where
    it would leave unwritten rows or write past the end."""
    at = torch.cumsum(keep, 0, dtype=I32) - 1
    if at.numel():
        torch._assert_async(at[-1] == k - 1)
    out = torch.empty(k + 1, dtype=values.dtype, device=values.device)
    out[torch.where(keep, at, k)] = values
    return out[:k]


def _bounded_rounds(hist: torch.Tensor, start_lvl: int, rem: torch.Tensor,
                    live: tuple):
    """The dictionary's depth-capped doubling, each round bounded by the
    phrase separators: from _seed_history's (hist, start_lvl), fills
    hist[start_lvl:] and returns sa.

    rem[p] is the number of characters from p to its phrase's separator
    (0 at a separator, the terminator and the zero pad). Round l sorts
    only the positions with rem + 1 >= 2^(l-1), live[l] of them, counted
    on the host (ops/pfp._dict_live), so no round reads anything back. A
    group of the 2^(l-1)-prefix order whose prefix holds its separator
    before its last character holds suffixes equal through the separator
    and one character past it; nothing that reads the index looks further
    (ops/pfp: _dict_groups, _build_slt), so the group keeps its rows in
    sa and its rank from then on. Groups are all live or all stopped:
    equal prefixes hold their separator at the same offset.

    A rank is the sa position of its group's first row, so the ranks of
    two groups never collide and a round touches only its own rows: the
    live rows, in position order, are stably sorted by (rank, rank
    2^(l-1) on), and each group's rows refill the group's own slots. Rows
    left tied are in position order, which is the suffix order of
    suffixes equal through their separators (the phrase after each
    separator decides, and the one the terminator follows is never tied):
    sa equals the unbounded rounds' outside the zero pad, whose order
    nothing reads.

    A history row keeps each rank as of the round its group stopped: for
    two suffixes that differ before their separators, equal ranks at level
    l mean equal 2^l prefixes, as without the bound; two equal through
    their separators read equal from their group's last round on, so the
    rank descent gives them an LCP above their separator."""
    n = hist.shape[1]
    skey, sa = torch.sort(hist[start_lvl - 1], stable=True)
    trace.count(trace.DICT_SORT_ROWS, n)
    sa = sa.to(I32)
    rank = route_set(sa, _first_of_runs(skey))
    del skey
    pos = torch.arange(n, dtype=I32, device=sa.device)
    for lvl in range(start_lvl, hist.shape[0]):
        half = 1 << (lvl - 1)
        k = int(live[lvl])
        pos = _compact(pos, rem[pos] >= half - 1, k)
        if k:
            _bounded_round(sa, rank, pos, half)
        hist[lvl] = rank
    return sa


def _bounded_round(sa: torch.Tensor, rank: torch.Tensor, pos: torch.Tensor,
                   half: int) -> None:
    """One round of _bounded_rounds over the live rows pos (every row of
    each group they touch, in position order): sa and rank updated in
    place. Its temporaries die with the call, so a round holds no more
    than the unbounded round it replaces."""
    # a live row's separator is at most rem chars on: pos + half stays
    # inside the text
    key = rank[pos].to(I64).bitwise_left_shift_(32)
    key.bitwise_or_(rank[pos + half])
    skey, perm = torch.sort(key, stable=True)
    del key
    trace.count(trace.DICT_SORT_ROWS, pos.shape[0])
    rows = pos[perm]
    del perm
    old = (skey >> 32).to(I32)
    first = _first_of_runs(old)
    j = torch.arange(pos.shape[0], dtype=I32, device=pos.device)
    sa[old + (j - first)] = rows
    del j
    rank[rows] = old + (_first_of_runs(skey) - first)


def _gather_pair(ranks, a, b, h, n):
    """(in-bounds mask, ranks[a+h], ranks[b+h]) with indices clamped."""
    ia = a + h
    ib = b + h
    inb = (ia < n) & (ib < n)
    ra = ranks[torch.clamp(ia, max=n - 1)]
    rb = ranks[torch.clamp(ib, max=n - 1)]
    return inb, ra, rb


def _lcp_impl(sa: torch.Tensor, hist: torch.Tensor, num_lvl: int, n: int,
              levels: int | None = None, text: torch.Tensor | None = None,
              bottom_thresholds: tuple | None = None,
              counter: str | None = None):
    """lcp[j] = LCP(suffix sa[j-1], suffix sa[j]); lcp[0] = 0, by exact
    rank descent over the history (two gathers per level).

    levels: number of computed rounds; descending from levels-1 skips the
    top levels that cannot match. bottom_thresholds (+ text), for <= 16
    distinct values: the last three levels (at most 7 remaining chars)
    collapse into one compare of packed 7-char 4-bit codes. counter, when
    given, counts the n pairs of each level (the packed bottom one)."""
    L = hist.shape[0] - 1
    top = L if levels is None else min(int(levels) - 1, L)
    a = torch.cat([sa[:1], sa[:-1]])
    b = sa
    h = torch.zeros(n, dtype=I32, device=sa.device)
    packed_bottom = bottom_thresholds is not None and top >= 3
    stop = 3 if packed_bottom else 0
    for lvl in range(top, stop - 1, -1):
        ranks = hist[min(lvl, num_lvl - 1)]
        inb, ra, rb = _gather_pair(ranks, a, b, h, n)
        h = torch.where(inb & (ra == rb), h + (1 << lvl), h)
    if counter:
        trace.count(counter, n * (max(top - stop + 1, 0) + packed_bottom))
    if packed_bottom:
        code = _codes(text, bottom_thresholds)
        pack = code << 24
        for j in range(1, 7):
            pack = pack | (_shift_static(code, j, n, 0) << (4 * (6 - j)))
        inb, wa, wb = _gather_pair(pack, a, b, h, n)
        nc = torch.zeros(n, dtype=I32, device=sa.device)
        for k in range(1, 8):  # top-k nibbles equal => common prefix >= k
            s = 28 - 4 * k
            nc += ((wa >> s) == (wb >> s)).to(I32)
        h = torch.where(inb, h + nc, h)
    h[0] = 0
    return h


def _lcp_plcp_impl(sa: torch.Tensor, hist: torch.Tensor, d: torch.Tensor,
                   n: int, levels: int, probe_thr: tuple, deep_cap: int,
                   probe_words: int = 2, num_lvl: int | None = None,
                   stats: dict | None = None, counter: str | None = None):
    """Adjacent-row LCP from a doubling history by the irreducible-LCP
    (PLCP) decomposition; returns (lcp, isa). Port of the JAX function of
    the same name (valid for <= 8-letter alphabets).

    Reducible positions (d[i] == d[phi[i+1]-1]) take plcp[i+1] + 1 by a
    reverse-cummin chain fill. Irreducible positions take a packed 9-char
    probe (probe_words=2: 18 chars); only those whose probe saturates take
    the rank descent. The JAX version sizes that descent by static buffer
    tiers chosen with lax.cond; here the deep rows are compacted with an
    exact-size nonzero, so one host branch remains: the compacted descent
    when n_deep <= deep_cap, else the full-width descent (same values).

    num_lvl: the filled-row count of an uncapped (early-exit) history,
    whose rows from num_lvl on are zeros; the descent then reads row
    min(lvl, num_lvl - 1), as _lcp_impl does. None (the depth-capped
    dictionary, every row filled) reads row min(lvl, L). stats, when given,
    receives n_deep, deep_cap and the branch taken; counter, when given,
    counts the descent's pairs, each level's and the packed probe's."""
    if probe_words not in (1, 2):
        raise ValueError(f"probe_words must be 1 or 2, got {probe_words}")
    L = hist.shape[0] - 1
    top = min(levels - 1, L)
    last_row = L if num_lvl is None else int(num_lvl) - 1
    dev = sa.device
    idx = torch.arange(n, dtype=I32, device=dev)

    code = _codes(d, probe_thr)
    q = code << 24
    for j in range(1, 9):
        q = q | (_shift_static(code, j, n, 0) << (3 * (8 - j)))
    prevc = torch.cat([torch.zeros(1, dtype=I32, device=dev), code[:-1]])
    pw = (prevc << 27) | q

    prev_sa = torch.cat([sa[:1], sa[:-1]])
    isa, phi = route_set(sa, idx, prev_sa)
    pwp = pw[phi]

    isa_n = _shift_static(isa, 1, n, 0)
    phi_n = _shift_static(phi, 1, n, 0)
    pwp_n = _shift_static(pwp, 1, n, 0)
    red = (isa_n > 0) & (phi_n >= 1) & (code == (pwp_n >> 27))
    irr = ~red

    mask9 = (1 << 27) - 1
    qj = pw & mask9
    qp = pwp & mask9
    c9 = torch.zeros(n, dtype=I32, device=dev)
    for k in range(1, 10):
        s = 27 - 3 * k
        c9 += ((qj >> s) == (qp >> s)).to(I32)
    if probe_words == 2:
        q2 = torch.zeros(n, dtype=I32, device=dev)
        for j in range(9, 18):
            q2 = q2 | (_shift_static(code, j, n, 0) << (3 * (17 - j)))
        q2p = q2[phi]
        c2 = torch.zeros(n, dtype=I32, device=dev)
        for k in range(1, 10):
            s = 27 - 3 * k
            c2 += ((q2 >> s) == (q2p >> s)).to(I32)
        probe = c9 + torch.where(c9 >= 9, c2, 0)
        probe_len = 18
    else:
        probe = c9
        probe_len = 9
    deep = irr & (probe >= probe_len) & (isa > 0)

    def descend(a, b, m: int):
        """Rank descent for pairs (a, b): levels top..3, then one packed
        9-char probe for the < 8-char residual."""
        if counter:
            trace.count(counter, m * (max(top - 2, 0) + 1))
        h = torch.zeros(m, dtype=I32, device=dev)
        for lvl in range(top, 2, -1):
            inb, ra, rb = _gather_pair(hist[min(lvl, last_row)], a, b, h, n)
            h = torch.where(inb & (ra == rb), h + (1 << lvl), h)
        inb, wa, wb = _gather_pair(pw, a, b, h, n)
        wa = wa & mask9
        wb = wb & mask9
        nc = torch.zeros(m, dtype=I32, device=dev)
        for k in range(1, 8):
            s = 27 - 3 * k
            nc += ((wa >> s) == (wb >> s)).to(I32)
        return torch.where(inb, h + nc, h)

    trace.count(trace.READBACKS)
    n_deep = int(deep.sum())
    if stats is not None:
        stats.update(n_deep=n_deep, deep_cap=deep_cap,
                     branch="full" if n_deep > deep_cap else "compacted")
    if n_deep > deep_cap:
        lcp = descend(prev_sa, sa, n)
        lcp[0] = 0
        return lcp, isa
    trace.count(trace.READBACKS)
    p = torch.nonzero(deep).flatten()
    plcp0 = probe.clone()
    plcp0[p] = descend(p.to(I32), phi[p], p.numel())
    plcp0 = torch.where(isa == 0, 0, plcp0)
    # chain fill: plcp[i] = plcp0[nx] + (nx - i) for the nearest
    # irreducible nx >= i (row n-1 is irreducible by construction)
    nx = scan.running_min(torch.where(irr, idx, n), reverse=True)
    plcp = plcp0[torch.clamp(nx, max=n - 1)] + (nx - idx)
    lcp = route_set(isa, plcp)
    lcp[0] = 0
    return lcp, isa


def canonicalize_pad_lcp(lcp: torch.Tensor, sa: torch.Tensor, total,
                         n: int) -> torch.Tensor:
    """Pin adjacent-pair LCPs of the zero-pad suffix class (both positions
    >= total-1) to the shared canonical value n - max(pair), so descent
    and PLCP results compare bit for bit; no consumer reads these rows."""
    prev_sa = torch.cat([sa[:1], sa[:-1]])
    both_pad = torch.minimum(prev_sa, sa) >= total - 1
    canon = n - torch.maximum(prev_sa, sa)
    out = torch.where(both_pad, canon, lcp)
    out[0] = 0
    return out


def suffix_lcp_arrays(text: torch.Tensor):
    """Full index of a zero-padded byte text: (sa, lcp, bwt) tensors on its
    device, by uncapped doubling with the packed seed and rank descent.
    bwt[j] = text[(sa[j] - 1) mod n] (direct_gsacak.hpp:64-67). The packed
    seed needs every char < 127 and >= 4 trailing zero-pad chars."""
    n = int(text.shape[0])
    if n:
        trace.count(trace.READBACKS)
        if int(text.max()) >= 127:
            raise ValueError("the packed SA seed needs every char < 127")
    sa, hist, num_lvl = _suffix_array_impl(text, n, packed_init=True)
    lcp = _lcp_impl(sa, hist, num_lvl, n, levels=num_lvl)
    return sa, lcp, bwt_of(text, sa)


def bwt_of(text: torch.Tensor, sa: torch.Tensor) -> torch.Tensor:
    """text[(sa - 1) mod n]: the char before each suffix, cyclically."""
    n = text.shape[0]
    return text[(sa.to(I64) + (n - 1)) % n]


def doc_array(sa: torch.Tensor, doc_ends: torch.Tensor,
              num_docs: int) -> torch.Tensor:
    """Doc id per SA row: the count of doc ends <= the position (sdsl rank
    semantics, ref_builder.cpp:183-190); pad and sentinel rows get
    num_docs."""
    da = torch.searchsorted(doc_ends.to(sa.dtype), sa, right=True)
    return torch.clamp(da, max=num_docs).to(I32)
