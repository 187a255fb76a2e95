"""The benchmark's plain reference: the multi-MUM / multi-MEM match set of a
collection, worked out from its documents with plain PyTorch operations.

It imports nothing of the program under test. From the documents it builds
its own text (fwd $ revcomp $ per document, then the sentinels 1 and 0 that
the reference C++ appends, direct_gsacak.hpp:56-67), sorts the suffixes by
prefix doubling (torch.sort on one int64 key a round), takes every LCP from
the doubling's rank arrays by binary descent, and finds the LCP intervals by
size: an interval of c rows at row s has the value L = min(lcp[s+1..s+c-1])
and is one exactly when lcp[s] < L and lcp[s+c] < L. Only sizes that the
occurrence limits let through are looked at (c <= f * N, c <= F, c >= k).
Each interval is then held to the conditions that mumemto's mem_finder
(mem_finder.hpp:304-355) emits under, and written out as its write_mum or
write_mem would (:357-428, :210-263):

- L >= min_len; k <= c <= F; every document at most f times (f > 0), at
  least k distinct documents;
- left-maximal: the BWT characters of its rows are not all the same;
- an interval that reaches the last row of the suffix array is never
  closed by the reference's stack scan, so it is never emitted;
- MUM mode (f == 1): a '-' occurrence that crosses its document's final
  terminator drops the match; the first present document among 0..N-2 (or
  N-1) must be on '+'; a '-' offset is 2*len - pos - L - 1;
- MEM mode: occurrences in suffix-array order; the last one's '-' offset
  is 2*len - pos - L, without the -1 (the reference's quirk at :248).

The result is a list of tuples, one per match, in no particular order:
MUM mode (L, offsets, strands), offsets -1 and strand '' for an absent
document; MEM mode (L, positions, docs, strands) in suffix-array order.

`left_maximal=False` drops the BWT condition: that is the benchmark's
control, which breaks the guarantee that every match is maximal.
"""

from __future__ import annotations

import numpy as np
import torch

# seqtk's complement (the reference's ref_builder.cpp:29-38)
_COMP = np.arange(256, dtype=np.uint8)
for _a, _b in zip(b"ABCDGHKMNRSTUVWXY", b"TVGHCDMKNYSAABWXR"):
    _COMP[_a] = _b


def resolve_options(num_docs: int, k: int = 0, f: int = 1, F: int = 0):
    """(k, f, F) after the reference's set_parameters
    (pfp_mum.hpp:80-198): k <= 0 counts back from N, k is at least 2 and
    at most N; F < 0 counts back from N, F == 1 means no limit, and f > 0
    caps F at f * N."""
    if k < -num_docs or k == 1:
        k = 2
    elif k <= 0:
        k = num_docs + k
    elif k > num_docs:
        k = num_docs
    if F < -num_docs or F == 1:
        F = 0
    elif F < 0:
        F = num_docs + F
    if f > 0 and (F == 0 or F > f * num_docs):
        F = f * num_docs
    return k, f, F


def collection_text(docs):
    """(text, doc_starts, half_lens): fwd $ revcomp $ per document and the
    two sentinels; each document's first text position; fwd length + 1."""
    dollar = np.frombuffer(b"$", np.uint8)
    pieces = []
    for d in docs:
        d = np.asarray(d, np.uint8)
        pieces += [d, dollar, _COMP[d[::-1]], dollar]
    pieces.append(np.array([1, 0], np.uint8))
    half = np.array([len(d) + 1 for d in docs], np.int64)
    starts = np.concatenate([[0], np.cumsum(2 * half)[:-1]]).astype(np.int64)
    return np.concatenate(pieces), starts, half


def suffix_ranks(text: torch.Tensor):
    """(sa, levels): the suffix array of `text` (ending in a unique
    smallest byte) by prefix doubling, and levels[j], the class of each
    suffix's first 2^j characters (equal classes, equal prefixes), for
    every j below the round at which all classes came apart."""
    n = text.numel()
    dev = text.device
    rank = text.to(torch.int32)
    levels = []
    h = 1
    while True:
        levels.append(rank)
        second = torch.full((n,), -1, dtype=torch.int64, device=dev)
        second[:n - h] = rank[h:].to(torch.int64)
        key = rank.to(torch.int64) * (n + 1) + (second + 1)
        del second
        skey, sa = torch.sort(key)
        del key
        new = torch.ones(n, dtype=torch.int64, device=dev)
        new[1:] = (skey[1:] != skey[:-1]).to(torch.int64)
        del skey
        sorted_rank = torch.cumsum(new, 0) - 1
        del new
        rank = torch.empty(n, dtype=torch.int32, device=dev)
        rank[sa] = sorted_rank.to(torch.int32)
        distinct = int(sorted_rank[-1]) == n - 1
        del sorted_rank
        if distinct:
            return sa, levels
        h *= 2


def lcp_from_levels(sa: torch.Tensor, levels) -> torch.Tensor:
    """lcp[j] = the longest common prefix of suffixes sa[j-1] and sa[j]
    (lcp[0] = 0), by descent over the rank levels, longest first."""
    n = sa.numel()
    a, b = sa[:-1], sa[1:]
    got = torch.zeros(n - 1, dtype=torch.int64, device=sa.device)
    for j in range(len(levels) - 1, -1, -1):
        ia, ib = a + got, b + got
        inside = (ia < n) & (ib < n)
        lv = levels[j]
        same = inside & (lv[ia.clamp(max=n - 1)] == lv[ib.clamp(max=n - 1)])
        got += same.to(torch.int64) << j
    return torch.cat([torch.zeros(1, dtype=torch.int64, device=sa.device),
                      got])


def match_set(docs, min_len: int = 20, k: int = 0, f: int = 1, F: int = 0,
              device="cpu", left_maximal: bool = True) -> list:
    """The match set (module docstring) of `docs`, a list of uint8 arrays,
    with the reference's options -l min_len -k k -f f -F F, revcomp on."""
    device = torch.device(device)
    N = len(docs)
    k, f, F = resolve_options(N, k, f, F)
    if F <= 0:
        raise ValueError("the reference needs a bound on the interval size "
                         "(f > 0 or F > 0)")
    mum_mode = f == 1
    text_np, starts_np, half_np = collection_text(docs)
    text = torch.from_numpy(text_np).to(device)
    n = text.numel()
    sa, levels = suffix_ranks(text)
    lcp = lcp_from_levels(sa, levels)
    del levels
    # lcp past the last row: the stack scan never closes an interval there
    lcp_end = torch.cat([lcp, torch.full((1,), np.iinfo(np.int64).max,
                                         dtype=torch.int64, device=device)])
    ends = torch.from_numpy(starts_np + 2 * half_np).to(device)
    starts = torch.from_numpy(starts_np).to(device)
    half = torch.from_numpy(half_np).to(device)

    out = []
    lo = max(2, k)
    low = None  # min(lcp[s+1 .. s+c-1]) for s in [0, n - c]
    for c in range(2, F + 1):
        if low is None:
            low = lcp[1:].clone()
        else:
            low = torch.minimum(low[:-1], lcp[c - 1:])
        if c < lo:
            continue
        s = torch.nonzero((low >= min_len) & (lcp[:n - c + 1] < low)
                          & (lcp_end[c:] < low)).flatten()
        if s.numel() == 0:
            continue
        L = low[s]
        rows = s[:, None] + torch.arange(c, device=device)
        pos_t = sa[rows]
        doc = torch.searchsorted(ends, pos_t, right=True).clamp(max=N)
        count = torch.zeros(s.numel(), N + 1, dtype=torch.int64,
                            device=device)
        count.scatter_add_(1, doc, torch.ones_like(doc))
        keep = (count > 0).sum(dim=1) >= k
        if f > 0:
            keep &= count.max(dim=1).values <= f
        if left_maximal:
            bwt = text[(pos_t - 1) % n]
            keep &= (bwt != bwt[:, :1]).any(dim=1)
        docc = doc.clamp(max=N - 1)
        pos = pos_t - starts[docc]
        dl = half[docc]
        neg = pos >= dl
        if mum_mode:
            keep &= ~(neg & (pos + L[:, None] >= 2 * dl)).any(dim=1)
            tpos = torch.where(neg, 2 * dl - pos - L[:, None] - 1, pos)
            off = torch.full((s.numel(), N), -1, dtype=torch.int64,
                             device=device)
            strand = torch.zeros((s.numel(), N), dtype=torch.int64,
                                 device=device)
            off.scatter_(1, docc, tpos)
            strand.scatter_(1, docc, torch.where(neg, -1, 1))
            head = strand[:, :N - 1] if N > 1 else strand
            first = torch.where((head != 0).any(dim=1),
                                (head != 0).to(torch.int8).argmax(dim=1),
                                torch.full_like(L, N - 1))
            keep &= strand.gather(1, first[:, None])[:, 0] != -1
            sign = {1: "+", -1: "-", 0: ""}
            for ln, o, st in zip(L[keep].tolist(), off[keep].tolist(),
                                 strand[keep].tolist()):
                out.append((ln, tuple(o), tuple(sign[x] for x in st)))
        else:
            last = torch.arange(c, device=device) == c - 1
            tpos = torch.where(neg, 2 * dl - pos - L[:, None] - 1
                               + last.to(torch.int64), pos)
            for ln, p, d, ng in zip(L[keep].tolist(), tpos[keep].tolist(),
                                    doc[keep].tolist(), neg[keep].tolist()):
                out.append((ln, tuple(p), tuple(d),
                            tuple("-" if x else "+" for x in ng)))
    return out
