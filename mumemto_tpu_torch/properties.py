"""Oracle-free property checks of the port's match results.

A copy of mumemto_tpu/properties.py with `_doc_metadata` taken from the
port's engine. Each match is checked against the raw collection text
only: exact occurrence, uniqueness (MUMs) or completeness and the k/f/F
filters (MEMs), and both-side maximality.
"""

from __future__ import annotations

import numpy as np

from mumemto_tpu_torch.engine import _doc_metadata


def _count_occurrences(hay: bytes, needle: bytes) -> int:
    count = 0
    start = 0
    while True:
        p = hay.find(needle, start)
        if p < 0:
            return count
        count += 1
        start = p + 1


def mum_text_positions(lengths, offsets, strands, doc_offsets, doc_lens):
    """Invert the writer's strand transform (mem_finder.hpp:370-375):
    '-' slots store 2*dl - pos - L - 1, so pos = 2*dl - off - L - 1.
    Returns (m, N) positions into the concatenated text (-1 where absent).
    """
    L = np.asarray(lengths, dtype=np.int64)[:, None]
    off = np.asarray(offsets, dtype=np.int64)
    st = np.asarray(strands)
    dl = np.asarray(doc_lens, dtype=np.int64)[None, :]
    pos = np.where(st < 0, 2 * dl - off - L - 1, off)
    out = np.asarray(doc_offsets, dtype=np.int64)[None, :] + pos
    return np.where(off < 0, -1, out)


def _check_maximality(text: np.ndarray, positions, L: int, label: str):
    """Not all previous chars equal AND not all next chars equal. Positions
    at the text edges count as unique sentinels (nothing to extend into)."""
    n = text.size
    ps = np.asarray(positions, dtype=np.int64)
    prev = np.where(ps > 0, text[np.maximum(ps - 1, 0)].astype(np.int64),
                    -1 - np.arange(ps.size))
    nxt_idx = ps + L
    nxt = np.where(nxt_idx < n,
                   text[np.minimum(nxt_idx, n - 1)].astype(np.int64),
                   -1 - np.arange(ps.size))
    assert len(np.unique(prev)) > 1, \
        f"{label}: not left-maximal (all preceded by {prev[0]})"
    assert len(np.unique(nxt)) > 1, \
        f"{label}: not right-maximal (all followed by {nxt[0]})"



def check_mum_properties(results, rb, max_checked: int | None = None,
                         progress=None) -> int:
    """Raise AssertionError on any property violation; returns #checked."""
    text = rb.text
    tbytes = bytes(text)
    doc_offsets, doc_lens = _doc_metadata(rb, results.opts)
    m = results.num_matches
    idx = np.arange(m)
    if max_checked is not None and m > max_checked:
        idx = np.linspace(0, m - 1, max_checked).astype(np.int64)
    tp = mum_text_positions(results.lengths, results.offsets,
                            results.strands, doc_offsets, doc_lens)
    # per-doc fwd$rc slices for the uniqueness scan
    doc_spans = [(int(doc_offsets[d]),
                  int(doc_offsets[d]) + int(rb.seq_lengths[d]))
                 for d in range(rb.num_docs)]
    for c, i in enumerate(idx.tolist()):
        L = int(results.lengths[i])
        ps = tp[i][results.offsets[i] >= 0]
        subs = {tbytes[int(p):int(p) + L] for p in ps.tolist()}
        assert len(subs) == 1, f"MUM {i}: occurrence substrings differ"
        needle = next(iter(subs))
        assert len(needle) == L, f"MUM {i}: occurrence out of bounds"
        for d, (a, b) in enumerate(doc_spans):
            cnt = _count_occurrences(tbytes[a:b], needle)
            # partial MUMs (k < N): absent docs must have ZERO occurrences
            want = 1 if int(results.offsets[i][d]) >= 0 else 0
            assert cnt == want, \
                f"MUM {i}: occurs {cnt}x in doc {d} (want {want})"
        _check_maximality(text, ps, L, f"MUM {i}")
        if progress is not None:
            progress(c + 1, len(idx))
    return len(idx)


def check_mem_properties(results, rb, max_checked: int | None = None) -> int:
    """MEM-mode property pass over results.mem_records."""
    opts = results.opts
    text = rb.text
    tbytes = bytes(text)
    doc_offsets, doc_lens = _doc_metadata(rb, opts)
    recs = results.mem_records
    idx = range(len(recs))
    if max_checked is not None and len(recs) > max_checked:
        idx = np.linspace(0, len(recs) - 1, max_checked).astype(np.int64)
    for i in idx:
        L, tpos, docs_arr, fwd = recs[int(i)]
        L = int(L)
        nv = len(tpos)
        # invert the writer transform incl. the last-occurrence '-' quirk
        # (tpos = 2*dl - pos - L - 1 + is_last, mem_finder.hpp:248)
        ps = []
        for j in range(nv):
            d = int(docs_arr[j])
            dl = int(doc_lens[d])
            if fwd[j]:
                pos = int(tpos[j])
            else:
                pos = 2 * dl - int(tpos[j]) - L - 1 + (1 if j == nv - 1 else 0)
            ps.append(int(doc_offsets[d]) + pos)
        subs = {tbytes[p:p + L] for p in ps}
        assert len(subs) == 1, f"MEM {i}: occurrence substrings differ"
        needle = next(iter(subs))
        assert len(needle) == L, f"MEM {i}: occurrence out of bounds"
        total = _count_occurrences(tbytes, needle)
        assert total == nv, \
            f"MEM {i}: record lists {nv} occurrences, text has {total}"
        counts = np.bincount(np.asarray(docs_arr, dtype=np.int64),
                             minlength=rb.num_docs)
        if opts.max_doc_freq > 0:
            assert counts.max() <= opts.max_doc_freq, \
                f"MEM {i}: per-doc freq {counts.max()} > f={opts.max_doc_freq}"
        if opts.max_total_freq > 0:
            assert nv <= opts.max_total_freq, \
                f"MEM {i}: total freq {nv} > F={opts.max_total_freq}"
        assert (counts > 0).sum() >= opts.num_distinct, \
            f"MEM {i}: {int((counts > 0).sum())} distinct docs < " \
            f"k={opts.num_distinct}"
        assert L >= opts.min_match_len
        _check_maximality(text, np.asarray(ps), L, f"MEM {i}")
    return len(list(idx))
