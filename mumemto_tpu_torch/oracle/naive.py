"""Trusted reference-semantics oracle (pure Python/numpy, test-only).

This is a literal, sequential transcription of the reference's match-finding
semantics, used as the golden oracle for the engine where the reference C++
is not built (its build fetches gsacak/sdsl over the network). Every rule is cited to the reference
source so equivalence can be audited line by line:

  * text layout + sentinels:  direct_gsacak.hpp:50-67 (text + {1,0})
  * per-row stream contract:  direct_gsacak.hpp:96-116
    (j, bwt[j], doc_ends_rank(sa[j]), sa[j], lcp[j])
  * LCP-interval stack:       mem_finder.hpp:304-355
  * emission conditions:      mem_finder.hpp:320-344
  * writers/coordinates:      mem_finder.hpp:210-263 (.mems), :357-428 (.mums)
  * merge thresholds:         mem_finder.hpp:104-157, 326-336

It is intentionally slow (pure Python stack machine); use only on small
inputs in tests.
"""

from __future__ import annotations

import numpy as np

from mumemto_tpu_torch import formats
from mumemto_tpu_torch.options import MatchOptions

MAX_THRESH = 65535  # mem_finder.hpp:299


def suffix_array_naive(text: np.ndarray) -> np.ndarray:
    """O(n^2 log n) suffix sort for tiny inputs (trusted baseline)."""
    b = bytes(text)
    return np.array(sorted(range(len(b)), key=lambda i: b[i:]), dtype=np.int64)


def suffix_array_doubling(text: np.ndarray) -> np.ndarray:
    """Prefix-doubling suffix array in numpy (O(n log^2 n))."""
    n = text.size
    rank = text.astype(np.int64)
    sa = np.argsort(rank, kind="stable")
    k = 1
    tmp = np.empty(n, dtype=np.int64)
    while True:
        key2 = np.full(n, -1, dtype=np.int64)
        key2[: n - k] = rank[k:]
        order = np.lexsort((key2, rank))
        r1 = rank[order]
        r2 = key2[order]
        changed = np.empty(n, dtype=np.int64)
        changed[0] = 0
        changed[1:] = (r1[1:] != r1[:-1]) | (r2[1:] != r2[:-1])
        tmp[order] = np.cumsum(changed)
        rank, tmp = tmp.copy(), tmp
        sa = order
        if rank[order[-1]] == n - 1:
            break
        k *= 2
    return sa.astype(np.int64)


def lcp_kasai(text: np.ndarray, sa: np.ndarray) -> np.ndarray:
    """LCP array (lcp[j] = lcp(suffix sa[j-1], suffix sa[j]), lcp[0]=0)."""
    n = text.size
    isa = np.empty(n, dtype=np.int64)
    isa[sa] = np.arange(n)
    lcp = np.zeros(n, dtype=np.int64)
    h = 0
    t = text
    for i in range(n):
        r = isa[i]
        if r > 0:
            j = sa[r - 1]
            while i + h < n and j + h < n and t[i + h] == t[j + h]:
                h += 1
            lcp[r] = h
            if h:
                h -= 1
        else:
            h = 0
    return lcp


class _StackFinder:
    """Literal transcription of mem_finder (include/mem_finder.hpp)."""

    def __init__(self, opts: MatchOptions, num_docs: int, seq_lengths):
        self.o = opts
        self.num_docs = num_docs
        self.doc_lens = list(seq_lengths)
        self.doc_offsets = [0] * num_docs
        s = 0
        for i in range(num_docs - 1):
            s += self.doc_lens[i]
            self.doc_offsets[i + 1] = s
        if opts.use_revcomp:
            self.doc_lens = [d // 2 for d in self.doc_lens]
        self.candidate_thresh = (
            np.zeros(self.doc_lens[0] * 2, dtype=np.int64) if opts.merge else None)
        self.mummode = opts.max_doc_freq == 1
        self.current_mems = [((0, 0), 0)]  # ((start, len), prev_lcp)
        self.mum_positions = []  # (first-genome offset, length)
        self.prev_lcp = 0
        self.last_bwt_change = 0
        self.buffer_start = 0
        self.sa_buffer = []
        self.bwt_buffer = []
        self.da_buffer = []
        self.out_lines = []       # bytes per emitted .mums/.mems line
        self.bum_lengths = []     # for bumbl
        self.bum_starts = []
        self.bum_strands = []

    # --- reference update() (mem_finder.hpp:161-170)
    def update(self, j, bwt_c, doc, sa_entry, lcp):
        self.update_mems(j, lcp)
        if len(self.bwt_buffer) == 0 or self.bwt_buffer[-1] != bwt_c:
            self.last_bwt_change = j
        self.update_buffers(j, bwt_c, sa_entry, lcp, doc)
        self.prev_lcp = lcp

    def check_bwt_range(self, start, end):
        return self.last_bwt_change <= start

    def check_doc_range(self, start, end):
        seen = {}
        unique = 0
        for i in range(start, end + 1):
            d = self.da_buffer[i - self.buffer_start]
            if d not in seen:
                unique += 1
                seen[d] = 1
            else:
                seen[d] += 1
                if self.o.max_doc_freq and seen[d] > self.o.max_doc_freq:
                    return False
        return unique >= self.o.num_distinct

    # --- update_mems (mem_finder.hpp:304-355)
    def update_mems(self, j, lcp):
        o = self.o
        start = j - 1
        while lcp < self.current_mems[-1][0][1]:
            interval, prev = self.current_mems.pop()
            if (interval[1] >= o.min_match_len
                    and j - interval[0] >= o.num_distinct
                    and (o.no_max_freq or j - interval[0] <= o.max_total_freq)
                    and self.check_doc_range(interval[0], j - 1)):
                if o.merge:
                    next_best = min(max(prev, lcp), MAX_THRESH)
                    for i in range(interval[0], j):
                        if self.da_buffer[i - self.buffer_start] == 0:
                            start_offset = (self.sa_buffer[i - self.buffer_start]
                                            - self.doc_offsets[0])
                            self.candidate_thresh[start_offset] = next_best
                            break
                if not self.check_bwt_range(interval[0], j - 1):
                    if self.mummode:
                        self.write_mum(interval[1], interval[0], j - 1)
                    else:
                        self.write_mem(interval[1], interval[0], j - 1)
            start = interval[0]
            self.prev_lcp = prev
        if lcp > self.current_mems[-1][0][1]:
            if lcp >= o.min_match_len:
                self.current_mems.append(((start, lcp), self.prev_lcp))

    # --- write_mum (mem_finder.hpp:357-428)
    def write_mum(self, length, start, end):
        o = self.o
        nd = self.num_docs
        offsets = [-1] * nd
        strand = [0] * nd
        for i in range(start, end + 1):
            curdoc = self.da_buffer[i - self.buffer_start]
            curpos = self.sa_buffer[i - self.buffer_start] - self.doc_offsets[curdoc]
            if o.use_revcomp and curpos >= self.doc_lens[curdoc]:
                curstrand = "-"
                if curpos + length >= 2 * self.doc_lens[curdoc]:
                    return 0
                curpos = 2 * self.doc_lens[curdoc] - curpos - length - 1
            else:
                curstrand = "+"
            offsets[curdoc] = curpos
            strand[curdoc] = curstrand
        # canonicalization: first present genome must be '+' (:383-391)
        i = 0
        while i < nd - 1:
            if strand[i] != 0:
                break
            i += 1
        if strand[i] == "-":
            return 0
        if o.merge:
            self.mum_positions.append((offsets[0], length))
        if o.binary:
            self.bum_lengths.append(length)
            self.bum_starts.append(list(offsets))
            self.bum_strands.append([s == "+" for s in strand])
        else:
            self.out_lines.append(formats.format_mum_line(
                length, offsets, ["+" if s == "+" else "-" for s in strand]))
        return 1

    # --- write_mem (mem_finder.hpp:210-263); note the last element's '-'
    # transform deliberately omits the -1 (reference quirk, :248)
    def write_mem(self, length, start, end):
        o = self.o
        positions, docs, strands = [], [], []
        for i in range(start, end + 1):
            curdoc = self.da_buffer[i - self.buffer_start]
            curpos = self.sa_buffer[i - self.buffer_start] - self.doc_offsets[curdoc]
            if o.use_revcomp and curpos >= self.doc_lens[curdoc]:
                curstrand = "-"
                if i < end:
                    curpos = 2 * self.doc_lens[curdoc] - curpos - length - 1
                else:
                    curpos = 2 * self.doc_lens[curdoc] - curpos - length
            else:
                curstrand = "+"
            positions.append(curpos)
            docs.append(curdoc)
            strands.append(curstrand)
        self.out_lines.append(formats.format_mem_line(length, positions, docs, strands))
        return 1

    # --- update_buffers (mem_finder.hpp:430-449)
    def update_buffers(self, j, bwt_c, sa_pos, lcp, docid):
        if len(self.current_mems) <= 1:
            if self.sa_buffer:
                self.sa_buffer.clear()
                self.bwt_buffer.clear()
                self.da_buffer.clear()
            self.buffer_start = j
        elif self.current_mems[1][0][0] > self.buffer_start:
            to_remove = self.current_mems[1][0][0] - self.buffer_start
            self.buffer_start = self.current_mems[1][0][0]
            del self.sa_buffer[:to_remove]
            del self.bwt_buffer[:to_remove]
            del self.da_buffer[:to_remove]
        self.bwt_buffer.append(bwt_c)
        self.sa_buffer.append(sa_pos)
        self.da_buffer.append(docid)

    # --- close-time merge metadata (mem_finder.hpp:104-157)
    def thresh_arrays(self):
        dl0 = self.doc_lens[0]
        total = sum(l + 1 for _, l in self.mum_positions)
        fwd = np.zeros(total, dtype=np.uint16)
        rev = np.zeros(total, dtype=np.uint16)
        offset = 0
        for pos, length in sorted(self.mum_positions, key=lambda t: t[0]):
            revpos = 2 * dl0 - pos - length - 1
            for jj in range(length):
                if self.candidate_thresh[pos + jj] < length - jj:
                    fwd[offset] = self.candidate_thresh[pos + jj]
                if self.candidate_thresh[revpos + jj] < length - jj:
                    rev[offset] = self.candidate_thresh[revpos + jj]
                offset += 1
            offset += 1  # separator slot, stays 0
        return fwd, rev


def build_arrays(rb, naive_sa: bool = False):
    """SA/LCP/BWT/DA over the gsacak-path text (text + {1,0} sentinels,
    direct_gsacak.hpp:56-67)."""
    text = np.concatenate([rb.text, np.array([1, 0], dtype=np.uint8)])
    sa = suffix_array_naive(text) if naive_sa else suffix_array_doubling(text)
    lcp = lcp_kasai(text, sa)
    bwt = text[(sa + text.size - 1) % text.size]
    da = rb.doc_array(sa)
    return text, sa, lcp, bwt, da


def run_finder(rb, opts: MatchOptions, naive_sa: bool = False) -> _StackFinder:
    """Run the full oracle pipeline; returns the finished finder."""
    text, sa, lcp, bwt, da = build_arrays(rb, naive_sa=naive_sa)
    finder = _StackFinder(opts, rb.num_docs, rb.seq_lengths)
    for j in range(text.size):
        finder.update(j, int(bwt[j]), int(da[j]), int(sa[j]), int(lcp[j]))
    return finder


def oracle_output(rb, opts: MatchOptions, naive_sa: bool = False) -> bytes:
    """The byte content of the .mums (or .mems) file the reference would write."""
    finder = run_finder(rb, opts, naive_sa=naive_sa)
    return b"".join(finder.out_lines)
