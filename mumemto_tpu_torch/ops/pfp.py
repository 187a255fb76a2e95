"""Prefix-free parsing pipeline: text -> PFP -> SA-row stream, in PyTorch.

Port of the main path of mumemto_tpu/ops/pfp.py (see its module docstring
for the algorithm):

  1. parse      Karp-Rabin window-hash breaks (the CUDA kernel
                kernels/kr_mask.py on the card), compacted with nonzero.
  2. dictionary unique phrases ranked on the device (sort_phrases:
                fingerprint dedupe, 7-byte MSD rounds, kernels/phrases.py).
  3. dict index D materialized on the device, prefix doubling bounded
                by the phrase separators, PLCP or rank-descent LCP,
                suffix groups.
  4. parse side parse SA + LCP + ISA, s_lcp_T and its range-min table.
  5. expansion  one row per text position, stably sorted by
                (group id, parse ISA) into SA order; per-row LCP from the
                PFP tables, then the interval analysis.

write_parse_files and pfp_from_parse_files save and reload a parse as
.dict/.parse files (-P, -p).

Pad rows get sort key -1 so they land at the front of the row stream with
LCP 0 and doc id num_docs. Row arrays are int32 (nr-scale); sort keys and
the s_lcp_T character sums are int64. Out-of-range scatter targets that
the JAX code drops by default are masked here explicitly.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from mumemto_tpu_torch import trace
from mumemto_tpu_torch.kernels import alphabet, kr_mask, phrases, scan
from mumemto_tpu_torch.ops import intervals as ops_intervals
from mumemto_tpu_torch.ops import suffix as ops_suffix
from mumemto_tpu_torch.ops.suffix import I32, I64

DOLLAR_PFP = 2   # artificial phrase decoration char (common.hpp:54)
SEP = 1          # EndOfWord (dict phrase separator)
TERM = 0         # EndOfDict / parse terminator

# canonical no-N DNA text alphabet incl. the PFP decoration chars
CANON_ALPHA = (0, 1, 2, 36, 65, 67, 71, 84)


# one device's row arrays are int32: a scan on one device takes row buckets
# below 2^31, the block scan (parallel/widepfp.py) any
ROW_LIMIT = 2**31


# _rmq_query's level-major flat copy of a sparse table is indexed in int32:
# a table of this many entries (levels x n) or more is read level by level
RMQ_FLAT_LIMIT = 2**31
# device bytes the range-min allocates in a call: each sparse table's
# levels above level 0, and each flat copy a query makes
RMQ_BYTES = "pfp.rmq.bytes"


class ScanSizeError(ValueError):
    """A collection past what a scan takes: a row space past one device's
    int32 row arrays, or a text past the int32 phrase coordinates. The CLI
    answers it as it answers a device out-of-memory error: the partition
    fallback where that reproduces the run, else a clean error."""


# ---------------------------------------------------------------------------
# 1. parse
# ---------------------------------------------------------------------------

def _compact_breaks(mask: torch.Tensor) -> torch.Tensor:
    """Indices of mask=True, ascending."""
    trace.count(trace.READBACKS)  # nonzero reads its size back
    return torch.nonzero(mask).flatten()


def compute_breaks(ext: torch.Tensor, n_text: int, w: int, mod: int
                   ) -> torch.Tensor:
    """Break positions (window-end chars) in TEXT coords, as int32 on ext's
    device."""
    mask, count = kr_mask.break_mask(ext, n_text, w, mod)
    trace.count(trace.READBACKS)
    if int(count) == 0:
        return torch.zeros(0, dtype=I32, device=ext.device)
    return _compact_breaks(mask).to(I32) - 1  # ext coord -> text coord


# ---------------------------------------------------------------------------
# 2. dictionary
# ---------------------------------------------------------------------------

def phrase_records(breaks: torch.Tensor, n_text: int, w: int):
    """(st, ln): each phrase record's start in ext coords and its length,
    int32 on the breaks' device. Record i runs from the window of break
    i - 1 (from 0 for the first) through break i (through the w trailing
    decoration chars for the last), so records overlap by w chars."""
    m = breaks.numel() + 1
    st = torch.zeros(m, dtype=I32, device=breaks.device)
    en = torch.full((m,), n_text + w, dtype=I32, device=breaks.device)
    st[1:] = breaks - w + 2
    en[:-1] = breaks + 1
    return st, en - st + 1


# rounds of 7-byte keys before the groups still tied go to the tail kernel
SORT_ROUNDS = 16
# trace counters: refinement rounds and failed fingerprint checks of a call
SORT_ROUNDS_COUNTER = "pfp.sort.rounds"
SORT_COLLISIONS = "pfp.sort.collisions"
_KEY_BYTES = 7


def sort_phrases(ext: torch.Tensor, st: torch.Tensor, ln: torch.Tensor):
    """Rank the phrase records ext[st[r] : st[r] + ln[r]] (int32 st and ln
    on ext's device) in unsigned-byte lexicographic order, a proper prefix
    first, on ext's device: the kernels of kernels/phrases on a CUDA
    tensor, their plain versions on a CPU tensor. Returns numpy int32
    (parse, phrase_st, phrase_ln): parse[r] the 1-based rank of record r's
    phrase; phrase_st / phrase_ln (index 0 unused) the start and length of
    each phrase's smallest record.

    1. Dedupe: records sorted by (fingerprint, length), stably, so each
       run's head is its smallest record; every record is checked byte for
       byte against its head. If any check fails (a fingerprint
       collision), every record is ranked in step 2 instead of the heads.
    2. Refine (MSD): each still-tied record's next 7 bytes, big-endian,
       zero past its end, and min(remaining, 8) make one key that orders
       as memcmp-then-shorter; a round sorts (bucket, key), where a
       record's bucket is the final position of its group's first member,
       splits the groups and drops the resolved ones (a group of one, or
       one whose members all ended: equal). After SORT_ROUNDS rounds the
       groups still tied are ranked by the tail kernel.
    3. Scatter the dense ranks to every record; one readback."""
    m = st.numel()
    dev = ext.device
    idx = torch.arange(m, dtype=I32, device=dev)
    order, run_start, head = fingerprint_runs(
        phrases.fingerprint(ext, st, ln), ln)
    bad = phrases.verify(ext, st, ln, order, head)
    trace.count(trace.READBACKS)
    collisions = int(bad)
    trace.count(SORT_COLLISIONS, collisions)
    if collisions:
        order = run_id = rec = idx  # rank every record
    else:
        run_id = torch.cumsum(run_start, 0, dtype=I32) - 1
        trace.count(trace.READBACKS)  # the mask index reads its size back
        rec = order[run_start]
    bucket = _refine(ext, st, ln, rec)
    # dense ranks (equal records share a bucket only after a collision)
    h = rec.numel()
    seen = torch.zeros(h, dtype=I32, device=dev)
    seen[bucket] = 1
    dense = torch.cumsum(seen, 0, dtype=I32) - 1
    grp = dense[bucket]
    rep = torch.full((h,), m, dtype=I32, device=dev)
    rep.scatter_reduce_(0, grp.to(I64), rec, reduce="amin")
    rep = torch.clamp(rep, max=m - 1)
    parse = torch.empty(m, dtype=I32, device=dev)
    parse[order] = grp[run_id] + 1
    zero = parse.new_zeros(1)
    trace.count(trace.READBACKS)
    out = torch.cat([dense[-1:] + 1, parse, zero, st[rep], zero, ln[rep]]
                    ).cpu().numpy()
    num_phrases = int(out[0])
    parse_np = out[1:m + 1]
    phrase_st = out[m + 1:m + 2 + num_phrases]
    phrase_ln = out[m + h + 2:m + h + 3 + num_phrases]
    return parse_np, phrase_st, phrase_ln


def fingerprint_runs(fp: torch.Tensor, ln: torch.Tensor):
    """The records sorted by (fingerprint, length), stably, so that equal
    pairs keep their index order: (order, run_start, head), int32 order,
    run_start True at the first record of each run of equal pairs, and
    head[i] the first record of sorted record i's run (its smallest)."""
    by_ln = torch.argsort(ln, stable=True)
    order = by_ln[torch.argsort(fp[by_ln], stable=True)]
    sfp, sln = fp[order], ln[order]
    run_start = torch.ones(order.numel(), dtype=torch.bool, device=fp.device)
    run_start[1:] = (sfp[1:] != sfp[:-1]) | (sln[1:] != sln[:-1])
    order = order.to(I32)
    idx = torch.arange(order.numel(), dtype=I32, device=fp.device)
    return order, run_start, order[scan.running_max(
        torch.where(run_start, idx, -1))]


def _round_keys(ext, st, ln, rec, d: int) -> torch.Tensor:
    """Each record's key at depth d: bytes d .. d + 6 big-endian (zero past
    its end) above 4 bits of min(ln - d, 8)."""
    start = st[rec].to(I64) + d
    left = ln[rec].to(I64) - d
    j = torch.arange(_KEY_BYTES, dtype=I64, device=ext.device)
    at = torch.clamp(start[:, None] + j, max=ext.numel() - 1)
    b = torch.where(j < left[:, None], ext[at].to(I64), 0)
    shift = 8 * (_KEY_BYTES - 1 - j) + 4
    return (b << shift).sum(1) | torch.clamp(left, max=_KEY_BYTES + 1)


def _refine(ext, st, ln, rec) -> torch.Tensor:
    """bucket[s]: the final position of the first member of record rec[s]'s
    group among the records rec, ranked by their bytes (step 2 of
    sort_phrases); equal records share it."""
    dev = ext.device
    h = rec.numel()
    bucket = torch.zeros(h, dtype=I32, device=dev)
    active = torch.arange(h if h > 1 else 0, dtype=I32, device=dev)
    rounds = 0
    while active.numel() and rounds < SORT_ROUNDS:
        key = _round_keys(ext, st, ln, rec[active], _KEY_BYTES * rounds)
        perm = torch.argsort(key, stable=True)
        if rounds:  # the groups of the rounds before
            perm = perm[torch.argsort(bucket[active[perm]], stable=True)]
        active, key = active[perm], key[perm]
        grp = bucket[active]
        i = torch.arange(active.numel(), dtype=I32, device=dev)
        new_grp = torch.ones(active.numel(), dtype=torch.bool, device=dev)
        new_grp[1:] = grp[1:] != grp[:-1]
        new_sub = new_grp.clone()
        new_sub[1:] |= key[1:] != key[:-1]
        bucket[active] = grp + (scan.running_max(torch.where(new_sub, i, -1))
                                - scan.running_max(torch.where(new_grp, i, -1)))
        alone = new_sub.clone()
        alone[:-1] &= new_sub[1:]
        tied = ~alone & ((key & 15) > _KEY_BYTES)
        trace.count(trace.READBACKS)  # the mask index reads its size back
        active = active[tied]
        rounds += 1
    trace.count(SORT_ROUNDS_COUNTER, rounds)
    if active.numel():
        grp = bucket[active]
        first = torch.ones(active.numel(), dtype=torch.bool, device=dev)
        first[1:] = grp[1:] != grp[:-1]
        trace.count(trace.READBACKS)
        starts = torch.cat([torch.nonzero(first).flatten().to(I32),
                            torch.full((1,), active.numel(), dtype=I32,
                                       device=dev)])
        phrases.tail_rank(ext, st, ln, rec, active, starts,
                          _KEY_BYTES * rounds, bucket)
    return bucket


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _segmented_min_after_valid(lcp: torch.Tensor,
                               valid: torch.Tensor) -> torch.Tensor:
    """out[i] = min(lcp[j]) over j in (prev_valid_row(i), i] for lcp >= 0:
    a running min that restarts after each valid row, as one running max
    of (valid rows before i) << 32 | (INT32_MAX - lcp[i]). No atomics: a
    scatter-min into each segment's slot took 1.5 s instead of 0.03 in
    some calls on an H100 once the dictionary's zero pad (32 M rows of
    one segment) came in another order."""
    key = torch.zeros(lcp.shape[0], dtype=I64, device=lcp.device)
    torch.cumsum(valid[:-1], 0, out=key[1:])
    key.bitwise_left_shift_(32).bitwise_or_(ops_intervals.INT32_MAX - lcp)
    run = scan.running_max(key)
    del key
    low = run.bitwise_and_(ops_intervals.INT32_MAX).to(I32)
    return low.neg_().add_(ops_intervals.INT32_MAX)


def _min_table(values: torch.Tensor) -> list:
    """The sparse min table of `values` (ops/intervals) that _rmq_query
    reads; the levels it adds above `values` are counted in RMQ_BYTES."""
    with trace.span("pfp.rmq"):
        table = ops_intervals._sparse_min_table(values)
        trace.count(RMQ_BYTES, sum(
            t.numel() * t.element_size()
            for prev, t in zip(table, table[1:]) if t is not prev))
    return table


def _rmq_query(table: list, lo: torch.Tensor, hi: torch.Tensor):
    """min(values[lo..hi]) inclusive, O(1): the two power-of-two windows
    of the sparse table that cover the range. Below RMQ_FLAT_LIMIT table
    entries, two gathers into the level-major flat copy of the table; at
    or past it, two gathers per level, each query keeping its own level's
    (torch.where): no copy of the table, and no index past n."""
    with trace.span("pfp.rmq"):
        n = table[0].shape[0]
        L1 = len(table)
        length = torch.clamp(hi - lo + 1, min=1)
        # exact floor(log2): frexp of an int32 held in float64 is exact
        lvl = (torch.frexp(length.to(torch.float64)).exponent - 1).to(I32)
        lvl = torch.clamp(lvl, 0, L1 - 1)
        width = torch.ones_like(lvl) << lvl
        if n * L1 >= RMQ_FLAT_LIMIT:
            ia = torch.clamp(lo, 0, n - 1)
            ib = torch.clamp(hi - width + 1, 0, n - 1)
            out = torch.minimum(table[0][ia], table[0][ib])
            for k in range(1, L1):
                out = torch.where(lvl == k, torch.minimum(
                    table[k][ia], table[k][ib]), out)
            return out
        flat = torch.cat(list(table))
        trace.count(RMQ_BYTES, flat.numel() * flat.element_size())
        base = lvl * n
        ia = base + torch.clamp(lo, 0, n - 1)
        ib = base + torch.clamp(hi - width + 1, 0, n - 1)
        return torch.minimum(flat[ia], flat[ib])


def _fill_per_occ(values: torch.Tensor, starts_idx: torch.Tensor, nr: int):
    """row_value[r] = values[j] for rows r of occurrence j: scatter-add the
    first differences at the occurrence start rows, then one cumsum.
    Start indices >= nr (pad slots) are dropped."""
    delta = torch.cat([values[:1], values[1:] - values[:-1]]).to(I32)
    keep = starts_idx < nr
    acc = torch.zeros(nr, dtype=I32, device=values.device)
    trace.count(trace.READBACKS, 2)  # each mask index reads its size back
    acc.index_add_(0, starts_idx[keep], delta[keep])
    return torch.cumsum(acc, 0, dtype=I32)


# ---------------------------------------------------------------------------
# main pipeline
# ---------------------------------------------------------------------------

@dataclass
class PFPData:
    """Host-side metadata + the device ext array for one parsed collection."""
    w: int
    n_text: int
    m: int                 # number of parse entries
    num_phrases: int       # unique phrases
    d_len: int             # dictionary string length
    ext: torch.Tensor      # [2] + text + [2]*w + zero pad (uint8, device)
    parse: np.ndarray      # phrase ids (1-based), length m
    phrase_st: np.ndarray  # ext start per unique phrase id (index 0 unused)
    phrase_ln: np.ndarray  # char length per unique phrase id
    alpha: tuple           # sorted distinct byte values present in ext


def seed_thresholds(alpha):
    """(seed_thr, lcp_thr) split points for a sorted distinct byte list:
    the 8-char 3-bit SA seed needs <= 8 values, the packed 7-char LCP
    bottom <= 16."""
    alpha = sorted(alpha)
    if set(alpha) <= set(CANON_ALPHA):
        seed_thr = CANON_ALPHA[:-1]
    elif len(alpha) <= 8:
        seed_thr = tuple(alpha[:-1])
    else:
        seed_thr = None
    lcp_thr = tuple(alpha[:-1]) if len(alpha) <= 16 else None
    if seed_thr is not None and lcp_thr is not None:
        lcp_thr = seed_thr
    return seed_thr, lcp_thr


def _alphabet(data) -> tuple:
    """Sorted distinct byte values of data, the span pfp.alphabet: of a
    1-D uint8 tensor on its device (kernels/alphabet.byte_presence, the
    kernel on a card), read back once; of a numpy array on the host
    (the plain twin), with no readback."""
    with trace.span("pfp.alphabet"):
        if isinstance(data, np.ndarray):
            flags = alphabet.byte_presence_plain(data)
        else:
            trace.count(trace.READBACKS)
            flags = alphabet.byte_presence(data).cpu()
        return tuple(np.flatnonzero(flags.numpy()).tolist())


def build_pfp(text_np: np.ndarray, device: torch.device, w: int = 10,
              mod: int = 100) -> PFPData:
    """Parse the collection text: upload ext, its alphabet, KR breaks, the
    phrase records and their lexicographic ranks on the device
    (sort_phrases). Phrase coordinates are int32, so ext ([2] + text +
    [2]*w) must stay below 2^31 bytes: a longer text raises ScanSizeError
    before anything is copied. Its parts are the spans pfp.build.text
    (ext allocated at its bucket size on the device, its sentinels and
    zero pad filled there, the text copied in once), pfp.alphabet,
    pfp.build.breaks, pfp.build.records and pfp.build.sort."""
    n_text = int(text_np.size)
    if n_text + w + 1 >= 2**31:
        raise ScanSizeError(
            f"a text of {n_text} characters does not fit the int32 phrase "
            f"coordinates (at most 2^31 - {w + 2} with w = {w}); partition "
            "the collection (MumemtoM)")
    with trace.span("pfp.build.text"):
        end = 1 + n_text + w
        ext = torch.empty(ops_suffix.bucket(end, lo=1024), dtype=torch.uint8,
                          device=device)
        ext[:1].fill_(DOLLAR_PFP)
        ext[1 + n_text:end].fill_(DOLLAR_PFP)
        ext[end:].zero_()
        ext[1:1 + n_text].copy_(torch.from_numpy(text_np))
    alpha = _alphabet(ext[:end])

    with trace.span("pfp.build.breaks"):
        breaks = compute_breaks(ext, n_text, w, mod)
    with trace.span("pfp.build.records"):
        st, ln = phrase_records(breaks, n_text, w)
    with trace.span("pfp.build.sort"):
        parse, phrase_st, phrase_ln = sort_phrases(ext, st, ln)
    num_phrases = phrase_st.size - 1
    return PFPData(w=w, n_text=n_text, m=parse.size, num_phrases=num_phrases,
                   d_len=int(phrase_ln.sum()) + num_phrases + 1,
                   ext=ext, parse=parse, phrase_st=phrase_st,
                   phrase_ln=phrase_ln, alpha=alpha)


def _dict_setup(ext, phrase_st, phrase_ln, d_starts, npz: int, total: int,
                nd: int, ne: int):
    """(d, meta, rem): D = concat(sorted phrases + SEP) + TERM, zero-padded
    to nd; the per-position proper-suffix length (-1 outside proper phrase
    suffixes); and each position's remaining length, the characters before
    its phrase's separator (0 at SEP, TERM and the pad). Phrase arrays are
    bucket-padded with zero-length pads at d_starts == total; their
    scatters are dropped."""
    dev = ext.device
    npzb = phrase_st.shape[0] - 1
    pos = torch.arange(nd, dtype=I32, device=dev)
    ids = torch.arange(1, npzb + 1, dtype=I32, device=dev)
    st_idx = torch.where(ids <= npz, torch.clamp(d_starts[1:], 0, nd - 1), nd)
    d_start_of = _fill_per_occ(d_starts[1:], st_idx, nd)
    st_of = _fill_per_occ(phrase_st[1:], st_idx, nd)
    plen_of = _fill_per_occ(phrase_ln[1:], st_idx, nd)
    off = pos - d_start_of
    in_phrase = off < plen_of
    ch = ext[torch.clamp(st_of + off, 0, ne - 1)]
    d = torch.where(in_phrase, ch, SEP).to(torch.uint8)
    d = torch.where(pos >= total, TERM, d).to(torch.uint8)
    rem = torch.where(in_phrase & (pos < total), plen_of - off, 0).to(I32)
    meta = torch.where((rem > 0) & (off >= 1), rem, -1)
    return d, meta, rem


def _dict_live(phrase_ln: np.ndarray, levels: int) -> tuple:
    """live[l]: the dictionary positions the bounded doubling sorts in
    round l (ops/suffix._bounded_rounds), those with remaining length r
    and r + 1 >= 2^(l-1): a phrase of length n has one at each r in 1..n,
    so n + 2 - 2^(l-1) of them when that is positive. Rounds 0 and 1 never
    run on the dictionary (its seed covers 4 or 8 characters): 0."""
    lens = np.asarray(phrase_ln, np.int64)
    lens = lens[lens > 0]
    live = [0, 0]
    for lvl in range(2, levels + 1):
        least = (1 << (lvl - 1)) - 1  # the least r a live row has
        lens = lens[lens >= least]
        live.append(int(lens.sum()) - (least - 1) * lens.size)
    return tuple(live)


def _dict_starts(phrase_ln: np.ndarray) -> np.ndarray:
    """Start offset in D per phrase id (1-based); D blocks are len+1."""
    npz = phrase_ln.size - 1
    starts = np.zeros(npz + 1, np.int64)
    starts[1:] = np.cumsum(phrase_ln[1:] + 1) - (phrase_ln[1:] + 1)
    return starts.astype(np.int32)


def _dict_index(ext, phrase_st, phrase_ln, d_starts, npz: int, total: int,
                nd: int, ne: int, w: int, lvl_cap: int, lvl_static: int,
                seed_thr, lcp_thr, live: tuple, probe_words: int = 2):
    """Dictionary index: D, depth-capped SA doubling bounded by the phrase
    separators, LCP (PLCP for <= 8 letters, rank descent otherwise), ISA
    and suffix groups. Returns (d, lcpD, isaD, grp_of_pos, grp_cross).

    live: _dict_live's counts (_host_prep's dict_live). The bounded
    doubling (ops/suffix._bounded_rounds) orders saD as the unbounded one
    does outside the zero pad and gives every pair of suffixes that differ
    before their separators its exact LCP; a pair equal through its
    separators reads an LCP above them, the exact one or more. d,
    grp_of_pos and grp_cross, and everything built on them, are the
    unbounded doubling's."""
    d, pos_meta, rem = _dict_setup(ext, phrase_st, phrase_ln, d_starts, npz,
                                   total, nd, ne)
    with trace.span("pfp.dict.sa"):
        lvlD = min(ops_suffix._num_levels(nd), lvl_cap) + 1
        histD, start_lvl = ops_suffix._seed_history(
            d, nd, lvlD - 1, packed_init=True, alpha_thresholds=seed_thr)
        saD = ops_suffix._bounded_rounds(histD, start_lvl, rem, live)
    del rem
    with trace.span("pfp.dict.lcp"):
        if seed_thr is not None:
            lcpD, isaD = ops_suffix._lcp_plcp_impl(
                saD, histD, d, nd, lvl_static, seed_thr,
                deep_cap=max(nd // 3, 1024), probe_words=probe_words,
                counter=trace.DICT_DESCENT_ROWS)
        else:
            lcpD = ops_suffix._lcp_impl(
                saD, histD, lvlD, nd, levels=lvl_static, text=d,
                bottom_thresholds=lcp_thr, counter=trace.DICT_DESCENT_ROWS)
            isaD = _isa_dev(saD, nd)
    del histD
    lcpD = ops_suffix.canonicalize_pad_lcp(lcpD, saD, total, nd)
    grp_of_pos, grp_cross = _dict_groups(d, saD, lcpD, pos_meta, nd, w)
    return d, lcpD, isaD, grp_of_pos, grp_cross


def _dict_groups(d, saD, lcpD, pos_meta, nd: int, w: int):
    """Group valid dict suffixes (same string across phrases):
    grp_of_pos[d_pos] = group id of the valid suffix at d_pos, else -1;
    grp_cross[g] = cross-group LCP at the first row of group g."""
    dev = d.device
    suf_len = pos_meta[saD]
    valid = suf_len >= w
    gapmin = _segmented_min_after_valid(lcpD, valid)
    idx = torch.arange(nd, dtype=I32, device=dev)
    last_valid = scan.running_max(torch.where(valid, idx, -1))
    prev_valid_idx = torch.cat([torch.full((1,), -1, dtype=I32, device=dev),
                                last_valid[:-1]])
    prev_len = torch.where(prev_valid_idx >= 0,
                           suf_len[torch.clamp(prev_valid_idx, min=0)], -1)
    same = valid & (gapmin >= suf_len) & (prev_len == suf_len)
    new_group = valid & ~same
    grp_of_row = torch.cumsum(new_group.to(I32), 0, dtype=I32) - 1
    grp_cross = torch.zeros(nd, dtype=I32, device=dev)
    trace.count(trace.READBACKS, 2)  # two mask indexes
    grp_cross[grp_of_row[new_group]] = gapmin[new_group]
    grp_cross[0] = 0
    grp_of_pos = ops_suffix.route_set(saD, torch.where(valid, grp_of_row, -1))
    return grp_of_pos, grp_cross


def _isa_dev(sa: torch.Tensor, n: int) -> torch.Tensor:
    return ops_suffix.route_set(
        sa, torch.arange(n, dtype=I32, device=sa.device))


def _pad_phrase_arrays(pfp: PFPData):
    """Bucket-pad the per-phrase arrays for _dict_setup: zero-length pad
    phrases at the end-of-dictionary sentinel. Returns numpy
    (phrase_st, phrase_ln, d_starts_pad, npz, total_real, nd)."""
    d_starts = _dict_starts(pfp.phrase_ln)
    # +4 trailing TERM pads: the packed SA seed reads up to 3 chars past
    # a suffix start
    nd = ops_suffix.bucket(pfp.d_len + 4, lo=1024)
    npz = pfp.num_phrases
    npzb = ops_suffix.bucket(npz + 1, lo=64) - 1
    total_real = pfp.d_len - 1
    phrase_st = np.zeros(npzb + 1, np.int32)
    phrase_ln = np.zeros(npzb + 1, np.int32)
    d_starts_pad = np.full(npzb + 1, total_real, np.int32)
    phrase_st[:npz + 1] = pfp.phrase_st
    phrase_ln[:npz + 1] = pfp.phrase_ln
    d_starts_pad[:npz + 1] = d_starts
    return phrase_st, phrase_ln, d_starts_pad, npz, total_real, nd


def _host_prep(pfp: PFPData, doc_ends: np.ndarray):
    """Host-side preparation for a scan: bucket-padded phrase arrays and
    parse arrays (uploaded to ext's device), the expansion row layout and
    the size parameters. Row and text coordinates are int32 below 2^31
    rows; past it cumcnt and doc_ends are int64 (only the block scan,
    parallel/widepfp.py, takes such a row space: pfp_scan refuses it)."""
    dev = pfp.ext.device
    w = pfp.w
    phrase_st, phrase_ln, d_starts_pad, npz, total_real, nd = \
        _pad_phrase_arrays(pfp)
    # the dict order and LCP values are consumed only up to maxlen+1
    # chars, so the doubling and the descent stop at log2(maxlen) rounds
    maxlen = int(pfp.phrase_ln.max()) if pfp.phrase_ln.size > 1 else 1
    lvl_cap = (maxlen + 2).bit_length()
    alpha = sorted(set(pfp.alpha) | {TERM, SEP, DOLLAR_PFP})
    seed_thr, lcp_thr = seed_thresholds(alpha)
    lvl_run = min(ops_suffix._num_levels(nd), lvl_cap) + 1
    lvl_static = min((lvl_run + 1) // 2 * 2, lvl_run, lvl_cap)

    m = pfp.m
    mp = ops_suffix.bucket(m + 1, lo=64)
    pprime = np.zeros(mp, np.int32)
    pprime[:m] = pfp.parse
    charlen = np.zeros(mp + 1, np.int64)
    charlen[:m] = pfp.phrase_ln[pfp.parse] - w
    cumC = np.concatenate([[0], np.cumsum(charlen)])

    cnt = (pfp.phrase_ln[pfp.parse] - w).astype(np.int64)
    n_rows = int(cnt.sum())
    nr = ops_suffix.bucket(n_rows, lo=1024)
    wide = n_rows >= 2**31
    cumcnt = np.zeros(mp + 1, np.int64 if wide else np.int32)
    cumcnt[1:m + 1] = np.cumsum(cnt)
    cumcnt[m + 1:] = n_rows

    def up(a, dtype=I32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).to(dev)
    return {
        "phrase_st": up(phrase_st), "phrase_ln": up(phrase_ln),
        "d_starts": up(d_starts_pad), "npz": npz, "total_real": total_real,
        "parse": up(pprime), "cumC": up(cumC, I64),
        "cumcnt": up(cumcnt, I64 if wide else I32),
        "m": m, "total_rows": n_rows, "n_text": pfp.n_text,
        "doc_ends": up(doc_ends.astype(np.int64), I64 if wide else I32),
        "ne": int(pfp.ext.shape[0]), "nd": nd, "nr": nr, "mp": mp, "w": w,
        "lvl_cap": lvl_cap, "lvl_static": lvl_static, "seed_thr": seed_thr,
        "lcp_thr": lcp_thr, "dict_live": _dict_live(pfp.phrase_ln, lvl_cap),
    }


def _parse_side(pprime, cumC, d_starts, lcpD, isaD, mp: int):
    """Parse SA + rank-descent LCP + ISA + s_lcp_T and its range-min
    table, all mp-scale. Returns (isaP, slt_table)."""
    saP, histP, lvlP = ops_suffix._suffix_array_impl(pprime, mp)
    klcp = ops_suffix._lcp_impl(saP, histP, lvlP, mp)
    isaP = _isa_dev(saP, mp)
    slt = _build_slt(pprime, saP, klcp, cumC, d_starts, lcpD, isaD, mp)
    return isaP, _min_table(slt)


def _build_slt(pprime, saP, klcp, cumC, d_starts, lcpD, isaD, mp: int):
    """SLT[r] = char-LCP of the text suffixes at the phrase starts of
    parse-SA rows r-1 and r (the reference's s_lcp_T, pfp.hpp:210-244).
    The character sum is int64 and saturates at 2^31-1, like the JAX
    package's uint32 form."""
    a = torch.cat([saP[:1], saP[:-1]])
    b = saP
    k = klcp
    c = (cumC[torch.clamp(a + k, 0, mp)] - cumC[torch.clamp(a, 0, mp)])
    x = pprime[torch.clamp(a + k, 0, mp - 1)]
    y = pprime[torch.clamp(b + k, 0, mp - 1)]
    xr = isaD[d_starts[x]]
    yr = isaD[d_starts[y]]
    lo = torch.minimum(xr, yr) + 1
    hi = torch.maximum(xr, yr)
    tab = _min_table(lcpD)
    pair = _rmq_query(tab, lo, hi)
    pair = torch.where((x == 0) | (y == 0) | (x == y), 0, pair)
    slt = torch.clamp(c + pair.to(I64), max=2**31 - 1).to(I32)
    slt[0] = 0
    return slt


def _grp_tab(d, grp_of_pos, grp_cross, nd: int):
    """Per dict position: group id (-1 invalid), previous dict char (the
    BWT char of rows at this position), and the group's cross LCP."""
    prev_d = torch.zeros(nd, dtype=I32, device=d.device)
    prev_d[1:] = d[:-1].to(I32)
    cross_of_pos = grp_cross[torch.clamp(grp_of_pos, 0,
                                         grp_cross.shape[0] - 1)]
    return grp_of_pos, prev_d, cross_of_pos


def _expand_operands(parse, d_starts, cumcnt, m: int, total_rows: int,
                     n_text: int, isaP, grp_tab, doc_ends, nr: int, nd: int,
                     w: int, num_docs: int):
    """One row per text position r: (key1, key2, ssa, suf_len, bwt,
    doc id, cross LCP). key1 = group id at the row's dict position (-1 for
    pads), key2 = isaP of the next parse position; the text position of
    row r is r itself (occurrences tile the text with w-overlap)."""
    dev = parse.device
    r = torch.arange(nr, dtype=I32, device=dev)
    mp1 = cumcnt.shape[0]
    slots = torch.arange(mp1 - 1, dtype=I32, device=dev)
    starts_idx = torch.where(slots < m, torch.clamp(cumcnt[:-1], 0, nr - 1),
                             nr)
    pad = r >= total_rows

    base = cumcnt[:-1]
    pid_tab = parse[:mp1 - 1]
    keep = starts_idx < nr
    nxt = torch.zeros(nr, dtype=I32, device=dev)
    trace.count(trace.READBACKS, 2)
    nxt.scatter_reduce_(0, starts_idx[keep].to(I64), cumcnt[1:][keep],
                        reduce="amax", include_self=True)
    next_start = scan.running_max(nxt)
    suf_len = next_start + (w - 1) - r
    dictpos = r + _fill_per_occ(d_starts[pid_tab] - base + 1, starts_idx, nr)
    ssa = torch.clamp(r, max=n_text)
    k2_vals = torch.cat([isaP[1:mp1 - 1],
                         torch.zeros(1, dtype=I32, device=dev)])
    key2 = torch.where(pad, 0, _fill_per_occ(k2_vals, starts_idx, nr))

    ends_idx = torch.clamp(doc_ends, 0, nr - 1)
    bounds = torch.zeros(nr, dtype=I32, device=dev)
    bounds.index_add_(0, ends_idx, torch.ones_like(ends_idx, dtype=I32))
    da_by_pos = torch.clamp(torch.cumsum(bounds, 0, dtype=I32), max=num_docs)

    grp_col, prev_col, cross_col = grp_tab
    dp = torch.clamp(dictpos, 0, nd - 1)
    key1 = torch.where(pad, -1, grp_col[dp])
    bwt = torch.where(pad, 0, prev_col[dp])
    crossv = torch.where(pad, 0, cross_col[dp])
    return key1, key2, ssa, suf_len, bwt, da_by_pos, crossv


def _sort_rows(ops, num_keys: int = 2):
    """Stable sort of a row-operand tuple by its first num_keys operands,
    through one exact int64 key. Two keys: key1 in [-1, 2^31 - 1) and key2
    in [-1, 2^32 - 1), packed as ((key1 + 1) << 32) | (key2 + 1), so a -1
    sorts first: the pads of the expansion rows (key1 = -1; key1 < nd, key2
    in [0, mp)), a rank shifted past the end (parallel/sharddict.py). One
    key: any int32 or int64 operand, taken as it is."""
    if num_keys == 1:
        key = ops[0].to(I64)
    elif num_keys == 2:
        # in place: the row space sets the scan's peak, so no temporary
        # beyond the two int64 copies
        key = ops[0].to(I64, copy=True).add_(1).bitwise_left_shift_(32)
        key.bitwise_or_(ops[1].to(I64, copy=True).add_(1))
    else:
        raise ValueError(f"num_keys must be 1 or 2, got {num_keys}")
    perm = torch.sort(key, stable=True).indices
    return tuple(op[perm] for op in ops)


def _analyze_sorted(sorted_ops, slt_table, nr: int, w: int, num_docs: int,
                    min_match_len: int, num_distinct: int,
                    max_total_freq: int, max_doc_freq: int,
                    size_cap: int | None, need_ctx: bool = False):
    """Post-sort: per-row LCP from the PFP tables, then the interval
    analysis. Returns (res, counts) with counts = [emit, cand, BWT runs]."""
    key1s, key2s, ssas, sufs, bwts, da, cross = sorted_ops
    dev = key1s.device
    same_grp = torch.zeros(nr, dtype=torch.bool, device=dev)
    same_grp[1:] = key1s[1:] == key1s[:-1]
    prev_key2 = torch.cat([key2s[:1], key2s[:-1]])
    within = sufs - w + _rmq_query(slt_table,
                                   torch.minimum(prev_key2, key2s) + 1,
                                   torch.maximum(prev_key2, key2s))
    lcp = torch.where(same_grp, within, cross)
    lcp = torch.where(key1s < 0, 0, lcp).to(I32)
    lcp[0] = 0
    da = torch.where(key1s < 0, num_docs, da).to(I32)
    bwt8 = bwts.to(torch.uint8)

    res = ops_intervals.analyze_intervals(
        lcp, da, bwt8, nr, min_match_len, num_distinct, max_total_freq,
        max_doc_freq, size_cap=size_cap, need_ctx=need_ctx)
    res["sa"] = ssas
    res["da"] = da
    res["lcp"] = lcp
    res["bwt"] = bwt8
    real = key1s >= 0
    change = (bwts[1:] != bwts[:-1]) & real[1:] & real[:-1]
    nruns = change.sum(dtype=I32) + 1
    counts = torch.stack([res["emit"].sum(dtype=I32),
                          res["cand"].sum(dtype=I32), nruns])
    return res, counts


def _expand_and_analyze(parse, d_starts, cumcnt, m: int, total_rows: int,
                        n_text: int, isaP, grp_of_pos, d, slt_table,
                        grp_cross, doc_ends, nr: int, nd: int, w: int,
                        num_docs: int, min_match_len: int, num_distinct: int,
                        max_total_freq: int, max_doc_freq: int,
                        size_cap: int | None = None, need_ctx: bool = False):
    """Expand (occurrence, offset) rows, sort into SA order, compute LCP
    and run the interval analysis."""
    grp_tab = _grp_tab(d, grp_of_pos, grp_cross, nd)
    ops = _expand_operands(parse, d_starts, cumcnt, m, total_rows, n_text,
                           isaP, grp_tab, doc_ends, nr, nd, w, num_docs)
    return _analyze_sorted(_sort_rows(ops), slt_table, nr, w, num_docs,
                           min_match_len, num_distinct, max_total_freq,
                           max_doc_freq, size_cap, need_ctx)


def pfp_scan_prepare(pfp: PFPData, doc_ends: np.ndarray,
                     probe_words: int = 2,
                     dict_devices: list | None = None,
                     max_nr: int | None = None) -> dict:
    """The dict and parse side of a scan on pfp.ext's device, shared by
    pfp_scan and the sharded scan (parallel/seqpfp.py): _host_prep's arrays
    and sizes plus the tables d, grp_of_pos, grp_cross, isaP and slt_table.
    All of it is dictionary- and parse-sized, small beside the row space;
    the sharded scan copies it to every device.

    dict_devices: a mesh (parallel/mesh.py, its first device pfp.ext's) to
    build the dict index distributed over it (parallel/sharddict.py); the
    tables are the same (the tie-order argument is in that module).
    probe_words belongs to the replicated index alone: the sharded one
    takes the rank descent and has no probe. max_nr: refuse a row bucket
    of max_nr or more with ScanSizeError, before the dict index."""
    with trace.stage("pfp.dict_index", "dict_index"):
        h = _host_prep(pfp, doc_ends)
        if max_nr is not None and h["nr"] >= max_nr:
            raise ScanSizeError(
                f"row spaces past 2^31 need the block (wide) scan: "
                f"{h['total_rows']} rows (bucket {h['nr']}) do not fit one "
                "device's int32 row arrays; shard the scan (--seq-shards N) "
                "or partition the collection (MumemtoM)")
        if dict_devices is not None:
            from mumemto_tpu_torch.parallel import sharddict
            fn = sharddict.compile_sharded_dict_index(
                dict_devices, h["nd"], h["ne"], h["w"], h["lvl_cap"],
                h["lvl_static"], h["seed_thr"], h["lcp_thr"])
            d, lcpD, isaD, grp_of_pos, grp_cross = fn(
                pfp.ext, h["phrase_st"], h["phrase_ln"], h["d_starts"],
                h["npz"], h["total_real"])
        else:
            d, lcpD, isaD, grp_of_pos, grp_cross = _dict_index(
                pfp.ext, h["phrase_st"], h["phrase_ln"], h["d_starts"],
                h["npz"], h["total_real"], h["nd"], h["ne"], h["w"],
                h["lvl_cap"], h["lvl_static"], h["seed_thr"], h["lcp_thr"],
                h["dict_live"], probe_words=probe_words)
    with trace.stage("pfp.parse_side", "parse_side"):
        isaP, slt_table = _parse_side(h["parse"], h["cumC"], h["d_starts"],
                                      lcpD, isaD, h["mp"])
    h.update({"isaP": isaP, "grp_of_pos": grp_of_pos, "d": d,
              "slt_table": slt_table, "grp_cross": grp_cross})
    return h


def pfp_scan(pfp: PFPData, doc_ends: np.ndarray, num_docs: int,
             min_match_len: int, num_distinct: int, max_total_freq: int,
             max_doc_freq: int, size_cap: int | None = None,
             need_ctx: bool = False, probe_words: int = 2):
    """Full PFP expansion + interval scan on pfp.ext's device; returns
    (res, counts, nr)."""
    h = pfp_scan_prepare(pfp, doc_ends, probe_words=probe_words,
                         max_nr=ROW_LIMIT)
    with trace.stage("pfp.expand_sort_analyze", "expand_sort_analyze"):
        res, counts = _expand_and_analyze(
            h["parse"], h["d_starts"], h["cumcnt"], h["m"],
            h["total_rows"], h["n_text"], h["isaP"], h["grp_of_pos"], h["d"],
            h["slt_table"], h["grp_cross"], h["doc_ends"], h["nr"], h["nd"],
            h["w"], num_docs, min_match_len, num_distinct, max_total_freq,
            max_doc_freq, size_cap, need_ctx)
    return res, counts, h["nr"]


# ---------------------------------------------------------------------------
# .dict/.parse resume files (newscan.hpp:407-419 format)
# ---------------------------------------------------------------------------

def write_parse_files(rb, prefix: str, device: torch.device, w: int = 10,
                      mod: int = 100) -> None:
    """-P/--only-parse: write PREFIX.dict (lex-sorted phrases, EndOfWord
    after each, then EndOfDict) and PREFIX.parse (u32 1-based ranks), from
    the same parse as the scan (build_pfp on `device`, so the KR kernel
    runs on a CUDA device) and the same D (_dict_setup)."""
    pfp = build_pfp(rb.text, device, w=w, mod=mod)
    phrase_st, phrase_ln, d_starts_pad, npz, total_real, nd = \
        _pad_phrase_arrays(pfp)

    def up(a):
        return torch.from_numpy(a).to(device)
    d, _meta, _rem = _dict_setup(pfp.ext, up(phrase_st), up(phrase_ln),
                                 up(d_starts_pad), npz, total_real, nd,
                                 int(pfp.ext.shape[0]))
    with open(prefix + ".dict", "wb") as f:
        f.write(d[:pfp.d_len].cpu().numpy().tobytes())
    with open(prefix + ".parse", "wb") as f:
        f.write(pfp.parse.astype("<u4").tobytes())


def read_parse_files(prefix: str):
    """PREFIX.dict/.parse (ours or the reference's) as (dict body, phrase
    starts, phrase lengths, parse ids). A .dict that does not end with
    EndOfDict (a truncated file) raises ValueError."""
    d = np.fromfile(prefix + ".dict", dtype=np.uint8)
    parse = np.fromfile(prefix + ".parse", dtype="<u4").astype(np.int32)
    if d.size == 0 or d[-1] != TERM:
        raise ValueError(f"{prefix}.dict does not end with the EndOfDict "
                         "byte: truncated or not a PFP dictionary")
    # split D on EndOfWord separators
    body = d[:-1]
    seps = np.flatnonzero(body == SEP)
    starts = np.concatenate([[0], seps[:-1] + 1])
    lens = seps - starts
    return body, starts.astype(np.int32), lens.astype(np.int32), parse


def pfp_from_parse_files(prefix: str, device: torch.device,
                         w: int = 10) -> PFPData:
    """-p/--from-parse resume (pfp_mum.cpp:122-123, pfp.hpp:105-129):
    PFPData from PREFIX.dict/.parse without the FASTAs, ext on `device`.

    The dict body is the phrase byte store (ext): phrase records address
    their bytes in it, so _dict_setup rebuilds the same D. Text length
    comes from the PFP invariant: occurrence j+1 starts phrase_ln[parse[j]]
    - w chars after occurrence j, and occurrence 0 at -1 (the Dollar)."""
    body, starts, lens, parse = read_parse_files(prefix)
    num_phrases = int(lens.size)
    m = int(parse.size)
    if parse.size and (int(parse.min()) < 1 or int(parse.max()) > num_phrases):
        raise ValueError(
            f"{prefix}.parse references phrase ids outside the .dict "
            f"(1..{num_phrases})")
    # every PFP phrase ends with the w-char trigger window of the next
    # phrase, so real phrase lengths are >= w+1; shorter ones mean the
    # files were written with a different window than the caller's w
    if lens.size and int(lens.min()) <= w:
        raise ValueError(
            f"{prefix}.dict contains a phrase of length {int(lens.min())} "
            f"<= w={w}: window mismatch with the parse files")
    phrase_st = np.zeros(num_phrases + 1, np.int32)
    phrase_ln = np.zeros(num_phrases + 1, np.int32)
    phrase_st[1:] = starts
    phrase_ln[1:] = lens
    ext_pad = np.zeros(ops_suffix.bucket(body.size + 1, lo=1024), np.uint8)
    ext_pad[:body.size] = body
    step = (phrase_ln[parse] - w).astype(np.int64)
    return PFPData(w=w, n_text=int(step.sum()) - 1, m=m,
                   num_phrases=num_phrases,
                   d_len=int(phrase_ln.sum()) + num_phrases + 1,
                   ext=torch.from_numpy(ext_pad).to(device), parse=parse,
                   phrase_st=phrase_st, phrase_ln=phrase_ln,
                   alpha=_alphabet(body))


def collection_pfp(rb, device: torch.device, w: int = 10, mod: int = 100,
                   parse_prefix: str | None = None) -> PFPData:
    """The collection's PFPData on `device`: read from PREFIX.dict/.parse
    (-p, the stage pfp.read_parse) or built from rb.text (pfp.build)."""
    if parse_prefix:
        with trace.stage("pfp.read_parse", "read_parse"):
            return pfp_from_parse_files(parse_prefix, device, w=w)
    with trace.stage("pfp.build", "build_pfp"):
        return build_pfp(rb.text, device, w=w, mod=mod)
