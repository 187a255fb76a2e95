"""Sharded dictionary index: the dict-side SA/LCP/groups distributed over
the mesh of the sharded scan, in PyTorch.

Port of mumemto_tpu/parallel/sharddict.py. parallel/seqpfp.py shards the
O(n) expansion row space but builds the whole dictionary index
(ops/pfp._dict_index) on one device and copies its tables to the others.
This module distributes every nd-scale dictionary stage over the same mesh
(parallel/mesh.py: a list of devices, one per shard, which may repeat) with
the same block-bitonic sort:

  S1  D per block (ops/pfp._dict_setup with searchsorted block carries:
      phrase starts are ascending, the technique of parallel/widepfp's
      occurrence fills).
  S2  prefix-doubling rounds: each round is one distributed 2-key sort of
      (rank, key2, idx), neighbour `changed` flags from a one-row halo, a
      cross-shard prefix-sum carry for the new ranks and one distributed
      1-key permutation route (a sort by text index) back to text order.
      key2 is a static shift by k rows: at most two block moves.
  S3  the LCP rank descent: the per-level random gathers into the sharded
      rank history become merged-stream routed gathers. Value rows
      (position, rank) and request rows (address, return slot) co-sort in
      one distributed 1-key sort; a forward last-value fill answers every
      request from the value row before it; a route-back sort restores
      request order. Deterministic and capacity-free: a stream is exactly
      (q + 1) * Bd rows per shard.
  S4  ISA and the group tables: permutation routes and cross-shard carries
      for the segmented fills of ops/pfp._dict_groups.

A per-shard array is a list of tensors, shard i's on devices[i]; what the
JAX module writes once inside shard_map is a loop over shards here.

Ties (why the outputs equal the single-device index): the depth-capped
doubling leaves suffix pairs that share more than 2^cap chars tied, and the
block sort orders ties differently from the single-device stable sort. That
difference is inert: tied suffixes have equal capped rank rows at every
level, so rank functions, group membership, the gapmin and cross minima and
every descent h do not depend on the order within a tie; lcpD entries
inside a tie block all reach the clamp. d, grp_of_pos and grp_cross are
equal exactly, lcpD once clamped at maxlen + 1, isaD at whole-phrase
starts, and the output bytes end to end (tests/test_torch_sharddict.py).
The single-device index takes the PLCP route for <= 8 letters; both pin the
zero-pad class (ops/suffix.canonicalize_pad_lcp), so the two agree in that
form.

Cost: the single-device index is (rounds + 2 * descent levels + groups)
random gather or scatter passes over nd rows. Sharded, a shard touches nd /
P rows a pass, and each 2-gather descent level becomes two distributed
sorts of 3 * Bd rows a shard: block_sorts() distributed sorts in all (38 at
lvl_cap 11), each of P + P/2 * log2(P) * (log2(P) + 1) / 2 local sorts.
With every shard on one card the whole rank history lives on that card
too, and the many small launches bind the stage to the host, so neither
the time nor the peak falls there. Measured on one NVIDIA H100 80GB HBM3
(700.00 W) by chip_smoke.py, on the 8 Mbp bench dictionary (nd = 6291456):
the dict_index stage takes 0.223 / 0.393 / 0.694 s with 2 / 4 / 8 shards
against 0.060 s on one device (nd = 25165824, 8 shards: 2.299 against
0.238 s), and the scan's peak is 2.57 / 2.01 / 1.70 GiB against 2.39 /
2.01 / 1.70 (PERF.md). With 8 shards on four such cards (chip_smoke.py
--cards, nd = 25165824) the stage takes 1.24 s against 0.25 s and its own
peak on devices[0] falls from 3.83 to 2.15 GiB (2.83 on the last card), but
no card's peak over the whole scan falls: devices[0]'s is the parse side's
(5.39 GiB, on tables this module gathers there all the same) and the
others' the block sort's. So the module pays only where the dictionary
index alone would not fit one card. The final tables (d, lcpD, isaD,
grp_of_pos, grp_cross, about 4 x nd) are gathered on devices[0] for the
parse side and the expansion's table gather.

Opt-in: find_matches_seq_sharded(..., shard_dict=True) or
MUMEMTO_SHARD_DICT=1. Requires the <= 8-letter alphabet (packed seed).
"""

from __future__ import annotations

import torch

from mumemto_tpu_torch.ops import intervals as ops_intervals
from mumemto_tpu_torch.ops import pfp as ops_pfp
from mumemto_tpu_torch.ops import suffix as ops_suffix
from mumemto_tpu_torch.ops.suffix import I32, I64
from mumemto_tpu_torch.parallel import mesh as pmesh
from mumemto_tpu_torch.parallel.seqpfp import _bitonic_block_sort
from mumemto_tpu_torch.parallel.widepfp import _block_fill

SEP = ops_pfp.SEP
TERM = ops_pfp.TERM
IMAX = ops_intervals.INT32_MAX


# ---------------------------------------------------------------------------
# cross-shard primitives (per-shard scalars are 0-d tensors, one per shard)
# ---------------------------------------------------------------------------

def _scatter_scalars(vec, devices: list) -> list:
    """Entry i of a devices[0] vector as a 0-d tensor on devices[i]."""
    return [vec[i].to(dev) for i, dev in enumerate(devices)]


def _ex_prefix(scalars: list, devices: list) -> list:
    """Exclusive prefix sum of a per-shard int32 scalar over the shards."""
    ps = pmesh.all_gather(scalars, devices[0])
    return _scatter_scalars(torch.cumsum(ps, 0, dtype=ps.dtype) - ps,
                            devices)


def _last_before(hs: torch.Tensor) -> torch.Tensor:
    """Per shard i, the last shard j < i where hs holds, else -1."""
    idxp = torch.arange(hs.shape[0], device=hs.device)
    last = torch.cummax(torch.where(hs, idxp, -1), 0).values
    return torch.cat([last.new_full((1,), -1), last[:-1]])


def _carry_last(has: list, val: list, devices: list, default) -> list:
    """Per shard, the value of the last shard before it with `has`, else
    default."""
    hs = pmesh.all_gather(has, devices[0])
    vs = pmesh.all_gather(val, devices[0])
    j = _last_before(hs)
    return _scatter_scalars(
        torch.where(j >= 0, vs[torch.clamp(j, min=0)], default), devices)


def _from_shard(blocks: list, j: int, devices: list) -> list:
    """Shard i's view of shard (i + j)'s block (zeros past the end)."""
    nshards = len(blocks)
    if j == 0:
        return list(blocks)
    got = pmesh.ppermute(blocks, [(s, s - j) for s in range(j, nshards)],
                         devices) if j < nshards else [None] * nshards
    return [torch.zeros_like(blocks[i]) if g is None else g
            for i, g in enumerate(got)]


def _shift_k(blocks: list, k: int, devices: list, Bd: int, fill) -> list:
    """out[i][r] = global arr[i * Bd + r + k] for k >= 0, with `fill` past
    the global end. At most two block moves per shard."""
    nshards = len(blocks)
    j, r = divmod(k, Bd)
    a = _from_shard(blocks, j, devices)
    b = _from_shard(blocks, j + 1, devices) if r else None
    out = []
    for i, dev in enumerate(devices):
        o = a[i] if r == 0 else torch.cat([a[i][r:], b[i][:r]])
        if (i + 1) * Bd + k > nshards * Bd:
            gpos = i * Bd + k + torch.arange(Bd, dtype=I64, device=dev)
            o = torch.where(gpos < nshards * Bd, o, fill)
        out.append(o)
    return out


def _prev1(blocks: list, devices: list, fill) -> list:
    """out[i][r] = global arr[i * Bd + r - 1] (one element from the
    previous shard; `fill` before the global start)."""
    out = []
    for i, blk in enumerate(blocks):
        prev = blk.new_full((1,), fill) if i == 0 else \
            blocks[i - 1][-1:].to(devices[i])
        out.append(torch.cat([prev, blk[:-1]]))
    return out


def _perm_route(keys: list, payload: list, devices: list) -> list:
    """Distributed scatter by a permutation key: sort (key, payload) by
    key; the keys are a permutation of [0, nd), so the sorted blocks line
    up with the position blocks."""
    out = _bitonic_block_sort(list(zip(keys, payload)), devices, num_keys=1)
    return [ops[1] for ops in out]


def _routed_gather(values: list, addrs: list, devices: list, Bd: int,
                   nd: int) -> list:
    """Merged-stream routed gather: out[i][r] = values_global[addrs[i][r]].

    values[i]: (Bd,) shard i's value block for dict positions [i * Bd,
    (i + 1) * Bd); addrs[i]: (q * Bd,) global addresses in [0, nd). Stream
    keys (int64) carry a low type bit, so a value sorts before the
    requests at its address; the payload carries the value or the
    request's global return slot. A forward last-value fill with a
    cross-shard carry answers every request; the route-back sort restores
    request order and puts the value rows into a tail zone per shard, so
    block boundaries stay aligned."""
    q = addrs[0].shape[0] // Bd
    stream = []
    for i, dev in enumerate(devices):
        vkey = (i * Bd + torch.arange(Bd, dtype=I64, device=dev)) << 1
        rkey = (torch.clamp(addrs[i].to(I64), 0, nd - 1) << 1) | 1
        slots = i * (q * Bd) + torch.arange(q * Bd, dtype=I32, device=dev)
        stream.append((torch.cat([vkey, rkey]),
                       torch.cat([values[i].to(I32), slots])))
    stream = _bitonic_block_sort(stream, devices, num_keys=1)

    fills = []
    for key_s, pay_s in stream:
        is_val = (key_s & 1) == 0
        ordv = torch.cumsum(is_val, 0, dtype=I32)  # 1-based local ordinal
        # the value rows in order; a masked write, one spare slot so an
        # empty table can still be indexed
        vtab = torch.cat([pay_s[is_val], pay_s.new_zeros(1)])
        fills.append((is_val, ordv, vtab))
    carry = _carry_last(
        [ordv[-1] > 0 for _, ordv, _ in fills],
        [vtab[torch.clamp(ordv[-1] - 1, min=0)] for _, ordv, vtab in fills],
        devices, 0)

    back = []
    for i, (key_s, tag) in enumerate(stream):
        is_val, ordv, vtab = fills[i]
        answer = torch.where(ordv > 0, vtab[torch.clamp(ordv - 1, min=0)],
                             carry[i])
        tag = tag.to(I64)
        ret_req = (tag // (q * Bd)) * ((q + 1) * Bd) + tag % (q * Bd)
        pos = key_s >> 1
        ret_val = (pos // Bd) * ((q + 1) * Bd) + q * Bd + pos % Bd
        back.append((torch.where(is_val, ret_val, ret_req), answer))
        stream[i] = fills[i] = None
    back = _bitonic_block_sort(back, devices, num_keys=1)
    # clones: the answers must not keep the tail zone alive
    return [ops[1][:q * Bd].clone() for ops in back]


# ---------------------------------------------------------------------------
# S1: block D materialization
# ---------------------------------------------------------------------------

def _block_dict_setup(i: int, ext, phrase_st, phrase_ln, d_starts, npz: int,
                      total: int, Bd: int, nd: int, ne: int):
    """Shard i's block of D and of the proper-suffix lengths
    (ops/pfp._dict_setup over positions [i * Bd, (i + 1) * Bd) with
    searchsorted block carries), on ext's device."""
    dev = ext.device
    base = i * Bd
    pos = base + torch.arange(Bd, dtype=I32, device=dev)
    npzb = phrase_st.shape[0] - 1
    ids = torch.arange(1, npzb + 1, dtype=I32, device=dev)
    st = torch.where(ids <= npz, d_starts[1:], nd)  # ascending real starts
    rel = st - base
    in_blk = (rel >= 0) & (rel < Bd)
    loc = torch.where(in_blk, rel, Bd).to(I64)
    j0p = torch.searchsorted(
        st, torch.full((1,), base, dtype=I32, device=dev), side="left") - 1

    def fill(vals):
        return _block_fill(vals, loc, in_blk, j0p, Bd, I32)

    d_start_of = fill(st)
    st_of = fill(phrase_st[1:])
    plen_of = fill(phrase_ln[1:])
    off = pos - d_start_of
    in_phrase = off < plen_of
    ch = ext[torch.clamp(st_of + off, 0, ne - 1)]
    d = torch.where(in_phrase, ch, SEP).to(torch.uint8)
    d = torch.where(pos >= total, TERM, d).to(torch.uint8)
    good = in_phrase & (pos < total) & (off >= 1)
    meta = torch.where(good, plen_of - off, -1).to(I32)
    return d, meta


# ---------------------------------------------------------------------------
# the sharded index
# ---------------------------------------------------------------------------

def block_sorts(nd: int, lvl_cap: int, lvl_static: int) -> int:
    """Distributed block sorts of one sharded index: the seed, a sort and
    a route per doubling round, two per descent level and for the packed
    bottom, one for ISA, two for the suffix lengths."""
    L = min(ops_suffix._num_levels(nd), lvl_cap)
    rounds = max(L - 3, 0)
    top = min(lvl_static - 1, 3 + rounds)
    return 1 + 2 * rounds + 2 * (top - 2) + 2 + 1 + 2


def compile_sharded_dict_index(devices: list, nd: int, ne: int, w: int,
                               lvl_cap: int, lvl_static: int, seed_thr,
                               lcp_thr):
    """The sharded dict index over the mesh `devices`. Returns fn(ext,
    phrase_st, phrase_ln, d_starts, npz, total) -> (d, lcpD, isaD,
    grp_of_pos, grp_cross) on devices[0], matching ops/pfp._dict_index;
    the inputs are ops/pfp._host_prep's tensors, on any device. The name is
    the JAX module's: nothing is compiled here, so there is no cache.

    nd < 2^29 is the JAX module's bound (its int32 route-back keys reach
    3 * nd). The keys here are int64, so the bound is kept, not needed."""
    nshards = len(devices)
    assert nshards > 0 and nshards & (nshards - 1) == 0, \
        "shard count must be a power of two"
    assert nd % nshards == 0
    assert nd < (1 << 29), "routed-gather return keys reach 3*nd (int32)"
    assert seed_thr is not None and lcp_thr is not None, \
        "sharded dict requires the packed <=8-byte alphabet seed"
    assert lvl_static >= 4, "packed-bottom descent needs top level >= 3"
    Bd = nd // nshards
    L = min(ops_suffix._num_levels(nd), lvl_cap)
    shards = range(nshards)

    def sharded(ext, phrase_st, phrase_ln, d_starts, npz, total):
        tabs = pmesh.replicate(
            {"ext": ext, "phrase_st": phrase_st, "phrase_ln": phrase_ln,
             "d_starts": d_starts}, devices)
        idxl = [torch.arange(Bd, dtype=I32, device=dev) for dev in devices]
        idxg = [i * Bd + idxl[i] for i in shards]
        d, meta = [], []
        for i, dev in enumerate(devices):
            t = tabs[dev]
            di, mi = _block_dict_setup(
                i, t["ext"], t["phrase_st"], t["phrase_ln"], t["d_starts"],
                npz, total, Bd, nd, ne)
            d.append(di)
            meta.append(mi)
        del tabs

        # --- seed: exact 8-char 3-bit ranks from an 8-char next halo. A
        # slot past the global end is a zero byte and codes as 0, as in the
        # single-device seed
        nxt = _from_shard(d, 1, devices)
        dh = [torch.cat([d[i], nxt[i][:8]]) for i in shards]
        del nxt
        hist = [[], [], [], []]
        for i in shards:
            code = ops_suffix._codes(dh[i], seed_thr)
            rank8 = code[:Bd]
            for j in range(1, 8):
                rank8 = (rank8 << 3) | code[j: Bd + j]
            for row, val in zip(hist, (code[:Bd].clone(), rank8 >> 18,
                                       rank8 >> 12, rank8)):
                row.append(val)
        rank = hist[3]
        perm = [ops[1] for ops in _bitonic_block_sort(
            list(zip(rank, idxg)), devices, num_keys=1)]

        # --- doubling rounds (depth-capped)
        for lvl in range(4, L + 1):
            k = 1 << (lvl - 1)
            key2 = _shift_k(rank, k, devices, Bd, -1)
            srt = _bitonic_block_sort(list(zip(rank, key2, idxg)), devices,
                                      num_keys=2)
            del key2
            r1 = [ops[0] for ops in srt]
            r2 = [ops[1] for ops in srt]
            perm = [ops[2] for ops in srt]
            del srt
            p1 = _prev1(r1, devices, -2)
            p2 = _prev1(r2, devices, -2)
            local = []
            for i in shards:
                changed = ((r1[i] != p1[i]) | (r2[i] != p2[i])).to(I32)
                if i == 0:
                    changed[0] = 0
                local.append(torch.cumsum(changed, 0, dtype=I32))
            del r1, r2, p1, p2
            ex = _ex_prefix([loc[-1] for loc in local], devices)
            rank = _perm_route(perm, [local[i] + ex[i] for i in shards],
                               devices)
            del local
            hist.append(rank)

        saD = perm  # sorted-order blocks of text positions

        # --- LCP rank descent (one merged-stream routed gather per level)
        a = _prev1(saD, devices, 0)
        a[0][0] = saD[0][0]  # a[0] = sa[0], the single-device concat
        b = saD
        h = [torch.zeros(Bd, dtype=I32, device=dev) for dev in devices]
        top = min(lvl_static - 1, len(hist) - 1)
        del hist[top + 1:]

        def pair_gather(values, h):
            """(in-bounds mask, values[a + h], values[b + h]) per shard."""
            inb, addrs = [], []
            for i in shards:
                ia = a[i] + h[i]
                ib = b[i] + h[i]
                inb.append((ia < nd) & (ib < nd))
                addrs.append(torch.cat([torch.clamp(ia, max=nd - 1),
                                        torch.clamp(ib, max=nd - 1)]))
            got = _routed_gather(values, addrs, devices, Bd, nd)
            return inb, [g[:Bd] for g in got], [g[Bd:] for g in got]

        for lvl in range(top, 2, -1):
            inb, ga, gb = pair_gather(hist.pop(), h)
            h = [torch.where(inb[i] & (ga[i] == gb[i]), h[i] + (1 << lvl),
                             h[i]) for i in shards]
        del hist
        # packed 7-char bottom (ops/suffix._lcp_impl's bottom step)
        pack = []
        for i in shards:
            codeb = ops_suffix._codes(dh[i], lcp_thr)
            pk = codeb[:Bd] << 24
            for j in range(1, 7):
                pk = pk | (codeb[j: Bd + j] << (4 * (6 - j)))
            pack.append(pk)
        del dh
        inb, ga, gb = pair_gather(pack, h)
        del pack
        lcpD = []
        for i in shards:
            nc = torch.zeros(Bd, dtype=I32, device=devices[i])
            for kk in range(1, 8):
                s = 28 - 4 * kk
                nc += ((ga[i] >> s) == (gb[i] >> s)).to(I32)
            hi = torch.where(inb[i], h[i] + nc, h[i])
            # canonical zero-pad-class values
            # (ops/suffix.canonicalize_pad_lcp)
            both_pad = torch.minimum(a[i], saD[i]) >= total - 1
            canon = nd - torch.maximum(a[i], saD[i])
            lcpD.append(torch.where(both_pad, canon, hi))
        lcpD[0][0] = 0
        del inb, ga, gb, h, a, b

        # --- ISA (permutation route: the global rank at position sa)
        isaD = _perm_route(saD, idxg, devices)

        # --- groups (ops/pfp._dict_groups with cross-shard carries)
        suf_len = _routed_gather(meta, saD, devices, Bd, nd)
        del meta
        valid = [sl >= w for sl in suf_len]

        # gapmin: running min of lcpD that restarts after each valid row.
        # A shard's first segment reaches back into the shards before it:
        # the min over shards [max(last shard with a valid row, 0), i) of
        # their mins after the last valid row (the whole block where a
        # shard has none)
        tail_min, last_idx = [], []
        for i in shards:
            last = torch.where(valid[i], idxl[i], -1).max()
            tail = torch.where(idxl[i] > last, lcpD[i], IMAX).min()
            tail_min.append(tail)
            last_idx.append(last)
        dev0 = devices[0]
        hs = pmesh.all_gather([last >= 0 for last in last_idx], dev0)
        ts = pmesh.all_gather(tail_min, dev0)
        idxp = torch.arange(nshards, device=dev0)
        lastv = torch.clamp(_last_before(hs), min=0)
        span = (idxp[None, :] >= lastv[:, None]) & \
            (idxp[None, :] < idxp[:, None])
        carry_min = _scatter_scalars(
            torch.where(span, ts[None, :], IMAX).min(dim=1).values, devices)
        # the suffix length of the last valid row before this shard
        carry_len = _carry_last(
            [last >= 0 for last in last_idx],
            [suf_len[i][torch.clamp(last_idx[i], min=0)] for i in shards],
            devices, -1)

        new_group, ngl, cross = [], [], []
        for i in shards:
            gapmin = ops_pfp._segmented_min_after_valid(lcpD[i], valid[i])
            prev_cnt = torch.cumsum(valid[i], 0, dtype=I32) - valid[i].to(I32)
            gapmin = torch.where(prev_cnt == 0,
                                 torch.minimum(gapmin, carry_min[i]), gapmin)
            # previous valid row's suffix length (last-value fill + carry)
            last_valid = torch.cummax(
                torch.where(valid[i], idxl[i], -1), 0).values
            prev_valid = torch.cat([last_valid.new_full((1,), -1),
                                    last_valid[:-1]])
            prev_len = torch.where(
                prev_valid >= 0,
                suf_len[i][torch.clamp(prev_valid, min=0)], carry_len[i])
            same = valid[i] & (gapmin >= suf_len[i]) & \
                (prev_len == suf_len[i])
            ng = valid[i] & ~same
            new_group.append(ng)
            ngl.append(torch.cumsum(ng, 0, dtype=I32))
            cross.append(torch.where(ng, gapmin, 0))
        ex = _ex_prefix([c[-1] for c in ngl], devices)
        grp_of_row = [ngl[i] - 1 + ex[i] for i in shards]

        def gather(blocks):
            return torch.cat([blk.to(dev0) for blk in blocks])
        return (gather(d), gather(lcpD), gather(isaD), gather(saD),
                gather(valid), gather(new_group), gather(grp_of_row),
                gather(cross))

    def index(ext, phrase_st, phrase_ln, d_starts, npz, total):
        npz, total = int(npz), int(total)
        d, lcpD, isaD, saD, valid, new_group, grp_of_row, cross = sharded(
            ext, phrase_st, phrase_ln, d_starts, npz, total)
        # the tail on devices[0] (ops/pfp._dict_groups' end)
        grp_cross = torch.zeros(nd, dtype=I32, device=d.device)
        grp_cross[grp_of_row[new_group]] = cross[new_group]
        grp_cross[0] = 0
        grp_of_pos = ops_suffix.route_set(
            saD, torch.where(valid, grp_of_row, -1))
        return d, lcpD, isaD, grp_of_pos, grp_cross

    return index
