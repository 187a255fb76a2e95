"""Block-sharded sequence-parallel PFP scan, in PyTorch.

Port of mumemto_tpu/parallel/widepfp.py, the default formulation of the
sharded scan (routing: seqpfp.find_matches_seq_sharded). The expansion row
space [0, nr) is cut into P equal blocks, one per shard of the mesh
(parallel/mesh.py: a list of devices which may repeat); the dictionary and
parse tables are small and every device holds a copy. Every scan over rows
is block-local with an explicit carry, so the total work is linear in the
row count at any shard count. As under the JAX module's shard_map, every
device works its own shards while the others work theirs: each distinct
device has a host thread (mesh.run_per_device), and the stages that read
another shard's rows (the sort's rounds, the halos) meet its thread first.

Stages:

  A  per-shard expansion operands from the replicated tables: the
     occurrence step-function fills restart at each block from the
     occurrence that straddles the block start,
     j0 = searchsorted(cumcnt, base) - 1 (delta scatter + cumsum or cummax
     + carry, all local).
  B  block-bitonic global sort by (group id, parse rank)
     (seqpfp._bitonic_block_sort); pads keep key1 = -1 and sort to the
     global front.
  C  halo exchange of the sorted operands (H = size_cap + 1 rows per
     side), then the per-row LCP and the interval analysis on the padded
     block in local pad coordinates. Every analyzer branch touches at most
     size_cap + 1 rows around a query row (caps <= 128: shifted compares;
     caps 129..4096: probe-guarded range-min walks, ops/intervals.py), so
     an interior shard's halos reproduce the global computation exactly.
     The edge halos are neutralized: shard 0's left halo becomes front
     pads (key1 = -1, lcp 0), and the last shard's right halo gets
     lcp = -1, so an interval still open at the global end closes into
     the halo and is dropped, which is the reference's rule for intervals
     open at the end of the stream.
  D  per-shard window compaction in pad coordinates; a shard owns the
     boundaries in its real region [H, H + B); outputs carry global rows.

Coordinates: global row ids and text positions are int64 values, indices
into a block are int32. The JAX module carries uint32 values with modular
arithmetic to pass 2^31 rows under a 32-bit index space; here int64 values
cost one wider sort operand (ssa) and need no modular reasoning, so the
in-block tests read 0 <= start - base < B. The single-device scan
(ops/pfp.pfp_scan) refuses row buckets of 2^31 or more, so this is the
one route past them; several cards hold what one card cannot (PERF.md
has the measured peaks).

The operands are the seven unpacked ones of ops/pfp._expand_operands; the
JAX module's packed (suffix length, BWT char, cross LCP) operand and its
pack-overflow error are a sort-width workaround with no counterpart here.
"""

from __future__ import annotations

import torch

from mumemto_tpu_torch.ops import intervals as ops_intervals
from mumemto_tpu_torch.ops import pfp as ops_pfp
from mumemto_tpu_torch.ops import pipeline as ops_pipeline
from mumemto_tpu_torch.ops.suffix import I32, I64
from mumemto_tpu_torch.parallel import mesh as pmesh
from mumemto_tpu_torch.parallel.seqpfp import _bitonic_block_sort


# ---------------------------------------------------------------------------
# stage A: per-shard expansion operands
# ---------------------------------------------------------------------------

def _block_fill(vals, loc, in_blk, j0p, B: int, dtype):
    """Step-function fill over one block: out[r] = vals[j] for the
    occurrence j covering global row base + r (ops/pfp._fill_per_occ with
    a block carry). loc are the local start rows of the occurrences
    in_blk selects; j0p (a 1-element tensor) is the last occurrence
    starting strictly before the block base, -1 if none: its value is the
    carry-in, and the scattered deltas telescope exactly from there
    (occurrences j0p+1.. all start in the block)."""
    vals = vals.to(dtype)
    delta = torch.cat([vals[:1], vals[1:] - vals[:-1]])
    acc = torch.zeros(B, dtype=dtype, device=vals.device)
    acc.index_add_(0, loc[in_blk], delta[in_blk])
    # a block of pads alone has j0p past the last slot: clamped, and its
    # rows are masked by the caller
    carry = torch.where(j0p < 0, 0,
                        vals[torch.clamp(j0p, 0, vals.shape[0] - 1)])
    return torch.cumsum(acc, 0, dtype=dtype) + carry


def _block_operands(base: int, parse, d_starts, cumcnt, m: int,
                    total_rows: int, n_text: int, isaP, grp_tab, doc_ends,
                    B: int, nd: int, w: int, num_docs: int):
    """Expansion operands of the global rows [base, base + B)
    (ops/pfp._expand_operands with a block base; the same identities, the
    same pad convention), on parse's device.

    Returns (key1, key2, ssa, suf_len, bwt, da, cross): key1/key2 are the
    sort keys; ssa is the int64 text position (equal to the global row id,
    the r == ssa tiling identity); the others are int32. cumcnt and
    doc_ends may be int32 or int64; total_rows, n_text and base are Python
    ints of any size. Pads (global row >= total_rows) get key1 = -1 and 0
    elsewhere, and sort to the global front."""
    dev = parse.device
    gr = base + torch.arange(B, dtype=I64, device=dev)
    cum = cumcnt.to(I64)
    mp1 = cum.shape[0]
    slots = torch.arange(mp1 - 1, dtype=I32, device=dev)

    # last occurrence starting strictly before the base (-1 if none)
    base_t = torch.full((1,), base, dtype=I64, device=dev)
    j0p = torch.searchsorted(cum, base_t, side="left") - 1
    starts = cum[:-1]
    rel = starts - base
    in_blk = (slots < m) & (rel >= 0) & (rel < B)
    loc = torch.where(in_blk, rel, B)

    # next occurrence boundary: cummax fill + the straddler's carry
    # (cum[j0p + 1] <= every in-block row's true boundary, and max is
    # idempotent, so a start that coincides with the base is harmless)
    nxt = torch.zeros(B, dtype=I64, device=dev)
    nxt.scatter_reduce_(0, loc[in_blk], cum[1:][in_blk], reduce="amax",
                        include_self=True)
    next_start = torch.maximum(torch.cummax(nxt, 0).values,
                               cum[torch.clamp(j0p + 1, 0, mp1 - 1)])
    pad = gr >= total_rows
    suf_len = torch.where(pad, 0, next_start + (w - 1) - gr).to(I32)

    # dict position: gr + c_j with the per-occurrence constant
    # c_j = d_starts[parse[j]] + 1 - cumcnt[j]
    pid_tab = parse[:mp1 - 1]
    c_occ = d_starts[pid_tab].to(I64) + 1 - starts
    dictpos = gr + _block_fill(c_occ, loc, in_blk, j0p, B, I64)

    # parse-order key: isaP of the next parse position
    k2_vals = torch.cat([isaP[1:mp1 - 1],
                         torch.zeros(1, dtype=I32, device=dev)])
    key2 = torch.where(pad, 0, _block_fill(k2_vals, loc, in_blk, j0p, B, I32))

    # doc id by text position: in-block boundary scatter + carry-in count
    de = doc_ends.to(I64)
    de_rel = de - base
    de_in = (de_rel >= 0) & (de_rel < B)
    bounds = torch.zeros(B, dtype=I32, device=dev)
    de_loc = de_rel[de_in]
    bounds.index_add_(0, de_loc, torch.ones_like(de_loc, dtype=I32))
    init_da = (de < base).sum(dtype=I32)
    da = torch.clamp(init_da + torch.cumsum(bounds, 0, dtype=I32),
                     max=num_docs)

    grp_col, prev_col, cross_col = grp_tab
    dp = torch.clamp(dictpos, 0, nd - 1)
    key1 = torch.where(pad, -1, grp_col[dp])
    bwt = torch.where(pad, 0, prev_col[dp])
    crossv = torch.where(pad, 0, cross_col[dp])
    ssa = torch.clamp(gr, max=n_text)
    return key1, key2, ssa, suf_len, bwt, da, crossv


# ---------------------------------------------------------------------------
# stage C: haloed per-row LCP + interval analysis (pad coordinates)
# ---------------------------------------------------------------------------

def _exchange_halos(blocks: list, H: int, devices: list) -> list:
    """The H rows each shard gets from either neighbour: out[i] =
    (left, right), each a tuple with one H-row tensor per operand, on
    devices[i]. blocks[i] is shard i's operand tuple. The edge shards
    receive wrapped rows, which _analyze_block neutralizes; one shard
    alone gets zeros. Each shard's thread copies its own halos in
    (parallel/mesh.run_per_device), after the sort's threads are
    joined."""
    nshards = len(blocks)
    if nshards == 1:
        z = tuple(torch.zeros(H, dtype=a.dtype, device=a.device)
                  for a in blocks[0])
        return [(z, z)]

    def pull(i):
        # copies: a halo must not keep its neighbour's whole block alive
        left, right = blocks[(i - 1) % nshards], blocks[(i + 1) % nshards]
        return (tuple(a[-H:].to(devices[i], copy=True) for a in left),
                tuple(a[:H].to(devices[i], copy=True) for a in right))
    return pmesh.run_per_device(pull, range(nshards), devices)


def _haloed(ops, halos):
    """[left halo | block | right halo] of every operand of one shard."""
    left, right = halos
    return tuple(torch.cat([l, a, r]) for l, a, r in zip(left, ops, right))


def _analyze_block(haloed_ops, slt_table, i: int, B: int, H: int,
                   nshards: int, w: int, num_docs: int, min_match_len: int,
                   num_distinct: int, max_total_freq: int, max_doc_freq: int,
                   size_cap: int, need_ctx: bool):
    """Per-shard LCP + interval analysis on shard i's haloed block (local
    pad coordinates 0..B+2H), as ops/pfp._analyze_sorted does on the whole
    row space; the edge-halo neutralization makes the local computation
    equal the global one for every boundary this shard owns (see the
    module docstring). Returns (res, (ssa_pad, da_pad), nruns_local)."""
    B2 = B + 2 * H
    key1, key2, ssa, sufs, bwts, da, cross = haloed_ops
    dev = key1.device
    pos = torch.arange(B2, dtype=I32, device=dev)
    first, last = i == 0, i == nshards - 1
    if first:
        # shard 0's left halo = front pads, inert like the bucket pads
        key1 = torch.where(pos < H, -1, key1)

    same_grp = torch.zeros(B2, dtype=torch.bool, device=dev)
    same_grp[1:] = key1[1:] == key1[:-1]
    prev_key2 = torch.cat([key2[:1], key2[:-1]])
    within = sufs - w + ops_pfp._rmq_query(
        slt_table, torch.minimum(prev_key2, key2) + 1,
        torch.maximum(prev_key2, key2))
    lcp = torch.where(same_grp, within, cross)
    lcp = torch.where(key1 < 0, 0, lcp).to(I32)
    if first:
        # the global first row's lcp is 0 (already so behind front pads,
        # unless the bucket has none)
        lcp[H] = 0
    if last:
        # rows past the global end must close and drop any interval that
        # reaches them: lcp = -1 is below every candidate L
        lcp[H + B:] = -1
    da = torch.where(key1 < 0, num_docs, da).to(I32)

    res = ops_intervals.analyze_intervals(
        lcp, da, bwts.to(torch.uint8), B2, min_match_len, num_distinct,
        max_total_freq, max_doc_freq, size_cap=size_cap, need_ctx=need_ctx)
    own = (pos >= H) & (pos < H + B)
    # ownership, and on the last shard the open-at-global-end drop: e on
    # the -1 halo row means e_global == nr, the open marker
    keep = own & (res["e"] < H + B) if last else own
    res["emit"] = res["emit"] & keep
    res["cand"] = res["cand"] & keep
    # BWT runs over the real global rows (the n/r stat): a run boundary at
    # pad coordinate q counts when rows q-1 and q are both real rows and
    # this shard owns q
    realrow = key1 >= 0
    chg = torch.zeros(B2, dtype=torch.bool, device=dev)
    chg[1:] = (bwts[1:] != bwts[:-1]) & realrow[1:] & realrow[:-1]
    nruns_local = (chg & own).sum(dtype=I32)
    return res, (ssa, da), nruns_local


# ---------------------------------------------------------------------------
# stage D: per-shard window compaction
# ---------------------------------------------------------------------------

def _compact_block(res, ssa_pad, da_pad, base: int, B: int, H: int, M: int,
                   num_docs: int, mem_mode: bool, need_ctx: bool) -> dict:
    """Stage D: pop-ordered window compaction in pad coordinates; the
    outputs carry int64 global rows. The halo width H = size_cap + 1
    exceeds the window width, so every window column stays inside the
    padded block. Every output has M rows; rows past `count` (and
    `cand_count`) are filler."""
    B2 = B + 2 * H
    W = H - 1  # = size_cap
    dev = ssa_pad.device

    def to_global(p_pad):
        return base + p_pad.to(I64) - H

    def window_cols(s):
        cols = s[:, None] + torch.arange(W, dtype=I32, device=dev)[None, :]
        return cols, torch.clamp(cols, 0, B2 - 1)

    idx = ops_pipeline._select_ordered(
        ops_pipeline._first_m(res["emit"], M), res["e"], res["L"], B2, M)
    s = res["s"][idx]
    _, colc = window_cols(s)
    out = {
        "count": res["emit"].sum(dtype=I32)[None],
        "s": to_global(s), "e": to_global(res["e"][idx]), "L": res["L"][idx],
        "w_sa": ssa_pad[colc],
        "w_da": da_pad[colc].to(ops_pipeline._da_dtype(num_docs)),
    }
    if mem_mode:
        # "no same-doc row within the padded block" (-1) means the true
        # previous occurrence, if any, lies below base - H < s, so the row
        # counts as its doc's first inside any interval
        prev = res["prev_same"]
        out["w_prev"] = torch.where(prev >= 0, to_global(prev), -1)[colc]
    if need_ctx:
        cidx = ops_pipeline._select_ordered(
            ops_pipeline._first_m(res["cand"], M), res["e"], res["L"], B2, M)
        cs = res["s"][cidx]
        ce = res["e"][cidx]
        cols, ccolc = window_cols(cs)
        is0 = (cols < ce[:, None]) & (da_pad[ccolc] == 0)
        first0 = torch.argmax(is0.to(torch.uint8), dim=1).to(I32)
        out.update({
            "cand_count": res["cand"].sum(dtype=I32)[None],
            "c_e": to_global(ce),
            "c_L": res["L"][cidx],
            "c_has0": is0.any(dim=1),
            "c_sa0": ssa_pad[torch.clamp(cs + first0, 0, B2 - 1)],
            "c_prev": res["prev_ctx"][cidx],
            "c_next": res["next_ctx"][cidx],
        })
    return out


# ---------------------------------------------------------------------------
# the sharded step + entry point
# ---------------------------------------------------------------------------

TABLES = ("parse", "d_starts", "cumcnt", "isaP", "d", "grp_of_pos",
          "grp_cross", "slt_table", "doc_ends")


def wide_step(prep: dict, devices: list, num_docs: int, min_match_len: int,
              num_distinct: int, max_total_freq: int, max_doc_freq: int,
              size_cap: int, need_ctx: bool, M: int, mem_mode: bool,
              phase=None):
    """The sharded scan (stages A-D) of a prepared collection
    (ops/pfp.pfp_scan_prepare) over the mesh `devices`, one shard per
    entry. Returns (counts, windows): counts = [emit, cand, BWT runs] over
    all shards on devices[0], windows the per-shard _compact_block dicts.
    Every stage runs through parallel/mesh.run_per_device, one thread per
    distinct device: a device's first shard copies the tables to it;
    stage A, the sort's rounds and the halo copies each run on every
    device at once; stages C and D run together for one shard, whose
    transients go before the device's next shard, so a device that holds
    several shards holds one block's transients at a time. `phase(name)`
    is called on the caller's thread after each stage (operands, sort,
    analyze: C and D)."""
    phase = phase or ops_pfp._noop_phase
    nshards = len(devices)
    nr, nd, w = prep["nr"], prep["nd"], prep["w"]
    assert nshards & (nshards - 1) == 0, "seq axis must be a power of two"
    assert nr % nshards == 0, "row bucket must divide the shard count"
    assert size_cap is not None and size_cap <= 4096, \
        "block scan requires a bounded interval size cap <= 4096"
    B = nr // nshards
    assert B < 2**31, "scan blocks must stay int32-indexable (add shards)"
    M = min(M, B)
    H = size_cap + 1
    assert H <= B, "shard blocks must cover one halo width"

    # each device's copy of the tables, made and read by its own thread
    tabs = {}

    def operands(i):
        dev = devices[i]
        if dev not in tabs:
            t = pmesh.place({k: prep[k] for k in TABLES}, dev)
            t["grp_tab"] = ops_pfp._grp_tab(t["d"], t["grp_of_pos"],
                                            t["grp_cross"], nd)
            tabs[dev] = t
        t = tabs[dev]
        return _block_operands(
            i * B, t["parse"], t["d_starts"], t["cumcnt"], prep["m"],
            prep["total_rows"], prep["n_text"], t["isaP"], t["grp_tab"],
            t["doc_ends"], B, nd, w, num_docs)
    blocks = pmesh.run_per_device(operands, range(nshards), devices)
    phase("operands")
    blocks = _bitonic_block_sort(blocks, devices)
    phase("sort")
    halos = _exchange_halos(blocks, H, devices)

    def analyze(i):
        haloed = _haloed(blocks[i], halos[i])
        blocks[i] = halos[i] = None
        res, (ssa_pad, da_pad), nruns_local = _analyze_block(
            haloed, tabs[devices[i]]["slt_table"], i, B, H, nshards, w,
            num_docs, min_match_len, num_distinct, max_total_freq,
            max_doc_freq, size_cap, need_ctx)
        del haloed
        window = _compact_block(res, ssa_pad, da_pad, i * B, B, H, M,
                                num_docs, mem_mode, need_ctx)
        return window, torch.stack([res["emit"].sum(dtype=I32),
                                    res["cand"].sum(dtype=I32), nruns_local])
    out = pmesh.run_per_device(analyze, range(nshards), devices)
    phase("analyze")
    windows = [wd for wd, _ in out]
    counts = pmesh.psum([c for _, c in out], devices[0])
    counts[2] += 1
    return counts, windows


def find_matches_wide(rb, opts, devices: list, pfp, M: int = 4096,
                      phase=None, shard_dict: bool = False):
    """engine.find_matches over the mesh `devices` (parallel/mesh.py), with
    output bytes equal to the single-device engine's. pfp: the collection's
    PFPData with ext on devices[0] (seqpfp.find_matches_seq_sharded, the
    entry point, builds or reloads it). shard_dict: build the dict index
    distributed over the same mesh (parallel/sharddict.py); its tables come
    back whole on devices[0], and the block stages take them unchanged."""
    from mumemto_tpu_torch import engine

    phase = phase or ops_pfp._noop_phase
    size_cap = engine.interval_size_cap(opts, rb.num_docs)
    if size_cap is None or size_cap > 4096:
        raise ValueError("block scan requires a bounded interval size "
                         "cap <= 4096 (finite f/F; collections up to "
                         "4096 docs in strict-MUM terms)")
    prep = ops_pfp.pfp_scan_prepare(
        pfp, rb.doc_ends, phase=phase,
        dict_devices=devices if shard_dict else None)
    nshards = len(devices)
    M = min(M, prep["nr"] // nshards)
    counts, windows = wide_step(
        prep, devices, rb.num_docs, opts.min_match_len, opts.num_distinct,
        opts.max_total_freq, opts.max_doc_freq, size_cap, opts.merge, M,
        mem_mode=not opts.mum_mode, phase=phase)
    results = _assemble_wide(rb, opts, counts, windows, nshards, M)
    phase("assemble")
    return results


def _assemble_wide(rb, opts, counts, windows: list, nshards: int, M: int):
    """Host-side merge: the per-shard windows as numpy arrays stacked
    shard-major, then the seqpfp assembly (shared emitters)."""
    from mumemto_tpu_torch.parallel import seqpfp

    win = {k: torch.cat([wd[k].cpu() for wd in windows]).numpy()
           for k in windows[0]}
    return seqpfp._assemble_results(rb, opts, counts.cpu().numpy(), win,
                                    nshards, M)
