"""Sequence-parallel PFP scan: one collection's expansion row space sharded
over a mesh of devices, in PyTorch.

Port of mumemto_tpu/parallel/seqpfp.py. The PFP dictionary and parse
tables are metadata-sized (|D| + |P| << n for repetitive collections, the
point of PFP) and every device holds a copy; the O(n) row space (expansion
operands, the big 2-key sort, per-row LCP and the interval analysis) is
sharded. The mesh is a list of devices, one per shard, which may repeat
(parallel/mesh.py): each distinct device gets a host thread that runs its
shards in shard order while the other devices run theirs; on one card
every shard runs on it, one after another, on the caller's thread.

The scan is the block scan of parallel/widepfp.py (stages A-D with
explicit per-shard carries, linear total work). This module holds its
entry point, the block-bitonic sort (stage B) and the host assembly:

  stage B  the global 2-key sort as a block-bitonic sort: each shard sorts
           its block, then log2(P)*(log2(P)+1)/2 merge-split rounds
           exchange whole blocks with the bitonic partner and keep the
           lower or upper half of the merged pair. Deterministic, and
           block sizes never change.
  assembly the host merges the P small window sets by the reference's pop
           order (e asc, L desc); (e, L) identifies a canonical interval
           (ops/intervals._leftmost_mask), so the merge is unambiguous.

The JAX module's second formulation (one logical array program under the
SPMD partitioner, compile_seq_pfp_step) is a test oracle there, measured
quadratic in the row count, and is not ported; nor are its force_gspmd and
wide arguments. shard_dict=True (or MUMEMTO_SHARD_DICT=1) distributes the
dictionary index over the mesh too (parallel/sharddict.py).

Output bytes equal the single-device engine's across shard counts and
modes (tests/test_torch_seqpfp.py).
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

from mumemto_tpu_torch.ops import pfp as ops_pfp
from mumemto_tpu_torch.parallel import mesh as pmesh
from mumemto_tpu_torch.parallel.partition import _check_capacity


def sort_rounds(nshards: int) -> int:
    """Merge-split rounds of the block-bitonic sort over nshards blocks."""
    p = nshards.bit_length() - 1
    return p * (p + 1) // 2


def _bitonic_block_sort(blocks: list, devices: list,
                        num_keys: int = 2) -> list:
    """Globally sort equal blocks of a multi-operand row sequence, one
    block per shard: blocks[i] is shard i's operand tuple on devices[i],
    and the first num_keys operands are the keys (ops/pfp._sort_rows; the
    default is the expansion rows' (group id, parse rank)).

    The classic merge-split block-bitonic network (a block
    compare-exchange sorts the concatenated pair and keeps one half);
    every block stays sorted internally throughout, so the 0-1 principle
    applies at block granularity.

    Duplicate keys: both partners of a compare-exchange must sort the
    same sequence, or the two kept halves are not a partition. With tied
    keys (every pad row ties), stable-sorting [mine, partner] on one side
    and [partner, mine] on the other orders tied rows differently,
    doubling some rows and dropping others. So the lower shard id's block
    always comes first. Two partners on one device sort the pair once and
    take a half each.

    Execution (parallel/mesh.run_per_device): the first sorts run on each
    device's thread; then one thread per device walks the rounds, and in
    each round takes its side of every pair it is part of, in pair order.
    Partners on two devices meet twice: before they copy (each side's
    block of the last round is in place) and after (both copies are made,
    so each side may drop its pre-round block). A device thus holds one
    pair's copy at a time, as the serial network did.

    The sort takes the list over: each entry is replaced as its block is
    sorted, so no unsorted block outlives its sort, also where the caller
    still holds the list; the list is returned."""
    nshards = len(blocks)

    def first(i):
        blocks[i] = ops_pfp._sort_rows(blocks[i], num_keys)
    pmesh.run_per_device(first, range(nshards), devices)
    if nshards == 1:
        return blocks
    B = blocks[0][0].shape[0]

    def merged(lo_ops, hi_ops):
        return ops_pfp._sort_rows(tuple(
            torch.cat([a, b]) for a, b in zip(lo_ops, hi_ops)), num_keys)

    p = nshards.bit_length() - 1
    rounds = [(k, 1 << j) for k in range(1, p + 1)
              for j in range(k - 1, -1, -1)]
    pairs = [[(lo, lo | d, ((lo >> k) & 1) == 0)
              for lo in range(nshards) if not lo & d] for k, d in rounds]
    meet = {(r, lo): threading.Barrier(2)
            for r, rnd in enumerate(pairs) for lo, hi, _ in rnd
            if devices[lo] != devices[hi]}

    def walk(dev):
        for r, rnd in enumerate(pairs):
            for lo, hi, asc in rnd:
                # ascending pairs keep the lower half on the lower shard
                if devices[lo] == devices[hi]:
                    if devices[lo] == dev:
                        mrg = merged(blocks[lo], blocks[hi])
                        lower = tuple(a[:B] for a in mrg)
                        upper = tuple(a[B:] for a in mrg)
                        blocks[lo], blocks[hi] = (lower, upper) if asc \
                            else (upper, lower)
                        # the halves alone keep the merged pair alive: it
                        # goes once a later round has replaced both
                        del mrg, lower, upper
                    continue
                if dev not in (devices[lo], devices[hi]):
                    continue
                mine, other = (lo, hi) if devices[lo] == dev else (hi, lo)
                meet[r, lo].wait()
                # each side gets the other's block and sorts the pair
                copy = tuple(a.to(dev) for a in blocks[other])
                meet[r, lo].wait()
                pair = (blocks[lo], copy) if mine == lo else \
                    (copy, blocks[hi])
                blocks[mine] = None
                mrg = merged(*pair)
                del pair, copy
                keep_lower = asc == (mine == lo)
                blocks[mine] = tuple((a[:B] if keep_lower else a[B:]).clone()
                                     for a in mrg)
                del mrg

    cards = list(dict.fromkeys(devices))
    pmesh.run_per_device(walk, cards, cards, barriers=meet.values())
    return blocks


def find_matches_seq_sharded(rb, opts, devices: list, pfp_w: int = 10,
                             pfp_mod: int = 100, M: int = 4096,
                             parse_prefix: str | None = None,
                             shard_dict: bool | None = None, phase=None):
    """engine.find_matches over the mesh `devices` (one torch device per
    shard, parallel/mesh.seq_devices; PFP backend), with output bytes
    equal to the single-device engine's. parse_prefix resumes from
    PREFIX.dict/.parse (-p): checkpoint the parse once, scan sharded.

    The interval size cap must be bounded and at most 4096 (caps <= 128
    take the windowed analyzer, larger caps the probe-guarded walks,
    ops/intervals.py, whose touch set fits the size_cap + 1 halo). M is
    the per-shard capacity of the match windows; a shard with more
    matches raises WindowCapacityError naming the M that is needed.
    shard_dict builds the dictionary index distributed over the mesh
    (parallel/sharddict.py) instead of on devices[0] alone, with the same
    output; None reads the environment: MUMEMTO_SHARD_DICT=1 turns it on.
    `phase(name)` is called on the caller's thread after each stage
    (build_pfp or read_parse, dict_index, parse_side, operands, sort,
    analyze: stages C and D of every shard, assemble); without one,
    engine._phase_logger's hook is."""
    from mumemto_tpu_torch import engine
    from mumemto_tpu_torch.parallel import widepfp

    pmesh.check_shards(len(devices))
    if shard_dict is None:
        shard_dict = os.environ.get("MUMEMTO_SHARD_DICT") == "1"
    size_cap = engine.interval_size_cap(opts, rb.num_docs)
    if size_cap is None or size_cap > 4096:
        raise ValueError("seq-sharded scan requires a bounded interval "
                         "size cap (finite f/F or MUM mode)")
    if phase is None:
        phase = engine._phase_logger(devices)
    if parse_prefix:
        pfp = ops_pfp.pfp_from_parse_files(parse_prefix, devices[0], w=pfp_w)
        phase("read_parse")
    else:
        pfp = ops_pfp.build_pfp(rb.text, devices[0], w=pfp_w, mod=pfp_mod)
        phase("build_pfp")
    return widepfp.find_matches_wide(rb, opts, devices, M=M, pfp=pfp,
                                     phase=phase, shard_dict=shard_dict)


def _assemble_results(rb, opts, counts, win: dict, nshards: int, M: int):
    """Host-side merge of the per-shard windows (numpy arrays of
    nshards * M rows, shard-major) into MatchResults, through the
    single-device emitters (engine._emit_mums/_emit_mems/
    _merge_thresholds)."""
    from mumemto_tpu_torch import engine

    n_emit, n_cand, n_runs = (int(x) for x in counts)
    per_shard = win["count"]
    _check_capacity(per_shard, M, "seq-sharded scan")

    def rows(key, counts):
        """The real (count-limited) rows of every shard, concatenated."""
        a = win[key].reshape((nshards, M) + win[key].shape[1:])
        return np.concatenate(
            [a[i, :int(counts[i])] for i in range(nshards)])

    def shard_rows(key):
        return rows(key, per_shard)

    results = engine.MatchResults(opts=opts, num_docs=rb.num_docs)
    results.bwt_runs = n_runs
    results.text_length = int(rb.text.size) if rb.text is not None else \
        int(sum(rb.seq_lengths))
    doc_offsets, doc_lens = engine._doc_metadata(rb, opts)

    s = shard_rows("s")
    e = shard_rows("e")
    L = shard_rows("L")
    w_sa = shard_rows("w_sa")
    w_da = shard_rows("w_da").astype(np.int32)
    order = np.lexsort((-L, e))
    s, e, L, w_sa, w_da = s[order], e[order], L[order], w_sa[order], \
        w_da[order]
    W = w_sa.shape[1] if w_sa.ndim == 2 else 1
    valid = (s[:, None] + np.arange(W)) < e[:, None]
    if opts.mum_mode:
        engine._emit_mums(results, s, e, L, w_sa, w_da, valid, opts,
                          doc_offsets, doc_lens, rb.num_docs)
    else:
        keep = np.ones(s.size, dtype=bool)
        if opts.max_doc_freq != 1 and s.size:
            w_prev = shard_rows("w_prev")[order]
            unique = (valid & (w_prev < s[:, None])).sum(axis=1)
            keep = unique >= opts.num_distinct
        engine._emit_mems(results, s[keep], e[keep], L[keep],
                          w_sa[keep], w_da[keep], valid[keep], opts,
                          doc_offsets, doc_lens)
    if opts.merge:
        cand_per = win["cand_count"]
        _check_capacity(cand_per, M, "seq-sharded cand windows")

        def cand_rows(key):
            return rows(key, cand_per)

        ce, cL = cand_rows("c_e"), cand_rows("c_L")
        corder = np.lexsort((-cL, ce))
        engine._merge_thresholds(
            results, cand_rows("c_has0")[corder],
            cand_rows("c_sa0")[corder], cand_rows("c_prev")[corder],
            cand_rows("c_next")[corder], doc_offsets, doc_lens)
    return results
