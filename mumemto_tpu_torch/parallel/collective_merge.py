"""Collective (device-side) MumemtoM anchor merge, in PyTorch.

Port of mumemto_tpu/parallel/collective_merge.py. The reference's anchor
merge is a sequential left-fold over partition files
(src/merge_candidates.cpp:211-219; fold core :106-157). Here each
partition's anchor metadata (MUM bitvector, lengths, thresholds) is placed
on the mesh's devices (parallel/mesh.py), gathered once, and the merge scan
runs as a vectorized zip over anchor positions on a device.

Key reduction (by induction over the fold): the fold's future behaviour
depends only on the dense per-anchor-position state

    bv[p]      a merged MUM starts at anchor position p
    len_at[p]  its length (0 if none)
    nb[p]      merged next-best threshold

because the fold's searchsorted/delta arithmetic reads only the anchor
column of the offsets, and anchor starts and trims are position-local. The
other offset columns are path-independent given the final (p, L): '+'
columns accumulate left trims summing to p - original_start, '-' columns
right trims summing to (len_k - delta_k) - L. So the device fold carries
three dense arrays per partition, and the host recomposes the full offset
and strand matrices afterwards from the original partitions, with bytes
equal to analysis/merge.anchor_merge (tests/test_torch_collective_merge.py).

The fold is elementwise over anchor positions plus a running max and a
gather per side and step: O(P * n_anchor) device work, and one all_gather
as the only communication.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from mumemto_tpu_torch import formats
from mumemto_tpu_torch.analysis import merge as host_merge
from mumemto_tpu_torch.analysis.mumdata import MUMdata
from mumemto_tpu_torch.kernels import scan
from mumemto_tpu_torch.ops.suffix import I32
from mumemto_tpu_torch.parallel import mesh as pmesh

MIN_MERGE_LEN = host_merge.MIN_MERGE_LEN


def _fold_pair(state, part):
    """One anchor-merge fold on dense device arrays
    (merge_candidates.cpp:106-157 as a vectorized zip over positions)."""
    bv1, nb1, len1 = state
    bv2, nb2, len2 = part
    n = bv1.shape[0]
    idx = torch.arange(n, dtype=I32, device=bv1.device)

    both = (nb1 > 0) & (nb2 > 0)
    new_nb = torch.where(both, torch.maximum(nb1, nb2), 0)
    check = (bv1 | bv2) & both

    def side(bv, len_at):
        # current MUM at p = last start <= p (the searchsorted-right - 1)
        cur = scan.running_max(torch.where(bv, idx, -1))
        delta = idx - cur
        cur_len = len_at[torch.clamp(cur, min=0)]
        covered = (cur >= 0) & (delta <= cur_len)
        return covered, cur_len - delta

    cov1, s1 = side(bv1, len1)
    cov2, s2 = side(bv2, len2)
    new_len = torch.minimum(s1, s2)
    emit = (check & cov1 & cov2 & (new_len > new_nb)
            & (new_len >= MIN_MERGE_LEN))
    return emit, new_nb, torch.where(emit, new_len, 0)


def _fold_all(bv_all, nb_all, len_all):
    """Left-fold partitions 0..P-1 (stacked (P, n_anchor) tensors).

    Also returns the intermediate state bitvectors, one per fold: the host
    needs them to trace each final MUM's emit-position chain back through
    the folds. With overlapping anchor MUMs, the originating MUM in
    partition k is its cover at the fold-k emit position, which can differ
    from its cover at the final position."""
    state = (bv_all[0], nb_all[0], len_all[0])
    inter_bv = []
    for k in range(1, bv_all.shape[0]):
        state = _fold_pair(state, (bv_all[k], nb_all[k], len_all[k]))
        inter_bv.append(state[0])
    inter = torch.stack(inter_bv) if inter_bv else \
        torch.zeros((0,) + bv_all.shape[1:], dtype=torch.bool,
                    device=bv_all.device)
    return state + (inter,)


def collective_fold(bv_all, nb_all, len_all, devices: list):
    """The collective fold of numpy (P, n_anchor) stacks (the JAX
    module's compile_collective_merge, with no compile step): partition k's
    three arrays are placed on devices[k], one all_gather brings them to
    devices[0], and the fold runs there. Returns the final
    (bv, nb, len_at) and the intermediate bitvectors, as tensors on
    devices[0]."""
    def place(stack):
        return pmesh.all_gather(
            [torch.from_numpy(row).to(dev)
             for row, dev in zip(stack, devices)], devices[0])
    return _fold_all(place(bv_all), place(nb_all), place(len_all))


def _dense_arrays(parts, n_anchor: int):
    """Per-partition dense (bv, nb, len_at) stacks from parse_candidate
    tuples. len_at's last-write-wins matches the host's
    searchsorted-right - 1 pick among equal starts."""
    n_parts = len(parts)
    bv_all = np.zeros((n_parts, n_anchor), dtype=bool)
    nb_all = np.zeros((n_parts, n_anchor), dtype=np.int32)
    len_all = np.zeros((n_parts, n_anchor), dtype=np.int32)
    for k, (lengths, starts, _strands, bv, nb) in enumerate(parts):
        if nb.size != n_anchor:
            raise ValueError("anchor length mismatch across partitions")
        # the device fold runs in int32 while the host fold it must match
        # byte for byte runs in int64: refuse, rather than wrap silently,
        # thresholds and lengths past int32
        if nb.size and (int(np.max(nb)) >= 2**31
                        or (lengths.size and int(np.max(lengths)) >= 2**31)):
            raise ValueError(
                f"partition {k}: anchor thresholds/lengths >= 2^31 exceed "
                "the collective fold's int32 operands — use the host fold "
                "(merge without --collective)")
        bv_all[k] = bv
        nb_all[k] = nb
        len_all[k, starts[:, 0]] = lengths
    return bv_all, nb_all, len_all


def _recompose(parts, inter_bv, pos, lengths):
    """Full offset/strand matrices for merged MUMs at anchor positions
    `pos` with final `lengths`, from the original partitions.

    The originating MUM of partition j is its cover at the fold-j emit
    position i_j, traced right to left through the intermediate state
    bitvectors: i_{P-1} = pos; i_{j-1} = state_{j-1}-cover(i_j). Offsets
    are then path-independent (trims telescope): '+' columns shift by
    pos - start, '-' columns by (len - (pos - start)) - L."""
    n_parts = len(parts)
    m = [None] * n_parts
    i = pos.copy()
    for j in range(n_parts - 1, 0, -1):
        sj = parts[j][1][:, 0]
        m[j] = np.searchsorted(sj, i, side="right") - 1
        # state_{j-1}: after fold j-1 (inter_bv[j-2]) or partition 0's bv
        state_pos = np.flatnonzero(inter_bv[j - 2]) if j >= 2 else \
            np.flatnonzero(parts[0][3])
        i = state_pos[np.searchsorted(state_pos, i, side="right") - 1] \
            if i.size else i
    m[0] = np.searchsorted(parts[0][1][:, 0], i, side="right") - 1

    out_starts = []
    out_strands = []
    for k, (lk, sk, tk, _bv, _nb) in enumerate(parts):
        mk = m[k]
        delta = pos - sk[mk, 0]
        trim_minus = (lk[mk] - delta) - lengths
        off = sk[mk] + np.where(tk[mk], delta[:, None],
                                trim_minus[:, None])
        cols = slice(None) if k == 0 else slice(1, None)
        out_starts.append(off[:, cols])
        out_strands.append(tk[mk][:, cols])
    return (np.concatenate(out_starts, axis=1),
            np.concatenate(out_strands, axis=1))


def collective_anchor_merge(mum_files, output: str, device="cuda",
                            verbose: bool = False) -> str:
    """Drop-in analysis/merge.anchor_merge with the fold on `device`: the
    partitions are spread over the visible cards round-robin (mesh.spread;
    on one card, or on the CPU, every partition lies on that device) and
    folded on the first."""
    parts = [host_merge.parse_candidate(p) for p in mum_files]
    n_anchor = parts[0][4].size
    n_parts = len(parts)
    devices = pmesh.spread(n_parts, device)
    if verbose:
        print(f"collective anchor merge: {n_parts} partitions x "
              f"{n_anchor} anchor positions on "
              f"{len(set(devices))} device(s)", file=sys.stderr)

    bv_all, nb_all, len_all = _dense_arrays(parts, n_anchor)
    bv_f, nb_f, len_f, inter_bv = (
        t.cpu().numpy()
        for t in collective_fold(bv_all, nb_all, len_all, devices))
    nb_f = nb_f.astype(np.int64)

    pos = np.flatnonzero(bv_f)
    lengths = len_f[pos].astype(np.int64)
    starts, strands = _recompose(parts, inter_bv, pos, lengths)

    out_path = output
    if not out_path.endswith((".mums", ".bumbl")):
        out_path += ".mums"
    base = out_path[:-6] if out_path.endswith(".bumbl") else out_path[:-5]
    md = MUMdata.from_arrays(lengths.astype(np.uint32), starts, strands)
    if out_path.endswith(".bumbl"):
        md.write_bums(out_path)
    else:
        md.write_mums(out_path)
    formats.write_thresh(base + ".athresh", nb_f)
    return out_path
