"""Partition-parallel scans: the MumemtoM partition scheme over a mesh of
devices, in PyTorch.

Port of mumemto_tpu/parallel/partition.py. The reference's only scale-out
mechanism is partition-merge ("MumemtoM", README.md:124-142): run the
finder independently per collection partition, then merge the candidate
sets. The JAX module writes that as one program over a device mesh with
the axes

  'part'  collection partitions (the reference's per-host runs)
  'seq'   sequence sharding inside one partition

and runs the per-partition index construction and interval scan under
vmap. Here a mesh is a small value (Mesh: a row-major grid of torch
devices, which may repeat) and the counterpart of vmap is a plain loop:
the scan has data-dependent sizes (torch.nonzero, the doubling's early
exit), so partition p runs on the first device of mesh row p % rows, one
partition after another on a device that holds several, and the results
are stacked on the mesh's first device. The sum over partitions is
parallel/mesh.psum.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mumemto_tpu_torch.ops import intervals as ops_intervals
from mumemto_tpu_torch.ops import pipeline as ops_pipeline
from mumemto_tpu_torch.ops import suffix as ops_suffix
from mumemto_tpu_torch.ops.suffix import I32
from mumemto_tpu_torch.parallel import mesh as pmesh


class Mesh(NamedTuple):
    """A grid of torch devices: `devices` row-major, `shape` its extents,
    `axis_names` one name per extent."""
    devices: tuple
    shape: tuple
    axis_names: tuple

    def part_device(self, p: int) -> torch.device:
        """The device of partition p: the first of mesh row p % rows."""
        row = len(self.devices) // self.shape[0]
        return self.devices[(p % self.shape[0]) * row]


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1D or 2D mesh: ('part',), or (n // 2, 2) with ('part', 'seq') for an
    even n >= 4. devices defaults to parallel/mesh.spread over the visible
    CUDA cards (n_devices of them, or as many as there are)."""
    if devices is None:
        count = n_devices if n_devices is not None else \
            max(torch.cuda.device_count(), 1)
        devices = pmesh.spread(count, "cuda")
    elif n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if n >= 4 and n % 2 == 0:
        shape, axes = (n // 2, 2), ("part", "seq")
    else:
        shape, axes = (n,), ("part",)
    return Mesh(tuple(torch.device(d) for d in devices), shape, axes)


def _on(device, a, dtype=None) -> torch.Tensor:
    """A tensor or anything numpy can read, as a tensor on `device`."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.ascontiguousarray(a))
    return a.to(device=device, dtype=dtype)


def _partition_index(text, doc_ends, num_docs: int, packed_init: bool):
    """(sa, lcp, bwt, da) of one partition's padded text: the direct
    backend (uncapped doubling, rank-descent LCP)."""
    n = text.shape[0]
    sa, hist, num_lvl = ops_suffix._suffix_array_impl(
        text, n, packed_init=packed_init)
    lcp = ops_suffix._lcp_impl(sa, hist, num_lvl, n)
    return sa, lcp, ops_suffix.bwt_of(text, sa), \
        ops_suffix.doc_array(sa, doc_ends, num_docs)


def _partition_scan(text, doc_ends, num_docs: int, min_match_len: int,
                    num_distinct: int):
    """Single-partition pipeline: index construction + MUM interval scan.
    Returns (match count, longest match length)."""
    n = text.shape[0]
    _sa, lcp, bwt, da = _partition_index(text, doc_ends, num_docs, False)
    res = ops_intervals.analyze_intervals(
        lcp, da, bwt, n, min_match_len, num_distinct, 0, 1)
    emit = res["emit"]
    count = emit.sum(dtype=I32)
    longest = torch.where(emit, res["L"], 0).max()
    return count, longest


def partitioned_step(texts, doc_ends, num_docs: int, min_match_len: int = 20,
                     num_distinct: int = 2, mesh: Mesh | None = None):
    """One step over a stack of partitions.

    texts: (num_partitions, n) uint8; doc_ends: (num_partitions, num_docs)
    end positions per partition; tensors or numpy arrays. With a mesh,
    partition p is scanned on mesh.part_device(p). Without one, tensors
    are scanned on their own device and numpy arrays on make_mesh(), the
    visible CUDA cards, which raises where there is none. Returns (total
    matches over all partitions, per-partition counts, per-partition
    longest match) on the first device."""
    nparts = len(texts)
    if mesh is None and not isinstance(texts, torch.Tensor):
        mesh = make_mesh()
    devs = [mesh.part_device(p) if mesh is not None else texts.device
            for p in range(nparts)]
    counts, longest = [], []
    for p, dev in enumerate(devs):
        c, lg = _partition_scan(
            _on(dev, texts[p], torch.uint8), _on(dev, doc_ends[p], I32),
            num_docs, min_match_len, num_distinct)
        counts.append(c)
        longest.append(lg)
    total = pmesh.psum(counts, devs[0])
    return total, pmesh.all_gather(counts, devs[0]), \
        pmesh.all_gather(longest, devs[0])


def compile_partitioned_step(mesh: Mesh, texts_shape, num_docs: int):
    """partitioned_step over `mesh` as fn(texts, doc_ends); the name and
    the unused texts_shape are the JAX module's, nothing is compiled."""
    def fn(texts, doc_ends):
        return partitioned_step(texts, doc_ends, num_docs, mesh=mesh)
    return fn


def _partition_scan_matches(text, doc_ends, num_docs: int,
                            min_match_len: int, num_distinct: int, M: int):
    """Per-partition scan returning the compacted match windows
    (ops/pipeline.compact_windows_mum's shape contract) and the whole
    match count, which may exceed M."""
    n = text.shape[0]
    sa, lcp, bwt, da = _partition_index(text, doc_ends, num_docs, True)
    # MUM mode (f = 1): F clamps to N * f (pfp_mum.hpp:194-196) and the
    # interval size is bounded by the doc count
    res = ops_intervals.analyze_intervals(
        lcp, da, bwt, n, min_match_len, num_distinct, num_docs, 1,
        size_cap=1 << max(int(num_docs).bit_length(), 2))
    res["sa"] = sa
    res["da"] = da
    count = res["emit"].sum(dtype=I32)
    res["emit"] = ops_pipeline._first_m(res["emit"], M)
    return (count, *ops_pipeline.compact_windows_mum(
        res, n, M, num_docs, num_docs))


class WindowCapacityError(RuntimeError):
    """A fixed-capacity match buffer (M) overflowed."""


def _check_capacity(emit_counts, M: int, what: str):
    """No silent caps: a compaction keeps at most M entries, so an emit
    count above M would drop matches. Verify from the counts and fail
    loudly with the needed capacity."""
    c = np.atleast_1d(np.asarray(emit_counts))
    worst = int(c.max()) if c.size else 0
    if worst > M:
        raise WindowCapacityError(
            f"{what}: {worst} matches exceed the window capacity "
            f"M={M}; rerun with M >= {worst}")


def compile_sharded_scan(mesh: Mesh, n: int, num_docs: int,
                         min_match_len: int = 20,
                         num_distinct: int | None = None, M: int = 4096):
    """Single-device scan of one collection's padded text (n chars), on
    the mesh's first device, as fn(text, doc_ends) -> (counts, s, e, L,
    w_sa, w_da): the compacted MUM windows of scan_collection, with
    counts = [emit, cand, BWT runs]; more than M matches raise
    WindowCapacityError.

    The JAX function leaves the split of the text over the mesh to XLA's
    automatic partitioner, which has no counterpart in PyTorch (and whose
    work is quadratic in n there); this one runs the scan whole on the
    mesh's first device. The sharded production route is parallel/seqpfp."""
    if num_distinct is None:
        num_distinct = num_docs
    dev = mesh.devices[0]

    def checked(text, doc_ends):
        res, counts = ops_pipeline.scan_collection(
            _on(dev, text, torch.uint8), _on(dev, doc_ends, I32), n,
            num_docs, min_match_len, num_distinct, num_docs, 1,
            size_cap=1 << max(int(num_docs).bit_length(), 2),
            need_ctx=False)
        _check_capacity(counts[0].cpu().numpy(), M, "sharded scan")
        return (counts, *ops_pipeline.compact_windows_mum(
            res, n, M, num_docs, num_docs))

    return checked


def compile_partitioned_matches(mesh: Mesh, num_docs: int, M: int = 4096,
                                min_match_len: int = 20,
                                num_distinct: int | None = None):
    """A partition-parallel step over `mesh` that returns the compacted
    matches per partition as fn(texts, doc_ends) -> (counts[P], s/e/L
    [P, M], w_sa/w_da [P, M, num_docs]) on the mesh's first device. The
    host then applies the writer transforms per partition
    (engine._emit_mums) and the MumemtoM merge. A partition with more than
    M matches raises WindowCapacityError."""
    if num_distinct is None:
        num_distinct = num_docs
    dev0 = mesh.devices[0]

    def checked(texts, doc_ends):
        outs = []
        for p in range(len(texts)):
            dev = mesh.part_device(p)
            outs.append(_partition_scan_matches(
                _on(dev, texts[p], torch.uint8), _on(dev, doc_ends[p], I32),
                num_docs, min_match_len, num_distinct, M))
        out = tuple(pmesh.all_gather([o[k] for o in outs], dev0)
                    for k in range(6))
        _check_capacity(out[0].cpu().numpy(), M, "partitioned match scan")
        return out

    return checked
