"""The port's partition mesh program (parallel/partition) against
mumemto_tpu's on its 8-device CPU mesh and against the port's own
single-device engine.

The same numpy texts and doc ends (the generator of tests/test_partition.py)
go through both packages; the port's mesh is the CPU k times. Tolerance:
none. Counts, longest, and the first `count` rows of s, e, L are equal
exactly, w_sa and w_da at the window columns inside [s, e), and the emitted
bytes. The shapes (n = 4096 and 8192, 3 docs, M = 256 and 4) are shared
across cases, so XLA compiles each program once.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mumemto_tpu import options
from mumemto_tpu.parallel import partition as jax_partition
from mumemto_tpu_torch import engine as t_engine
from mumemto_tpu_torch.parallel import partition
from conftest import build, mutated_collection

torch.set_num_threads(2)

CPU = torch.device("cpu")
NUM_DOCS, N, M = 3, 4096, 256
_cache = {}


def _partition_inputs(n_part, num_docs=NUM_DOCS, n=N):
    texts = np.zeros((n_part, n), dtype=np.uint8)
    doc_ends = np.zeros((n_part, num_docs), dtype=np.int32)
    rbs = []
    for p in range(n_part):
        rb = build(mutated_collection(np.random.default_rng(1000 + p),
                                      num_docs, base_len=300))
        assert rb.text.size <= n
        texts[p, :rb.text.size] = rb.text
        doc_ends[p] = rb.doc_ends.astype(np.int32)
        rbs.append(rb)
    return texts, doc_ends, rbs


def _jax_matches():
    """The JAX program's outputs on its 4 x 2 mesh, computed once."""
    if "matches" not in _cache:
        mesh = jax_partition.make_mesh(8)
        texts, doc_ends, rbs = _partition_inputs(mesh.shape["part"])
        fn = jax_partition.compile_partitioned_matches(mesh, NUM_DOCS, M=M)
        out = [np.asarray(x) for x in fn(jnp.asarray(texts),
                                         jnp.asarray(doc_ends))]
        _cache["matches"] = (texts, doc_ends, rbs, out)
    return _cache["matches"]


def _emitted(rb, count, s, e, L, w_sa, w_da):
    """The windows through the writer, as tests/test_partition.py does."""
    m = int(count)
    opts = options.normalize(NUM_DOCS, quiet=True)
    results = t_engine.MatchResults(opts=opts, num_docs=NUM_DOCS)
    doc_offsets, doc_lens = t_engine._doc_metadata(rb, opts)
    valid = (s[:m, None] + np.arange(NUM_DOCS)) < e[:m, None]
    t_engine._emit_mums(results, s[:m], e[:m], L[:m], w_sa[:m],
                        w_da[:m].astype(np.int32), valid, opts, doc_offsets,
                        doc_lens, NUM_DOCS)
    want = t_engine.find_matches(rb, opts, backend="direct", device="cpu")
    assert len(results.lengths) == want.num_matches
    return results.output_bytes(), want.output_bytes()


def _same_windows(want, got, label):
    cw, sw, ew, Lw, saw, daw = want
    cg, sg, eg, Lg, sag, dag = got
    m = int(cw)
    assert int(cg) == m > 0, label
    for a, b in ((sw, sg), (ew, eg), (Lw, Lg)):
        assert np.array_equal(a[:m], b[:m]), label
    valid = (sw[:m, None] + np.arange(saw.shape[1])) < ew[:m, None]
    assert np.array_equal(saw[:m][valid], sag[:m][valid]), label
    assert np.array_equal(daw[:m][valid], dag[:m][valid]), label


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_make_mesh_matches_jax(n):
    want = jax_partition.make_mesh(n)
    got = partition.make_mesh(devices=[CPU] * n)
    assert got.shape == tuple(want.shape.values())
    assert got.axis_names == tuple(want.axis_names)
    assert len(got.devices) == n
    assert partition.make_mesh(n, devices=[CPU] * 8).shape == got.shape
    rows = got.shape[0]
    assert got.part_device(rows + 1) == got.part_device(1 % rows) == CPU


def test_make_mesh_rows_and_default():
    two = [CPU, torch.device("cpu", 0)]
    mesh = partition.make_mesh(devices=two * 2)      # 2 x 2
    assert mesh.shape == (2, 2) and mesh.axis_names == ("part", "seq")
    # partition p on devices[p % 4]: every device of the mesh gets some
    assert [mesh.part_device(p) for p in range(5)] == two * 2 + [CPU]
    mesh = partition.make_mesh(devices=two)          # (2,)
    assert [mesh.part_device(p) for p in range(3)] == [two[0], two[1], two[0]]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        partition.make_mesh(2)


@pytest.mark.parametrize("k", [1, 2, 8])
def test_partitioned_matches_equal_jax_and_engine(k):
    texts, doc_ends, rbs, want = _jax_matches()
    mesh = partition.make_mesh(devices=[CPU] * k)
    fn = partition.compile_partitioned_matches(mesh, NUM_DOCS, M=M)
    got = [x.numpy() for x in fn(texts, doc_ends)]
    assert got[0].shape == (4,) and got[1].shape == (4, M)
    assert got[4].shape == got[5].shape == (4, M, NUM_DOCS)
    assert got[0].tolist() == want[0].tolist()
    for p in range(4):
        _same_windows([a[p] for a in want], [a[p] for a in got], p)
        mine, engine_bytes = _emitted(rbs[p], *(a[p] for a in got))
        assert mine == engine_bytes != b"", p


def test_partitioned_matches_take_tensors_and_two_devices():
    texts, doc_ends, _rbs, want = _jax_matches()
    mesh = partition.make_mesh(devices=[CPU, torch.device("cpu", 0)])
    fn = partition.compile_partitioned_matches(mesh, NUM_DOCS, M=M)
    got = [x.numpy() for x in fn(torch.from_numpy(texts),
                                 torch.from_numpy(doc_ends))]
    for p in range(4):
        _same_windows([a[p] for a in want], [a[p] for a in got], p)


def test_partitioned_step_equals_jax():
    texts, doc_ends, _rbs, matches = _jax_matches()
    jmesh = jax_partition.make_mesh(8)
    want = [np.asarray(x) for x in jax_partition.compile_partitioned_step(
        jmesh, texts.shape, NUM_DOCS)(jnp.asarray(texts),
                                      jnp.asarray(doc_ends))]
    mesh = partition.make_mesh(devices=[CPU] * 4)
    total, counts, longest = partition.compile_partitioned_step(
        mesh, texts.shape, NUM_DOCS)(texts, doc_ends)
    assert int(total) == int(want[0]) == int(counts.sum()) > 0
    assert counts.tolist() == want[1].tolist()
    assert longest.tolist() == want[2].tolist()
    # without a mesh: on the texts' own device
    again = partition.partitioned_step(torch.from_numpy(texts),
                                       torch.from_numpy(doc_ends), NUM_DOCS)
    assert int(again[0]) == int(total)
    # the step's num_distinct is 2, the match program's is all 3 docs
    strict = partition.partitioned_step(texts, doc_ends, NUM_DOCS,
                                        num_distinct=NUM_DOCS, mesh=mesh)[1]
    assert strict.tolist() == matches[0].tolist()
    # numpy arrays and no mesh: the cards, never silently the CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            partition.partitioned_step(texts, doc_ends, NUM_DOCS)


def _one_collection(n=8192):
    rb = build(mutated_collection(np.random.default_rng(7), NUM_DOCS,
                                  base_len=900))
    text = np.zeros(n, dtype=np.uint8)
    text[:rb.text.size] = rb.text
    return rb, text, n


def test_sharded_scan_equals_jax_and_engine():
    rb, text, n = _one_collection()
    jmesh = jax.sharding.Mesh(np.asarray(jax.devices()), ("seq",))
    want = [np.asarray(x) for x in jax_partition.compile_sharded_scan(
        jmesh, n, NUM_DOCS, M=M)(jnp.asarray(text),
                                 jnp.asarray(rb.doc_ends, dtype=jnp.int32))]
    mesh = partition.make_mesh(devices=[CPU] * 8)
    got = [x.numpy() for x in partition.compile_sharded_scan(
        mesh, n, NUM_DOCS, M=M)(text, rb.doc_ends.astype(np.int32))]
    assert got[0].tolist() == want[0].tolist()
    _same_windows([want[0][0], *want[1:]], [got[0][0], *got[1:]], "scan")
    mine, engine_bytes = _emitted(rb, got[0][0], *got[1:])
    assert mine == engine_bytes != b""
    # equal to row 0 of a one-partition match program on the same text
    row = [x.numpy()[0] for x in partition.compile_partitioned_matches(
        mesh, NUM_DOCS, M=M)(text[None], rb.doc_ends[None].astype(np.int32))]
    _same_windows([got[0][0], *got[1:]], row, "row 0")


def test_window_capacity_overflow_raises():
    """More matches than M: both functions fail loudly in both packages,
    naming the M that is needed."""
    rb, text, n = _one_collection()
    jmesh = jax.sharding.Mesh(np.asarray(jax.devices()), ("seq",))
    with pytest.raises(jax_partition.WindowCapacityError, match="M=4"):
        jax_partition.compile_sharded_scan(jmesh, n, NUM_DOCS, M=4)(
            jnp.asarray(text), jnp.asarray(rb.doc_ends, dtype=jnp.int32))
    mesh = partition.make_mesh(devices=[CPU] * 8)
    with pytest.raises(partition.WindowCapacityError,
                       match="sharded scan: .* M=4; rerun with M >="):
        partition.compile_sharded_scan(mesh, n, NUM_DOCS, M=4)(
            text, rb.doc_ends.astype(np.int32))
    texts, doc_ends, _rbs, want = _jax_matches()
    pm = jax_partition.make_mesh(8)
    with pytest.raises(jax_partition.WindowCapacityError, match="M=4"):
        jax_partition.compile_partitioned_matches(pm, NUM_DOCS, M=4)(
            jnp.asarray(texts), jnp.asarray(doc_ends))
    with pytest.raises(partition.WindowCapacityError,
                       match=f"partitioned match scan: {want[0].max()} "
                             "matches .* M=4"):
        partition.compile_partitioned_matches(mesh, NUM_DOCS, M=4)(
            texts, doc_ends)


@pytest.mark.gpu
def test_cuda_partitioned_matches_equal_cpu():
    """The match program on the visible cards (mesh rows round-robin over
    them) against the CPU mesh, window for window."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    texts, doc_ends, rbs = _partition_inputs(4)
    want = [x.numpy() for x in partition.compile_partitioned_matches(
        partition.make_mesh(devices=[CPU] * 4), NUM_DOCS, M=M)(
            texts, doc_ends)]
    mesh = partition.make_mesh(4)
    assert all(d.type == "cuda" for d in mesh.devices)
    got = [x.cpu().numpy() for x in partition.compile_partitioned_matches(
        mesh, NUM_DOCS, M=M)(texts, doc_ends)]
    for p in range(4):
        _same_windows([a[p] for a in want], [a[p] for a in got], p)
        mine, engine_bytes = _emitted(rbs[p], *(a[p] for a in got))
        assert mine == engine_bytes != b""
