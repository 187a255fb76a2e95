"""The port's sharded dictionary index (parallel/sharddict) against its
single-device index, against mumemto_tpu's sharded index and against both
packages' _dict_index.

The port runs on torch-CPU, every shard on the one CPU device (or on its
two names "cpu" and "cpu:0", which the mesh treats as two devices, so the
cross-device branches run); JAX runs on its 8-device CPU mesh. Inputs come
from seeded numpy generators at the sizes of tests/test_sharddict.py.
Tolerance: none. d, grp_of_pos and grp_cross are equal exactly, isaD at
whole-phrase starts (never tied), isaD and lcpD in the form their
consumers read (torch_dict_form.dict_consumer_form: the order through each
phrase separator and the LCPs of suffixes that differ before it; the
port's single-device doubling stops at the separators, the sharded one and
the JAX package's at 2^lvl_cap characters), and the output bytes exactly.
"""

import numpy as np
import pytest
import torch

import jax

from mumemto_tpu import engine as jax_engine
from mumemto_tpu import options
from mumemto_tpu.ops import pfp as jax_pfp
from mumemto_tpu.parallel import sharddict as jax_sharddict
from mumemto_tpu_torch import convert
from mumemto_tpu_torch import engine as t_engine
from mumemto_tpu_torch.ops import pfp as t_pfp
from mumemto_tpu_torch.parallel import mesh, seqpfp, sharddict
from conftest import build, mutated_collection, rand_seq
from torch_dict_form import dict_consumer_form

# several test workers share the machine's cores
torch.set_num_threads(2)

CPU = torch.device("cpu")
SHARDS = [1, 2, 4, 8]


def _devices(nshards, two=False):
    """The CPU nshards times, or its two names alternating (unequal as
    torch devices, so blocks, halos and carries cross "devices")."""
    return [torch.device("cpu", 0) if two and i % 2 else CPU
            for i in range(nshards)]


def _meshes():
    return [(n, False) for n in SHARDS] + [(4, True)]


def _blocks(a, nshards, devices):
    B = a.shape[0] // nshards
    return [torch.from_numpy(a[i * B:(i + 1) * B].copy()).to(devices[i])
            for i in range(nshards)]


def _cat(blocks):
    return np.concatenate([b.cpu().numpy() for b in blocks])


# ---------------------------------------------------------------------------
# (a) the cross-shard primitives against numpy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nshards,two", _meshes())
def test_scalar_carries(nshards, two):
    devices = _devices(nshards, two)
    g = np.random.default_rng(3)
    vals = g.integers(0, 50, nshards).astype(np.int32)
    has = g.integers(0, 2, nshards).astype(bool)
    scal = [torch.tensor(v, device=d) for v, d in zip(vals, devices)]
    hs = [torch.tensor(bool(h), device=d) for h, d in zip(has, devices)]
    ex = sharddict._ex_prefix(scal, devices)
    assert [int(x) for x in ex] == (np.cumsum(vals) - vals).tolist()
    got = sharddict._carry_last(hs, scal, devices, -7)
    want = [next((int(vals[j]) for j in range(i - 1, -1, -1) if has[j]), -7)
            for i in range(nshards)]
    assert [int(x) for x in got] == want


@pytest.mark.parametrize("nshards,two", _meshes())
def test_block_moves(nshards, two):
    """_from_shard, _shift_k (the fill past the global end is part of the
    result) and _prev1."""
    devices = _devices(nshards, two)
    Bd = 12
    n = nshards * Bd
    a = np.random.default_rng(5).integers(1, 99, n).astype(np.int32)
    blocks = _blocks(a, nshards, devices)
    for j in (0, 1, 2, nshards, nshards + 3):
        got = _cat(sharddict._from_shard(blocks, j, devices))
        want = np.concatenate([a[j * Bd:], np.zeros(min(j * Bd, n), np.int32)])
        assert np.array_equal(got, want), j
    for k in (0, 1, 5, Bd, Bd + 1, 2 * Bd + 7, n - 1, n, 4 * n):
        out = sharddict._shift_k(blocks, k, devices, Bd, -1)
        want = np.concatenate([a[k:], np.full(min(k, n), -1, np.int32)])
        assert np.array_equal(_cat(out), want), k
    u8 = _blocks(a.astype(np.uint8), nshards, devices)
    got = _cat(sharddict._shift_k(u8, Bd, devices, Bd, 0))
    assert got.dtype == np.uint8
    assert np.array_equal(got, np.concatenate([a[Bd:], np.zeros(Bd)]))
    got = _cat(sharddict._prev1(blocks, devices, -2))
    assert np.array_equal(got, np.concatenate([[-2], a[:-1]]))


@pytest.mark.parametrize("nshards,two", _meshes())
def test_perm_route_and_routed_gather(nshards, two):
    devices = _devices(nshards, two)
    Bd = 16
    nd = nshards * Bd
    g = np.random.default_rng(9)
    perm = g.permutation(nd).astype(np.int32)
    payload = g.integers(0, 1000, nd).astype(np.int32)
    got = _cat(sharddict._perm_route(_blocks(perm, nshards, devices),
                                     _blocks(payload, nshards, devices),
                                     devices))
    want = np.empty(nd, np.int32)
    want[perm] = payload
    assert np.array_equal(got, want)

    values = g.integers(0, 1 << 28, nd).astype(np.int32)
    for q in (1, 2):
        # repeated addresses, some never asked for, some out of range
        addrs = g.integers(-3, nd + 3, nshards * q * Bd).astype(np.int32)
        addrs[:5] = 0
        addrs[-5:] = nd - 1
        out = sharddict._routed_gather(
            _blocks(values, nshards, devices),
            _blocks(addrs, nshards, devices), devices, Bd, nd)
        assert [o.shape[0] for o in out] == [q * Bd] * nshards
        assert np.array_equal(_cat(out), values[np.clip(addrs, 0, nd - 1)])


@pytest.mark.parametrize("num_keys", [1, 2])
def test_block_sort_keys(num_keys):
    """One key (int64 stream keys up to 3 * nd) and two (rank, key2 with
    -1): globally ascending, every row exactly once."""
    nshards, B = 4, 40
    n = nshards * B
    g = np.random.default_rng(11)
    k1 = g.integers(0, 6, n).astype(np.int64 if num_keys == 1 else np.int32)
    if num_keys == 1:
        k1 = k1 * (1 << 29)
    k2 = g.integers(-1, 3, n).astype(np.int32)
    row = np.arange(n, dtype=np.int32)
    devices = _devices(nshards, True)
    cols = (k1, row) if num_keys == 1 else (k1, k2, row)
    blocks = [tuple(torch.from_numpy(a[i * B:(i + 1) * B].copy()).to(
        devices[i]) for a in cols) for i in range(nshards)]
    out = seqpfp._bitonic_block_sort(blocks, devices, num_keys=num_keys)
    got = [np.concatenate([b[k].numpy() for b in out])
           for k in range(len(cols))]
    rows = got[-1]
    assert np.array_equal(np.sort(rows), row)
    for a, b in zip(cols, got):
        assert np.array_equal(a[rows], b)
    key = got[0].astype(np.int64) if num_keys == 1 else \
        (got[0].astype(np.int64) << 32) + got[1] + 1
    assert (np.diff(key) >= 0).all()
    with pytest.raises(ValueError, match="num_keys must be 1 or 2"):
        seqpfp._bitonic_block_sort(blocks, devices, num_keys=3)


# ---------------------------------------------------------------------------
# (b), (c) the block D and the index tables
# ---------------------------------------------------------------------------

def _prepared(docs):
    """One collection parsed and host-prepared by the JAX package, carried
    into the port: (jax pfp, jax host prep, arrays, static, the position
    of D's terminator, the D starts of the real phrases)."""
    rb = build(docs)
    pfp = jax_pfp.build_pfp(rb.text, w=10, mod=100)
    h = jax_pfp._host_prep(pfp, rb.doc_ends, rb.num_docs)
    arrays, static = convert.from_jax_dict_args(pfp, h, CPU)
    d_starts = np.asarray(h["d_starts"])[1:int(h["npz"]) + 1]
    return pfp, h, arrays, static, int(h["total_real"]), d_starts


def _jax_tables(pfp, h, nshards=None):
    arrs = (pfp.ext, h["phrase_st"], h["phrase_ln"], h["d_starts"],
            h["npz"], h["total_real"])
    static = (h["nd"], h["ne"], h["w"], h["lvl_cap"], h["lvl_static"],
              h["seed_thr"], h["lcp_thr"])
    if nshards is None:
        return convert.dict_tables_to_numpy(jax_pfp._dict_index(*arrs,
                                                                *static))
    devs = np.asarray(jax.devices()[:nshards]).reshape(nshards)
    fn = jax_sharddict.compile_sharded_dict_index(
        jax.sharding.Mesh(devs, ("seq",)), "seq", *static)
    return convert.dict_tables_to_numpy(fn(*arrs))


def _own_tables(h, arrays, static):
    """The port's single-device index on _prepared's arrays, with the live
    counts of the JAX package's host prep h."""
    live = t_pfp._dict_live(np.asarray(h["phrase_ln"]), int(h["lvl_cap"]))
    return convert.dict_tables_to_numpy(t_pfp._dict_index(*arrays, *static,
                                                          live))


def _check_tables(ref, got, total, d_starts):
    d_r, lcp_r, isa_r, gop_r, gcr_r = ref
    d_g, lcp_g, isa_g, gop_g, gcr_g = got
    assert (d_r == d_g).all()
    keys_r, cross_r = dict_consumer_form(d_r, isa_r, lcp_r, total)
    keys_g, cross_g = dict_consumer_form(d_g, isa_g, lcp_g, total)
    assert keys_r == keys_g
    assert (cross_r == cross_g).all()
    assert (gop_r == gop_g).all()
    assert (gcr_r == gcr_g).all()
    # whole-phrase suffixes are untied under the depth cap: exact ranks
    assert (isa_r[d_starts] == isa_g[d_starts]).all()


@pytest.mark.parametrize("nshards", SHARDS)
def test_block_dict_setup(rng, nshards):
    _pfp, h, arrays, static, _total, _st = _prepared(
        mutated_collection(rng, 4, base_len=900))
    nd, ne = static[0], static[1]
    Bd = nd // nshards
    parts = [sharddict._block_dict_setup(i, *arrays, Bd, nd, ne)
             for i in range(nshards)]
    d = _cat([p[0] for p in parts])
    meta = _cat([p[1] for p in parts])
    d_t, meta_t, _rem = t_pfp._dict_setup(*arrays, nd, ne)
    assert np.array_equal(d, d_t.numpy())
    assert np.array_equal(meta, meta_t.numpy())
    d_j, meta_j = jax_pfp._dict_setup(
        _pfp.ext, h["phrase_st"], h["phrase_ln"], h["d_starts"], h["npz"],
        h["total_real"], nd, ne)
    assert np.array_equal(d, np.asarray(d_j))
    assert np.array_equal(meta, np.asarray(meta_j))


@pytest.mark.parametrize("nshards,two", _meshes())
def test_sharded_dict_tables(rng, nshards, two):
    pfp, h, arrays, static, total, d_starts = _prepared(
        mutated_collection(rng, 4, base_len=900))
    got = convert.dict_tables_to_numpy(sharddict.compile_sharded_dict_index(
        _devices(nshards, two), *static)(*arrays))
    assert got[0].shape == (static[0],)
    own = _own_tables(h, arrays, static)
    _check_tables(own, got, total, d_starts)
    _check_tables(_jax_tables(pfp, h), got, total, d_starts)
    _check_tables(_jax_tables(pfp, h, nshards), got, total, d_starts)


def test_sharded_dict_tables_repetitive(rng):
    """Heavy repeats give large tie blocks in the dictionary, the hazard
    class for the tie-order argument."""
    rep = rand_seq(rng, 80)
    pfp, h, arrays, static, total, d_starts = _prepared(
        mutated_collection(rng, 4, base_len=600, insert_rep=rep))
    got = convert.dict_tables_to_numpy(sharddict.compile_sharded_dict_index(
        _devices(8), *static)(*arrays))
    _check_tables(_own_tables(h, arrays, static), got, total, d_starts)
    _check_tables(_jax_tables(pfp, h), got, total, d_starts)
    _check_tables(_jax_tables(pfp, h, 8), got, total, d_starts)


def test_block_sorts_counted(rng, monkeypatch):
    """block_sorts() is the number of distributed sorts one index makes."""
    _pfp, _h, arrays, static, _total, _st = _prepared(
        mutated_collection(rng, 3, base_len=500))
    calls = []
    real = sharddict._bitonic_block_sort

    def counting(blocks, devices, num_keys=2):
        calls.append(num_keys)
        return real(blocks, devices, num_keys=num_keys)
    monkeypatch.setattr(sharddict, "_bitonic_block_sort", counting)
    sharddict.compile_sharded_dict_index(_devices(2), *static)(*arrays)
    nd, lvl_cap, lvl_static = static[0], static[3], static[4]
    assert len(calls) == sharddict.block_sorts(nd, lvl_cap, lvl_static) > 10
    assert calls.count(2) == min(t_pfp.ops_suffix._num_levels(nd),
                                 lvl_cap) - 3


# ---------------------------------------------------------------------------
# (d) end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nshards,two", [(2, False), (8, False), (4, True)])
def test_sharded_dict_end_to_end(rng, nshards, two):
    rb = build(mutated_collection(rng, 4, base_len=800))
    opts = options.normalize(rb.num_docs, quiet=True)
    want = t_engine.find_matches(rb, opts, device="cpu").output_bytes()
    got = seqpfp.find_matches_seq_sharded(
        rb, opts, _devices(nshards, two), shard_dict=True)
    assert got.output_bytes() == want != b""
    assert want == jax_engine.find_matches(rb, opts,
                                           backend="pfp").output_bytes()


def test_sharded_dict_end_to_end_merge(rng):
    """Merge metadata (candidate thresholds) with the sharded dict stage."""
    rb = build(mutated_collection(rng, 3, base_len=700))
    opts = options.normalize(rb.num_docs, merge=True, quiet=True)
    single = t_engine.find_matches(rb, opts, device="cpu")
    sharded = seqpfp.find_matches_seq_sharded(rb, opts, _devices(4),
                                              shard_dict=True)
    assert single.output_bytes() == sharded.output_bytes() != b""
    assert (single.candidate_thresh == sharded.candidate_thresh).all()
    ref = jax_engine.find_matches(rb, opts, backend="pfp")
    assert ref.output_bytes() == sharded.output_bytes()
    assert (np.asarray(ref.candidate_thresh)
            == sharded.candidate_thresh).all()


def test_sharded_dict_end_to_end_mems(rng):
    rep = rand_seq(rng, 60)
    rb = build(mutated_collection(rng, 4, base_len=500, insert_rep=rep))
    opts = options.normalize(rb.num_docs, rare_freq=2, quiet=True)
    want = t_engine.find_matches(rb, opts, device="cpu").output_bytes()
    got = seqpfp.find_matches_seq_sharded(rb, opts, _devices(4),
                                          shard_dict=True).output_bytes()
    assert got == want != b""


def test_sharded_dict_env_opt_in(rng, monkeypatch):
    """MUMEMTO_SHARD_DICT=1 routes the default call through the sharded
    index (seen by its phase of block sorts), with the same bytes; an
    explicit shard_dict=False wins over the variable."""
    rb = build(mutated_collection(rng, 3, base_len=500))
    opts = options.normalize(rb.num_docs, quiet=True)
    want = t_engine.find_matches(rb, opts, device="cpu").output_bytes()
    calls = []
    real = sharddict.compile_sharded_dict_index
    monkeypatch.setattr(sharddict, "compile_sharded_dict_index",
                        lambda *a: calls.append(len(a[0])) or real(*a))
    devs = mesh.seq_devices(4, "cpu")
    assert seqpfp.find_matches_seq_sharded(rb, opts,
                                           devs).output_bytes() == want
    assert calls == []
    monkeypatch.setenv("MUMEMTO_SHARD_DICT", "1")
    assert seqpfp.find_matches_seq_sharded(rb, opts,
                                           devs).output_bytes() == want
    assert calls == [4]
    assert seqpfp.find_matches_seq_sharded(
        rb, opts, devs, shard_dict=False).output_bytes() == want
    assert calls == [4]
    assert want == jax_engine.find_matches(rb, opts,
                                           backend="pfp").output_bytes()


def test_cli_honours_the_variable(rng, tmp_path, monkeypatch):
    """--seq-shards 2 under MUMEMTO_SHARD_DICT=1: the same .mums."""
    from mumemto_tpu_torch import cli
    paths = []
    for i, d in enumerate(mutated_collection(rng, 3, base_len=500)):
        p = tmp_path / f"c{i}.fa"
        p.write_text(f">c{i}\n{d[0]}\n")
        paths.append(str(p))
    dev = ["--device", "cpu"]
    assert cli.main(paths + ["-o", str(tmp_path / "plain"), *dev]) == 0
    monkeypatch.setenv("MUMEMTO_SHARD_DICT", "1")
    calls = []
    real = sharddict.compile_sharded_dict_index
    monkeypatch.setattr(sharddict, "compile_sharded_dict_index",
                        lambda *a: calls.append(len(a[0])) or real(*a))
    assert cli.main(paths + ["-o", str(tmp_path / "sd"), "--seq-shards", "2",
                             *dev]) == 0
    assert calls == [2]
    assert (tmp_path / "sd.mums").read_bytes() == \
        (tmp_path / "plain.mums").read_bytes() != b""


# ---------------------------------------------------------------------------
# (e) the refusals
# ---------------------------------------------------------------------------

def test_refusals(rng):
    docs = mutated_collection(rng, 3, base_len=400)
    docs[1][0] = docs[1][0][:100] + "NNNN" + docs[1][0][100:]
    rb = build(docs)
    opts = options.normalize(rb.num_docs, quiet=True)
    # an N in the text: more than 8 letters, so no packed seed
    with pytest.raises(AssertionError, match="packed <=8-byte alphabet"):
        seqpfp.find_matches_seq_sharded(rb, opts, _devices(2),
                                        shard_dict=True)
    want = t_engine.find_matches(rb, opts, device="cpu").output_bytes()
    assert seqpfp.find_matches_seq_sharded(
        rb, opts, _devices(2), shard_dict=False).output_bytes() == want
    with pytest.raises(ValueError, match="positive power of two"):
        seqpfp.find_matches_seq_sharded(rb, opts, _devices(3),
                                        shard_dict=True)
    thr = t_pfp.CANON_ALPHA[:-1]
    with pytest.raises(AssertionError, match="power of two"):
        sharddict.compile_sharded_dict_index(_devices(3), 3072, 4096, 10, 8,
                                             8, thr, thr)
    with pytest.raises(AssertionError):  # nd % nshards
        sharddict.compile_sharded_dict_index(_devices(4), 1026, 4096, 10, 8,
                                             8, thr, thr)
    with pytest.raises(AssertionError, match=r"3\*nd"):
        sharddict.compile_sharded_dict_index(_devices(2), 1 << 29, 4096, 10,
                                             8, 8, thr, thr)
    with pytest.raises(AssertionError, match="top level >= 3"):
        sharddict.compile_sharded_dict_index(_devices(2), 1024, 4096, 10, 8,
                                             3, thr, thr)


# ---------------------------------------------------------------------------
# on the card (skipped here)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("kw,nshards", [({}, 2), ({}, 8), ({"merge": True}, 4)])
def test_cuda_shard_dict_matches_cpu_single_device(rng, kw, nshards):
    """shard_dict=True on cuda (one card: every shard on it; several:
    round-robin, so the index's blocks cross cards) against the
    single-device CPU path, byte for byte."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rb = build(mutated_collection(rng, 4, base_len=20000, n_mut=30))
    opts = options.normalize(rb.num_docs, quiet=True, **kw)
    want = t_engine.find_matches(rb, opts, device="cpu")
    got = seqpfp.find_matches_seq_sharded(
        rb, opts, mesh.seq_devices(nshards, "cuda"), M=1 << 16,
        shard_dict=True)
    assert got.output_bytes() == want.output_bytes() != b""
    if kw.get("merge"):
        assert (got.candidate_thresh == want.candidate_thresh).all()


@pytest.mark.gpu
def test_cuda_sharded_tables_match_single_device(rng):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rb = build(mutated_collection(rng, 4, base_len=20000, n_mut=30))
    dev = torch.device("cuda")
    pfp = t_pfp.build_pfp(rb.text, dev)
    h = t_pfp._host_prep(pfp, rb.doc_ends)
    arrays = (pfp.ext, h["phrase_st"], h["phrase_ln"], h["d_starts"],
              h["npz"], h["total_real"])
    static = (h["nd"], h["ne"], h["w"], h["lvl_cap"], h["lvl_static"],
              h["seed_thr"], h["lcp_thr"])
    ref = convert.dict_tables_to_numpy(t_pfp._dict_index(*arrays, *static,
                                                         h["dict_live"]))
    got = convert.dict_tables_to_numpy(sharddict.compile_sharded_dict_index(
        mesh.seq_devices(4, "cuda"), *static)(*arrays))
    d_starts = h["d_starts"].cpu().numpy()[1:h["npz"] + 1]
    _check_tables(ref, got, h["total_real"], d_starts)
