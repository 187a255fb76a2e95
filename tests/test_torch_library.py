"""The port's in-memory API (library.mum/mem, the C-ABI shims) and its
oracle-free property checks, against mumemto_tpu.library.

One collection shape throughout: 3 documents of 400 bp (two records each,
str and bytes) with a planted 40 bp repeat. Tolerance: exact equality of
every array, record and byte string.
"""

import numpy as np
import pytest
import torch

import mumemto_tpu_torch
from mumemto_tpu import library as jax_library
from mumemto_tpu import properties as jax_properties
from mumemto_tpu_torch import library, properties
from conftest import build, mutated_collection, rand_seq

# several test workers share the machine's cores
torch.set_num_threads(2)


def _sequences(rng):
    """3 docs of 400 bp (+ the repeat), each as a str record and a bytes
    record."""
    docs = mutated_collection(rng, 3, base_len=400,
                              insert_rep=rand_seq(rng, 40))
    return [[d[0][:150], d[0][150:].encode()] for d in docs]


# (call, keywords): strict and partial MUMs, MEMs with f = 2 and 3
CALLS = [("mum", {}), ("mum", {"num_distinct": 2}),
         ("mum", {"use_revcomp": False}),
         ("mem", {"max_doc_freq": 2}), ("mem", {"max_doc_freq": 3}),
         ("mem", {"max_doc_freq": 3, "max_total_freq": 6,
                  "num_distinct": 2})]


def _records(res):
    return [tuple(np.asarray(x).tolist() for x in res.match_at(i))
            for i in range(len(res))]


@pytest.mark.parametrize("call,kw", CALLS)
def test_library_matches_jax(rng, call, kw):
    seqs = _sequences(rng)
    want = getattr(jax_library, call)(seqs, **kw)
    got = getattr(library, call)(seqs, device="cpu", **kw)
    assert type(got).__name__ == type(want).__name__
    assert len(got) == len(want) > 0
    assert got.num_docs() == want.num_docs() == 3
    assert got.lengths == want.lengths == [[len(r) for r in d] for d in seqs]
    assert _records(got) == _records(want)
    assert [tuple(np.asarray(x).tolist() for x in got[i])
            for i in range(len(got))] == _records(want)
    if call == "mum":
        for name in ("match_lengths", "offsets", "strands"):
            g, w = getattr(got, name), getattr(want, name)
            assert g.dtype == w.dtype and np.array_equal(g, w), name


@pytest.mark.parametrize("call,kw", CALLS)
def test_cabi_bytes_match_jax(rng, call, kw):
    seqs = _sequences(rng)
    kw = dict(kw)
    args = [seqs, 20, kw.pop("use_revcomp", True), kw.pop("num_distinct", 0)]
    if call == "mem":
        args += [kw.pop("max_total_freq", 0), kw.pop("max_doc_freq")]
    want = getattr(jax_library, "_cabi_" + call)(*args)
    got = getattr(library, "_cabi_" + call)(*args, device="cpu")
    assert got == want
    assert got[0] > 0


def test_library_errors(rng):
    seqs = _sequences(rng)
    res = library.mum(seqs, device="cpu")
    for idx in (-1, len(res)):
        with pytest.raises(IndexError):
            res.match_at(idx)
    mres = library.mem(seqs, max_doc_freq=2, device="cpu")
    with pytest.raises(IndexError):
        mres[len(mres)]
    with pytest.raises(ValueError, match="max_doc_freq > 1"):
        library.mem(seqs, max_doc_freq=1, device="cpu")
    # seq_shards runs the sharded scan: the same records; a count that is
    # no power of two is refused
    assert _records(library.mum(seqs, seq_shards=2, device="cpu")) == \
        _records(res)
    assert _records(library.mem(seqs, max_doc_freq=2, seq_shards=2,
                                device="cpu")) == _records(mres)
    for call in (library.mum, library.mem):
        with pytest.raises(ValueError, match="positive power of two"):
            call(seqs, seq_shards=3, device="cpu")


def test_package_exports_library():
    assert mumemto_tpu_torch.mum is library.mum
    assert mumemto_tpu_torch.mem is library.mem
    assert mumemto_tpu_torch.MumResult is library.MumResult
    assert mumemto_tpu_torch.MemResult is library.MemResult
    with pytest.raises(AttributeError):
        mumemto_tpu_torch.no_such_name


@pytest.mark.parametrize("call,kw", CALLS)
def test_properties_pass(rng, call, kw):
    """The port's results pass its checks and the JAX package's."""
    seqs = _sequences(rng)
    res = getattr(library, call)(seqs, device="cpu", **kw)._r
    rb = build(seqs, use_revcomp=kw.get("use_revcomp", True))
    if call == "mum":
        n = properties.check_mum_properties(res, rb)
        assert n == jax_properties.check_mum_properties(res, rb) == len(
            res.lengths)
        assert properties.check_mum_properties(res, rb, max_checked=2) == 2
    else:
        n = properties.check_mem_properties(res, rb)
        assert n == jax_properties.check_mem_properties(res, rb) == len(
            res.mem_records)
        assert properties.check_mem_properties(res, rb, max_checked=2) == 2
    assert n > 0


def test_properties_catch_a_moved_offset(rng):
    seqs = _sequences(rng)
    rb = build(seqs)
    res = library.mum(seqs, device="cpu")._r
    res.offsets[0, 1] += 1
    with pytest.raises(AssertionError):
        properties.check_mum_properties(res, rb)
    mres = library.mem(seqs, max_doc_freq=3, device="cpu")._r
    mres.mem_records._tposf[0] += 1
    with pytest.raises(AssertionError):
        properties.check_mem_properties(mres, rb)


@pytest.mark.gpu
def test_cuda_library_matches_cpu(rng):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    seqs = _sequences(rng)
    for call, kw in CALLS:
        got = getattr(library, call)(seqs, device="cuda", **kw)
        want = getattr(library, call)(seqs, device="cpu", **kw)
        assert _records(got) == _records(want) and len(got) > 0, (call, kw)
