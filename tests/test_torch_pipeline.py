"""ops/pipeline against mumemto_tpu.ops.pipeline: the direct (-g) scan
and the compactions.

The direct scan runs in both packages on the same padded text. For the
compactions, one JAX PFP scan (with the merge contexts) is carried into
the port with convert.from_jax_res, and every compaction runs on it in
both packages. Tolerance: exact equality, pad rows included — every
output is an integer or boolean array.
"""

import numpy as np
import pytest
import torch

from mumemto_tpu import engine as jax_engine
from mumemto_tpu import options
from mumemto_tpu.ops import pfp as jax_pfp
from mumemto_tpu.ops import pipeline as jax_pipeline
from mumemto_tpu_torch import convert, trace
from mumemto_tpu_torch.ops import pipeline as t_pipeline
from mumemto_tpu_torch.ops import suffix as t_suffix
from conftest import build, mutated_collection, rand_seq

# several test workers share the machine's cores
torch.set_num_threads(2)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def collection():
    rng = np.random.default_rng(7)
    rep = rand_seq(rng, 60)
    return build(mutated_collection(rng, 3, base_len=300, insert_rep=rep))


def _scan(rb, k, f, F):
    opts = options.normalize(rb.num_docs, num_distinct_docs=k, rare_freq=f,
                             max_mem_freq=F, quiet=True)
    res, counts, n = jax_pfp.scan_collection_pfp(
        rb.text, rb.doc_ends, rb.num_docs, np.int32(opts.min_match_len),
        np.int32(opts.num_distinct), np.int32(opts.max_total_freq),
        opts.max_doc_freq,
        size_cap=jax_engine.interval_size_cap(opts, rb.num_docs),
        need_ctx=True)
    n_emit, n_cand, _ = (int(x) for x in np.asarray(counts))
    return res, convert.from_jax_res(res, CPU), n, n_emit, n_cand


def _eq(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, i
        assert (g.numpy() == w).all(), i


OPTS = [(0, 1, 0), (-1, 1, 0), (0, 2, 0), (2, 3, 0), (0, 0, 0), (0, 2, -1)]


@pytest.mark.parametrize("k,f,F", OPTS)
def test_compactions_match_jax(collection, k, f, F):
    res_j, res_t, n, n_emit, n_cand = _scan(collection, k, f, F)
    for key in ("cand", "emit", "s", "e", "L", "prev_same", "sa", "da"):
        assert (res_t[key].numpy() == np.asarray(res_j[key])).all(), key
    nd = collection.num_docs
    M = t_suffix.bucket(n_emit, lo=256)
    assert M == jax_pipeline.bucket(n_emit)
    fields = t_pipeline.compact_fields(res_t, n, M)
    _eq(fields, jax_pipeline.compact_fields(res_j, n, M))
    assert int(fields[4].sum()) == n_emit
    s0, e0 = fields[1].numpy(), fields[2].numpy()
    maxw = int((e0[:n_emit] - s0[:n_emit]).max()) if n_emit else 1
    W = t_suffix.bucket(maxw, lo=8)
    assert W == jax_pipeline.bucket(maxw, lo=8)
    _eq(t_pipeline.compact_windows_mem(res_t, n, M, W, nd),
        jax_pipeline.compact_windows_mem(res_j, n, M, W, nd))
    _eq(t_pipeline.compact_windows_mum(res_t, n, M, nd, nd),
        jax_pipeline.compact_windows_mum(res_j, n, M, nd, nd))
    Mc = t_suffix.bucket(n_cand, lo=256)
    assert Mc == jax_pipeline.bucket(n_cand)
    _eq(t_pipeline.compact_cand_thresh(res_t, n, Mc, nd),
        jax_pipeline.compact_cand_thresh(res_j, n, Mc, nd))
    assert n_cand >= n_emit
    if f != 1 and F >= 0:
        assert n_emit > 0


def test_select_ordered_checks_m(collection):
    _res_j, res_t, n, n_emit, _ = _scan(collection, 0, 2, 0)
    assert n_emit > 1
    with pytest.raises(ValueError, match="do not fit"):
        t_pipeline._select_ordered(res_t["emit"], res_t["e"], res_t["L"], n,
                                   n_emit - 1)
    idx = t_pipeline._select_ordered(res_t["emit"], res_t["e"], res_t["L"],
                                     n, n_emit + 3)
    assert (idx[n_emit:] == n - 1).all()
    e, L = res_t["e"][idx[:n_emit]], res_t["L"][idx[:n_emit]]
    # pop order: e ascending, then L descending
    key = e.to(torch.int64) * 2**32 - L.to(torch.int64)
    assert (key[1:] > key[:-1]).all()


def test_from_jax_res_dtypes(collection):
    res_j, res_t, *_ = _scan(collection, 0, 1, 0)
    assert set(res_t) == set(res_j)
    for key, val in res_t.items():
        assert val.device == CPU
        assert val.numpy().dtype == np.asarray(res_j[key]).dtype, key


def _direct_rb(rng, variant):
    """An ACGT collection (<= 8 distinct bytes with the pad: the 8-char
    seed and the PLCP LCP), or one over 9 letters without revcomp (the
    7-bit seed and the rank descent)."""
    if variant == "acgt":
        return build(mutated_collection(rng, 3, base_len=300,
                                        insert_rep=rand_seq(rng, 40)))
    letters = list("ACGTRYKMS")
    base = "".join(rng.choice(letters, 300))
    docs = []
    for _ in range(3):
        s = list(base)
        for i in rng.integers(0, 300, 6):
            s[i] = rng.choice(letters)
        docs.append(["".join(s)])
    return build(docs, use_revcomp=False)


@pytest.mark.parametrize("variant", ["acgt", "nine_letters"])
@pytest.mark.parametrize("k,f,F", [(0, 1, 0), (0, 3, 0), (0, 0, 0)])
def test_scan_collection_matches_jax(rng, variant, k, f, F):
    """The direct (-g) backend: every res key and the counts, exactly."""
    import jax.numpy as jnp
    rb = _direct_rb(rng, variant)
    opts = options.normalize(rb.num_docs, num_distinct_docs=k, rare_freq=f,
                             max_mem_freq=F, quiet=True)
    n = jax_engine.pad_size(rb.text.size)
    text = np.zeros(n, np.uint8)
    text[:rb.text.size] = rb.text
    seed_thr, lcp_thr = jax_pfp.seed_thresholds(
        set(jax_pfp._alphabet(rb.text)) | {0})
    assert (seed_thr is None) == (variant == "nine_letters")
    size_cap = jax_engine.interval_size_cap(opts, rb.num_docs)
    res_j, counts_j = jax_pipeline.scan_collection(
        jnp.asarray(text), jnp.asarray(rb.doc_ends, dtype=jnp.int32), n,
        rb.num_docs, np.int32(opts.min_match_len),
        np.int32(opts.num_distinct), np.int32(opts.max_total_freq),
        opts.max_doc_freq, size_cap=size_cap, need_ctx=True,
        alpha_thresholds=seed_thr, lcp_thresholds=lcp_thr)
    stages = []
    with trace.call("engine.find_matches", hook=stages.append):
        res_t, counts_t = t_pipeline.scan_collection(
            torch.from_numpy(text), torch.from_numpy(rb.doc_ends), n,
            rb.num_docs, opts.min_match_len, opts.num_distinct,
            opts.max_total_freq, opts.max_doc_freq, size_cap=size_cap,
            need_ctx=True, alpha_thresholds=seed_thr,
            lcp_thresholds=lcp_thr)
    assert stages == ["suffix_array", "lcp", "analyze"]
    assert (counts_t.numpy() == np.asarray(counts_j)).all()
    assert int(counts_t[0]) > 0
    assert set(res_t) == set(res_j)
    for key, want in res_j.items():
        assert (res_t[key].numpy() == np.asarray(want)).all(), key
