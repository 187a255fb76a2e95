"""ops/suffix port against mumemto_tpu.ops.suffix on small inputs.

Tolerance: exact equality (integer arrays). The one exception is the
depth-capped dictionary doubling, whose tie order is implementation-defined
in both packages (unstable lax.sort, stop at lvl_cap): there saD is
compared through the final rank row, hist[L][saD], which does not depend
on tie order, and lcpD only at tie-block boundaries. Where both ports are
fed the same saD/history (PLCP, descent), every value is compared exactly.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mumemto_tpu.ops import pfp as jax_pfp
from mumemto_tpu.ops import suffix as jax_suffix
from mumemto_tpu_torch.ops import suffix as t_suffix
from conftest import build, mutated_collection, rand_seq

# several test workers share the machine's cores
torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x))


def with_n(docs, rng, rate=0.03):
    """Sprinkle N bases: a 9-letter alphabet takes the no-seed variant."""
    return [["".join("N" if rng.random() < rate else c for c in d[0])]
            for d in docs]


def dict_state(docs):
    """(pfp, host prep, D, meta) of the JAX package for a collection."""
    rb = build(docs)
    pfp = jax_pfp.build_pfp(rb.text, w=10, mod=100)
    h = jax_pfp._host_prep(pfp, rb.doc_ends, rb.num_docs)
    d, meta = jax_pfp._dict_setup(pfp.ext, h["phrase_st"], h["phrase_ln"],
                                  h["d_starts"], h["npz"], h["total_real"],
                                  h["nd"], h["ne"])
    return rb, pfp, h, np.asarray(d), np.asarray(meta)


def _parse_like(rng, m, mp, hi):
    x = np.zeros(mp, np.int32)
    x[:m] = rng.integers(1, hi, m)
    return x


@pytest.mark.parametrize("m,mp,hi", [(50, 64, 6), (700, 1024, 40),
                                     (900, 1024, 3)])
def test_uncapped_parse_sa_lcp_exact(rng, m, mp, hi):
    """Uncapped early-exit doubling + rank-descent LCP, as the parse side
    runs them: SA, history, filled rows and LCP are exact."""
    x = _parse_like(rng, m, mp, hi)
    sa_j, hist_j, lvl_j = jax_suffix._suffix_array_impl(jnp.asarray(x), mp)
    lcp_j = jax_suffix._lcp_impl(sa_j, hist_j, lvl_j, mp)
    sa_t, hist_t, lvl_t = t_suffix._suffix_array_impl(_t(x), mp)
    lcp_t = t_suffix._lcp_impl(sa_t, hist_t, lvl_t, mp)
    assert lvl_t == int(lvl_j)
    assert (sa_t.numpy() == np.asarray(sa_j)).all()
    assert (hist_t.numpy() == np.asarray(hist_j)).all()
    assert (lcp_t.numpy() == np.asarray(lcp_j)).all()


@pytest.mark.parametrize("variant", ["acgt", "with_n"])
def test_capped_dict_doubling_tie_invariant(rng, variant):
    docs = mutated_collection(rng, 4, base_len=500)
    if variant == "with_n":
        docs = with_n(docs, rng)
    _rb, _pfp, h, d, _meta = dict_state(docs)
    nd, cap, seed = h["nd"], h["lvl_cap"], h["seed_thr"]
    assert (seed is None) == (variant == "with_n")
    sa_j, hist_j, lvl_j = jax_suffix._suffix_array_impl(
        jnp.asarray(d), nd, packed_init=True, max_lvl=cap,
        alpha_thresholds=seed)
    sa_t, hist_t, lvl_t = t_suffix._suffix_array_impl(
        _t(d), nd, packed_init=True, max_lvl=cap, alpha_thresholds=seed)
    hist_j = np.asarray(hist_j)
    sa_j = np.asarray(sa_j)
    # the rank history does not depend on tie order: exact
    assert lvl_t == int(lvl_j)
    assert (hist_t.numpy() == hist_j).all()
    # saD: same final-rank sequence (ties may be permuted), and a
    # permutation of 0..nd-1
    last = hist_j[-1]
    assert (last[sa_t.numpy()] == last[sa_j]).all()
    assert (np.sort(sa_t.numpy()) == np.arange(nd)).all()
    # lcpD: exact at tie-block boundaries (the rank descent over the
    # same history)
    lvl_static = h["lvl_static"]
    lcp_j = np.asarray(jax_suffix._lcp_impl(
        jnp.asarray(sa_j), jnp.asarray(hist_j), lvl_j, nd,
        levels=lvl_static))
    lcp_t = t_suffix._lcp_impl(sa_t, hist_t, lvl_t, nd,
                               levels=lvl_static).numpy()
    boundary = np.ones(nd, bool)
    boundary[1:] = last[sa_j][1:] != last[sa_j][:-1]
    assert boundary.sum() > nd // 2
    assert (lcp_t[boundary] == lcp_j[boundary]).all()


@functools.partial(jax.jit, static_argnames=(
    "n", "levels", "thr", "deep_cap", "probe_words", "deep_cap_small"))
def _jax_plcp(sa, hist, d, n, levels, thr, deep_cap, probe_words,
              deep_cap_small):
    return jax_suffix._lcp_plcp_impl(sa, hist, d, n, levels, thr,
                                     deep_cap=deep_cap,
                                     probe_words=probe_words,
                                     deep_cap_small=deep_cap_small)


# (JAX deep_cap, JAX deep_cap_small) forcing each lax.cond tier, given as
# fractions of nd (0 = a cap of 1 or 2 rows); the port takes the same
# deep_cap, so its compacted branch runs in the first two and its
# full-width branch in the third
_TIERS = {"small_tier": (3, 1), "mid_tier": (3, 0), "full_width": (0, 0)}


@pytest.mark.parametrize("probe_words", [1, 2])
@pytest.mark.parametrize("tier", list(_TIERS))
def test_plcp_same_input_exact(rng, probe_words, tier):
    """PLCP on one shared saD/history: lcp and isa exact, every tier."""
    rep = rand_seq(rng, 60)
    docs = mutated_collection(rng, 3, base_len=500, insert_rep=rep)
    _rb, _pfp, h, d, _meta = dict_state(docs)
    nd = h["nd"]
    big, small = _TIERS[tier]
    deep_cap = max(nd // big, 1024) if big else 2
    dcs = (nd if small else 1) if probe_words == 2 else None
    sa_j, hist_j, _ = jax_suffix._suffix_array_impl(
        jnp.asarray(d), nd, packed_init=True, max_lvl=h["lvl_cap"],
        alpha_thresholds=h["seed_thr"])
    lcp_j, isa_j = _jax_plcp(sa_j, hist_j, jnp.asarray(d), nd,
                             h["lvl_static"], h["seed_thr"], deep_cap,
                             probe_words, dcs)
    lcp_t, isa_t = t_suffix._lcp_plcp_impl(
        _t(sa_j), _t(hist_j), _t(d), nd, h["lvl_static"], h["seed_thr"],
        deep_cap=deep_cap, probe_words=probe_words)
    total = int(h["total_real"])
    lcp_j = jax_suffix.canonicalize_pad_lcp(lcp_j, sa_j, total, nd)
    lcp_t = t_suffix.canonicalize_pad_lcp(lcp_t, _t(sa_j), total, nd)
    assert (lcp_t.numpy() == np.asarray(lcp_j)).all()
    assert (isa_t.numpy() == np.asarray(isa_j)).all()


@pytest.mark.parametrize("variant", ["acgt", "with_n"])
def test_lcp_descent_packed_bottom_exact(rng, variant):
    """_lcp_impl with the packed 7-char bottom on a shared saD/history."""
    docs = mutated_collection(rng, 3, base_len=400)
    if variant == "with_n":
        docs = with_n(docs, rng)
    _rb, _pfp, h, d, _meta = dict_state(docs)
    nd, lcp_thr = h["nd"], h["lcp_thr"]
    assert lcp_thr is not None
    sa_j, hist_j, lvl_j = jax_suffix._suffix_array_impl(
        jnp.asarray(d), nd, packed_init=True, max_lvl=h["lvl_cap"],
        alpha_thresholds=h["seed_thr"])
    lcp_j = jax_suffix._lcp_impl(sa_j, hist_j, lvl_j, nd,
                                 levels=h["lvl_static"], text=jnp.asarray(d),
                                 bottom_thresholds=lcp_thr)
    lcp_t = t_suffix._lcp_impl(_t(sa_j), _t(hist_j), int(lvl_j), nd,
                               levels=h["lvl_static"], text=_t(d),
                               bottom_thresholds=lcp_thr)
    assert (lcp_t.numpy() == np.asarray(lcp_j)).all()


def test_route_set_and_shift(rng):
    perm = rng.permutation(300).astype(np.int32)
    v = rng.integers(-5, 5, 300).astype(np.int32)
    want = np.asarray(jax_suffix.route_set(jnp.asarray(perm), jnp.asarray(v)))
    assert (t_suffix.route_set(_t(perm), _t(v)).numpy() == want).all()
    for k in (0, 1, 7, 300, 301):
        got = t_suffix._shift_static(_t(v), k, 300, -1).numpy()
        assert (got == np.asarray(jax_suffix._shift_static(
            jnp.asarray(v), k, 300, -1))).all()


def _direct_text(rng, base_len=1200):
    """A zero-padded 3-doc collection text, as the direct backend pads it:
    (padded text, its seed thresholds, first pad position)."""
    from mumemto_tpu import engine as jax_engine
    rb = build(mutated_collection(rng, 3, base_len=base_len, n_mut=30))
    padded = np.zeros(jax_engine.pad_size(rb.text.size), dtype=np.uint8)
    padded[:rb.text.size] = rb.text
    seed_thr, _ = jax_pfp.seed_thresholds(set(jax_pfp._alphabet(rb.text))
                                          | {0})
    return padded, seed_thr, int(rb.doc_ends[-1]) + 1


@functools.partial(jax.jit, static_argnames=("n", "thr", "deep_cap"))
def _jax_direct_plcp(text, n, thr, deep_cap):
    # the 7-bit seed tells the zero pad from the past-the-end slot, so the
    # doubling exits early and leaves zero rows; the 3-bit seed (the -g
    # backend's) codes both as 0 and always fills every row
    sa, hist, num_lvl = jax_suffix._suffix_array_impl(
        text, n, packed_init=True)
    lcp, isa = jax_suffix._lcp_plcp_impl(sa, hist, text, n, hist.shape[0],
                                         thr, deep_cap=deep_cap,
                                         num_lvl=num_lvl)
    return sa, hist, num_lvl, lcp, isa


@pytest.mark.parametrize("probe_words", [1, 2])
@pytest.mark.parametrize("cap", ["quarter", "full_width"])
def test_plcp_uncapped_history_num_lvl_exact(rng, probe_words, cap):
    """PLCP on an uncapped, early-exit history (the rows past the exit are
    zeros) with num_lvl: lcp and isa exact against the JAX function, in
    the compacted and the full-width branch. Without num_lvl the descent
    reads the zero rows and counts every pair as equal there."""
    text, thr, total = _direct_text(rng)
    n = text.size
    deep_cap = max(n // 4, 1024) if cap == "quarter" else 1
    sa_j, hist_j, lvl_j, lcp_j, isa_j = _jax_direct_plcp(
        jnp.asarray(text), n, thr, deep_cap)
    lvl = int(lvl_j)
    hist = np.asarray(hist_j)
    assert lvl < hist.shape[0] and not hist[lvl:].any()
    stats = {}
    lcp_t, isa_t = t_suffix._lcp_plcp_impl(
        _t(sa_j), _t(hist), _t(text), n, hist.shape[0], thr,
        deep_cap=deep_cap, probe_words=probe_words, num_lvl=lvl, stats=stats)
    assert stats["branch"] == ("full" if cap == "full_width"
                               else "compacted")
    assert stats["n_deep"] > 0
    lcp_j = jax_suffix.canonicalize_pad_lcp(lcp_j, sa_j, total, n)
    got = t_suffix.canonicalize_pad_lcp(lcp_t, _t(sa_j), total, n).numpy()
    assert (got == np.asarray(lcp_j)).all()
    assert (isa_t.numpy() == np.asarray(isa_j)).all()
    # the repair's witness: the same call reading the zero rows differs
    stale, _ = t_suffix._lcp_plcp_impl(
        _t(sa_j), _t(hist), _t(text), n, hist.shape[0], thr,
        deep_cap=deep_cap, probe_words=probe_words)
    stale = t_suffix.canonicalize_pad_lcp(stale, _t(sa_j), total, n).numpy()
    assert (stale != got).any()


@pytest.mark.parametrize("kind", ["random", "repetitive", "collection"])
def test_suffix_lcp_arrays_and_doc_array(rng, kind):
    from mumemto_tpu import engine as jax_engine
    if kind == "random":
        body = rng.integers(65, 91, 300).astype(np.uint8)
    elif kind == "repetitive":
        body = np.tile(rng.integers(65, 69, 30).astype(np.uint8), 40)
    else:
        body = _direct_text(rng, base_len=300)[0]
        body = body[:np.flatnonzero(body)[-1] + 1]
    text = np.zeros(jax_engine.pad_size(body.size), np.uint8)
    text[:body.size] = body
    want = jax_suffix.suffix_lcp_arrays(text)
    got = t_suffix.suffix_lcp_arrays(_t(text))
    for g, w in zip(got, want):
        assert g.dtype == _t(np.asarray(w)).dtype
        assert (g.numpy() == np.asarray(w)).all()
    ends = np.sort(rng.choice(np.arange(1, body.size), 3, replace=False))
    da_t = t_suffix.doc_array(got[0], _t(ends.astype(np.int64)), 3)
    da_j = jax_suffix.doc_array(want[0], jnp.asarray(ends, jnp.int32), 3)
    assert (da_t.numpy() == np.asarray(da_j)).all()
    assert da_t.dtype == torch.int32 and int(da_t.max()) == 3


def test_suffix_lcp_arrays_refuses_wide_chars():
    text = np.zeros(64, np.uint8)
    text[5] = 200
    with pytest.raises(ValueError, match="< 127"):
        t_suffix.suffix_lcp_arrays(_t(text))
