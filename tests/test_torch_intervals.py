"""analyze_intervals port against mumemto_tpu.ops.intervals, every branch:
windowed (f = 1 and f > 1), the probe-guarded walk, uncapped, with and
without the merge contexts; and each helper on its own.

Tolerance: exact equality — every output is a boolean or int32 array.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mumemto_tpu import engine as jax_engine
from mumemto_tpu import options
from mumemto_tpu.ops import intervals as jax_intervals
from mumemto_tpu_torch import engine as t_engine
from mumemto_tpu_torch.ops import intervals as t_intervals
from conftest import build, mutated_collection, rand_seq

# several test workers share the machine's cores
torch.set_num_threads(2)

KEYS = ("cand", "emit", "s", "e", "L", "prev_same")
CTX_KEYS = ("prev_ctx", "next_ctx")
N = 2048  # one row count for every random case, so XLA compiles reuse


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.int32))  # a writable copy


def _compare(lcp, da, bwt, min_len, k, F, f, cap, need_ctx=False):
    n = lcp.size
    # XLA:CPU needs about a minute to compile the cap-128 stencils (~400
    # unrolled shifted compares); wide windows run op by op instead
    windowed = cap is not None and cap <= 128
    eager = jax.disable_jit() if windowed and cap > 16 else \
        contextlib.nullcontext()
    with eager:
        want = jax_intervals.analyze_intervals(
            jnp.asarray(lcp, jnp.int32), jnp.asarray(da, jnp.int32),
            jnp.asarray(bwt, jnp.uint8), n, jnp.int32(min_len),
            jnp.int32(k), jnp.int32(F), f, size_cap=cap, need_ctx=need_ctx)
    got = t_intervals.analyze_intervals(
        _t(lcp), _t(da), torch.from_numpy(bwt.astype(np.uint8)), n, min_len,
        k, F, f, size_cap=cap, need_ctx=need_ctx)
    for key in KEYS + (CTX_KEYS if need_ctx else ()):
        assert (got[key].numpy() == np.asarray(want[key])).all(), key
    assert need_ctx or not set(CTX_KEYS) & set(got)
    return int(got["emit"].sum())


def _random_arrays(rng, num_docs, max_lcp=12):
    lcp = rng.integers(0, max_lcp, N)
    lcp[0] = 0
    da = rng.integers(0, num_docs + 1, N)
    bwt = rng.choice(np.frombuffer(b"ACGT", np.uint8), N)
    return lcp, da, bwt


@pytest.mark.parametrize("cap", [4, 8, 16, 128])
def test_windowed_random_arrays(rng, cap):
    num_docs = max(cap // 2, 2)
    lcp, da, bwt = _random_arrays(rng, num_docs)
    combos = ((num_docs, num_docs), (2, num_docs), (2, 0))
    for k, F in combos if cap <= 16 else combos[1:2]:  # cap 128 runs eagerly
        _compare(lcp, da, bwt, 3, k, F, 1, cap)


@pytest.mark.parametrize("f", [2, 3])
@pytest.mark.parametrize("cap", [8, 16, 32])
def test_windowed_doc_freq_random_arrays(rng, f, cap):
    """MEM mode on a few docs: windowed s/e, global prev_same_doc chain."""
    num_docs = max(cap // (2 * f), 2)
    lcp, da, bwt = _random_arrays(rng, num_docs)
    emitted = 0
    for k, F in ((2, 0), (num_docs, cap - 1)):
        emitted += _compare(lcp, da, bwt, 2, k, F, f, cap)
    assert emitted > 0


@pytest.mark.parametrize("cap", [256, 512])
def test_walk_random_arrays(rng, cap):
    """Caps above 128: the probe-guarded walk (MUM mode on >= 128 docs)."""
    lcp, da, bwt = _random_arrays(rng, cap // 2, max_lcp=40)
    emitted = 0
    for k, F, f in ((2, 0, 1), (2, cap - 3, 1), (2, 0, 2), (3, 0, 0)):
        emitted += _compare(lcp, da, bwt, 3, k, F, f, cap)
    assert emitted > 0


@pytest.mark.parametrize("F", [0, 5])
def test_uncapped_random_arrays(rng, F):
    """size_cap None (-f 0 -F 0 in the engine): full-height walks and the
    (e, L) sort dedup; F = 5 keeps the total-frequency filter on."""
    lcp, da, bwt = _random_arrays(rng, 6)
    emitted = 0
    for k, f in ((2, 0), (3, 2), (2, 1)):
        emitted += _compare(lcp, da, bwt, 3, k, F, f, None)
    assert emitted > 0


@pytest.mark.parametrize("cap", [8, 32, 256, None])
def test_need_ctx(rng, cap):
    """The merge contexts in their select form (windowed) and their
    gather form (walk, uncapped)."""
    lcp, da, bwt = _random_arrays(rng, 4, max_lcp=20)
    for f in (1, 2):
        _compare(lcp, da, bwt, 3, 2, 0, f, cap, need_ctx=True)


def test_real_arrays_mum_mode_ctx(rng):
    """SA/LCP/BWT/DA of a real collection, MUM mode with merge contexts."""
    n_docs = 5
    rb = build(mutated_collection(rng, n_docs, base_len=300))
    sa, lcp, bwt, da = jax_engine.compute_arrays(rb)
    opts = options.normalize(n_docs, merge=True, quiet=True)
    cap = t_engine.interval_size_cap(opts, n_docs)
    assert _compare(lcp, da, bwt, 20, n_docs, opts.max_total_freq, 1, cap,
                    need_ctx=True) > 0


@pytest.mark.parametrize("n_docs", [2, 5, 8])
def test_windowed_real_arrays(rng, n_docs):
    """SA/LCP/BWT/DA of a real collection (JAX direct backend), with the
    cap the engine derives in MUM mode."""
    rb = build(mutated_collection(rng, n_docs, base_len=300))
    sa, lcp, bwt, da = jax_engine.compute_arrays(rb)
    cap = 1 << max(n_docs.bit_length(), 2)
    emitted = 0
    for k in (n_docs, 2):
        emitted += _compare(lcp, da, bwt, 20, k, n_docs, 1, cap)
    assert emitted > 0


@pytest.mark.parametrize("k,f,F", [(0, 2, 0), (0, 3, 0), (2, 2, 0),
                                   (0, 0, 0), (0, 2, -1), (0, 0, 5)])
def test_real_arrays_mem_options(rng, k, f, F):
    """A real collection with a planted repeat, under the MEM options the
    engine normalizes (windowed f > 1, uncapped, F-only caps)."""
    rep = rand_seq(rng, 60)
    rb = build(mutated_collection(rng, 3, base_len=150, insert_rep=rep))
    sa, lcp, bwt, da = jax_engine.compute_arrays(rb)
    opts = options.normalize(rb.num_docs, num_distinct_docs=k, rare_freq=f,
                             max_mem_freq=F, quiet=True)
    cap = t_engine.interval_size_cap(opts, rb.num_docs)
    assert cap == jax_engine.interval_size_cap(opts, rb.num_docs)
    _compare(lcp, da, bwt, opts.min_match_len, opts.num_distinct,
             opts.max_total_freq, opts.max_doc_freq, cap)


def test_sparse_min_table_matches(rng):
    v = rng.integers(-50, 50, 777).astype(np.int32)
    want = jax_intervals._sparse_min_table(jnp.asarray(v))
    got = t_intervals._sparse_min_table(torch.from_numpy(v))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.numpy() == np.asarray(w)).all()


@pytest.mark.parametrize("num_docs", [1, 3, 50])
def test_prev_same_doc(rng, num_docs):
    da = rng.integers(0, num_docs + 1, 999)
    got = t_intervals.prev_same_doc(_t(da)).numpy()
    assert (got == np.asarray(jax_intervals.prev_same_doc(
        jnp.asarray(da, jnp.int32)))).all()
    last = {}
    for r, d in enumerate(da.tolist()):  # the definition, directly
        assert got[r] == last.get(d, -1)
        last[d] = r


@pytest.mark.parametrize("times", [1, 2, 3])
def test_compose_prev_and_first_violation(rng, times):
    da = rng.integers(0, 4, 999)
    prev = jax_intervals.prev_same_doc(jnp.asarray(da, jnp.int32))
    want = jax_intervals._compose_prev(prev, times)
    got = t_intervals._compose_prev(_t(np.asarray(prev)), times)
    assert (got.numpy() == np.asarray(want)).all()
    mindup = t_intervals._first_violation_from(got).numpy()
    assert (mindup == np.asarray(
        jax_intervals._first_violation_from(want))).all()
    prevf = got.numpy()
    for s in (0, 1, 500, 998):  # the definition, directly
        hits = np.flatnonzero(prevf >= s)
        assert mindup[s] == (hits.min() if hits.size else 2**31 - 1)


@pytest.mark.parametrize("max_dist", [None, 5, 64])
def test_walks(rng, max_dist):
    lcp = rng.integers(0, 30, 1000).astype(np.int32)
    lcp[0] = 0
    thresh = rng.integers(0, 32, 1000).astype(np.int32)
    levels = None if max_dist is None else \
        max((max_dist + 1).bit_length() - 1, 1)
    tab_j = jax_intervals._sparse_min_table(jnp.asarray(lcp), levels)
    tab_t = t_intervals._sparse_min_table(_t(lcp), levels)
    p_j = jnp.arange(1000, dtype=jnp.int32)
    p_t = torch.arange(1000, dtype=torch.int32)
    for walk in ("_psv_walk", "_nsv_walk"):
        want = getattr(jax_intervals, walk)(tab_j, p_j, jnp.asarray(thresh),
                                            max_dist=max_dist)
        got = getattr(t_intervals, walk)(tab_t, p_t, _t(thresh),
                                         max_dist=max_dist)
        assert (got.numpy() == np.asarray(want)).all(), walk
    if max_dist is None:  # unguarded: the exact PSV, directly
        psv = t_intervals._psv_walk(tab_t, p_t, _t(thresh))
        for p in (1, 17, 999):
            q = [i for i in range(p) if lcp[i] < thresh[p]]
            assert psv[p] == (q[-1] if q else -1)


def test_leftmost_mask(rng):
    n = 1500
    e = rng.integers(0, n + 1, n)
    lcp = rng.integers(0, 2**31 - 1, n)
    lcp[::3] = 7  # many (e, L) ties
    e[::5] = n
    want = jax_intervals._leftmost_mask(jnp.asarray(e, jnp.int32),
                                        jnp.asarray(lcp, jnp.int32), n)
    got = t_intervals._leftmost_mask(_t(e), _t(lcp), n)
    assert (got.numpy() == np.asarray(want)).all()
    seen = set()
    for p in range(n):  # first occurrence of each (e, L), directly
        assert got[p] == ((e[p], lcp[p]) not in seen)
        seen.add((e[p], lcp[p]))
