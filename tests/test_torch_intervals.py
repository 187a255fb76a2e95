"""Windowed analyze_intervals port against mumemto_tpu.ops.intervals.

Tolerance: exact equality — every output is a boolean or int32 array.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mumemto_tpu import engine as jax_engine
from mumemto_tpu.ops import intervals as jax_intervals
from mumemto_tpu_torch.ops import intervals as t_intervals
from conftest import build, mutated_collection

KEYS = ("cand", "emit", "s", "e", "L", "prev_same")


def _compare(lcp, da, bwt, min_len, k, F, cap):
    n = lcp.size
    # XLA:CPU needs about a minute to compile the cap-128 stencils (~400
    # unrolled shifted compares); the same function runs op by op instead
    eager = jax.disable_jit() if cap > 16 else contextlib.nullcontext()
    with eager:
        want = jax_intervals.analyze_intervals(
            jnp.asarray(lcp, jnp.int32), jnp.asarray(da, jnp.int32),
            jnp.asarray(bwt, jnp.uint8), n, jnp.int32(min_len),
            jnp.int32(k), jnp.int32(F), 1, size_cap=cap, need_ctx=False)
    got = t_intervals.analyze_intervals(
        torch.from_numpy(lcp.astype(np.int32)),
        torch.from_numpy(da.astype(np.int32)),
        torch.from_numpy(bwt.astype(np.uint8)), n, min_len, k, F, 1,
        size_cap=cap, need_ctx=False)
    for key in KEYS:
        assert (got[key].numpy() == np.asarray(want[key])).all(), key
    return int(got["emit"].sum())


@pytest.mark.parametrize("cap", [4, 8, 16, 128])
def test_windowed_random_arrays(rng, cap):
    n = 2048
    num_docs = max(cap // 2, 2)
    lcp = rng.integers(0, 12, n)
    lcp[0] = 0
    da = rng.integers(0, num_docs + 1, n)
    bwt = rng.choice(np.frombuffer(b"ACGT", np.uint8), n)
    combos = ((num_docs, num_docs), (2, num_docs), (2, 0))
    for k, F in combos if cap <= 16 else combos[1:2]:  # cap 128 runs eagerly
        _compare(lcp, da, bwt, 3, k, F, cap)


@pytest.mark.parametrize("n_docs", [2, 5, 8])
def test_windowed_real_arrays(rng, n_docs):
    """SA/LCP/BWT/DA of a real collection (JAX direct backend), with the
    cap the engine derives in MUM mode."""
    rb = build(mutated_collection(rng, n_docs, base_len=300))
    sa, lcp, bwt, da = jax_engine.compute_arrays(rb)
    cap = 1 << max(n_docs.bit_length(), 2)
    emitted = 0
    for k in (n_docs, 2):
        emitted += _compare(lcp, da, bwt, 20, k, n_docs, cap)
    assert emitted > 0


def test_unported_modes_raise():
    z = torch.zeros(64, dtype=torch.int32)
    b = torch.zeros(64, dtype=torch.uint8)
    for kw in ({"size_cap": 256}, {"size_cap": None},
               {"size_cap": 16, "need_ctx": True}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            t_intervals.analyze_intervals(z, z, b, 64, 20, 2, 2, 1, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_intervals.analyze_intervals(z, z, b, 64, 20, 2, 2, 2, size_cap=16)


def test_sparse_min_table_matches(rng):
    v = rng.integers(-50, 50, 777).astype(np.int32)
    want = jax_intervals._sparse_min_table(jnp.asarray(v))
    got = t_intervals._sparse_min_table(torch.from_numpy(v))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.numpy() == np.asarray(w)).all()
