"""KR break mask: the port's plain version against the JAX package's XLA
twin and its Pallas kernel (interpreter mode), plus the CUDA kernel against
the plain version on a card.

Tolerance: exact equality everywhere — the mask is boolean and the count
an integer, and every implementation computes the same modular hash.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mumemto_tpu.ops import pallas_kernels as pk
from mumemto_tpu.ops import pfp as jax_pfp
from mumemto_tpu_torch.kernels import kr_mask

# several test workers share the machine's cores
torch.set_num_threads(2)


def _ext(rng, ne, n_text, w, alphabet=None):
    """ext layout: [Dollar] + text + [Dollar]*w + zero pad."""
    ext = np.zeros(ne, np.uint8)
    ext[0] = jax_pfp.DOLLAR_PFP
    if alphabet is None:
        ext[1:n_text + 1] = rng.integers(65, 91, n_text)
    else:
        ext[1:n_text + 1] = np.frombuffer(alphabet, np.uint8)[
            rng.integers(0, len(alphabet), n_text)]
    ext[n_text + 1:n_text + 1 + w] = jax_pfp.DOLLAR_PFP
    return ext


def _plain(ext, n_text, w, mod=100):
    mask, count = kr_mask.break_mask_plain(torch.from_numpy(ext), n_text, w,
                                           mod)
    return mask.numpy(), int(count)


@pytest.mark.parametrize("n_text", [pk.BLK * 4 - 64, pk.BLK * 2, pk.BLK + 3])
def test_plain_matches_xla_and_pallas(rng, n_text):
    """The test_pallas.py shapes: the plain version equals both JAX forms."""
    ne = pk.BLK * 4
    ext = _ext(rng, ne, n_text, 10)
    m_x, c_x = jax_pfp._break_mask(jnp.asarray(ext), jnp.int32(n_text),
                                   10, 100, ne)
    m_p, c_p = pk.break_mask_pallas(jnp.asarray(ext), jnp.int32(n_text),
                                    10, 100, ne, interpret=True)
    m_t, c_t = _plain(ext, n_text, 10)
    assert c_t == int(c_x) == int(c_p)
    assert (m_t == np.asarray(m_x)).all()
    assert (m_t == np.asarray(m_p)).all()


@pytest.mark.parametrize("w", [4, 10, 16])
@pytest.mark.parametrize("n_text", [3, 3000])
def test_plain_matches_xla_acgt_and_edges(rng, w, n_text):
    """ACGT text, windows 4/10/16, and texts shorter than the window."""
    ne = 4096
    ext = _ext(rng, ne, n_text, w, alphabet=b"ACGT")
    m_x, c_x = jax_pfp._break_mask(jnp.asarray(ext), jnp.int32(n_text),
                                   w, 100, ne)
    m_t, c_t = _plain(ext, n_text, w)
    assert c_t == int(c_x)
    assert (m_t == np.asarray(m_x)).all()
    if n_text < w:
        assert c_t == 0


def test_cpu_tensor_takes_plain_and_counts_no_launch(rng):
    ext = _ext(rng, 8192, 6000, 10, alphabet=b"ACGT")
    before = kr_mask.launches
    mask, count = kr_mask.break_mask(torch.from_numpy(ext), 6000, 10, 100)
    m_t, c_t = _plain(ext, 6000, 10)
    assert kr_mask.launches == before
    assert int(count) == c_t and (mask.numpy() == m_t).all()


def test_wrapper_rejects_bad_input():
    with pytest.raises(ValueError):
        kr_mask.break_mask(torch.zeros(16, dtype=torch.int32), 4, 10, 100)
    with pytest.raises(ValueError):
        kr_mask.break_mask(torch.zeros((4, 4), dtype=torch.uint8), 4, 10, 100)
    with pytest.raises(ValueError):
        kr_mask.break_mask(torch.zeros(32, dtype=torch.uint8)[::2], 4, 10, 100)
    with pytest.raises(ValueError):
        kr_mask.break_mask(torch.zeros(16, dtype=torch.uint8), 4, 0, 100)


@pytest.mark.gpu
def test_cuda_kernel_matches_plain(rng):
    """Kernel == plain on the card, odd sizes and windows included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for ne, n_text, w in [(1 << 20, (1 << 20) - 40, 10), (300001, 299000, 4),
                          (77777, 5, 16)]:
        ext = torch.from_numpy(_ext(rng, ne, n_text, w)).cuda()
        before = kr_mask.launches
        m_k, c_k = kr_mask.break_mask(ext, n_text, w, 100)
        torch.cuda.synchronize()
        assert kr_mask.launches == before + 1
        m_p, c_p = kr_mask.break_mask_plain(ext, n_text, w, 100)
        assert int(c_k) == int(c_p)
        assert bool((m_k == m_p).all())
