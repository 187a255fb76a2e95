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
from mumemto_tpu_torch import bench
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


def _filled(rng, ne, n_text, w, kind):
    """ext with random bytes or all-255 bytes (the largest partial sums)."""
    ext = np.zeros(ne, np.uint8)
    ext[0] = jax_pfp.DOLLAR_PFP
    ext[1:n_text + 1] = (255 if kind == "ff"
                         else rng.integers(0, 256, n_text))
    ext[n_text + 1:n_text + 1 + w] = jax_pfp.DOLLAR_PFP
    return ext


GRID_W = [1, 2, 17, 33]
GRID_MOD = [1, 7, 100, 2**31 - 1]


@pytest.mark.parametrize("mod", GRID_MOD)
@pytest.mark.parametrize("w", GRID_W)
def test_plain_matches_xla_over_w_and_mod(rng, w, mod):
    """Every w and mod of the grid, on an ne that is no multiple of 16,
    random bytes and all-255 bytes: the plain version equals the XLA twin."""
    ne, n_text = 5003, 4900
    for kind in ("bytes", "ff"):
        ext = _filled(rng, ne, n_text, w, kind)
        m_x, c_x = jax_pfp._break_mask(jnp.asarray(ext), jnp.int32(n_text),
                                       w, mod, ne)
        m_t, c_t = _plain(ext, n_text, w, mod)
        assert c_t == int(c_x), kind
        assert (m_t == np.asarray(m_x)).all(), kind
        if mod == 1:  # every hash is a multiple of 1
            assert c_t == n_text - w + 1


@pytest.mark.parametrize("w,mod", [(1, 1), (2, 7), (17, 100),
                                   (33, 2**31 - 1)])
def test_plain_matches_pallas_over_w_and_mod(rng, w, mod):
    """The Pallas kernel in interpreter mode on all-255 bytes, then random
    bytes, over the diagonal of the grid."""
    ne = pk.BLK * 2
    n_text = ne - 77
    for kind in ("ff", "bytes"):
        ext = _filled(rng, ne, n_text, w, kind)
        m_p, c_p = pk.break_mask_pallas(jnp.asarray(ext), jnp.int32(n_text),
                                        w, mod, ne, interpret=True)
        m_t, c_t = _plain(ext, n_text, w, mod)
        assert c_t == int(c_p), kind
        assert (m_t == np.asarray(m_p)).all(), kind


def test_plain_takes_a_misaligned_view(rng):
    """A view that starts off a 16-byte boundary is an ext like any other
    for the plain version (the kernel takes byte loads for it)."""
    whole = torch.from_numpy(_filled(rng, 6001, 5900, 10, "bytes"))
    for off in (1, 3, 8):
        view = whole[off:]
        assert view.is_contiguous()
        m_v, c_v = kr_mask.break_mask(view, 5900 - off, 10, 100)
        m_c, c_c = kr_mask.break_mask_plain(view.clone(), 5900 - off, 10, 100)
        assert int(c_v) == int(c_c) and bool((m_v == m_c).all())


def test_cpu_tensor_takes_plain_and_counts_no_launch(rng):
    ext = _ext(rng, 8192, 6000, 10, alphabet=b"ACGT")
    (mask, count), _s, launches = bench.counted(
        torch, lambda: kr_mask.break_mask(torch.from_numpy(ext), 6000, 10,
                                          100))
    m_t, c_t = _plain(ext, 6000, 10)
    assert launches["kr_break_mask"] == 0
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
        (m_k, c_k), _s, launches = bench.counted(
            torch, lambda: kr_mask.break_mask(ext, n_text, w, 100))
        assert launches["kr_break_mask"] == 1
        m_p, c_p = kr_mask.break_mask_plain(ext, n_text, w, 100)
        assert int(c_k) == int(c_p)
        assert bool((m_k == m_p).all())


@pytest.mark.gpu
@pytest.mark.parametrize("mod", GRID_MOD)
@pytest.mark.parametrize("w", GRID_W + [700, 50000])
def test_cuda_kernel_matches_plain_over_w_and_mod(rng, w, mod):
    """The CPU grid on the card, kernel against plain: an ne that is no
    multiple of 16, random and all-255 bytes, the staged path (w > 16, and
    w = 50000 above 48 KiB of shared memory), and misaligned views."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ne, n_text = 120007, 110000
    for kind in ("bytes", "ff"):
        whole = torch.from_numpy(_filled(rng, ne, n_text, w, kind)).cuda()
        for off in (0, 1, 8):
            ext = whole[off:]
            assert (ext.data_ptr() % 16 == 0) == (off == 0)
            m_k, c_k = kr_mask.break_mask(ext, n_text - off, w, mod)
            torch.cuda.synchronize()
            m_p, c_p = kr_mask.break_mask_plain(ext, n_text - off, w, mod)
            assert int(c_k) == int(c_p), (kind, off)
            assert bool((m_k == m_p).all()), (kind, off)


@pytest.mark.gpu
@pytest.mark.parametrize("variant", [0, 1], ids=["first", "linear"])
def test_timing_tool_forms_match_plain(rng, variant):
    """tools/kr_mask_ab.cu still builds, and its two exact forms (the
    kernel's first version and the linear form) equal the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import ctypes
    import os
    from mumemto_tpu_torch.kernels import build
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    lib = ctypes.CDLL(build.build(
        "kr_mask_ab", src=os.path.join(root, "tools", "kr_mask_ab.cu")))
    fn = ctypes.CFUNCTYPE(
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p)(("kr_break_mask_variant", lib))
    for ne, n_text, w, mod in [(300001, 299000, 10, 100), (77777, 70000, 33, 7)]:
        ext = torch.from_numpy(_ext(rng, ne, n_text, w)).cuda()
        mask = torch.empty(ne, dtype=torch.bool, device="cuda")
        count = torch.empty((), dtype=torch.int32, device="cuda")
        rc = fn(variant, ext.data_ptr(), mask.data_ptr(), count.data_ptr(), ne,
                n_text, w, mod, torch.cuda.current_stream().cuda_stream)
        assert rc == 0
        torch.cuda.synchronize()
        m_p, c_p = kr_mask.break_mask_plain(ext, n_text, w, mod)
        assert int(count) == int(c_p)
        assert bool((mask == m_p).all())
