"""Karp-Rabin phrase-break mask: CUDA kernel wrapper and its plain version.

`break_mask` is the port of the TPU kernel
mumemto_tpu/ops/pallas_kernels.py::break_mask_pallas (and of its XLA twin
mumemto_tpu/ops/pfp.py::_break_mask). On a CUDA tensor it launches the
hand-written kernel in csrc/kr_mask.cu, or raises; on a CPU tensor it runs
`break_mask_plain`. The plain version is also the reference the kernel is
checked against on the card.
"""

from __future__ import annotations

import ctypes

import torch

from mumemto_tpu_torch import trace
from mumemto_tpu_torch.kernels import build

KR_PRIME = 1999999973  # reference KR window-hash modulus (newscan.hpp:84)
COUNTER = "kernels.kr_mask.launches"  # trace counter: one a kernel launch

_fns = None  # (kr_break_mask, its shared-memory tile's max w), bound once


def launcher():
    """(kr_break_mask, max_w): the C launcher of csrc/kr_mask.cu, built and
    bound at the first call, and the largest w it takes. The launcher's
    arguments are (ext, mask, count, ne, n_real, w, mod, stream); calls
    made through it directly are not counted in COUNTER. The first call
    is the span kernels.load."""
    global _fns
    if _fns is None:
        with trace.span("kernels.load"):
            fn = build.function(
                "kr_mask", "kr_break_mask", ctypes.c_int,
                [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                 ctypes.c_void_p])
            _fns = (fn, build.function("kr_mask", "kr_break_mask_max_w",
                                       ctypes.c_int, [])())
    return _fns


def _check(ext: torch.Tensor, w: int, mod: int) -> None:
    if ext.dtype != torch.uint8 or ext.dim() != 1:
        raise ValueError(f"ext must be a 1-D uint8 tensor, got "
                         f"{ext.dtype} with shape {tuple(ext.shape)}")
    if not ext.is_contiguous():
        raise ValueError("ext must be contiguous")
    if ext.numel() == 0:
        raise ValueError("ext must not be empty")
    if w < 1 or mod < 1:
        raise ValueError(f"need w >= 1 and mod >= 1, got w={w} mod={mod}")


def break_mask_plain(ext: torch.Tensor, n_real: int, w: int, mod: int):
    """(mask, count) with int64 shifted copies; exact, because every
    partial sum h + t*256^j stays below 2^40."""
    _check(ext, w, mod)
    ne = ext.numel()
    t = ext.to(torch.int64)
    t[0] = 0  # the decoration Dollar is never hashed
    h = torch.zeros(ne, dtype=torch.int64, device=ext.device)
    pw = 1
    for j in range(w):  # char j positions back carries 256^j (mod p)
        if j < ne:
            h[j:] += t[:ne - j] * pw
        h %= KR_PRIME
        pw = pw * 256 % KR_PRIME
    k = torch.arange(ne, dtype=torch.int64, device=ext.device)
    mask = (h % mod == 0) & (k >= w) & (k <= n_real)
    return mask, mask.sum(dtype=torch.int32)


def break_mask(ext: torch.Tensor, n_real: int, w: int, mod: int):
    """(mask, count) over ext coords: mask[k] is a KR break at ext
    position k (see csrc/kr_mask.cu). count is a 0-d int32 tensor on
    ext's device; the launcher zeroes it on the stream before the kernel
    adds to it. ext may start at any byte address: the kernel takes byte
    loads when it is not 16-byte aligned. On a CUDA tensor w is limited
    by the kernel's shared-memory tile (227328 on sm_90a, far above any
    parse window) and a larger w raises ValueError; the plain version on
    a CPU tensor takes any w."""
    _check(ext, w, mod)
    if ext.device.type == "cpu":
        return break_mask_plain(ext, n_real, w, mod)
    if ext.device.type != "cuda":
        raise ValueError(f"break_mask takes a CPU or CUDA tensor, got "
                         f"{ext.device}")
    fn, max_w = launcher()
    if w > max_w:
        raise ValueError(f"w={w} does not fit the kernel's shared-memory "
                         f"tile (max {max_w})")
    mask = torch.empty(ext.numel(), dtype=torch.bool, device=ext.device)
    count = torch.empty((), dtype=torch.int32, device=ext.device)
    build.launch(fn, ext, ext.data_ptr(), mask.data_ptr(), count.data_ptr(),
                 ext.numel(), int(n_real), int(w), int(mod), counter=COUNTER)
    return mask, count
