"""Byte-presence set of a text: CUDA kernel wrapper and its plain twin.

`byte_presence(t)` gives the 256 flags of the byte values that occur in a
1-D uint8 tensor: on a CUDA tensor it launches the hand-written kernel in
csrc/alphabet.cu, or raises; on a CPU tensor it runs
`byte_presence_plain`, the host presence mask over a uint16 view, which is
also the reference the kernel is checked against on the card.
ops/pfp._alphabet reads the flags back once (build_pfp's ext, the direct
backend's text).

No Pallas kernel is replaced: the JAX package takes the alphabet on the
host (mumemto_tpu/ops/pfp.py::_alphabet); csrc/alphabet.cu says why the
port takes it on the card.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from mumemto_tpu_torch import trace
from mumemto_tpu_torch.kernels import build

COUNTER = "kernels.alphabet.launches"  # trace counter: one a launch

_fn = None  # the C entry point, bound once


def launcher():
    """byte_presence of csrc/alphabet.cu, built and bound at the first
    call; its arguments are (data, n, flags, stream). Calls made through
    it directly are not counted in COUNTER. The first call is the span
    kernels.load."""
    global _fn
    if _fn is None:
        with trace.span("kernels.load"):
            p = ctypes.c_void_p
            _fn = build.function("alphabet", "byte_presence", ctypes.c_int,
                                 [p, ctypes.c_int64, p, p])
    return _fn


def _check(t: torch.Tensor) -> None:
    if t.dtype != torch.uint8 or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"byte_presence takes a contiguous 1-D uint8 "
                         f"tensor, got {t.dtype} with shape "
                         f"{tuple(t.shape)}")


def byte_presence_plain(data) -> torch.Tensor:
    """(256,) bool CPU tensor, flags[v] whether byte value v occurs in data
    (a 1-D uint8 CPU tensor or numpy array): every pair of bytes marks one
    entry of a 65,536-entry mask, whose set entries give both bytes."""
    a = np.ascontiguousarray(data.numpy() if isinstance(data, torch.Tensor)
                             else data)
    even = a[:a.size & ~1]
    present16 = np.zeros(65536, np.bool_)
    present16[even.view(np.uint16)] = True
    pairs = np.flatnonzero(present16)
    present = np.zeros(256, np.bool_)
    present[pairs & 255] = True
    present[pairs >> 8] = True
    if a.size & 1:
        present[a[-1]] = True
    return torch.from_numpy(present)


def byte_presence(t: torch.Tensor) -> torch.Tensor:
    """(256,) bool tensor on t's device: flags[v] whether byte value v
    occurs in t, a contiguous 1-D uint8 tensor of any length (int64) that
    may start at any byte address. One launch on a CUDA tensor."""
    _check(t)
    if t.device.type == "cpu":
        return byte_presence_plain(t)
    if t.device.type != "cuda":
        raise ValueError(f"byte_presence takes a CPU or CUDA tensor, got "
                         f"{t.device}")
    flags = torch.empty(256, dtype=torch.bool, device=t.device)
    build.launch(launcher(), t, t.data_ptr(), t.numel(), flags.data_ptr(),
                 counter=COUNTER)
    return flags
