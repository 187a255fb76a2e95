"""Running maximum and minimum of a 1-D int32 or int64 tensor: CUDA kernel
wrapper and its plain version.

`running_max(x)[i]` is max(x[0], ..., x[i]) and, with reverse=True,
max(x[i], ..., x[n-1]); `running_min` likewise. On a CUDA tensor they
launch the hand-written kernel in csrc/scan.cu, or raise; on a CPU tensor
they run `running_plain`, the torch.cummax / cummin(x, 0).values form
(with flips for reverse), which is also the reference the kernel is
checked against on the card.

The kernel replaces no Pallas kernel: the JAX package calls
jax.lax.cummax / cummin. It was added because torch.cummax / cummin of a
1-D tensor runs on one block of the card (PyTorch launches
ceil(rows / 32) blocks, and a 1-D input is one row), 737 ms for 2^28
int32 on an H100, and writes an int64 index array that no caller reads.
The scan is bound by bytes: each element read once and written once,
0.64 ms for 2^28 int32 at 3.35 TB/s; the kernel takes 1.07 ms. It makes
one pass: a block scans a 32 KiB tile in registers and chains to the
tiles before it by a decoupled look-back over per-tile status words, so
no second pass over memory is needed (csrc/scan.cu).
"""

from __future__ import annotations

import ctypes

import torch

from mumemto_tpu_torch import trace
from mumemto_tpu_torch.kernels import build

COUNTER = "kernels.scan.launches"  # trace counter: one a kernel launch

_fns = None  # (running_scan, running_scan_status_words), bound once


def launcher():
    """(running_scan, running_scan_status_words): the C entry points of
    csrc/scan.cu, built and bound at the first call. running_scan's
    arguments are (in, out, status, n, elem_bytes, is_min, reverse,
    stream); calls made through it directly are not counted in COUNTER.
    The first call is the span kernels.load."""
    global _fns
    if _fns is None:
        with trace.span("kernels.load"):
            _fns = (build.function(
                        "scan", "running_scan", ctypes.c_int,
                        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                         ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                         ctypes.c_int, ctypes.c_void_p]),
                    build.function("scan", "running_scan_status_words",
                                   ctypes.c_int64,
                                   [ctypes.c_int64, ctypes.c_int]))
    return _fns


def _check(x: torch.Tensor) -> None:
    if x.dtype not in (torch.int32, torch.int64) or x.dim() != 1:
        raise ValueError(f"x must be a 1-D int32 or int64 tensor, got "
                         f"{x.dtype} with shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")


def running_plain(x: torch.Tensor, op: str, reverse: bool = False):
    """The running max (op "max") or min ("min") of x by torch.cummax /
    cummin, on any device."""
    _check(x)
    fn = {"max": torch.cummax, "min": torch.cummin}[op]
    if reverse:
        return torch.flip(fn(torch.flip(x, (0,)), 0).values, (0,))
    return fn(x, 0).values


def _running(x: torch.Tensor, op: str, reverse: bool) -> torch.Tensor:
    _check(x)
    if x.device.type == "cpu":
        return running_plain(x, op, reverse)
    if x.device.type != "cuda":
        raise ValueError(f"running_{op} takes a CPU or CUDA tensor, got "
                         f"{x.device}")
    out = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return out
    fn, status_words = launcher()
    size = x.element_size()
    status = torch.empty(status_words(n, size), dtype=torch.int64,
                         device=x.device)
    build.launch(fn, x, x.data_ptr(), out.data_ptr(), status.data_ptr(), n,
                 size, int(op == "min"), int(reverse), counter=COUNTER)
    return out


def running_max(x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """out[i] = max(x[:i + 1]), or max(x[i:]) with reverse."""
    return _running(x, "max", reverse)


def running_min(x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """out[i] = min(x[:i + 1]), or min(x[i:]) with reverse."""
    return _running(x, "min", reverse)
