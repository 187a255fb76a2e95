"""The .mems lines' text in one byte buffer: the CUDA kernel's wrapper
(csrc/mem_render.cu) and its plain twin in numpy.

A line of row r of the (m, W) match windows is

    L[r] \\t tpos[r, 0],...,tpos[r, k-1] \\t docs[r, 0],... \\t s0,... \\n

with k = nv[r] >= 1 occurrences (its first k columns) and s_j '-' where
neg[r, j], else '+'; values in signed decimal. `line_lengths` gives each
line's bytes with PyTorch on the windows' device, and the caller's
exclusive scan of them (line_off, m + 1 entries) places the lines.
`render` writes them all: on a CUDA tensor it launches the kernel, or
raises; on a CPU tensor it runs `render_plain`, the same digit writer in
numpy, which is also the reference the kernel is checked against on the
card. engine._emit_mems calls it once per MEM call with matches.

No Pallas kernel is replaced: the JAX package formats the lines on the
host with numpy string arrays; csrc/mem_render.cu says why the port does
not.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from mumemto_tpu_torch import trace
from mumemto_tpu_torch.kernels import build

COUNTER = "kernels.mem_render.launches"  # trace counter: one a launch

# 10^1 .. 10^18: a magnitude's decimal digits are 1 + how many it reaches
POWERS = [10**k for k in range(1, 19)]
TAB, NEWLINE, COMMA, PLUS, MINUS = b"\t\n,+-"

_fn = None  # the C entry point, bound once


def launcher():
    """mem_render of csrc/mem_render.cu, built and bound at the first call;
    its arguments are (L, tpos, docs, neg, nv, line_off, m, W, out,
    stream). Calls made through it directly are not counted in COUNTER.
    The first call is the span kernels.load."""
    global _fn
    if _fn is None:
        with trace.span("kernels.load"):
            p = ctypes.c_void_p
            _fn = build.function(
                "mem_render", "mem_render", ctypes.c_int,
                [p, p, p, p, p, p, ctypes.c_int64, ctypes.c_int64, p, p])
    return _fn


def widths(x: torch.Tensor) -> torch.Tensor:
    """int64 bytes of each int64 value's decimal text, with its '-'."""
    bounds = torch.tensor(POWERS, dtype=torch.int64, device=x.device)
    return torch.searchsorted(bounds, x.abs(), right=True) + 1 + (x < 0)


def line_lengths(L, tpos, docs, valid) -> torch.Tensor:
    """Each line's bytes: the length and a tab, each occurrence's position,
    document and strand with a separator after each (4 bytes), and the
    newline. L (m) and tpos (m, W) int64, docs (m, W) int32, valid (m, W)
    bool."""
    occ = torch.where(valid, widths(tpos) + widths(docs.long()), 0)
    return widths(L) + occ.sum(dim=1) + 4 * valid.sum(dim=1) + 1


def _widths_np(x: np.ndarray) -> np.ndarray:
    return np.searchsorted(POWERS, np.abs(x), side="right") + 1 + (x < 0)


def _put(out: np.ndarray, at: np.ndarray, x: np.ndarray, w: np.ndarray):
    """x's decimal texts (w bytes each) into out[at : at + w]."""
    out[at[x < 0]] = MINUS
    v = np.abs(x).astype(np.int64)
    digits = w - (x < 0)
    end = at + w
    for d in range(1, int(digits.max()) + 1):  # d-th digit from the right
        on = digits >= d
        out[end[on] - d] = 48 + v[on] % 10
        v //= 10


def render_plain(L, tpos, docs, neg, nv, line_off) -> np.ndarray:
    """The kernel's buffer in numpy (numpy arrays of the dtypes `render`
    takes): line_off[-1] bytes. Within a line the occurrences are placed by
    cumulative sums of their widths, and the digits are written by
    position, a digit place at a time over every value at once."""
    m, W = tpos.shape
    out = np.empty(int(line_off[-1]), dtype=np.uint8)
    if m == 0:
        return out
    valid = np.arange(W) < nv[:, None]
    ends = np.cumsum(nv)      # one past each row's last occurrence
    firsts = ends - nv
    rows = np.repeat(np.arange(m), nv)
    last = np.zeros(int(ends[-1]), dtype=bool)
    last[ends - 1] = True
    at = line_off[:-1]
    wl = _widths_np(L)
    _put(out, at, L, wl)
    out[at + wl] = TAB
    at = at + wl + 1          # each line's next column
    for vals in (tpos[valid], docs[valid]):
        w = _widths_np(vals) + 1  # with the separator
        before = np.cumsum(w) - w
        start = at[rows] + before - before[firsts][rows]
        _put(out, start, vals, w - 1)
        out[start + w - 1] = np.where(last, TAB, COMMA)
        at = at + (before[ends - 1] + w[ends - 1] - before[firsts])
    start = at[rows] + 2 * (np.arange(rows.size) - firsts[rows])
    out[start] = np.where(neg[valid], MINUS, PLUS)
    out[start + 1] = np.where(last, NEWLINE, COMMA)
    return out


def _check(L, tpos, docs, neg, nv, line_off) -> None:
    m, W = tpos.shape
    want = ((L, torch.int64, (m,)), (tpos, torch.int64, (m, W)),
            (docs, torch.int32, (m, W)), (neg, torch.bool, (m, W)),
            (nv, torch.int64, (m,)), (line_off, torch.int64, (m + 1,)))
    for t, dtype, shape in want:
        if t.dtype != dtype or tuple(t.shape) != shape or \
                not t.is_contiguous():
            raise ValueError(f"render takes contiguous {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != tpos.device:
            raise ValueError(f"render's tensors must share tpos's device "
                             f"{tpos.device}, got {t.device}")


def render(L, tpos, docs, neg, nv, line_off, n_bytes: int) -> torch.Tensor:
    """uint8 tensor of the m lines' text (n_bytes = line_off[-1]) on the
    windows' device: L (m) int64, tpos (m, W) int64, docs (m, W) int32,
    neg (m, W) bool, nv (m) int64 (each >= 1), line_off (m + 1) int64."""
    _check(L, tpos, docs, neg, nv, line_off)
    if tpos.device.type == "cpu":
        return torch.from_numpy(render_plain(
            *(t.numpy() for t in (L, tpos, docs, neg, nv, line_off))))
    if tpos.device.type != "cuda":
        raise ValueError(f"render takes CPU or CUDA tensors, got "
                         f"{tpos.device}")
    out = torch.empty(n_bytes, dtype=torch.uint8, device=tpos.device)
    m, W = tpos.shape
    if m:
        build.launch(launcher(), tpos, L.data_ptr(), tpos.data_ptr(),
                     docs.data_ptr(), neg.data_ptr(), nv.data_ptr(),
                     line_off.data_ptr(), m, W, out.data_ptr(),
                     counter=COUNTER)
    return out
