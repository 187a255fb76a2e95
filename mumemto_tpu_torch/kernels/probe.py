"""CUDA toolchain probe: the `add_one` kernel and its bounded runner.

`add_one` is the port of the Pallas probe kernel in tools/mosaic_probe.py.
It launches csrc/add_one.cu through the same nvcc -> ctypes route as
kernels/kr_mask.py, on a CUDA tensor only: any other device raises.
`add_one_plain` is its plain version.

    python -m mumemto_tpu_torch.kernels.probe [timeout_s]

builds the kernel and runs it on an (8, 128) int32 tile in a child
process, under a hard timeout so that a hung build or launch cannot take
the caller down. Exit code 0: the child printed CUDA_PROBE_OK; 2: the
timeout expired; 1: anything else, including no CUDA card.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import time

import torch

from mumemto_tpu_torch.kernels import build

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

launches = 0  # kernel launches made by add_one

CHILD = r"""
import sys
sys.path.insert(0, sys.argv[1])
from mumemto_tpu_torch.kernels import probe
print("CUDA_PROBE_OK", probe.check(), flush=True)
"""


_fn = None  # add_one_i32, bound at its first launch


def _kernel():
    global _fn
    if _fn is None:
        _fn = build.function(
            "add_one", "add_one_i32", ctypes.c_int,
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
             ctypes.c_void_p])
    return _fn


def _check(x: torch.Tensor) -> None:
    if x.dtype != torch.int32:
        raise ValueError(f"x must be an int32 tensor, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.numel() == 0:
        raise ValueError("x must not be empty")


def add_one_plain(x: torch.Tensor) -> torch.Tensor:
    """x + 1, on any device."""
    _check(x)
    return x + 1


def add_one(x: torch.Tensor) -> torch.Tensor:
    """x + 1 by the CUDA kernel; x must be a CUDA tensor."""
    global launches
    _check(x)
    if not x.is_cuda:
        raise ValueError(f"add_one launches a CUDA kernel and takes a CUDA "
                         f"tensor, got {x.device} (add_one_plain is the "
                         "plain version)")
    out = torch.empty_like(x)  # allocated on x's device, on its stream
    rc = build.launch(_fn or _kernel(), x, x.data_ptr(), out.data_ptr(),
                      x.numel())
    if rc != 0:
        raise RuntimeError(f"add_one launch failed: CUDA error {rc}")
    launches += 1
    return out


def check() -> str:
    """The probe's work: build the kernel, run it on an (8, 128) int32
    tile on the current CUDA device and compare it with the plain version.
    Returns the device's name; raises on any failure."""
    x = torch.arange(8 * 128, dtype=torch.int32, device="cuda").reshape(8, 128)
    y = add_one(x)
    torch.cuda.synchronize()
    if not torch.equal(y, add_one_plain(x)):
        raise AssertionError("add_one kernel != x + 1")
    return torch.cuda.get_device_name(x.device)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    timeout_s = float(argv[0]) if argv else 600.0
    if not torch.cuda.is_available():
        print("cuda probe: FAILED: CUDA is not available (the probe needs a "
              "CUDA card and never falls back)", flush=True)
        return 1
    t0 = time.time()
    try:
        r = subprocess.run([sys.executable, "-c", CHILD, ROOT],
                           capture_output=True, text=True, timeout=timeout_s)
    except subprocess.TimeoutExpired:
        print(f"cuda probe: TIMEOUT after {timeout_s:.0f}s", flush=True)
        return 2
    dt = time.time() - t0
    if r.returncode == 0 and "CUDA_PROBE_OK" in r.stdout:
        print(f"cuda probe: OK in {dt:.1f}s: {r.stdout.strip()}", flush=True)
        return 0
    tail = (r.stderr or "").strip().splitlines()
    print(f"cuda probe: FAILED rc={r.returncode} in {dt:.1f}s: "
          f"{tail[-3:] if tail else ''}", flush=True)
    return 1


if __name__ == "__main__":
    sys.exit(main())
