"""Build and load the port's CUDA kernels.

Each kernel is one `csrc/<name>.cu` file with a plain C interface. It is
compiled by `nvcc` into `build/lib<name>.so` beside this file, at first use
and again whenever the source is newer than the library, and loaded with
ctypes. Nothing is built when this module is imported, and nothing here
runs without a CUDA toolkit.

A wrapper binds each C entry point once (`function`) and launches it with
`launch`, which appends the raw handle of PyTorch's current stream on the
tensor's device (`current_stream`), raises on a CUDA error and counts the
launch in the kernel's trace counter.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import torch

from mumemto_tpu_torch import trace

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "csrc")
BUILD_DIR = os.path.join(HERE, "build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_loaded: dict = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    """The nvcc binary: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need a CUDA toolkit "
                       "(set CUDA_HOME or put nvcc on PATH)")


def build(name: str, src: str | None = None) -> str:
    """Compile csrc/<name>.cu (or the source file `src`) into
    build/lib<name>.so unless the library is newer than its source; returns
    the library path. When csrc/<name>.cu needs compiling, every other
    csrc/*.cu whose library is missing or older is compiled beside it, one
    nvcc each, all started together: a fresh checkout's first call waits
    for the slowest source instead of each in turn."""
    if src is None:
        srcs = {n[:-3]: os.path.join(CSRC, n)
                for n in sorted(os.listdir(CSRC)) if n.endswith(".cu")}
        srcs[name] = os.path.join(CSRC, name + ".cu")
    else:
        srcs = {name: src}
    with _lock:  # one process's threads never write one temporary file
        stale = {n: s for n, s in srcs.items() if not _fresh(n, s)}
        if name in stale:
            _compile(name, stale)
    return _library(name)


def _library(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _fresh(name: str, src: str) -> bool:
    out = _library(name)
    return os.path.exists(out) and os.path.getmtime(out) >= \
        os.path.getmtime(src)


def _compile(name: str, srcs: dict) -> None:
    """One nvcc for each {library name: source}, all running at once;
    raises when `name`'s fails (a failure of another source is raised
    when that kernel is loaded)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    runs = {}
    for n, src in srcs.items():
        tmp = f"{_library(n)}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-o", tmp, src]
        runs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True),
                   tmp, src)
    failed = None
    for n, (proc, tmp, src) in runs.items():
        _, err = proc.communicate()
        if proc.returncode == 0:
            # atomic: a concurrent loader never sees half a file
            os.replace(tmp, _library(n))
        elif n == name:
            failed = f"nvcc failed for {src} (rc {proc.returncode}):\n{err}"
    if failed:
        raise RuntimeError(failed)


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of lib<name>.so, built first when needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name))
        _loaded[name] = lib
    return lib


def function(name: str, symbol: str, restype, argtypes):
    """A prototyped ctypes function object for `symbol` in lib<name>.so
    (built and loaded first when needed). Pointers and the stream must be
    declared c_void_p: an undeclared argument is passed as a 32-bit int."""
    return ctypes.CFUNCTYPE(restype, *argtypes)((symbol, load(name)))


def current_stream(device_index: int) -> int:
    """Raw cudaStream_t of PyTorch's current stream on a CUDA device, read
    anew on every call (the current stream can change between calls).
    torch._C._cuda_getCurrentRawStream is the private entry point that
    torch.compile's generated launchers use; it builds no Stream object.
    The public torch.cuda.current_stream(device).cuda_stream gives the same
    handle (a gpu test checks that)."""
    return torch._C._cuda_getCurrentRawStream(device_index)


def launch(fn, t: torch.Tensor, *args, counter: str) -> None:
    """fn(*args, stream) for a CUDA tensor t: on t's device, on its current
    stream. Raises RuntimeError when fn returns a nonzero CUDA error code,
    else adds one to the trace counter `counter` (kernels.<name>.launches).
    The device guard is entered only when t is not on the current device
    (a launch must be made with the stream's device current). The current
    device is read by the private torch._C._cuda_getDevice, which
    torch.cuda.current_device wraps after its lazy-init check (CUDA is
    initialized once t exists)."""
    dev = t.get_device()
    if dev == torch._C._cuda_getDevice():
        rc = fn(*args, current_stream(dev))
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, current_stream(dev))
    if rc != 0:
        raise RuntimeError(f"{counter.removesuffix('.launches')} launch "
                           f"failed: CUDA error {rc}")
    trace.count(counter)
