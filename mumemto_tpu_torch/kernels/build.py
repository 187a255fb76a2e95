"""Build and load the port's CUDA kernels.

Each kernel is one `csrc/<name>.cu` file with a plain C interface. It is
compiled by `nvcc` into `build/lib<name>.so` beside this file, at first use
and again whenever the source is newer than the library, and loaded with
ctypes. Nothing is built when this module is imported, and nothing here
runs without a CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "csrc")
BUILD_DIR = os.path.join(HERE, "build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_loaded: dict = {}


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


def build(name: str) -> str:
    """Compile csrc/<name>.cu into build/lib<name>.so unless the library is
    newer than its source; returns the library path."""
    src = os.path.join(CSRC, name + ".cu")
    out = os.path.join(BUILD_DIR, f"lib{name}.so")
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-o", tmp, src]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src} (rc {res.returncode}):\n"
                           f"{res.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of lib<name>.so, built first when needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name))
        _loaded[name] = lib
    return lib
