"""Build libmumemto_tpu_torch.so, the C ABI over mumemto_tpu_torch.library
(interface: native/mumemto_tpu.h).

Usage: python mumemto_tpu_torch/capi/build_capi.py [--force]
"""

from __future__ import annotations

import os
import subprocess
import sys
import sysconfig

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
SRC = os.path.join(HERE, "mumemto_capi.cc")
HDR = os.path.join(ROOT, "native", "mumemto_tpu.h")
OUT = os.path.join(HERE, "libmumemto_tpu_torch.so")


def stale() -> bool:
    if not os.path.exists(OUT):
        return True
    mt = os.path.getmtime(OUT)
    return mt < os.path.getmtime(SRC) or mt < os.path.getmtime(HDR)


def build(force: bool = False, quiet: bool = False) -> bool:
    if not force and not stale():
        return True
    include = sysconfig.get_paths()["include"]
    libdir = sysconfig.get_config_var("LIBDIR")
    pyver = f"python{sysconfig.get_python_version()}"
    cmd = [
        "g++", "-O3", "-std=c++17", "-shared", "-fPIC",
        "-o", OUT, SRC,
        f"-I{include}", f"-I{os.path.dirname(HDR)}",
        f"-L{libdir}", f"-Wl,-rpath,{libdir}", f"-l{pyver}",
    ]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=180)
    except (OSError, subprocess.TimeoutExpired) as e:
        if not quiet:
            print(f"[capi] build failed to launch: {e}", file=sys.stderr)
        return False
    if res.returncode != 0:
        if not quiet:
            print(f"[capi] g++ failed:\n{res.stderr}", file=sys.stderr)
        return False
    return True


if __name__ == "__main__":
    ok = build(force="--force" in sys.argv)
    print("built" if ok else "FAILED", OUT)
    sys.exit(0 if ok else 1)
