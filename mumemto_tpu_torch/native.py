"""Loader for the native host-runtime extension, with pure-Python fallback.

The native module (native/mumemto_native.cc) is the C++ data-loader
equivalent of the reference's kseq.h+zlib ingest layer, plus the phrase
sort (which the port does not call: ops/pfp.sort_phrases ranks the phrases
on the device). This package builds its own image of it,
mumemto_tpu_torch/_native.so (g++, links zlib), on demand, and skips it
silently when it cannot be built — every caller must work against the
fallback too. Disable with MUMEMTO_TPU_NO_NATIVE=1.
"""

from __future__ import annotations

import importlib.machinery
import importlib.util
import os
import subprocess
import sysconfig

from mumemto_tpu_torch import trace

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "native", "mumemto_native.cc")
OUT = os.path.join(HERE, "_native.so")
MODULE = "mumemto_tpu_torch._native"

_native = None
_tried = False


def stale() -> bool:
    return (not os.path.exists(OUT)
            or os.path.getmtime(OUT) < os.path.getmtime(SRC))


def build() -> bool:
    """Compile if missing or stale. True only when OUT is fresh: a failed
    compile with a stale .so on disk removes it and returns False, so the
    caller takes the pure-Python path instead of outdated native code."""
    if not os.path.exists(SRC):
        # no sources shipped: trust a prebuilt .so if present
        return os.path.exists(OUT)
    if not stale():
        return True
    tmp = f"{OUT}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", tmp, SRC,
           f"-I{sysconfig.get_paths()['include']}", "-lz"]
    try:
        ok = subprocess.run(cmd, capture_output=True, text=True,
                            timeout=120).returncode == 0
    except (OSError, subprocess.TimeoutExpired):
        ok = False
    if ok:
        os.replace(tmp, OUT)  # atomic: a concurrent import never sees half
        return True
    for path in (tmp, OUT):  # never import a stale binary
        if os.path.exists(path):
            try:
                os.remove(path)
            except OSError:
                pass
    return False


def _import():
    """Load OUT as mumemto_tpu_torch._native. The loader is bound to the
    file, so its PyInit__native is taken from this image and not from
    another package's build of the same source."""
    loader = importlib.machinery.ExtensionFileLoader(MODULE, OUT)
    spec = importlib.util.spec_from_file_location(MODULE, OUT, loader=loader)
    mod = importlib.util.module_from_spec(spec)
    loader.exec_module(mod)
    return mod


def get_native():
    """The `_native` extension module, or None when unavailable. The first
    call builds and loads it: the span native.load."""
    global _native, _tried
    if _tried:
        return _native
    _tried = True
    if os.environ.get("MUMEMTO_TPU_NO_NATIVE"):
        return None
    with trace.span("native.load"):
        # build (or staleness-check) first: importing before checking
        # would happily load a stale .so built from older sources
        if not build():
            return None
        try:
            _native = _import()
        except ImportError:
            _native = None
    return _native
