"""The port's C ABI (mumemto_tpu_torch/capi/libmumemto_tpu_torch.so) end
to end: a plain C consumer, native/test_capi.c compiled unchanged against
the port's library, must print the MUMs of mumemto_tpu_torch.library.mum
and of mumemto_tpu.library.mum, with no module of the JAX package in its
process. The device comes from MUMEMTO_TORCH_DEVICE. Tolerance: none.
"""

import os
import shutil
import subprocess
import sys

import pytest
import torch

from mumemto_tpu import library as jax_library
from mumemto_tpu_torch import library
from mumemto_tpu_torch.capi import build_capi

# several test workers share the machine's cores
torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAPI = os.path.join(ROOT, "mumemto_tpu_torch", "capi")

# run by the embedded interpreter before the library is imported: 2 torch
# threads, and a finder that refuses every import of JAX and of the JAX
# package, so a run that succeeds held none of them (the C program never
# finalizes the interpreter, so nothing can be checked at its exit)
PRELUDE = (
    "import sys, torch; torch.set_num_threads(2)\n"
    "class _Block:\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.split('.')[0] in ('jax', 'jaxlib', 'mumemto_tpu', "
    "'bench'):\n"
    "            raise ImportError('blocked import: ' + name)\n"
    "sys.meta_path.insert(0, _Block())\n")


@pytest.fixture(scope="module")
def capi_exe(tmp_path_factory):
    if shutil.which("gcc") is None or shutil.which("g++") is None:
        pytest.skip("no C compiler")
    r = subprocess.run([sys.executable,
                        os.path.join(CAPI, "build_capi.py")],
                       capture_output=True, text=True)
    if r.returncode != 0:
        pytest.skip(f"C ABI library build failed: {r.stderr}")
    exe = str(tmp_path_factory.mktemp("capi") / "test_capi")
    r = subprocess.run([
        "gcc", "-O2", "-o", exe,
        os.path.join(ROOT, "native", "test_capi.c"),
        "-I" + os.path.join(ROOT, "native"),
        "-L" + CAPI, "-Wl,-rpath," + CAPI, "-lmumemto_tpu_torch",
    ], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    return exe


def _docs(rng):
    base = "".join(rng.choice(list("ACGT"), 500))
    docs = []
    for _ in range(3):
        s = list(base)
        for _ in range(4):
            s[int(rng.integers(0, len(s)))] = str(rng.choice(list("ACGT")))
        docs.append("".join(s))
    return docs


def _run(exe, docs, device):
    env = dict(os.environ, MUMEMTO_TPU_PYROOT=ROOT,
               MUMEMTO_TPU_CABI_PRELUDE=PRELUDE)
    env.pop("MUMEMTO_TORCH_DEVICE", None)
    if device is not None:
        env["MUMEMTO_TORCH_DEVICE"] = device
    return subprocess.run([exe], input="\n".join(docs) + "\n",
                          capture_output=True, text=True, env=env,
                          timeout=600)


def test_c_consumer_matches_both_libraries(capi_exe, rng):
    docs = _docs(rng)
    r = _run(capi_exe, docs, "cpu")
    assert r.returncode == 0, r.stderr
    got = [line.split("\t") for line in r.stdout.splitlines()]
    for want in (library.mum([[d] for d in docs], device="cpu"),
                 jax_library.mum([[d] for d in docs])):
        assert len(got) == want.num_matches() > 0
        for i, (ln, offs, strands) in enumerate(got):
            L, o, s = want.match_at(i)
            assert int(ln) == L
            assert [int(x) for x in offs.split(",")] == list(o)
            assert strands == "".join("+" if x else "-" for x in s)


def test_c_consumer_without_device_variable_fails(capi_exe, rng):
    """MUMEMTO_TORCH_DEVICE unset means "cuda": with no card the call
    fails, and the C side reports device.resolve's error."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    r = _run(capi_exe, _docs(rng), None)
    assert r.returncode != 0
    assert r.stdout == ""
    assert "CUDA is not available" in r.stderr


def test_shims_read_the_device_variable(rng, monkeypatch):
    """Only the two shims read the variable; mum() keeps its argument."""
    seqs = [[d] for d in _docs(rng)]
    monkeypatch.setenv("MUMEMTO_TORCH_DEVICE", "cpu")
    via_env = library._cabi_mum(seqs, 20, 1, 0)
    assert via_env == library._cabi_mum(seqs, 20, 1, 0, device="cpu")
    assert via_env == jax_library._cabi_mum(seqs, 20, 1, 0)
    assert library._cabi_mem(seqs, 20, 1, 0, 0, 2) == \
        jax_library._cabi_mem(seqs, 20, 1, 0, 0, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        library.mum(seqs)  # the variable says cpu; mum() does not read it
    monkeypatch.delenv("MUMEMTO_TORCH_DEVICE")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        library._cabi_mum(seqs, 20, 1, 0)


def test_blocked_imports_are_refused_in_the_c_process(capi_exe, rng):
    """The prelude's finder works: a prelude that then imports the JAX
    package makes the run fail, so the passing run above imported none."""
    env = dict(os.environ, MUMEMTO_TPU_PYROOT=ROOT,
               MUMEMTO_TORCH_DEVICE="cpu",
               MUMEMTO_TPU_CABI_PRELUDE=PRELUDE + "import mumemto_tpu\n")
    r = subprocess.run([capi_exe], input="\n".join(_docs(rng)) + "\n",
                       capture_output=True, text=True, env=env, timeout=600)
    assert "blocked import: mumemto_tpu" in r.stderr


def test_capi_source_names_the_port():
    src = open(os.path.join(CAPI, "mumemto_capi.cc")).read()
    assert 'PyImport_ImportModule("mumemto_tpu_torch.library")' in src
    assert '"mumemto_tpu.library"' not in src
    assert '#include "mumemto_tpu.h"' in src
    assert build_capi.OUT.endswith("capi/libmumemto_tpu_torch.so")
    assert build_capi.SRC.endswith("capi/mumemto_capi.cc")
