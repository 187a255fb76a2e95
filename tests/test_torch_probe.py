"""The add_one toolchain probe: plain version, device rules, the runner's
exit codes, and the CUDA kernel against the plain version on a card.

Tolerance: exact equality (int32 arithmetic).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mumemto_tpu_torch.kernels import build, probe

# several test workers share the machine's cores
torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tile():
    return np.arange(8 * 128, dtype=np.int32).reshape(8, 128)


def test_plain_matches_numpy():
    x = _tile()
    got = probe.add_one_plain(torch.from_numpy(x))
    assert got.dtype == torch.int32
    assert (got.numpy() == x + 1).all()


def test_plain_wraps_like_int32():
    x = np.array([2**31 - 1, -1, -(2**31)], dtype=np.int32)
    got = probe.add_one_plain(torch.from_numpy(x)).numpy()
    assert (got == (x.astype(np.int64) + 1).astype(np.int32)).all()


def test_kernel_wrapper_refuses_cpu_tensors():
    before = probe.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        probe.add_one(torch.from_numpy(_tile()))
    assert probe.launches == before


@pytest.mark.parametrize("bad", [
    torch.zeros(16, dtype=torch.int64),
    torch.zeros(0, dtype=torch.int32),
    torch.zeros((8, 8), dtype=torch.int32).t(),
])
def test_rejects_bad_input(bad):
    with pytest.raises(ValueError):
        probe.add_one_plain(bad)
    with pytest.raises(ValueError):
        probe.add_one(bad)


def test_module_exits_1_without_cuda():
    lib = os.path.join(build.BUILD_DIR, "libadd_one.so")
    existed = os.path.exists(lib)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    run = subprocess.run(
        [sys.executable, "-m", "mumemto_tpu_torch.kernels.probe", "30"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 1
    assert "CUDA is not available" in run.stdout
    assert os.path.exists(lib) == existed  # no build attempted


def _fake_card(monkeypatch, outcome):
    """Pretend a card exists and replace the child process by `outcome`
    (a CompletedProcess, or an exception to raise)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)

    def run(cmd, **kw):
        assert cmd[:2] == [sys.executable, "-c"] and cmd[3] == probe.ROOT
        assert kw["timeout"] == 7.0
        if isinstance(outcome, BaseException):
            raise outcome
        return outcome
    monkeypatch.setattr(subprocess, "run", run)


@pytest.mark.parametrize("outcome,rc,said", [
    (subprocess.CompletedProcess([], 0, "CUDA_PROBE_OK NVIDIA X\n", ""), 0,
     "OK"),
    (subprocess.TimeoutExpired("child", 7.0), 2, "TIMEOUT"),
    (subprocess.CompletedProcess([], 1, "", "Traceback\nRuntimeError: nvcc"),
     1, "FAILED rc=1"),
    (subprocess.CompletedProcess([], 0, "no marker\n", ""), 1, "FAILED"),
])
def test_runner_exit_codes(monkeypatch, capsys, outcome, rc, said):
    _fake_card(monkeypatch, outcome)
    assert probe.main(["7"]) == rc
    assert said in capsys.readouterr().out


@pytest.mark.gpu
def test_cuda_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for x in (torch.from_numpy(_tile()),
              torch.tensor([2**31 - 1, -1, 0], dtype=torch.int32),
              torch.arange(-500000, 500001, dtype=torch.int32)):
        xc = x.cuda()
        before = probe.launches
        got = probe.add_one(xc)
        torch.cuda.synchronize()
        assert probe.launches == before + 1
        assert torch.equal(got, probe.add_one_plain(xc))
    run = subprocess.run(
        [sys.executable, "-m", "mumemto_tpu_torch.kernels.probe", "600"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "CUDA_PROBE_OK" in run.stdout


@pytest.mark.gpu
def test_current_stream_matches_public_api():
    """build.current_stream (a private torch entry point) gives the handle
    of torch.cuda.current_stream(dev).cuda_stream, on the default stream
    and under a side stream."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.cuda.current_device()
    assert torch._C._cuda_getDevice() == dev  # what build.launch reads
    assert build.current_stream(dev) == \
        torch.cuda.current_stream(dev).cuda_stream
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        assert build.current_stream(dev) == side.cuda_stream
        x = torch.arange(-3000, 3001, dtype=torch.int32, device="cuda")
        got = probe.add_one(x)
    torch.cuda.synchronize()
    assert torch.equal(got, probe.add_one_plain(x))
    assert build.current_stream(dev) == \
        torch.cuda.current_stream(dev).cuda_stream


@pytest.mark.gpu
@pytest.mark.parametrize("start,stop", [(1, None), (3, 10), (0, 1), (0, 3),
                                        (0, 1000003), (2, 1000003)])
def test_cuda_kernel_misaligned_and_odd(start, stop):
    """Views that are not 16-byte aligned take the scalar body, lengths
    that are not a multiple of 4 the vector body's tail."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    base = torch.from_numpy(np.random.default_rng(7).integers(
        -2**31, 2**31, 1000003, dtype=np.int64).astype(np.int32)).cuda()
    x = base[start:stop]
    assert x.is_contiguous()
    before = probe.launches
    got = probe.add_one(x)
    torch.cuda.synchronize()
    assert probe.launches == before + 1
    assert torch.equal(got, probe.add_one_plain(x))
