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

from mumemto_tpu_torch import bench, trace
from mumemto_tpu_torch.kernels import build, probe

# several test workers share the machine's cores
torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tile():
    return np.arange(8 * 128, dtype=np.int32).reshape(8, 128)


def _add_one(x):
    """(add_one(x), its launches, counted in the trace counter)."""
    got, _s, launches = bench.counted(torch, lambda: probe.add_one(x))
    return got, launches["add_one"]


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
    def refused():
        with pytest.raises(ValueError, match="CUDA tensor"):
            probe.add_one(torch.from_numpy(_tile()))
    _, _s, launches = bench.counted(torch, refused)
    assert launches["add_one"] == 0


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


# stands in for nvcc: notes its source, waits until $WANT compiles have
# started, then writes its -o file (bad.cu fails)
FAKE_NVCC = """#!/bin/sh
prev=""
for a in "$@"; do
  [ "$prev" = "-o" ] && out="$a"
  prev="$a"
done
echo "$a" >> "$CALLS"
touch "$STARTED/$(basename "$a")"
i=0
while [ "$(ls "$STARTED" | wc -l)" -lt "$WANT" ]; do
  i=$((i + 1))
  [ $i -gt 200 ] && exit 3
  sleep 0.05
done
case "$a" in *bad.cu) echo "bad.cu: error" >&2; exit 2;; esac
echo built > "$out"
"""


def test_build_compiles_the_stale_sources_together(tmp_path, monkeypatch):
    """A stale csrc/<name>.cu is compiled with every other stale source,
    one nvcc each, all at once (the stand-in nvcc waits until all three
    have started, so compiles made in turn fail); another source's failure
    does not fail the build, its own does, and a fresh library is not
    compiled again."""
    csrc, started = tmp_path / "csrc", tmp_path / "started"
    csrc.mkdir()
    started.mkdir()
    for name in ("a", "b", "bad"):
        (csrc / f"{name}.cu").write_text("")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    calls = tmp_path / "calls"
    monkeypatch.setattr(build, "CSRC", str(csrc))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setenv("CALLS", str(calls))
    monkeypatch.setenv("STARTED", str(started))
    monkeypatch.setenv("WANT", "3")
    assert build.build("a") == str(tmp_path / "build" / "liba.so")
    assert sorted(os.listdir(tmp_path / "build")) == ["liba.so", "libb.so"]
    assert sorted(os.path.basename(c) for c in
                  calls.read_text().split()) == ["a.cu", "b.cu", "bad.cu"]
    assert build.build("b") == str(tmp_path / "build" / "libb.so")
    with pytest.raises(RuntimeError, match="nvcc failed for .*bad.cu"):
        build.build("bad")
    assert sorted(os.path.basename(c) for c in calls.read_text().split()) \
        == ["a.cu", "b.cu", "bad.cu", "bad.cu"]


@pytest.mark.parametrize("rc", [0, 700])
@pytest.mark.parametrize("on", [False, True])
def test_launch_counts_or_raises(monkeypatch, rc, on):
    """build.launch hands fn its arguments and the current stream, then
    counts one launch in its trace counter, or, on a nonzero CUDA error
    code, raises and counts none (a stand-in fn and stream on the CPU;
    with tracing off nothing is kept)."""
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: -1,
                        raising=False)
    monkeypatch.setattr(build, "current_stream", lambda dev: 1234)
    calls = []

    def fn(*args):
        calls.append(args)
        return rc
    trace.disable()
    trace.drain()
    if on:
        trace.enable()
    try:
        with trace.call("engine.find_matches"):
            if rc:
                with pytest.raises(RuntimeError, match="kernels.fake launch "
                                   "failed: CUDA error 700"):
                    build.launch(fn, torch.zeros(1), 5, 6,
                                 counter="kernels.fake.launches")
            else:
                build.launch(fn, torch.zeros(1), 5, 6,
                             counter="kernels.fake.launches")
    finally:
        trace.disable()
    kept = trace.drain()
    assert calls == [(5, 6, 1234)]
    assert list(kept["counters"].values()) == (
        [{"kernels.fake.launches": 1}] if on and not rc else [])


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
        got, launched = _add_one(xc)
        assert launched == 1
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
    got, launched = _add_one(x)
    assert launched == 1
    assert torch.equal(got, probe.add_one_plain(x))
