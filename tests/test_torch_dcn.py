"""The port's multi-process placement (parallel/dcn): two real processes
in one gloo group over 127.0.0.1 must write the files of the port's
single-process mumemtom.run_partitioned on the same partitions, which are
also the files mumemto_tpu's run_partitioned writes; with the host fold and
with the collective fold. A failed merge on rank 0 must fail both ranks.
Tolerance: none, the files are equal byte for byte.
"""

import os
import socket
import subprocess
import sys

import pytest
import torch

from mumemto_tpu.parallel import mumemtom as jax_mumemtom
from mumemto_tpu_torch.parallel import dcn, mumemtom
from conftest import mutated_collection

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT_S = 600

# argv: rank, world size, port, output prefix, file list, repo root,
# collective (0/1), device, mode ("ok", or "fail": rank 1 removes its
# partition's .mums after writing it, so rank 0's merge cannot read it,
# or "scanfail": rank 1's scan raises)
WORKER = r"""
import os, sys
sys.path.insert(0, sys.argv[6])
import torch
torch.set_num_threads(2)
from mumemto_tpu_torch.parallel import dcn, mumemtom
rank, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
out_prefix, filelist = sys.argv[4], sys.argv[5]
collective, device, mode = sys.argv[7] == "1", sys.argv[8], sys.argv[9]
scanned = []
real = mumemtom.scan_partition
def scan(files, pfx, **kw):
    if mode == "scanfail" and rank == 1:
        raise OSError("scan of " + pfx + " broke")
    out = real(files, pfx, **kw)
    scanned.append(int(pfx.rsplit("_part", 1)[1]))
    if mode == "fail" and rank == 1:
        os.remove(out)
    return out
mumemtom.scan_partition = scan
dcn.initialize(f"127.0.0.1:{port}", nproc, rank)
files = open(filelist).read().split()
dcn.run_partitioned_dcn(files, out_prefix, anchor=True,
                        collective=collective, device=device)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "mumemto_tpu"))
assert not bad, bad
print("WORKER_OK", rank, "scanned", scanned)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _write_collection(rng, tmp_path, n=5):
    paths = []
    for i, d in enumerate(mutated_collection(rng, n, base_len=500)):
        p = tmp_path / f"g{i}.fa"
        p.write_text(f">g{i}\n{d[0]}\n")
        paths.append(str(p))
    return paths


def _run_pair(tmp_path, paths, prefix, collective, device="cpu", mode="ok"):
    """Both workers' (return code, output); one retry on a fresh port
    when the first attempt of an "ok" pair fails (a loaded host can miss
    gloo's connect window; a real fault shows again)."""
    filelist = tmp_path / "files.txt"
    filelist.write_text("\n".join(paths))
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_", "MUMEMTO_"))}
    env["GLOO_SOCKET_IFNAME"] = "lo"

    def attempt():
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, str(worker), str(rank), "2", str(port), prefix,
             str(filelist), ROOT, "1" if collective else "0", device, mode],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env) for rank in (0, 1)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=LIMIT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        return [(p.returncode, out) for p, out in zip(procs, outs)]

    got = attempt()
    if mode == "ok" and any(rc != 0 for rc, _ in got):
        got = attempt()
    return got


def _check_pair_equals_single(rng, tmp_path, collective, device):
    paths = _write_collection(rng, tmp_path)
    parts = mumemtom.auto_partition(paths, 2, anchor=True)
    assert len(parts) == 2
    single = str(tmp_path / "single")
    mumemtom.run_partitioned(parts, single, anchor=True, device=device)
    pair = str(tmp_path / "dcn")
    got = _run_pair(tmp_path, paths, pair, collective, device)
    for rank, (rc, out) in enumerate(got):
        assert rc == 0, out[-2000:]
        # placement is by index mod process count
        assert f"WORKER_OK {rank} scanned [{rank}]" in out, out[-2000:]
    for ext in (".mums", ".athresh", ".lengths"):
        want = open(single + ext, "rb").read()
        assert want and open(pair + ext, "rb").read() == want, ext
    return paths, single


@pytest.mark.parametrize("collective", [False, True])
def test_dcn_two_process_equals_single(rng, tmp_path, collective):
    paths, single = _check_pair_equals_single(rng, tmp_path, collective,
                                              "cpu")
    # and the JAX package's files for the same partitions
    ref = str(tmp_path / "jax")
    jax_mumemtom.run_partitioned(
        jax_mumemtom.auto_partition(paths, 2, anchor=True), ref, anchor=True)
    for ext in (".mums", ".athresh", ".lengths"):
        assert open(ref + ext, "rb").read() == open(single + ext,
                                                    "rb").read(), ext


def test_dcn_failed_merge_fails_both_ranks(rng, tmp_path):
    """Rank 0's merge cannot read rank 1's partition: rank 0 raises its
    error, rank 1 learns of it from the gathered outcome, and both exit
    non-zero inside the time limit."""
    paths = _write_collection(rng, tmp_path)
    got = _run_pair(tmp_path, paths, str(tmp_path / "dcn"), False,
                    mode="fail")
    (rc0, out0), (rc1, out1) = got
    assert rc0 not in (0, None) and rc1 not in (0, None), (out0[-1500:],
                                                           out1[-1500:])
    assert "WORKER_OK" not in out0 + out1
    assert "dcn_part1.mums" in out0
    assert "merge failed on process 0" in out1
    assert not os.path.exists(str(tmp_path / "dcn") + ".mums")


def test_dcn_failed_scan_fails_both_ranks(rng, tmp_path):
    """Rank 1's scan raises: it raises its error, rank 0 learns of it at
    the barrier after the scans and merges nothing, and both exit non-zero
    inside the time limit."""
    paths = _write_collection(rng, tmp_path)
    got = _run_pair(tmp_path, paths, str(tmp_path / "dcn"), False,
                    mode="scanfail")
    (rc0, out0), (rc1, out1) = got
    assert rc0 not in (0, None) and rc1 not in (0, None), (out0[-1500:],
                                                           out1[-1500:])
    assert "WORKER_OK" not in out0 + out1
    assert "partition scan failed on process 1" in out0
    assert "dcn_part1 broke" in out1
    assert not os.path.exists(str(tmp_path / "dcn") + ".mums")


def test_initialize_arguments(monkeypatch):
    """The three variables are read when the arguments are absent; a part
    of them is refused before any group is made; importing the module
    pulls in no process-group machinery."""
    for k in ("MUMEMTO_COORDINATOR", "MUMEMTO_NUM_PROCESSES",
              "MUMEMTO_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="together"):
        dcn.initialize("127.0.0.1:1", num_processes=2)
    import torch.distributed as dist
    seen = {}
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: seen.update(kw))
    monkeypatch.setenv("MUMEMTO_COORDINATOR", "127.0.0.1:4321")
    monkeypatch.setenv("MUMEMTO_NUM_PROCESSES", "2")
    monkeypatch.setenv("MUMEMTO_PROCESS_ID", "1")
    dcn.initialize()
    assert seen["backend"] == "gloo" and seen["rank"] == 1
    assert seen["init_method"] == "tcp://127.0.0.1:4321"
    assert seen["world_size"] == 2
    assert seen["timeout"].total_seconds() == 1200
    for k in ("MUMEMTO_COORDINATOR", "MUMEMTO_NUM_PROCESSES",
              "MUMEMTO_PROCESS_ID"):
        monkeypatch.delenv(k)
    seen.clear()
    dcn.initialize(timeout_seconds=30)
    assert seen == {"backend": "gloo", "init_method": "env://",
                    "timeout": seen["timeout"]}
    assert seen["timeout"].total_seconds() == 30


@pytest.mark.gpu
@pytest.mark.parametrize("collective", [False, True])
def test_cuda_dcn_two_process_equals_single(rng, tmp_path, collective):
    """Two processes that share the card (gloo carries the barrier)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _check_pair_equals_single(rng, tmp_path, collective, "cuda")
