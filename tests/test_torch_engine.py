"""End-to-end port against mumemto_tpu: .mums bytes, the CLI, the oracle,
and the rule that the port never imports jax.

Tolerance: byte equality of the written outputs.
"""

import gzip
import os
import subprocess
import sys

import pytest
import torch

from mumemto_tpu import cli as jax_cli
from mumemto_tpu import engine as jax_engine
from mumemto_tpu import options
from mumemto_tpu.oracle import naive
from mumemto_tpu_torch import cli as t_cli
from mumemto_tpu_torch import device as t_device
from mumemto_tpu_torch import engine as t_engine
from conftest import build, mutated_collection, rand_seq
from test_torch_suffix import with_n

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (docs, revcomp, k, N bases, planted repeat)
CASES = [(2, True, 0, False, False), (3, False, 0, False, False),
         (4, True, -1, False, False), (5, False, -1, True, False),
         (6, True, 2, False, True), (8, False, 2, False, False),
         (8, True, 0, True, True), (3, True, -1, False, True)]


def _docs(rng, n_docs, n_bases, rep):
    docs = mutated_collection(rng, n_docs, base_len=400,
                              insert_rep=rand_seq(rng, 40) if rep else None)
    return with_n(docs, rng, rate=0.005) if n_bases else docs


@pytest.mark.parametrize("n_docs,revcomp,k,n_bases,rep", CASES)
def test_mums_bytes_match_jax(rng, n_docs, revcomp, k, n_bases, rep):
    rb = build(_docs(rng, n_docs, n_bases, rep), use_revcomp=revcomp)
    opts = options.normalize(rb.num_docs, num_distinct_docs=k,
                             use_revcomp=revcomp, quiet=True)
    want = jax_engine.find_matches(rb, opts, show_progress=False)
    got = t_engine.find_matches(rb, opts, device="cpu")
    assert got.output_bytes() == want.output_bytes()
    assert got.bwt_runs == want.bwt_runs
    assert got.num_matches > 0


def test_mums_bytes_match_oracle(rng):
    rb = build(mutated_collection(rng, 4, base_len=500))
    opts = options.normalize(rb.num_docs, quiet=True)
    got = t_engine.find_matches(rb, opts, device="cpu").output_bytes()
    assert got and got == naive.oracle_output(rb, opts)


def _write_fastas(tmp_path, docs):
    """g0 gzipped, g1 lowercase, the rest plain."""
    paths = []
    for i, d in enumerate(docs):
        body = d[0].lower() if i == 1 else d[0]
        text = f">s{i}\n{body[:150]}\n{body[150:]}\n"
        p = tmp_path / (f"g{i}.fa.gz" if i == 0 else f"g{i}.fa")
        if i == 0:
            with gzip.open(p, "wt") as f:
                f.write(text)
        else:
            p.write_text(text)
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("k", [0, -1, 2])
@pytest.mark.parametrize("n_bases", [False, True])
def test_cli_bytes_match_jax(rng, tmp_path, k, n_bases):
    paths = _write_fastas(tmp_path, _docs(rng, 4, n_bases, False))
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jax_cli.main(paths + ["-o", out_j, "-k", str(k)]) == 0
    assert t_cli.main(paths + ["-o", out_t, "-k", str(k),
                               "--device", "cpu"]) == 0
    for ext in (".mums", ".lengths"):
        with open(out_j + ext, "rb") as a, open(out_t + ext, "rb") as b:
            assert a.read() == b.read(), ext
    assert os.path.getsize(out_t + ".mums") > 0


def test_module_entry_point(rng, tmp_path):
    paths = _write_fastas(tmp_path, _docs(rng, 3, False, False))
    out = str(tmp_path / "m")
    run = subprocess.run(
        [sys.executable, "-m", "mumemto_tpu_torch", *paths, "-o", out,
         "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert run.returncode == 0, run.stderr
    assert os.path.getsize(out + ".mums") > 0
    assert os.path.exists(out + ".lengths")


@pytest.mark.parametrize("argv", [["-M"], ["-b"], ["-f", "2"], ["-F", "5"],
                                  ["-g"], ["-A"], ["-P"], ["--seq-shards", "2"],
                                  ["-p", "x"], ["-a", "x"], ["-M", "-n"]])
def test_cli_refuses_unported_flags(tmp_path, capsys, argv):
    assert t_cli.main(["g.fa", "-o", str(tmp_path / "o"), *argv]) == 2
    assert "not yet ported" in capsys.readouterr().err
    assert not os.path.exists(str(tmp_path / "o.mums"))


def test_cli_refuses_subcommands(capsys):
    assert t_cli.main(["viz", "-m", "x.mums"]) == 2
    assert "not yet ported" in capsys.readouterr().err


def test_engine_refuses_unported_modes(rng):
    rb = build(mutated_collection(rng, 2, base_len=100))
    for kw in ({"rare_freq": 2}, {"merge": True}):
        opts = options.normalize(rb.num_docs, quiet=True, **kw)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            t_engine.find_matches(rb, opts, device="cpu")


def test_port_never_imports_jax():
    code = ("import sys; import mumemto_tpu_torch, mumemto_tpu_torch.engine,"
            " mumemto_tpu_torch.cli, mumemto_tpu_torch.convert,"
            " mumemto_tpu_torch.kernels.kr_mask, mumemto_tpu_torch.kernels.build;"
            " assert 'jax' not in sys.modules, sorted("
            "m for m in sys.modules if m.startswith('jax'))")
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr


def test_resolve_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_device.resolve("cuda")
    assert t_device.resolve("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        t_device.resolve("meta")


@pytest.mark.gpu
def test_cuda_mums_bytes_match_cpu(rng):
    """The card's output equals the CPU path's, byte for byte."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rb = build(_docs(rng, 5, True, True))
    opts = options.normalize(rb.num_docs, quiet=True)
    got = t_engine.find_matches(rb, opts, device="cuda").output_bytes()
    assert got == t_engine.find_matches(rb, opts, device="cpu").output_bytes()
