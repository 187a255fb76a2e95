"""End-to-end port against mumemto_tpu: .mums, .mems, .bumbl and merge
metadata bytes, the CLI, the oracle, and the rule that the port never
imports jax.

Tolerance: byte equality of the written outputs.
"""

import gzip
import os
import subprocess
import sys

import numpy as np
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

# several test workers share the machine's cores
torch.set_num_threads(2)

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


MEM_CASES = [(0, 2, 0), (0, 3, 0), (2, 2, 0), (0, 0, 0), (0, 2, -1)]


def _mem_rb(rng, revcomp=True):
    """tests/test_matches.py's MEM collection: 3 docs, a planted repeat."""
    rep = rand_seq(rng, 60)
    docs = mutated_collection(rng, 3, base_len=150, insert_rep=rep)
    return build(docs, use_revcomp=revcomp)


@pytest.mark.parametrize("revcomp", [True, False])
@pytest.mark.parametrize("k,f,F", MEM_CASES)
def test_mems_bytes_match_jax(rng, k, f, F, revcomp):
    rb = _mem_rb(rng, revcomp)
    opts = options.normalize(rb.num_docs, num_distinct_docs=k, rare_freq=f,
                             max_mem_freq=F, use_revcomp=revcomp, quiet=True)
    want = jax_engine.find_matches(rb, opts, show_progress=False)
    got = t_engine.find_matches(rb, opts, device="cpu")
    assert not opts.mum_mode
    assert got.output_bytes() == want.output_bytes()
    assert got.num_matches == want.num_matches
    assert got.bwt_runs == want.bwt_runs
    assert [(r[0], r[1].tolist(), r[2].tolist(), r[3].tolist())
            for r in got.mem_records] == \
        [(r[0], r[1].tolist(), r[2].tolist(), r[3].tolist())
         for r in want.mem_records]
    if F >= 0:
        assert got.num_matches > 0


@pytest.mark.parametrize("k,f,F", MEM_CASES)
def test_mems_bytes_match_oracle(rng, k, f, F):
    rb = _mem_rb(rng)
    opts = options.normalize(rb.num_docs, num_distinct_docs=k, rare_freq=f,
                             max_mem_freq=F, quiet=True)
    got = t_engine.find_matches(rb, opts, device="cpu").output_bytes()
    assert got == naive.oracle_output(rb, opts)


def _write_both(rb, opts, tmp_path):
    """Both packages' find_matches + write_outputs, to tmp_path/jax.* and
    tmp_path/torch.*."""
    jax_engine.write_outputs(
        jax_engine.find_matches(rb, opts, show_progress=False), rb,
        str(tmp_path / "jax"))
    t_engine.write_outputs(t_engine.find_matches(rb, opts, device="cpu"),
                           rb, str(tmp_path / "torch"))


def _same_files(tmp_path, exts):
    """The jax.* and torch.* files in tmp_path: the same set, equal
    bytes."""
    names = sorted(os.listdir(tmp_path))
    got = {n[len("torch"):] for n in names if n.startswith("torch.")}
    want = {n[len("jax"):] for n in names if n.startswith("jax.")}
    assert got == want == set(exts), (got, want)
    for ext in exts:
        a = (tmp_path / ("jax" + ext)).read_bytes()
        b = (tmp_path / ("torch" + ext)).read_bytes()
        assert a == b, ext
        assert a, ext


@pytest.mark.parametrize("revcomp", [True, False])
@pytest.mark.parametrize("anchor", [False, True])
def test_merge_metadata_matches_jax_and_oracle(rng, tmp_path, revcomp,
                                               anchor):
    rb = build(mutated_collection(rng, 3), use_revcomp=revcomp)
    opts = options.normalize(rb.num_docs, merge=True, anchor_merge=anchor,
                             use_revcomp=revcomp, quiet=True)
    got = t_engine.find_matches(rb, opts, device="cpu")
    want = jax_engine.find_matches(rb, opts, show_progress=False)
    finder = naive.run_finder(rb, opts)
    assert got.candidate_thresh.dtype == want.candidate_thresh.dtype
    assert (got.candidate_thresh == want.candidate_thresh).all()
    assert (got.candidate_thresh == np.asarray(finder.candidate_thresh)).all()
    assert (got.mum_positions == want.mum_positions).all()
    assert got.candidate_thresh.any()
    dl0 = rb.seq_lengths[0] // (2 if revcomp else 1)
    fwd, rev = t_engine.thresh_arrays(got, dl0)
    fo, ro = finder.thresh_arrays()
    assert (fwd == fo).all() and (rev == ro).all()
    for a, b in zip((fwd, rev), jax_engine.thresh_arrays(want, dl0)):
        assert (a == b).all()

    _write_both(rb, opts, tmp_path)
    _same_files(tmp_path, [".mums", ".athresh"] if anchor
                else [".mums", ".thresh", ".thresh_rev"])


@pytest.mark.parametrize("k", [0, -1])
def test_bumbl_bytes_match_jax(rng, tmp_path, k):
    rb = build(mutated_collection(rng, 4, base_len=400))
    opts = options.normalize(rb.num_docs, num_distinct_docs=k, binary=True,
                             quiet=True)
    _write_both(rb, opts, tmp_path)
    _same_files(tmp_path, [".bumbl"])


def _many_docs(rng, n_docs, base_len=200, sites=8):
    """n_docs copies of one base, each with one SNP at one of `sites`
    fixed positions: the conserved stretches between sites are MUMs."""
    base = np.frombuffer(rand_seq(rng, base_len).encode(), np.uint8)
    where = np.linspace(10, base_len - 10, sites).astype(int)
    docs = []
    for _ in range(n_docs):
        d = base.copy()
        i = where[int(rng.integers(0, sites))]
        d[i] = b"ACGT"[(b"ACGT".index(bytes(d[i:i + 1])) + 1) % 4]
        docs.append([d.tobytes().decode()])
    return docs


@pytest.mark.parametrize("k", [0, -5])
def test_many_docs_walk_branch_matches_jax(rng, k):
    """130 docs: the MUM size cap is 256, so the scan takes the
    probe-guarded walk."""
    rb = build(_many_docs(rng, 130))
    opts = options.normalize(rb.num_docs, num_distinct_docs=k, quiet=True)
    assert t_engine.interval_size_cap(opts, rb.num_docs) == 256
    want = jax_engine.find_matches(rb, opts, show_progress=False)
    got = t_engine.find_matches(rb, opts, device="cpu")
    assert got.num_matches > 0
    assert got.output_bytes() == want.output_bytes()


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


@pytest.mark.parametrize("argv,exts", [
    (["-f", "3"], [".mems"]),
    (["-F", "5"], [".mums"]),
    (["-M"], [".mums", ".thresh", ".thresh_rev"]),
    (["-M", "-n"], [".mums", ".athresh"]),
    (["-b"], [".bumbl"]),
])
def test_cli_flags_bytes_match_jax(rng, tmp_path, argv, exts):
    rep = rand_seq(rng, 40)
    docs = mutated_collection(rng, 4, base_len=400, insert_rep=rep)
    paths = _write_fastas(tmp_path, docs)
    out = tmp_path / "out"
    out.mkdir()
    assert jax_cli.main(paths + ["-o", str(out / "jax"), *argv]) == 0
    assert t_cli.main(paths + ["-o", str(out / "torch"), *argv,
                               "--device", "cpu"]) == 0
    _same_files(out, exts + [".lengths"])


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


@pytest.mark.parametrize("argv", [["-g"], ["-A"], ["-P"], ["--seq-shards", "2"],
                                  ["-p", "x"], ["-a", "x"]])
def test_cli_refuses_unported_flags(tmp_path, capsys, argv):
    assert t_cli.main(["g.fa", "-o", str(tmp_path / "o"), *argv]) == 2
    assert "not yet ported" in capsys.readouterr().err
    assert not os.path.exists(str(tmp_path / "o.mums"))


def test_cli_refuses_subcommands(capsys):
    assert t_cli.main(["viz", "-m", "x.mums"]) == 2
    assert "not yet ported" in capsys.readouterr().err


def test_port_never_imports_jax():
    code = ("import sys; import mumemto_tpu_torch, mumemto_tpu_torch.engine,"
            " mumemto_tpu_torch.cli, mumemto_tpu_torch.convert,"
            " mumemto_tpu_torch.kernels.kr_mask, mumemto_tpu_torch.kernels.build,"
            " mumemto_tpu_torch.kernels.probe, mumemto_tpu_torch.ops.pipeline;"
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


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [{"rare_freq": 3}, {"rare_freq": 0},
                                {"merge": True},
                                {"merge": True, "anchor_merge": True},
                                {"binary": True}])
def test_cuda_outputs_match_cpu(rng, tmp_path, kw):
    """MEM mode, merge metadata and .bumbl: the card's files equal the CPU
    path's, byte for byte."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rb = _mem_rb(rng)
    opts = options.normalize(rb.num_docs, quiet=True, **kw)
    for dev in ("cuda", "cpu"):
        t_engine.write_outputs(t_engine.find_matches(rb, opts, device=dev),
                               rb, str(tmp_path / dev))
    names = sorted(os.listdir(tmp_path))
    assert len(names) >= 2
    for name in names:
        if name.startswith("cuda."):
            other = tmp_path / ("cpu." + name[len("cuda."):])
            assert (tmp_path / name).read_bytes() == other.read_bytes(), name
