"""End-to-end port against mumemto_tpu: .mums, .mems, .bumbl and merge
metadata bytes, the direct backend (-g), the parse files (-P/-p), the
array checkpoints (-A/-a), the CLI, the oracle, and the rule that the port
never imports jax.

Tolerance: byte equality of the written outputs.
"""

import dataclasses
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
from mumemto_tpu_torch.ops import suffix as t_suffix
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


@pytest.mark.parametrize("argv", [["--seq-shards", "2"]])
def test_cli_refuses_unported_flags(rng, tmp_path, capsys, argv):
    """No build flag is refused as unported: --seq-shards runs, with the
    unsharded run's bytes. What is refused (exit 1, as in the JAX package)
    is --seq-shards beside -A/-a/-P/-g."""
    paths = _write_fastas(tmp_path, _docs(rng, 3, False, False))
    cpu = ["--device", "cpu"]
    assert t_cli.main(paths + ["-o", str(tmp_path / "o"), *argv, *cpu]) == 0
    assert "not yet ported" not in capsys.readouterr().err
    assert t_cli.main(paths + ["-o", str(tmp_path / "single"), *cpu]) == 0
    with open(str(tmp_path / "o.mums"), "rb") as a, \
            open(str(tmp_path / "single.mums"), "rb") as b:
        assert a.read() == b.read() != b""
    assert t_cli.main(paths + ["-o", str(tmp_path / "g"), *argv, "-g",
                               *cpu]) == 1
    assert "--seq-shards is not supported together" in capsys.readouterr().err
    assert not os.path.exists(str(tmp_path / "g.mums"))


def test_cli_refuses_subcommands(tmp_path, capsys):
    """No subcommand or flag exits 2 ("not yet ported"): merge
    --collective and --seq-shards reach their routes, and fail there on
    these missing inputs as the JAX package's CLI does (exit 1)."""
    assert t_cli.main(["merge", "a.mums", "b.mums", "--collective"]) == 1
    err = capsys.readouterr().err
    assert "not yet ported" not in err
    assert "--collective applies to anchor-based merging only" in err
    assert t_cli.main(["g.fa", "-o", str(tmp_path / "o"),
                       "--seq-shards", "4", "--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert "not yet ported" not in err
    assert "Multiple FASTA inputs required" in err
    assert jax_cli.main(["merge", "a.mums", "b.mums", "--collective"]) == 1


# neither jax nor anything of the JAX package (nor its benchmark script)
_NO_JAX = ("bad = sorted(m for m in sys.modules if m.split('.')[0] in "
           "('jax', 'jaxlib', 'mumemto_tpu', 'bench')); assert not bad, bad")


def test_port_never_imports_jax(rng, tmp_path):
    code = ("import sys; import mumemto_tpu_torch, mumemto_tpu_torch.engine,"
            " mumemto_tpu_torch.cli, mumemto_tpu_torch.convert,"
            " mumemto_tpu_torch.device,"
            " mumemto_tpu_torch.kernels.kr_mask, mumemto_tpu_torch.kernels.build,"
            " mumemto_tpu_torch.kernels.probe, mumemto_tpu_torch.ops.pipeline,"
            " mumemto_tpu_torch.ops.suffix, mumemto_tpu_torch.ops.pfp,"
            " mumemto_tpu_torch.ops.intervals, mumemto_tpu_torch.library,"
            " mumemto_tpu_torch.properties, mumemto_tpu_torch.analysis.merge,"
            " mumemto_tpu_torch.analysis.dispatch, mumemto_tpu_torch.formats,"
            " mumemto_tpu_torch.refbuilder, mumemto_tpu_torch.native,"
            " mumemto_tpu_torch.oracle.naive,"
            " mumemto_tpu_torch.parallel.mumemtom,"
            " mumemto_tpu_torch.parallel.mesh,"
            " mumemto_tpu_torch.parallel.partition,"
            " mumemto_tpu_torch.parallel.seqpfp,"
            " mumemto_tpu_torch.parallel.widepfp,"
            " mumemto_tpu_torch.parallel.collective_merge,"
            " mumemto_tpu_torch.capi.build_capi; " + _NO_JAX)
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    # python -m mumemto_tpu_torch mori / view / merge (anchor)
    paths = _write_fastas(tmp_path, _docs(rng, 3, False, False))
    pre = [str(tmp_path / "p0"), str(tmp_path / "p1")]
    for part, p in zip(([paths[0], paths[1]], [paths[0], paths[2]]), pre):
        assert t_cli.main(part + ["-o", p, "-M", "-n", "--device", "cpu"]) == 0
    bumbl = str(tmp_path / "all")
    assert t_cli.main(paths + ["-o", bumbl, "-b", "--device", "cpu"]) == 0
    as_module = ("import runpy, sys\n"
                 "try:\n"
                 "    runpy.run_module('mumemto_tpu_torch', run_name='__main__')\n"
                 "except SystemExit as e:\n"
                 "    rc = e.code\n" + _NO_JAX + "\nsys.exit(rc)\n")
    for argv in (["mori"], ["view", bumbl + ".bumbl"],
                 ["merge", pre[0] + ".mums", pre[1] + ".mums", "-o",
                  str(tmp_path / "merged")]):
        run = subprocess.run([sys.executable, "-c", as_module, *argv],
                             cwd=ROOT, capture_output=True, text=True,
                             timeout=300)
        assert run.returncode == 0, (argv, run.stderr)
        assert run.stdout or argv[0] == "merge", argv
    assert os.path.getsize(str(tmp_path / "merged.mums")) > 0


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


# (label, MatchOptions keywords): MUM mode, multi-MEMs, merge metadata
ROUTE_MODES = [("mums", {}), ("-f 3", {"rare_freq": 3}),
               ("-M", {"merge": True})]


def _same_results(got, want, opts):
    assert got.output_bytes() == want.output_bytes()
    assert got.num_matches == want.num_matches > 0
    if opts.merge:
        assert (got.candidate_thresh == want.candidate_thresh).all()
        assert (got.mum_positions == want.mum_positions).all()


def _route_rb(rng):
    rep = rand_seq(rng, 40)
    return build(mutated_collection(rng, 4, base_len=400, insert_rep=rep))


def _route_docs(rng):
    return mutated_collection(rng, 3, base_len=400,
                              insert_rep=rand_seq(rng, 40))


@pytest.mark.parametrize("label,kw", ROUTE_MODES)
def test_direct_backend_matches_jax(rng, label, kw):
    rb = _route_rb(rng)
    opts = options.normalize(rb.num_docs, quiet=True, **kw)
    want = jax_engine.find_matches(rb, opts, backend="direct",
                                   show_progress=False)
    got = t_engine.find_matches(rb, opts, device="cpu", backend="direct")
    _same_results(got, want, opts)
    assert got.bwt_runs == want.bwt_runs
    assert got.text_length == want.text_length == rb.text.size
    pfp = t_engine.find_matches(rb, opts, device="cpu")
    assert pfp.output_bytes() == got.output_bytes()
    with pytest.raises(ValueError, match="unknown backend"):
        t_engine.find_matches(rb, opts, device="cpu", backend="gsacak")


@pytest.mark.parametrize("label,kw", ROUTE_MODES)
def test_parse_prefix_resume_matches_jax(rng, tmp_path, label, kw):
    """-p: the scan resumes from .dict/.parse with no text (rb.text is
    None); results equal the JAX resume and the port's full run, and
    text_length falls back to the .lengths total."""
    from mumemto_tpu.ops import pfp as jax_pfp
    rb = _route_rb(rng)
    opts = options.normalize(rb.num_docs, quiet=True, **kw)
    pre = str(tmp_path / "ck")
    jax_pfp.write_parse_files(rb, pre)
    meta = dataclasses.replace(rb, text=None)
    want = jax_engine.find_matches(meta, opts, parse_prefix=pre,
                                   show_progress=False)
    stages = []
    got = t_engine.find_matches(meta, opts, device="cpu", parse_prefix=pre,
                                phase=stages.append)
    _same_results(got, want, opts)
    assert got.bwt_runs == want.bwt_runs
    assert got.text_length == want.text_length == sum(rb.seq_lengths)
    assert stages[0] == "read_parse" and "build_pfp" not in stages
    full = t_engine.find_matches(rb, opts, device="cpu")
    assert got.output_bytes() == full.output_bytes()


@pytest.mark.parametrize("label,kw", ROUTE_MODES)
@pytest.mark.parametrize("backend", ["pfp", "direct"])
def test_arrays_out_and_replay_match_jax(rng, tmp_path, label, kw, backend):
    """-A writes .sa/.lcp/.bwt from the scan's rows (real rows only, equal
    to JAX's bytes); find_matches_from_arrays replays them (-a) to the
    same results as JAX's replay and the scan itself."""
    from mumemto_tpu import formats
    rb = _route_rb(rng)
    opts = options.normalize(rb.num_docs, quiet=True, **kw)
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "torch")
    want = jax_engine.find_matches(rb, opts, backend=backend,
                                   arrays_out_prefix=out_j,
                                   show_progress=False)
    got = t_engine.find_matches(rb, opts, device="cpu", backend=backend,
                                arrays_out_prefix=out_t)
    _same_results(got, want, opts)
    for ext in (".sa", ".lcp", ".bwt"):
        a = (tmp_path / ("jax" + ext)).read_bytes()
        assert a and (tmp_path / ("torch" + ext)).read_bytes() == a, ext
    assert os.path.getsize(out_t + ".sa") == 5 * rb.text.size
    sa = formats.read_5byte(out_t + ".sa").astype(np.int64)
    lcp = formats.read_5byte(out_t + ".lcp").astype(np.int64)
    bwt = formats.read_rl_bwt(out_t + ".bwt")
    da = rb.doc_array(sa)
    replay_j = jax_engine.find_matches_from_arrays(sa, lcp, bwt, da, rb, opts)
    replay_t = t_engine.find_matches_from_arrays(sa, lcp, bwt, da, rb, opts,
                                                 device="cpu")
    _same_results(replay_t, replay_j, opts)
    assert replay_t.output_bytes() == got.output_bytes()


@pytest.mark.parametrize("label,kw", ROUTE_MODES)
def test_compute_arrays_matches_jax(rng, label, kw):
    rb = _route_rb(rng)
    opts = options.normalize(rb.num_docs, quiet=True, **kw)
    want = jax_engine.compute_arrays(rb)
    got = t_engine.compute_arrays(rb, device="cpu")
    for g, w in zip(got, want):
        assert g.dtype == np.asarray(w).dtype
        assert (g == np.asarray(w)).all()
    _same_results(
        t_engine.find_matches_from_arrays(*got, rb, opts, device="cpu"),
        jax_engine.find_matches_from_arrays(*want, rb, opts), opts)
    # the direct backend's text length: at least 4 pad bytes, bucketed
    for n in (rb.text.size, 0, 4092, 4093, 6140, 6141, 10**6):
        assert t_suffix.bucket(n + 4, lo=4096) == jax_engine.pad_size(n)


def _cli_both(argv_j, argv_t):
    assert jax_cli.main(argv_j) == 0
    assert t_cli.main(argv_t + ["--device", "cpu"]) == 0


@pytest.mark.parametrize("flags", [[], ["-f", "3"]])
def test_cli_parse_then_resume_matches_jax(rng, tmp_path, flags):
    """-P writes .dict/.parse/.lengths, -p resumes (no FASTA) to the same
    output as the full run; every file equals the JAX package's."""
    paths = _write_fastas(tmp_path, _route_docs(rng))
    out = tmp_path / "out"
    out.mkdir()
    j, t = str(out / "jax"), str(out / "torch")
    _cli_both(paths + ["-o", j, "-P"], paths + ["-o", t, "-P"])
    _same_files(out, [".dict", ".parse", ".lengths"])
    res = tmp_path / "res"
    res.mkdir()
    _cli_both(["-p", j, "-o", str(res / "jax"), *flags],
              ["-p", t, "-o", str(res / "torch"), *flags])
    ext = ".mems" if flags else ".mums"
    _same_files(res, [ext])
    assert t_cli.main(paths + ["-o", str(tmp_path / "full"), *flags,
                               "--device", "cpu"]) == 0
    assert (res / ("torch" + ext)).read_bytes() == \
        (tmp_path / ("full" + ext)).read_bytes()


@pytest.mark.parametrize("flags", [[], ["-g"], ["-M"]])
def test_cli_arrays_out_then_replay_matches_jax(rng, tmp_path, flags):
    """-A writes .sa/.lcp/.bwt beside the matches, -a replays them (no
    FASTA) to the same matches; every file equals the JAX package's."""
    paths = _write_fastas(tmp_path, _route_docs(rng))
    out = tmp_path / "out"
    out.mkdir()
    j, t = str(out / "jax"), str(out / "torch")
    _cli_both(paths + ["-o", j, "-A", *flags], paths + ["-o", t, "-A", *flags])
    merge = [".thresh", ".thresh_rev"] if "-M" in flags else []
    _same_files(out, [".sa", ".lcp", ".bwt", ".mums", ".lengths"] + merge)
    res = tmp_path / "res"
    res.mkdir()
    _cli_both(["-a", j, "-o", str(res / "jax")],
              ["-a", t, "-o", str(res / "torch")])
    _same_files(res, [".mums"])
    assert (res / "torch.mums").read_bytes() == \
        (out / "torch.mums").read_bytes()


def test_cli_gsacak_routes_direct_backend(rng, tmp_path, monkeypatch):
    """-g runs the direct backend (and the default run does not); its
    .mums equal the JAX package's -g and the PFP run's."""
    from mumemto_tpu_torch.ops import pipeline as t_pipeline
    calls = []
    real = t_pipeline.scan_collection

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(t_pipeline, "scan_collection", spy)
    paths = _write_fastas(tmp_path, _route_docs(rng))
    out = tmp_path / "out"
    out.mkdir()
    assert t_cli.main(paths + ["-o", str(tmp_path / "pfp"),
                               "--device", "cpu"]) == 0
    assert not calls, "the default run must not use the direct backend"
    _cli_both(paths + ["-o", str(out / "jax"), "-g"],
              paths + ["-o", str(out / "torch"), "-g"])
    assert calls, "-g must route to the direct backend"
    _same_files(out, [".mums", ".lengths"])
    assert (out / "torch.mums").read_bytes() == \
        (tmp_path / "pfp.mums").read_bytes()


def test_cli_resume_without_inputs_fails_cleanly(tmp_path, capsys):
    assert t_cli.main(["-o", str(tmp_path / "o"), "--device", "cpu"]) == 1
    assert "Need to provide" in capsys.readouterr().err
    assert t_cli.main(["-p", str(tmp_path / "missing"), "-o",
                       str(tmp_path / "o"), "--device", "cpu"]) == 1


@pytest.mark.gpu
def test_cuda_routes_match_cpu(rng, tmp_path):
    """-g, -A and -P on the card write the CPU path's bytes; -p and -a
    replay them on the card to the same .mums."""
    from mumemto_tpu_torch.ops import pfp as t_pfp
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rb = _route_rb(rng)
    opts = options.normalize(rb.num_docs, quiet=True)
    for dev in ("cuda", "cpu"):
        pre = str(tmp_path / dev)
        res = t_engine.find_matches(rb, opts, device=dev, backend="direct",
                                    arrays_out_prefix=pre)
        t_engine.write_outputs(res, rb, pre)
        t_pfp.write_parse_files(rb, pre, torch.device(dev))
    for ext in (".mums", ".sa", ".lcp", ".bwt", ".dict", ".parse"):
        a = (tmp_path / ("cuda" + ext)).read_bytes()
        assert a and a == (tmp_path / ("cpu" + ext)).read_bytes(), ext
    meta = dataclasses.replace(rb, text=None)
    got = t_engine.find_matches(meta, opts, device="cuda",
                                parse_prefix=str(tmp_path / "cuda"))
    assert got.output_bytes() == (tmp_path / "cpu.mums").read_bytes()


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["pfp", "direct"])
@pytest.mark.parametrize("label,kw", ROUTE_MODES[:2])
def test_cuda_main_path_launches_the_kernels(rng, label, kw, backend):
    """On the card the PFP route launches the KR kernel and the running
    max / min kernel, -g the scan kernel alone, in MUM mode and with -f 3;
    each gives the CPU path's bytes."""
    from mumemto_tpu_torch import bench
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rb = _route_rb(rng)
    opts = options.normalize(rb.num_docs, quiet=True, **kw)
    got, _s, launches = bench.counted(torch, lambda: t_engine.find_matches(
        rb, opts, device="cuda", backend=backend))
    assert (launches["kr_break_mask"] > 0) == (backend == "pfp")
    assert launches["running_scan"] > 0
    want = t_engine.find_matches(rb, opts, device="cpu", backend=backend)
    assert got.output_bytes() == want.output_bytes()
    assert got.num_matches > 0
