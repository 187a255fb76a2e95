"""The port's CLI beyond the build command: every analysis subcommand
against mumemto_tpu's CLI, `mori` and `--version`, and the progress bar
and profile hook of the port's engine.

One collection shape throughout: 3 documents of 400 bp, each two records
(250 + 150 bp), built once per module with the port's CLI on the CPU.
Tolerance: equal exit codes, equal stdout and stderr, and the same output
files with equal bytes (gzip files compared by their decompressed
content: the gzip header holds the time of writing).
"""

import contextlib
import dataclasses
import gzip
import os
import shutil

import numpy as np
import pytest
import torch

from mumemto_tpu import cli as jax_cli
from mumemto_tpu import options
from mumemto_tpu_torch import cli as t_cli
from mumemto_tpu_torch import progress
from mumemto_tpu_torch import engine as t_engine
from mumemto_tpu_torch.ops import pfp as t_pfp
from conftest import build, rand_seq

# several test workers share the machine's cores
torch.set_num_threads(2)

FASTAS = ["g0.fa", "g1.fa", "g2.fa"]


def _docs(rng):
    """3 mutated copies of a 250 + 150 bp two-record genome."""
    base = [rand_seq(rng, 250), rand_seq(rng, 150)]
    docs = []
    for _ in range(3):
        recs = []
        for b in base:
            s = list(b)
            for _ in range(3):
                s[int(rng.integers(0, len(s)))] = rng.choice(list("ACGT"))
            recs.append("".join(s))
        docs.append(recs)
    return docs


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """A directory of FASTAs (named by relative paths in the .lengths
    files) and the port's outputs: out.* (MUMs), outb.bumbl, memd.mems
    (-f 2) and ct.* (-M)."""
    d = tmp_path_factory.mktemp("built")
    rng = np.random.default_rng(12345)
    for name, recs in zip(FASTAS, _docs(rng)):
        (d / name).write_text(f">c1\n{recs[0]}\n>c2\n{recs[1]}\n")
    with contextlib.chdir(d):
        for out, flags in (("out", []), ("outb", ["-b"]),
                           ("memd", ["-f", "2"]), ("ct", ["-M"])):
            assert t_cli.main(FASTAS + ["-o", out, *flags,
                                        "--device", "cpu"]) == 0
    return d


SUBCOMMANDS = [
    ["collinear", "-m", "out.mums", "-o", "blocks.mums"],
    ["convert", "-m", "out.mums", "-o", "conv.bumbl"],
    ["view", "outb.bumbl"],
    ["coverage", "-m", "out.mums", "-l", "out.lengths"],
    ["extract", "-m", "out.mums", "-o", "x.fa"],
    ["lengths", *FASTAS, "-o", "lens"],
    ["inversion", "-m", "out.mums"],
    ["viz", "-m", "out.mums", "-o", "synteny.png"],
    ["label", "-m", "out.mums", "-o", "labeled.mums"],
    ["bed", "out.mums", "-L", "10"],
    ["trim", "-m", "out.mums", "-o", "trimmed.mums"],
    ["tabix", "out.mums", "--no-tabix"],
    ["density", "-m", "memd.mems", "-l", "memd.lengths"],
    ["convert-thresh", "ct.mums", "-o", "ct_conv"],
]


def _files(d):
    out = {}
    for name in sorted(os.listdir(d)):
        data = (d / name).read_bytes()
        out[name] = gzip.decompress(data) if name.endswith(".gz") else data
    return out


@pytest.mark.parametrize("argv", SUBCOMMANDS, ids=[a[0] for a in SUBCOMMANDS])
def test_subcommand_matches_jax(built, tmp_path, capsys, argv):
    runs = {}
    d = tmp_path / "run"  # one path for both: outputs may record it
    for pkg, main in (("jax", jax_cli.main), ("torch", t_cli.main)):
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(built, d)
        with contextlib.chdir(d):
            rc = main(list(argv))
        cap = capsys.readouterr()
        runs[pkg] = (rc, cap.out, cap.err, _files(d))
    assert runs["torch"] == runs["jax"]
    rc, _out, _err, files = runs["torch"]
    assert rc == 0
    assert set(files) > set(_files(built)) or argv[0] in (
        "view", "coverage", "inversion", "bed")


def test_mori_prints_the_skull(capsys):
    assert t_cli.main(["mori"]) == 0
    out = capsys.readouterr().out
    assert out == jax_cli.SKULL + "\n"
    assert "{_'-K.__/" in out


def test_version(capsys):
    assert t_cli.main(["--version"]) == 0
    assert capsys.readouterr().out == "1.4.0\n"


# ---------------------------------------------------------------------------
# progress bar and profile hook
# ---------------------------------------------------------------------------

def _rb():
    return build(_docs(np.random.default_rng(7)))


def test_progress_bar_reaches_100(built, tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("MUMEMTO_TPU_PROGRESS", "1")
    shutil.copytree(built, tmp_path / "run")
    with contextlib.chdir(tmp_path / "run"):
        assert t_cli.main(FASTAS + ["-o", "p", "--device", "cpu"]) == 0
    err = capsys.readouterr().err
    assert "100.0%" in err and "[mumemto] |" in err
    assert progress.active() is None


def test_every_phase_maps_into_the_bar(tmp_path, monkeypatch):
    """Every phase the port emits, on every route, has a progress stage,
    and with the bar on each advance names a stage the bar knows."""
    monkeypatch.setenv("MUMEMTO_TPU_PROGRESS", "1")
    advanced = []
    real = progress.PhaseBar.advance

    def spy(self, stage):
        advanced.append(stage)
        real(self, stage)

    monkeypatch.setattr(progress.PhaseBar, "advance", spy)
    known = {name for name, _ in progress._STAGES}
    rb = _rb()
    pre = str(tmp_path / "ck")
    t_pfp.write_parse_files(rb, pre, torch.device("cpu"))
    meta = dataclasses.replace(rb, text=None)
    emitted = set()
    for kw in ({"rare_freq": 3}, {"merge": True}):
        opts = options.normalize(rb.num_docs, quiet=True, **kw)
        for run_rb, run_kw in ((rb, {"arrays_out_prefix": pre + "A"}),
                               (rb, {"backend": "direct"}),
                               (meta, {"parse_prefix": pre})):
            names = []
            t_engine.find_matches(run_rb, opts, device="cpu",
                                  phase=names.append, **run_kw)
            emitted |= set(names)
            t_engine.find_matches(run_rb, opts, device="cpu", **run_kw)
    assert emitted == set(t_engine.PROGRESS_STAGE)
    assert set(t_engine.PROGRESS_STAGE.values()) <= known
    assert advanced and set(advanced) <= known
    assert progress.active() is None


def test_default_hook_is_noop_when_off(monkeypatch, capsys):
    monkeypatch.delenv("MUMEMTO_TPU_PROGRESS", raising=False)
    monkeypatch.delenv("MUMEMTO_TPU_PROFILE", raising=False)
    assert t_engine._phase_logger(torch.device("cpu")) is None
    monkeypatch.setenv("MUMEMTO_TPU_PROFILE", "1")
    hook = t_engine._phase_logger(torch.device("cpu"))
    assert callable(hook)
    rb = _rb()
    t_engine.find_matches(rb, options.normalize(rb.num_docs, quiet=True),
                          device="cpu", show_progress=False)
    err = capsys.readouterr().err
    for stage in ("build_pfp", "dict_index", "parse_side",
                  "expand_sort_analyze", "compact", "emit"):
        assert f"[pfp_scan] {stage}: " in err, stage


def test_bar_released_on_failure(monkeypatch):
    monkeypatch.setenv("MUMEMTO_TPU_PROGRESS", "1")

    def boom(*a, **kw):
        raise _Boom

    monkeypatch.setattr(t_engine, "_find_matches_inner", boom)
    rb = _rb()
    with pytest.raises(_Boom):
        t_engine.find_matches(rb, options.normalize(rb.num_docs, quiet=True),
                              device="cpu")
    assert progress.active() is None


class _Boom(Exception):
    pass
