"""The port stands alone: no file of mumemto_tpu_torch and not chip_smoke.py
imports mumemto_tpu, bench or jax, the port runs with those unimportable,
and each host module the port keeps a copy of behaves as the original on
the same numpy-seeded inputs.

Tolerance: exact equality everywhere (bytes, arrays, dataclass fields):
the copies carry the same host code.
"""

import ast
import dataclasses
import gzip
import importlib
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import mumemto_tpu_torch
from mumemto_tpu import formats as j_formats
from mumemto_tpu import native as j_native
from mumemto_tpu import options as j_options
from mumemto_tpu import progress as j_progress
from mumemto_tpu import properties as j_properties
from mumemto_tpu import refbuilder as j_refbuilder
from mumemto_tpu.analysis import merge as j_merge
from mumemto_tpu.analysis import mumdata as j_mumdata
from mumemto_tpu.oracle import naive as j_naive
from mumemto_tpu_torch import cli as t_cli
from mumemto_tpu_torch import formats as t_formats
from mumemto_tpu_torch import native as t_native
from mumemto_tpu_torch import options as t_options
from mumemto_tpu_torch import progress as t_progress
from mumemto_tpu_torch import properties as t_properties
from mumemto_tpu_torch import refbuilder as t_refbuilder
from mumemto_tpu_torch.analysis import merge as t_merge
from mumemto_tpu_torch.analysis import mumdata as t_mumdata
from mumemto_tpu_torch.oracle import naive as t_naive
from conftest import rand_seq

# several test workers share the machine's cores
torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "mumemto_tpu_torch")
FORBIDDEN = ("mumemto_tpu", "bench", "jax", "jaxlib")
CPU = ["--device", "cpu"]


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, names in os.walk(PORT):
        out += [os.path.join(base, n) for n in names if n.endswith(".py")]
    return sorted(out)


def _port_modules():
    return ["mumemto_tpu_torch"] + sorted(
        m.name for m in pkgutil.walk_packages([PORT], "mumemto_tpu_torch."))


# --- (1) no import statement names the JAX package, bench or jax ----------

@pytest.mark.parametrize(
    "path", _port_sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_source_imports_nothing_of_the_jax_package(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad += [(node.lineno, n) for n in names
                if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_source_walk_sees_the_copies():
    """The walk above covers the copied modules, chip_smoke.py included."""
    rel = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for name in ("chip_smoke.py", "mumemto_tpu_torch/formats.py",
                 "mumemto_tpu_torch/native.py",
                 "mumemto_tpu_torch/oracle/naive.py",
                 "mumemto_tpu_torch/analysis/dispatch.py",
                 "mumemto_tpu_torch/analysis/viz_interactive.py",
                 "mumemto_tpu_torch/parallel/mesh.py",
                 "mumemto_tpu_torch/parallel/partition.py",
                 "mumemto_tpu_torch/parallel/sharddict.py",
                 "mumemto_tpu_torch/parallel/dcn.py",
                 "mumemto_tpu_torch/parallel/seqpfp.py",
                 "mumemto_tpu_torch/parallel/widepfp.py",
                 "mumemto_tpu_torch/parallel/collective_merge.py",
                 "mumemto_tpu_torch/capi/build_capi.py"):
        assert name in rel


def test_no_source_imports_torch_distributed():
    """The sharded scan, the sharded dictionary index and the collective
    merge are single-process programs over a list of devices: no file of
    the port names torch.distributed, apart from parallel/dcn.py (the
    multi-process placement), which imports it inside its functions only."""
    dcn_path = os.path.join(PORT, "parallel", "dcn.py")
    for path in _port_sources():
        if path != dcn_path:
            with open(path) as f:
                assert "torch.distributed" not in f.read(), path
    with open(dcn_path) as f:
        tree = ast.parse(f.read(), dcn_path)
    inside = []
    for fn in tree.body:
        for node in ast.walk(fn):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] + [
                    getattr(node, "module", None) or ""]
                if any(n.startswith("torch") for n in names):
                    assert isinstance(fn, ast.FunctionDef), node.lineno
                    inside.append(fn.name)
    assert sorted(inside) == ["barrier", "initialize", "run_partitioned_dcn"]


def test_importing_dcn_starts_no_process_group():
    """Importing parallel.dcn (with mumemto_tpu and jax blocked) loads no
    torch.distributed module beyond those `import torch` itself loads, and
    makes no process group."""
    code = ("import torch\n"
            "before = {m for m in sys.modules "
            "if m.startswith('torch.distributed')}\n"
            "import mumemto_tpu_torch.parallel.dcn as dcn\n"
            "after = {m for m in sys.modules "
            "if m.startswith('torch.distributed')}\n"
            "assert after == before, sorted(after - before)\n"
            "import torch.distributed as dist\n"
            "assert not dist.is_initialized()\n"
            "assert callable(dcn.initialize) and callable(dcn.barrier)\n"
            + _CLEAN)
    run = _run_blocked(code)
    assert run.returncode == 0, run.stderr[-3000:]


def test_c_abi_source_loads_the_port_only():
    """The port's C ABI source imports mumemto_tpu_torch.library and never
    the JAX package's library."""
    with open(os.path.join(PORT, "capi", "mumemto_capi.cc")) as f:
        src = f.read()
    assert '"mumemto_tpu_torch.library"' in src
    assert '"mumemto_tpu.library"' not in src


# --- (2) the port runs with mumemto_tpu and jax unimportable --------------

# installed before anything of the port is imported: any import of a
# forbidden package raises, whether or not it is installed
_BLOCK = (
    "import sys\n"
    "class _Block:\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    f"        if name.split('.')[0] in {FORBIDDEN!r}:\n"
    "            raise ImportError('blocked import of ' + name)\n"
    "sys.meta_path.insert(0, _Block())\n")
_CLEAN = (
    f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
    "assert not bad, bad\n")


def _run_blocked(code, *argv):
    return subprocess.run([sys.executable, "-c", _BLOCK + code, *argv],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=600)


def test_every_module_imports_with_jax_package_blocked():
    mods = _port_modules()
    assert len(mods) >= 40 and "mumemto_tpu_torch.analysis.viz" in mods
    for name in ("parallel.mesh", "parallel.seqpfp", "parallel.widepfp",
                 "parallel.collective_merge", "parallel.partition",
                 "parallel.sharddict", "parallel.dcn"):
        assert "mumemto_tpu_torch." + name in mods
    # capi/ is a directory of sources, not a package (its built .so must
    # not pass for a Python module); its build script is imported by name
    mods.append("mumemto_tpu_torch.capi.build_capi")
    code = ("import importlib\n"
            f"for name in {mods!r}:\n"
            "    if not name.endswith('__main__'):\n"
            "        importlib.import_module(name)\n"
            "import chip_smoke\n" + _CLEAN)
    run = _run_blocked(code)
    assert run.returncode == 0, run.stderr[-3000:]


def test_blocker_blocks():
    run = _run_blocked("import mumemto_tpu.formats\n")
    assert run.returncode != 0 and "blocked import" in run.stderr


def test_cli_builds_merges_and_views_with_jax_package_blocked(rng, tmp_path):
    """python -m mumemto_tpu_torch: builds (-M -n partitions, a -b union
    and a --seq-shards 2 union, --device cpu), then mori, view, merge and
    merge --collective, each in a fresh process in which mumemto_tpu and
    jax cannot be imported; then library.mum(seq_shards=2) likewise."""
    base = rand_seq(rng, 420)
    paths = []
    for i in range(3):
        s = list(base)
        for _ in range(6):
            s[int(rng.integers(0, len(s)))] = rng.choice(list("ACGT"))
        p = tmp_path / f"g{i}.fa"
        p.write_text(f">g{i}\n{rand_seq(rng, 25)}{''.join(s)}"
                     f"{rand_seq(rng, 25)}\n")
        paths.append(str(p))
    as_module = ("import runpy\n"
                 "try:\n"
                 "    runpy.run_module('mumemto_tpu_torch', "
                 "run_name='__main__')\n"
                 "except SystemExit as e:\n"
                 "    rc = e.code\n" + _CLEAN + "sys.exit(rc)\n")
    pre = [str(tmp_path / "p0"), str(tmp_path / "p1")]
    union = str(tmp_path / "all")
    merged = str(tmp_path / "merged")
    sharded = str(tmp_path / "sharded")
    for argv in ([paths[0], paths[1], "-o", pre[0], "-M", "-n", *CPU],
                 [paths[0], paths[2], "-o", pre[1], "-M", "-n", *CPU],
                 [*paths, "-o", union, "-b", *CPU],
                 [*paths, "-o", sharded, "--seq-shards", "2", *CPU],
                 ["mori"], ["view", union + ".bumbl"],
                 ["merge", pre[0] + ".mums", pre[1] + ".mums", "-o", merged],
                 ["merge", pre[0] + ".mums", pre[1] + ".mums", "-o",
                  merged + "_c", "--collective", *CPU]):
        run = _run_blocked(as_module, *argv)
        assert run.returncode == 0, (argv, run.stderr[-3000:])
    assert os.path.getsize(merged + ".mums") > 0
    assert os.path.getsize(merged + ".athresh") > 0
    for ext in (".mums", ".athresh", ".lengths"):
        assert _read(merged + "_c" + ext) == _read(merged + ext), ext
    # the sharded build against the unsharded one of this process
    assert t_cli.main([*paths, "-o", union + "_1", *CPU]) == 0
    assert _read(sharded + ".mums") == _read(union + "_1.mums") != b""
    seqs = [[open(p).read().split("\n")[1]] for p in paths]
    lib = ("from mumemto_tpu_torch import library\n"
           f"r = library.mum({seqs!r}, seq_shards=2, device='cpu')\n"
           "print(len(r))\n" + _CLEAN)
    run = _run_blocked(lib)
    assert run.returncode == 0, run.stderr[-3000:]
    assert int(run.stdout) == len(_read(sharded + ".mums").splitlines())
    # the same merge in this process, where the JAX package is importable
    assert t_cli.main(["merge", pre[0] + ".mums", pre[1] + ".mums", "-o",
                       merged + "2"]) == 0
    with open(merged + ".mums", "rb") as a, open(merged + "2.mums", "rb") as b:
        assert a.read() == b.read()


# --- (3) each copy against its original ------------------------------------

def _mum_arrays(rng, n_mums=40, n_seqs=5, partial=False):
    lengths = rng.integers(20, 5000, n_mums).astype(np.uint32)
    starts = rng.integers(0, 1 << 33, (n_mums, n_seqs)).astype(np.int64)
    strands = rng.integers(0, 2, (n_mums, n_seqs)).astype(bool)
    if partial:
        starts[rng.random((n_mums, n_seqs)) < 0.2] = -1
    return lengths, starts, strands


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _same(a, b):
    """Nested tuples/lists/arrays/dataclasses, exactly equal."""
    if dataclasses.is_dataclass(a):
        a, b = dataclasses.asdict(a), dataclasses.asdict(b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return (a.dtype == b.dtype and a.shape == b.shape
                and bool((a == b).all()))
    return a == b


def _fmt_mums(f, rng, tmp, tag):
    lengths, starts, strands = _mum_arrays(rng, partial=True)
    path = str(tmp / f"{tag}.mums")
    with open(path, "wb") as out:
        for l, s, t in zip(lengths, starts, strands):
            out.write(f.format_mum_line(int(l), s, np.where(t, 1, -1)))
    mem = f.format_mem_line(31, [5, 9, 77], [0, 1, 1], ["+", "-", "+"])
    return _read(path), mem, f.parse_mums(path, 5), f.first_offsets(path, 5)


def _fmt_bumbl(f, rng, tmp, tag):
    lengths, starts, strands = _mum_arrays(rng, n_mums=300)
    path = str(tmp / f"{tag}.bumbl")
    f.write_bumbl(path, lengths, starts, strands)
    chunks = [tuple(np.asarray(x) for x in c)
              for c in f.iter_bumbl(path, chunk_size=64)]
    bits = f.pack_strand_bits(strands)
    return (_read(path), f.parse_bumbl(path), chunks, bits,
            f.unpack_strand_bits(bits, *strands.shape),
            f.first_offsets(path))


def _fmt_lengths(f, rng, tmp, tag):
    path = str(tmp / "x.lengths")  # the same path: it is part of the bytes
    files = [str(tmp / "a.fa"), str(tmp / "b.fa")]
    f.write_lengths(path, files, [["c1", "c2"], ["d1"]],
                    [[int(x) for x in rng.integers(5, 900, 2)], [77]])
    info = f.parse_lengths(path)
    return (_read(path), info, info.seq_lengths(True),
            info.seq_lengths(False))


def _fmt_thresh(f, rng, tmp, tag):
    path = str(tmp / f"{tag}.thresh")
    f.write_thresh(path, rng.integers(0, 65536, 4001).astype(np.uint16))
    return _read(path), f.read_thresh(path)


def _fmt_5byte(f, rng, tmp, tag):
    path = str(tmp / f"{tag}.sa")
    f.write_5byte(path, rng.integers(0, 1 << 40, 3001).astype(np.int64))
    return _read(path), f.read_5byte(path)


def _fmt_rl_bwt(f, rng, tmp, tag):
    path = str(tmp / f"{tag}.bwt")
    bwt = np.repeat(np.frombuffer(b"ACGT$N", np.uint8)[
        rng.integers(0, 6, 400)], rng.integers(1, 700, 400))
    f.write_rl_bwt(path, bwt)
    return _read(path), f.read_rl_bwt(path)


@pytest.mark.parametrize("case", [_fmt_mums, _fmt_bumbl, _fmt_lengths,
                                  _fmt_thresh, _fmt_5byte, _fmt_rl_bwt],
                         ids=lambda c: c.__name__[5:])
def test_formats_copy(tmp_path, case):
    """Writers give the same bytes, readers the same arrays."""
    got = case(t_formats, np.random.default_rng(11), tmp_path, "t")
    want = case(j_formats, np.random.default_rng(11), tmp_path, "j")
    assert got[0] and _same(got, want)


def _set_native(monkeypatch, on: bool):
    """Both loaders with the C++ extension on or off for one test."""
    for mod in (j_native, t_native):
        monkeypatch.setattr(mod, "_tried", not on)
        monkeypatch.setattr(mod, "_native", None)
    if on:
        monkeypatch.delenv("MUMEMTO_TPU_NO_NATIVE", raising=False)


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
@pytest.mark.parametrize("kind", ["plain", "gzip", "multifasta"])
def test_refbuilder_copy(rng, tmp_path, monkeypatch, kind, native):
    _set_native(monkeypatch, native)
    files = []
    for i in range(3):
        recs = [(f"s{i}_{r}", rand_seq(rng, int(rng.integers(40, 300))))
                for r in range(3 if kind == "multifasta" else 1)]
        body = "".join(f">{n} extra words\n{s[:50].lower()}\n{s[50:]}\n"
                       for n, s in recs)
        if kind == "gzip":
            p = tmp_path / f"g{i}.fa.gz"
            with gzip.open(p, "wt") as fh:
                fh.write(body)
        else:
            p = tmp_path / f"g{i}.fa"
            p.write_text(body)
        files.append(str(p))
    if native:
        mods = [j_native.get_native(), t_native.get_native()]
        if None in mods:
            pytest.skip("the C++ extension does not build here")
        # two images of one source in one process, each found by file
        assert mods[0] is not mods[1]
        assert os.path.samefile(mods[1].__file__, t_native.OUT)
        assert not os.path.samefile(mods[0].__file__, mods[1].__file__)
        assert mods[1].__name__ == "mumemto_tpu_torch._native"
    for revcomp in (True, False):
        got = t_refbuilder.build_from_files(files, use_revcomp=revcomp)
        want = j_refbuilder.build_from_files(files, use_revcomp=revcomp)
        assert type(got).__module__ == "mumemto_tpu_torch.refbuilder"
        assert _same(got, want)
        assert _same(got.doc_ends, want.doc_ends)
    names, seqs = t_refbuilder.read_fasta(files[0])
    assert _same((names, seqs), j_refbuilder.read_fasta(files[0]))
    got.write_lengths_file(str(tmp_path / "x"))
    a = _read(str(tmp_path / "x.lengths"))
    want.write_lengths_file(str(tmp_path / "x"))
    assert a == _read(str(tmp_path / "x.lengths"))
    assert _same(t_refbuilder.build_from_lengths(str(tmp_path / "x")),
                 j_refbuilder.build_from_lengths(str(tmp_path / "x")))
    seqs = [[rand_seq(rng, 80), rand_seq(rng, 30)], [rand_seq(rng, 99)]]
    assert _same(t_refbuilder.build_from_sequences(seqs),
                 j_refbuilder.build_from_sequences(seqs))
    arr = np.frombuffer(rand_seq(rng, 64).encode() + b"NnRy", np.uint8)
    assert _same(t_refbuilder.revcomp(arr), j_refbuilder.revcomp(arr))


def test_native_no_native_env_and_stale_check(monkeypatch, tmp_path):
    """MUMEMTO_TPU_NO_NATIVE keeps its meaning, and a library older than
    the C++ source counts as stale."""
    monkeypatch.setattr(t_native, "_tried", False)
    monkeypatch.setattr(t_native, "_native", None)
    monkeypatch.setenv("MUMEMTO_TPU_NO_NATIVE", "1")
    assert t_native.get_native() is None
    src = tmp_path / "src.cc"
    out = tmp_path / "_native.so"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(t_native, "SRC", str(src))
    monkeypatch.setattr(t_native, "OUT", str(out))
    assert t_native.stale()
    out.write_bytes(b"old")
    os.utime(out, (1, 1))
    assert t_native.stale()
    os.utime(out, None)
    os.utime(src, (1, 1))
    assert not t_native.stale()
    # a failed compile never leaves a stale library to import
    os.utime(out, (1, 1))
    os.utime(src, None)
    assert t_native.build() is False and not out.exists()


def _tiny(rng, planted=False):
    base = rand_seq(rng, 120)
    rep = rand_seq(rng, 40)
    docs = []
    for _ in range(3):
        s = list(base)
        for _ in range(int(rng.integers(1, 6))):
            s[int(rng.integers(0, len(s)))] = rng.choice(list("ACGT"))
        body = "".join(s)
        if planted:
            for _ in range(int(rng.integers(1, 4))):
                cut = int(rng.integers(0, len(body)))
                body = body[:cut] + rep + body[cut:]
        docs.append([body])
    return docs


@pytest.mark.parametrize("kw", [
    {}, {"num_distinct_docs": -1}, {"merge": True},
    {"rare_freq": 2}, {"rare_freq": 3, "num_distinct_docs": 2},
    {"rare_freq": 0, "max_mem_freq": 0}, {"rare_freq": 2, "max_mem_freq": -1}],
    ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()) or "mum")
def test_oracle_copy(rng, kw):
    docs = _tiny(rng, planted="rare_freq" in kw)
    t_rb = t_refbuilder.build_from_sequences(docs)
    j_rb = j_refbuilder.build_from_sequences(docs)
    t_opts = t_options.normalize(3, quiet=True, **kw)
    j_opts = j_options.normalize(3, quiet=True, **kw)
    assert _same(t_opts, j_opts)
    want = j_naive.oracle_output(j_rb, j_opts)
    assert want or kw.get("max_mem_freq") == -1
    assert t_naive.oracle_output(t_rb, t_opts) == want
    assert t_naive.oracle_output(t_rb, t_opts, naive_sa=True) == want
    if kw.get("merge"):
        assert _same(t_naive.run_finder(t_rb, t_opts).thresh_arrays(),
                     j_naive.run_finder(j_rb, j_opts).thresh_arrays())


def test_options_and_progress_copy(capsys):
    for n, kw in ((3, {}), (5, {"num_distinct_docs": 9}),
                  (4, {"rare_freq": 0, "binary": True}),
                  (4, {"min_match_len": 7, "use_revcomp": False,
                       "anchor_merge": True, "merge": True})):
        got = t_options.normalize(n, **kw)
        t_err = capsys.readouterr().err
        assert _same(got, j_options.normalize(n, **kw))
        assert capsys.readouterr().err == t_err
    for bad in ({"rare_freq": -1}, {"merge": True, "num_distinct_docs": 2},
                {"merge": True, "rare_freq": 2}):
        with pytest.raises(t_options.InputError) as t_exc:
            t_options.normalize(3, **bad)
        with pytest.raises(j_options.InputError) as j_exc:
            j_options.normalize(3, **bad)
        assert str(t_exc.value) == str(j_exc.value)
    assert issubclass(t_options.InputError, ValueError)
    assert t_progress._STAGES == j_progress._STAGES


def _mumdata_views(md_mod, path):
    md = md_mod.MUMdata(path, sort=True)
    blocks = md_mod.find_coll_blocks(md, max_break=500)
    both = md + md_mod.MUMdata(path)
    out = [md.lengths, md.starts, md.strands, md.num_mums, md.num_seqs,
           blocks, md_mod.serialize_coll_blocks(blocks, md.num_mums),
           both.lengths, md_mod.MUMdata(path, lenfilter=900).lengths,
           md_mod.MUMdata(path, subsample=3).starts, md[3].starts]
    if not path.endswith(".bumbl"):
        out.append(md.filter_pmums().starts)
    return out


@pytest.mark.parametrize("ext", [".mums", ".bumbl"])
def test_mumdata_copy(rng, tmp_path, ext):
    lengths, starts, strands = _mum_arrays(rng, partial=ext == ".mums")
    starts[:, 0] = np.sort(rng.integers(0, 1 << 20, lengths.size))
    files = {}
    for name, md_mod in (("t", t_mumdata), ("j", j_mumdata)):
        md = md_mod.MUMdata.from_arrays(lengths, starts, strands)
        files[name] = str(tmp_path / (name + ext))
        if ext == ".bumbl":
            md.write_bums(files[name])
        else:
            md.write_mums(files[name])
    assert _read(files["t"]) and _read(files["t"]) == _read(files["j"])
    assert _same(_mumdata_views(t_mumdata, files["t"]),
                 _mumdata_views(j_mumdata, files["j"]))


def _partitions(rng, tmp_path, flags, anchor):
    """Two partitions of 5 FASTAs built by the port's CLI on the CPU."""
    base = rand_seq(rng, 400)
    paths = []
    for i in range(5):
        s = list(base)
        for _ in range(int(rng.integers(2, 10))):
            s[int(rng.integers(0, len(s)))] = rng.choice(list("ACGT"))
        p = tmp_path / f"g{i}.fa"
        p.write_text(f">g{i}\n{rand_seq(rng, 25)}{''.join(s)}"
                     f"{rand_seq(rng, 25)}\n")
        paths.append(str(p))
    parts = ([paths[:3], [paths[0], *paths[3:]]] if anchor
             else [paths[:3], paths[3:]])
    pres = []
    for i, part in enumerate(parts):
        pres.append(str(tmp_path / f"p{i}"))
        assert t_cli.main(part + ["-o", pres[-1], *flags, *CPU]) == 0
    return pres


def test_anchor_merge_copy(rng, tmp_path):
    pres = _partitions(rng, tmp_path, ["-M", "-n"], anchor=True)
    mums = [p + ".mums" for p in pres]
    for name, mod in (("t", t_merge), ("j", j_merge)):
        out = str(tmp_path / name)
        mod.merge_anchor_lengths(pres, out)
        mod.anchor_merge(mums, out + ".mums")
    for ext in (".mums", ".athresh", ".lengths"):
        a = _read(str(tmp_path / ("t" + ext)))
        assert a and a == _read(str(tmp_path / ("j" + ext))), ext
    assert _same(t_merge.parse_candidate(mums[0]),
                 j_merge.parse_candidate(mums[0]))


def test_string_merge_recomposition_copy(rng, tmp_path):
    """The recomposition of string_merge on one "MUMs of MUMs" file (made
    by the port's scan): both modules write the same files."""
    pres = _partitions(rng, tmp_path, ["-M"], anchor=False)
    mums = [p + ".mums" for p in pres]
    fas = [p + "_mums.fa" for p in pres]
    for mod, suffix in ((t_merge, ""), (j_merge, ".j")):
        for mf, p, fa in zip(mums, pres, fas):
            mod._extract_sorted_mums_fasta(mf, p + ".lengths", fa + suffix)
    for fa in fas:
        assert _read(fa) and _read(fa) == _read(fa + ".j")
    grand = str(tmp_path / "grand")
    assert t_cli.main(fas + ["-o", grand, *CPU]) == 0
    for name, mod in (("t", t_merge), ("j", j_merge)):
        out = str(tmp_path / name)
        mod.string_merge(mums, pres, out + ".mums", out,
                         merged_mums=grand + ".mums")
    for ext in (".mums", ".thresh", ".thresh_rev", ".lengths"):
        a = _read(str(tmp_path / ("t" + ext)))
        assert a and a == _read(str(tmp_path / ("j" + ext))), ext
    assert os.path.exists(fas[0])  # with merged_mums given, nothing is removed


def test_properties_helpers_copy(rng):
    lengths, offsets, strands = _mum_arrays(rng, n_mums=30, n_seqs=4,
                                            partial=True)
    offsets = np.where(offsets < 0, -1, offsets % 5000)
    signs = np.where(strands, 1, -1)
    doc_lens = rng.integers(9000, 12000, 4)
    doc_offsets = np.concatenate(([0], np.cumsum(2 * doc_lens + 2)[:-1]))
    assert _same(
        t_properties.mum_text_positions(lengths, offsets, signs, doc_offsets,
                                        doc_lens),
        j_properties.mum_text_positions(lengths, offsets, signs, doc_offsets,
                                        doc_lens))
    hay = rand_seq(rng, 3000).encode()
    for needle in (b"A", b"AC", b"ACG", hay[100:109], b"AAAA"):
        assert (t_properties._count_occurrences(hay, needle)
                == j_properties._count_occurrences(hay, needle))
    text = np.frombuffer(hay, np.uint8)
    text = np.concatenate([text, np.frombuffer(b"XABYXABZXABY", np.uint8)])
    n = text.size
    for positions, L in (([0, 50, 700], 9), ([10, 20], 2990), ([5, 5], 3),
                         ([n - 11, n - 7, n - 3], 2)):
        outcome = []
        for mod in (t_properties, j_properties):
            try:
                mod._check_maximality(text, positions, L, "m")
                outcome.append(None)
            except AssertionError as e:
                outcome.append(str(e))
        assert outcome[0] == outcome[1]
    assert outcome[0] is not None and "left-maximal" in outcome[0]


def test_cli_constants_copy(tmp_path):
    from mumemto_tpu import cli as j_cli
    assert t_cli.SKULL == j_cli.SKULL
    assert t_cli.SUBCOMMANDS == j_cli.SUBCOMMANDS
    assert t_cli.VERSION == j_cli.VERSION == mumemto_tpu_torch.__version__
    lst = tmp_path / "files.txt"
    lst.write_text("a.fa extra\n\n  b.fa.gz\t7\nc.fa\n")
    assert t_cli.read_filelist(str(lst)) == j_cli.read_filelist(str(lst))


@pytest.mark.parametrize("args", [(0.02, 4, 0, 0.001), (0.003, 3, 2, 0.004),
                                  (0.05, 8, 1, 0.001)])
def test_synth_collection_copy(args):
    """The harness's copy (mumemto_tpu_torch.bench.synth_collection, which
    chip_smoke.py calls as bench.synth_collection) gives bench.py's bytes
    for the seed."""
    from mumemto_tpu_torch import bench as t_bench
    sys.path.insert(0, ROOT)
    try:
        chip_smoke = importlib.import_module("chip_smoke")
        bench = importlib.import_module("bench")
    finally:
        sys.path.remove(ROOT)
    mbp, n_docs, seed, snp = args
    want = bench.synth_collection(mbp, n_docs, seed=seed, snp_rate=snp)
    assert chip_smoke.bench is t_bench
    got = t_bench.synth_collection(mbp, n_docs, seed=seed, snp_rate=snp)
    assert len(got) == n_docs and _same(got, want)
