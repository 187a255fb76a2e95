"""The port's sharded scan (parallel/mesh, seqpfp, widepfp) against its
single-device engine and against mumemto_tpu's sharded scan.

The port runs on torch-CPU, every shard on the one CPU device (or on the
two names "cpu" and "cpu:0" of it, which the mesh treats as two devices, so
the cross-device branches run); JAX runs on its 8-device CPU mesh. Inputs
come from seeded numpy generators, at the sizes of tests/test_seqpfp.py and
tests/test_widepfp.py. Tolerance: none, integers and bytes are equal.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mumemto_tpu import cli as jax_cli
from mumemto_tpu import options
from mumemto_tpu.ops import pfp as jax_pfp
from mumemto_tpu.parallel import seqpfp as jax_seqpfp
from mumemto_tpu.parallel import widepfp as jax_widepfp
from mumemto_tpu_torch import cli as t_cli
from mumemto_tpu_torch import convert
from mumemto_tpu_torch import engine as t_engine
from mumemto_tpu_torch import library
from mumemto_tpu_torch.ops import pfp as t_pfp
from mumemto_tpu_torch.parallel import mesh, seqpfp, widepfp
from mumemto_tpu_torch.parallel.partition import WindowCapacityError
from conftest import build, mutated_collection, rand_seq

# several test workers share the machine's cores
torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _two_devices(nshards):
    """Two names of the CPU, alternating: unequal as torch devices, so
    neighbours exchange blocks and halos across "devices"."""
    return [torch.device("cpu", 0) if i % 2 else CPU for i in range(nshards)]


def _jax_mesh(nshards):
    devs = np.asarray(jax.devices()[:nshards]).reshape(nshards)
    return jax.sharding.Mesh(devs, ("seq",))


def _compare(rb, opts, nshards, M=4096, devices=None):
    """Sharded == single-device: output bytes and the n/r run count."""
    want = t_engine.find_matches(rb, opts, device="cpu")
    got = seqpfp.find_matches_seq_sharded(
        rb, opts, devices or mesh.seq_devices(nshards, "cpu"), M=M)
    assert got.output_bytes() == want.output_bytes()
    assert got.bwt_runs == want.bwt_runs
    assert got.text_length == want.text_length
    return want


def _conserved_collection(rng, n_docs, n_cores=3, core_len=45,
                          unique_len=40):
    """tests/test_seqpfp.py's collection for 128+ docs: conserved cores
    between per-doc unique sequence, so strict MUMs exist."""
    cores = [rand_seq(rng, core_len) for _ in range(n_cores)]
    docs = []
    for _ in range(n_docs):
        parts = []
        for c in cores:
            parts.append(rand_seq(rng, unique_len))
            parts.append(c)
        parts.append(rand_seq(rng, unique_len))
        docs.append(["".join(parts)])
    return docs


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def test_mesh_devices_and_exchanges(monkeypatch):
    assert mesh.seq_devices(4, "cpu") == [CPU] * 4
    for bad in (0, -2, 3, 6):
        with pytest.raises(ValueError, match="positive power of two"):
            mesh.seq_devices(bad, "cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh.seq_devices(2, "cuda")
    # two visible cards: round-robin
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert [d.index for d in mesh.seq_devices(4, "cuda")] == [0, 1, 0, 1]
    assert [d.index for d in mesh.seq_devices(2, "cuda:1")] == [1, 1]
    assert len(mesh.spread(3, "cpu")) == 3
    monkeypatch.undo()

    devs = _two_devices(4)
    blocks = [torch.full((3,), i) for i in range(4)]
    got = mesh.ppermute(blocks, [(s, (s + 1) % 4) for s in range(4)], devs)
    assert [int(b[0]) for b in got] == [3, 0, 1, 2]
    assert mesh.ppermute(blocks, [(0, 1)], devs)[0] is None
    gathered = mesh.all_gather(blocks, CPU)
    assert gathered.shape == (4, 3) and gathered[:, 0].tolist() == [0, 1, 2, 3]
    assert mesh.psum(blocks, CPU).tolist() == [6, 6, 6]
    rep = mesh.replicate({"a": blocks[1], "t": [blocks[2]], "n": 5}, devs)
    assert set(rep) == set(devs) and rep[devs[1]]["n"] == 5
    assert int(rep[devs[1]]["t"][0][0]) == 2


# ---------------------------------------------------------------------------
# the slice as a whole against the port's single-device engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nshards", [1, 2, 4, 8])
def test_shard_sweep(rng, nshards):
    rb = build(mutated_collection(rng, 4, base_len=900))
    opts = options.normalize(rb.num_docs, quiet=True)
    assert _compare(rb, opts, nshards).num_matches > 0


@pytest.mark.parametrize("nshards", [2, 4, 8])
def test_shard_sweep_two_devices(rng, nshards):
    rb = build(mutated_collection(rng, 4, base_len=900))
    opts = options.normalize(rb.num_docs, quiet=True)
    _compare(rb, opts, nshards, devices=_two_devices(nshards))


def test_partial_mums(rng):
    rb = build(mutated_collection(rng, 5, base_len=700))
    opts = options.normalize(rb.num_docs, num_distinct_docs=-1, quiet=True)
    assert _compare(rb, opts, 4).num_matches > 0


@pytest.mark.parametrize("nshards,two", [(4, False), (2, True)])
def test_mems(rng, nshards, two):
    rep = rand_seq(rng, 60)
    rb = build(mutated_collection(rng, 4, base_len=500, insert_rep=rep))
    opts = options.normalize(rb.num_docs, rare_freq=2, quiet=True)
    devices = _two_devices(nshards) if two else None
    assert _compare(rb, opts, nshards, devices=devices).num_matches > 0


def test_cap1024_mem_mode(rng):
    """Size cap 1024 (unlimited per-doc frequency, F = 1000): the walk."""
    rep = rand_seq(rng, 50)
    rb = build(mutated_collection(rng, 4, base_len=400, insert_rep=rep))
    opts = options.normalize(rb.num_docs, rare_freq=0, max_mem_freq=1000,
                             quiet=True)
    assert t_engine.interval_size_cap(opts, rb.num_docs) == 1024
    assert _compare(rb, opts, 2).num_matches > 0


def _thresh_lists(res, rb, opts):
    dl0 = int(t_engine._doc_metadata(rb, opts)[1][0])
    return t_engine.thresh_arrays(res, dl0)


@pytest.mark.parametrize("nshards,two", [(4, False), (4, True)])
def test_merge_metadata(rng, nshards, two):
    """-M: the candidate thresholds and the .thresh/.thresh_rev lists."""
    rb = build(mutated_collection(rng, 3, base_len=800))
    opts = options.normalize(rb.num_docs, merge=True, quiet=True)
    single = t_engine.find_matches(rb, opts, device="cpu")
    sharded = seqpfp.find_matches_seq_sharded(
        rb, opts, _two_devices(nshards) if two
        else mesh.seq_devices(nshards, "cpu"))
    assert single.output_bytes() == sharded.output_bytes()
    assert (single.candidate_thresh == sharded.candidate_thresh).all()
    for a, b in zip(_thresh_lists(single, rb, opts),
                    _thresh_lists(sharded, rb, opts)):
        assert a.any() and np.array_equal(a, b)


@pytest.mark.parametrize("kw", [{}, {"num_distinct_docs": -1},
                                {"merge": True}])
def test_cap256_many_docs(rng, kw):
    """130+ docs in MUM mode: size cap 256, the probe-guarded walks inside
    the halo; strict, partial (one doc lacks a core) and -M."""
    docs = _conserved_collection(rng, 132)
    if kw.get("num_distinct_docs"):
        docs[7][0] = docs[7][0].replace(docs[0][0][45:70], "")
    rb = build(docs)
    opts = options.normalize(rb.num_docs, quiet=True, **kw)
    assert t_engine.interval_size_cap(opts, rb.num_docs) == 256
    single = _compare(rb, opts, 4)
    assert single.num_matches > 0
    if kw.get("merge"):
        sharded = seqpfp.find_matches_seq_sharded(
            rb, opts, mesh.seq_devices(2, "cpu"))
        assert (single.candidate_thresh == sharded.candidate_thresh).all()


def test_midsize_boundary_stress(rng):
    """~160 kb over 8 shards: thousands of rows per block, long matches
    that span shard boundaries."""
    rb = build(mutated_collection(rng, 4, base_len=20000, n_mut=30))
    opts = options.normalize(rb.num_docs, quiet=True)
    assert _compare(rb, opts, 8, M=8192).num_matches > 0


def test_capacity_overflow(rng):
    rb = build(mutated_collection(rng, 3, base_len=900))
    opts = options.normalize(rb.num_docs, quiet=True)
    with pytest.raises(WindowCapacityError, match="M=4; rerun with M >="):
        seqpfp.find_matches_seq_sharded(rb, opts,
                                        mesh.seq_devices(2, "cpu"), M=4)
    opts = options.normalize(rb.num_docs, merge=True, quiet=True)
    with pytest.raises(WindowCapacityError):
        seqpfp.find_matches_seq_sharded(rb, opts,
                                        mesh.seq_devices(2, "cpu"), M=4)


def test_refusals(rng):
    rb = build(mutated_collection(rng, 3, base_len=300))
    opts = options.normalize(rb.num_docs, rare_freq=0, max_mem_freq=0,
                             quiet=True)
    devs = mesh.seq_devices(2, "cpu")
    with pytest.raises(ValueError, match="bounded interval size cap"):
        seqpfp.find_matches_seq_sharded(rb, opts, devs)
    with pytest.raises(ValueError, match="bounded interval size cap"):
        widepfp.find_matches_wide(rb, opts, devs,
                                  t_pfp.build_pfp(rb.text, CPU))
    opts = options.normalize(rb.num_docs, quiet=True)
    # shard_dict=True is no refusal: the same bytes as the plain call
    assert seqpfp.find_matches_seq_sharded(
        rb, opts, devs, shard_dict=True).output_bytes() == \
        seqpfp.find_matches_seq_sharded(rb, opts, devs).output_bytes() != b""
    with pytest.raises(ValueError, match="positive power of two"):
        seqpfp.find_matches_seq_sharded(rb, opts, [CPU] * 3)
    # blocks narrower than one halo: 1024 rows over 512 shards
    prep = t_pfp.pfp_scan_prepare(t_pfp.build_pfp(rb.text, CPU), rb.doc_ends)
    with pytest.raises(AssertionError, match="halo width"):
        widepfp.wide_step(prep, [CPU] * (prep["nr"] // 2), rb.num_docs, 20,
                          3, 0, 1, 4, False, 64, False)


def test_phase_hook_names(rng):
    rb = build(mutated_collection(rng, 3, base_len=300))
    opts = options.normalize(rb.num_docs, quiet=True)
    seen = []
    seqpfp.find_matches_seq_sharded(rb, opts, mesh.seq_devices(2, "cpu"),
                                    phase=seen.append)
    # stages C and D run together for each shard on its device's thread,
    # so one hook follows them all, on the caller's thread
    assert seen == ["build_pfp", "dict_index", "parse_side", "operands",
                    "sort", "analyze", "assemble"]
    assert seqpfp.sort_rounds(1) == 0 and seqpfp.sort_rounds(2) == 1
    assert seqpfp.sort_rounds(4) == 3 and seqpfp.sort_rounds(8) == 6


# ---------------------------------------------------------------------------
# the entry routes: -p resume, the library, the CLI
# ---------------------------------------------------------------------------

def _write_fastas(tmp_path, docs, tag="c"):
    paths = []
    for i, d in enumerate(docs):
        p = tmp_path / f"{tag}{i}.fa"
        p.write_text(f">{tag}{i}\n{d[0]}\n")
        paths.append(str(p))
    return paths


def test_cli_parse_resume(rng, tmp_path):
    """-P checkpoint, then -p resume sharded == single-device resume."""
    paths = _write_fastas(tmp_path, mutated_collection(rng, 3, base_len=600))
    ck = str(tmp_path / "ck")
    dev = ["--device", "cpu"]
    assert t_cli.main(paths + ["-o", ck, "-P", *dev]) == 0
    assert t_cli.main(["-p", ck, "-o", str(tmp_path / "single"), *dev]) == 0
    assert t_cli.main(["-p", ck, "-o", str(tmp_path / "sharded"),
                       "--seq-shards", "4", *dev]) == 0
    assert (tmp_path / "single.mums").read_bytes() == \
        (tmp_path / "sharded.mums").read_bytes() != b""


def test_library_seq_shards(rng):
    docs = mutated_collection(rng, 3, base_len=500)
    single = library.mum(docs, device="cpu")
    sharded = library.mum(docs, seq_shards=2, device="cpu")
    assert len(single) == len(sharded) > 0
    for i in range(len(single)):
        L1, o1, s1 = single.match_at(i)
        L2, o2, s2 = sharded.match_at(i)
        assert L1 == L2 and (o1 == o2).all() and (s1 == s2).all()
    with pytest.raises(ValueError, match="seq_shards must be a positive"):
        library.mum(docs, seq_shards=3, device="cpu")


def test_library_mem_seq_shards(rng):
    rep = rand_seq(rng, 60)
    docs = mutated_collection(rng, 3, base_len=400, insert_rep=rep)
    single = library.mem(docs, max_doc_freq=3, device="cpu")
    sharded = library.mem(docs, max_doc_freq=3, seq_shards=4, device="cpu")
    assert len(single) == len(sharded) > 0
    for i in range(len(single)):
        for a, b in zip(single.match_at(i), sharded.match_at(i)):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("flags,exts", [
    ([], [".mums"]), (["-f", "2"], [".mems"]),
    (["-M"], [".mums", ".thresh", ".thresh_rev"])])
def test_cli_seq_shards_matches_jax(rng, tmp_path, flags, exts):
    """`--seq-shards 2` through both packages' CLIs: the same files, which
    are also the port's unsharded files."""
    rep = rand_seq(rng, 40)
    paths = _write_fastas(tmp_path, mutated_collection(
        rng, 3, base_len=600, insert_rep=rep if flags == ["-f", "2"]
        else None))
    out = tmp_path / "out"
    out.mkdir()
    assert jax_cli.main(paths + ["-o", str(out / "jax"), "--seq-shards", "2",
                                 *flags]) == 0
    dev = ["--device", "cpu"]
    assert t_cli.main(paths + ["-o", str(out / "torch"), "--seq-shards", "2",
                               *flags, *dev]) == 0
    assert t_cli.main(paths + ["-o", str(out / "single"), *flags, *dev]) == 0
    for ext in exts + [".lengths"]:
        a = (out / ("jax" + ext)).read_bytes()
        assert a, ext
        assert (out / ("torch" + ext)).read_bytes() == a, ext
        assert (out / ("single" + ext)).read_bytes() == a, ext


def test_module_entry_point_seq_shards(rng, tmp_path):
    """python -m mumemto_tpu_torch ... --seq-shards 2 --device cpu against
    python -m mumemto_tpu ... --seq-shards 2."""
    paths = _write_fastas(tmp_path, mutated_collection(rng, 3, base_len=500))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    for pkg, extra in (("mumemto_tpu_torch", ["--device", "cpu"]),
                       ("mumemto_tpu", [])):
        run = subprocess.run(
            [sys.executable, "-m", pkg, *paths, "-o", str(tmp_path / pkg),
             "--seq-shards", "2", *extra], cwd=ROOT, env=env,
            capture_output=True, text=True, timeout=600)
        assert run.returncode == 0, run.stderr
    a = (tmp_path / "mumemto_tpu.mums").read_bytes()
    assert a and (tmp_path / "mumemto_tpu_torch.mums").read_bytes() == a


def test_cli_seq_shards_refusals(rng, tmp_path, capsys):
    paths = _write_fastas(tmp_path, mutated_collection(rng, 3, base_len=300))
    out = str(tmp_path / "o")
    dev = ["--device", "cpu"]
    for flag in (["-A"], ["-P"], ["-g"], ["-a", out]):
        assert t_cli.main(paths + ["-o", out, "--seq-shards", "2", *flag,
                                   *dev]) == 1
        assert "--seq-shards is not supported together with -A/-a/-P/-g" \
            in capsys.readouterr().err
    assert t_cli.main(paths + ["-o", out, "--seq-shards", "3", *dev]) == 1
    assert ("--seq-shards must be a positive power of two, got 3"
            in capsys.readouterr().err)
    assert not os.path.exists(out + ".mums")


# ---------------------------------------------------------------------------
# against mumemto_tpu's sharded scan, as a whole and stage by stage
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,nshards", [({}, 4), ({"rare_freq": 2}, 2)])
def test_matches_jax_seq_sharded(rng, kw, nshards):
    rep = rand_seq(rng, 60)
    rb = build(mutated_collection(rng, 4, base_len=500,
                                  insert_rep=rep if kw else None))
    opts = options.normalize(rb.num_docs, quiet=True, **kw)
    want = jax_seqpfp.find_matches_seq_sharded(rb, opts, _jax_mesh(nshards))
    got = seqpfp.find_matches_seq_sharded(rb, opts,
                                          mesh.seq_devices(nshards, "cpu"))
    assert got.output_bytes() == want.output_bytes() != b""
    assert got.bwt_runs == want.bwt_runs


def _jax_prepared(rng, n_docs=3, base_len=400, **kw):
    """One collection prepared by the JAX package (uint32 row coordinates,
    as its block scan takes them) and carried into the port."""
    rb = build(mutated_collection(rng, n_docs, base_len=base_len, **kw))
    pfp = jax_pfp.build_pfp(rb.text, w=10, mod=100)
    jprep = jax_pfp.pfp_scan_prepare(pfp, rb.doc_ends, rb.num_docs,
                                     row_dtype=np.uint32)
    return rb, jprep, convert.from_jax_prepare(jprep, CPU)


def _jax_block_operands(jprep, base, B, num_docs):
    """mumemto_tpu's _block_operands for one block, its sufbwt unpacked:
    (key1, key2, ssa, suf_len, bwt, da, cross) as numpy."""
    nd, lvl_cap = jprep["nd"], jprep["lvl_cap"]
    pack_cross = 2 * lvl_cap + 7 <= 31
    grp_tab = jax_pfp._grp_tab(jprep["d"], jprep["grp_of_pos"],
                               jprep["grp_cross"], nd)
    out = jax_widepfp._block_operands(
        jnp.uint32(base), jprep["parse"], jprep["d_starts"], jprep["cumcnt"],
        jprep["m"], jprep["total_rows"], jprep["n_text"], jprep["isaP"],
        grp_tab, jprep["doc_ends"], B=B, nd=nd, w=jprep["w"],
        num_docs=num_docs, lvl_cap=lvl_cap, pack_cross=pack_cross)
    key1, key2, ssa, sufbwt, da = (np.asarray(x) for x in out[:5])
    if pack_cross:
        cross = sufbwt & ((1 << lvl_cap) - 1)
        sufbwt = sufbwt >> lvl_cap
    else:
        cross = np.asarray(out[5])
    return key1, key2, ssa.astype(np.int64), sufbwt >> 7, sufbwt & 127, da, \
        cross


def _torch_block_operands(prep, base, B, num_docs, **over):
    p = dict(prep, **over)
    grp_tab = t_pfp._grp_tab(p["d"], p["grp_of_pos"], p["grp_cross"], p["nd"])
    return [t.numpy() for t in widepfp._block_operands(
        base, p["parse"], p["d_starts"], p["cumcnt"], p["m"],
        p["total_rows"], p["n_text"], p["isaP"], grp_tab, p["doc_ends"], B,
        p["nd"], p["w"], num_docs)]


def test_from_jax_prepare_equals_own_prepare(rng):
    """The carried prepare equals the port's own, table by table (the
    tie-order-dependent tables are not part of it)."""
    rb, jprep, prep = _jax_prepared(rng)
    own = t_pfp.pfp_scan_prepare(t_pfp.build_pfp(rb.text, CPU), rb.doc_ends)
    assert set(own) == set(prep)
    for k, v in own.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v.to(torch.int64), prep[k].to(torch.int64)), k
        elif k == "slt_table":
            assert len(v) == len(prep[k])
            assert all(torch.equal(a, b) for a, b in zip(v, prep[k]))
        else:
            assert v == prep[k], k
    # a flat level-major table converts to the same list of levels
    flat = dict(jprep, slt_table=np.concatenate(
        [np.asarray(t) for t in jprep["slt_table"]]))
    again = convert.from_jax_prepare(flat, CPU)["slt_table"]
    assert all(torch.equal(a, b) for a, b in zip(again, prep["slt_table"]))


@pytest.mark.parametrize("nshards", [1, 2, 4])
def test_block_operands_match_jax(rng, nshards):
    rb, jprep, prep = _jax_prepared(rng)
    B = prep["nr"] // nshards
    total = prep["total_rows"]
    for base in sorted({i * B for i in range(nshards)} | {137, total - B // 2}):
        want = _jax_block_operands(jprep, base, B, rb.num_docs)
        got = _torch_block_operands(prep, base, B, rb.num_docs)
        for name, a, b in zip(("key1", "key2", "ssa", "suf_len", "bwt", "da",
                               "cross"), want, got):
            assert np.array_equal(a, b), (name, base)
    # the blocks tile the single-device operands
    whole = [t.numpy() for t in t_pfp._expand_operands(
        prep["parse"], prep["d_starts"], prep["cumcnt"], prep["m"], total,
        prep["n_text"], prep["isaP"],
        t_pfp._grp_tab(prep["d"], prep["grp_of_pos"], prep["grp_cross"],
                       prep["nd"]),
        prep["doc_ends"], prep["nr"], prep["nd"], prep["w"], rb.num_docs)]
    real = np.arange(prep["nr"]) < total
    tiles = [_torch_block_operands(prep, i * B, B, rb.num_docs)
             for i in range(nshards)]
    for k in range(7):
        joined = np.concatenate([t[k] for t in tiles])
        assert np.array_equal(joined[real], whole[k][real]), k
        if k != 3:  # a pad's suffix length is 0 here and unset there
            assert np.array_equal(joined[~real], whole[k][~real]), k


def test_block_operands_past_2_31(rng):
    """The offset-shift idea of tests/test_widepfp.py, in int64: translate
    the whole row space by DELTA = 2^31 + 12345 (and by 2^33 + 7) through a
    phantom occurrence 0 spanning [0, DELTA), then build the block at
    base + DELTA. Every operand equals the untranslated block's, and ssa is
    the old one + DELTA."""
    rb, _jprep, prep = _jax_prepared(rng)
    B = 512
    total, n_text = prep["total_rows"], prep["n_text"]
    for DELTA in (2**31 + 12345, 2**33 + 7):
        cum2 = torch.cat([torch.zeros(1, dtype=torch.int64),
                          prep["cumcnt"].to(torch.int64) + DELTA])
        shifted = dict(
            cumcnt=cum2,
            parse=torch.cat([torch.ones(1, dtype=torch.int32),
                             prep["parse"]]),
            isaP=torch.cat([torch.zeros(1, dtype=torch.int32),
                            prep["isaP"]]),
            doc_ends=prep["doc_ends"] + DELTA, m=prep["m"] + 1,
            total_rows=total + DELTA, n_text=n_text + DELTA)
        for base in (0, 137, B, total - B // 2):
            ref = _torch_block_operands(prep, base, B, rb.num_docs)
            got = _torch_block_operands(prep, base + DELTA, B, rb.num_docs,
                                        **shifted)
            real = (np.arange(B) + base) < total
            assert np.array_equal(ref[0], got[0]), base
            for k in (1, 3, 4, 5, 6):
                assert np.array_equal(ref[k][real], got[k][real]), (k, base)
            assert np.array_equal(got[2][real] - DELTA, ref[2][real])
            assert (got[2][real] > 2**31).all()


@pytest.mark.parametrize("nshards,two", [(2, False), (4, False), (8, True)])
def test_bitonic_block_sort_with_ties(nshards, two):
    """Keys with many ties (a quarter pads, few distinct values): the
    blocks come out globally ascending, every row exactly once, and the
    multiset of rows per key equals a global stable sort's."""
    g = np.random.default_rng(7)
    B = 96
    n = nshards * B
    key1 = g.integers(-1, 3, n).astype(np.int32)
    key2 = np.where(key1 < 0, 0, g.integers(0, 4, n)).astype(np.int32)
    row = np.arange(n, dtype=np.int64)
    devices = _two_devices(nshards) if two else [CPU] * nshards
    blocks = [tuple(torch.from_numpy(a[i * B:(i + 1) * B]).to(devices[i])
                    for a in (key1, key2, row)) for i in range(nshards)]
    out = seqpfp._bitonic_block_sort(blocks, devices)
    k1, k2, rows = (np.concatenate([b[k].numpy() for b in out])
                    for k in range(3))
    key = (k1.astype(np.int64) + 1) * 2**32 + k2
    assert (np.diff(key) >= 0).all()
    assert np.array_equal(np.sort(rows), row)           # none lost or doubled
    assert np.array_equal(key1[rows], k1) and np.array_equal(key2[rows], k2)
    want = np.argsort((key1.astype(np.int64) + 1) * 2**32 + key2,
                      kind="stable")
    for value in np.unique(key):
        sel = key == value
        assert sorted(rows[sel]) == sorted(
            want[sel])  # the same rows under each key


def _jax_wide_step(rb, opts, jprep, nshards, M):
    size_cap = t_engine.interval_size_cap(opts, rb.num_docs)
    step = jax_widepfp.compile_wide_step(
        _jax_mesh(nshards), "seq", jprep["nr"], jprep["nd"], jprep["w"],
        rb.num_docs, opts.max_doc_freq, size_cap, opts.merge, M,
        mem_mode=not opts.mum_mode, lvl_cap=jprep["lvl_cap"])
    counts, windows = step(
        jprep["parse"], jprep["d_starts"], jprep["cumcnt"], jprep["m"],
        jprep["total_rows"], jprep["n_text"], jprep["isaP"],
        jprep["grp_of_pos"], jprep["d"], jprep["slt_table"],
        jprep["grp_cross"], jprep["doc_ends"],
        jnp.int32(opts.min_match_len), jnp.int32(opts.num_distinct),
        jnp.int32(opts.max_total_freq))
    return np.asarray(counts), {k: np.asarray(v) for k, v in windows.items()}


@pytest.mark.parametrize("nshards,kw", [
    (2, {}), (4, {}), (2, {"merge": True}), (4, {"rare_freq": 2})])
def test_analyze_and_compact_windows_match_jax(rng, nshards, kw):
    """Stages C and D through one prepared collection: the per-shard
    counts and the real rows of every window array equal the JAX block
    scan's (its uint32 globals read as int64, its no-previous sentinel as
    -1)."""
    rep = rand_seq(rng, 60)
    rb, jprep, prep = _jax_prepared(rng, 4, 500,
                                    insert_rep=rep if "rare_freq" in kw
                                    else None)
    opts = options.normalize(rb.num_docs, quiet=True, **kw)
    M = 256
    jcounts, jwin = _jax_wide_step(rb, opts, jprep, nshards, M)
    counts, windows = widepfp.wide_step(
        prep, [CPU] * nshards, rb.num_docs, opts.min_match_len,
        opts.num_distinct, opts.max_total_freq, opts.max_doc_freq,
        t_engine.interval_size_cap(opts, rb.num_docs), opts.merge, M,
        mem_mode=not opts.mum_mode)
    assert counts.tolist() == jcounts.tolist() and counts[0] > 0
    assert set(windows[0]) == set(jwin)
    for i, wd in enumerate(windows):
        for key, got in wd.items():
            want = jwin[key].reshape((nshards, -1) + jwin[key].shape[1:])[i]
            if want.dtype == np.uint32:
                want = want.astype(np.int64)
                want[want == 0xFFFFFFFF] = -1
            got = got.numpy()
            if key in ("count", "cand_count"):
                assert got.tolist() == want.tolist(), (i, key)
                continue
            n = int(wd["cand_count" if key.startswith("c_") else "count"])
            if key in ("w_sa", "w_da", "w_prev"):
                # window columns past the interval's end are not compared
                valid = (wd["s"].numpy()[:n, None]
                         + np.arange(got.shape[1])) < wd["e"].numpy()[:n, None]
                assert np.array_equal(got[:n][valid], want[:n][valid]), \
                    (i, key)
            else:
                assert np.array_equal(got[:n], want[:n]), (i, key)


# ---------------------------------------------------------------------------
# on the card (skipped here): the shards spread over every visible card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("kw,nshards", [({}, 2), ({}, 4), ({}, 8),
                                        ({"rare_freq": 2}, 4),
                                        ({"merge": True}, 4)])
def test_cuda_sharded_matches_cpu_single_device(rng, kw, nshards):
    """The sharded scan on cuda (one card: every shard on it; several
    cards: round-robin, so blocks and halos cross cards) against the
    single-device CPU path, byte for byte."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rep = rand_seq(rng, 60)
    rb = build(mutated_collection(rng, 4, base_len=20000, n_mut=30,
                                  insert_rep=rep if "rare_freq" in kw
                                  else None))
    opts = options.normalize(rb.num_docs, quiet=True, **kw)
    devices = mesh.seq_devices(nshards, "cuda")
    assert len(set(devices)) == min(nshards, torch.cuda.device_count())
    want = t_engine.find_matches(rb, opts, device="cpu")
    got = seqpfp.find_matches_seq_sharded(rb, opts, devices, M=1 << 16)
    assert got.output_bytes() == want.output_bytes() != b""
    assert got.bwt_runs == want.bwt_runs
    if kw.get("merge"):
        assert (got.candidate_thresh == want.candidate_thresh).all()
