"""The port's collective anchor merge (parallel/collective_merge) against
its host anchor fold and against mumemto_tpu's `merge --collective`.

Partitions are built by the port on torch-CPU from seeded collections
(tests/test_collective_merge.py's shapes: mutated copies of one base with
unique flanks, and a tandem-structured base whose anchor MUMs overlap); the
JAX side folds on its CPU mesh. Tolerance: none, bytes and integers are
equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mumemto_tpu import cli as jax_cli
from mumemto_tpu.parallel import collective_merge as jax_collective
from mumemto_tpu_torch import cli as t_cli
from mumemto_tpu_torch.analysis import merge as host_merge
from mumemto_tpu_torch.parallel import collective_merge, mumemtom
from conftest import rand_seq
from test_torch_merge import _genomes

# several test workers share the machine's cores
torch.set_num_threads(2)

CPU = ["--device", "cpu"]


def _overlapping_genomes(rng):
    """A tandem-structured base, so anchor MUMs overlap in coordinates:
    the emit-chain trace through the intermediate states is exercised."""
    core = rand_seq(rng, 120)
    base = core + core[:60] + rand_seq(rng, 200)
    genomes = []
    for i in range(5):
        s = list(base)
        for _ in range(3 + i):
            s[int(rng.integers(0, len(s)))] = rng.choice(list("ACGT"))
        genomes.append(rand_seq(rng, 25) + "".join(s) + rand_seq(rng, 25))
    return genomes


def _partitions(tmp_path, genomes, members):
    """Anchor partitions (-M -n) of `genomes`; members lists the genome
    indices of each. Returns the partitions' .mums paths."""
    paths = []
    for i, g in enumerate(genomes):
        p = tmp_path / f"g{i}.fa"
        p.write_text(f">g{i}\n{g}\n")
        paths.append(str(p))
    mums = []
    for k, idx in enumerate(members):
        pre = str(tmp_path / f"p{k}")
        assert t_cli.main([paths[i] for i in idx]
                          + ["-o", pre, "-M", "-n", *CPU]) == 0
        mums.append(pre + ".mums")
    return mums


CASES = {
    "two_way": (lambda rng: _genomes(rng, 5), [[0, 1, 2], [0, 3, 4]]),
    "four_way": (lambda rng: _genomes(rng, 9, base_len=600, n_mut=14),
                 [[0, 1, 2], [0, 3, 4], [0, 5, 6], [0, 7, 8]]),
    "overlapping": (_overlapping_genomes, [[0, 1, 2], [0, 3, 4]]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_collective_merge_bytes(rng, tmp_path, case):
    """`merge --collective`: the port's files equal its host fold's and
    mumemto_tpu's `merge --collective`, .mums, .athresh and .lengths."""
    make, members = CASES[case]
    mums = _partitions(tmp_path, make(rng), members)
    out = tmp_path / "out"
    out.mkdir()
    assert t_cli.main(["merge", *mums, "-o", str(out / "host"), *CPU]) == 0
    assert t_cli.main(["merge", *mums, "-o", str(out / "coll"),
                       "--collective", *CPU]) == 0
    assert jax_cli.main(["merge", *mums, "-o", str(out / "jax"),
                         "--collective"]) == 0
    for ext in (".mums", ".athresh", ".lengths"):
        a = (out / ("host" + ext)).read_bytes()
        assert a, ext
        assert (out / ("coll" + ext)).read_bytes() == a, ext
        assert (out / ("jax" + ext)).read_bytes() == a, ext


def test_collective_anchor_merge_function_and_bumbl(rng, tmp_path):
    """The function itself, its verbose line, the .bumbl output name, and
    mumemtom.merge_partition_outputs(collective=True)."""
    mums = _partitions(tmp_path, _genomes(rng, 5), [[0, 1, 2], [0, 3, 4]])
    host = host_merge.anchor_merge(mums, str(tmp_path / "host.mums"))
    got = collective_merge.collective_anchor_merge(
        mums, str(tmp_path / "coll"), device="cpu", verbose=True)
    assert got == str(tmp_path / "coll.mums")
    assert open(got, "rb").read() == open(host, "rb").read() != b""
    assert (tmp_path / "coll.athresh").read_bytes() == \
        (tmp_path / "host.athresh").read_bytes()
    host_b = host_merge.anchor_merge(mums, str(tmp_path / "hb.bumbl"))
    got_b = collective_merge.collective_anchor_merge(
        mums, str(tmp_path / "cb.bumbl"), device="cpu")
    assert got_b.endswith("cb.bumbl")
    assert open(got_b, "rb").read() == open(host_b, "rb").read()
    merged = mumemtom.merge_partition_outputs(
        mums, str(tmp_path / "mm"), collective=True, device="cpu")
    assert open(merged, "rb").read() == open(host, "rb").read()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        collective_merge.collective_anchor_merge(mums, str(tmp_path / "x"))


def test_collective_refused_for_string_merge(rng, tmp_path, capsys):
    genomes = _genomes(rng, 4)
    paths = []
    for i, g in enumerate(genomes):
        p = tmp_path / f"s{i}.fa"
        p.write_text(f">s{i}\n{g}\n")
        paths.append(str(p))
    pre = [str(tmp_path / "a"), str(tmp_path / "b")]
    for part, p in zip((paths[:2], paths[2:]), pre):
        assert t_cli.main(part + ["-o", p, "-M", *CPU]) == 0
    argv = ["merge", pre[0] + ".mums", pre[1] + ".mums", "-o",
            str(tmp_path / "m"), "--collective"]
    assert t_cli.main(argv + CPU) == 1
    err = capsys.readouterr().err
    assert "--collective applies to anchor-based merging only" in err
    assert jax_cli.main(argv) == 1


def _dense(g, n, n_mums):
    """Seeded dense (bv, nb, len_at): MUM starts with lengths that often
    overlap the next start, thresholds zero in places."""
    starts = np.sort(g.choice(n, n_mums, replace=False))
    bv = np.zeros(n, bool)
    bv[starts] = True
    len_at = np.zeros(n, np.int32)
    len_at[starts] = g.integers(15, 90, n_mums)
    nb = g.integers(0, 40, n).astype(np.int32)
    nb[g.random(n) < 0.1] = 0
    return bv, nb, len_at


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fold_pair_matches_jax(seed):
    g = np.random.default_rng(seed)
    n = 3000
    state, part = _dense(g, n, 60), _dense(g, n, 70)
    want = jax_collective._fold_pair(tuple(jnp.asarray(a) for a in state),
                                     tuple(jnp.asarray(a) for a in part))
    got = collective_merge._fold_pair(
        tuple(torch.from_numpy(a) for a in state),
        tuple(torch.from_numpy(a) for a in part))
    assert int(got[0].sum()) > 0
    for a, b in zip(want, got):
        assert np.asarray(a).dtype == b.numpy().dtype
        assert np.array_equal(np.asarray(a), b.numpy())


def test_fold_all_matches_jax():
    g = np.random.default_rng(5)
    n, parts = 2000, 4
    stacks = [np.stack(x) for x in zip(*(_dense(g, n, 50)
                                         for _ in range(parts)))]
    want = jax_collective._fold_all(*(jnp.asarray(a) for a in stacks),
                                    n_parts=parts)
    cpu = torch.device("cpu")
    devices = [cpu, torch.device("cpu", 0), cpu, cpu]
    got = collective_merge.collective_fold(*stacks, devices)
    assert got[3].shape == (parts - 1, n)
    for a, b in zip(want, got):
        assert np.array_equal(np.asarray(a), b.numpy())
    one = collective_merge._fold_all(*(torch.from_numpy(a[:1])
                                       for a in stacks))
    assert one[3].shape == (0, n) and torch.equal(
        one[0], torch.from_numpy(stacks[0][0]))


def test_dense_arrays_refuse_past_int32():
    lengths = np.array([30], np.int64)
    starts = np.array([[5, 7]], np.int64)
    strands = np.ones((1, 2), bool)
    bv = np.zeros(50, bool)
    bv[5] = True
    nb = np.zeros(50, np.int64)
    ok = collective_merge._dense_arrays(
        [(lengths, starts, strands, bv, nb)], 50)
    assert ok[2][0, 5] == 30 and ok[0][0, 5]
    for bad_nb, bad_len in ((2**31, 30), (0, 2**31)):
        nb2 = nb.copy()
        nb2[3] = bad_nb
        with pytest.raises(ValueError, match=">= 2\\^31 exceed"):
            collective_merge._dense_arrays(
                [(np.array([bad_len], np.int64), starts, strands, bv, nb2)],
                50)
    with pytest.raises(ValueError, match="anchor length mismatch"):
        collective_merge._dense_arrays(
            [(lengths, starts, strands, bv, nb)], 49)


@pytest.mark.gpu
def test_cuda_collective_merge_matches_host(rng, tmp_path):
    """The fold on cuda (the partitions spread over every visible card)
    against the host fold, byte for byte."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    make, members = CASES["four_way"]
    mums = _partitions(tmp_path, make(rng), members)
    host = host_merge.anchor_merge(mums, str(tmp_path / "host.mums"))
    got = collective_merge.collective_anchor_merge(
        mums, str(tmp_path / "coll.mums"), device="cuda")
    assert open(got, "rb").read() == open(host, "rb").read() != b""
    assert (tmp_path / "coll.athresh").read_bytes() == \
        (tmp_path / "host.athresh").read_bytes()
