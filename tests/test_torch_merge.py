"""The port's `merge` subcommand, MumemtoM partitioned runs and the
device-OOM fallback to partitions, against mumemto_tpu.

One collection shape throughout: mutated copies of a 400 bp base with a
unique 25 bp flank at each end (tests/test_merge.py's `_genomes`: the
flanks keep MUMs off the '$' terminators, where the merge == union
invariant does not hold for the reference either). Tolerance: byte
equality of files, equality of the sorted MUM sets.
"""

import os

import numpy as np
import pytest
import torch

from mumemto_tpu import cli as jax_cli
from mumemto_tpu import formats
from mumemto_tpu.parallel import mumemtom as jax_mumemtom
from mumemto_tpu_torch import cli as t_cli
from mumemto_tpu_torch import engine as t_engine
from mumemto_tpu_torch.parallel import mumemtom
from conftest import rand_seq

# several test workers share the machine's cores
torch.set_num_threads(2)

CPU = ["--device", "cpu"]


def _genomes(rng, n, base_len=400, n_mut=10):
    """Mutated copies of one base, each with unique 25 bp flanks."""
    base = rand_seq(rng, base_len)
    out = []
    for _ in range(n):
        s = list(base)
        for _ in range(int(rng.integers(2, n_mut))):
            s[int(rng.integers(0, len(s)))] = rng.choice(list("ACGT"))
        out.append(rand_seq(rng, 25) + "".join(s) + rand_seq(rng, 25))
    return out


def _fastas(rng, tmp_path, n, tag="g"):
    paths = []
    for i, g in enumerate(_genomes(rng, n)):
        p = tmp_path / f"{tag}{i}.fa"
        p.write_text(f">{tag}{i}\n{g}\n")
        paths.append(str(p))
    return paths


def _sorted_set(path, num_docs):
    L, S, T = formats.parse_mums(path, num_docs)
    order = np.lexsort((L, S[:, 0]))
    return L[order].tolist(), S[order].tolist(), T[order].tolist()


def _union(paths, tmp_path):
    union = str(tmp_path / "union")
    assert t_cli.main(paths + ["-o", union, *CPU]) == 0
    return _sorted_set(union + ".mums", len(paths))


# (merge scheme, build flags, merged files)
SCHEMES = [("anchor", ["-M", "-n"], [".mums", ".lengths", ".athresh"]),
           ("string", ["-M"], [".mums", ".lengths", ".thresh",
                               ".thresh_rev"])]


@pytest.mark.parametrize("scheme,flags,exts", SCHEMES)
def test_merge_subcommand_bytes_match_jax(rng, tmp_path, scheme, flags,
                                          exts):
    """`merge` of two partitions through both CLIs: the same merged
    files, byte for byte, and no temporary files left behind."""
    paths = _fastas(rng, tmp_path, 5)
    parts = ([paths[:3], [paths[0], *paths[3:]]] if scheme == "anchor"
             else [paths[:3], paths[3:]])
    mums = []
    for i, part in enumerate(parts):
        pre = str(tmp_path / f"p{i}")
        assert t_cli.main(part + ["-o", pre, *flags, *CPU]) == 0
        mums.append(pre + ".mums")
    out = tmp_path / "out"
    out.mkdir()
    assert jax_cli.main(["merge", *mums, "-o", str(out / "jax")]) == 0
    assert t_cli.main(["merge", *mums, "-o", str(out / "torch"), *CPU]) == 0
    names = sorted(os.listdir(out))
    assert names == sorted(p + e for p in ("jax", "torch") for e in exts)
    for ext in exts:
        a = (out / ("jax" + ext)).read_bytes()
        assert a and (out / ("torch" + ext)).read_bytes() == a, ext
    leftovers = [n for n in os.listdir(tmp_path)
                 if "_mums.fa" in n or "_temp_merged" in n]
    assert not leftovers
    assert _sorted_set(str(out / "torch.mums"), 5) == _union(paths, tmp_path)


def test_merge_collective_refused(rng, tmp_path, capsys):
    """`merge --collective` and merge_partition_outputs(collective=True)
    are not refused: both run, with the host anchor fold's bytes."""
    paths = _fastas(rng, tmp_path, 5)
    mums = []
    for i, part in enumerate([paths[:3], [paths[0], *paths[3:]]]):
        pre = str(tmp_path / f"p{i}")
        assert t_cli.main(part + ["-o", pre, "-M", "-n", *CPU]) == 0
        mums.append(pre + ".mums")
    assert t_cli.main(["merge", *mums, "-o", str(tmp_path / "host"),
                       *CPU]) == 0
    assert t_cli.main(["merge", *mums, "-o", str(tmp_path / "coll"),
                       "--collective", *CPU]) == 0
    assert "not yet ported" not in capsys.readouterr().err
    merged = mumemtom.merge_partition_outputs(
        mums, str(tmp_path / "mm"), collective=True, device="cpu")
    assert merged == str(tmp_path / "mm.mums")
    for ext in (".mums", ".athresh", ".lengths"):
        a = (tmp_path / ("host" + ext)).read_bytes()
        assert a and (tmp_path / ("coll" + ext)).read_bytes() == a, ext
        assert (tmp_path / ("mm" + ext)).read_bytes() == a, ext


@pytest.mark.parametrize("n_docs,nparts,anchor", [
    (6, 2, True), (6, 2, False), (4, 3, False), (5, 4, True)])
def test_run_partitioned_equals_union(rng, tmp_path, n_docs, nparts, anchor):
    paths = _fastas(rng, tmp_path, n_docs)
    merged = mumemtom.run_partitioned_files(
        paths, str(tmp_path / "merged"), num_partitions=nparts,
        anchor=anchor, device="cpu")
    assert merged == str(tmp_path / "merged.mums")
    assert _sorted_set(merged, n_docs) == _union(paths, tmp_path)


@pytest.mark.parametrize("n_files", [2, 3, 4, 5, 7])
@pytest.mark.parametrize("anchor", [True, False])
def test_auto_partition_matches_jax(n_files, anchor):
    files = [f"f{i}" for i in range(n_files)]
    for req in (1, 2, 3, 4, 8):
        assert mumemtom.auto_partition(files, req, anchor=anchor) == \
            jax_mumemtom.auto_partition(files, req, anchor=anchor)


def test_single_partition_is_renamed(rng, tmp_path):
    paths = _fastas(rng, tmp_path, 3)
    merged = mumemtom.run_partitioned([paths], str(tmp_path / "one"),
                                      anchor=True, device="cpu")
    assert sorted(n for n in os.listdir(tmp_path) if n.startswith("one")) \
        == ["one.athresh", "one.lengths", "one.mums"]
    assert _sorted_set(merged, 3) == _union(paths, tmp_path)


# ---------------------------------------------------------------------------
# device out-of-memory handling of the build command
# ---------------------------------------------------------------------------

def _oom(msg="CUDA out of memory. Tried to allocate 2.00 GiB"):
    return torch.cuda.OutOfMemoryError(msg)


def test_is_device_oom():
    assert t_cli._is_device_oom(_oom())
    assert t_cli._is_device_oom(RuntimeError(
        "CUDA out of memory. Tried to allocate 20.00 MiB"))
    assert not t_cli._is_device_oom(RuntimeError(
        "device cuda was asked for, but CUDA is not available"))
    assert not t_cli._is_device_oom(MemoryError())
    assert not t_cli._is_device_oom(ValueError("bad input"))


def _patch_scan(monkeypatch, oom_when):
    """find_matches raises a CUDA OOM when oom_when(num_docs); a spy on
    torch.cuda.empty_cache counts the fallback's releases."""
    real = t_engine.find_matches
    freed = []

    def scan(rb, opts, **kw):
        if oom_when(rb.num_docs):
            raise _oom()
        return real(rb, opts, **kw)

    monkeypatch.setattr(t_engine, "find_matches", scan)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: freed.append(1))
    return freed


@pytest.mark.parametrize("n_docs,oom_from,nparts", [(5, 5, 2), (5, 3, 4)])
def test_oom_falls_back_to_partitions(rng, tmp_path, capsys, monkeypatch,
                                      n_docs, oom_from, nparts):
    """A CUDA OOM on the union scan is retried as anchor partitions on the
    same device, doubling the partition count while partitions run out
    of memory too; the result is the union's MUM set."""
    paths = _fastas(rng, tmp_path, n_docs)
    want = _union(paths, tmp_path)
    freed = _patch_scan(monkeypatch, lambda nd: nd >= oom_from)
    out = str(tmp_path / "oom")
    assert t_cli.main(paths + ["-o", out, *CPU]) == 0
    assert _sorted_set(out + ".mums", n_docs) == want
    err = capsys.readouterr().err
    assert f"retrying as {nparts} MumemtoM partitions" in err
    assert "partitioned fallback succeeded" in err
    assert len(freed) == nparts // 2  # one release before each retry
    assert os.path.exists(f"{out}_part{nparts - 1}.mums")


def test_oom_at_maximum_partitioning_exits_137(rng, tmp_path, capsys,
                                               monkeypatch):
    paths = _fastas(rng, tmp_path, 4)
    _patch_scan(monkeypatch, lambda nd: True)
    assert t_cli.main(paths + ["-o", str(tmp_path / "x"), *CPU]) == 137
    assert "even at maximum partitioning" in capsys.readouterr().err


@pytest.mark.parametrize("flags", [["-f", "3"], ["-M"], ["-b"], ["-k", "2"]])
def test_oom_ineligible_exits_137(rng, tmp_path, capsys, monkeypatch, flags):
    """Runs the partitions would not reproduce report the OOM (exit 137)
    instead of falling back."""
    paths = _fastas(rng, tmp_path, 4)
    freed = _patch_scan(monkeypatch, lambda nd: True)
    assert t_cli.main(paths + ["-o", str(tmp_path / "x"), *flags,
                               *CPU]) == 137
    assert "device ran out of memory" in capsys.readouterr().err
    assert not freed


def test_host_memory_error_exits_137(rng, tmp_path, capsys, monkeypatch):
    paths = _fastas(rng, tmp_path, 3)

    def scan(rb, opts, **kw):
        raise MemoryError

    monkeypatch.setattr(t_engine, "find_matches", scan)
    assert t_cli.main(paths + ["-o", str(tmp_path / "x"), *CPU]) == 137
    assert "ran out of memory" in capsys.readouterr().err


def test_cuda_unavailable_is_not_swallowed(rng, tmp_path, monkeypatch):
    paths = _fastas(rng, tmp_path, 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_cli.main(paths + ["-o", str(tmp_path / "x"), "--device", "cuda"])

    def scan(rb, opts, **kw):
        raise RuntimeError("device cuda was asked for, but CUDA is not "
                           "available")

    monkeypatch.setattr(t_engine, "find_matches", scan)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_cli.main(paths + ["-o", str(tmp_path / "y"), *CPU])
