"""The port's multi-card deployment, small, on the CPU: dcn with four
ranks (MumemtoM anchor partitions as worker processes of one gloo group)
against the JAX package's single-process MumemtoM, chip_smoke's
occurrence hash of a .mums file against native/baseline_cpu's, the scan's
phase hook on a mesh of several cards, and a rehearsal of `chip_smoke.py
--cards` (phase_cards) at 4-8 kbp a document with the stand-ins of
tests/test_torch_scale.py. A gpu-marked case runs the four ranks on the
cards, rank r on cuda:{r % device_count()}.

Both packages get the same numpy bytes, made from a seed; the JAX side runs
on its CPU backend. Tolerance: none (files, counts and hashes are equal).
"""

import importlib
import os
import sys

import numpy as np
import pytest
import torch

from mumemto_tpu import options
from mumemto_tpu.parallel import mumemtom as jax_mumemtom
from mumemto_tpu_torch import bench as t_bench
from mumemto_tpu_torch import device as t_device
from mumemto_tpu_torch import engine as t_engine
from mumemto_tpu_torch import refbuilder
from mumemto_tpu_torch import trace
from mumemto_tpu_torch.kernels import kr_mask
from mumemto_tpu_torch.ops import pfp as t_pfp
from mumemto_tpu_torch.parallel import mesh as t_mesh
from mumemto_tpu_torch.parallel import mumemtom, seqpfp
from test_torch_dcn import _run_ranks, _write_collection
from test_torch_scale import _count_scans, _dict_flat, _NoCard, _TorchOnCpu

# several test workers share the machine's cores
torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 4


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, ROOT)
    try:
        return importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(ROOT)


def _check_ranks(got, prefix, want):
    for rank, (rc, out) in enumerate(got):
        assert rc == 0, out[-2000:]
        # one anchor partition a rank: partition r on rank r
        assert f"WORKER_OK {rank} scanned [{rank}]" in out, out[-2000:]
    for ext in (".mums", ".athresh", ".lengths"):
        a = open(want + ext, "rb").read()
        assert a and open(prefix + ext, "rb").read() == a, ext


@pytest.mark.parametrize("collective", [False, True],
                         ids=["host fold", "collective fold"])
def test_dcn_four_ranks_equals_jax(rng, tmp_path, collective):
    """Four processes, one anchor partition each (the anchor and one more
    genome), write the JAX package's run_partitioned_files(files, prefix,
    num_partitions=4) files byte for byte."""
    paths = _write_collection(rng, tmp_path)
    assert [len(p) for p in mumemtom.auto_partition(paths, RANKS)] == \
        [2] * RANKS
    ref = str(tmp_path / "jax")
    jax_mumemtom.run_partitioned_files(paths, ref, num_partitions=RANKS,
                                       anchor=True)
    prefix = str(tmp_path / "dcn")
    got = _run_ranks(tmp_path, paths, prefix, collective, ("cpu",) * RANKS)
    _check_ranks(got, prefix, ref)


@pytest.mark.gpu
def test_cuda_dcn_four_ranks_equals_single(rng, tmp_path):
    """Four processes, rank r on cuda:{r % device_count()} (one card each
    on four cards, all four on one), against the single-process MumemtoM
    of four partitions on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    paths = _write_collection(rng, tmp_path)
    single = str(tmp_path / "single")
    mumemtom.run_partitioned_files(paths, single, num_partitions=RANKS,
                                   anchor=True, device="cuda")
    cards = torch.cuda.device_count()
    prefix = str(tmp_path / "dcn")
    got = _run_ranks(tmp_path, paths, prefix, False,
                     tuple(f"cuda:{r % cards}" for r in range(RANKS)))
    _check_ranks(got, prefix, single)


def _strand_docs(rng):
    """Three documents of one random base with a few SNPs each; the third
    carries a segment reverse-complemented, so some MUMs lie on '-'."""
    base = rng.choice(np.frombuffer(b"ACGT", np.uint8), 3000)
    docs = []
    for i in range(3):
        d = base.copy()
        for j in rng.integers(0, d.size, 6):
            d[j] = rng.choice(np.frombuffer(b"ACGT", np.uint8))
        if i == 2:
            comp = np.zeros(256, np.uint8)
            comp[list(b"ACGT")] = list(b"TGCA")
            d[1000:2000] = comp[d[1000:2000][::-1]]
        docs.append(d)
    return docs


def test_occ_hash_equals_baseline_cpu(chip_smoke, rng, tmp_path):
    """t_bench.occ_stats of the port's .mums (count, sum of lengths
    and the order-free occurrence hash) equals native/baseline_cpu's on
    the same text, revcomp on, with MUMs on both strands; a changed
    strand or offset changes the hash."""
    rb = t_bench.rb_of(_strand_docs(rng))
    opts = options.normalize(rb.num_docs, quiet=True)
    res = t_engine.find_matches(rb, opts, device="cpu")
    prefix = str(tmp_path / "strands")
    t_engine.write_outputs(res, rb, prefix)
    got = t_bench.occ_stats(prefix + ".mums", rb.num_docs)
    base = t_bench.cpu_baseline(rb.text, rb.seq_lengths, opts)
    assert got == {k: base[k] for k in ("matches", "sum_len", "occ_hash")}
    lines = open(prefix + ".mums").read().splitlines()
    strands = {s for ln in lines for s in ln.split("\t")[2].split(",")}
    assert {"+", "-"} <= strands and got["matches"] > 1
    flipped = tmp_path / "flipped.mums"
    first = lines[0].split("\t")
    first[2] = first[2].replace("+", "-", 1)
    flipped.write_text("\n".join(["\t".join(first)] + lines[1:]) + "\n")
    moved = t_bench.occ_stats(str(flipped), rb.num_docs)
    assert moved["matches"] == got["matches"]
    assert moved["occ_hash"] != got["occ_hash"]


def test_sharded_phase_hook_syncs_every_card(monkeypatch):
    """With MUMEMTO_TPU_PROFILE=1 a sharded scan's stage times wait for
    every card of its mesh, not only the first: find_matches_seq_sharded
    hands the whole mesh to engine._phase_logger, whose hook synchronizes
    each distinct CUDA device once a stage (the CPU none)."""
    seen = []
    real = t_engine._phase_logger
    monkeypatch.setattr(t_engine, "_phase_logger",
                        lambda devices: seen.append(devices) or
                        real(devices))
    rb = refbuilder.build_from_sequences([["ACGTACGTTTGACCA" * 20]] * 2)
    mesh = [torch.device("cpu"), torch.device("cpu", 0)] * 2
    seqpfp.find_matches_seq_sharded(rb, options.normalize(2, quiet=True),
                                    mesh, M=4096)
    assert seen == [mesh]
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    monkeypatch.setenv("MUMEMTO_TPU_PROFILE", "1")
    cards = [torch.device("cuda", i % 2) for i in range(4)]
    real(cards + [torch.device("cpu")])("sort")
    assert synced == cards[:2]


def test_phase_cards_rehearsal(chip_smoke, monkeypatch):
    """phase_cards' rows (k, m1, m2, s, c, p, the shard_dict runs and m2's
    baseline) at 4 kbp a document (C20 0.08 Mbp, C40 0.16 Mbp), on the CPU
    with the stand-ins of the phase 13/14 rehearsals: "cuda:r" resolves
    to the CPU, torch.cuda's sync and memory counters do nothing, the KR
    wrapper and the running max / min count a launch around their plain
    versions, and a stand-in refusal at the rehearsal's scale: a range-min
    table as large as C40's union's raises ScanSizeError, so m2's union is
    refused and its four partitions are not."""
    doc_mbp = 0.004
    c40 = t_bench.rb_of(t_bench.synth_collection(40 * doc_mbp, 40))
    limit = _dict_flat(c40)
    real_rmq = t_pfp._rmq_query

    def guard_at_scale(table, lo, hi):
        n, levels = int(table[0].shape[0]), len(table)
        if n * levels >= limit:
            raise t_pfp.ScanSizeError(f"{levels} levels x {n} entries: the "
                                      "rehearsal's one-card limit")
        return real_rmq(table, lo, hi)

    def on_cpu(device):
        return torch.device("cpu")

    def counted_plain(ext, n_real, w, mod):
        trace.count(kr_mask.COUNTER)
        return kr_mask.break_mask_plain(ext, n_real, w, mod)

    class NoCard(_NoCard):
        def is_available(self):
            return False

    class TorchOnCpu(_TorchOnCpu):
        cuda = NoCard()
    monkeypatch.setattr(t_engine, "resolve", on_cpu)
    monkeypatch.setattr(t_device, "resolve", on_cpu)
    monkeypatch.setattr(t_mesh, "resolve", on_cpu)
    monkeypatch.setattr(kr_mask, "break_mask", counted_plain)
    _count_scans(monkeypatch)
    monkeypatch.setattr(t_pfp, "_rmq_query", guard_at_scale)
    # the dcn workers inherit it: two threads each
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    report = {}
    chip_smoke.phase_cards(TorchOnCpu(), report, doc_mbp=doc_mbp,
                           bench_mbp=0.06, part_doc_mbp=0.004,
                           shard_dict_mbp=(0.04,), kr_mbp=0.03,
                           dcn_device="cpu")
    rows = report["rows"]
    assert list(rows) == ["k", "m1", "m2", "s", "c", "p", "shard_dict"]
    assert [r["mismatches"] for r in rows["k"]] == [0, 0]
    assert all(r["breaks"] > 0 for r in rows["k"])
    m1 = rows["m1"]
    assert m1["partition_docs"] == [6, 6, 6, 5]
    assert [p["kr_launches"] for p in m1["single_process"]["partitions"]] \
        == [1] * RANKS
    for run in m1["runs"].values():
        assert [r["scanned"] for r in run["ranks"]] == [[r] for r in
                                                        range(RANKS)]
        assert run["only_union"] + run["only_merged"] == \
            run["terminal_touching_differences"]
    m2 = rows["m2"]
    assert m2["refused"]["refused"] and m2["refused"]["dict_flat"] >= limit
    parts = [p for r in m2["ranks"] for p in r["partitions"]]
    assert [p["docs"] for p in parts] == [11, 11, 11, 10]
    assert all(p["nd"] * p["dict_levels"] < limit for p in parts)
    base = m2["baseline"]
    assert m2["merged"] == {k: base[k] for k in ("matches", "sum_len",
                                                 "occ_hash")}
    assert m2["merged"]["matches"] > 0
    s = rows["s"]["runs"]
    assert [(r["input"], r["shards"]) for r in s] == [
        (inp, n) for inp in ("C20", "bench 0.06 Mbp")
        for n in (1, 4, 4, 8)]
    assert all(r["bytes_equal"] for r in s if r["shards"] > 1)
    assert all(r["launches"]["running_scan"] > 0 for r in s)
    assert rows["s"]["trace"]["bytes_equal"]
    assert rows["c"]["fold"]["devices"] == ["cpu"] * RANKS
    assert rows["p"]["mesh_shape"] == [2, 2]
    assert len(rows["p"]["ran_on"]) == 4
    assert [(r["shards"], r["shard_dict"]) for r in rows["shard_dict"]] == [
        (1, False), (8, False), (8, True), (8, True), (8, False)]
