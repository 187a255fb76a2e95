"""The sharded scan at the row space it was built for, small, on the CPU.

(a) The port's _host_prep against the JAX package's wide-coordinate
    _host_prep (row_dtype=np.uint32) on a fake parse whose rows pass
    0.75 x 2^31 (and 2^31) without ever being allocated.
(b) A small copy of chip_smoke's row w: 129 documents at 0.01% SNPs (the
    strict-MUM interval cap is 256, so the analysis takes the walk) through
    16 shards, against the port's single-device engine, the JAX package's
    block scan on its 8-device CPU mesh and native/baseline_cpu.
(c) A rehearsal of `chip_smoke.py --cards wr wbase kw w f1 w2` with the
    stand-ins of tests/test_torch_scale.py.
(d) What a 2^31-row bucket needs of the port: the single-device scan and
    the CLI refuse it cleanly, the CLI's partition fallback takes a
    refused union, a text past the int32 phrase coordinates is refused
    before it is copied, and the block sort releases each unsorted block
    as it sorts it.

Both packages get the same numpy bytes, made from a seed. Tolerance: none;
everything compared is an integer or a byte.
"""

import gc
import importlib
import os
import sys
import weakref

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mumemto_tpu import options
from mumemto_tpu.ops import pfp as jax_pfp
from mumemto_tpu.parallel import widepfp as jax_widepfp
from mumemto_tpu_torch import cli as t_cli
from mumemto_tpu_torch import device as t_device
from mumemto_tpu_torch import engine as t_engine
from mumemto_tpu_torch import formats
from mumemto_tpu_torch.kernels import kr_mask
from mumemto_tpu_torch.ops import pfp as t_pfp
from mumemto_tpu_torch.parallel import mesh as t_mesh
from mumemto_tpu_torch.parallel import mumemtom, seqpfp
from test_torch_scale import _count_scans, _NoCard, _TorchOnCpu

# several test workers share the machine's cores
torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
W = 10
SHARDS = 16
WALK_DOCS = 129  # the fewest documents whose strict-MUM cap (256) walks


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, ROOT)
    try:
        return importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(ROOT)


def _fake_parse(rows_per, n_occ, seed=5):
    """(phrase_ln, parse, n_rows): len(rows_per) phrases of rows_per[i] + w
    characters and a parse of n_occ draws from them."""
    phrase_ln = np.array([0] + [r + W for r in rows_per], np.int32)
    parse = np.random.default_rng(seed).integers(
        1, len(rows_per) + 1, n_occ).astype(np.int32)
    n_rows = int((phrase_ln[parse].astype(np.int64) - W).sum())
    return phrase_ln, parse, n_rows


def _fake_pfps(rows_per, n_occ):
    """The same fake PFPData in both packages (a 1 kB ext; _host_prep
    reads its length alone) and doc ends through the text."""
    phrase_ln, parse, n_rows = _fake_parse(rows_per, n_occ)
    npz = len(rows_per)
    phrase_st = np.zeros(npz + 1, np.int32)
    phrase_st[1:] = np.arange(npz) * 200 + 1
    kw = dict(w=W, n_text=n_rows - 1, m=int(parse.size), num_phrases=npz,
              d_len=int(phrase_ln.sum()) + npz + 1, parse=parse,
              phrase_st=phrase_st, phrase_ln=phrase_ln,
              alpha=(2, 65, 67, 71, 84))
    ext = np.zeros(1024, np.uint8)
    ours = t_pfp.PFPData(ext=torch.from_numpy(ext), **kw)
    theirs = jax_pfp.PFPData(ext=jnp.asarray(ext), **kw)
    doc_ends = np.linspace(0, n_rows - 2, 7).astype(np.int64)[1:]
    return ours, theirs, doc_ends, n_rows


@pytest.mark.parametrize("rows_per,n_occ,nr", [
    ((800, 760, 880, 720), 2_200_000, 2**31),
    ((1100, 1045, 1210, 990), 2_200_000, 3 << 30)],
    ids=["2^31 bucket", "past 2^31"])
def test_host_prep_equals_jax_wide(rows_per, n_occ, nr):
    """(a) nr, cumcnt, cumC, doc_ends and total_rows equal the JAX
    package's uint32 preparation value for value: a 2^31 bucket of
    0.82 x 2^31 rows keeps int32 cumcnt, rows past 2^31 take int64."""
    ours, theirs, doc_ends, n_rows = _fake_pfps(rows_per, n_occ)
    assert 0.75 * 2**31 < n_rows and t_pfp.bucket(n_rows) == nr
    h = t_pfp._host_prep(ours, doc_ends)
    j = jax_pfp._host_prep(theirs, doc_ends, 6, row_dtype=np.uint32)
    assert h["nr"] == j["nr"] == nr
    assert h["total_rows"] == int(j["total_rows"]) == n_rows
    assert h["cumcnt"].dtype == (torch.int32 if n_rows < 2**31
                                 else torch.int64)
    for key in ("cumcnt", "cumC", "doc_ends"):
        assert np.array_equal(h[key].numpy(), np.asarray(j[key])), key
    assert int(h["cumcnt"][ours.m]) == n_rows


@pytest.fixture(scope="module")
def walk_collection(chip_smoke):
    """129 documents of 5 kbp, 0.01% SNPs (one a document)."""
    docs = chip_smoke._wide_docs(WALK_DOCS * 0.005, WALK_DOCS)
    return chip_smoke._rb_of(docs)


def test_row_w_small_equals_engine_jax_and_baseline(chip_smoke, tmp_path,
                                                     walk_collection):
    """(b) 16 shards on the CPU mesh [cpu, cpu:0, ...]: the .mums bytes of
    the single-device engine and of the JAX package's block scan on 8 CPU
    devices, and baseline_cpu's count, sum of lengths and hash."""
    rb = walk_collection
    opts = options.normalize(rb.num_docs, quiet=True)
    assert t_engine.interval_size_cap(opts, rb.num_docs) == 256
    devices = [torch.device("cpu", 0) if i % 2 else CPU
               for i in range(SHARDS)]
    got = seqpfp.find_matches_seq_sharded(rb, opts, devices, M=4096)
    want = t_engine.find_matches(rb, opts, device="cpu").output_bytes()
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:8]), ("seq",))
    jax_bytes = jax_widepfp.find_matches_wide(rb, opts, mesh).output_bytes()
    assert got.output_bytes() == want == jax_bytes
    assert got.num_matches > 20
    prefix = str(tmp_path / "w")
    t_engine.write_outputs(got, rb, prefix)
    base = chip_smoke._cpu_baseline(rb.text, rb.seq_lengths, opts)
    assert chip_smoke._occ_stats(prefix + ".mums", rb.num_docs) == \
        chip_smoke._triple(base)


def _stand_ins(monkeypatch):
    """The rehearsal stand-ins: "cuda:r" resolves to the CPU, torch.cuda
    does nothing, the KR wrapper and the running max / min count a launch
    around their plain versions."""
    def on_cpu(device):
        return CPU

    def counted_plain(ext, n_real, w, mod):
        kr_mask.launches += 1
        return kr_mask.break_mask_plain(ext, n_real, w, mod)
    for mod in (t_engine, t_device, t_mesh):
        monkeypatch.setattr(mod, "resolve", on_cpu)
    monkeypatch.setattr(kr_mask, "break_mask", counted_plain)
    monkeypatch.setattr(kr_mask, "launches", 0)
    _count_scans(monkeypatch)
    # the dcn workers inherit it: two threads each
    monkeypatch.setenv("OMP_NUM_THREADS", "2")


def test_phase_wide_rehearsal(chip_smoke, monkeypatch):
    """(c) `--cards wr wbase kw w f1 w2` at 3 kbp a document (129 documents,
    0.39 Mbp; wr at half that) on the CPU with the stand-ins, and the
    single-device row limit at the collection's bucket, so the CLI's union
    on one card is refused as row w's is on the card and its partitions
    are not: every triple equals the live baseline_cpu's."""
    doc_mbp, n_docs = 0.003, WALK_DOCS
    rb = chip_smoke._rb_of(chip_smoke._wide_docs(doc_mbp * n_docs, n_docs))
    limit = t_pfp.bucket(int(rb.text.size) + 1)
    _stand_ins(monkeypatch)
    monkeypatch.setattr(t_pfp, "ROW_LIMIT", limit)

    class NoCard(_NoCard):
        def is_available(self):
            return False

    class TorchOnCpu(_TorchOnCpu):
        cuda = NoCard()
    report = {}
    chip_smoke.phase_wide(TorchOnCpu(), report,
                          ("w2", "f1", "w", "kw", "wbase", "wr"),
                          doc_mbp=doc_mbp, n_docs=n_docs,
                          rehearsal_mbp=doc_mbp * n_docs / 2, M=1024,
                          dcn_device="cpu")
    rows = report["rows"]
    assert list(rows) == ["wr", "kw", "w", "f1", "w2", "wbase"]
    assert rows["kw"]["mismatches"] == 0 and rows["kw"]["breaks"] > 0
    base = chip_smoke._triple(rows["wbase"])
    assert base["matches"] > 0
    wr = rows["wr"]
    assert wr["bytes_equal_single"] and wr["shards"] == SHARDS
    assert wr["triple"] == chip_smoke._triple(wr["baseline"])
    assert wr["kr"]["mismatches"] == 0 and wr["kr"]["chunks"] == 8
    w = rows["w"]
    assert w["triple"] == base and w["rows"] > 0.75 * w["nr"]
    assert w["nr"] == limit and w["launches"]["kr_break_mask"] == 1
    assert w["launches"]["running_scan"] > 0
    assert len(w["shard_matches"]) == SHARDS and not w["retries"]
    assert w["kr"]["breaks"] > 0 and w["kr"]["launches"] == 1
    assert w["cli"]["rc"] == 0 and w["cli"]["mums_equal_library"]
    assert {"build_pfp", "dict_index", "parse_side", "operands", "sort",
            "analyze", "assemble", "emit (in assemble)"} == set(
                w["stages_s"])
    f1 = rows["f1"]
    assert f1["rc"] == 0 and f1["triple"] == base
    assert [a["what"] for a in f1["attempts"]] == [
        f"scan of {n_docs} docs", "scan of 65 docs", "scan of 65 docs",
        "2 partitions"]
    assert "row spaces past 2^31 need the block (wide) scan" in \
        f1["attempts"][0]["end"]
    assert f1["launches"]["kr_break_mask"] == 3
    w2 = rows["w2"]
    assert w2["triple"] == base and w2["partition_docs"] == [17] * 8
    assert [r["scanned"] for r in w2["ranks"]] == [[0, 4], [1, 5], [2, 6],
                                                   [3, 7]]


def test_phase_wide_m3_rehearsal(chip_smoke, monkeypatch):
    """Row m3 at 4 kbp a document (40 genomes at 0.1% SNPs) with the
    stand-ins and a stand-in refusal at the union's scale (ScanSizeError
    from a range-min table as large as the union's, as
    tests/test_torch_cards.py rehearses row m2): the union on one card is
    refused, four dcn ranks take it, and the merged triple equals the live
    baseline_cpu's, started before the row."""
    from test_torch_scale import _dict_flat
    union = chip_smoke._rb_of(chip_smoke._synth_collection(0.16, 40))
    limit = _dict_flat(union)
    real_rmq = t_pfp._rmq_query

    def guard_at_scale(table, lo, hi):
        n, levels = int(table[0].shape[0]), len(table)
        if n * levels >= limit:
            raise t_pfp.ScanSizeError(f"{levels} levels x {n} entries: the "
                                      "rehearsal's one-card limit")
        return real_rmq(table, lo, hi)
    _stand_ins(monkeypatch)
    monkeypatch.setattr(t_pfp, "_rmq_query", guard_at_scale)
    report = {}
    chip_smoke.phase_wide(_TorchOnCpu(), report, ("m3",), m3_docs=40,
                          m3_doc_mbp=0.004, dcn_device="cpu")
    m3 = report["rows"]["m3"]
    assert m3["refused"]["refused"]
    assert [p["docs"] for r in m3["ranks"] for p in r["partitions"]] == \
        [11, 11, 11, 10]
    assert m3["merged"] == chip_smoke._triple(m3["baseline"])
    assert m3["merged"]["matches"] > 0


def test_phase_wide_needs_a_baseline(chip_smoke):
    """Rows checked against baseline_cpu refuse to start without its
    triple (no wbase in the call and no W_BASELINE given)."""
    with pytest.raises(AssertionError, match="need baseline_cpu's triple"):
        chip_smoke.phase_wide(_TorchOnCpu(), {}, ("w",), baseline=None)


# ---------------------------------------------------------------------------
# (d) the refusals and repairs
# ---------------------------------------------------------------------------

def test_single_device_scan_refuses_past_2_31(monkeypatch):
    """pfp_scan on a 2^31 bucket raises ScanSizeError in the JAX package's
    words before the dictionary index, the first stage that allocates."""
    ours, _, doc_ends, n_rows = _fake_pfps((800, 760, 880, 720), 2_200_000)

    def reached(*a, **kw):
        raise AssertionError("reached the dictionary index")
    monkeypatch.setattr(t_pfp, "_dict_index", reached)
    with pytest.raises(t_pfp.ScanSizeError,
                       match=r"^row spaces past 2\^31 need the block \(wide\)"
                             rf" scan: {n_rows} rows \(bucket 2147483648\)"):
        t_pfp.pfp_scan(ours, doc_ends, 6, 20, 6, 0, 1, size_cap=8)


def test_cli_refuses_past_2_31_cleanly(tmp_path, capsys):
    """The CLI resuming a parse (-p) of a 2^31-row bucket exits 1 with the
    refusal and no traceback."""
    phrase_ln, parse, n_rows = _fake_parse((800, 760, 880, 720), 2_200_000)
    prefix = str(tmp_path / "big")
    body = b"".join(b"A" * int(n) + b"\x01" for n in phrase_ln[1:]) + b"\x00"
    (tmp_path / "big.dict").write_bytes(body)
    parse.astype("<u4").tofile(prefix + ".parse")
    half = (n_rows // 2) // 2
    formats.write_lengths(prefix + ".lengths", ["a.fa", "b.fa"],
                          [["a"], ["b"]], [[half], [half]])
    rc = t_cli.main(["-p", prefix, "-o", str(tmp_path / "out"),
                     "--device", "cpu"])
    err = capsys.readouterr().err
    assert rc == 1
    assert "Error: row spaces past 2^31 need the block (wide) scan" in err
    assert "Traceback" not in err


@pytest.mark.parametrize("flags,rc", [([], 0), (["-f", "2"], 1)],
                         ids=["strict: partition fallback", "-f 2: refused"])
def test_cli_union_refused_by_size(tmp_path, capsys, monkeypatch, flags, rc):
    """A union the single-device scan refuses by size takes the partition
    fallback where that reproduces the run (strict MUMs over >= 3 files:
    the files of 2 anchor partitions merged), and exits 1 with the
    refusal otherwise."""
    g = np.random.default_rng(3)
    base = g.choice(list("ACGT"), 3000)
    paths = []
    for i in range(6):
        d = base.copy()
        d[g.integers(0, d.size, 5)] = g.choice(list("ACGT"), 5)
        p = tmp_path / f"g{i}.fa"
        p.write_text(f">g{i}\n{''.join(d)}\n")
        paths.append(str(p))
    # below the union's bucket (0.75 x 2^16), above a partition's (2^15)
    monkeypatch.setattr(t_pfp, "ROW_LIMIT", 32768)
    out = str(tmp_path / "out")
    assert t_cli.main(paths + ["-o", out, "--device", "cpu"] + flags) == rc
    err = capsys.readouterr().err
    assert "Traceback" not in err
    if rc:
        assert "Error: row spaces past 2^31 need the block (wide) scan" in err
        return
    assert "need the block (wide) scan" in err and \
        "retrying as 2 MumemtoM partitions" in err
    ref = str(tmp_path / "ref")
    mumemtom.run_partitioned_files(paths, ref, num_partitions=2,
                                   anchor=True, device="cpu")
    for ext in (".mums", ".lengths"):
        a = open(ref + ext, "rb").read()
        assert a and open(out + ext, "rb").read() == a, ext


def test_build_pfp_refuses_text_past_int32():
    """A text whose ext would pass 2^31 - 1 bytes is refused before
    anything is copied (a zero-copy text of that length)."""
    text = np.broadcast_to(np.uint8(65), (2**31 - W - 1,))
    with pytest.raises(t_pfp.ScanSizeError, match="int32 phrase coordinates"):
        t_pfp.build_pfp(text, CPU, w=W)


def test_block_sort_releases_unsorted_blocks(monkeypatch):
    """The block sort drops each unsorted block as it sorts it, also while
    the caller holds the list: when the merge rounds start, no unsorted
    operand is alive (the scan's blocks would double on every card)."""
    nshards, B = 4, 64
    g = np.random.default_rng(2)
    blocks = [tuple(torch.from_numpy(g.integers(0, 9, B).astype(np.int32))
                    for _ in range(3)) for _ in range(nshards)]
    refs = [weakref.ref(op) for ops in blocks for op in ops]
    alive_at_merge = []
    real = t_pfp._sort_rows

    def sort_rows(ops, num_keys=2):
        if ops[0].shape[0] == 2 * B and not alive_at_merge:
            gc.collect()
            alive_at_merge.append(sum(r() is not None for r in refs))
        return real(ops, num_keys)
    monkeypatch.setattr(t_pfp, "_sort_rows", sort_rows)
    out = seqpfp._bitonic_block_sort(blocks, [CPU] * nshards)
    assert alive_at_merge == [0]
    keys = np.concatenate([(b[0].numpy().astype(np.int64) << 32)
                           + b[1].numpy() for b in out])
    assert (np.diff(keys) >= 0).all()
