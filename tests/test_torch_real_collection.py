"""chip_smoke.py's real-alphabet collection (_synth_collection_real: the
bench collection with assembly gaps as runs of N, and the IUPAC codes) and a
CPU rehearsal of the phase that drives it on the card.

The generator is held to its docstring: deterministic for a seed, the bench
collection's lengths, the forced gaps, the share of N, 9 and 19 distinct
bytes. native/baseline_cpu, which the phase trusts for its counts, is held
against the port's oracle.naive and the JAX package on a tiny such input.
The rehearsal runs phase_real's own code at 0.16 Mbp with stand-ins for
what only a card has: device "cuda" resolves to the CPU, torch.cuda's
synchronize and memory counters do nothing, and the KR wrapper counts a
launch around its plain version. Tolerance: none (counts and bytes).
"""

import importlib
import os
import sys

import numpy as np
import pytest
import torch

from mumemto_tpu import engine as jax_engine
from mumemto_tpu_torch import engine as t_engine
from mumemto_tpu_torch import options
from mumemto_tpu_torch.kernels import kr_mask
from mumemto_tpu_torch.oracle import naive
from mumemto_tpu_torch.parallel import mesh

# several test workers share the machine's cores
torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, ROOT)
    try:
        return importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(ROOT)


def _runs_of_n(doc):
    """(start, length) of every maximal run of N in a document."""
    is_n = np.concatenate([[False], doc == ord("N"), [False]])
    edges = np.flatnonzero(is_n[1:] != is_n[:-1])
    return list(zip(edges[::2].tolist(), (edges[1::2] - edges[::2]).tolist()))


@pytest.mark.parametrize("mbp,seed", [(8, 0), (1, 1), (0.16, 0)])
def test_real_collection_gaps(chip_smoke, mbp, seed):
    docs = chip_smoke._synth_collection_real(mbp, 8, seed=seed)
    again = chip_smoke._synth_collection_real(mbp, 8, seed=seed)
    plain = chip_smoke._synth_collection(mbp, 8, seed=seed)
    assert all(np.array_equal(a, b) for a, b in zip(docs, again))
    assert [d.size for d in docs] == [d.size for d in plain]
    n = docs[0].size
    clip = n // 10
    for i, (d, p) in enumerate(zip(docs, plain)):
        is_n = d == ord("N")
        # overwritten, never inserted: every other base is the bench's
        assert np.array_equal(d[~is_n], p[~is_n])
        runs = _runs_of_n(d)
        assert 1 <= len(runs) <= max(1, n // 250_000)
        # a run is one gap or several that touch; no gap passes the clip
        assert all(ln >= min(100, clip) for _s, ln in runs)
        assert sum(ln for _s, ln in runs) <= max(1, n // 250_000) * min(
            50_000, clip)
    assert max(ln for _s, ln in _runs_of_n(docs[0])) >= min(50_000, clip)
    assert docs[1][0] == ord("N")
    assert docs[2][-1] == ord("N")
    share = sum(int((d == ord("N")).sum()) for d in docs) / (8 * n)
    # the mean gap is 3810 bases per 250 kbp (1.5%); a draw of 32 gaps at 8
    # Mbp spreads around it, and below 500 kbp a document the clip and the
    # one gap every document gets set the share
    assert 0.005 < share < 0.06
    values = set(np.unique(np.concatenate(docs)).tolist())
    assert values == set(b"ACGTN")
    other = chip_smoke._synth_collection_real(mbp, 8, seed=seed + 1)
    assert not all(np.array_equal(a, b) for a, b in zip(docs, other))


@pytest.mark.parametrize("mbp,seed", [(8, 0), (1, 1), (0.16, 0)])
def test_real_collection_iupac(chip_smoke, mbp, seed):
    docs = chip_smoke._synth_collection_real(mbp, 8, seed=seed)
    coded = chip_smoke._synth_collection_real(mbp, 8, seed=seed, iupac=True)
    codes = np.frombuffer(chip_smoke.IUPAC_CODES, np.uint8)
    n_codes = 0
    for d, c in zip(docs, coded):
        diff = d != c
        # the gaps are the same; only single non-N bases became codes
        assert np.array_equal(d == ord("N"), c == ord("N"))
        assert np.isin(c[diff], codes).all() and diff.any()
        assert not np.isin(d, codes).any()
        n_codes += int(diff.sum())
    assert n_codes == 10 + 8 * max(1, round(docs[0].size * 1e-5))
    assert set(np.unique(np.concatenate(coded)).tolist()) == \
        set(b"ACGTN" + chip_smoke.IUPAC_CODES)
    # with the '$' and the parse's 0, 1, 2: 9 and 19 distinct bytes
    for rb, want in ((chip_smoke._rb_of(docs), 9),
                     (chip_smoke._rb_of(coded), 19)):
        assert len(set(np.unique(rb.text).tolist()) | {0, 1, 2}) == want
        assert rb.seq_lengths == [2 * (d.size + 1) for d in docs]


@pytest.mark.parametrize("iupac", [False, True])
@pytest.mark.parametrize("kw", [{}, {"rare_freq": 3, "max_mem_freq": 0}])
def test_baseline_cpu_agrees_with_oracle_on_gapped_input(chip_smoke, iupac,
                                                         kw):
    """The program phase_real's counts are held against, against the
    oracle, the port's CPU path and the JAX package, on 3 documents of 2
    kbp with a gap each."""
    docs = chip_smoke._synth_collection_real(0.006, 3, seed=5, iupac=iupac)
    rb = chip_smoke._rb_of(docs)
    opts = options.normalize(3, quiet=True, **kw)
    want = naive.oracle_output(rb, opts)
    _mbp_s, count = chip_smoke._run_cpu_baseline(rb.text, rb.seq_lengths,
                                                 opts, 0.006)
    assert count == want.count(b"\n") > 0
    assert t_engine.find_matches(rb, opts, device="cpu").output_bytes() == want
    assert jax_engine.find_matches(rb, opts, show_progress=False
                                   ).output_bytes() == want


class _NoCard:
    """torch.cuda's part in the phase, without a card."""

    def synchronize(self, *a):
        pass

    def reset_peak_memory_stats(self, *a):
        pass

    def max_memory_allocated(self, *a):
        return 0

    def device_count(self):
        return 1


class _TorchOnCpu:
    """torch, with _NoCard for torch.cuda."""
    cuda = _NoCard()

    def __getattr__(self, name):
        return getattr(torch, name)


def test_phase_real_rehearsal(chip_smoke, monkeypatch):
    """phase_real's rows a-g at 0.16 / 0.32 / 0.08 Mbp on the CPU: every
    count equal to a live baseline_cpu run, -g's and the sharded scan's
    bytes equal to the PFP rows', the variants asserted, the launches
    counted as on the card."""
    def on_cpu(device):
        return torch.device("cpu")

    def counted_plain(ext, n_real, w, mod):
        kr_mask.launches += 1
        return kr_mask.break_mask_plain(ext, n_real, w, mod)
    monkeypatch.setattr(t_engine, "resolve", on_cpu)
    monkeypatch.setattr(mesh, "resolve", on_cpu)
    monkeypatch.setattr(kr_mask, "break_mask", counted_plain)
    monkeypatch.setattr(kr_mask, "launches", 0)
    fake = _TorchOnCpu()
    opts = options.normalize(8, quiet=True)
    report = {"e2e": {}, "mem": {}}
    report["e2e"]["0.16mbp"], _ = chip_smoke._drive(
        fake, "acgt", chip_smoke._bench_rb(0.16), opts, 0.16)
    chip_smoke.phase_real(fake, report, mbp=0.16, mbp_big=0.32,
                          mbp_bytes=0.08)
    real = report["real"]
    rows = real["rows"]
    assert set(rows) == {"a", "b", "c", "d", "e", "e2", "f", "g"}
    assert real["kernel"]["mismatches"] == 0 and real["kernel"]["breaks"] > 0
    for key in "abcd":
        row = rows[key]
        assert row["matches"] == row["baseline_matches"] > 0
        assert row["launches"] == {"kr_break_mask": 2, "add_one": 0}
        assert row["seed_thr_is_none"]
        assert row["lcp_thr_is_none"] == (key == "d")
    acgt = report["e2e"]["0.16mbp"]
    assert rows["a"]["matches"] < acgt["matches"]
    assert rows["a"]["longest_phrase"] > 2000
    assert rows["a"]["alphabet"] == 9 and rows["d"]["alphabet"] == 19
    assert rows["c"]["matches"] > rows["a"]["matches"]
    for key, lcp in (("e", "plcp"), ("e2", "descent")):
        assert rows[key]["bytes_equal_pfp_row"]
        assert rows[key]["index"]["lcp"] == lcp
        assert not any(rows[key]["launches"].values())
    assert rows["e2"]["index"]["exits_early"]
    assert not rows["e"]["index"]["exits_early"]
    assert rows["f"]["bytes_equal_single_device"]
    assert rows["f"]["launches"] == {"kr_break_mask": 1, "add_one": 0}
    assert "packed <=8-byte alphabet" in rows["f"]["shard_dict_refused"]
    assert len(rows["g"]) == 8 and all(
        all(sizes.values()) for sizes in rows["g"].values())
    # every driven path is in the launch record, PFP paths with launches
    assert len(real["paths"]) == 7
    assert sum(p["kr_break_mask"] for p in real["paths"].values()) == 9
