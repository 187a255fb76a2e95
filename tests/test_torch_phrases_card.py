"""The phrase sort's kernels (kernels/phrases.py) on the card: each kernel
against its plain version, build_pfp on the card against the host's native
phrase sort (the sort the JAX package's build_pfp calls) at 1 and 8 Mbp,
with fingerprints cut to two bits too, the kernels' launch counts, no host
sort, engine.readbacks against the trace's device-to-host copies, and a
repeat family (thousands of distinct phrases sharing 200 bytes) ranked by
the tail kernel as Python's sort ranks it.
Every test here needs a CUDA card and skips without one; the CPU side is
tests/test_torch_phrases.py.

Tolerance: exact equality (integer fingerprints, counts, ranks).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mumemto_tpu_torch import bench, native, trace
from mumemto_tpu_torch.kernels import phrases
from mumemto_tpu_torch.ops import pfp as t_pfp

W, MOD = 10, 100


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _records(dev, seed=0, m=200_000, n=1 << 22):
    """Records over random bytes with long equal stretches: random spans,
    copies, proper prefixes, lengths 1 to 2000."""
    g = np.random.default_rng(seed)
    ext = g.integers(0, 256, n).astype(np.uint8)
    ext[1000:60000] = 0
    ext[100000:160000] = ext[200000:260000]
    st = g.integers(0, n - 3000, m)
    ln = g.integers(1, 2000, m)
    k = m // 4
    st[:k] = g.choice([1000, 100000, 200000], k)
    st[k:2 * k] = st[g.integers(0, k, k)]
    return (torch.from_numpy(ext).to(dev),
            torch.from_numpy(st.astype(np.int32)).to(dev),
            torch.from_numpy(ln.astype(np.int32)).to(dev))


def repeat_family(seed: int, g: int, prefix: int = 200, tail: int = 40):
    """Records (numpy ext, st, ln) of a repeat family: g copies of one
    `prefix`-byte stretch, each followed by its own `tail` bytes (of 0 to
    3, so tails share prefixes too); a fifth of the tails repeat others, a
    tenth of the records stop early (proper prefixes of others), and one
    record is the shared stretch alone. Past the refinement's rounds
    (SORT_ROUNDS x 7 < prefix bytes) the distinct ones form one tied
    group."""
    rng = np.random.default_rng(seed)
    head = rng.integers(0, 256, prefix).astype(np.uint8)
    tails = rng.integers(0, 4, (g, tail)).astype(np.uint8)
    k = g // 5
    tails[:k] = tails[rng.integers(k, g, k)]
    ext = np.concatenate([np.tile(head, (g, 1)), tails], axis=1).ravel()
    st = np.arange(g, dtype=np.int64) * (prefix + tail)
    ln = np.full(g, prefix + tail)
    short = rng.permutation(g)[:g // 10]
    ln[short] = prefix + rng.integers(1, tail, short.size)
    ln[0] = prefix
    return ext, st.astype(np.int32), ln.astype(np.int32)


def _launched(fn):
    before = dict(phrases.launches)
    out = fn()
    torch.cuda.synchronize()
    return out, {k: phrases.launches[k] - before[k] for k in before}


@pytest.mark.gpu
def test_fingerprint_and_verify_kernels_match_plain():
    dev = _card()
    ext, st, ln = _records(dev)
    fp, n = _launched(lambda: phrases.fingerprint(ext, st, ln))
    assert n["phrase_fingerprint"] == 1
    assert torch.equal(fp, phrases.fingerprint_plain(ext, st, ln))
    # sorted by (fingerprint, length): every record against its run head,
    # and against a record of its length before it
    order, _run, run_head = t_pfp.fingerprint_runs(fp, ln)
    assert int(phrases.verify(ext, st, ln, order, run_head)) == 0
    lens = ln[order]
    # a head for every record: itself or a record of its length before it
    first = torch.ones(order.numel(), dtype=torch.bool, device=dev)
    first[1:] = lens[1:] != lens[:-1]
    head = torch.where(first, order, torch.roll(order, 1))
    bad, n = _launched(lambda: phrases.verify(ext, st, ln, order, head))
    assert n["phrase_verify"] == 1
    assert int(bad) == int(phrases.verify_plain(ext, st, ln, order, head)) > 0
    assert int(phrases.verify(ext, st, ln, order, order)) == 0


@pytest.mark.gpu
def test_repeat_family_ranks_like_pythons_sort(monkeypatch):
    """6000 records of one repeat family: the sort on the card gives the
    dense ranks and smallest records of Python's sort of their bytes, the
    tail kernel ranks one group of thousands of members, once, and equals
    its plain version on it."""
    dev = _card()
    ext, st, ln = repeat_family(7, 6000)
    groups = []
    real_tail = phrases.tail_rank

    def spy(*a):
        want = a[7].clone()
        real_tail(*a)
        phrases.tail_rank_plain(*a[:7], want)
        groups.append((int((a[5][1:] - a[5][:-1]).max()),
                       torch.equal(a[7], want)))
    monkeypatch.setattr(phrases, "tail_rank", spy)
    (parse, phrase_st, phrase_ln), n = _launched(lambda: t_pfp.sort_phrases(
        *(torch.from_numpy(x).to(dev) for x in (ext, st, ln))))
    grp, rep = _host_ranks(ext, st, ln)
    assert np.array_equal(parse, grp + 1)
    assert np.array_equal(phrase_st[1:], st[rep])
    assert np.array_equal(phrase_ln[1:], ln[rep])
    assert n["phrase_tail_rank"] == 1 and len(groups) == 1
    largest, same = groups[0]
    assert same and largest > 4000


def _host_ranks(ext, st, ln):
    """(grp, rep) by Python's sort of the records' bytes: grp[r] the dense
    rank of record r's phrase, rep[g] the smallest record of phrase g."""
    keys = [ext[s:s + n].tobytes() for s, n in zip(st.tolist(), ln.tolist())]
    rank = {k: i for i, k in enumerate(sorted(set(keys)))}
    grp = np.array([rank[k] for k in keys], np.int32)
    rep = np.full(len(rank), -1, np.int32)
    for r in range(len(keys) - 1, -1, -1):
        rep[grp[r]] = r
    return grp, rep


@pytest.mark.gpu
def test_tail_kernel_matches_plain():
    """Groups of 1 to 300 records, ranked from depths 0 and 5."""
    dev = _card()
    ext, st, ln = _records(dev, seed=1, m=30_000)
    g = np.random.default_rng(2)
    sizes = g.integers(1, 300, 400)
    sizes = sizes[np.cumsum(sizes) <= st.numel()]
    members = int(sizes.sum())
    starts = torch.from_numpy(np.concatenate([[0], np.cumsum(sizes)])
                              .astype(np.int32)).to(dev)
    rec = torch.from_numpy(g.permutation(st.numel())[:members]
                           .astype(np.int32)).to(dev)
    active = torch.arange(members, dtype=torch.int32, device=dev)
    base = np.repeat(np.concatenate([[0], np.cumsum(sizes)[:-1]]), sizes)
    for d in (0, 5):
        ln_d = torch.clamp(ln, min=d + 1)  # every record has bytes at d
        got = torch.from_numpy(base.astype(np.int32)).to(dev)
        want = got.clone()
        _, n = _launched(lambda: phrases.tail_rank(
            ext, st, ln_d, rec, active, starts, d, got))
        assert n["phrase_tail_rank"] == 1
        phrases.tail_rank_plain(ext, st, ln_d, rec, active, starts, d, want)
        assert torch.equal(got, want)


def _native_fields(pfp):
    """parse, phrase_st, phrase_ln of the host path: the card's records,
    ranked by the native std::sort (native/mumemto_native.cc)."""
    nat = native.get_native()
    if nat is None or not hasattr(nat, "sort_phrases"):
        pytest.skip("the native extension did not build")
    ext = pfp.ext.cpu().numpy()
    breaks = t_pfp.compute_breaks(pfp.ext, pfp.n_text, W, MOD).cpu().numpy()
    st = np.concatenate([[0], breaks - W + 2]).astype(np.int32)
    en = np.concatenate([breaks + 1, [pfp.n_text + W]]).astype(np.int32)
    ln = en - st + 1
    order_b, grp_b = nat.sort_phrases(ext, st, ln)
    order = np.frombuffer(order_b, np.int32)
    grp = np.frombuffer(grp_b, np.int32)
    rep = order[np.concatenate([[True], grp[1:] != grp[:-1]])]
    parse = np.zeros(st.size, np.int32)
    parse[order] = grp + 1
    return (parse, np.concatenate([[0], st[rep]]).astype(np.int32),
            np.concatenate([[0], ln[rep]]).astype(np.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("mbp,fp_bits", [(1, 62), (8, 62), (1, 2)])
def test_build_pfp_on_the_card_equals_the_native_sort(mbp, fp_bits,
                                                      monkeypatch):
    """Every field, no host sort, the kernels launched once each (the tail
    at most once), and the fingerprint collisions counted."""
    dev = _card()
    rb = bench.rb_of(bench.synth_collection(mbp, 8, seed=mbp))
    if fp_bits < 62:
        real_fp = phrases.fingerprint
        monkeypatch.setattr(phrases, "fingerprint",
                            lambda *a: real_fp(*a) & ((1 << fp_bits) - 1))

    def no_host_sort():
        raise AssertionError("the host sort ran")
    monkeypatch.setattr(native, "get_native", no_host_sort)
    trace.disable()
    trace.drain()
    trace.enable()
    try:
        with trace.call("engine.find_matches"):
            got, n = _launched(lambda: t_pfp.build_pfp(rb.text, dev, W, MOD))
    finally:
        trace.disable()
    (counters,) = trace.drain()["counters"].values()
    monkeypatch.undo()
    want = _native_fields(got)
    for f, w in zip(("parse", "phrase_st", "phrase_ln"), want):
        assert np.array_equal(getattr(got, f), w), f
    assert got.num_phrases == want[1].size - 1 and got.m == want[0].size
    assert n["phrase_fingerprint"] == n["phrase_verify"] == 1
    assert n["phrase_tail_rank"] <= 1
    for k, c in n.items():
        assert counters.get(phrases.COUNTERS[k], 0) == c
    assert (counters[t_pfp.SORT_COLLISIONS] > 0) == (fp_bits < 62)
    assert 1 <= counters[t_pfp.SORT_ROUNDS_COUNTER] <= t_pfp.SORT_ROUNDS


_PROFILED = r"""
import json, sys
import torch
from torch.profiler import ProfilerActivity, profile
from mumemto_tpu_torch import bench, trace
from mumemto_tpu_torch.ops import pfp
dev = torch.device("cuda")
rb = bench.rb_of(bench.synth_collection(1, 8, seed=3))
pfp.build_pfp(rb.text, dev)  # loads the kernels
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    with trace.call("engine.find_matches"):
        pfp.build_pfp(rb.text, dev)
    torch.cuda.synchronize()
(counted,) = trace.drain()["counters"].values()
prof.export_chrome_trace(sys.argv[1])
events = json.load(open(sys.argv[1]))["traceEvents"]
d2h = [e for e in events if e.get("cat") == "gpu_memcpy"
       and "DtoH" in e.get("name", "")]
print(json.dumps([counted[trace.READBACKS], len(d2h)]))
"""


@pytest.mark.gpu
def test_build_pfp_readbacks_equal_the_trace_copies(tmp_path):
    """engine.readbacks of one build_pfp equals the device-to-host copies
    of its torch.profiler trace, in a process of its own (in a whole -m gpu
    run, the same check made in the test process has read two copies more
    than its trace, as tests/test_torch_trace.py's do; PERF.md §7)."""
    _card()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    done = subprocess.run(
        [sys.executable, "-c", _PROFILED, str(tmp_path / "trace.json")],
        cwd=root, capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-2000:]
    counted, copies = json.loads(done.stdout.strip().splitlines()[-1])
    assert counted == copies > 0
