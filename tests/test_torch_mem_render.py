"""The .mems text writer (kernels/mem_render and engine._emit_mems): the
numpy twin against a per-match loop transcription of write_mem
(mem_finder.hpp:210-263) on randomized windows, both the lines and the
records; values at decimal digit boundaries, negative '-'-strand
positions, two-digit document ids, windows from 2 to 300 wide; the render
called once per MEM call with matches. On the card: the kernel's buffer
against the twin's, byte for byte, find_matches on cuda against cpu for
-f 3, -f 0 and -F 5, and the launch counter.

Tolerance: byte equality and exact integer arrays.
"""

import numpy as np
import pytest
import torch

from mumemto_tpu_torch import bench, engine, formats, options, trace
from mumemto_tpu_torch.kernels import mem_render
from mumemto_tpu_torch.refbuilder import build_from_sequences

# several test workers share the machine's cores
torch.set_num_threads(2)

# magnitudes at decimal boundaries, past 2^32 and near int64's last digit
EDGES = [0, 1, 9, 10, 11, 99, 100, 101, 999, 1000, 10**9 - 1, 10**9,
         10**9 + 1, 2**31 - 1, 2**31, 2**32 - 1, 2**32, 2**32 + 1,
         10**12, 10**18 - 1, 10**18, 2**62]


def loop_mem_lines(L, w_sa, w_da, valid, opts, doc_offsets, doc_lens):
    """The lines and records of write_mem, one match at a time (the
    engine's loop before it was vectorized, tests/test_emit_vectorized.py's
    oracle on the port's formats)."""
    lines, records = [], []
    for i in range(len(L)):
        k = int(valid[i].sum())
        length = int(L[i])
        pos, docs, strands, negs = [], [], [], []
        for j in range(k):
            d = int(w_da[i, j])
            dd = min(d, len(doc_lens) - 1)
            p = int(w_sa[i, j]) - int(doc_offsets[dd])
            dl = int(doc_lens[dd])
            neg = opts.use_revcomp and p >= dl
            if neg:  # the last occurrence drops the -1 (:248)
                p = 2 * dl - p - length - (0 if j == k - 1 else 1)
            pos.append(p)
            docs.append(d)
            strands.append("-" if neg else "+")
            negs.append(neg)
        lines.append(formats.format_mem_line(length, pos, docs, strands))
        records.append((length, pos, docs, [not n for n in negs]))
    return lines, records


def synth_windows(rng, m, num_docs, W, revcomp):
    """(L, w_sa, w_da, valid, doc_offsets, doc_lens) of m rows of width W:
    1 to W occurrences a row (a prefix of the row, W itself in one row),
    documents of 2^40 to 2^41 bases, positions and lengths drawn from
    EDGES (up to 10^12) and at random on both strands, some '-' positions
    past the document's end (printed negative), pad columns holding doc id
    num_docs."""
    doc_lens = rng.integers(2**40, 2**41, num_docs).astype(np.int64)
    span = 2 * doc_lens if revcomp else doc_lens
    doc_offsets = np.concatenate([[0], np.cumsum(span)[:-1]]).astype(np.int64)
    nv = rng.integers(1, W + 1, m)
    nv[0] = W
    valid = np.arange(W) < nv[:, None]
    L = rng.choice(np.array(EDGES[1:12] + [20, 55, 300], np.int64), m)
    w_da = rng.integers(0, num_docs, (m, W)).astype(np.int32)
    w_da[~valid] = num_docs
    dd = np.minimum(w_da, num_docs - 1)
    dl = doc_lens[dd]
    edge = np.array(EDGES[:EDGES.index(10**12) + 1], np.int64)
    fwd = np.where(rng.random((m, W)) < 0.5, rng.choice(edge, (m, W)),
                   rng.integers(0, 2**33, (m, W))) % dl
    pos = fwd
    if revcomp:
        # a '-' occurrence whose printed position is an edge: p such that
        # 2 dl - p - L - 1 = target, kept inside the reverse strand
        target = rng.choice(edge, (m, W)) % (dl - L[:, None] - 2)
        rev = 2 * dl - target - L[:, None] - 1
        rev = np.where(rng.random((m, W)) < 0.1, 2 * dl - 1, rev)
        pos = np.where(rng.random((m, W)) < 0.5, rev, fwd)
    w_sa = doc_offsets[dd] + pos
    return L, w_sa, w_da, valid, doc_offsets, doc_lens


def _emitted(L, w_sa, w_da, valid, opts, doc_offsets, doc_lens):
    res = engine.MatchResults(opts=opts, num_docs=len(doc_lens))
    m = len(L)
    engine._emit_mems(res, np.zeros(m), np.zeros(m), L, w_sa, w_da, valid,
                      opts, doc_offsets, doc_lens)
    return res


@pytest.mark.parametrize("W", [2, 17, 300])
@pytest.mark.parametrize("num_docs", [2, 9, 10, 12])
@pytest.mark.parametrize("revcomp", [True, False])
def test_twin_equals_the_loop(revcomp, num_docs, W):
    rng = np.random.default_rng(1000 * num_docs + W + revcomp)
    m = 40 if W == 300 else 150
    args = synth_windows(rng, m, num_docs, W, revcomp)
    opts = options.normalize(num_docs, rare_freq=3, use_revcomp=revcomp,
                             quiet=True)
    res = _emitted(*args[:4], opts, *args[4:])
    lines, records = loop_mem_lines(*args[:4], opts, *args[4:])
    assert res.mem_lines == lines
    assert res.num_matches == m
    got = [(length, p.tolist(), d.tolist(), s.tolist())
           for length, p, d, s in res.mem_records]
    assert got == records
    printed = np.concatenate([np.asarray(p) for _, p, _, _ in records])
    assert (printed > 2**32).any() and (printed == 0).any()
    assert (printed < 0).any() == revcomp  # '-' past the document's end


@pytest.mark.parametrize("values", [EDGES, [-x for x in EDGES[1:]],
                                    list(range(-120, 121))])
def test_render_plain_writes_python_decimals(values):
    """One row a value: the length, one occurrence at the value, doc id
    the value's magnitude mod 1000; the text is Python's str()."""
    v = np.array(values, np.int64)
    m = v.size
    L = np.abs(v) + 1
    tpos = v[:, None]
    docs = (np.abs(v) % 1000).astype(np.int32)[:, None]
    neg = (v < 0)[:, None]
    nv = np.ones(m, np.int64)
    t = [torch.from_numpy(a) for a in (L, tpos, docs, neg)]
    lengths = mem_render.line_lengths(*t[:3], torch.ones(m, 1, dtype=bool))
    line_off = np.concatenate([[0], np.cumsum(lengths.numpy())])
    got = mem_render.render_plain(L, tpos, docs, neg, nv, line_off)
    want = b"".join(formats.format_mem_line(
        int(a), [int(b)], [int(c)], ["-" if b < 0 else "+"])
        for a, b, c in zip(L, v, docs[:, 0]))
    assert got.tobytes() == want


def test_widths_are_the_decimal_lengths():
    x = np.array(EDGES + [-e for e in EDGES] + [2**63 - 1, -2**63 + 1],
                 np.int64)
    got = mem_render.widths(torch.from_numpy(x)).tolist()
    assert got == [len(str(int(a))) for a in x]


def _rb(seed=7, n_docs=4, base_len=900):
    rng = np.random.default_rng(seed)
    base = "".join(rng.choice(list("ACGT"), base_len))
    rep = "".join(rng.choice(list("ACGT"), 40))
    docs = []
    for _ in range(n_docs):
        s = list(base)
        for _ in range(6):
            s[int(rng.integers(0, len(s)))] = str(rng.choice(list("ACGT")))
        s = "".join(s)
        docs.append([s[:300] + rep + s[300:600] + rep + s[600:]])
    return build_from_sequences(docs, use_revcomp=True)


# (options, render calls a find_matches call makes)
CALLS = {"mem -f 3": ({"rare_freq": 3}, 1),
         "mem -f 0 -F 5": ({"rare_freq": 0, "max_mem_freq": 5}, 1),
         "mum": ({}, 0),
         "mem, none": ({"rare_freq": 3, "min_match_len": 2000}, 0)}


@pytest.mark.parametrize("case", list(CALLS))
def test_one_render_per_mem_call_with_matches(case, monkeypatch):
    """engine.find_matches on the CPU renders once when it has MEM
    matches (the call the kernel takes on a card), never in MUM mode."""
    kw, want = CALLS[case]
    real = mem_render.render
    calls = []

    def spy(*a):
        calls.append(a[1].shape)
        return real(*a)
    monkeypatch.setattr(mem_render, "render", spy)
    rb = _rb()
    res = engine.find_matches(rb, options.normalize(rb.num_docs, quiet=True,
                                                    **kw), device="cpu")
    assert len(calls) == want
    assert (res.num_matches > 0) == (case != "mem, none")


# --- on the card -----------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("W", [2, 33, 300])
@pytest.mark.parametrize("num_docs", [2, 12])
@pytest.mark.parametrize("revcomp", [True, False])
def test_kernel_equals_the_twin(revcomp, num_docs, W):
    dev = _card()
    rng = np.random.default_rng(W + num_docs)
    m = 300 if W == 300 else 3000
    L, w_sa, w_da, valid, doc_offsets, doc_lens = synth_windows(
        rng, m, num_docs, W, revcomp)
    opts = options.normalize(num_docs, rare_freq=3, use_revcomp=revcomp,
                             quiet=True)
    want = _emitted(L, w_sa, w_da, valid, opts, doc_offsets, doc_lens)
    res = engine.MatchResults(opts=opts, num_docs=num_docs)
    on = [torch.from_numpy(a).to(dev) for a in (L, w_sa, w_da, valid)]
    _, _s, launches = bench.counted(torch, lambda: engine._emit_mems(
        res, on[0], on[0], *on, opts, doc_offsets, doc_lens))
    assert launches["mem_render"] == 1
    assert res.mem_lines == want.mem_lines
    for a, b in zip(res.mem_records, want.mem_records):
        assert a[0] == b[0] and all(np.array_equal(x, y)
                                    for x, y in zip(a[1:], b[1:]))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["-f 3", "-f 0", "-F 5"])
def test_cuda_output_equals_cpu(case):
    _card()
    kw = {"-f 3": {"rare_freq": 3}, "-f 0": {"rare_freq": 0,
                                             "max_mem_freq": 0},
          "-F 5": {"rare_freq": 0, "max_mem_freq": 5,
                   "num_distinct_docs": 3}}[case]
    rb = _rb(n_docs=6, base_len=3000)
    opts = options.normalize(rb.num_docs, quiet=True, **kw)
    got = engine.find_matches(rb, opts, device="cuda")
    want = engine.find_matches(rb, opts, device="cpu")
    assert got.num_matches > 0
    assert got.output_bytes() == want.output_bytes()


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CALLS))
def test_kernel_launches_once_per_mem_call_with_matches(case):
    _card()
    kw, want = CALLS[case]
    rb = _rb()
    opts = options.normalize(rb.num_docs, quiet=True, **kw)
    engine.find_matches(rb, opts, device="cuda")  # loads the kernels
    res, _s, launches = bench.counted(
        torch, lambda: engine.find_matches(rb, opts, device="cuda"))
    assert launches["mem_render"] == want
    assert (res.num_matches > 0) == (case != "mem, none")
    trace.drain()
