"""The dictionary doubling bounded by the phrase separators
(ops/suffix._bounded_rounds), on collections with assembly gaps.

The benchmark's gapped configuration (mumbench/configs/
human20x6.6mbp-gapped.json) runs synth_collection_real: the bench
collection with runs of N written over it, and with iupac the ten IUPAC
codes. Here, at 20-60 kbp a document:

- the port's match set equals the benchmark's plain reference
  (mumbench/reference.py, loaded by its path, as the harness loads it)
  under the mixes mum, partial_k1 and mem_f3;
- the bounded index keeps d, grp_of_pos and grp_cross equal to the JAX
  package's, isaD and lcpD in the form their consumers read
  (torch_dict_form.dict_consumer_form), saD equal to the unbounded doubling's
  outside the zero pad, and the parse side's isaP and s_lcp_T exact; the
  .mems bytes (-f 3) equal the JAX package's, on ACGT, ACGTN and IUPAC
  inputs (the MUM mixes are held to the reference above, and to the JAX
  package in test_torch_alphabet.py and test_torch_engine.py);
- the counter pfp.dict.sort_rows equals the host's count (_dict_live) and,
  with one long gap, stays below what the unbounded rounds sort.

Tolerance: none.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from mumemto_tpu import engine as jax_engine
from mumemto_tpu import options as jax_options
from mumemto_tpu.ops import pfp as jax_pfp
from mumemto_tpu_torch import convert, engine, options, trace
from mumemto_tpu_torch.bench import rb_of
from mumemto_tpu_torch.ops import pfp as t_pfp
from mumemto_tpu_torch.ops import suffix as t_suffix
from conftest import build
from torch_dict_form import dict_consumer_form

# several test workers share the machine's cores
torch.set_num_threads(2)

CPU = torch.device("cpu")
BENCH_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "mumbench")
MIXES = {"mum": dict(num_distinct_docs=0, rare_freq=1, max_mem_freq=0),
         "partial_k1": dict(num_distinct_docs=-1, rare_freq=1,
                            max_mem_freq=0),
         "mem_f3": dict(num_distinct_docs=0, rare_freq=3, max_mem_freq=0)}


def _load(name):
    spec = importlib.util.spec_from_file_location(
        "mumbench_" + name, os.path.join(BENCH_DIR, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def bench():
    """The harness (its generator loader, output parser and comparison)
    and the plain reference."""
    return _load("run"), _load("reference")


def _docs(bench, kind, n_docs, kbp, seed):
    """A collection of the gapped configuration's generator ("acgtn", or
    "iupac" with the codes) or of the ACGT one, as uint8 arrays."""
    run, _ref = bench
    gen = "synth_collection" if kind == "acgt" else "synth_collection_real"
    return run.generate({"generator": gen, "total_mbp": n_docs * kbp / 1e3,
                         "n_docs": n_docs, "snp_rate": 0.001,
                         "iupac": kind == "iupac"}, seed)


@pytest.mark.parametrize("mix", sorted(MIXES))
@pytest.mark.parametrize("kind,n_docs,kbp", [("acgtn", 4, 50),
                                             ("iupac", 10, 20)])
def test_port_equals_the_plain_reference(bench, kind, n_docs, kbp, mix):
    run, reference = bench
    docs = _docs(bench, kind, n_docs, kbp, seed=2**33 + n_docs)
    assert any((d == ord("N")).any() for d in docs)
    kw = MIXES[mix]
    opts = options.normalize(n_docs, quiet=True, min_match_len=20, **kw)
    got = engine.find_matches(rb_of(docs), opts, device=CPU,
                              show_progress=False)
    want = reference.match_set(docs, min_len=20, k=kw["num_distinct_docs"],
                               f=kw["rare_freq"], F=kw["max_mem_freq"])
    assert len(want) > 10
    assert run.mismatches(run.parse_output(got.output_bytes(),
                                           opts.mum_mode), want) == 0


@pytest.mark.parametrize("kind", ["acgt", "acgtn", "iupac"])
def test_bounded_index_equals_the_jax_package(bench, kind):
    docs = _docs(bench, kind, 4, 15, seed=11)
    rb = build([[bytes(d).decode()] for d in docs])
    pj = jax_pfp.build_pfp(rb.text, w=10, mod=100)
    hj = jax_pfp._host_prep(pj, rb.doc_ends, rb.num_docs)
    ht = t_pfp._host_prep(convert.from_jax_pfp(pj, CPU), rb.doc_ends)
    arrays, static = convert.from_jax_dict_args(pj, hj, CPU)
    dj = convert.dict_tables_to_numpy(jax_pfp._dict_index(
        pj.ext, hj["phrase_st"], hj["phrase_ln"], hj["d_starts"],
        hj["npz"], hj["total_real"], *static))
    dt = t_pfp._dict_index(*arrays, *static, live=ht["dict_live"])
    d_t, lcp_t, isa_t, gp_t, gc_t = convert.dict_tables_to_numpy(dt)
    assert np.array_equal(d_t, dj[0])
    assert np.array_equal(gp_t, dj[3])
    assert np.array_equal(gc_t, dj[4])
    total = ht["total_real"]
    keys_t, cross_t = dict_consumer_form(d_t, isa_t, lcp_t, total)
    keys_j, cross_j = dict_consumer_form(dj[0], dj[2], dj[1], total)
    assert keys_t == keys_j
    assert np.array_equal(cross_t, cross_j)
    # saD: the unbounded doubling's order on every row outside the pad
    nd = ht["nd"]
    sa_u, _hist, _lvl = t_suffix._suffix_array_impl(
        dt[0], nd, packed_init=True, max_lvl=ht["lvl_cap"],
        alpha_thresholds=ht["seed_thr"])
    sa_t = np.empty(nd, np.int64)
    sa_t[isa_t] = np.arange(nd)
    assert np.array_equal(sa_u.numpy()[nd - total:], sa_t[nd - total:])
    # the parse side on each package's own index: exact
    isaP_j, tab_j = jax_pfp._parse_side(hj["parse"], hj["cumC"],
                                        hj["d_starts"], dj[1], dj[2],
                                        hj["mp"], hj["nd"])
    isaP_t, tab_t = t_pfp._parse_side(ht["parse"], ht["cumC"],
                                      ht["d_starts"], dt[1], dt[2],
                                      ht["mp"])
    assert np.array_equal(isaP_t.numpy(), np.asarray(isaP_j))
    assert len(tab_t) == len(tab_j)
    for a, b in zip(tab_t, tab_j):
        assert np.array_equal(a.numpy(), np.asarray(b))
    # the output bytes
    trb = rb_of(docs)
    assert np.array_equal(trb.text, rb.text)
    kw = MIXES["mem_f3"]
    want = jax_engine.find_matches(rb, jax_options.normalize(
        rb.num_docs, quiet=True, **kw)).output_bytes()
    got = engine.find_matches(trb, options.normalize(
        rb.num_docs, quiet=True, **kw), device=CPU,
        show_progress=False).output_bytes()
    assert got == want != b""


def _sort_rows(docs):
    """(the counter over one _dict_index, the host's count, the unbounded
    rounds' rows, the prep) for a collection, on the port alone."""
    pfp = t_pfp.build_pfp(rb_of(docs).text, CPU)
    h = t_pfp._host_prep(pfp, rb_of(docs).doc_ends)
    trace.enable()
    try:
        t_pfp._dict_index(
            pfp.ext, h["phrase_st"], h["phrase_ln"], h["d_starts"],
            h["npz"], h["total_real"], h["nd"], h["ne"], h["w"],
            h["lvl_cap"], h["lvl_static"], h["seed_thr"], h["lcp_thr"],
            live=h["dict_live"])
        counted = trace.totals()
    finally:
        trace.disable()
        trace.drain()
    nd = h["nd"]
    L = min(t_suffix._num_levels(nd), h["lvl_cap"])
    start = 4 if h["seed_thr"] is not None else 3
    host = nd + sum(h["dict_live"][start:L + 1])
    return counted, host, (L - start + 2) * nd, h


@pytest.mark.parametrize("kind", ["acgt", "acgtn"])
def test_sort_rows_counter(bench, kind):
    docs = _docs(bench, kind, 4, 40, seed=5)
    if kind == "acgtn":
        # one long gap: a phrase of 20 000 characters sets the depth
        docs[1][5000:25000] = ord("N")
    counted, host, unbounded, h = _sort_rows(docs)
    assert counted[trace.DICT_SORT_ROWS] == host
    assert host < unbounded
    if kind == "acgtn":
        assert h["lvl_cap"] >= 15 and host < unbounded // 2
        # the rank descent: every level from lvl_static - 1 to 3 and the
        # packed bottom, each over every row
        top = min(h["lvl_static"] - 1, min(t_suffix._num_levels(h["nd"]),
                                           h["lvl_cap"]))
        assert counted[trace.DICT_DESCENT_ROWS] == (top - 1) * h["nd"]
    else:
        assert counted[trace.DICT_DESCENT_ROWS] < h["nd"]


def _live_and_rem(bench, kind, via):
    """(the live counts, the device's remaining lengths, the rounds run)
    for a collection: from the port's own host prep, or from the JAX
    package's prepare carried over by convert.from_jax_prepare."""
    docs = _docs(bench, kind, 4, 15, seed=13)
    if via == "port":
        pfp = t_pfp.build_pfp(rb_of(docs).text, CPU)
        h = t_pfp._host_prep(pfp, rb_of(docs).doc_ends)
        live = h["dict_live"]
        arrays = (pfp.ext, h["phrase_st"], h["phrase_ln"], h["d_starts"],
                  h["npz"], h["total_real"])
    else:
        rb = build([[bytes(d).decode()] for d in docs])
        pj = jax_pfp.build_pfp(rb.text, w=10, mod=100)
        h = jax_pfp.pfp_scan_prepare(pj, rb.doc_ends, rb.num_docs)
        live = convert.from_jax_prepare(h, CPU)["dict_live"]
        arrays, _static = convert.from_jax_dict_args(pj, h, CPU)
    nd, lvl_cap = int(h["nd"]), int(h["lvl_cap"])
    rem = t_pfp._dict_setup(*arrays, nd, int(h["ne"]))[2]
    return live, rem, min(t_suffix._num_levels(nd), lvl_cap)


@pytest.mark.parametrize("via", ["port", "from_jax_prepare"])
@pytest.mark.parametrize("kind", ["acgt", "acgtn", "iupac"])
def test_live_counts_equal_the_device_mask(bench, kind, via):
    """Each round's host count (_dict_live) equals the rows the device's
    mask keeps, rem + 1 >= 2^(l-1), counted here on the CPU: the bounded
    rounds trust the count to size their compaction."""
    live, rem, rounds = _live_and_rem(bench, kind, via)
    assert len(live) >= rounds + 1
    for lvl in range(2, rounds + 1):
        assert int((rem + 1 >= 1 << (lvl - 1)).sum()) == live[lvl], lvl
    assert live[3] > 0


def test_compact_refuses_a_count_that_disagrees(rng):
    """_compact sizes its output from the host's count; a count the mask
    does not give stops it, above or below."""
    keep = torch.from_numpy(rng.random(100) < 0.4)
    values = torch.arange(100, dtype=torch.int32)
    k = int(keep.sum())
    assert torch.equal(t_suffix._compact(values, keep, k), values[keep])
    for wrong in (k - 1, k + 1):
        with pytest.raises(RuntimeError):
            t_suffix._compact(values, keep, wrong)
