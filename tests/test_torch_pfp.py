"""ops/pfp port against mumemto_tpu.ops.pfp, stage by stage.

One parse (the JAX package's build_pfp) is carried into the port with
convert.from_jax_pfp, and each stage's outputs are compared. Tolerance:
exact equality for every integer table, with one exception: the
dictionary's doubling stops where its consumers stop reading, at each
suffix's phrase separator in the port (ops/suffix._bounded_rounds) and at
2^lvl_cap characters in the JAX package, so isaD and lcpD are compared in
the form the consumers read them (torch_dict_form.dict_consumer_form): the
order through each separator, and every LCP between suffixes that differ
before it. Everything downstream (groups, s_lcp_T, the row stream and the
interval analysis) is exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mumemto_tpu.ops import pfp as jax_pfp
from mumemto_tpu_torch import convert
from mumemto_tpu_torch.ops import pfp as t_pfp
from conftest import build, mutated_collection, rand_seq
from torch_dict_form import dict_consumer_form
from test_torch_suffix import with_n

# several test workers share the machine's cores
torch.set_num_threads(2)

CPU = torch.device("cpu")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eq(a, b):
    return np.array_equal(_np(a), _np(b))


def _collection(rng, variant):
    rep = rand_seq(rng, 50)
    docs = mutated_collection(rng, 4, base_len=600, insert_rep=rep)
    return build(with_n(docs, rng) if variant == "with_n" else docs)


@pytest.fixture(params=["acgt", "with_n"])
def staged(request, rng):
    """Both packages' state after each stage, for one collection."""
    rb = _collection(rng, request.param)
    pj = jax_pfp.build_pfp(rb.text, w=10, mod=100)
    pt = convert.from_jax_pfp(pj, CPU)
    hj = jax_pfp._host_prep(pj, rb.doc_ends, rb.num_docs)
    ht = t_pfp._host_prep(pt, rb.doc_ends)
    return request.param, rb, pj, pt, hj, ht


def test_build_pfp_fields(rng):
    for variant in ("acgt", "with_n"):
        rb = _collection(rng, variant)
        pj = jax_pfp.build_pfp(rb.text, w=10, mod=100)
        pt = t_pfp.build_pfp(rb.text, CPU, w=10, mod=100)
        for f in ("w", "n_text", "m", "num_phrases", "d_len", "alpha"):
            assert getattr(pt, f) == getattr(pj, f), f
        for f in ("ext", "parse", "phrase_st", "phrase_ln"):
            assert _eq(getattr(pt, f), getattr(pj, f)), f
        assert (ord("N") in pt.alpha) == (variant == "with_n")


def _dict_index_both(hj, ht, pj, pt):
    dj = jax_pfp._dict_index(
        pj.ext, hj["phrase_st"], hj["phrase_ln"], hj["d_starts"], hj["npz"],
        hj["total_real"], hj["nd"], hj["ne"], hj["w"], hj["lvl_cap"],
        hj["lvl_static"], hj["seed_thr"], hj["lcp_thr"])
    dt = t_pfp._dict_index(
        pt.ext, ht["phrase_st"], ht["phrase_ln"], ht["d_starts"], ht["npz"],
        ht["total_real"], ht["nd"], ht["ne"], ht["w"], ht["lvl_cap"],
        ht["lvl_static"], ht["seed_thr"], ht["lcp_thr"], ht["dict_live"])
    return dj, dt


def test_host_prep_and_dict_index(staged):
    variant, _rb, pj, pt, hj, ht = staged
    for key in ("nd", "nr", "mp", "w", "lvl_cap", "lvl_static", "seed_thr",
                "lcp_thr", "ne"):
        assert ht[key] == hj[key], key
    for key in ("phrase_st", "phrase_ln", "d_starts", "parse", "cumC",
                "cumcnt", "doc_ends"):
        assert _eq(ht[key], hj[key]), key
    assert (hj["seed_thr"] is None) == (variant == "with_n")

    (d_j, lcp_j, isa_j, gp_j, gc_j), (d_t, lcp_t, isa_t, gp_t, gc_t) = \
        _dict_index_both(hj, ht, pj, pt)
    # exact: the dictionary string and the group tables
    assert _eq(d_t, d_j)
    assert _eq(gp_t, gp_j)
    assert _eq(gc_t, gc_j)
    # isaD and lcpD as the consumers read them (see the module docstring)
    total = hj["total_real"]
    keys_j, cross_j = dict_consumer_form(d_j, isa_j, lcp_j, total)
    keys_t, cross_t = dict_consumer_form(d_t, isa_t, lcp_t, total)
    assert keys_t == keys_j
    assert (cross_t == cross_j).all()
    assert (cross_t >= 0).sum() > hj["nd"] // 4


def test_parse_side(staged):
    _variant, _rb, pj, pt, hj, ht = staged
    dj, dt = _dict_index_both(hj, ht, pj, pt)
    isaP_j, tab_j = jax_pfp._parse_side(hj["parse"], hj["cumC"],
                                        hj["d_starts"], dj[1], dj[2],
                                        hj["mp"], hj["nd"])
    # each port stage on its own upstream outputs: isaP and the s_lcp_T
    # range-min table are exact despite the dictionary's tie order
    isaP_t, tab_t = t_pfp._parse_side(ht["parse"], ht["cumC"],
                                      ht["d_starts"], dt[1], dt[2],
                                      ht["mp"])
    assert _eq(isaP_t, isaP_j)
    assert len(tab_t) == len(tab_j)
    for a, b in zip(tab_t, tab_j):
        assert _eq(a, b)


def test_expand_and_analyze(staged):
    _variant, rb, pj, pt, hj, ht = staged
    dj, dt = _dict_index_both(hj, ht, pj, pt)
    isaP_j, tab_j = jax_pfp._parse_side(hj["parse"], hj["cumC"],
                                        hj["d_starts"], dj[1], dj[2],
                                        hj["mp"], hj["nd"])
    isaP_t, tab_t = t_pfp._parse_side(ht["parse"], ht["cumC"],
                                      ht["d_starts"], dt[1], dt[2],
                                      ht["mp"])
    n = rb.num_docs
    cap = 1 << max(n.bit_length(), 2)
    for k in (n, 2):
        res_j, counts_j = jax_pfp._expand_and_analyze(
            hj["parse"], hj["d_starts"], hj["cumcnt"], hj["m"],
            hj["total_rows"], hj["n_text"], isaP_j, dj[3], dj[0], tab_j,
            dj[4], hj["doc_ends"], hj["nr"], hj["nd"], hj["w"], n,
            hj["lvl_cap"], jnp.int32(20), jnp.int32(k), jnp.int32(n), 1,
            cap, False)
        res_t, counts_t = t_pfp._expand_and_analyze(
            ht["parse"], ht["d_starts"], ht["cumcnt"], ht["m"],
            ht["total_rows"], ht["n_text"], isaP_t, dt[3], dt[0], tab_t,
            dt[4], ht["doc_ends"], ht["nr"], ht["nd"], ht["w"], n, 20, k,
            n, 1, cap)
        assert _eq(counts_t, counts_j)
        assert int(counts_t[0]) > 0
        for key in ("cand", "emit", "s", "e", "L", "prev_same", "da", "lcp",
                    "bwt", "sa"):
            assert _eq(res_t[key], res_j[key]), key


@pytest.mark.parametrize("n", [1, 2, 33, 5000])
def test_segmented_min_after_valid(rng, n):
    """The running min of lcp that restarts after each valid row, on every
    row (consumers read the valid ones), against a loop."""
    lcp = rng.integers(0, 2**31 - 1, n).astype(np.int32)
    lcp[rng.random(n) < 0.3] = 0
    valid = rng.random(n) < 0.2
    want = np.empty(n, np.int64)
    for i in range(n):
        want[i] = lcp[i] if i == 0 or valid[i - 1] else min(want[i - 1],
                                                             lcp[i])
    got = t_pfp._segmented_min_after_valid(torch.from_numpy(lcp),
                                           torch.from_numpy(valid))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("path", ["flat", "by level"])
def test_rmq_query_matches_and_guards(rng, monkeypatch, path):
    """Random ranges against a plain min, on the flat copy's path and, with
    the bound lowered to the table's size, the level-by-level path (which
    makes no copy of the table)."""
    v = rng.integers(0, 1000, 500).astype(np.int32)
    lo = rng.integers(0, 500, 300).astype(np.int32)
    hi = np.minimum(lo + rng.integers(0, 200, 300), 499).astype(np.int32)
    tab_t = t_pfp.ops_intervals._sparse_min_table(torch.from_numpy(v))
    if path == "by level":
        monkeypatch.setattr(t_pfp, "RMQ_FLAT_LIMIT", 500 * len(tab_t))

        def no_copy(*a, **kw):
            raise AssertionError("the table was copied")
        monkeypatch.setattr(torch, "cat", no_copy)
    got = t_pfp._rmq_query(tab_t, torch.from_numpy(lo), torch.from_numpy(hi))
    want = np.array([v[a:b + 1].min() for a, b in zip(lo, hi)])
    assert got.dtype == torch.int32
    assert (got.numpy() == want).all()


@pytest.mark.parametrize("variant", ["acgt", "with_n"])
def test_parse_files_match_jax(rng, tmp_path, variant):
    """-P's .dict/.parse bytes, and every PFPData field -p rebuilds from
    them, equal the JAX package's."""
    rb = _collection(rng, variant)
    jax_pfp.write_parse_files(rb, str(tmp_path / "jax"), w=10, mod=100)
    t_pfp.write_parse_files(rb, str(tmp_path / "torch"), CPU, w=10, mod=100)
    for ext in (".dict", ".parse"):
        want = (tmp_path / ("jax" + ext)).read_bytes()
        assert want and (tmp_path / ("torch" + ext)).read_bytes() == want
    pj = jax_pfp.pfp_from_parse_files(str(tmp_path / "jax"), w=10)
    pt = t_pfp.pfp_from_parse_files(str(tmp_path / "torch"), CPU, w=10)
    for f in ("w", "n_text", "m", "num_phrases", "d_len", "alpha"):
        assert getattr(pt, f) == getattr(pj, f), f
    for f in ("ext", "parse", "phrase_st", "phrase_ln"):
        assert _eq(getattr(pt, f), getattr(pj, f)), f
    assert pt.ext.device == CPU
    assert pt.n_text == rb.text.size
    body, starts, lens, parse = t_pfp.read_parse_files(str(tmp_path / "torch"))
    for a, b in zip((body, starts, lens, parse),
                    jax_pfp.read_parse_files(str(tmp_path / "jax"))):
        assert _eq(a, b)


def test_parse_files_refuse_bad_input(rng, tmp_path):
    rb = _collection(rng, "acgt")
    pre = str(tmp_path / "ck")
    t_pfp.write_parse_files(rb, pre, CPU)
    d = (tmp_path / "ck.dict").read_bytes()
    (tmp_path / "ck.dict").write_bytes(d[:-7])  # truncated
    with pytest.raises(ValueError, match="EndOfDict"):
        t_pfp.pfp_from_parse_files(pre, CPU)
    (tmp_path / "ck.dict").write_bytes(b"")
    with pytest.raises(ValueError, match="EndOfDict"):
        t_pfp.read_parse_files(pre)
    (tmp_path / "ck.dict").write_bytes(d)
    with pytest.raises(ValueError, match="window mismatch"):
        t_pfp.pfp_from_parse_files(pre, CPU, w=40)
    p = np.fromfile(str(tmp_path / "ck.parse"), dtype="<u4")
    p[0] = 10**6
    p.tofile(str(tmp_path / "ck.parse"))
    with pytest.raises(ValueError, match="outside the .dict"):
        t_pfp.pfp_from_parse_files(pre, CPU)
