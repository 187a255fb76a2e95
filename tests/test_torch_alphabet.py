"""The real-alphabet variant of the main path against mumemto_tpu: inputs
with assembly gaps (runs of N) and IUPAC ambiguity codes.

One more letter than ACGT and the dictionary index drops the 3-bit seed and
the PLCP for the 7-bit packed seed and the rank descent; more than 16
letters and the descent runs unpacked to level 0. The collections here hold
runs of 100, 1000 and 3000 N at different places per document (one at a
document's first base, one at a document's last), so a phrase is thousands
of characters long and the doubling depth exceeds the ACGT value; the
second collection adds the ten codes RYKMSWBDHV. Both packages get the same
numpy bytes, made from a seed; the JAX side runs on its CPU backend, as its
own tests run it.

Tolerance: none. Integers and output bytes are compared exactly; isaD and
lcpD in the form their consumers read (torch_dict_form.dict_consumer_form:
the order through each phrase separator, where the port's doubling stops,
and the LCPs of suffixes that differ before it). The two collections share
every array shape, so the JAX programs compile once per mode; -f 0 -F 0
runs on a fifth of the size, because its output is quadratic in the run
length.
"""

import functools
import gzip

import numpy as np
import pytest
import torch

import jax

from mumemto_tpu import cli as jax_cli
from mumemto_tpu import engine as jax_engine
from mumemto_tpu import options
from mumemto_tpu import refbuilder as jax_refbuilder
from mumemto_tpu.ops import pfp as jax_pfp
from mumemto_tpu.parallel import seqpfp as jax_seqpfp
from mumemto_tpu_torch import cli as t_cli
from mumemto_tpu_torch import engine as t_engine
from mumemto_tpu_torch import refbuilder as t_refbuilder
from mumemto_tpu_torch.ops import pfp as t_pfp
from mumemto_tpu_torch.parallel import mesh, seqpfp
from conftest import build
from torch_dict_form import dict_consumer_form
from test_torch_engine import _same_files, _write_both

# several test workers share the machine's cores
torch.set_num_threads(2)

CPU = torch.device("cpu")
KINDS = ["acgtn", "iupac"]
CODES = b"RYKMSWBDHV"
# (start, length) of each document's gaps; document 0's first starts at its
# first base and document 1's last ends at its last base
DOC_LENS = (15000, 20000, 25000)
GAPS = (((0, 100), (7000, 1000), (11000, 3000)),
        ((2500, 3000), (9000, 100), (19000, 1000)),
        ((4000, 100), (14000, 1000), (20000, 3000)))
# the same at a fifth of the size, for -f 0 -F 0: with no occurrence limit
# every N^L down to the minimum length is a multi-MEM of every suffix inside
# a long enough run, so the output grows with the square of the run length
SMALL_LENS = (3000, 4000, 5000)
SMALL_GAPS = (((0, 100), (1500, 300)), ((800, 300), (3900, 100)),
              ((2000, 100), (3000, 300)))


@functools.lru_cache(maxsize=None)
def _docs(kind, small=False):
    """Three mutated prefixes (15, 20 and 25 kbp) of one random base: as
    "acgt" plain, as "acgtn" with the gaps of GAPS, as "iupac" with each of
    the ten codes once per document besides. small: SMALL_LENS and
    SMALL_GAPS instead."""
    rng = np.random.default_rng(8)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    lens, all_gaps = (SMALL_LENS, SMALL_GAPS) if small else (DOC_LENS, GAPS)
    base = rng.integers(0, 4, max(lens))
    docs = []
    for n, gaps in zip(lens, all_gaps):
        s = base[:n].copy()
        pos = rng.integers(0, n, n // 500)
        s[pos] = (s[pos] + rng.integers(1, 4, pos.size)) % 4
        d = acgt[s]
        in_gap = np.zeros(n, bool)
        for start, length in gaps:
            in_gap[start:start + length] = True
        where = rng.choice(np.flatnonzero(~in_gap), len(CODES), replace=False)
        if kind != "acgt":
            d[in_gap] = ord("N")
        if kind == "iupac":
            d[where] = np.frombuffer(CODES, np.uint8)
        docs.append([d.tobytes().decode()])
    return docs


@functools.lru_cache(maxsize=None)
def _rb(kind, small=False):
    return build(_docs(kind, small))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eq(a, b):
    return np.array_equal(_np(a), _np(b))


def test_collections_hold_the_runs():
    for kind, letters in (("acgtn", 5), ("iupac", 15)):
        docs = [d[0] for d in _docs(kind)]
        assert [len(d) for d in docs] == list(DOC_LENS)
        assert docs[0].startswith("N" * 100) and docs[0][100] != "N"
        assert docs[1].endswith("N" * 1000) and docs[1][-1001] != "N"
        assert all("N" * 3000 in d for d in docs)
        assert len(set("".join(docs))) == letters
    # with the parse's 0, 1, 2 and the '$': 9 and 19 distinct bytes
    for kind, n in (("acgtn", 9), ("iupac", 19)):
        alpha = set(t_pfp._alphabet(_rb(kind).text)) | {0, 1, 2}
        assert len(alpha) == n


def test_complement_table_on_the_codes():
    codes = np.frombuffer(b"ACGTN" + CODES, np.uint8)
    want = jax_refbuilder.revcomp(codes)
    assert t_refbuilder.revcomp(codes).tobytes() == want.tobytes()
    assert want.tobytes() == b"BDHVWSKMRYNACGT"
    for kind in KINDS:
        seqs = [[s.lower() for s in d] for d in _docs(kind)]
        assert _eq(t_refbuilder.build_from_sequences(seqs).text,
                   _rb(kind).text)


@pytest.mark.parametrize("kind", KINDS)
def test_seed_thresholds(kind):
    alpha = sorted(set(t_pfp._alphabet(_rb(kind).text)) | {0, 1, 2})
    got = t_pfp.seed_thresholds(alpha)
    assert got == jax_pfp.seed_thresholds(alpha)
    assert got[0] is None
    assert (got[1] is None) == (kind == "iupac")
    # the direct backend's text holds no parse bytes: ACGTN with the pad's
    # 0 is 7 letters and keeps the 3-bit seed there
    direct = sorted(set(t_pfp._alphabet(_rb(kind).text)) | {0})
    got = t_pfp.seed_thresholds(direct)
    assert got == jax_pfp.seed_thresholds(direct)
    assert (got[0] is None) == (got[1] is None) == (kind == "iupac")


def _host_alphabet(bytes_np: np.ndarray) -> tuple:
    """The oracle: the alphabet as the host took it before the device did,
    sorted distinct byte values from a presence mask over a uint16 view."""
    bytes_np = np.ascontiguousarray(bytes_np)
    even = bytes_np[:bytes_np.size & ~1]
    present16 = np.zeros(65536, np.bool_)
    present16[even.view(np.uint16)] = True
    pairs = np.flatnonzero(present16)
    present = np.zeros(256, np.bool_)
    present[pairs & 255] = True
    present[pairs >> 8] = True
    if bytes_np.size & 1:
        present[bytes_np[-1]] = True
    return tuple(np.flatnonzero(present).tolist())


@pytest.mark.parametrize("kind", ["acgt"] + KINDS)
def test_build_pfp_ext_and_alpha_equal_the_host_construction(kind):
    """ext byte for byte, zero pad included, as the host concatenated and
    padded it before the upload; alpha that ext's (without the pad), by
    the host oracle and by the JAX package."""
    text = _rb(kind).text
    pt = t_pfp.build_pfp(text, CPU, w=10, mod=100)
    ext_np = np.concatenate([np.full(1, t_pfp.DOLLAR_PFP, np.uint8), text,
                             np.full(10, t_pfp.DOLLAR_PFP, np.uint8)])
    ne = t_pfp.ops_suffix.bucket(ext_np.size, lo=1024)
    want = np.zeros(ne, np.uint8)
    want[:ext_np.size] = ext_np
    assert pt.ext.dtype == torch.uint8 and tuple(pt.ext.shape) == (ne,)
    assert _eq(pt.ext, want)
    assert pt.alpha == _host_alphabet(ext_np) == jax_pfp._alphabet(ext_np)
    assert (ord("N") in pt.alpha) == (kind != "acgt")


class _Stop(Exception):
    pass


@pytest.mark.parametrize("kind", ["acgt"] + KINDS)
def test_direct_seed_thresholds_unchanged(kind, monkeypatch):
    """-g's seed and LCP thresholds, from the alphabet of its uploaded
    text and the pad's 0, are those of the host text's bytes."""
    rb = _rb(kind)
    got = {}

    def scan(*a, **kw):
        got.update(seed=kw["alpha_thresholds"], lcp=kw["lcp_thresholds"],
                   text=a[0].clone())
        raise _Stop
    monkeypatch.setattr(t_engine.ops_pipeline, "scan_collection", scan)
    with pytest.raises(_Stop):
        t_engine.find_matches(rb, options.normalize(rb.num_docs, quiet=True),
                              device="cpu", backend="direct")
    letters = set(_host_alphabet(rb.text)) | {0}
    want = t_pfp.seed_thresholds(letters)
    assert (got["seed"], got["lcp"]) == want == jax_pfp.seed_thresholds(
        set(jax_pfp._alphabet(rb.text)) | {0})
    n = t_pfp.ops_suffix.bucket(rb.text.size + 4, lo=4096)
    padded = np.zeros(n, np.uint8)
    padded[:rb.text.size] = rb.text
    assert _eq(got["text"], padded)


@functools.lru_cache(maxsize=None)
def _staged(kind):
    rb = _rb(kind)
    pj = jax_pfp.build_pfp(rb.text, w=10, mod=100)
    pt = t_pfp.build_pfp(rb.text, CPU, w=10, mod=100)
    hj = jax_pfp._host_prep(pj, rb.doc_ends, rb.num_docs)
    ht = t_pfp._host_prep(pt, rb.doc_ends)
    return rb, pj, pt, hj, ht


@pytest.mark.parametrize("kind", KINDS)
def test_build_pfp_and_host_prep(kind):
    _rb_, pj, pt, hj, ht = _staged(kind)
    for f in ("w", "n_text", "m", "num_phrases", "d_len", "alpha"):
        assert getattr(pt, f) == getattr(pj, f), f
    for f in ("ext", "parse", "phrase_st", "phrase_ln"):
        assert _eq(getattr(pt, f), getattr(pj, f)), f
    for key in ("nd", "nr", "mp", "w", "lvl_cap", "lvl_static", "seed_thr",
                "lcp_thr", "ne", "npz", "total_real", "m", "total_rows"):
        assert ht[key] == hj[key], key
    for key in ("phrase_st", "phrase_ln", "d_starts", "parse", "cumC",
                "cumcnt", "doc_ends"):
        assert _eq(ht[key], hj[key]), key
    assert ht["seed_thr"] is None
    assert (ht["lcp_thr"] is None) == (kind == "iupac")
    # no KR break falls inside a run of N, so a phrase holds a whole gap
    assert int(pt.phrase_ln.max()) > 3000
    acgt = t_pfp._host_prep(t_pfp.build_pfp(_rb("acgt").text, CPU),
                            _rb("acgt").doc_ends)
    assert ht["lvl_cap"] >= 12 > acgt["lvl_cap"]
    assert acgt["seed_thr"] is not None


@pytest.mark.parametrize("kind", KINDS)
def test_dict_index(kind):
    _rb_, pj, pt, hj, ht = _staged(kind)
    d_j, lcp_j, isa_j, gp_j, gc_j = jax_pfp._dict_index(
        pj.ext, hj["phrase_st"], hj["phrase_ln"], hj["d_starts"], hj["npz"],
        hj["total_real"], hj["nd"], hj["ne"], hj["w"], hj["lvl_cap"],
        hj["lvl_static"], hj["seed_thr"], hj["lcp_thr"])
    d_t, lcp_t, isa_t, gp_t, gc_t = t_pfp._dict_index(
        pt.ext, ht["phrase_st"], ht["phrase_ln"], ht["d_starts"], ht["npz"],
        ht["total_real"], ht["nd"], ht["ne"], ht["w"], ht["lvl_cap"],
        ht["lvl_static"], ht["seed_thr"], ht["lcp_thr"], ht["dict_live"])
    assert _eq(d_t, d_j)
    assert _eq(gp_t, gp_j)
    assert _eq(gc_t, gc_j)
    nd = hj["nd"]
    assert (np.sort(isa_t.numpy()) == np.arange(nd)).all()
    # isaD and lcpD as the consumers read them: the order through each
    # phrase separator, the LCPs of suffixes that differ before it
    keys_j, cross_j = dict_consumer_form(d_j, isa_j, lcp_j, hj["total_real"])
    keys_t, cross_t = dict_consumer_form(d_t, isa_t, lcp_t, hj["total_real"])
    assert keys_t == keys_j
    assert (cross_t == cross_j).all()
    # an LCP above the ACGT collection's whole depth: suffixes inside runs
    assert int(lcp_t.max()) >= 2900


# name -> (options, how the run is made)
MODES = {
    "mum": ({}, "pfp"),
    "k-1": ({"num_distinct_docs": -1}, "pfp"),
    "f3": ({"rare_freq": 3}, "pfp"),
    "f0F0": ({"rare_freq": 0, "max_mem_freq": 0}, "pfp"),
    "g": ({}, "direct"),
    "shards4": ({}, "sharded"),
}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("kind", KINDS)
def test_find_matches_bytes(kind, mode):
    rb = _rb(kind, small=mode == "f0F0")
    kw, how = MODES[mode]
    opts = options.normalize(rb.num_docs, quiet=True, **kw)
    if how == "sharded":
        devs = np.asarray(jax.devices()[:4]).reshape(4)
        want = jax_seqpfp.find_matches_seq_sharded(
            rb, opts, jax.sharding.Mesh(devs, ("seq",)))
        got = seqpfp.find_matches_seq_sharded(rb, opts,
                                              mesh.seq_devices(4, "cpu"))
    else:
        want = jax_engine.find_matches(rb, opts, backend=how,
                                       show_progress=False)
        got = t_engine.find_matches(rb, opts, device="cpu", backend=how)
    assert got.output_bytes() == want.output_bytes()
    assert got.num_matches == want.num_matches > 0
    assert got.bwt_runs == want.bwt_runs
    if mode == "f0F0":
        # the all-N multi-MEMs: one for every length from 20 to the longest
        # run, each listing every suffix of a run that is long enough
        lines = got.output_bytes().splitlines()
        assert sum(ln.count(b",") > 1000 for ln in lines) > 100


@pytest.mark.parametrize("kind", KINDS)
def test_merge_metadata_files(kind, tmp_path):
    rb = _rb(kind)
    opts = options.normalize(rb.num_docs, merge=True, quiet=True)
    _write_both(rb, opts, tmp_path)
    _same_files(tmp_path, [".mums", ".thresh", ".thresh_rev"])


@pytest.mark.parametrize("kind", KINDS)
def test_cli_from_fasta_files(kind, tmp_path):
    """Both CLIs from FASTA files: one lower-case, one gzipped."""
    paths = []
    for i, d in enumerate(_docs(kind)):
        body = d[0].lower() if i == 1 else d[0]
        text = f">s{i}\n{body[:7000]}\n{body[7000:]}\n"
        p = tmp_path / (f"g{i}.fa.gz" if i == 0 else f"g{i}.fa")
        if i == 0:
            with gzip.open(p, "wt") as f:
                f.write(text)
        else:
            p.write_text(text)
        paths.append(str(p))
    out = tmp_path / "out"
    out.mkdir()
    assert jax_cli.main(paths + ["-o", str(out / "jax")]) == 0
    assert t_cli.main(paths + ["-o", str(out / "torch"),
                               "--device", "cpu"]) == 0
    _same_files(out, [".mums", ".lengths"])
    want = t_engine.find_matches(
        _rb(kind), options.normalize(3, quiet=True), device="cpu")
    assert (out / "torch.mums").read_bytes() == want.output_bytes()


@pytest.mark.parametrize("kind", KINDS)
def test_shard_dict_refused_word_for_word(kind):
    rb = _rb(kind)
    opts = options.normalize(rb.num_docs, quiet=True)
    devs = np.asarray(jax.devices()[:4]).reshape(4)
    with pytest.raises(AssertionError) as want:
        jax_seqpfp.find_matches_seq_sharded(
            rb, opts, jax.sharding.Mesh(devs, ("seq",)), shard_dict=True)
    with pytest.raises(AssertionError) as got:
        seqpfp.find_matches_seq_sharded(rb, opts, mesh.seq_devices(4, "cpu"),
                                        shard_dict=True)
    assert str(got.value) == str(want.value)
    assert "packed <=8-byte alphabet" in str(got.value)
