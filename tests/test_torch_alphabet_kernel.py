"""The byte-presence set (kernels/alphabet) and where the main path takes
it (ops/pfp._alphabet): the plain twin against np.unique on random bytes
of every value, on sets of 1, 4, 5, 9 and 19 values (ACGT, ACGTN, the
parse's bytes, the IUPAC codes) at lengths 0, 1, 15, 16, 17 and 2^20 + 3,
each at start offsets 0-15 into a larger buffer whose other bytes hold a
value outside the set; the wrapper's refusals; the routes that take the
alphabet on the device (one a build_pfp, one a -g call, none for -a and
the -p resume, which keeps the host twin). On the card: the kernel's flags
against the twin's on the same cases, and its launches counted by
bench.counted on each route.

Tolerance: none; flags, tuples and counts are compared exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mumemto_tpu_torch import bench, engine, formats, options, trace
from mumemto_tpu_torch.kernels import alphabet
from mumemto_tpu_torch.ops import pfp as ops_pfp
from mumemto_tpu_torch.parallel import mesh, seqpfp
from mumemto_tpu_torch.refbuilder import build_from_sequences

# several test workers share the machine's cores
torch.set_num_threads(2)

IUPAC = b"ACGTNRYKMSWBDHV"
# name -> the set's byte values
SETS = {
    "1": [65],
    "4": list(b"ACGT"),
    "5": list(b"ACGTN"),
    "9": [0, 1, 2, 36] + list(b"ACGTN"),
    "19": [0, 1, 2, 36] + list(IUPAC),
}
LENGTHS = [0, 1, 15, 16, 17, 2**20 + 3]
OUTSIDE = 255  # the buffer's bytes around the window


def _oracle(a: np.ndarray) -> np.ndarray:
    return np.isin(np.arange(256), np.unique(a))


def _windows(values, n, seed):
    """[(buffer, o, want)] for the offsets o = 0-15: a uint8 buffer of n +
    48 bytes whose window buffer[16 + o : 16 + o + n] holds random set
    values, the set's first value at the window's last byte only and its
    second at the window's first byte only (where n allows), every other
    byte OUTSIDE. want: np.unique's flags of the window."""
    rng = np.random.default_rng(seed)
    cases = []
    buf = np.full(n + 48, OUTSIDE, np.uint8)
    pick = np.asarray(values[2:] or values, np.uint8)
    for o in range(16):
        body = pick[rng.integers(0, pick.size, n)]
        if n >= 1:
            body[-1] = values[0]
        if n >= 2 and len(values) > 1:
            body[0] = values[1]
        win = buf.copy()
        win[16 + o:16 + o + n] = body
        cases.append((win, o, _oracle(body)))
    return cases


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("name", list(SETS))
def test_plain_twin_on_windows(name, n):
    for buf, o, want in _windows(SETS[name], n, seed=n + len(SETS[name])):
        t = torch.from_numpy(buf)[16 + o:16 + o + n]
        got = alphabet.byte_presence(t)
        assert got.dtype == torch.bool and got.shape == (256,)
        assert np.array_equal(got.numpy(), want), (name, n, o)
        assert not got[OUTSIDE]
        assert np.array_equal(alphabet.byte_presence_plain(
            buf[16 + o:16 + o + n]).numpy(), want)


@pytest.mark.parametrize("n", [1, 2, 3, 4096, 4097])
def test_plain_twin_on_random_bytes_of_every_value(n):
    a = np.random.default_rng(n).integers(0, 256, n).astype(np.uint8)
    got = alphabet.byte_presence(torch.from_numpy(a)).numpy()
    assert np.array_equal(got, _oracle(a))
    if n > 4000:
        assert got.all()


def test_byte_presence_refuses_other_tensors():
    for bad in (torch.zeros(4, dtype=torch.int32),
                torch.zeros((2, 2), dtype=torch.uint8),
                torch.zeros(8, dtype=torch.uint8)[::2]):
        with pytest.raises(ValueError, match="contiguous 1-D uint8"):
            alphabet.byte_presence(bad)


def test_alphabet_reads_back_once_from_a_tensor():
    """A tensor's flags are read back once (engine.readbacks); a numpy
    array's are the host twin's, with no readback. Both give the sorted
    values."""
    a = np.frombuffer(b"\x02ACGTNNNACGT\x02\x02", np.uint8)
    trace.enable()
    try:
        with trace.call("engine.find_matches"):
            got_t = ops_pfp._alphabet(torch.from_numpy(a.copy()))
            got_n = ops_pfp._alphabet(a)
    finally:
        trace.disable()
    kept = trace.drain()
    assert got_t == got_n == (2, 65, 67, 71, 78, 84)
    (counters,) = kept["counters"].values()
    assert counters == {trace.READBACKS: 1}
    assert [s["name"] for s in kept["spans"]].count("pfp.alphabet") == 2


# --- the routes ------------------------------------------------------------------

def _rb(seed=5, n_docs=4, base_len=1200):
    rng = np.random.default_rng(seed)
    base = "".join(rng.choice(list("ACGT"), base_len))
    docs = []
    for i in range(n_docs):
        s = list(base)
        for _ in range(8):
            s[int(rng.integers(0, len(s)))] = str(rng.choice(list("ACGT")))
        s[100 + 50 * i:130 + 50 * i] = "N" * 30
        docs.append(["".join(s)])
    return build_from_sequences(docs, use_revcomp=True)


def _routes(rb, device, tmp_path):
    """route -> a function running it on `device`: the PFP routes, -g,
    -P, the -p resume of its files, -A and the -a replay of its files."""
    pre = str(tmp_path / "ck")

    def find(flags=None, **kw):
        opts = options.normalize(rb.num_docs, quiet=True, **(flags or {}))
        return lambda: engine.find_matches(rb, opts, device=device,
                                           show_progress=False, **kw)

    def replay():
        sa = formats.read_5byte(pre + ".sa").astype(np.int64)
        lcp = formats.read_5byte(pre + ".lcp").astype(np.int64)
        bwt = formats.read_rl_bwt(pre + ".bwt")
        return engine.find_matches_from_arrays(
            sa, lcp, bwt, rb.doc_array(sa), rb,
            options.normalize(rb.num_docs, quiet=True), device=device)
    return {
        "mum": find(),
        "mem_f3": find({"rare_freq": 3}),
        "-g": find(backend="direct"),
        "-P": lambda: ops_pfp.write_parse_files(rb, pre,
                                                torch.device(device)),
        "-p": lambda: engine.find_matches(
            dataclasses.replace(rb, text=None),
            options.normalize(rb.num_docs, quiet=True), device=device,
            parse_prefix=pre, show_progress=False),
        "-A": find(arrays_out_prefix=pre),
        "-a": replay,
    }


# route -> the alphabet's launches, in the order the routes run (-P
# writes the files -p reads, -A those -a reads)
LAUNCHES = {"mum": 1, "mem_f3": 1, "-g": 1, "-P": 1, "-p": 0, "-A": 1,
            "-a": 0}


def _counting_twin(monkeypatch):
    """byte_presence as a rehearsal sees it: the plain twin, each call
    counted as a launch on the card is."""
    def counted(t):
        trace.count(alphabet.COUNTER)
        return alphabet.byte_presence_plain(t)
    monkeypatch.setattr(alphabet, "byte_presence", counted)


def test_routes_take_the_alphabet_where_the_text_lies(tmp_path, monkeypatch):
    _counting_twin(monkeypatch)
    rb = _rb()
    runs = _routes(rb, "cpu", tmp_path)
    got = {route: bench.counted(torch, fn)[2]["alphabet"]
           for route, fn in runs.items()}
    assert got == LAUNCHES


def test_sharded_scan_takes_the_alphabet_once(monkeypatch):
    _counting_twin(monkeypatch)
    rb = _rb()
    opts = options.normalize(rb.num_docs, quiet=True)
    out, _s, launches = bench.counted(torch, lambda: (
        seqpfp.find_matches_seq_sharded(rb, opts,
                                        mesh.seq_devices(2, "cpu"))))
    assert launches["alphabet"] == 1
    assert out.output_bytes() == engine.find_matches(
        rb, opts, device="cpu", show_progress=False).output_bytes()


def test_direct_alphabet_is_the_texts_without_its_pad(monkeypatch):
    """-g takes the alphabet of text[:n_real] on the device and adds the
    pad's 0: its seed thresholds are those of the host text's bytes."""
    seen = []
    real = ops_pfp._alphabet

    def spy(data):
        seen.append((data.device, data.numel()))
        return real(data)
    monkeypatch.setattr(ops_pfp, "_alphabet", spy)
    rb = _rb()
    thr = {}
    real_scan = engine.ops_pipeline.scan_collection

    def scan(*a, **kw):
        thr.update(seed=kw["alpha_thresholds"], lcp=kw["lcp_thresholds"])
        return real_scan(*a, **kw)
    monkeypatch.setattr(engine.ops_pipeline, "scan_collection", scan)
    engine.find_matches(rb, options.normalize(rb.num_docs, quiet=True),
                        device="cpu", backend="direct", show_progress=False)
    assert seen == [(torch.device("cpu"), rb.text.size)]
    letters = set(np.unique(rb.text).tolist()) | {0}
    assert (thr["seed"], thr["lcp"]) == ops_pfp.seed_thresholds(letters)
    assert thr["seed"] == tuple(sorted(letters))[:-1]


# --- on the card -----------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("name", list(SETS))
def test_kernel_equals_the_twin(name, n):
    dev = _card()
    for buf, o, want in _windows(SETS[name], n, seed=n + len(SETS[name])):
        t = torch.from_numpy(buf).to(dev)[16 + o:16 + o + n]
        got = alphabet.byte_presence(t)
        assert got.device == t.device and got.dtype == torch.bool
        assert np.array_equal(got.cpu().numpy(), want), (name, n, o)


@pytest.mark.gpu
def test_kernel_on_random_bytes_of_every_value():
    dev = _card()
    for n in (1, 255, 4096, 2**22 + 5):
        a = np.random.default_rng(n).integers(0, 256, n).astype(np.uint8)
        got = alphabet.byte_presence(torch.from_numpy(a).to(dev)[1:])
        want = alphabet.byte_presence_plain(a[1:])
        assert torch.equal(got.cpu(), want), n


@pytest.mark.gpu
def test_kernel_launches_on_each_route(tmp_path):
    """bench.counted reads one alphabet launch per build_pfp (a PFP call,
    -P) and per -g call, and none for -p and -a; as many as KR launches on
    every PFP route."""
    _card()
    rb = _rb()
    runs = _routes(rb, "cuda", tmp_path)
    runs["mum"]()  # loads the kernels
    got = {}
    for route, fn in runs.items():
        _out, _s, launches = bench.counted(torch, fn)
        got[route] = launches["alphabet"]
        if route != "-g":
            assert launches["alphabet"] == launches["kr_break_mask"], route
    assert got == LAUNCHES
