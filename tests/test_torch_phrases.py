"""The phrase sort on the device (ops/pfp.sort_phrases, kernels/phrases.py)
on the CPU, through the kernels' plain versions.

build_pfp against the JAX package's (whose ranks come from the host's
native sort) on heavy duplication, 1% divergence, N runs, a text of all
256 byte values with proper prefixes and phrases ending in byte 0, two
distinct phrases sharing a prefix of 100,000 bytes (the tail kernel's
path), and fingerprints cut to two bits (every record ranked); every
PFPData field equal. sort_phrases on arbitrary records against Python's
sort of their bytes; the plain versions against direct definitions.

Tolerance: exact equality (integer ranks and positions).
"""

import numpy as np
import pytest
import torch

from mumemto_tpu.ops import pfp as jax_pfp
from mumemto_tpu_torch import trace
from mumemto_tpu_torch.kernels import kr_mask, phrases
from mumemto_tpu_torch.ops import pfp as t_pfp
from conftest import build, mutated_collection, rand_seq
from test_torch_phrases_card import _host_ranks, repeat_family
from test_torch_suffix import with_n

# several test workers share the machine's cores
torch.set_num_threads(2)

CPU = torch.device("cpu")
W, MOD = 10, 100


def _snps(rng, base: str, rate: float) -> str:
    s = np.array(list(base))
    at = rng.random(s.size) < rate
    s[at] = rng.choice(list("ACGT"), int(at.sum()))
    return "".join(s)


def _non_break_byte(choices: bytes) -> int:
    """A byte whose w-long run is no KR break (so a run of it has none)."""
    for c in choices:
        ext = torch.full((4 * W,), c, dtype=torch.uint8)
        if int(kr_mask.break_mask_plain(ext, 4 * W, W, MOD)[1]) == 0:
            return c
    raise AssertionError("every candidate byte breaks")


def _text(kind: str, rng) -> np.ndarray:
    if kind == "duplicated":  # identical haplotypes and light mutations
        base = rand_seq(rng, 3000)
        docs = [[base]] * 4 + mutated_collection(rng, 3, base_len=3000)
        return build(docs).text
    if kind == "divergent":  # 1% SNPs: most phrases distinct
        base = rand_seq(rng, 8000)
        return build([[_snps(rng, base, 0.01)] for _ in range(5)]).text
    if kind == "with_n":
        rep = rand_seq(rng, 50)
        return build(with_n(mutated_collection(rng, 4, base_len=2000,
                                               insert_rep=rep), rng)).text
    if kind == "all_bytes":
        # byte 0 at 1/8, the rest of the 256 values spread; a block T
        # repeated, and T + [DOLLAR] * w + more earlier in the text, so the
        # last phrase (which ends in the w decoration bytes) and its earlier
        # copy are one a proper prefix of the other
        def block(n):
            b = rng.integers(0, 256, n).astype(np.uint8)
            b[rng.random(n) < 0.125] = 0
            return b
        t = block(4000)
        pad = np.full(W, t_pfp.DOLLAR_PFP, np.uint8)
        return np.concatenate([block(3000), t, pad, block(2000), t,
                               block(500), t])
    if kind == "long_prefix":
        # x + run + "C" ... x + run + "G": two distinct phrases that share
        # their start in x and 100,000 run bytes
        run = _non_break_byte(b"ACGT")
        x = np.frombuffer(rand_seq(rng, 600).encode(), np.uint8)
        body = np.full(100_000, run, np.uint8)

        def tail(c):
            return np.concatenate([np.frombuffer(c, np.uint8), np.frombuffer(
                rand_seq(rng, 800).encode(), np.uint8)])
        return np.concatenate([x, body, tail(b"C"), x, body, tail(b"G")])
    raise ValueError(kind)


def _phrases_of(p) -> list:
    ext = p.ext.numpy() if isinstance(p.ext, torch.Tensor) else \
        np.asarray(p.ext)
    return [ext[s:s + n].tobytes()
            for s, n in zip(p.phrase_st[1:].tolist(), p.phrase_ln[1:].tolist())]


def _traced_build(text):
    trace.disable()
    trace.drain()
    trace.enable()
    try:
        got = t_pfp.build_pfp(text, CPU, w=W, mod=MOD)
    finally:
        trace.disable()
    (counters,) = trace.drain()["counters"].values()
    return got, counters


@pytest.mark.parametrize("kind", ["duplicated", "divergent", "with_n",
                                  "all_bytes", "long_prefix", "collisions"])
def test_build_pfp_equals_the_jax_package(kind, monkeypatch):
    rng = np.random.default_rng(19)
    text = _text("divergent" if kind == "collisions" else kind, rng)
    tails = []
    real_tail = phrases.tail_rank
    monkeypatch.setattr(phrases, "tail_rank",
                        lambda *a: tails.append(a[6]) or real_tail(*a))
    if kind == "collisions":
        real_fp = phrases.fingerprint
        monkeypatch.setattr(phrases, "fingerprint",
                            lambda *a: real_fp(*a) & 3)
    want = jax_pfp.build_pfp(text, w=W, mod=MOD)
    got, counters = _traced_build(text)
    for f in ("w", "n_text", "m", "num_phrases", "d_len", "alpha"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("parse", "phrase_st", "phrase_ln"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b), f
    assert np.array_equal(got.ext.numpy(), np.asarray(want.ext))
    words = _phrases_of(got)
    assert words == sorted(words) and len(set(words)) == len(words)
    assert counters[t_pfp.SORT_ROUNDS_COUNTER] >= 1
    assert (counters[t_pfp.SORT_COLLISIONS] > 0) == (kind == "collisions")
    if kind == "duplicated":
        assert got.num_phrases < got.m // 2
    if kind == "all_bytes":
        assert len(set(text.tolist())) == 256
        assert any(w[-1] == 0 for w in words)
        assert any(b.startswith(a) for a, b in zip(words, words[1:]))
    if kind == "long_prefix":
        assert counters[t_pfp.SORT_ROUNDS_COUNTER] == t_pfp.SORT_ROUNDS
        assert tails == [t_pfp.SORT_ROUNDS * t_pfp._KEY_BYTES]
        run = bytes([_non_break_byte(b"ACGT")]) * 99_000
        assert len([w for w in words if run in w]) == 2


def _records(seed: int, m: int = 3000):
    """Records over a text of all byte values: random spans, copies, proper
    prefixes of one another, spans of zeros and of equal bytes (whose
    7-byte keys tie over many rounds), lengths 1 to 300."""
    rng = np.random.default_rng(seed)
    ext = rng.integers(0, 256, 40000).astype(np.uint8)
    ext[5000:5600] = 0
    ext[9000:9700] = 7
    ext[20000:20400] = ext[30000:30400]  # two copies of one stretch
    st = rng.integers(0, 39000, m)
    ln = rng.integers(1, 300, m)
    k = m // 5
    st[:k] = rng.choice([5000, 9000, 20000, 30000], k)   # shared starts
    st[k:2 * k] = st[rng.integers(0, k, k)]               # prefixes, copies
    ln = np.minimum(ln, ext.size - st)
    return ext, st.astype(np.int32), ln.astype(np.int32)


@pytest.mark.parametrize("fp_bits", [62, 2, 0])
def test_sort_phrases_ranks_like_pythons_sort(fp_bits, monkeypatch):
    """Dense ranks and smallest records equal Python's sort of the bytes,
    with the fingerprint whole, cut to 2 bits and cut to nothing (every
    record collides: the refinement ranks every record)."""
    ext, st, ln = _records(fp_bits)
    if fp_bits < 62:
        real_fp = phrases.fingerprint
        monkeypatch.setattr(phrases, "fingerprint",
                            lambda *a: real_fp(*a) & ((1 << fp_bits) - 1))
    monkeypatch.setattr(t_pfp, "SORT_ROUNDS", 6)  # reach the tail too
    parse, phrase_st, phrase_ln = t_pfp.sort_phrases(
        torch.from_numpy(ext), torch.from_numpy(st), torch.from_numpy(ln))
    grp, rep = _host_ranks(ext, st, ln)
    assert np.array_equal(parse, grp + 1)
    assert np.array_equal(phrase_st[1:], st[rep])
    assert np.array_equal(phrase_ln[1:], ln[rep])
    assert phrase_st[0] == phrase_ln[0] == 0


def test_sort_phrases_ranks_a_repeat_family(monkeypatch):
    """3000 records of one repeat family (distinct phrases sharing 200
    bytes, copies, proper prefixes): Python's sort's ranks, the family's
    distinct phrases handed to the tail as one group."""
    ext, st, ln = repeat_family(3, 3000)
    groups = []
    real_tail = phrases.tail_rank
    monkeypatch.setattr(phrases, "tail_rank", lambda *a: groups.append(
        int((a[5][1:] - a[5][:-1]).max())) or real_tail(*a))
    parse, phrase_st, phrase_ln = t_pfp.sort_phrases(
        torch.from_numpy(ext), torch.from_numpy(st), torch.from_numpy(ln))
    grp, rep = _host_ranks(ext, st, ln)
    assert np.array_equal(parse, grp + 1)
    assert np.array_equal(phrase_st[1:], st[rep])
    assert np.array_equal(phrase_ln[1:], ln[rep])
    assert len(groups) == 1 and groups[0] == phrase_st.size - 1 > 2000


@pytest.mark.parametrize("n", [1, 2])
def test_sort_phrases_one_or_two_records(n):
    ext = torch.tensor([5, 5, 5, 4], dtype=torch.uint8)
    st = torch.tensor([0, 1][:n], dtype=torch.int32)
    ln = torch.tensor([3, 3][:n], dtype=torch.int32)
    parse, phrase_st, phrase_ln = t_pfp.sort_phrases(ext, st, ln)
    # 5 5 5 > 5 5 4
    assert parse.tolist() == ([1] if n == 1 else [2, 1])
    assert phrase_st.tolist() == ([0, 0] if n == 1 else [0, 1, 0])
    assert phrase_ln.tolist() == [0, 3, 3][:n + 1]


def test_round_keys_order_as_memcmp_then_shorter():
    """At each depth, a smaller key means smaller remaining bytes (memcmp
    over the shorter, then the shorter first: Python's bytes order), and
    equal keys mean equal remaining bytes or equal 7-byte windows that
    both records run past; over neighbours in that order (shared
    prefixes, prefixes, byte 0 against an end) and random pairs."""
    ext, st, ln = _records(5, m=600)
    et, stt, lnt = (torch.from_numpy(x) for x in (ext, st, ln))
    k = t_pfp._KEY_BYTES
    rng = np.random.default_rng(0)
    for d in (0, 7, 21):
        rest = sorted((ext[s + d:s + n].tobytes(), r) for r, (s, n)
                      in enumerate(zip(st.tolist(), ln.tolist())) if n > d)
        rec = torch.tensor([r for _, r in rest], dtype=torch.int32)
        keys = t_pfp._round_keys(et, stt, lnt, rec, d).tolist()
        pairs = [(i, i + 1) for i in range(len(rest) - 1)]
        pairs += list(zip(rng.permutation(len(rest)),
                          rng.permutation(len(rest))))
        for i, j in pairs:
            a, b = rest[i][0], rest[j][0]
            if keys[i] < keys[j]:
                assert a < b, (d, a, b)
            elif keys[i] > keys[j]:
                assert a > b, (d, a, b)
            else:
                assert a == b or (a[:k] == b[:k] and min(len(a), len(b)) > k)


def test_plain_fingerprint_and_verify():
    """fingerprint_plain is the polynomial sum of its definition, and
    verify_plain counts the records that differ from their heads."""
    ext, st, ln = _records(3, m=400)
    et, stt, lnt = (torch.from_numpy(x) for x in (ext, st, ln))
    fp = phrases.fingerprint(et, stt, lnt).tolist()
    for r in range(0, st.size, 37):
        want = 0
        for mod, base in phrases.HASHES:
            h = sum(int(b) * pow(base, i, mod)
                    for i, b in enumerate(ext[st[r]:st[r] + ln[r]]))
            want = (want << 31) | (h % mod)
        assert fp[r] == want
    order = torch.arange(st.size, dtype=torch.int32)
    head = torch.roll(order, 1)
    same = torch.tensor([i for i in range(st.size) if ln[i] == ln[i - 1]],
                        dtype=torch.int64)
    o, h = order[same].contiguous(), head[same].contiguous()
    bad = int(phrases.verify(et, stt, lnt, o, h))
    want = sum(ext[st[i]:st[i] + ln[i]].tobytes()
               != ext[st[i - 1]:st[i - 1] + ln[i]].tobytes()
               for i in same.tolist())
    assert bad == want
    assert int(phrases.verify(et, stt, lnt, order, order)) == 0


@pytest.mark.parametrize("bad", ["ext dtype", "st dtype", "2-D", "strided",
                                 "device"])
def test_wrappers_reject_bad_input(bad):
    ext = torch.zeros(64, dtype=torch.uint8)
    st = torch.zeros(4, dtype=torch.int32)
    ln = torch.ones(4, dtype=torch.int32)
    if bad == "ext dtype":
        ext = ext.to(torch.int32)
    elif bad == "st dtype":
        st = st.to(torch.int64)
    elif bad == "2-D":
        ln = ln.view(2, 2)
    elif bad == "strided":
        st = torch.zeros(8, dtype=torch.int32)[::2]
    else:
        st = st.to("meta")
    with pytest.raises(ValueError):
        phrases.fingerprint(ext, st, ln)
    with pytest.raises(ValueError):
        phrases.verify(ext, st, ln, st, st)
