"""The phrase records' kernels (csrc/phrases.cu) and their plain versions.

A record is the byte span ext[st[r] : st[r] + ln[r]] of a parse's text
(ext uint8, st and ln int32). ops/pfp.sort_phrases ranks the records with
these three kernels and PyTorch between them:

  fingerprint(ext, st, ln)            int64 fingerprint of each record's
                                      bytes: (h1 << 31) | h2, h_k the
                                      polynomial sum of byte_i * B_k^i
                                      modulo P_k (P1 = 2^31 - 1,
                                      P2 = 2^31 - 19);
  verify(ext, st, ln, order, head)    a 0-d int32 tensor: how many records
                                      order[i] differ byte for byte from
                                      head[i] (records of equal length);
  tail_rank(ext, st, ln, rec, active, starts, d, bucket)
                                      each group of S-positions
                                      active[starts[g] : starts[g + 1]],
                                      tied through depth d, ranked from d on
                                      by direct comparison: bucket[s] (for
                                      s in the group) becomes the group's
                                      bucket plus the number of members
                                      whose bytes from d on are smaller, in
                                      place.

On a CUDA tensor each launches its kernel, or raises; on a CPU tensor it
runs its plain version (`*_plain`), which is also the reference the kernel
is checked against on the card. The plain versions take any device; on
the CPU they run inside traced calls, so they make none of the calls the
readback counter counts (.cpu(), .item(), int() of a tensor, a mask
index).

No Pallas kernel is replaced: the JAX package sorts the records on the
host (native/mumemto_native.cc's std::sort), csrc/phrases.cu says why the
port does not.
"""

from __future__ import annotations

import ctypes

import torch

from mumemto_tpu_torch import trace
from mumemto_tpu_torch.kernels import build

# the fingerprint's two hashes: (modulus, base); csrc/phrases.cu kC*, kB*
HASHES = ((2**31 - 1, 911382323), (2**31 - 19, 972663749))

KERNELS = ("phrase_fingerprint", "phrase_verify", "phrase_tail_rank")
# trace counters: one a kernel launch
COUNTERS = {k: f"kernels.{k}.launches" for k in KERNELS}

launches = dict.fromkeys(KERNELS, 0)  # kernel launches (CPU calls do not)

_fns = None  # {kernel name: its C entry point}, bound once

_P = ctypes.c_void_p
_I64 = ctypes.c_int64


def launcher() -> dict:
    """{name: C entry point} of csrc/phrases.cu, built and bound at the
    first call; their arguments are those of the extern "C" functions
    there, the stream last. Calls made through them directly are not
    counted in `launches`. The first call is the span kernels.load."""
    global _fns
    if _fns is None:
        with trace.span("kernels.load"):
            args = {"phrase_fingerprint": [_P, _P, _P, _I64, _P, _P],
                    "phrase_verify": [_P, _P, _P, _P, _P, _I64, _P, _P],
                    "phrase_tail_rank": [_P, _P, _P, _P, _P, _P, _I64, _I64,
                                         _I64, _P, _P, _P]}
            _fns = {k: build.function("phrases", k, ctypes.c_int, a)
                    for k, a in args.items()}
    return _fns


def _check(ext: torch.Tensor, *int32s: torch.Tensor) -> None:
    if ext.dtype != torch.uint8 or ext.dim() != 1 or not ext.is_contiguous():
        raise ValueError(f"ext must be a contiguous 1-D uint8 tensor, got "
                         f"{ext.dtype} with shape {tuple(ext.shape)}")
    for t in int32s:
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"record arrays must be contiguous 1-D int32 "
                             f"tensors, got {t.dtype} with shape "
                             f"{tuple(t.shape)}")
        if t.device != ext.device:
            raise ValueError(f"record arrays must be on ext's device "
                             f"{ext.device}, got {t.device}")


def _on_card(ext: torch.Tensor, name: str) -> bool:
    if ext.device.type == "cpu":
        return False
    if ext.device.type != "cuda":
        raise ValueError(f"{name} takes CPU or CUDA tensors, got "
                         f"{ext.device}")
    return True


def _launch(name: str, ext: torch.Tensor, *args) -> None:
    rc = build.launch(launcher()[name], ext, *args)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    launches[name] += 1
    trace.count(COUNTERS[name])


# --- fingerprint ---------------------------------------------------------------

def _powers(base: int, e: torch.Tensor, mod: int, bits: int):
    """base^e mod `mod` for every int64 0 <= e < 2^bits: the product of two
    table entries, base^(e's low half of the bits) and base^(the high
    half's multiple)."""
    low = (bits + 1) // 2

    def table(b: int, n: int) -> torch.Tensor:  # b^0 .. b^(n - 1)
        t = torch.ones(1, dtype=torch.int64, device=e.device)
        while t.numel() < n:  # t holds b^0 .. b^(len - 1); step = b^len
            t = torch.cat([t, t * pow(b, t.numel(), mod) % mod])
        return t[:n]
    lo = table(base, 1 << low)
    hi = table(pow(base, 1 << low, mod), 1 << max(bits - low, 0))
    return lo[e & ((1 << low) - 1)] * hi[e >> low] % mod


def fingerprint_plain(ext: torch.Tensor, st: torch.Tensor, ln: torch.Tensor):
    """The kernel's fingerprints by prefix sums: with Q(x) = sum over q < x
    of ext[q] * B^q mod P, a record's hash is (Q(st + ln) - Q(st)) * B^-st.
    Every partial sum stays below 2^62 for ext below 2^31 bytes."""
    _check(ext, st, ln)
    bits = ext.numel().bit_length()  # every position and start is below ne
    pos = torch.arange(ext.numel(), dtype=torch.int64, device=ext.device)
    lo = st.to(torch.int64)
    hi = lo + ln.to(torch.int64)
    out = torch.zeros(st.numel(), dtype=torch.int64, device=ext.device)
    for mod, base in HASHES:
        terms = ext.to(torch.int64) * _powers(base, pos, mod, bits) % mod
        pre = torch.cat([terms.new_zeros(1), torch.cumsum(terms, 0) % mod])
        inv = pow(base, mod - 2, mod)
        h = (pre[hi] - pre[lo]) % mod * _powers(inv, lo, mod, bits) % mod
        out = (out << 31) | h
    return out


def fingerprint(ext: torch.Tensor, st: torch.Tensor, ln: torch.Tensor):
    """int64 fingerprint of each record ext[st[r] : st[r] + ln[r]]."""
    _check(ext, st, ln)
    if not _on_card(ext, "fingerprint"):
        return fingerprint_plain(ext, st, ln)
    fp = torch.empty(st.numel(), dtype=torch.int64, device=ext.device)
    if st.numel():
        _launch("phrase_fingerprint", ext, ext.data_ptr(), st.data_ptr(),
                ln.data_ptr(), st.numel(), fp.data_ptr())
    return fp


# --- verify --------------------------------------------------------------------

def verify_plain(ext, st, ln, order, head):
    """The number of records order[i] whose bytes differ from head[i]'s,
    over every byte of every record (a head against itself finds none)."""
    _check(ext, st, ln, order, head)
    a, h = order.to(torch.int64), head.to(torch.int64)
    n = ln[a].to(torch.int64)
    which = torch.repeat_interleave(torch.arange(a.numel(), device=ext.device),
                                    n)
    off = torch.arange(which.numel(), device=ext.device) - \
        (torch.cumsum(n, 0) - n)[which]
    diff = (ext[st[a].to(torch.int64)[which] + off]
            != ext[st[h].to(torch.int64)[which] + off])
    per = torch.zeros(a.numel(), dtype=torch.int32, device=ext.device)
    per.index_add_(0, which, diff.to(torch.int32))
    return (per > 0).sum(dtype=torch.int32)


def verify(ext, st, ln, order, head) -> torch.Tensor:
    """0-d int32: how many records order[i] differ from head[i]. A record
    and its head must have the same length."""
    _check(ext, st, ln, order, head)
    if order.numel() != head.numel():
        raise ValueError("order and head must have one entry each")
    if not _on_card(ext, "verify"):
        return verify_plain(ext, st, ln, order, head)
    bad = torch.zeros((), dtype=torch.int32, device=ext.device)
    if order.numel():
        _launch("phrase_verify", ext, ext.data_ptr(), st.data_ptr(),
                ln.data_ptr(), order.data_ptr(), head.data_ptr(),
                order.numel(), bad.data_ptr())
    return bad


# --- tail rank -----------------------------------------------------------------

def tail_rank_plain(ext, st, ln, rec, active, starts, d: int, bucket):
    """The kernel's buckets by sorting each group's byte strings from d on
    in Python (bytes compare as memcmp, then the shorter first)."""
    _check(ext, st, ln, rec, active, starts, bucket)
    host = [t.to("cpu").numpy() for t in (ext, st, ln, rec, active, starts,
                                          bucket)]
    text, st_h, ln_h, rec_h, act_h, starts_h, out = host
    out = out.copy()
    for g in range(starts_h.size - 1):
        members = act_h[starts_h[g]:starts_h[g + 1]]
        base = out[members[0]]
        keys = [text[st_h[r] + d:st_h[r] + ln_h[r]].tobytes()
                for r in rec_h[members]]
        ranked = sorted(keys)
        first = {}
        for i, k in enumerate(ranked):
            first.setdefault(k, i)
        out[members] = [base + first[k] for k in keys]
    bucket.copy_(torch.from_numpy(out))


def tail_rank(ext, st, ln, rec, active, starts, d: int, bucket) -> None:
    """Rank each group of `active` (S-positions) between starts[g] and
    starts[g + 1], tied through depth d, from d on: in place in bucket,
    indexed by S-position (rec maps it to the record). On the card a block
    merge-sorts each group: O(g log^2 g) comparisons for g members."""
    _check(ext, st, ln, rec, active, starts, bucket)
    if starts.numel() < 2:
        return
    if not _on_card(ext, "tail_rank"):
        tail_rank_plain(ext, st, ln, rec, active, starts, d, bucket)
        return
    scratch = torch.empty(2 * active.numel(), dtype=torch.int32,
                          device=ext.device)
    _launch("phrase_tail_rank", ext, ext.data_ptr(), st.data_ptr(),
            ln.data_ptr(), rec.data_ptr(), active.data_ptr(),
            starts.data_ptr(), starts.numel() - 1, active.numel(), int(d),
            bucket.data_ptr(), scratch.data_ptr())

