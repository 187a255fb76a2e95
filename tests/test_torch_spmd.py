"""The port's mesh programs run the way shard_map runs them: one host thread
per distinct device of a mesh (parallel/mesh.run_per_device), every thread
working its own shards while the others work theirs.

Here the CPU has two names, "cpu" and "cpu:0", which compare unequal as
torch devices: a mesh that uses both runs two real worker threads, so the
cross-device branches (the sort's pair exchanges, the halos, the tables'
copies) run concurrently. The sharded scan on such meshes is held against
the port's single-device engine and against the JAX package's sharded scan
on its 8-device CPU mesh; the partition program against the JAX package's
on the same numpy stacks. Inputs come from seeded numpy generators.
Tolerance: none, integers and bytes are equal. A gpu-marked case checks on
the cards that each worker launches its work on its shard's card.
"""

import importlib
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax

from mumemto_tpu import options
from mumemto_tpu.parallel import seqpfp as jax_seqpfp
from mumemto_tpu_torch import cli as t_cli
from mumemto_tpu_torch import device as t_device
from mumemto_tpu_torch import engine as t_engine
from mumemto_tpu_torch import trace
from mumemto_tpu_torch.ops import pfp as t_pfp
from mumemto_tpu_torch.ops.pfp import ScanSizeError
from mumemto_tpu_torch.parallel import mesh, mumemtom, partition, seqpfp
from mumemto_tpu_torch.parallel import widepfp
from mumemto_tpu_torch.parallel.partition import WindowCapacityError
from conftest import build, mutated_collection, rand_seq
import test_torch_partition as pt

# several test workers share the machine's cores
torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
CPU0 = torch.device("cpu", 0)

# two-name meshes: shards alternate between the names, or the first half
# sits on one name and the second on the other (so some sort rounds pair
# shards of one name and others pair the two names)
LAYOUTS = {
    "alternating": lambda n: [CPU0 if i % 2 else CPU for i in range(n)],
    "halves": lambda n: [CPU0 if i >= n // 2 else CPU for i in range(n)],
}


def _in_time(fn, limit=60.0):
    """fn() on a thread of its own, which must end within `limit` seconds;
    returns (result, exception)."""
    out = {}

    def run():
        try:
            out["result"] = fn()
        except BaseException as e:
            out["error"] = e
    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(limit)
    assert not t.is_alive(), f"did not end within {limit} s"
    return out.get("result"), out.get("error")


def _no_mesh_threads():
    return not any(t.name.startswith("mesh ") for t in threading.enumerate())


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------

def test_runner_order_and_one_thread_per_device():
    devices = LAYOUTS["alternating"](6) + [CPU0, CPU]
    seen = []

    def fn(x):
        seen.append((x, threading.current_thread()))
        return 10 * x
    assert mesh.run_per_device(fn, range(8), devices) == \
        [10 * x for x in range(8)]
    ident = dict(seen)
    threads = {}
    for i, dev in enumerate(devices):
        threads.setdefault(dev, set()).add(ident[i])
    assert all(len(v) == 1 for v in threads.values())
    assert len({next(iter(v)) for v in threads.values()}) == 2
    assert threading.current_thread() not in ident.values()
    # each device's items ran in item order on its thread
    for dev, (tid,) in threads.items():
        assert [x for x, t in seen if t == tid] == \
            [i for i, d in enumerate(devices) if d == dev]
    assert _no_mesh_threads()


@pytest.mark.parametrize("devices", [[CPU] * 4, [CPU0] * 3, [CPU], []],
                         ids=["cpu x4", "cpu:0 x3", "one", "none"])
def test_runner_one_device_runs_inline(devices):
    seen = []
    got = mesh.run_per_device(
        lambda x: seen.append(threading.current_thread()) or x + 1,
        range(len(devices)), devices)
    assert got == list(range(1, len(devices) + 1))
    assert set(seen) <= {threading.current_thread()}


def test_runner_refuses_unequal_lengths():
    with pytest.raises(ValueError, match="3 items for 2 devices"):
        mesh.run_per_device(lambda x: x, range(3), [CPU, CPU0])


@pytest.mark.parametrize("exc", [
    torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate "
                                "2.00 GiB"),
    WindowCapacityError("seq-sharded scan: 9 matches exceed the window "
                        "capacity M=4; rerun with M >= 9"),
    ScanSizeError("row spaces past 2^31 need the block (wide) scan"),
    KeyError("x")], ids=lambda e: type(e).__name__)
def test_runner_raises_the_lowest_failing_shard(exc):
    """Shards 1 (on cpu:0) and 2 (on cpu) both fail, at the same moment:
    the caller gets shard 1's exception, the very object, type unchanged,
    after every thread has ended."""
    both = threading.Barrier(2)

    def fn(i):
        if i in (1, 2):
            both.wait(timeout=30)
            raise exc if i == 1 else RuntimeError("shard 2")
        return i
    _, err = _in_time(lambda: mesh.run_per_device(
        fn, range(4), LAYOUTS["alternating"](4)))
    assert err is exc
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        assert t_cli._is_device_oom(err) and t_cli._too_big(err)
    assert _no_mesh_threads()


def test_runner_aborts_barriers_for_a_failed_peer():
    """Shard 0 waits at a barrier for shard 1, which fails first: the
    runner aborts the barrier, so shard 0 is released (no hang), and the
    caller gets shard 1's error, not shard 0's BrokenBarrierError. The
    failed thread runs none of its later items."""
    meet = threading.Barrier(2)
    ran = []

    def fn(i):
        ran.append(i)
        if i == 1:
            raise ValueError("shard 1 failed")
        if i == 0:
            meet.wait()        # no timeout: only the abort releases it
        return i
    t0 = time.perf_counter()
    _, err = _in_time(lambda: mesh.run_per_device(
        fn, range(4), [CPU, CPU0, CPU, CPU0], barriers=[meet]), limit=30)
    assert isinstance(err, ValueError) and str(err) == "shard 1 failed"
    assert meet.broken and 3 not in ran and 2 not in ran
    assert time.perf_counter() - t0 < 30
    assert _no_mesh_threads()


def test_runner_raises_broken_barrier_only_when_alone():
    meet = threading.Barrier(2)

    def fn(i):
        if i == 1:
            meet.abort()
        return meet.wait(timeout=30)
    _, err = _in_time(lambda: mesh.run_per_device(
        fn, range(2), [CPU, CPU0], barriers=[meet]))
    assert isinstance(err, threading.BrokenBarrierError)


def test_runner_stress_exchange():
    """More threads than cores, a short switch interval: 16 "devices"
    exchange values around a ring through a shared list and a barrier
    for 200 rounds; a lost or early read changes the sums."""
    n, rounds = 16, 200
    meet = threading.Barrier(n)
    slots = [[0] * n for _ in range(2)]

    def fn(d):
        total = 0
        for r in range(rounds):
            slots[r % 2][d] = d * r
            meet.wait(timeout=60)
            total += slots[r % 2][(d + 1) % n]
        return total
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got, err = _in_time(lambda: mesh.run_per_device(
            fn, range(n), list(range(n)), barriers=[meet]), limit=120)
    finally:
        sys.setswitchinterval(old)
    assert err is None
    assert got == [((d + 1) % n) * rounds * (rounds - 1) // 2
                   for d in range(n)]


# ---------------------------------------------------------------------------
# the block sort
# ---------------------------------------------------------------------------

def _tied_blocks(nshards, devices, B=64, seed=7):
    g = np.random.default_rng(seed)
    n = nshards * B
    key1 = g.integers(-1, 3, n).astype(np.int32)
    key2 = np.where(key1 < 0, 0, g.integers(0, 4, n)).astype(np.int32)
    row = np.arange(n, dtype=np.int64)
    return [tuple(torch.from_numpy(a[i * B:(i + 1) * B].copy()).to(
        devices[i]) for a in (key1, key2, row)) for i in range(nshards)]


def _flat(blocks):
    return [np.concatenate([b[k].numpy() for b in blocks])
            for k in range(len(blocks[0]))]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("nshards", [2, 4, 8, 16])
def test_block_sort_with_ties_is_deterministic(layout, nshards):
    """Ten runs in a row on a two-name mesh give the same rows in the same
    order, globally ascending, equal to the one-device network's."""
    devices = LAYOUTS[layout](nshards)
    want = _flat(seqpfp._bitonic_block_sort(
        _tied_blocks(nshards, [CPU] * nshards), [CPU] * nshards))
    key = (want[0].astype(np.int64) + 1) * 2**32 + want[1]
    assert (np.diff(key) >= 0).all()
    assert np.array_equal(np.sort(want[2]), np.arange(want[2].size))
    for _ in range(10):
        blocks = _tied_blocks(nshards, devices)
        got = seqpfp._bitonic_block_sort(blocks, devices)
        assert all(np.array_equal(a, b) for a, b in zip(_flat(got), want))
    assert _no_mesh_threads()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_block_sort_releases_unsorted_blocks_on_threads(monkeypatch, layout):
    """F8 on two threads: when the merge rounds start, no unsorted operand
    is alive, also while the caller holds the list."""
    import gc
    import weakref
    nshards, B = 4, 64
    devices = LAYOUTS[layout](nshards)
    blocks = _tied_blocks(nshards, devices, B)
    refs = [weakref.ref(op) for ops in blocks for op in ops]
    alive_at_merge = []
    real = t_pfp._sort_rows
    lock = threading.Lock()

    def sort_rows(ops, num_keys=2):
        with lock:
            if ops[0].shape[0] == 2 * B and not alive_at_merge:
                gc.collect()
                alive_at_merge.append(sum(r() is not None for r in refs))
        return real(ops, num_keys)
    monkeypatch.setattr(t_pfp, "_sort_rows", sort_rows)
    out = seqpfp._bitonic_block_sort(blocks, devices)
    assert alive_at_merge == [0]
    k = _flat(out)
    assert (np.diff((k[0].astype(np.int64) + 1) * 2**32 + k[1]) >= 0).all()


def test_block_sort_releases_local_merges(monkeypatch):
    """A merge of two shards of one device leaves no reference to itself
    on its thread: once a later round has replaced both halves, its
    storage goes (on the cards, each card kept one more block's worth
    alive through the cross rounds otherwise). Alternating 8 shards:
    "cpu"'s 6th merge is its last local one of round 2, its 11th the
    first of round 4, after the cross round that replaced the halves
    (each thread merges 18 times: 4 + 2 + 4 + 2 + 2 + 4)."""
    import gc
    import weakref
    devices = LAYOUTS["alternating"](8)
    real = t_pfp._sort_rows
    calls = {}
    local = []
    alive = []
    peer_in_round_4 = threading.Event()

    def sort_rows(ops, num_keys=2):
        if ops[0].shape[0] != 128:
            return real(ops, num_keys)
        name = threading.current_thread().name
        calls[name] = calls.get(name, 0) + 1
        if name == f"mesh {CPU0}" and calls[name] == 11:
            peer_in_round_4.set()
        if name == f"mesh {CPU}" and calls[name] == 11:
            # the peer is past its cross pairs: none of its locals holds
            # one of our blocks any more
            assert peer_in_round_4.wait(timeout=30)
            gc.collect()
            alive.append(local[0]() is not None)
        out = real(ops, num_keys)
        if name == f"mesh {CPU}" and calls[name] == 6:
            local.append(weakref.ref(out[0]))
        return out
    monkeypatch.setattr(t_pfp, "_sort_rows", sort_rows)
    got, err = _in_time(lambda: seqpfp._bitonic_block_sort(
        _tied_blocks(8, devices), devices))
    monkeypatch.undo()
    assert err is None and calls == {f"mesh {CPU}": 18, f"mesh {CPU0}": 18}
    assert alive == [False]
    want = _flat(seqpfp._bitonic_block_sort(_tied_blocks(8, [CPU] * 8),
                                            [CPU] * 8))
    assert all(np.array_equal(a, b) for a, b in zip(_flat(got), want))


def test_block_sort_failure_releases_the_partner(monkeypatch):
    """A merge that fails on one side of a cross-device pair aborts the
    partners' meeting points: the other side does not hang, and the
    caller gets the merge's error."""
    nshards = 4
    devices = LAYOUTS["alternating"](nshards)
    real = t_pfp._sort_rows
    calls = []

    def sort_rows(ops, num_keys=2):
        if threading.current_thread().name == f"mesh {CPU0}" and \
                ops[0].shape[0] == 128:
            calls.append(1)
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")
        return real(ops, num_keys)
    monkeypatch.setattr(t_pfp, "_sort_rows", sort_rows)
    _, err = _in_time(lambda: seqpfp._bitonic_block_sort(
        _tied_blocks(nshards, devices), devices), limit=30)
    assert isinstance(err, torch.cuda.OutOfMemoryError) and calls
    assert _no_mesh_threads()


# ---------------------------------------------------------------------------
# the sharded scan on two-name meshes
# ---------------------------------------------------------------------------

def _jax_mesh(nshards):
    devs = np.asarray(jax.devices()[:nshards]).reshape(nshards)
    return jax.sharding.Mesh(devs, ("seq",))


# the shard of a stage's call, from its positional arguments: stage A's
# base row i * B and B, stage C's i, stage D's base row and B
SHARD_OF = {"_block_operands": lambda a: a[0] // a[10],
            "_analyze_block": lambda a: a[2],
            "_compact_block": lambda a: a[3] // a[4]}


def _compare(rb, opts, devices, M=4096):
    want = t_engine.find_matches(rb, opts, device="cpu")
    got = seqpfp.find_matches_seq_sharded(rb, opts, devices, M=M)
    assert got.output_bytes() == want.output_bytes() != b""
    assert got.bwt_runs == want.bwt_runs
    assert got.text_length == want.text_length
    return want, got


@pytest.mark.parametrize("layout,nshards", [
    ("alternating", 2), ("alternating", 4), ("halves", 4),
    ("alternating", 8), ("halves", 8)])
def test_shard_sweep_two_names(rng, layout, nshards):
    rb = build(mutated_collection(rng, 4, base_len=900))
    opts = options.normalize(rb.num_docs, quiet=True)
    _compare(rb, opts, LAYOUTS[layout](nshards))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_mems_two_names(rng, layout):
    rep = rand_seq(rng, 60)
    rb = build(mutated_collection(rng, 4, base_len=500, insert_rep=rep))
    opts = options.normalize(rb.num_docs, rare_freq=2, quiet=True)
    _compare(rb, opts, LAYOUTS[layout](4))


def test_merge_metadata_two_names(rng):
    rb = build(mutated_collection(rng, 3, base_len=800))
    opts = options.normalize(rb.num_docs, merge=True, quiet=True)
    single, sharded = _compare(rb, opts, LAYOUTS["halves"](8))
    assert (single.candidate_thresh == sharded.candidate_thresh).all()
    dl0 = int(t_engine._doc_metadata(rb, opts)[1][0])
    for a, b in zip(t_engine.thresh_arrays(single, dl0),
                    t_engine.thresh_arrays(sharded, dl0)):
        assert a.any() and np.array_equal(a, b)


def test_cap256_walk_two_names(rng):
    """132 docs in MUM mode: size cap 256, the probe-guarded walks on two
    threads."""
    cores = [rand_seq(rng, 45) for _ in range(3)]
    docs = [["".join(rand_seq(rng, 40) + c for c in cores)
             + rand_seq(rng, 40)] for _ in range(132)]
    rb = build(docs)
    opts = options.normalize(rb.num_docs, quiet=True)
    assert t_engine.interval_size_cap(opts, rb.num_docs) == 256
    _compare(rb, opts, LAYOUTS["alternating"](4))


@pytest.mark.parametrize("kw,nshards,layout", [
    ({}, 4, "alternating"), ({}, 8, "halves"),
    ({"rare_freq": 2}, 2, "alternating"), ({"merge": True}, 4, "halves")])
def test_matches_jax_seq_sharded_two_names(rng, kw, nshards, layout):
    """The port on a two-name mesh (two threads) against the JAX package's
    sharded scan on its 8-device CPU mesh and the port's single-device
    engine."""
    rep = rand_seq(rng, 60)
    rb = build(mutated_collection(rng, 4, base_len=500,
                                  insert_rep=rep if "rare_freq" in kw
                                  else None))
    opts = options.normalize(rb.num_docs, quiet=True, **kw)
    want = jax_seqpfp.find_matches_seq_sharded(rb, opts, _jax_mesh(nshards))
    _, got = _compare(rb, opts, LAYOUTS[layout](nshards))
    assert got.output_bytes() == want.output_bytes()
    assert got.bwt_runs == want.bwt_runs


def test_worker_threads_and_phase_hook(rng, monkeypatch):
    """Stages A, C and D of each shard run on its device's thread, each
    device's shards in shard order; the phase hook runs on the caller's
    thread only, once a stage."""
    rb = build(mutated_collection(rng, 3, base_len=400))
    opts = options.normalize(rb.num_docs, quiet=True)
    devices = LAYOUTS["halves"](8)
    seen = {name: [] for name in SHARD_OF}
    for name, shard in SHARD_OF.items():
        real = getattr(widepfp, name)

        def spy(*a, _real=real, _name=name, _shard=shard, **kw):
            seen[_name].append((_shard(a), threading.current_thread().name))
            return _real(*a, **kw)
        monkeypatch.setattr(widepfp, name, spy)
    hooks = []
    seqpfp.find_matches_seq_sharded(
        rb, opts, devices,
        phase=lambda name: hooks.append(
            (name, threading.current_thread())))
    me = threading.current_thread()
    assert {t for _, t in hooks} == {me}
    assert [n for n, _ in hooks] == ["build_pfp", "dict_index", "parse_side",
                                    "operands", "sort", "analyze",
                                    "assemble"]
    for name, calls in seen.items():
        by_thread = {}
        for i, t in calls:
            by_thread.setdefault(t, []).append(i)
        assert by_thread == {f"mesh {CPU}": [0, 1, 2, 3],
                             f"mesh {CPU0}": [4, 5, 6, 7]}, name


@pytest.mark.parametrize("where,exc", [
    ("_analyze_block", torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 4.00 GiB")),
    ("_compact_block", WindowCapacityError("shard 3 (test)")),
    ("_block_operands", ScanSizeError("shard 3 (test)"))],
    ids=["oom", "capacity", "size"])
def test_worker_errors_reach_the_caller(rng, monkeypatch, where, exc):
    """A stage that fails on shard 3's thread fails the call with that
    exception, its type unchanged, with every thread joined."""
    rb = build(mutated_collection(rng, 3, base_len=400))
    opts = options.normalize(rb.num_docs, quiet=True)
    real = getattr(widepfp, where)

    def failing(*a, **kw):
        if SHARD_OF[where](a) == 3:
            raise exc
        return real(*a, **kw)
    monkeypatch.setattr(widepfp, where, failing)
    with pytest.raises(type(exc)) as got:
        seqpfp.find_matches_seq_sharded(rb, opts, LAYOUTS["alternating"](4))
    assert got.value is exc
    assert _no_mesh_threads()


def _write_fastas(tmp_path, docs):
    paths = []
    for i, d in enumerate(docs):
        p = tmp_path / f"g{i}.fa"
        p.write_text(f">g{i}\n{d[0]}\n")
        paths.append(str(p))
    return paths


def test_worker_oom_takes_the_cli_fallback(rng, tmp_path, monkeypatch,
                                           capsys):
    """--seq-shards over a two-name mesh: a device out-of-memory error on
    one worker reaches cli.build_main, which falls back to MumemtoM
    partitions; the files equal a direct 2-partition anchor run's."""
    paths = _write_fastas(tmp_path, mutated_collection(rng, 4, base_len=600))
    monkeypatch.setattr(t_cli, "_seq_mesh",
                        lambda n, device: LAYOUTS["alternating"](n))
    real = widepfp._analyze_block

    def oom_on_shard_2(*a, **kw):
        if a[2] == 2:
            raise torch.cuda.OutOfMemoryError(
                "CUDA out of memory. Tried to allocate 4.00 GiB")
        return real(*a, **kw)
    monkeypatch.setattr(widepfp, "_analyze_block", oom_on_shard_2)
    out = str(tmp_path / "sh")
    assert t_cli.main(paths + ["-o", out, "--seq-shards", "4",
                               "--device", "cpu"]) == 0
    err = capsys.readouterr().err
    assert "device OOM on the union scan" in err
    assert "partitioned fallback succeeded" in err
    monkeypatch.setattr(widepfp, "_analyze_block", real)
    ref = str(tmp_path / "ref")
    mumemtom.run_partitioned_files(paths, ref, num_partitions=2,
                                   anchor=True, device="cpu")
    for ext in (".mums", ".athresh", ".lengths"):
        a = open(ref + ext, "rb").read()
        assert a and open(out + ext, "rb").read() == a, ext


# ---------------------------------------------------------------------------
# the partition program
# ---------------------------------------------------------------------------

def test_partitioned_matches_two_names(monkeypatch):
    """A four-entry two-name mesh (2 x 2): partition p on devices[p % 4],
    so both names get partitions, each name's on its own thread; the
    windows equal JAX's and the bytes the direct backend's."""
    texts, doc_ends, rbs, want = pt._jax_matches()
    pmesh = partition.make_mesh(devices=LAYOUTS["alternating"](4))
    assert pmesh.shape == (2, 2)
    assert [pmesh.part_device(p) for p in range(4)] == \
        LAYOUTS["alternating"](4)
    thread_of = {}
    real = partition._partition_scan_matches

    def spy(text, *a):
        p, = [p for p in range(4) if np.array_equal(text.numpy(), texts[p])]
        thread_of[p] = threading.current_thread()
        return real(text, *a)
    monkeypatch.setattr(partition, "_partition_scan_matches", spy)
    fn = partition.compile_partitioned_matches(pmesh, pt.NUM_DOCS, M=pt.M)
    got = [x.numpy() for x in fn(texts, doc_ends)]
    assert thread_of[0] == thread_of[2] != thread_of[1] == thread_of[3]
    assert threading.current_thread() not in thread_of.values()
    assert got[0].tolist() == want[0].tolist()
    for p in range(4):
        pt._same_windows([a[p] for a in want], [a[p] for a in got], p)
        mine, engine_bytes = pt._emitted(rbs[p], *(a[p] for a in got))
        assert mine == engine_bytes != b"", p


def test_partitioned_step_two_names():
    """partitioned_step on the two-name 2 x 2 mesh equals the one-device
    mesh's, partition for partition, and the match program's counts."""
    texts, doc_ends, _rbs, matches = pt._jax_matches()
    one = partition.partitioned_step(
        texts, doc_ends, pt.NUM_DOCS, mesh=partition.make_mesh(
            devices=[CPU] * 4))
    two = partition.partitioned_step(
        texts, doc_ends, pt.NUM_DOCS, mesh=partition.make_mesh(
            devices=LAYOUTS["alternating"](4)))
    assert all(a.tolist() == b.tolist() for a, b in zip(one, two))
    assert int(two[0]) > 0 and two[1].device == CPU
    strict = partition.partitioned_step(
        texts, doc_ends, pt.NUM_DOCS, num_distinct=pt.NUM_DOCS,
        mesh=partition.make_mesh(devices=LAYOUTS["alternating"](4)))[1]
    assert strict.tolist() == matches[0].tolist()


def test_partition_window_capacity_on_threads():
    texts, doc_ends, _rbs, want = pt._jax_matches()
    fn = partition.compile_partitioned_matches(
        partition.make_mesh(devices=LAYOUTS["alternating"](4)), pt.NUM_DOCS,
        M=4)
    with pytest.raises(WindowCapacityError,
                       match=f"{want[0].max()} matches .* M=4"):
        fn(texts, doc_ends)


# ---------------------------------------------------------------------------
# chip_smoke's named rows s and p, rehearsed on the CPU
# ---------------------------------------------------------------------------

def test_named_rows_s_p_rehearsal(monkeypatch):
    """`chip_smoke.py --cards s p` at 0.06 Mbp a tier, with the stand-ins
    of tests/test_torch_cards.py ("cuda:r" resolves to the CPU, torch.cuda
    counts nothing, the KR wrapper and the running max / min count a
    launch around their plain versions): the rows' control flow, checks
    and record."""
    from mumemto_tpu_torch.kernels import kr_mask
    from test_torch_scale import _count_scans, _NoCard, _TorchOnCpu
    sys.path.insert(0, ROOT)
    try:
        chip_smoke = importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(ROOT)

    def on_cpu(device):
        return CPU

    def counted_plain(ext, n_real, w, mod):
        trace.count(kr_mask.COUNTER)
        return kr_mask.break_mask_plain(ext, n_real, w, mod)

    class NoCard(_NoCard):
        def is_available(self):
            return False

    class TorchOnCpu(_TorchOnCpu):
        cuda = NoCard()
    for mod in (t_engine, t_device, mesh):
        monkeypatch.setattr(mod, "resolve", on_cpu)
    monkeypatch.setattr(kr_mask, "break_mask", counted_plain)
    _count_scans(monkeypatch)
    report = {}
    chip_smoke.phase_wide(TorchOnCpu(), report, ("p", "s"),
                          s_mbp=(0.03, 0.06), p_doc_mbp=0.004, p_runs=2)
    rows = report["rows"]
    assert list(rows) == ["s", "p"]
    runs = rows["s"]["runs"]
    assert [(r["input"], r["shards"]) for r in runs] == [
        (f"bench {m:g} Mbp", n) for m in (0.03, 0.06) for n in (1, 8, 8, 8)]
    assert all(r["bytes_equal"] for r in runs if r["shards"] > 1)
    assert all(r["launches"]["running_scan"] > 0 for r in runs)
    assert [t["window"] for t in rows["s"]["traces"]] == [
        "whole call", "shard stages"] * 2
    assert all(t["bytes_equal"] for t in rows["s"]["traces"])
    p = rows["p"]
    assert p["ran_on"] == ["cpu"] * 4 and p["threads"] == 1
    assert len(p["walls_s"]) == len(p["run_peaks"]) == 2


# ---------------------------------------------------------------------------
# on the cards (skipped here)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("nshards", [4, 8])
def test_cuda_workers_on_their_cards(rng, monkeypatch, nshards):
    """The shards spread over every visible card: inside the runner each
    worker's current device is its shard's card and its current stream
    the caller's, through stages A, C and D; the sharded bytes equal
    those of the same scan with every shard on cuda:0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    devices = mesh.seq_devices(nshards, "cuda")
    caller = {d: torch.cuda.current_stream(d).cuda_stream
              for d in set(devices)}
    got = mesh.run_per_device(
        lambda i: (torch.cuda.current_device(),
                   torch.cuda.current_stream().cuda_stream),
        range(nshards), devices)
    assert got == [(d.index, caller[d]) for d in devices]
    rb = build(mutated_collection(rng, 4, base_len=20000, n_mut=30))
    opts = options.normalize(rb.num_docs, quiet=True)
    seen = []
    for name, shard in SHARD_OF.items():
        real = getattr(widepfp, name)

        def spy(*a, _real=real, _name=name, _shard=shard, **kw):
            seen.append((_name, _shard(a), torch.cuda.current_device()))
            return _real(*a, **kw)
        monkeypatch.setattr(widepfp, name, spy)
    spread = seqpfp.find_matches_seq_sharded(rb, opts, devices, M=1 << 16)
    monkeypatch.undo()
    assert len(seen) == 3 * nshards
    assert all(card == devices[i].index for _, i, card in seen), seen
    one = seqpfp.find_matches_seq_sharded(
        rb, opts, mesh.seq_devices(nshards, "cuda:0"), M=1 << 16)
    assert spread.output_bytes() == one.output_bytes() != b""
    assert spread.bwt_runs == one.bwt_runs
