"""The port's "mesh": a list of torch devices, one per shard, which may
repeat, and the way a mesh program runs on it.

The JAX package's sharded programs (parallel/seqpfp, widepfp, partition,
collective_merge) are single-process programs over a mesh of devices. Here
a mesh is a plain list: shard i lives on devices[i], and a per-shard array
is a list of tensors, one per shard, each on its shard's device. A device
may hold several shards (on one card all of them), so a run never needs as
many devices as shards, and the JAX package's "--seq-shards N needs that
many devices" error has no counterpart.

run_per_device is the counterpart of shard_map's "every device runs its
body": one host thread per distinct device launches the work of that
device's shards, in shard order, while the other devices' threads launch
theirs. PyTorch releases the interpreter lock inside its operators, so the
host syncs of one shard's stages (a nonzero, a count read back) hold up
only its own device; the threads still take turns at the lock between
operators, which costs more than the overlap gains where a stage is many
short operators (small blocks) and less where its operators are long
(PERF.md has both). A mesh of one distinct device runs on the caller's
thread. The exchanges between shards are functions over the lists; a
stage that reads another shard's block meets that shard's thread at a
barrier first. There are no process groups and no environment variables.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from mumemto_tpu_torch.device import resolve


def check_shards(nshards: int, what: str = "--seq-shards") -> None:
    if nshards <= 0 or nshards & (nshards - 1):
        raise ValueError(f"{what} must be a positive power of two, "
                         f"got {nshards}")


def spread(nshards: int, device="cuda") -> list:
    """One device per shard: the CPU nshards times, or the visible CUDA
    cards round-robin (cuda:0 .. cuda:k-1, cuda:0 ..). An indexed device
    ("cuda:1") holds every shard."""
    dev = resolve(device)
    if dev.type == "cuda" and dev.index is None:
        k = torch.cuda.device_count()
        return [torch.device("cuda", i % k) for i in range(nshards)]
    return [dev] * nshards


def seq_devices(nshards: int, device="cuda",
                what: str = "--seq-shards") -> list:
    """The mesh of a sharded scan: spread() over a power-of-two shard
    count."""
    check_shards(nshards, what)
    return spread(nshards, device)


def ppermute(blocks: list, perm, devices: list) -> list:
    """out[dst] = blocks[src] on devices[dst] for every (src, dst) of perm;
    shards that receive nothing get None. No copy is made between two
    shards of one device."""
    out = [None] * len(blocks)
    for src, dst in perm:
        out[dst] = blocks[src].to(devices[dst])
    return out


def all_gather(blocks: list, device) -> torch.Tensor:
    """The per-shard tensors stacked on `device`, shard-major."""
    return torch.stack([b.to(device) for b in blocks])


def psum(blocks: list, device) -> torch.Tensor:
    """The sum of the per-shard tensors on `device`."""
    return all_gather(blocks, device).sum(dim=0)


def place(tables: dict, device) -> dict:
    """`tables` on `device`: a dict of names to tensors, lists or tuples of
    tensors, or plain values."""
    def move(v):
        if isinstance(v, torch.Tensor):
            return v.to(device)
        if isinstance(v, (list, tuple)):
            return type(v)(move(x) for x in v)
        return v
    return {k: move(v) for k, v in tables.items()}


def replicate(tables: dict, devices: list) -> dict:
    """{device: place(tables, device)} for each distinct device."""
    return {dev: place(tables, dev) for dev in dict.fromkeys(devices)}


@contextlib.contextmanager
def _on_device(dev, streams):
    """The caller's current stream on every card of the mesh (`streams`),
    and `dev` as the current device when it is a card: a worker thread
    launches work as the caller's thread would. A copy from another card
    runs on that card's current stream, so every thread sees the same
    one."""
    with contextlib.ExitStack() as stack:
        for s in streams:
            stack.enter_context(torch.cuda.stream(s))
        if isinstance(dev, torch.device) and dev.type == "cuda":
            stack.enter_context(torch.cuda.device(dev))
        yield


def run_per_device(fn, items, devices, barriers=()) -> list:
    """[fn(x) for x in items], item i run on devices[i]'s thread: one
    thread per distinct device, which runs that device's items in item
    order under torch.cuda.device(card) on the caller's current streams.
    The threads of different devices run at the same time; every one is
    joined before this returns or raises. With one distinct device the
    items run on the caller's thread.

    A failing item stops its thread; the others stop before their next
    item, and every barrier of `barriers` (threading.Barrier, shared by
    the threads for their exchanges) is aborted, so no thread waits for a
    peer that is gone. The exception of the lowest failing item is raised
    here, its type unchanged (a peer's BrokenBarrierError counts only
    when nothing else failed)."""
    items = list(items)
    if len(items) != len(devices):
        raise ValueError(f"{len(items)} items for {len(devices)} devices")
    order = {}
    for i, dev in enumerate(devices):
        order.setdefault(dev, []).append(i)
    streams = [torch.cuda.current_stream(d) for d in order
               if isinstance(d, torch.device) and d.type == "cuda"]
    if len(order) <= 1:
        with _on_device(devices[0] if devices else None, streams):
            return [fn(x) for x in items]
    results = [None] * len(items)
    errors = {}

    def fail(i, e):
        errors[i] = e
        for b in barriers:
            b.abort()

    def work(dev):
        with _on_device(dev, streams):
            for i in order[dev]:
                if errors:
                    return
                try:
                    results[i] = fn(items[i])
                except BaseException as e:  # re-raised on the caller's thread
                    fail(i, e)
                    return

    threads = [threading.Thread(target=work, args=(dev,),
                                name=f"mesh {dev}") for dev in order]
    for t in threads:
        t.start()
    try:
        for t in threads:
            t.join()
    except BaseException as e:  # the caller interrupted: stop the threads
        fail(len(items), e)
        for t in threads:
            t.join()
        raise
    if errors:
        first = min(errors, key=lambda i: (
            isinstance(errors[i], threading.BrokenBarrierError), i))
        err = errors[first]
        # the other items' partial results and tracebacks go now
        errors.clear()
        results.clear()
        raise err
    return results

