"""The port's "mesh": a list of torch devices, one per shard, which may
repeat.

The JAX package's sharded programs (parallel/seqpfp, widepfp,
collective_merge) are single-process programs over a mesh of devices. Here
a mesh is a plain list: shard i lives on devices[i], and a per-shard array
is a list of tensors, one per shard, each on its shard's device. A device
may hold several shards (on one card all of them); their work then runs one
shard after another on that device, with the same results. So a run never
needs as many devices as shards, and the JAX package's "--seq-shards N
needs that many devices" error has no counterpart.

The three exchanges the sharded programs use are functions over such lists.
There are no process groups and no environment variables.
"""

from __future__ import annotations

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


def replicate(tables: dict, devices: list) -> dict:
    """{device: tables on that device} for each distinct device; `tables`
    maps names to tensors, lists or tuples of tensors, or plain values."""
    def move(v, dev):
        if isinstance(v, torch.Tensor):
            return v.to(dev)
        if isinstance(v, (list, tuple)):
            return type(v)(move(x, dev) for x in v)
        return v
    return {dev: {k: move(v, dev) for k, v in tables.items()}
            for dev in dict.fromkeys(devices)}
