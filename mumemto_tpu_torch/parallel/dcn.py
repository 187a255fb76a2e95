"""Multi-process placement of MumemtoM partitions.

Port of mumemto_tpu/parallel/dcn.py. The reference's scale-out unit is the
partition: run mumemto with merge metadata once per collection partition,
one host each and no communication, then merge the partition MUM sets
(README.md:124-142; fold core src/merge_candidates.cpp:106-157,211-219).
parallel/mumemtom.py runs that flow inside one process; this module places
it across processes: every process runs the same command,
torch.distributed wires them into one group, the partition assignment is a
function of the rank, a barrier replaces file polling, and rank 0 merges,
with the host fold (analysis/merge.py) or the collective device fold
(parallel/collective_merge.py) on its own device.

The process group's backend is gloo by design: what crosses processes is a
barrier and one boolean per rank, both on the host, and two processes that
share one card cannot form an NCCL group. The scans and the merge run on
each process's `device`. torch.distributed is imported inside the
functions, so importing this module stays cheap.

Assumption (the reference's too): the partition outputs land on a
filesystem that rank 0 can read; the reference's own merge step reads all
partition files on one node the same way.

Tested with real separate processes in tests/test_torch_dcn.py: a
2-process run equals the single-process run_partitioned, byte for byte.
"""

from __future__ import annotations

import datetime
import os

from mumemto_tpu_torch.parallel import mumemtom


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               timeout_seconds: int = 1200) -> None:
    """Wire this process into the multi-process group.

    The arguments default to the MUMEMTO_COORDINATOR ("host:port"),
    MUMEMTO_NUM_PROCESSES and MUMEMTO_PROCESS_ID environment variables;
    with all three absent the group is read from the environment torchrun
    sets (init_method "env://"). Call once per process.

    The timeout is generous on purpose: partition scans are minutes-long
    batch work, so a process may go quiet (a kernel build, host I/O) far
    longer than a training step would."""
    import torch.distributed as dist

    coordinator = coordinator or os.environ.get("MUMEMTO_COORDINATOR")
    if num_processes is None and "MUMEMTO_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["MUMEMTO_NUM_PROCESSES"])
    if process_id is None and "MUMEMTO_PROCESS_ID" in os.environ:
        process_id = int(os.environ["MUMEMTO_PROCESS_ID"])
    timeout = datetime.timedelta(seconds=timeout_seconds)
    if coordinator is None and num_processes is None and process_id is None:
        dist.init_process_group(backend="gloo", init_method="env://",
                                timeout=timeout)
        return
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError(
            "dcn.initialize needs the coordinator, the number of processes "
            "and the process id together (arguments or MUMEMTO_COORDINATOR "
            "/ MUMEMTO_NUM_PROCESSES / MUMEMTO_PROCESS_ID), or none of them")
    dist.init_process_group(backend="gloo",
                            init_method="tcp://" + coordinator,
                            world_size=num_processes, rank=process_id,
                            timeout=timeout)


def barrier(name: str) -> None:
    """Block until every process reaches this point; `name` says which
    point, for a reader of the call."""
    import torch.distributed as dist

    dist.barrier()


def run_partitioned_dcn(files, output_prefix: str, *,
                        anchor: bool = True,
                        num_partitions: int | None = None,
                        min_match_len: int = 20,
                        use_revcomp: bool = True,
                        collective: bool = False,
                        verbose: bool = False, device="cuda") -> str:
    """SPMD MumemtoM: every process calls this with identical arguments.

    Partitioning is deterministic (mumemtom.auto_partition), so each
    process derives the same partition list and claims the indices rank,
    rank + P, ...; nothing is exchanged until the barrier after the scans,
    which gathers each rank's outcome: a scan that raised on one rank
    raises on every rank. Rank 0 then merges (the host fold, or with
    collective=True the device fold) and every process returns the merged
    path once that outcome has been gathered too. Scans and merge run on
    `device`.

    The process group must be initialized first (see initialize())."""
    import torch.distributed as dist

    rank = dist.get_rank()
    nproc = dist.get_world_size()
    parts = mumemtom.auto_partition(
        list(files), num_partitions or nproc, anchor=anchor)

    part_mums = []
    scan_err = None
    for i, pfiles in enumerate(parts):
        pfx = f"{output_prefix}_part{i}"
        part_mums.append(pfx + ".mums")
        if i % nproc == rank and scan_err is None:
            try:
                mumemtom.scan_partition(pfiles, pfx, anchor=anchor,
                                        min_match_len=min_match_len,
                                        use_revcomp=use_revcomp,
                                        verbose=verbose, device=device)
            except Exception as e:  # noqa: BLE001 (gathered before raising)
                scan_err = e

    # the barrier after the scans carries each rank's outcome (a deliberate
    # difference from the JAX module, whose plain barrier leaves the other
    # ranks waiting for a rank whose scan raised until the timeout)
    _raise_everywhere(dist, scan_err, "partition scan")

    merged = output_prefix + ".mums"
    merge_err = None
    if rank == 0:
        try:
            mumemtom.merge_partition_outputs(part_mums, output_prefix,
                                             collective=collective,
                                             device=device)
        except Exception as e:  # noqa: BLE001 (gathered before raising)
            merge_err = e
    # gather the merge outcome (which doubles as the final barrier), so a
    # failure on rank 0 raises everywhere instead of stranding the other
    # ranks until the timeout buries the real error
    _raise_everywhere(dist, merge_err, "merge")
    return merged


def _raise_everywhere(dist, err, what: str) -> None:
    """Gather every rank's outcome of `what` (a barrier too): a rank that
    failed raises its own error, the others name the ranks that did."""
    ok = [None] * dist.get_world_size()
    dist.all_gather_object(ok, err is None)
    if err is not None:
        raise err
    if not all(ok):
        failed = ", ".join(str(r) for r, good in enumerate(ok) if not good)
        raise RuntimeError(f"{what} failed on process {failed}; see its log")
