"""MumemtoM orchestration: partitioned multi-MUM finding + merge, one call.

A copy of mumemto_tpu/parallel/mumemtom.py, which imports the JAX
package's engine, with each partition's scan on the port's engine and the
merge through the port's `merge` subcommand, all on one `device`:

    merged = run_partitioned(partitions, out_prefix, anchor=True)

The reference's scale-out story (README.md:124-142) is operational: run
`mumemto -M [-n]` once per collection partition, then `mumemto merge`.
Each partition runs the full engine with merge metadata; the outputs are
combined with the anchor or string merging scheme (analysis/merge.py).
The invariant merge(partitions) == run-on-union is the tested contract.
collective=True runs the anchor fold on the device
(parallel/collective_merge.py).
"""

from __future__ import annotations

import os

from mumemto_tpu_torch import options, refbuilder
from mumemto_tpu_torch import engine
from mumemto_tpu_torch.analysis import merge as merge_mod


def auto_partition(files, num_partitions: int, anchor: bool = True):
    """Split a collection into partitions.

    anchor=True: the first file is the shared anchor sequence, prepended to
    every partition (anchor merging requires an identical first sequence
    per partition, merge_candidates.cpp:211-219). anchor=False: disjoint
    round-robin split (string merging).
    """
    if num_partitions < 2:
        return [list(files)]
    if anchor:
        # a partition of [anchor] alone carries no extra docs — dropping
        # it loses nothing (the anchor is in every partition)
        rest = list(files[1:])
        parts = [[files[0]] for _ in range(num_partitions)]
        for i, f in enumerate(rest):
            parts[i % num_partitions].append(f)
        return [p for p in parts if len(p) > 1]
    # string mode: every partition must hold >= 2 docs (a 1-doc partition
    # has no MUMs and would drop its doc from the merge), so the partition
    # count is capped for the round-robin to give >= 2 docs each
    num_partitions = min(num_partitions, len(files) // 2)
    if num_partitions < 2:
        return [list(files)]
    parts = [[] for _ in range(num_partitions)]
    for i, f in enumerate(files):
        parts[i % num_partitions].append(f)
    return parts


def scan_partition(files, pfx: str, anchor: bool = True,
                   min_match_len: int = 20, use_revcomp: bool = True,
                   verbose: bool = False, device="cuda") -> str:
    """One partition: full engine scan on `device` with merge metadata,
    outputs under pfx. Returns the partition .mums path."""
    rb = refbuilder.build_from_files(files, use_revcomp=use_revcomp)
    rb.write_lengths_file(pfx)
    opts = options.normalize(
        rb.num_docs, min_match_len=min_match_len,
        use_revcomp=use_revcomp, merge=True, anchor_merge=anchor,
        quiet=not verbose)
    results = engine.find_matches(rb, opts, device=device)
    engine.write_outputs(results, rb, pfx)
    return pfx + ".mums"


def merge_partition_outputs(part_mums, output_prefix: str,
                            collective: bool = False, device="cuda") -> str:
    """Combine partition outputs into output_prefix.mums (single-partition
    degenerates to a rename of every sidecar); a string merge runs its
    scan on `device`. collective=True: the anchor-merge fold runs on
    `device` instead of the host."""
    merged = output_prefix + ".mums"
    if len(part_mums) == 1:
        os.replace(part_mums[0], merged)
        for ext in (".lengths", ".athresh", ".thresh", ".thresh_rev"):
            src = os.path.splitext(part_mums[0])[0] + ext
            if os.path.exists(src):
                os.replace(src, output_prefix + ext)
        return merged
    rc = merge_mod.run(list(part_mums)
                       + ["-o", output_prefix, "--device", str(device)]
                       + (["--collective"] if collective else []))
    if rc != 0:
        raise RuntimeError(f"merge failed with exit code {rc}")
    return merged


def run_partitioned(partitions, output_prefix: str, anchor: bool = True,
                    min_match_len: int = 20, use_revcomp: bool = True,
                    verbose: bool = False, device="cuda") -> str:
    """Run the engine per partition with merge metadata, then merge, all
    on `device`.

    partitions: list of file lists. With anchor=True every partition must
    start with the same anchor file. Returns the merged .mums path.
    """
    part_mums = [
        scan_partition(files, f"{output_prefix}_part{i}", anchor=anchor,
                       min_match_len=min_match_len,
                       use_revcomp=use_revcomp, verbose=verbose,
                       device=device)
        for i, files in enumerate(partitions)
    ]
    return merge_partition_outputs(part_mums, output_prefix, device=device)


def run_partitioned_files(files, output_prefix: str,
                          num_partitions: int = 2, anchor: bool = True,
                          **kw) -> str:
    """Convenience: auto-partition a file list, run, and merge."""
    parts = auto_partition(files, num_partitions, anchor=anchor)
    return run_partitioned(parts, output_prefix, anchor=anchor, **kw)
