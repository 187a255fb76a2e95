"""The capacity check of the fixed-size match windows.

Of mumemto_tpu/parallel/partition.py only WindowCapacityError and
_check_capacity are here: the sharded scan (parallel/seqpfp.py) uses them.
The vmap-over-partitions mesh program of that module is not ported.
"""

from __future__ import annotations

import numpy as np


class WindowCapacityError(RuntimeError):
    """A fixed-capacity match buffer (M) overflowed."""


def _check_capacity(emit_counts, M: int, what: str):
    """No silent caps: a shard's compaction keeps at most M entries, so an
    emit count above M would drop matches. Verify from the counts and fail
    loudly with the needed capacity."""
    c = np.atleast_1d(np.asarray(emit_counts))
    worst = int(c.max()) if c.size else 0
    if worst > M:
        raise WindowCapacityError(
            f"{what}: {worst} matches exceed the window capacity "
            f"M={M}; rerun with M >= {worst}")
