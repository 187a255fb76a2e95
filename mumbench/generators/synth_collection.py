"""The bench collection: mutated copies of one random base sequence.

A frozen copy of synth_collection in the program's throughput harness (and
of the JAX package's bench.py): the same bytes for the same arguments, so
the counts on record (native/baseline_cpu at seed 0) hold for it.
"""

from __future__ import annotations

import numpy as np


def synth_collection(total_mbp: float, n_docs: int, seed: int = 0,
                     snp_rate: float = 0.001):
    """n_docs mutated copies of one random base sequence, ~total_mbp Mbp
    in all before revcomp, as uint8 ACGT arrays; max(1, len * snp_rate)
    SNP draws a copy (positions may repeat), 0.1% by default (the pairwise
    divergence of human haplotypes)."""
    rng = np.random.default_rng(seed)
    base_len = int(total_mbp * 1e6 / n_docs)
    base = rng.integers(0, 4, base_len, dtype=np.int8)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    docs = []
    for _ in range(n_docs):
        s = base.copy()
        n_mut = max(1, int(base_len * snp_rate))
        pos = rng.integers(0, base_len, n_mut)
        s[pos] = (s[pos] + rng.integers(1, 4, n_mut)) % 4
        docs.append(acgt[s])
    return docs


def generate(config: dict, seed: int):
    """The documents of a configuration file's collection."""
    return synth_collection(config["total_mbp"], config["n_docs"], seed=seed,
                            snp_rate=config["snp_rate"])
