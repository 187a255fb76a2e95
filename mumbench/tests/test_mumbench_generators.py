"""The frozen generator copies: pinned digests of their bytes at seed 0,
and the same bytes as the program's own harness
(mumemto_tpu_torch/bench.py) for the same arguments."""

import hashlib
import json
import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH_DIR)
sys.path.insert(0, os.path.join(BENCH_DIR, "generators"))
sys.path.insert(0, ROOT)

from synth_collection import synth_collection  # noqa: E402
from synth_collection_real import synth_collection_real  # noqa: E402

PINNED = {
    "human20x6.6mbp":
        "ee82e950b17dcfe9d311f96bc79d713457a89807376deb3a42ac36675c184d3d",
    "ecoli10x3.6mbp":
        "f6132fdd3d61bf1749118fa41c7d33cfad9cc33b70cc66a514db285cc947b3c9",
}
REAL_1MBP_4_IUPAC = \
    "32113afbcaaf9cca84cf72861b980cba5187985742a997cbca8066a951cc0192"


def _digest(docs):
    h = hashlib.sha256()
    for d in docs:
        h.update(d.tobytes())
        h.update(b"$")
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(PINNED))
def test_config_collection_digest_at_seed_0(name):
    with open(os.path.join(BENCH_DIR, "configs", name + ".json")) as f:
        cfg = json.load(f)
    docs = synth_collection(cfg["total_mbp"], cfg["n_docs"], seed=0,
                            snp_rate=cfg["snp_rate"])
    assert len(docs) == cfg["n_docs"]
    assert all(d.dtype == np.uint8 for d in docs)
    assert _digest(docs) == PINNED[name]


def test_real_alphabet_digest_at_seed_0():
    assert _digest(synth_collection_real(1.0, 4, seed=0, iupac=True)) \
        == REAL_1MBP_4_IUPAC


@pytest.mark.parametrize("seed", [0, 7, 2**33 + 5])
def test_same_bytes_as_the_programs_harness(seed):
    from mumemto_tpu_torch import bench
    for a, b in zip(synth_collection(0.3, 5, seed=seed),
                    bench.synth_collection(0.3, 5, seed=seed)):
        assert np.array_equal(a, b)
    for iupac in (False, True):
        for a, b in zip(synth_collection_real(0.6, 3, seed=seed, iupac=iupac),
                        bench.synth_collection_real(0.6, 3, seed=seed,
                                                    iupac=iupac)):
            assert np.array_equal(a, b)


def test_seeds_give_the_same_sizes():
    a = synth_collection(0.2, 4, seed=1)
    b = synth_collection(0.2, 4, seed=2**40 + 3)
    assert [d.size for d in a] == [d.size for d in b]
    assert not all(np.array_equal(x, y) for x, y in zip(a, b))
