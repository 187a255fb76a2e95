"""The bench collection with the alphabet of a real assembly: runs of N
(assembly gaps) and, with iupac, the ten IUPAC ambiguity codes written
over synth_collection's documents.

A frozen copy of synth_collection_real in the program's throughput
harness: the same bytes for the same arguments.
"""

from __future__ import annotations

import numpy as np

from synth_collection import synth_collection

GAP_LENGTHS = (100, 1000, 10_000, 50_000)
GAP_PROBS = (0.6, 0.25, 0.1, 0.05)
IUPAC_CODES = b"RYKMSWBDHV"


def synth_collection_real(total_mbp: float, n_docs: int, seed: int = 0,
                          iupac: bool = False, snp_rate: float = 0.001):
    """The bench collection with the alphabet of a real assembly:
    synth_collection's documents for the same arguments (the same lengths,
    so Mbp stays comparable) with assembly gaps written over them as runs
    of N and, with iupac, the ten IUPAC ambiguity codes.

    Per document, independently (gaps differ between assemblies),
    max(1, doc_len // 250_000) gaps overwrite (never insert) bases:
    positions uniform, lengths drawn from GAP_LENGTHS with GAP_PROBS. 100
    is NCBI's convention for a gap of unknown size and by far the most
    common, 1000 and 10 000 are scaffolding gaps, 50 000 is what GRCh38
    writes for its largest unsized gaps (heterochromatin, short arms). The
    mean is 3810 bases a gap, so about 1.5% of the bases are N. A gap is
    clipped to the document and to a tenth of its length (which bites below
    500 kbp a document: the 1 Mbp byte checks). Document 0 always holds one
    gap of 50 000 (so clipped); one gap of document 1 starts at its first
    base and one of document 2 ends at its last, a run that meets the '$'.
    With N the text has 9 distinct bytes with the parse's 0, 1, 2 and '$':
    one more than the 3-bit seed takes.

    iupac: single non-N bases at rate 1e-5 (at least one a document) become
    a code drawn from RYKMSWBDHV, and document 0 gets each code once more,
    so all ten occur: 19 distinct bytes, over the 16 of the packed LCP
    bottom. The gaps are the same with and without iupac."""
    docs = synth_collection(total_mbp, n_docs, seed=seed, snp_rate=snp_rate)
    rng = np.random.default_rng([seed, 0x4E])       # the gaps
    rng_c = np.random.default_rng([seed, 0x49])     # the codes
    codes = np.frombuffer(IUPAC_CODES, np.uint8)
    for i, d in enumerate(docs):
        n = int(d.size)
        n_gaps = max(1, n // 250_000)
        lens = rng.choice(GAP_LENGTHS, n_gaps, p=GAP_PROBS)
        if i == 0:
            lens[0] = GAP_LENGTHS[-1]
        lens = np.minimum(lens, max(1, n // 10))
        pos = (rng.random(n_gaps) * (n - lens + 1)).astype(np.int64)
        if i == 1:
            pos[0] = 0
        if i == 2:
            pos[0] = n - lens[0]
        if iupac:
            n_codes = max(1, int(round(n * 1e-5)))
            where = rng_c.integers(0, n, n_codes)
            what = codes[rng_c.integers(0, codes.size, n_codes)]
            if i == 0:
                where = np.concatenate([where,
                                        rng_c.integers(0, n, codes.size)])
                what = np.concatenate([what, codes])
        for p, ln in zip(pos.tolist(), lens.tolist()):
            d[p:p + ln] = ord("N")
        if iupac:
            # after the gaps, so no code breaks a run: a code drawn into a
            # gap (or onto another code) moves to the next free base
            for p, c in zip(where.tolist(), what.tolist()):
                while d[p % n] == ord("N") or d[p % n] in codes:
                    p += 1
                d[p % n] = c
    return docs


def generate(config: dict, seed: int):
    """The documents of a configuration file's collection."""
    return synth_collection_real(config["total_mbp"], config["n_docs"],
                                 seed=seed, iupac=config.get("iupac", False),
                                 snp_rate=config["snp_rate"])
