"""Match-finding parameter normalization, mirroring the reference exactly.

Replicates BuildOptions::validate / set_parameters semantics
(include/pfp_mum.hpp:80-198): negative k/F are relative to N, F is clamped to
f*N, MUM mode iff f == 1, merge-mode incompatibilities.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass


class InputError(ValueError):
    """User-input validation failure: printed cleanly by the CLI (the
    reference's die() analogy) instead of a traceback. Internal
    ValueErrors deliberately do NOT subclass this."""


def _log(msg: str) -> None:
    print(f"[build_main] {msg}", file=sys.stderr)


@dataclass
class MatchOptions:
    """Normalized match-finding parameters (post set_parameters)."""
    min_match_len: int = 20     # -l
    num_distinct: int = 0       # -k (normalized: >=2, <=num_docs)
    max_doc_freq: int = 1       # -f (rare_freq); 0 = unlimited; 1 = MUM mode
    max_total_freq: int = 0     # -F; 0 = unlimited
    use_revcomp: bool = True    # !-r
    merge: bool = False         # -M
    anchor_merge: bool = False  # -Mn
    binary: bool = False        # -b

    @property
    def mum_mode(self) -> bool:
        return self.max_doc_freq == 1  # pfp_mum.hpp:146

    @property
    def no_max_freq(self) -> bool:
        return self.max_total_freq == 0  # mem_finder.hpp:89


def normalize(num_docs: int,
              min_match_len: int = 20,
              num_distinct_docs: int = 0,
              rare_freq: int = 1,
              max_mem_freq: int = 0,
              use_revcomp: bool = True,
              merge: bool = False,
              anchor_merge: bool = False,
              binary: bool = False,
              quiet: bool = False) -> MatchOptions:
    """Apply validate() + set_parameters() rules (pfp_mum.hpp:80-198)."""
    log = (lambda m: None) if quiet else _log

    if rare_freq < 0:
        raise InputError("Per-sequence MEM frequency must be > 0 (or 0 for no limit).")
    if binary and rare_freq != 1:
        log("binary output is not supported for multi-MEMs, ignoring flag")
        binary = False
    if anchor_merge and not merge:
        merge = True

    mum_mode = rare_freq == 1
    match_type = "MUMs" if mum_mode else "MEMs"

    k = num_distinct_docs
    if k < -num_docs:
        log(f"Too few number of sequences, defaulting to multi-{match_type} in 2 or more sequences")
        k = 2
    elif k <= 0:
        k = num_docs + k
    elif k == 1:
        log(f"Too few number of sequences, defaulting to multi-{match_type} in 2 or more sequences")
        k = 2
    elif k >= num_docs:
        if k > num_docs:
            log(f"Too large number of sequences, defaulting to multi-{match_type} in all sequences")
        k = num_docs

    if merge and k != num_docs:
        raise InputError("Merging not available for partial multi-MUM/MEMs")
    if merge and rare_freq != 1:
        raise InputError("Merging not available for multi-MEMs")

    F = max_mem_freq
    if F < -num_docs or F == 1:
        log("Invalid maximum total MEM frequency, defaulting to no upper limit")
        F = 0
    elif F < 0:
        F = num_docs + F

    # max per doc frequency overrides total frequency (pfp_mum.hpp:194-196)
    if rare_freq > 0 and (F == 0 or F > rare_freq * num_docs):
        F = rare_freq * num_docs

    return MatchOptions(min_match_len=min_match_len, num_distinct=k,
                        max_doc_freq=rare_freq, max_total_freq=F,
                        use_revcomp=use_revcomp, merge=merge,
                        anchor_merge=anchor_merge, binary=binary)
