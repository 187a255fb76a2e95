"""The port's dictionary index in the form its consumers read it, for the
tests that hold it against the JAX package's and the sharded index's.

The port's dictionary doubling stops each suffix one character past its
phrase separator (ops/suffix._bounded_rounds); the JAX package's and the
sharded one stop at 2^lvl_cap characters. So isaD and lcpD are compared
through each separator, where every consumer stops reading.
"""

import numpy as np


def dict_consumer_form(d, isa, lcp, total):
    """A dictionary index (d, isaD, lcpD; either package's, any array type)
    in the form its consumers read it: (keys, cross). keys[i] is the suffix
    at SA row i through its phrase's separator (the byte <= 1 that ends
    it: SEP, or TERM and the zero pad), so equal keys mark the rows no
    consumer tells apart. cross[i] is lcpD[i] where rows i-1 and i have
    different keys, exact in every implementation; -1 where the keys are
    equal, where lcpD[i] is asserted to be above the separator; and -2
    for row 0 and the zero-pad pairs (both positions >= total - 1), which
    canonicalize_pad_lcp pins and nothing reads."""
    d, isa, lcp = (np.asarray(x.cpu() if hasattr(x, "cpu") else x)
                   for x in (d, isa, lcp))
    n = d.size
    sa = np.empty(n, np.int64)
    sa[isa] = np.arange(n)
    stops = np.flatnonzero(d <= 1)
    ends = stops[np.searchsorted(stops, np.arange(n))]
    raw = d.tobytes()
    keys = [raw[p:ends[p] + 1] for p in sa.tolist()]
    cross = np.full(n, -2, np.int64)
    for i in range(1, n):
        if min(sa[i - 1], sa[i]) >= total - 1:
            continue
        if keys[i] == keys[i - 1]:
            assert lcp[i] >= len(keys[i]), (i, int(lcp[i]), len(keys[i]))
            cross[i] = -1
        else:
            cross[i] = lcp[i]
    return keys, cross
