"""Carry a parsed collection or a scan result from the JAX package into
the port.

The system has no weights; its state is the parsed collection and the
scan's row arrays. Feeding one parse or one scan to both packages lets the
tests compare them stage by stage.
"""

from __future__ import annotations

import numpy as np
import torch

from mumemto_tpu_torch.ops.pfp import PFPData


def from_jax_res(res: dict, device) -> dict:
    """The port's scan-result dict for a JAX one (analyze_intervals output
    plus sa/da/lcp/bwt, any arrays numpy can read), as tensors on
    `device`."""
    return {key: torch.from_numpy(np.array(val)).to(device)
            for key, val in res.items()}


def from_jax_pfp(pfp, device) -> PFPData:
    """The port's PFPData for mumemto_tpu.ops.pfp.PFPData `pfp` (its ext
    is any array numpy can read), with ext on `device`."""
    ext = np.array(pfp.ext, dtype=np.uint8)  # a writable host copy
    return PFPData(w=pfp.w, n_text=pfp.n_text, m=pfp.m,
                   num_phrases=pfp.num_phrases, d_len=pfp.d_len,
                   ext=torch.from_numpy(ext).to(device),
                   parse=np.asarray(pfp.parse),
                   phrase_st=np.asarray(pfp.phrase_st),
                   phrase_ln=np.asarray(pfp.phrase_ln),
                   alpha=tuple(pfp.alpha))
