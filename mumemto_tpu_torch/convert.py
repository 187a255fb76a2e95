"""Carry a parsed collection or a scan result from the JAX package into
the port.

The system has no weights; its state is the parsed collection, the
prepared dictionary and parse tables, and the scan's row arrays. Feeding
one parse, one prepared collection or one scan to both packages lets the
tests compare them stage by stage.
"""

from __future__ import annotations

import numpy as np
import torch

from mumemto_tpu_torch.ops.pfp import PFPData, _dict_live


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


_PREP_INTS = ("npz", "total_real", "m", "total_rows", "n_text", "ne", "nd",
              "nr", "mp", "w", "lvl_cap", "lvl_static")
_PREP_I32 = ("phrase_st", "phrase_ln", "d_starts", "parse", "isaP",
             "grp_of_pos", "grp_cross")


def _tensor(a, dtype, device):
    # through int64: torch reads no uint32 arrays (the JAX package's wide
    # row coordinates)
    return torch.from_numpy(np.asarray(a).astype(np.int64)).to(dtype).to(
        device)


def from_jax_prepare(prep: dict, device) -> dict:
    """The port's ops.pfp.pfp_scan_prepare dict for the dict that
    mumemto_tpu.ops.pfp.pfp_scan_prepare returns (any arrays numpy can
    read), as tensors on `device`. Row coordinates keep their values:
    cumcnt is int32 when it fits and int64 otherwise (a uint32 prepare),
    cumC and doc_ends are int64. slt_table (a sequence of levels, or one
    flat level-major array of mp entries per level) becomes the port's
    list of levels; it is converted, not rebuilt. dict_live, which the
    JAX package has no use for, is counted from phrase_ln."""
    out = {k: int(prep[k]) for k in _PREP_INTS}
    out.update(seed_thr=prep["seed_thr"], lcp_thr=prep["lcp_thr"])
    for k in _PREP_I32:
        out[k] = _tensor(prep[k], torch.int32, device)
    out["d"] = _tensor(prep["d"], torch.uint8, device)
    cumcnt = np.asarray(prep["cumcnt"]).astype(np.int64)
    out["cumcnt"] = _tensor(
        cumcnt, torch.int32 if int(cumcnt.max()) < 2**31 else torch.int64,
        device)
    out["cumC"] = _tensor(prep["cumC"], torch.int64, device)
    out["doc_ends"] = _tensor(prep["doc_ends"], torch.int64, device)
    slt = prep["slt_table"]
    if not isinstance(slt, (list, tuple)):
        slt = np.asarray(slt).reshape(-1, out["mp"])
    out["slt_table"] = [_tensor(level, torch.int32, device) for level in slt]
    out["dict_live"] = _dict_live(np.asarray(prep["phrase_ln"]),
                                  out["lvl_cap"])
    return out


def from_jax_dict_args(pfp, h: dict, device):
    """The dictionary index's arguments for a JAX PFPData `pfp` and its
    ops.pfp._host_prep dict `h`, so both packages' indexes see the same
    ext, phrase arrays, sizes, depths and thresholds. Returns (arrays,
    static): ops.pfp._dict_index(*arrays, *static), and
    sharddict.compile_sharded_dict_index(devices, *static)(*arrays);
    arrays = (ext, phrase_st, phrase_ln, d_starts, npz, total) with the
    tensors on `device`, static = (nd, ne, w, lvl_cap, lvl_static,
    seed_thr, lcp_thr)."""
    arrays = (_tensor(pfp.ext, torch.uint8, device),
              *(_tensor(h[k], torch.int32, device)
                for k in ("phrase_st", "phrase_ln", "d_starts")),
              int(h["npz"]), int(h["total_real"]))
    static = (*(int(h[k]) for k in ("nd", "ne", "w", "lvl_cap",
                                    "lvl_static")),
              h["seed_thr"], h["lcp_thr"])
    return arrays, static


def dict_tables_to_numpy(tables) -> tuple:
    """The index's five tables (d, lcpD, isaD, grp_of_pos, grp_cross), the
    port's tensors or the JAX package's arrays, as numpy arrays."""
    return tuple(t.cpu().numpy() if isinstance(t, torch.Tensor)
                 else np.asarray(t) for t in tables)
