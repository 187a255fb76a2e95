"""mumemto_tpu_torch — the PyTorch/CUDA port of mumemto_tpu.

Finds multi-MUMs and multi-MEMs across a pangenome collection with the
prefix-free-parse (PFP) pipeline of mumemto_tpu, on one NVIDIA GPU (or the
CPU, for tests). Its output bytes (.mums, .mems, .bumbl, .lengths,
.thresh, .thresh_rev, .athresh) equal mumemto_tpu's for the same inputs.
The package imports torch, never jax and nothing of mumemto_tpu: it keeps
its own copy of every host module (formats, refbuilder, options, ...).

Entry points:
    python -m mumemto_tpu_torch a.fa b.fa ... -o out [--device cuda]
    python -m mumemto_tpu_torch merge|viz|collinear|... (the subcommands)
    mum(sequences, ..., device="cuda"), mem(sequences, ..., device="cuda")
    mumemto_tpu_torch.engine.find_matches(rb, opts, device="cuda")
    mumemto_tpu_torch.parallel.mumemtom.run_partitioned_files(files, out)
    python -m mumemto_tpu_torch.kernels.probe [timeout_s]
"""

__version__ = "1.4.0"


def __getattr__(name):
    # lazy: importing the package loads neither the engine nor torch
    if name in ("mum", "mem", "MumResult", "MemResult"):
        from mumemto_tpu_torch import library
        return getattr(library, name)
    raise AttributeError(name)
