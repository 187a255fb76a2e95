"""mumemto_tpu_torch — the PyTorch/CUDA port of mumemto_tpu.

Finds multi-MUMs and multi-MEMs across a pangenome collection with the
prefix-free-parse (PFP) pipeline of mumemto_tpu, on one NVIDIA GPU (or the
CPU, for tests). Its output bytes (.mums, .mems, .bumbl, .lengths,
.thresh, .thresh_rev, .athresh) equal mumemto_tpu's for the same inputs.
The package imports torch and never jax.

Entry points:
    python -m mumemto_tpu_torch a.fa b.fa ... -o out [--device cuda]
    mumemto_tpu_torch.engine.find_matches(rb, opts, device="cuda")
    python -m mumemto_tpu_torch.kernels.probe [timeout_s]
"""

__version__ = "1.4.0"
