"""mumemto_tpu_torch — the PyTorch/CUDA port of mumemto_tpu.

Finds strict and partial multi-MUMs across a pangenome collection with the
prefix-free-parse (PFP) pipeline of mumemto_tpu, on one NVIDIA GPU (or the
CPU, for tests). Its .mums and .lengths bytes equal mumemto_tpu's for the
same inputs. The package imports torch and never jax.

Entry points:
    python -m mumemto_tpu_torch a.fa b.fa ... -o out [--device cuda]
    mumemto_tpu_torch.engine.find_matches(rb, opts, device="cuda")
"""

__version__ = "1.4.0"
