"""Array programs of the port (PyTorch counterparts of mumemto_tpu.ops)."""
