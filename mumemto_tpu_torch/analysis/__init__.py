"""Subcommands of the PyTorch port: copies of mumemto_tpu/analysis/*, with
merge's "MUMs of MUMs" scan on the port's engine."""
