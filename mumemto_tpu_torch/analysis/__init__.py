"""Subcommands of the PyTorch port that run its engine."""
