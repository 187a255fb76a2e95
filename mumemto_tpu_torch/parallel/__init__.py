"""Multi-run orchestration of the PyTorch port (MumemtoM)."""
