"""Explicit device resolution: the port never moves to the CPU on its own."""

from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """torch.device for `device` ("cuda", "cuda:1", "cpu" or a
    torch.device). Asking for CUDA without a usable card raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} was asked for, but CUDA is "
                               "not available")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"device {dev} was asked for, but only "
                               f"{torch.cuda.device_count()} CUDA devices "
                               "exist")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use cuda or cpu")
    return dev
