"""The device a constructor or entry point of the port builds on.

The port's entry points run on the card unless the caller asks for
another device: ``device=None`` means CUDA, never the CPU. Without a card
such a call raises instead of quietly taking the CPU (plain) path; the
tests pass ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """torch.device(device), CUDA for None. Raises RuntimeError when the
    result is a CUDA device and torch sees none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card unless the caller "
            "names another device (device='cpu' for the plain versions)")
    return dev
