"""Small constant tensors, made once per (values, dtype, device).

A tensor built from a host list is a synchronous copy to the card: inside
the per-frame step it would make the host wait for every queued kernel,
each frame, several times. The step takes its constants from here.
"""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=256)
def constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """torch.tensor(values) on `device`; values a float or nested tuples.
    The result is shared: callers must not write to it."""
    return torch.tensor(values, dtype=dtype, device=device)
