"""FAST-16 corner detection as dense tensor ops.

Port of ``ekf_slam_tpu/vision/fast.py`` on its default forms (the
runlen arc test, rolled taps). A pixel is a corner when >= `arc`
CONTIGUOUS pixels of its 16-pixel Bresenham circle are all brighter than
center + t or all darker than center − t. The 16 taps are 16 wrapped
rolls of the image (``torch.roll``, as ``jnp.roll``; fast_score zeroes the
3-px border they wrap), the arc test a log-step run length on the doubled
mask, non-max suppression a wrapped 3x3 max. The image path runs all of it
once a frame on the shared (H, W) frame.

``top_k`` is the port's one top-k: a stable descending sort and a slice,
so equal values come lowest index first, as ``jax.lax.top_k`` and a stable
``argsort(-v)`` order them (``torch.topk`` promises no order of ties).
"""

from __future__ import annotations

import numpy as np
import torch

# 16-point Bresenham circle of radius 3, clockwise (standard FAST layout).
CIRCLE = np.array([
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1)])


def top_k(x: torch.Tensor, k: int):
    """The k largest entries along the last axis, ties lowest index first.
    Returns (values, indices (int64)), each (..., k)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _taps(img: torch.Tensor) -> torch.Tensor:
    """(16, …, H, W) circle intensities: 16 wrapped rolls."""
    return torch.stack(
        [torch.roll(img, (-int(dy), -int(dx)), dims=(-2, -1))
         for dy, dx in CIRCLE.tolist()], dim=0)


def _max_contiguous_run(mask: torch.Tensor) -> torch.Tensor:
    """Maximum circular run of True along axis 0 of a (16, ...) mask, via
    log-doubling on the doubled sequence (run length capped at 16)."""
    m = torch.cat([mask, mask], dim=0).to(torch.int32)      # (32, ...)
    # run[i] = run length starting at i, exact once below the cap 2^k:
    # extend only SATURATED runs (run == 2^k) by the run at i + 2^k.
    run = m
    for k in range(5):
        s = 1 << k
        shifted = torch.cat([run[s:], torch.zeros_like(run[:s])], dim=0)
        run = torch.where(run == s, s + shifted, run)
    return torch.clamp(run[:16].amax(dim=0), max=16)


def fast_score(img: torch.Tensor, threshold: float = 0.08,
               arc: int = 9) -> torch.Tensor:
    """Corner response map (…, H, W) -> (…, H, W): the mean contrast
    margin of the qualifying taps where the arc test passes, else 0.
    The mean is taken tap by tap in order, so it rounds alike on every
    device."""
    taps = _taps(img)
    diff = taps - img[None]
    bright = diff > threshold
    dark = diff < -threshold
    is_corner = ((_max_contiguous_run(bright) >= arc)
                 | (_max_contiguous_run(dark) >= arc))
    excess = torch.where(bright | dark, diff.abs() - threshold,
                         torch.zeros_like(diff))
    total = torch.zeros_like(img)
    for tap in excess:
        total = total + tap
    score = torch.where(is_corner, total / 16, torch.zeros_like(img))
    # Zero the 3-px border the rolls wrapped around.
    H, W = img.shape[-2:]
    yy = torch.arange(H, device=img.device)[:, None]
    xx = torch.arange(W, device=img.device)[None, :]
    interior = (yy >= 3) & (yy < H - 3) & (xx >= 3) & (xx < W - 3)
    return score * interior


def non_max_suppress(score: torch.Tensor, radius: int = 1) -> torch.Tensor:
    """Keep only local maxima within a (2r+1)² wrapped window; plateau ties
    are all kept."""
    neigh = score
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            if dy == 0 and dx == 0:
                continue
            neigh = torch.maximum(
                neigh, torch.roll(score, (dy, dx), dims=(-2, -1)))
    return torch.where(score >= neigh, score, torch.zeros_like(score))


def top_corners(score: torch.Tensor, k: int):
    """Top-k corners of a suppressed score map (…, H, W). Returns
    (yx (…, k, 2) int32, scores (…, k)); zero-score entries mean 'no
    corner'."""
    W = score.shape[-1]
    vals, idx = top_k(score.flatten(-2), k)
    yx = torch.stack([idx // W, idx % W], dim=-1).to(torch.int32)
    return yx, vals
