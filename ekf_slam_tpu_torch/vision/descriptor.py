"""Binary intensity-comparison descriptor (FREAK-class), batched.

Port of ``ekf_slam_tpu/vision/descriptor.py``: N_BITS fixed pseudo-random
pair comparisons over a 3x3-smoothed PATCH x PATCH support, as ±1 floats
so that a Hamming distance is one product, (N − d·d')/2. The pattern is
made by this module's own copy of the JAX package's recipe (numpy
``default_rng(1234)``), so the two packages compare the same pixel pairs.

The JAX package extracts candidate patches with one-hot matmuls (its TPU
lowering, EKF_REGEXTRACT / EKF_DESCRIBE); they select exactly one value
each, so here ``describe_regions`` is one plain gather of the same values.
``hamming_distance`` and ``match`` are the brute-force matcher over two
descriptor sets (the frame's matcher compares each slot's candidates with
that slot's stored descriptor instead).
"""

from __future__ import annotations

import numpy as np
import torch

from ekf_slam_tpu_torch.ops.consts import constant

N_BITS = 256
PATCH = 15          # descriptor support (odd)


def _pattern():
    """N_BITS pairs of (dy, dx) offsets in the patch, Gaussian-concentrated
    like BRIEF, from a seeded numpy generator (the JAX package's recipe)."""
    rng = np.random.default_rng(1234)
    r = PATCH // 2
    a = np.clip(np.round(rng.standard_normal((N_BITS, 2)) * r / 2.5),
                -r, r).astype(np.int32)
    b = np.clip(np.round(rng.standard_normal((N_BITS, 2)) * r / 2.5),
                -r, r).astype(np.int32)
    return a, b


_PAT_A, _PAT_B = _pattern()
_PAT_ROWS = tuple(tuple(int(v) for v in row)
                  for row in np.concatenate([_PAT_A, _PAT_B], axis=1).T)


def _offsets(device):
    """The pattern as int64 tensors (ya, xa, yb, xb), each (N_BITS,),
    made once per device."""
    return constant(_PAT_ROWS, torch.int64, device).unbind(0)


def _smooth3(img: torch.Tensor) -> torch.Tensor:
    """3x3 box smoothing over wrapped rolls (BRIEF requires
    pre-smoothing), summed in the JAX module's order."""
    out = torch.zeros_like(img)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            out = out + torch.roll(img, (dy, dx), dims=(-2, -1))
    return out / 9.0


def _bits(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(a > b, 1.0, -1.0).to(a.dtype)


def describe(img: torch.Tensor, yx: torch.Tensor) -> torch.Tensor:
    """Descriptors at keypoints. img (H, W); yx (..., 2) integer (y, x).
    Returns (..., N_BITS) ±1 floats."""
    return describe_presmoothed(_smooth3(img), yx)


def describe_presmoothed(sm: torch.Tensor, yx: torch.Tensor) -> torch.Tensor:
    """describe() given an already-smoothed image: the keypoint is clipped
    so the support lies inside the image, then bit i is
    sm[a_i] > sm[b_i]."""
    H, W = sm.shape
    r = PATCH // 2
    y = yx[..., 0].long().clamp(r, H - 1 - r)[..., None]
    x = yx[..., 1].long().clamp(r, W - 1 - r)[..., None]
    ya, xa, yb, xb = _offsets(sm.device)
    return _bits(sm[y + ya, x + xa], sm[y + yb, x + xb])


def describe_regions(regions: torch.Tensor, ru0: torch.Tensor,
                     rv0: torch.Tensor, u0: torch.Tensor, v0: torch.Tensor,
                     wy: torch.Tensor, wx: torch.Tensor,
                     H: int, W: int) -> torch.Tensor:
    """Describe the C candidates of each of S slots from pre-cut
    smoothed regions (S, RG, RG) anchored at (ru0, rv0) (S,) in image
    coordinates (negative when cut from a zero-padded plane). The
    candidates are at offsets wy, wx (S, C) from the search-window anchors
    (u0, v0) (S,); their centers are clipped inside the true image, so
    padding is never read. Returns (S, C, N_BITS) ±1, equal to
    describe_presmoothed at (v0 + wy, u0 + wx)."""
    r = PATCH // 2
    S_ = regions.shape[0]
    cy = (v0[:, None] + wy).clamp(r, H - 1 - r) - rv0[:, None]   # (S, C)
    cx = (u0[:, None] + wx).clamp(r, W - 1 - r) - ru0[:, None]
    ya, xa, yb, xb = _offsets(regions.device)
    s = torch.arange(S_, device=regions.device)[:, None, None]
    cy, cx = cy.long()[..., None], cx.long()[..., None]
    return _bits(regions[s, cy + ya, cx + xa], regions[s, cy + yb, cx + xb])


def hamming_distance(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """(K1, N) ±1 x (K2, N) ±1 -> (K1, K2) Hamming distances, one product."""
    return 0.5 * (d1.shape[-1] - d1 @ d2.T)


def match(d1: torch.Tensor, d2: torch.Tensor, max_distance: float):
    """Nearest-neighbour Hamming matching with a distance gate, the
    matchFeatures equivalent (matching.m:45-47; uniqueness as forward
    nearest neighbour only; the first minimum wins ties). Returns
    (idx2 (K1,), valid (K1,))."""
    dist = hamming_distance(d1, d2)
    best, idx = dist.min(dim=-1)
    return idx, best <= max_distance
