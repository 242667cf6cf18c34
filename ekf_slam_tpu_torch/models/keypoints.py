"""Activation keypoints and local descriptors (CALC 2.0, utils.py:88-174).

Port of ``ekf_slam_tpu/models/keypoints.py``, batched as it is there:
``kp_descriptor(c5)`` takes the conv activations (B, H, W, C), NHWC, and
returns exactly GRID²·C keypoints an image — per 4x4 grid cell and
channel, the argmax location (its first maximum, as in JAX), its
response, the arctan of the activation gradient and the 8-neighbour
difference stack over all channels. Keypoints are kept 1 px off the
border (the clip to 1..H−2 / 1..W−2). ``ratio_test_matches`` is the
nearest-neighbour match with Lowe's ratio test on squared distances.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ekf_slam_tpu_torch.ops.consts import constant

GRID = 4  # utils.py:96 (n = 4)
# The 8-neighbourhood, in the order of the descriptor's blocks.
OFFSETS = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0),
           (1, 1))


class Keypoints(NamedTuple):
    yx: torch.Tensor           # (B, K, 2) keypoint positions, c5's dtype
    response: torch.Tensor     # (B, K) activation at the keypoint
    orientation: torch.Tensor  # (B, K) gradient angle
    descr: torch.Tensor        # (B, K, 8·C) neighbour-difference descriptor


def kp_descriptor(c5: torch.Tensor) -> Keypoints:
    """c5: (B, H, W, C), H and W multiples of GRID. K = GRID²·C."""
    B, H, W, C = c5.shape
    ch, cw = H // GRID, W // GRID
    cells = c5.reshape(B, GRID, ch, GRID, cw, C).permute(
        0, 1, 3, 2, 4, 5).reshape(B, GRID * GRID, ch * cw, C)
    flat_idx = torch.argmax(cells, dim=2)                    # (B, G², C)
    cell_ids = torch.arange(GRID * GRID, device=c5.device)
    ky = flat_idx // cw + ((cell_ids // GRID) * ch)[None, :, None]
    kx = flat_idx % cw + ((cell_ids % GRID) * cw)[None, :, None]
    ky = torch.clamp(ky, 1, H - 2).reshape(B, -1)            # (B, K)
    kx = torch.clamp(kx, 1, W - 2).reshape(B, -1)
    chan = torch.arange(C, device=c5.device).repeat(GRID * GRID)[None]
    b = torch.arange(B, device=c5.device)[:, None]

    def at(yy, xx):
        return c5[b, yy, xx, chan]

    resp = at(ky, kx)
    gy = at(torch.clamp(ky + 1, 0, H - 1), kx) - at(
        torch.clamp(ky - 1, 0, H - 1), kx)
    gx = at(ky, torch.clamp(kx + 1, 0, W - 1)) - at(
        ky, torch.clamp(kx - 1, 0, W - 1))
    offs = constant(OFFSETS, torch.int64, c5.device)
    nb = c5[b[:, :, None], ky[:, :, None] + offs[:, 0],
            kx[:, :, None] + offs[:, 1]]                     # (B, K, 8, C)
    d = nb - c5[b, ky, kx][:, :, None, :]
    yx = torch.stack([ky, kx], dim=-1).to(c5.dtype)
    return Keypoints(yx=yx, response=resp, orientation=torch.atan2(gy, gx),
                     descr=d.reshape(B, ky.shape[1], 8 * C))


def ratio_test_matches(d1: torch.Tensor, d2: torch.Tensor,
                       ratio: float = 0.7):
    """Nearest-neighbour matching with Lowe's ratio test
    (close_kitti_loops.py:30-38). d1 (..., K1, D), d2 (..., K2, D).
    Returns (idx2 (..., K1) int64, valid (..., K1) bool): the first
    nearest neighbour, kept where its squared distance is below ratio² of
    the second's."""
    n1 = torch.sum(d1 * d1, dim=-1, keepdim=True)
    n2 = torch.sum(d2 * d2, dim=-1)
    dist = n1 + n2[..., None, :] - 2.0 * (d1 @ d2.transpose(-1, -2))
    idx = torch.argmin(dist, dim=-1)
    best = torch.gather(dist, -1, idx[..., None])[..., 0]
    masked = dist.scatter(-1, idx[..., None], torch.inf)
    second = torch.min(masked, dim=-1).values
    return idx, best < (ratio * ratio) * second
