"""Homography, crop and appearance augmentation of CALC2 training and
evaluation, on NHWC batches.

Port of ``ekf_slam_tpu/models/augment.py`` ("CALC 2.0"/layers.py,
calc2.py:254-269):

* ``estimate_hom`` — the 4-point DLT with h33 = 1, one batched 8 x 8
  ``torch.linalg.solve``;
* ``hom_warp`` — bilinear resampling of the warped [-1, 1]² grid by four
  gathers. Not ``F.grid_sample``: [-1, 1] maps to (w + 1)·w_in / 2, and
  the integer corners are clamped after the floor while the weights come
  from the unclamped floor;
* ``rand_warp`` / ``positive_view`` / ``eval_view`` /
  ``seasonal_change`` / ``random_crop``.

Randomness is an input. Each random function takes its draws (a
``*Draws`` tuple, or the warped corners ``dst``), or draws them from a
``torch.Generator`` on the images' device (``*_draws``). The draws are
the values JAX's functions draw, so a test can hand in JAX's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

CORNERS = ((-1.0, -1.0), (-1.0, 1.0), (1.0, -1.0), (1.0, 1.0))


def _uniform(shape, lo, hi, like: torch.Tensor,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=generator,
                                       dtype=like.dtype, device=like.device)


def estimate_hom(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Batched 4-point DLT. src, dst (B, 4, 2) -> H (B, 3, 3) with
    H·[src; 1] ∝ [dst; 1], h33 = 1 (layers.py:141-156)."""
    rx, ry = src[..., 0:1], src[..., 1:2]
    x, y = dst[..., 0:1], dst[..., 1:2]
    z = torch.zeros_like(rx)
    o = torch.ones_like(rx)
    rows_x = torch.cat([-rx, -ry, -o, z, z, z, rx * x, ry * x], dim=-1)
    rows_y = torch.cat([z, z, z, -rx, -ry, -o, rx * y, ry * y], dim=-1)
    A = torch.cat([rows_x, rows_y], dim=-2)                 # (B, 8, 8)
    b = torch.cat([-x, -y], dim=-2)                         # (B, 8, 1)
    h = torch.linalg.solve(A, b)[..., 0]
    H = torch.cat([h, torch.ones_like(h[..., :1])], dim=-1)
    return H.reshape(*h.shape[:-1], 3, 3)


def hom_warp(images: torch.Tensor, out_hw, H: torch.Tensor) -> torch.Tensor:
    """Warp NHWC images (B, h, w, C) by per-image homographies H (B, 3, 3)
    over a [-1, 1]² grid of out_hw, bilinear, corners clamped to the image
    (layers.py:28-139)."""
    B, h_in, w_in, C = images.shape
    out_h, out_w = out_hw
    dt, dev = images.dtype, images.device
    xs = torch.linspace(-1.0, 1.0, out_w, dtype=dt, device=dev)
    ys = torch.linspace(-1.0, 1.0, out_h, dtype=dt, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")          # (out_h, out_w)
    grid = torch.stack([gx.reshape(-1), gy.reshape(-1),
                        torch.ones(out_h * out_w, dtype=dt, device=dev)])
    warped = H.to(dt) @ grid                                # (B, 3, N)
    fx = (warped[:, 0] / warped[:, 2] + 1.0) * w_in / 2.0
    fy = (warped[:, 1] / warped[:, 2] + 1.0) * h_in / 2.0
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    tx = fx - x0
    ty = fy - y0
    # clamp before the cast: a far-off corner saturates, as XLA's does
    x0i = torch.clamp(x0, -1, w_in).long().clamp(0, w_in - 1)
    y0i = torch.clamp(y0, -1, h_in).long().clamp(0, h_in - 1)
    x1i = torch.clamp(x0i + 1, 0, w_in - 1)
    y1i = torch.clamp(y0i + 1, 0, h_in - 1)
    flat = images.reshape(B, h_in * w_in, C)

    def gather(yi, xi):
        idx = (yi * w_in + xi)[..., None].expand(-1, -1, C)
        return torch.gather(flat, 1, idx)

    wa = ((1 - tx) * (1 - ty))[..., None]
    wb = ((1 - tx) * ty)[..., None]
    wc = (tx * (1 - ty))[..., None]
    wd = (tx * ty)[..., None]
    out = (wa * gather(y0i, x0i) + wb * gather(y1i, x0i)
           + wc * gather(y0i, x1i) + wd * gather(y1i, x1i))
    return out.reshape(B, out_h, out_w, C)


def warp_corners(images: torch.Tensor, max_warp: float = 0.5,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
    """rand_warp's draw: the warped CORNERS (B, 4, 2), each coordinate
    uniform within max_warp of its corner's ±1, inside [-1, 1]
    (layers.py:4-26)."""
    src = torch.tensor(CORNERS, dtype=images.dtype, device=images.device)
    u = torch.rand((images.shape[0], 4, 2), generator=generator,
                   dtype=images.dtype, device=images.device)
    return src - torch.sign(src) * max_warp * u


def rand_warp(images: torch.Tensor, out_hw, max_warp: float = 0.5,
              dst: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Random 4-corner homography warp: CORNERS to dst (B, 4, 2), drawn by
    warp_corners when None."""
    if dst is None:
        dst = warp_corners(images, max_warp, generator)
    src = torch.tensor(CORNERS, dtype=images.dtype,
                       device=images.device).expand(images.shape[0], 4, 2)
    return hom_warp(images, out_hw, estimate_hom(src, dst.to(images.dtype)))


def crop_offsets(images: torch.Tensor, out_hw, per_image: bool = True,
                 generator: Optional[torch.Generator] = None):
    """random_crop's draw: (oy, ox), each (B,) (per_image) or () int64,
    uniform over the offsets that keep the crop inside."""
    B, H, W, _ = images.shape
    shape = (B,) if per_image else ()
    kw = dict(generator=generator, device=images.device)
    return (torch.randint(0, H - out_hw[0] + 1, shape, **kw),
            torch.randint(0, W - out_hw[1] + 1, shape, **kw))


def random_crop(images: torch.Tensor, labels_onehot: torch.Tensor, out_hw,
                per_image: bool = True, offsets=None,
                generator: Optional[torch.Generator] = None):
    """Joint random crop of images and labels to out_hw (calc2.py:254-258).
    per_image=True crops each image at its own offset, False at one offset
    for the batch (the reference's tf.image.random_crop). offsets (oy, ox)
    as crop_offsets draws them."""
    oy, ox = (offsets if offsets is not None
              else crop_offsets(images, out_hw, per_image, generator))
    vh, vw = out_hw
    if oy.dim() == 0:
        return (images[:, oy:oy + vh, ox:ox + vw],
                labels_onehot[:, oy:oy + vh, ox:ox + vw])
    rows = (oy[:, None] + torch.arange(vh, device=oy.device))[:, :, None]
    cols = (ox[:, None] + torch.arange(vw, device=ox.device))[:, None, :]
    b = torch.arange(images.shape[0], device=oy.device)[:, None, None]
    return images[b, rows, cols], labels_onehot[b, rows, cols]


class PositiveDraws(NamedTuple):
    flip: torch.Tensor       # (B,) bool — mirror left-right
    dst: torch.Tensor        # (B, 4, 2) rand_warp's corners
    shift: torch.Tensor      # (B, 1, 1, 1) brightness in [-0.8, 0)


def positive_draws(images: torch.Tensor, max_warp: float = 0.5,
                   generator: Optional[torch.Generator] = None
                   ) -> PositiveDraws:
    B = images.shape[0]
    flip = torch.rand(B, generator=generator, dtype=images.dtype,
                      device=images.device) < 0.5
    return PositiveDraws(flip, warp_corners(images, max_warp, generator),
                         _uniform((B, 1, 1, 1), -0.8, 0.0, images,
                                  generator))


def _brightness(warped: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """The shift, clamped to [0, 1], kept only where the warped image's
    mean is at least 0.2 (calc2.py:266-269)."""
    adjusted = torch.clamp(warped + shift.to(warped.dtype), 0.0, 1.0)
    mean = torch.mean(warped, dim=(1, 2, 3), keepdim=True)
    return torch.where(mean < 0.2, warped, adjusted)


def positive_view(images: torch.Tensor, max_warp: float = 0.5,
                  draws: Optional[PositiveDraws] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """The training positive (calc2.py:264-269): random left-right flip,
    rand_warp, then a brightness shift in [-0.8, 0]."""
    if draws is None:
        draws = positive_draws(images, max_warp, generator)
    B, H, W, _ = images.shape
    images = torch.where(draws.flip[:, None, None, None],
                         torch.flip(images, dims=[2]), images)
    warped = rand_warp(images, (H, W), max_warp, draws.dst)
    return _brightness(warped, draws.shift)


class SeasonalDraws(NamedTuple):
    gain: torch.Tensor       # (B, 4, 5, 1) in [1 - 0.6s, 1 + 0.6s]
    noise: torch.Tensor      # (B, H, W, C) unit normal
    cy: torch.Tensor         # (B, n, 1, 1, 1) occluder centres in [0, H)
    cx: torch.Tensor         # (B, n, 1, 1, 1) in [0, W)
    fill: torch.Tensor       # (B, 1, 1, C) occluder grey in [0.3, 0.7)


def seasonal_draws(images: torch.Tensor, severity: float = 1.0,
                   n_occluders: int = 3,
                   generator: Optional[torch.Generator] = None
                   ) -> SeasonalDraws:
    B, H, W, C = images.shape
    occ = (B, n_occluders, 1, 1, 1)
    return SeasonalDraws(
        _uniform((B, 4, 5, 1), 1.0 - 0.6 * severity, 1.0 + 0.6 * severity,
                 images, generator),
        torch.randn(images.shape, generator=generator, dtype=images.dtype,
                    device=images.device),
        _uniform(occ, 0.0, float(H), images, generator),
        _uniform(occ, 0.0, float(W), images, generator),
        _uniform((B, 1, 1, C), 0.3, 0.7, images, generator))


def seasonal_change(images: torch.Tensor, severity: float = 1.0,
                    n_occluders: int = 3,
                    draws: Optional[SeasonalDraws] = None,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """Cross-season appearance change of a revisit (test_net.py:44-99): a
    4 x 5 gain grid bilinearly upsampled, sensor noise of σ 0.08·s, and
    n_occluders grey rectangles of 0.2·s of each side. s = 0 is the
    identity (then a clamp to [0, 1]).

    The upsampling is F.interpolate's bilinear with align_corners=False,
    which equals jax.image.resize "bilinear" when it enlarges (its
    renormalized kernel at an edge is torch's clamped index); the grid is
    never shrunk."""
    B, H, W, C = images.shape
    if H < 4 or W < 5:
        raise ValueError(f"seasonal_change needs images of at least 4 x 5, "
                         f"got {H} x {W}")
    if draws is None:
        draws = seasonal_draws(images, severity, n_occluders, generator)
    dt = images.dtype
    gain = F.interpolate(draws.gain.to(dt).permute(0, 3, 1, 2), size=(H, W),
                         mode="bilinear", align_corners=False)
    out = images * gain.permute(0, 2, 3, 1)
    out = out + draws.noise.to(dt) * (0.08 * severity)
    yy = torch.arange(H, dtype=dt, device=images.device)[:, None, None]
    xx = torch.arange(W, dtype=dt, device=images.device)[None, :, None]
    inside = ((torch.abs(yy - draws.cy.to(dt)) < 0.1 * severity * H)
              & (torch.abs(xx - draws.cx.to(dt)) < 0.1 * severity * W))
    occluded = torch.any(inside, dim=1)                     # (B, H, W, 1)
    out = torch.where(occluded, draws.fill.to(dt), out)
    return torch.clamp(out, 0.0, 1.0)


class EvalDraws(NamedTuple):
    dst: torch.Tensor                   # (B, 4, 2) rand_warp's corners
    shift: torch.Tensor                 # (B, 1, 1, 1) in [-0.5, 0)
    seasonal: Optional[SeasonalDraws]   # at severity > 0


def eval_draws(images: torch.Tensor, max_warp: float = 0.3,
               severity: float = 0.0,
               generator: Optional[torch.Generator] = None) -> EvalDraws:
    return EvalDraws(
        warp_corners(images, max_warp, generator),
        _uniform((images.shape[0], 1, 1, 1), -0.5, 0.0, images, generator),
        seasonal_draws(images, severity, generator=generator)
        if severity > 0.0 else None)


def eval_view(images: torch.Tensor, max_warp: float = 0.3,
              severity: float = 0.0, draws: Optional[EvalDraws] = None,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """A held-out revisit view for evaluation pairs: a moderate viewpoint
    homography and a brightness shift in [-0.5, 0], no mirror flip; at
    severity > 0 seasonal_change on top (test_net.py:44-99)."""
    if draws is None:
        draws = eval_draws(images, max_warp, severity, generator)
    B, H, W, _ = images.shape
    out = _brightness(rand_warp(images, (H, W), max_warp, draws.dst),
                      draws.shift)
    if severity > 0.0:
        out = seasonal_change(out, severity, draws=draws.seasonal)
    return out
