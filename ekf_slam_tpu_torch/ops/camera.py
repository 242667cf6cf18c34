"""Camera model: pinhole projection + 2-parameter radial distortion (L1).

Port of ``ekf_slam_tpu/ops/camera.py``. Pixel coordinates on the last
axis (uv[..., 0] = u, uv[..., 1] = v); any leading batch axes.
Sources: hu.m, undistort_fm.m, distort_fm.m (fixed 10-iteration Newton),
jacob_undistor_fm.m, hinv.m, calculate_Hi_inverse_depth.m:138-156.
"""

from __future__ import annotations

import torch

from ekf_slam_tpu_torch.config import CameraConfig
from ekf_slam_tpu_torch.ops import quaternion as quat
from ekf_slam_tpu_torch.ops.consts import constant


def _center(cam: CameraConfig, like: torch.Tensor) -> torch.Tensor:
    return constant((cam.cx, cam.cy), like.dtype, like.device)


def project(hrl: torch.Tensor, cam: CameraConfig) -> torch.Tensor:
    """Undistorted pinhole projection of camera-frame points (hu.m:1-14).
    hrl (..., 3) -> (..., 2). No division guard, like the reference."""
    fku = cam.f / cam.d
    u = cam.cx + (hrl[..., 0] / hrl[..., 2]) * fku
    v = cam.cy + (hrl[..., 1] / hrl[..., 2]) * fku
    return torch.stack([u, v], dim=-1)


def undistort(uvd: torch.Tensor, cam: CameraConfig) -> torch.Tensor:
    """Distorted -> undistorted pixels, closed form (undistort_fm.m:1-27)."""
    center = _center(cam, uvd)
    xy = (uvd - center) * cam.d
    rd2 = torch.sum(xy * xy, dim=-1, keepdim=True)
    D = 1.0 + cam.k1 * rd2 + cam.k2 * rd2 * rd2
    return xy * D / cam.d + center


def distort(uvu: torch.Tensor, cam: CameraConfig) -> torch.Tensor:
    """Undistorted -> distorted pixels: solve rd + k1·rd³ + k2·rd⁵ = ru
    with the reference's fixed Newton iterations and initial guess
    (distort_fm.m:26-32)."""
    k1, k2 = cam.k1, cam.k2
    center = _center(cam, uvu)
    xy = (uvu - center) * cam.d
    ru = torch.sqrt(torch.sum(xy * xy, dim=-1))
    rd = ru / (1.0 + k1 * ru ** 2 + k2 * ru ** 4)
    for _ in range(cam.distort_newton_iters):
        f = rd + k1 * rd ** 3 + k2 * rd ** 5 - ru
        fp = 1.0 + 3.0 * k1 * rd ** 2 + 5.0 * k2 * rd ** 4
        rd = rd - f / fp
    D = 1.0 + k1 * rd ** 2 + k2 * rd ** 4
    return xy / (D[..., None] * cam.d) + center


def jacob_undistort(uvd: torch.Tensor, cam: CameraConfig) -> torch.Tensor:
    """2x2 ∂(undistorted uv)/∂(distorted uv) (jacob_undistor_fm.m:1-34)."""
    d, k1, k2 = cam.d, cam.k1, cam.k2
    du = uvd[..., 0] - cam.cx
    dv = uvd[..., 1] - cam.cy
    xd = du * d
    yd = dv * d
    rd2 = xd * xd + yd * yd
    rd4 = rd2 * rd2
    base = 1.0 + k1 * rd2 + k2 * rd4
    g = k1 + 2.0 * k2 * rd2
    uu_ud = base + du * g * (2.0 * du * d * d)
    vu_vd = base + dv * g * (2.0 * dv * d * d)
    uu_vd = du * g * (2.0 * dv * d * d)
    vu_ud = dv * g * (2.0 * du * d * d)
    row0 = torch.stack([uu_ud, uu_vd], dim=-1)
    row1 = torch.stack([vu_ud, vu_vd], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def jacob_distort(uvd: torch.Tensor, cam: CameraConfig) -> torch.Tensor:
    """2x2 ∂(distorted)/∂(undistorted) = inv(jacob_undistort), by the
    adjugate (jacob_distor_fm.m:1-13)."""
    J = jacob_undistort(uvd, cam)
    det = J[..., 0, 0] * J[..., 1, 1] - J[..., 0, 1] * J[..., 1, 0]
    inv = torch.stack([
        torch.stack([J[..., 1, 1], -J[..., 0, 1]], dim=-1),
        torch.stack([-J[..., 1, 0], J[..., 0, 0]], dim=-1)], dim=-2)
    return inv / det[..., None, None]


def dhu_dhrl(hrl: torch.Tensor, cam: CameraConfig) -> torch.Tensor:
    """2x3 pinhole Jacobian ∂(undistorted uv)/∂(camera-frame point)
    (calculate_Hi_inverse_depth.m:138-156)."""
    fku = cam.f / cam.d
    x, y, z = hrl[..., 0], hrl[..., 1], hrl[..., 2]
    zero = torch.zeros_like(z)
    row0 = torch.stack([fku / z, zero, -x * fku / (z * z)], dim=-1)
    row1 = torch.stack([zero, fku / z, -y * fku / (z * z)], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def back_project_inverse_depth(uvd: torch.Tensor, r_w: torch.Tensor,
                               q_wr: torch.Tensor, initial_rho: float,
                               cam: CameraConfig) -> torch.Tensor:
    """Pixel -> 6-vector inverse-depth feature [r_W θ φ ρ₀] (hinv.m:1-28).
    uvd (..., 2), r_w (..., 3); q_wr (..., 4) broadcastable against uvd's
    leading axes."""
    uv = undistort(uvd, cam)
    fku = cam.f / cam.d
    h_lr = torch.stack([-(cam.cx - uv[..., 0]) / fku,
                        -(cam.cy - uv[..., 1]) / fku,
                        torch.ones_like(uv[..., 0])], dim=-1)
    n = (quat.q2r(q_wr) @ h_lr[..., None])[..., 0]
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    theta = torch.atan2(nx, nz)
    phi = torch.atan2(-ny, torch.sqrt(nx * nx + nz * nz))
    rho = torch.full_like(theta, initial_rho)
    return torch.cat([r_w, theta[..., None], phi[..., None], rho[..., None]],
                     dim=-1)
