"""Synthetic scene / sequence generator, drawn from a ``torch.Generator``.

Port of ``ekf_slam_tpu/sim/scene.py`` with the same geometry: landmarks
back-projected from random in-image pixels at random depths, a camera
trajectory under the filter's constant-velocity model plus white
acceleration, and per-frame observations through projection + radial
distortion with Gaussian pixel noise and a fraction of gross outliers.
The draws come from a torch generator, so a sequence matches the JAX one
in distribution, not bit for bit; with the noise stds and the outlier
fraction at 0 the geometry is deterministic and matches exactly.

Observations stay dense over all L landmarks: pixels (L, 2) and visible
(L,) per frame, with a leading time axis for a sequence. One sequence is
shared by every filter instance of a batch.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ekf_slam_tpu_torch.config import CAM_DIM, EngineConfig
from ekf_slam_tpu_torch.filter import motion
from ekf_slam_tpu_torch.ops import camera as cam_ops
from ekf_slam_tpu_torch.ops import device as devices
from ekf_slam_tpu_torch.ops import quaternion as quat


@dataclasses.dataclass(frozen=True)
class Scene:
    """Static world: ground-truth landmark positions (L, 3)."""
    landmarks: torch.Tensor


@dataclasses.dataclass(frozen=True)
class FrameObs:
    """Observations of every world landmark: pixels (..., L, 2) distorted
    (garbage where not visible), visible (..., L) bool. A sequence carries
    a leading time axis; ``frame(t)`` picks one frame, ``window`` a run."""
    pixels: torch.Tensor
    visible: torch.Tensor

    def frame(self, t: int) -> "FrameObs":
        return FrameObs(self.pixels[t], self.visible[t])

    def window(self, start: int, stop: int) -> "FrameObs":
        """Frames start:stop of a sequence."""
        return FrameObs(self.pixels[start:stop], self.visible[start:stop])

    def to(self, device) -> "FrameObs":
        return FrameObs(self.pixels.to(device), self.visible.to(device))


def _uniform(gen, shape, lo, hi, dtype):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, dtype=dtype)


def make_scene(gen: torch.Generator, cfg: EngineConfig) -> Scene:
    """Landmarks inside the camera's initial viewing frustum: random
    in-image pixels (15% margin) back-projected to depths in
    [depth_min, depth_max]."""
    s, cam = cfg.sim, cfg.camera
    dt = torch.float64
    L = s.num_landmarks
    lo = torch.tensor([0.15 * cam.n_cols, 0.15 * cam.n_rows], dtype=dt)
    hi = torch.tensor([0.85 * cam.n_cols, 0.85 * cam.n_rows], dtype=dt)
    uv = _uniform(gen, (L, 2), lo, hi, dt)
    depth = _uniform(gen, (L,), s.depth_min, s.depth_max, dt)
    uvu = cam_ops.undistort(uv, cam)
    fku = cam.f / cam.d
    rays = torch.stack([(uvu[:, 0] - cam.cx) / fku, (uvu[:, 1] - cam.cy) / fku,
                        torch.ones(L, dtype=dt)], dim=-1)
    return Scene(landmarks=(rays * depth[:, None]).to(cfg.torch_dtype))


def simulate_trajectory(gen: torch.Generator, cfg: EngineConfig,
                        num_steps: int) -> torch.Tensor:
    """Ground-truth camera states (T, 13): constant velocity + white
    acceleration (func_Q.m's generative model), computed in float64."""
    f = cfg.filter
    dt = torch.float64
    x = torch.zeros(CAM_DIM, dtype=dt)
    x[3] = 1.0
    x[7:10] = torch.tensor(cfg.sim.v_init, dtype=dt)
    x[10:13] = torch.tensor(cfg.sim.w_init, dtype=dt)
    sa = (cfg.sim.traj_accel_std if cfg.sim.traj_accel_std is not None
          else f.sigma_a)
    sw = (cfg.sim.traj_alpha_std if cfg.sim.traj_alpha_std is not None
          else f.sigma_alpha)
    xs = [x]
    for _ in range(num_steps - 1):
        x = motion.fv(x, f)
        dv = sa * f.delta_t * torch.randn(3, generator=gen, dtype=dt)
        dw = sw * f.delta_t * torch.randn(3, generator=gen, dtype=dt)
        q = x[3:7]
        x = torch.cat([x[0:3], q / torch.linalg.vector_norm(q),
                       x[7:10] + dv, x[10:13] + dw])
        xs.append(x)
    return torch.stack(xs).to(cfg.torch_dtype)


def observe(gen: torch.Generator, scene: Scene, x_cam: torch.Tensor,
            cfg: EngineConfig) -> FrameObs:
    """Project all landmarks through the true pose (h_C = R_cw (y − t),
    hi_cartesian.m), then project + distort, add pixel noise and gross
    outliers (shift by outlier_shift_px in a random direction), and gate
    by positive depth and the image bounds."""
    s, cam = cfg.sim, cfg.camera
    dt = scene.landmarks.dtype
    L = scene.landmarks.shape[0]
    R_wc = quat.q2r(x_cam[3:7])
    hc = (scene.landmarks - x_cam[0:3]) @ R_wc
    z_ok = hc[:, 2] > 1e-3
    hc_safe = torch.where(z_ok[:, None], hc,
                          torch.tensor([0.0, 0.0, 1.0], dtype=dt))
    px = cam_ops.distort(cam_ops.project(hc_safe, cam), cam)
    px = px + s.pixel_noise_std * torch.randn(L, 2, generator=gen, dtype=dt)
    is_out = torch.rand(L, generator=gen, dtype=dt) < s.outlier_fraction
    ang = _uniform(gen, (L,), 0.0, 2 * math.pi, dt)
    shift = s.outlier_shift_px * torch.stack([torch.cos(ang), torch.sin(ang)],
                                             dim=-1)
    px = torch.where(is_out[:, None], px + shift, px)
    vis = (z_ok & (px[:, 0] > 0) & (px[:, 0] < cam.n_cols)
           & (px[:, 1] > 0) & (px[:, 1] < cam.n_rows))
    return FrameObs(pixels=px, visible=vis)


def simulate(gen: torch.Generator, cfg: EngineConfig, num_steps: int,
             device=None):
    """Full dataset on `device`: (scene, true states (T, 13), FrameObs
    with pixels (T, L, 2) and visible (T, L)). Drawn on the generator's
    (CPU) device, then moved: to the card unless `device` names another."""
    device = devices.resolve(device)
    scene = make_scene(gen, cfg)
    xs = simulate_trajectory(gen, cfg, num_steps)
    frames = [observe(gen, scene, x, cfg) for x in xs]
    obs = FrameObs(torch.stack([o.pixels for o in frames]),
                   torch.stack([o.visible for o in frames]))
    return Scene(scene.landmarks.to(device)), xs.to(device), obs.to(device)
