"""The benchmark's inputs, made from the seed: one general generator.

A sequence is a synthetic scene seen by a moving camera, drawn from
``numpy.random.default_rng(seed)`` in float64 on the host (a few thousand
numbers) and handed to the program and to the reference alike:

* the scene: landmarks back-projected from random in-image pixels (15%
  margin) at random depths;
* the camera's true trajectory: the filter's constant-velocity model with
  white linear and angular acceleration;
* the observations of every landmark in every frame: projection, radial
  distortion, Gaussian pixel noise and a fraction of gross outliers, gated
  by depth and the image bounds (the ``sim_sequence`` driver's input);
* the rendered frames: Gaussian intensity bumps at the projected
  landmarks on a mid-grey background (the ``image_sequence`` driver's
  input);
* RANSAC's uniform draws, one row of NUM_HYPOTHESES a frame and instance.

Every quantity the program reads is float32, and the reference reads the
same float32 values. The sizes depend on the configuration and the traffic
alone, never on the seed. The geometry follows the repository's simulator
and renderer (``sim/scene.py``, ``vision/frontend.render_scene_image``),
frozen here with the reference's camera model.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from benchmark.reference import oracle


@dataclasses.dataclass
class Sequence:
    """landmarks (L, 3), truth (T, 13), pixels (T, L, 2) float32, visible
    (T, L), frames (T, H, W) float32 or None, u (T, B, NHYP) float32."""
    landmarks: np.ndarray
    truth: np.ndarray
    pixels: np.ndarray
    visible: np.ndarray
    frames: np.ndarray | None
    u: np.ndarray


def _project_all(landmarks, x_cam, cam):
    """Camera-frame points, the in-front mask and the distorted pixels of
    every landmark seen from camera state x_cam."""
    hc = (landmarks - x_cam[0:3]) @ oracle.q2r(x_cam[3:7])
    ok = hc[:, 2] > 1e-3
    safe = np.where(ok[:, None], hc, [0.0, 0.0, 1.0])
    fku = cam.f / cam.d
    uv = np.stack([cam.cx + safe[:, 0] / safe[:, 2] * fku,
                   cam.cy + safe[:, 1] / safe[:, 2] * fku], axis=1)
    return ok, oracle.distort_many(uv, cam)


def make_scene(rng, s) -> np.ndarray:
    cam, sim = s.camera, s.sim
    L = sim.num_landmarks
    lo = np.array([0.15 * cam.n_cols, 0.15 * cam.n_rows])
    hi = np.array([0.85 * cam.n_cols, 0.85 * cam.n_rows])
    uv = lo + (hi - lo) * rng.random((L, 2))
    depth = sim.depth_min + (sim.depth_max - sim.depth_min) * rng.random(L)
    uvu = np.stack([oracle.undistort(p, cam) for p in uv])
    fku = cam.f / cam.d
    rays = np.stack([(uvu[:, 0] - cam.cx) / fku, (uvu[:, 1] - cam.cy) / fku,
                     np.ones(L)], axis=1)
    return rays * depth[:, None]


def trajectory(rng, s, frames: int) -> np.ndarray:
    f, sim = s.filter, s.sim
    sa = sim.traj_accel_std if sim.traj_accel_std is not None else f.sigma_a
    sw = (sim.traj_alpha_std if sim.traj_alpha_std is not None
          else f.sigma_alpha)
    x = np.zeros(13)
    x[3] = 1.0
    x[7:10], x[10:13] = sim.v_init, sim.w_init
    xs = [x]
    for _ in range(frames - 1):
        x = oracle.fv(x, f.delta_t, f)
        x[3:7] /= np.linalg.norm(x[3:7])
        x[7:10] += sa * f.delta_t * rng.standard_normal(3)
        x[10:13] += sw * f.delta_t * rng.standard_normal(3)
        xs.append(x.copy())
    return np.stack(xs)


def observe(rng, landmarks, x_cam, s):
    cam, sim = s.camera, s.sim
    L = len(landmarks)
    ok, px = _project_all(landmarks, x_cam, cam)
    px = px + sim.pixel_noise_std * rng.standard_normal((L, 2))
    out = rng.random(L) < sim.outlier_fraction
    ang = 2 * np.pi * rng.random(L)
    px = np.where(out[:, None], px + sim.outlier_shift_px
                  * np.stack([np.cos(ang), np.sin(ang)], axis=1), px)
    vis = (ok & (px[:, 0] > 0) & (px[:, 0] < cam.n_cols)
           & (px[:, 1] > 0) & (px[:, 1] < cam.n_rows))
    return px, vis


def render(landmarks, x_cam, s) -> np.ndarray:
    """(n_rows, n_cols) frame: 0.2 grey plus one separable Gaussian bump a
    landmark in front of the camera, clipped to [0, 1]; each landmark's
    amplitude and width fixed by its index."""
    cam = s.camera
    ok, px = _project_all(landmarks, x_cam, cam)
    ids = np.arange(len(landmarks))
    amp = np.where(ok, 0.35 + 0.45 * ((ids * 69069 % 97) / 96.0), 0.0)
    sig = 1.2 + 1.3 * ((ids * 40503 % 89) / 88.0)
    yy = np.arange(cam.n_rows, dtype=np.float64)
    xx = np.arange(cam.n_cols, dtype=np.float64)
    gy = np.exp(-0.5 * ((yy[:, None] - px[None, :, 1]) / sig) ** 2)
    gx = np.exp(-0.5 * ((xx[:, None] - px[None, :, 0]) / sig) ** 2)
    return np.clip(0.2 + gy @ (amp[:, None] * gx.T), 0.0, 1.0)


def sequence(seed: int, s, frames: int, instances: int,
             rendered: bool) -> Sequence:
    """The sequence of `seed`: scene, truth, observations, (frames) and
    the draws of `instances` filters."""
    rng = np.random.default_rng(seed)
    landmarks = make_scene(rng, s)
    truth = trajectory(rng, s, frames)
    obs = [observe(rng, landmarks, x, s) for x in truth]
    u = rng.random((frames, instances, s.ransac.num_hypotheses),
                   dtype=np.float32)
    imgs = (np.stack([render(landmarks, x, s) for x in truth])
            .astype(np.float32) if rendered else None)
    return Sequence(landmarks, truth,
                    np.stack([p for p, _ in obs]).astype(np.float32),
                    np.stack([v for _, v in obs]), imgs, u)
