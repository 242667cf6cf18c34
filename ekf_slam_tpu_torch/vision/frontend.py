"""Image front-end: the SLAM frame from pixels, batched over instances.

Port of ``ekf_slam_tpu/vision/frontend.py`` (the image path of
BASELINE.json configs[3]) on its default forms:

* ``render_scene_image`` — a grayscale frame of Gaussian intensity bumps
  at the projected landmarks, which FAST detects and NCC locks onto.
* ``Appearance`` — per-slot 41x41 init patch, init pose, init pixel and
  binary descriptor (add_feature_to_info_vector.m:7-32), each with a
  leading instance axis B; ``appearance_from_numpy`` / ``_to_numpy``
  carry it across from the JAX package.
* ``measure`` — predict, then ``measure_at_prior`` (standalone use; the
  frame predicts once for the matcher and the filter).
* ``measure_at_prior`` — predicted pixels and S from the prior, then one of
  two matchers: "ncc" (plane-homography-warped templates, NCC search in
  the χ²-gated window; its numerator is kernel K7) or "descriptor" (FAST
  corners in the window, χ² gate, Hamming match against the stored
  descriptor — the reference's matching.m:29-47 and the JAX default).
* ``select_new_feature_pixels`` — top FAST corners away from the
  predicted features and the border.
* ``prepare_frame`` — the planes the matchers and the feature init read
  (NMS'd FAST response, 3x3-smoothed image), computed once a frame.
* ``step_image`` — the whole frame: manage → predict → match →
  ``engine.step_core_from_prior`` → feature init and appearance store;
  ``run_images`` drives it over a sequence of frames, on a CUDA device
  by replaying one frame captured as a CUDA graph (filter/graph.py).

One frame (H, W) is shared by every instance: FAST, non-max suppression
and smoothing run once a frame (``prepare_frame``; the JAX functions each
recompute them from the image, which XLA merges under jit and eager torch
would not); only the per-slot windows are batched, cut by index
arithmetic. Not ported: the attribution knobs (EKF_ABLATE),
the window-form knob (EKF_MATCHWIN; the "shared" form is the one here)
and the staggered drivers (step_image_phase1/2, run_images_staggered).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from ekf_slam_tpu_torch.config import CAM_DIM, EngineConfig
from ekf_slam_tpu_torch.filter import ekf, engine, graph, mapman, measurement
from ekf_slam_tpu_torch.filter.association import mahalanobis2
from ekf_slam_tpu_torch.filter.state import FIELDS, FilterState
from ekf_slam_tpu_torch.ops import camera as cam_ops
from ekf_slam_tpu_torch.ops import device as devices
from ekf_slam_tpu_torch.ops import quaternion as quat
from ekf_slam_tpu_torch.ops.consts import constant
from ekf_slam_tpu_torch.sim.scene import Scene
from ekf_slam_tpu_torch.vision import descriptor, fast, ncc, patch_warp

INIT_PATCH_HALF = 20   # 41x41 init patch (initialize_a_feature.m:4)
MATCH_PATCH_HALF = 6   # 13x13 matching patch (initialize_a_feature.m:5)
BORDER = 21            # image border exclusion (initialize_a_feature.m:22)

APPEARANCE_FIELDS = ("patches", "init_pose", "init_px", "descr")


@dataclasses.dataclass(frozen=True)
class Appearance:
    patches: torch.Tensor    # (B, CAP, 41, 41) init patches
    init_pose: torch.Tensor  # (B, CAP, 7) [r(3) q(4)] camera pose at init
    init_px: torch.Tensor    # (B, CAP, 2) pixel at init
    descr: torch.Tensor      # (B, CAP, N_BITS) ±1 init binary descriptor

    def to(self, device) -> "Appearance":
        return Appearance(*(getattr(self, f).to(device)
                            for f in APPEARANCE_FIELDS))


def init_appearance(cfg: EngineConfig, batch: int,
                    device=None) -> Appearance:
    """Empty appearance store for `batch` instances (identity init pose),
    on the card unless `device` names another."""
    device = devices.resolve(device)
    cap = cfg.map.capacity
    p = 2 * INIT_PATCH_HALF + 1
    kw = dict(dtype=cfg.torch_dtype, device=device)
    pose = torch.zeros(batch, cap, 7, **kw)
    pose[..., 3] = 1.0
    return Appearance(patches=torch.zeros(batch, cap, p, p, **kw),
                      init_pose=pose,
                      init_px=torch.zeros(batch, cap, 2, **kw),
                      descr=torch.zeros(batch, cap, descriptor.N_BITS, **kw))


class Frame(NamedTuple):
    """One shared frame and what every reader of it needs, made once."""
    img: torch.Tensor      # (H, W) in [0, 1]
    score: torch.Tensor    # (H, W) NMS'd FAST response
    smooth: torch.Tensor   # (H, W) 3x3-smoothed image (descriptor support)


def prepare_frame(img: torch.Tensor, cfg: EngineConfig) -> Frame:
    """FAST, non-max suppression and smoothing of img (H, W), once."""
    v = cfg.vision
    return Frame(img, fast.non_max_suppress(
        fast.fast_score(img, v.fast_threshold, v.fast_arc)),
        descriptor._smooth3(img))


def appearance_from_numpy(d, device=None,
                          dtype=torch.float64) -> Appearance:
    """Appearance from a mapping (or object with attributes) of numpy
    arrays with the JAX field names; an unbatched store (patches of rank
    3) gains a leading instance axis of 1. On the card unless `device`
    names another."""
    device = devices.resolve(device)
    get = d.__getitem__ if isinstance(d, dict) else lambda k: getattr(d, k)
    arrs = {k: np.asarray(get(k)) for k in APPEARANCE_FIELDS}
    if arrs["patches"].ndim == 3:
        arrs = {k: v[None] for k, v in arrs.items()}
    return Appearance(**{k: torch.tensor(v, dtype=dtype, device=device)
                         for k, v in arrs.items()})


def appearance_to_numpy(a: Appearance) -> dict:
    """Dict of numpy arrays (batched) with the JAX field names."""
    return {k: getattr(a, k).detach().cpu().numpy()
            for k in APPEARANCE_FIELDS}


def render_scene_image(scene: Scene, x_cam: torch.Tensor,
                       cfg: EngineConfig, device=None) -> torch.Tensor:
    """Grayscale (n_rows, n_cols) frame seen from camera state x_cam
    (13,): Gaussian bumps at the projected landmarks over a mid-gray
    background, separable, so one (H, L) x (L, W) product. On the card
    unless `device` names another."""
    device = devices.resolve(device)
    cam = cfg.camera
    lm = scene.landmarks.to(device)
    x_cam = x_cam.to(device)
    dt = x_cam.dtype
    L = lm.shape[0]
    hc = (lm - x_cam[0:3]) @ quat.q2r(x_cam[3:7])
    ok = hc[:, 2] > 1e-3
    hc_safe = torch.where(ok[:, None], hc, constant((0.0, 0.0, 1.0), dt,
                                                    device))
    px = cam_ops.distort(cam_ops.project(hc_safe, cam), cam)
    # Per-landmark deterministic amplitude / width (stable across frames).
    ids = torch.arange(L, device=device)
    amp = 0.35 + 0.45 * ((ids * 69069 % 97).to(dt) / 96.0)
    sig = 1.2 + 1.3 * ((ids * 40503 % 89).to(dt) / 88.0)
    amp = torch.where(ok, amp, torch.zeros_like(amp))
    yy = torch.arange(cam.n_rows, dtype=dt, device=device)
    xx = torch.arange(cam.n_cols, dtype=dt, device=device)
    gy = torch.exp(-0.5 * ((yy[:, None] - px[None, :, 1]) / sig) ** 2)
    gx = torch.exp(-0.5 * ((xx[:, None] - px[None, :, 0]) / sig) ** 2)
    return torch.clamp(0.2 + gy @ (amp[:, None] * gx.T), 0.0, 1.0)


def landmark_world_points(state: FilterState) -> torch.Tensor:
    """Current 3D point estimate per slot (B, CAP, 3): y + m(θ,φ)/ρ for
    inverse depth (inversedepth2cartesian.m:1-12), y for cartesian."""
    B, cap = state.active.shape
    slots = state.x[:, CAM_DIM:].reshape(B, cap, 6)
    y3, rho = slots[..., 0:3], slots[..., 5]
    safe_rho = torch.where(rho == 0, torch.ones_like(rho), rho)
    mi = quat.azel_to_ray(slots[..., 3], slots[..., 4])
    return torch.where(state.cartesian[..., None], y3,
                       y3 + mi / safe_rho[..., None])


def measure(state: FilterState, app: Appearance, img: torch.Tensor,
            cfg: EngineConfig):
    """Predict from the state, then match in img (H, W) -> (z, z_valid, h,
    visible), each (B, CAP, ...) as measure_at_prior's."""
    x_prior, P_prior = ekf.predict(state.x, state.P, cfg.filter)
    return measure_at_prior(state, app, prepare_frame(img, cfg), x_prior,
                            P_prior, cfg)[:4]


def measure_at_prior(state: FilterState, app: Appearance, frame: Frame,
                     x_prior: torch.Tensor, P_prior: torch.Tensor,
                     cfg: EngineConfig):
    """Appearance matching at the prior -> (z (B,CAP,2), z_valid,
    h (B,CAP,2), visible, r_needed (B,)).

    Only slots with λmax(S) < max_innovation_eig are searched (matching.m:16;
    association re-applies the gate). `r_needed` is the search radius the
    χ² gate can reach this frame, max sqrt(chi2·λmax(S)) over those slots:
    the gated window argmax is exact to an unbounded search iff
    search_radius ≥ r_needed."""
    h, visible, hc = measurement.predict_measurements(
        x_prior, state.active, state.cartesian, cfg)
    H_xv, H_y = measurement.jacobians(x_prior, h, hc, state.cartesian,
                                      cfg.camera)
    S = measurement.innovation_covariances(P_prior, H_xv, H_y,
                                           cfg.filter.sigma_z)
    tr = S[..., 0, 0] + S[..., 1, 1]                      # closed-form λmax
    det = S[..., 0, 0] * S[..., 1, 1] - S[..., 0, 1] * S[..., 1, 0]
    lmax = tr / 2 + torch.sqrt(torch.clamp(tr * tr / 4 - det, min=0.0))
    matchable = visible & (lmax < cfg.matching.max_innovation_eig)
    chi2 = cfg.matching.chi2_inv_2_95
    r_needed = torch.where(matchable, torch.sqrt(chi2 * lmax),
                           torch.zeros_like(lmax)).amax(dim=1)
    v = cfg.vision
    if v.matcher == "descriptor":
        z, _, found = match_all_descriptor(frame, app.descr, h, S,
                                           matchable, cfg)
    else:
        templates = patch_warp.predict_appearance(
            app.patches, app.init_pose, x_prior[:, :CAM_DIM],
            landmark_world_points(state), app.init_px, h, cfg.camera,
            out_size=2 * MATCH_PATCH_HALF + 1, distortion=v.warp_distortion)
        z, _, found = ncc.match_all(frame.img, templates, h, S, matchable,
                                    chi2, v.search_radius, v.min_ncc)
    return z, found, h, visible, r_needed


def match_all_descriptor(frame: Frame, descr_init: torch.Tensor,
                         h_pred: torch.Tensor, S: torch.Tensor,
                         visible: torch.Tensor, cfg: EngineConfig):
    """FAST + binary-descriptor matching of every slot (matching.m:29-47).

    Per slot: the top `corners_per_window` corners of the frame's NMS'd
    FAST response in the (2R+1)² window around h_pred, χ²-gated on their
    innovation against S, described, and the minimum-Hamming candidate
    kept under max_hamming. One (2, 2R+15, 2R+15) block a slot is cut from
    the zero-padded stacked [score; smoothed] plane: the score window is
    its interior, the describe region the rest (candidate centers are
    clipped inside the image, so padding is never read). descr_init
    (B, CAP, N_BITS), h_pred (B, CAP, 2), S (B, CAP, 2, 2), visible
    (B, CAP). Returns (z (B, CAP, 2), dist (B, CAP), found (B, CAP))."""
    v = cfg.vision
    R, C = v.search_radius, v.corners_per_window
    B, cap = h_pred.shape[:2]
    N = B * cap
    img = frame.img
    H, W = img.shape
    W2 = 2 * R + 1
    r = descriptor.PATCH // 2
    plane = torch.zeros(2, H + 2 * r, W + 2 * r, dtype=img.dtype,
                        device=img.device)
    plane[:, r:H + r, r:W + r] = torch.stack([frame.score, frame.smooth])

    h = h_pred.reshape(N, 2)
    u0 = (torch.round(h[:, 0]).to(torch.int32) - R).clamp(0, W - W2)
    v0 = (torch.round(h[:, 1]).to(torch.int32) - R).clamp(0, H - W2)
    reg = ncc.cut(plane, v0, u0, W2 + 2 * r)              # (N, 2, RG, RG)
    win = reg[:, 0, r:r + W2, r:r + W2].reshape(N, W2 * W2)
    vals, idx = fast.top_k(win, C)                        # (N, C)
    wy, wx = idx // W2, idx % W2
    cu = (u0[:, None] + wx).to(img.dtype)
    cv = (v0[:, None] + wy).to(img.dtype)
    nu = torch.stack([cu - h[:, 0:1], cv - h[:, 1:2]], dim=-1)   # (N, C, 2)
    gate = (vals > 0.0) & (mahalanobis2(nu, S.reshape(N, 1, 2, 2))
                           < cfg.matching.chi2_inv_2_95)
    d = descriptor.describe_regions(reg[:, 1], u0 - r, v0 - r, u0, v0, wy,
                                    wx, H, W)                    # (N, C, NB)
    d0 = descr_init.reshape(N, descriptor.N_BITS, 1)
    dist = 0.5 * (descriptor.N_BITS - (d @ d0)[..., 0])           # Hamming
    dist = torch.where(gate, dist, torch.full_like(dist, torch.inf))
    best = torch.argmin(dist, dim=1, keepdim=True)               # first min
    db = dist.gather(1, best)[:, 0]
    found = torch.isfinite(db) & (db <= v.max_hamming)
    z = torch.cat([cu.gather(1, best), cv.gather(1, best)], dim=1)
    db = torch.where(torch.isfinite(db), db, torch.full_like(db, 1e9))
    return (z.reshape(B, cap, 2), db.reshape(B, cap),
            found.reshape(B, cap) & visible)


def select_new_feature_pixels(frame: Frame, pred_px: torch.Tensor,
                              pred_mask: torch.Tensor, cfg: EngineConfig):
    """The top max_new_per_step FAST corners of the frame outside the
    exclusion disks around each instance's predicted features (pred_px
    (B, CAP, 2), pred_mask (B, CAP)) and off the border. The top K + CAP
    corners are taken once a frame, then tested against each instance's
    predictions. Returns (uv (B, K, 2), mask (B, K))."""
    v = cfg.vision
    img = frame.img
    H, W = img.shape
    yy = torch.arange(H, device=img.device)[:, None]
    xx = torch.arange(W, device=img.device)[None, :]
    border_ok = ((yy >= BORDER) & (yy < H - BORDER)
                 & (xx >= BORDER) & (xx < W - BORDER))
    k = cfg.map.max_new_per_step
    yx, vals = fast.top_corners(frame.score * border_ok,
                                k + pred_px.shape[1])
    cy = yx[:, 0].to(img.dtype)[None, :, None]
    cx = yx[:, 1].to(img.dtype)[None, :, None]
    d2 = ((cy - pred_px[:, None, :, 1]) ** 2
          + (cx - pred_px[:, None, :, 0]) ** 2)           # (B, K+CAP, CAP)
    d2 = torch.where(pred_mask[:, None, :], d2, torch.full_like(d2, torch.inf))
    clear = d2.amin(dim=-1) > v.exclusion_radius ** 2
    picked, order = fast.top_k(vals[None] * clear, k)     # (B, K)
    yx = yx[order]
    return torch.stack([yx[..., 1], yx[..., 0]], dim=-1).to(img.dtype), \
        picked > 0.0


def store_appearance(app: Appearance, state: FilterState, frame: Frame,
                     uv: torch.Tensor, assigned: torch.Tensor) -> Appearance:
    """Write the 41x41 patch, pose, pixel and binary descriptor of each
    candidate that landed in a slot (assigned (B, K) >= 0;
    add_feature_to_info_vector.m, initialize_a_feature.m:51-54) by one
    scatter per field. The JAX package writes the K candidates in a loop;
    add_features_batch assigns distinct slots, so the order of the writes
    cannot matter and one scatter is exact. Candidates that landed nowhere
    write a spare row past CAP, dropped after."""
    B, K = assigned.shape
    cap = app.patches.shape[1]
    yx = torch.stack([uv[..., 1], uv[..., 0]], dim=-1).to(torch.int32)
    new = {"patches": ncc.extract_patch(frame.img, uv, INIT_PATCH_HALF),
           "init_pose": state.x[:, None, :7].expand(B, K, 7),
           "init_px": uv,
           "descr": descriptor.describe_presmoothed(frame.smooth, yx)}
    slot = torch.where(assigned >= 0, assigned, cap).long()

    def put(field: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
        buf = torch.cat([field, torch.zeros_like(field[:, :1])], dim=1)
        idx = slot.reshape(B, K, *[1] * (val.dim() - 2)).expand_as(val)
        return buf.scatter(1, idx, val)[:, :cap]

    return Appearance(**{k: put(getattr(app, k), new[k])
                         for k in APPEARANCE_FIELDS})


def step_image(state: FilterState, app: Appearance, img: torch.Tensor,
               u: torch.Tensor, cfg: EngineConfig):
    """One SLAM frame from pixels for every instance: img (H, W) shared,
    u (B, NHYP) RANSAC's uniform draws. Stage order of mono_slam.m:50-82:
    map management, ONE prediction shared by the matcher and the filter,
    association / RANSAC / updates, then feature initialization from the
    frame when fewer than min_features_in_image were matched.
    Returns (state, app, StepInfo)."""
    frame = prepare_frame(img, cfg)
    state = mapman.manage(state, cfg)
    x_prior, P_prior = ekf.predict(state.x, state.P, cfg.filter)
    z, z_valid, h_pred, pred_vis, r_needed = measure_at_prior(
        state, app, frame, x_prior, P_prior, cfg)
    state, _, ic, info = engine.step_core_from_prior(
        state, x_prior, P_prior, z, z_valid, u, cfg)
    info = dataclasses.replace(info, search_r_needed=r_needed)
    m = cfg.map
    n_ic = ic.sum(dim=1)
    uv, cand = select_new_feature_pixels(frame, h_pred, pred_vis, cfg)
    k = torch.arange(uv.shape[1], device=uv.device)
    deficit = torch.clamp(m.min_features_in_image - n_ic, min=0)
    take = (cand & (k < deficit[:, None])
            & (n_ic < m.min_features_in_image)[:, None])
    no_ids = torch.full(take.shape, -1, dtype=torch.int32, device=uv.device)
    state, assigned = mapman.add_features_batch(state, uv, take, no_ids, cfg)
    return state, store_appearance(app, state, frame, uv, assigned), info


def _image_frame(carry, inputs, cfg: EngineConfig):
    """One `step_image` as graph.py's frame function: carry the
    FilterState's fields, then the Appearance's; inputs (img, u) of the
    frame. Outputs: the camera block of the new state and the StepInfo's
    fields."""
    n = len(FIELDS)
    img, u = inputs
    state, app, info = step_image(FilterState(*carry[:n]),
                                  Appearance(*carry[n:]), img, u, cfg)
    return ((*(getattr(state, f) for f in FIELDS),
             *(getattr(app, f) for f in APPEARANCE_FIELDS)),
            (state.x[:, :CAM_DIM].contiguous(),
             *(getattr(info, f.name)
               for f in dataclasses.fields(engine.StepInfo))))


def frame_driver(states: FilterState, apps: Appearance, imgs: torch.Tensor,
                 u_seq: torch.Tensor, cfg: EngineConfig,
                 capture: bool = True):
    """run_images through graph.py's static buffers on the tensors' own
    device: the frame captured once and replayed, or with capture=False
    the same frame callable over the same buffers without a graph (how
    the CPU tests see what replay runs). Returns what run_images
    returns."""
    n = len(FIELDS)
    final, (traj, *info) = graph.run(
        functools.partial(_image_frame, cfg=cfg),
        (*(getattr(states, f) for f in FIELDS),
         *(getattr(apps, f) for f in APPEARANCE_FIELDS)),
        lambda t: (imgs[t], u_seq[t]), imgs.shape[0],
        ("image", cfg, engine.route(cfg, imgs.device, fused=False)), capture)
    return (FilterState(*final[:n]), Appearance(*final[n:]), traj,
            engine.StepInfo(*info))


def run_images(states: FilterState, apps: Appearance, imgs: torch.Tensor,
               u_seq: torch.Tensor, cfg: EngineConfig, device=None,
               eager: bool | None = None):
    """step_image over T shared frames imgs (T, H, W) with RANSAC draws
    u_seq (T, B, NHYP), on the card unless `device` names another (the
    inputs are moved there). On a CUDA device one frame is captured as a
    CUDA graph and replayed T times (frame_driver); eager=True, or the
    CPU, runs the eager loop of step_image, and eager=False without a card
    raises. No bootstrap: frame 0 initializes features from FAST. Returns
    (final state, final appearance, camera trajectory (B, T, 13), StepInfo
    with (B, T) fields)."""
    device = devices.resolve(device)
    state, app = states.to(device), apps.to(device)
    imgs, u_seq = imgs.to(device), u_seq.to(device)
    if graph.replays(device, eager):
        return frame_driver(state, app, imgs, u_seq, cfg)
    traj, infos = [], []
    for t in range(imgs.shape[0]):
        state, app, info = step_image(state, app, imgs[t], u_seq[t], cfg)
        traj.append(state.x[:, :CAM_DIM])
        infos.append(info)
    return state, app, torch.stack(traj, dim=1), engine.stack_infos(infos)
