"""Online loop-closure runner: the close_kitti_loops.py pipeline wired into
the EKF, batched over instances.

Port of ``ekf_slam_tpu/models/loop_runner.py``. Per frame
(close_kitti_loops.py:100-154): descriptor and keypoints from the VSS
network -> retrieval and geometric verification against the ring DB
(hypotheses masked until the DB holds ``min_db`` frames) -> temporal
consistency -> the stored pose of the matched frame fused as an EKF
constraint (filter/loop_fusion.py) -> push the frame. As in the JAX
package the constraint is applied every frame, masked by ``declared``:
a masked update still renormalizes q and transforms P, so it is not
skipped. ``run_online`` drives a sequence with a Python loop over frames
(the JAX package's lax.scan). The sharded DB (``mesh``) is not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ekf_slam_tpu_torch.filter import loop_fusion
from ekf_slam_tpu_torch.models import keypoints as kp_mod
from ekf_slam_tpu_torch.models import loopclosure as lc
from ekf_slam_tpu_torch.ops import device as devices
from ekf_slam_tpu_torch.utils.metrics import trace_annotation


class LoopStepOut(NamedTuple):
    declared: torch.Tensor    # (B,) bool — loop fired this frame
    match_id: torch.Tensor    # (B,) int32 — matched DB frame
    inliers: torch.Tensor     # (B,) int32
    similarity: torch.Tensor  # (B,) best candidate's cosine similarity


def make_frame_fn(model, lcfg: lc.LoopConfig, loop_sigma: float = 0.05,
                  relative_pose: bool = True):
    """fn(db, x, P, images, draws=None, generator=None) ->
    (db, x, P, LoopStepOut) for images (B, H, W, 3), x (B, D),
    P (B, D, D), draws (B, top_k, NH, K) or None (then from `generator`).

    relative_pose=True fuses the 6-DoF pose constraint with noise scaled
    by the inlier count; False the 3-DoF position snap with the fixed
    `loop_sigma`. The frame's phases are profiler ranges ``loop.vss``,
    ``loop.query`` and ``loop.fusion``."""

    @torch.no_grad()
    def frame(db: lc.LoopDatabase, x, P, images, draws=None,
              generator: Optional[torch.Generator] = None):
        with trace_annotation("loop.vss"):
            outs = model(images, descriptor_only=True)
            descr = outs["descriptor"]
            kps = kp_mod.kp_descriptor(outs["c5"])
        pose = torch.cat([x[:, 0:3], x[:, 3:7]], dim=1)
        with trace_annotation("loop.query"):
            res = lc.query(db, descr, kps, lcfg, draws, generator)
            res = res._replace(
                is_hypothesis=res.is_hypothesis & (db.count >= lcfg.min_db))
            db, declared, match_slot, match_frame = lc.step_temporal(
                db, res, lcfg)
        with trace_annotation("loop.fusion"):
            slot = torch.clamp(match_slot, 0, db.pose.shape[1] - 1)
            pose_j = torch.gather(db.pose, 1, slot[:, None, None].expand(
                -1, 1, 7).long())[:, 0].to(x.dtype)
            if relative_pose:
                sp, sr = loop_fusion.loop_noise_sigmas(res.best_inliers)
                x, P = loop_fusion.apply_loop_constraint_pose(
                    x, P, pose_j, sp, sr, declared)
            else:
                x, P = loop_fusion.apply_loop_constraint(
                    x, P, pose_j[:, 0:3], loop_sigma, declared)
        db = lc.push(db, descr, kps, pose)
        return db, x, P, LoopStepOut(
            declared=declared, match_id=match_frame,
            inliers=res.best_inliers, similarity=res.similarities[:, 0])

    return frame


def run_online(model, images: torch.Tensor, x0: torch.Tensor,
               P0: torch.Tensor, lcfg: lc.LoopConfig,
               draws: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               loop_sigma: float = 0.05, device=None):
    """The loop-closure pipeline over images (T, B, H, W, 3) from a static
    filter state x0 (B, D), P0 (B, D, D): pose updates come only from loop
    constraints (odometry lives in the SLAM engine; see run_loop_closure).
    draws (T, B, top_k, NH, K) RANSAC's uniforms, or None to draw them from
    `generator`. On the card unless `device` names another: the model and
    inputs are moved there. Returns (db, x, P, LoopStepOut with (T, B)
    fields)."""
    device = devices.resolve(device)
    model = model.to(device)
    x, P = x0.to(device), P0.to(device)
    frame = make_frame_fn(model, lcfg, loop_sigma)
    db = lc.init_db(lcfg, x.shape[0], model.descr_dim, model.num_kp,
                    model.kp_dim, model.mu.weight.dtype, device)
    outs = []
    for t in range(images.shape[0]):
        d_t = None if draws is None else draws[t].to(device)
        db, x, P, out = frame(db, x, P, images[t].to(device), d_t, generator)
        outs.append(out)
    return db, x, P, LoopStepOut(*(torch.stack(f) for f in zip(*outs)))
