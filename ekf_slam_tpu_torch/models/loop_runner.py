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
skipped. ``run_online`` drives a sequence (the JAX package's lax.scan):
on a CUDA device it replays one frame captured as a CUDA graph
(filter/graph.py; ``frame_driver``), elsewhere, or with eager=True, it
runs a Python loop over frames. The replayed frame carries the eight
database fields, x and P; the ring's store (descr, kp_yx, kp_descr,
pose: 9.36 GB at LoopConfig's capacity and B = 4) is its own static
buffer, written in place and returned as the database, never copied.
RANSAC's draws are made outside the graph, a frame at a time in the
eager loop's order, so replay equals the eager loop bit for bit. With a
``mesh`` the database is capacity-sharded over its "data" ranks
(parallel/sharded_loopdb.py): every rank runs the network and the fusion
on all B instances and holds N/k slots of the ring; its gloo
collectives cannot be captured, so that frame runs eagerly.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from ekf_slam_tpu_torch.filter import graph, loop_fusion
from ekf_slam_tpu_torch.models import keypoints as kp_mod
from ekf_slam_tpu_torch.models import loopclosure as lc
from ekf_slam_tpu_torch.models import vss
from ekf_slam_tpu_torch.ops import device as devices
from ekf_slam_tpu_torch.utils.metrics import trace_annotation


class LoopStepOut(NamedTuple):
    declared: torch.Tensor    # (B,) bool — loop fired this frame
    match_id: torch.Tensor    # (B,) int32 — matched DB frame
    inliers: torch.Tensor     # (B,) int32
    similarity: torch.Tensor  # (B,) best candidate's cosine similarity


def make_frame_fn(model, lcfg: lc.LoopConfig, loop_sigma: float = 0.05,
                  relative_pose: bool = True, mesh=None):
    """fn(db, x, P, images, draws=None, generator=None) ->
    (db, x, P, LoopStepOut) for images (B, H, W, 3), x (B, D),
    P (B, D, D), draws (B, top_k, NH, K) or None (then from `generator`).

    relative_pose=True fuses the 6-DoF pose constraint with noise scaled
    by the inlier count; False the 3-DoF position snap with the fixed
    `loop_sigma`. With a `mesh` db is this rank's block of a ring sharded
    over its "data" axis (sharded_loopdb). The frame's phases are profiler
    ranges ``loop.vss``, ``loop.query`` and ``loop.fusion``."""
    if mesh is not None:
        from ekf_slam_tpu_torch.parallel import sharded_loopdb as sdb

    @torch.no_grad()
    def frame(db: lc.LoopDatabase, x, P, images, draws=None,
              generator: Optional[torch.Generator] = None):
        with trace_annotation("loop.vss"):
            outs = model(images, descriptor_only=True)
            descr = outs["descriptor"]
            kps = kp_mod.kp_descriptor(outs["c5"])
        pose = torch.cat([x[:, 0:3], x[:, 3:7]], dim=1)
        with trace_annotation("loop.query"):
            res = (lc.query(db, descr, kps, lcfg, draws, generator)
                   if mesh is None else
                   sdb.query(db, descr, kps, lcfg, mesh, draws=draws,
                             generator=generator))
            res = res._replace(
                is_hypothesis=res.is_hypothesis & (db.count >= lcfg.min_db))
            db, declared, match_slot, match_frame = lc.step_temporal(
                db, res, lcfg)
        with trace_annotation("loop.fusion"):
            if mesh is None:
                slot = torch.clamp(match_slot, 0, db.pose.shape[1] - 1)
                pose_j = torch.gather(db.pose, 1, slot[:, None, None].expand(
                    -1, 1, 7).long())[:, 0].to(x.dtype)
            else:
                cap = db.pose.shape[1] * mesh.size("data")
                pose_j = sdb.best_pose(db, torch.clamp(match_slot, 0, cap - 1),
                                       mesh).to(x.dtype)
            if relative_pose:
                sp, sr = loop_fusion.loop_noise_sigmas(res.best_inliers)
                x, P = loop_fusion.apply_loop_constraint_pose(
                    x, P, pose_j, sp, sr, declared)
            else:
                x, P = loop_fusion.apply_loop_constraint(
                    x, P, pose_j[:, 0:3], loop_sigma, declared)
        db = (lc.push(db, descr, kps, pose) if mesh is None
              else sdb.push(db, descr, kps, pose, mesh))
        return db, x, P, LoopStepOut(
            declared=declared, match_id=match_frame,
            inliers=res.best_inliers, similarity=res.similarities[:, 0])

    return frame


# The ring's store: static buffers used in place by the replayed frame.
RING = ("descr", "kp_yx", "kp_descr", "pose")


def _setup(model, x0, P0, lcfg, loop_sigma, device, mesh):
    """The model and state on `device`, the frame function and an empty
    database (this rank's block with a mesh)."""
    model = model.to(device)
    x, P = x0.to(device), P0.to(device)
    frame = make_frame_fn(model, lcfg, loop_sigma, mesh=mesh)
    dims = (x.shape[0], model.descr_dim, model.num_kp, model.kp_dim)
    if mesh is None:
        db = lc.init_db(lcfg, *dims, model.mu.weight.dtype, device)
    else:
        from ekf_slam_tpu_torch.parallel import sharded_loopdb as sdb
        db = sdb.init_db(lcfg, *dims, mesh, dtype=model.mu.weight.dtype)
    return model, x, P, frame, db


def _graph_frame(carry, inputs, frame):
    """`frame` as graph.py's frame function: carry the database's fields,
    x and P; inputs the frame's images and RANSAC draws; outputs the
    LoopStepOut's fields."""
    n = len(lc.DB_FIELDS)
    db, x, P, out = frame(lc.LoopDatabase(*carry[:n]), *carry[n:], *inputs)
    return (*(getattr(db, f) for f in lc.DB_FIELDS), x, P), tuple(out)


def frame_driver(model, images: torch.Tensor, x0: torch.Tensor,
                 P0: torch.Tensor, lcfg: lc.LoopConfig,
                 draws: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 loop_sigma: float = 0.05, device=None,
                 capture: bool = True):
    """run_online through graph.py's static buffers: one frame captured as
    a CUDA graph and replayed, or with capture=False the same frame
    callable over the same buffers without a graph (how the CPU tests see
    what replay runs). The ring's store is used in place, so the frame is
    captured for this call. Each frame's draws are made before its replay
    from `generator`, as the eager loop makes them. Returns what
    run_online returns."""
    device = devices.resolve(device)
    model, x, P, frame, db = _setup(model, x0, P0, lcfg, loop_sigma, device,
                                    None)
    B, K = x.shape[0], model.num_kp
    dt = torch.promote_types(vss.compute_dtype(model.cfg,
                                               model.mu.weight.dtype),
                             torch.float32)        # the keypoints' dtype

    def inputs_at(t):
        d_t = (draws[t].to(device) if draws is not None
               else lc.ransac_draws(lcfg, B, K, generator, dt, device))
        return images[t].to(device), d_t

    (*fields, x, P), outs = graph.run(
        functools.partial(_graph_frame, frame=frame),
        (*(getattr(db, f) for f in lc.DB_FIELDS), x, P), inputs_at,
        images.shape[0], None, capture,
        in_place=[lc.DB_FIELDS.index(f) for f in RING])
    return (lc.LoopDatabase(*fields), x, P,
            LoopStepOut(*(o.transpose(0, 1).contiguous() for o in outs)))


def run_online(model, images: torch.Tensor, x0: torch.Tensor,
               P0: torch.Tensor, lcfg: lc.LoopConfig,
               draws: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               loop_sigma: float = 0.05, device=None, mesh=None,
               eager: Optional[bool] = None):
    """The loop-closure pipeline over images (T, B, H, W, 3) from a static
    filter state x0 (B, D), P0 (B, D, D): pose updates come only from loop
    constraints (odometry lives in the SLAM engine; see run_loop_closure).
    draws (T, B, top_k, NH, K) RANSAC's uniforms, or None to draw them from
    `generator`. On the card unless `device` names another: the model and
    inputs are moved there. On a CUDA device one frame is captured as a
    CUDA graph and replayed T times (frame_driver; the counterpart of the
    JAX package's scan); eager=True, or a CPU device, runs the eager loop,
    and eager=False without a card raises. With a `mesh`
    (parallel/mesh.make_mesh) the ring is capacity-sharded over its "data"
    ranks, the mesh's device is taken and the returned db is this rank's
    block; every rank must pass the same inputs (and draws, or a generator
    in the same state); the frame runs eagerly (eager=False raises).
    Returns (db, x, P, LoopStepOut with (T, B) fields)."""
    if mesh is not None:
        if eager is False:
            raise ValueError("run_online: a mesh's frame runs gloo "
                             "collectives, which a CUDA graph cannot "
                             "capture; pass eager=None or eager=True")
        device = mesh.device
    else:
        device = devices.resolve(device)
        if graph.replays(device, eager):
            return frame_driver(model, images, x0, P0, lcfg, draws,
                                generator, loop_sigma, device)
    model, x, P, frame, db = _setup(model, x0, P0, lcfg, loop_sigma, device,
                                    mesh)
    outs = []
    for t in range(images.shape[0]):
        d_t = None if draws is None else draws[t].to(device)
        db, x, P, out = frame(db, x, P, images[t].to(device), d_t, generator)
        outs.append(out)
    return db, x, P, LoopStepOut(*(torch.stack(f) for f in zip(*outs)))
