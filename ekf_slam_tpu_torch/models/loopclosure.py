"""Loop-closure retrieval (CALC 2.0, close_kitti_loops.py + test_net.py),
batched over instances.

Port of ``ekf_slam_tpu/models/loopclosure.py``. Per incoming frame
(close_kitti_loops.py:100-154):

1. ``query``: cosine similarity of the frame's global descriptor against
   every valid ring slot (written, and ``exclude_recent`` frames old by
   its absolute frame id) in one product, the top-k candidates by a
   stable descending sort (the lower slot first among ties, as
   ``jax.lax.top_k`` orders them: the −inf of invalid slots always tie),
   then geometric verification of each candidate: the keypoint ratio test
   and a fixed-hypothesis 8-point RANSAC for the fundamental matrix
   (``fundamental_ransac``, the cv2.findFundamentalMat step);
2. ``step_temporal``: a loop is declared after ``consistency_count``
   consecutive hypotheses whose matched frame ids stay within
   ``consistency_window`` (close_kitti_loops.py:113-138);
3. ``push``: the frame's descriptor, keypoints and pose into the ring.

``LoopDatabase`` carries a leading instance axis B on every field.
``push`` writes the frame into the ring's tensors in place (a copy of the
store a frame would move gigabytes at the reference's capacity) and
returns the database with its count advanced; ``step_temporal`` returns a
new one. RANSAC's uniform draws are an input (B, top_k, NH, K), or come
from a torch.Generator.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from ekf_slam_tpu_torch.models.keypoints import Keypoints, ratio_test_matches
from ekf_slam_tpu_torch.ops import device as devices
from ekf_slam_tpu_torch.ops import kernels


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    capacity: int = 4096            # ring-buffer frames
    top_k: int = 7                  # close_kitti_loops.py:26 (K=7)
    exclude_recent: int = 200       # close_kitti_loops.py:108 (db[:-200])
    min_db: int = 400               # close_kitti_loops.py:107 (i > 2N=400)
    sim_threshold: float = 0.85     # cosine acceptance
    ratio: float = 0.7              # kp ratio test
    ransac_hypotheses: int = 64
    ransac_threshold: float = 2.0   # Sampson distance gate (px)
    min_inliers: int = 12
    consistency_count: int = 7      # close_kitti_loops.py:116 (C)
    consistency_window: int = 9     # close_kitti_loops.py:115 (W)


DB_FIELDS = ("descr", "kp_yx", "kp_descr", "pose", "frame_id", "count",
             "streak", "last_match")


@dataclasses.dataclass(frozen=True)
class LoopDatabase:
    """Fixed-capacity descriptor / keypoint / pose store of B instances."""
    descr: torch.Tensor       # (B, N, Dd)
    kp_yx: torch.Tensor       # (B, N, K, 2)
    kp_descr: torch.Tensor    # (B, N, K, Dk)
    pose: torch.Tensor        # (B, N, 7) [r(3), q(4)] camera pose a frame
    frame_id: torch.Tensor    # (B, N) int32 absolute frame index a slot,
                              # -1 empty. Once the ring wraps, slot order
                              # is not frame order: age comes from this.
    count: torch.Tensor       # (B,) int32 frames pushed so far
    streak: torch.Tensor      # (B,) int32 consecutive hypotheses
    last_match: torch.Tensor  # (B,) int32 frame id of the last hypothesis

    def replace(self, **kw) -> "LoopDatabase":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "LoopDatabase":
        return LoopDatabase(*(getattr(self, f).to(device)
                              for f in DB_FIELDS))


def init_db(cfg: LoopConfig, batch: int, descr_dim: int, num_kp: int,
            kp_dim: int, dtype=torch.float32, device=None) -> LoopDatabase:
    """An empty database for `batch` instances, on the card unless
    `device` names another."""
    device = devices.resolve(device)
    n = cfg.capacity
    kw = dict(dtype=dtype, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return LoopDatabase(
        descr=torch.zeros(batch, n, descr_dim, **kw),
        kp_yx=torch.zeros(batch, n, num_kp, 2, **kw),
        kp_descr=torch.zeros(batch, n, num_kp, kp_dim, **kw),
        pose=torch.zeros(batch, n, 7, **kw),
        frame_id=torch.full((batch, n), -1, **i32),
        count=torch.zeros(batch, **i32),
        streak=torch.zeros(batch, **i32),
        last_match=torch.full((batch,), -1, **i32))


def push(db: LoopDatabase, descr: torch.Tensor, kp: Keypoints,
         pose: torch.Tensor) -> LoopDatabase:
    """Write one frame a instance into slot count % N of the ring, in
    place (descr (B, Dd), kp with (B, K, ...) fields, pose (B, 7)).
    Returns the database with count + 1."""
    b = torch.arange(db.count.shape[0], device=db.count.device)
    slot = (db.count % db.descr.shape[1]).long()
    db.descr[b, slot] = descr.to(db.descr.dtype)
    db.kp_yx[b, slot] = kp.yx.to(db.kp_yx.dtype)
    db.kp_descr[b, slot] = kp.descr.to(db.kp_descr.dtype)
    db.pose[b, slot] = pose.to(db.pose.dtype)
    db.frame_id[b, slot] = db.count
    return db.replace(count=db.count + 1)


class QueryResult(NamedTuple):
    candidate_ids: torch.Tensor  # (B, top_k) ring slots (may be invalid)
    similarities: torch.Tensor   # (B, top_k), descending
    best_slot: torch.Tensor      # (B,) ring slot of the best candidate
    best_id: torch.Tensor        # (B,) absolute frame index of it
    best_inliers: torch.Tensor   # (B,) int32 its inlier count
    is_hypothesis: torch.Tensor  # (B,) bool — passed sim + geometry gates


def ransac_draws(cfg: LoopConfig, batch: int, num_kp: int,
                 generator: Optional[torch.Generator], dtype,
                 device) -> torch.Tensor:
    """Uniform draws (B, top_k, NH, K) in [0, 1) for one query, from
    `generator` (on its own device), moved to `device`."""
    gen_dev = None if generator is None else generator.device
    return torch.rand(batch, cfg.top_k, cfg.ransac_hypotheses, num_kp,
                      generator=generator, dtype=dtype,
                      device=gen_dev).to(device)


def query(db: LoopDatabase, descr: torch.Tensor, kp: Keypoints,
          cfg: LoopConfig, draws: Optional[torch.Tensor] = None,
          generator: Optional[torch.Generator] = None) -> QueryResult:
    """Retrieve and geometrically verify loop candidates. descr (B, Dd),
    kp with (B, K, ...) fields; draws (B, top_k, NH, K) RANSAC's uniforms
    (from `generator` when None)."""
    B = kp.yx.shape[0]
    age = db.count[:, None] - 1 - db.frame_id
    valid = (db.frame_id >= 0) & (age >= cfg.exclude_recent)
    sims = (db.descr @ descr[..., None].to(db.descr.dtype))[..., 0]
    sims = torch.where(valid, sims, -torch.inf)
    top_sims, top_ids = torch.sort(sims, dim=1, descending=True,
                                   stable=True)
    top_sims, top_ids = top_sims[:, :cfg.top_k], top_ids[:, :cfg.top_k]
    b = torch.arange(B, device=top_ids.device)[:, None]
    return verify(kp, top_sims, top_ids, db.frame_id[b, top_ids],
                  db.kp_yx[b, top_ids], db.kp_descr[b, top_ids], cfg, draws,
                  generator)


def verify(kp: Keypoints, top_sims, top_ids, cand_fid, cand_yx,
           cand_kdescr, cfg: LoopConfig,
           draws: Optional[torch.Tensor] = None,
           generator: Optional[torch.Generator] = None) -> QueryResult:
    """Geometric verification of the retrieved candidates and the gates:
    top_sims, top_ids, cand_fid (B, top_k) their similarities, slots and
    frame ids, cand_yx (B, top_k, K, 2) and cand_kdescr (B, top_k, K, Dk)
    their keypoints; draws as ``query`` takes them."""
    B, K = kp.yx.shape[0], kp.yx.shape[1]
    idx2, ok = ratio_test_matches(kp.descr[:, None], cand_kdescr,
                                  cfg.ratio)                # (B, top_k, K)
    pts2 = torch.gather(cand_yx, 2, idx2[..., None].expand(-1, -1, -1, 2))
    pts1 = kp.yx[:, None].expand_as(pts2)
    if draws is None:
        draws = ransac_draws(cfg, B, K, generator, pts1.dtype, pts1.device)
    inliers = fundamental_ransac(pts1, pts2, ok, cfg, draws)  # (B, top_k)
    gate = (top_sims > cfg.sim_threshold) & (inliers >= cfg.min_inliers)
    best = torch.argmax(torch.where(gate, inliers, -1), dim=1)[:, None]
    return QueryResult(
        candidate_ids=top_ids, similarities=top_sims,
        best_slot=torch.gather(top_ids, 1, best)[:, 0],
        best_id=torch.gather(cand_fid, 1, best)[:, 0],
        best_inliers=torch.gather(inliers, 1, best)[:, 0],
        is_hypothesis=gate.any(dim=1))


def step_temporal(db: LoopDatabase, result: QueryResult, cfg: LoopConfig):
    """Temporal consistency (close_kitti_loops.py:113-138). Returns
    (new_db, declared (B,) bool, loop_slot (B,), loop_frame (B,)): the
    window compares absolute frame ids (monotone across the ring's wrap);
    loop_slot addresses the store (pose, keypoints) of the match."""
    hyp = result.is_hypothesis
    near = torch.abs(result.best_id - db.last_match) <= cfg.consistency_window
    cont = hyp & (near | (db.streak == 0))
    streak = torch.where(cont, db.streak + 1, hyp.to(torch.int32))
    declared = streak >= cfg.consistency_count
    new_db = db.replace(
        streak=torch.where(declared, 0, streak).to(torch.int32),
        last_match=torch.where(hyp, result.best_id, -1).to(torch.int32))
    return new_db, declared, result.best_slot, result.best_id


# --- fundamental matrix ------------------------------------------------------

def _homogeneous(pts: torch.Tensor) -> torch.Tensor:
    """(..., K, 2) as (y, x) -> (..., K, 3) as (x, y, 1)."""
    xy = pts.flip(-1)
    return torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)


def _normalize_pts(pts: torch.Tensor, w: torch.Tensor):
    """Hartley normalization with masked statistics. pts (..., K, 2) as
    (y, x), w (..., K). Returns the normalized homogeneous points
    (..., K, 3) and the transform T (..., 3, 3)."""
    xyh = _homogeneous(pts)
    xy = xyh[..., :2]
    wsum = torch.clamp(w.sum(dim=-1), min=1.0)
    mean = (xy * w[..., None]).sum(dim=-2) / wsum[..., None]    # (..., 2)
    d = torch.sqrt(torch.sum((xy - mean[..., None, :]) ** 2, dim=-1))
    scale = math.sqrt(2.0) / torch.clamp((d * w).sum(dim=-1) / wsum,
                                         min=1e-6)
    T = torch.zeros(scale.shape + (3, 3), dtype=pts.dtype, device=pts.device)
    T[..., 0, 0] = scale
    T[..., 1, 1] = scale
    T[..., 0, 2] = -scale * mean[..., 0]
    T[..., 1, 2] = -scale * mean[..., 1]
    T[..., 2, 2] = 1.0
    return xyh @ T.transpose(-1, -2), T


def _eight_point(p1h: torch.Tensor, p2h: torch.Tensor, sel: torch.Tensor,
                 w8: torch.Tensor) -> torch.Tensor:
    """Weighted 8-point solve of each hypothesis: F = argmin ‖A f‖ as the
    eigenvector of the smallest eigenvalue of AᵀWA (9x9), projected to
    rank 2 (kernels.eight_point_fit; NaN for a non-finite AᵀWA, as in
    JAX, whose Sampson gate then counts no inlier). p1h, p2h (..., K, 3);
    sel (..., NH, 8) the sample's point
    indices, w8 (..., NH, 8) their weights (0 for an invalid point).
    AᵀWA sums only the sampled rows: every other row has weight 0.
    Returns (..., NH, 3, 3)."""
    x1, y1 = p1h[..., 0], p1h[..., 1]
    x2, y2 = p2h[..., 0], p2h[..., 1]
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], dim=-1)          # (..., K, 9)
    nh = sel.shape[-2]
    rows = torch.gather(A[..., None, :, :].expand(
        *A.shape[:-2], nh, *A.shape[-2:]), -2,
        sel[..., None].expand(*sel.shape, 9))               # (..., NH, 8, 9)
    M = (rows * w8[..., None]).transpose(-1, -2) @ rows
    return kernels.eight_point_fit(M.reshape(-1, 9, 9)).reshape(
        *M.shape[:-2], 3, 3)


def _sampson(F: torch.Tensor, p1h: torch.Tensor,
             p2h: torch.Tensor) -> torch.Tensor:
    """Sampson distances (..., NH, K) of F (..., NH, 3, 3) on (..., K, 3)
    point pairs."""
    Fx1 = p1h[..., None, :, :] @ F.transpose(-1, -2)        # (..., NH, K, 3)
    Ftx2 = p2h[..., None, :, :] @ F
    num = torch.sum(p2h[..., None, :, :] * Fx1, dim=-1) ** 2
    den = (Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2
           + Ftx2[..., 1] ** 2)
    return num / torch.clamp(den, min=1e-12)


def fundamental_ransac(pts1: torch.Tensor, pts2: torch.Tensor,
                       valid: torch.Tensor, cfg: LoopConfig,
                       draws: torch.Tensor) -> torch.Tensor:
    """Masked fixed-hypothesis RANSAC for F (cv2.findFundamentalMat,
    close_kitti_loops.py:47). pts1, pts2 (..., K, 2) as (y, x); valid
    (..., K) bool; draws (..., NH, K) uniforms in [0, 1): each hypothesis
    fits the 8 valid points of least draw (invalid points score 1e3 more).
    The Sampson gate is evaluated in pixels on the denormalized F.
    Returns the best inlier count (...,) int32."""
    dtype = pts1.dtype
    vf = valid.to(dtype)
    p1n, T1 = _normalize_pts(pts1, vf)
    p2n, T2 = _normalize_pts(pts2, vf)
    r = draws + (~valid)[..., None, :].to(draws.dtype) * 1e3
    sel = torch.topk(-r, 8, dim=-1).indices                 # (..., NH, 8)
    w8 = torch.gather(vf[..., None, :].expand_as(r), -1, sel)
    Fn = _eight_point(p1n, p2n, sel, w8)
    F = T2.transpose(-1, -2)[..., None, :, :] @ Fn @ T1[..., None, :, :]
    d = _sampson(F, _homogeneous(pts1), _homogeneous(pts2))
    inl = (d < cfg.ransac_threshold ** 2) & valid[..., None, :]
    return inl.sum(dim=-1).amax(dim=-1).to(torch.int32)
