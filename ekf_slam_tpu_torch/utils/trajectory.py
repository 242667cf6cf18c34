"""Trajectory evaluation: Umeyama alignment, ATE, RPE.

Port of ``ekf_slam_tpu/utils/trajectory.py`` (Sturm et al., IROS 2012
metrics): ``umeyama`` removes the SE(3) / Sim(3) gauge of a monocular
estimate before it is compared with ground truth, ``ate_rmse`` is the
absolute trajectory error after that alignment and ``rpe`` the relative
pose error over a horizon. Every function takes any leading batch axes
before the time axis: ``ate_rmse(est, gt)`` with est, gt (B, T, 3)
evaluates a B-instance ensemble at once and returns (B,).

On a trajectory whose positions barely move (a camera that only pans) the
3x3 cross-covariance is near-singular and R is whatever the SVD returns:
the two packages can part there, on R, not on the well-posed cases.
"""

from __future__ import annotations

import torch

from ekf_slam_tpu_torch.ops.quaternion import q2r, qconj, qprod


def umeyama(src: torch.Tensor, dst: torch.Tensor, with_scale: bool = False):
    """Least-squares (s, R, t) with dst ≈ s · R @ src + t.

    src, dst: (..., T, 3) point sets. with_scale=False returns s = 1
    (SE(3)); True estimates the Sim(3) scale. Umeyama (1991) eq. 34-43,
    with the determinant-sign fix so that R is a proper rotation for
    reflected constellations too. Returns s (...,), R (..., 3, 3),
    t (..., 3)."""
    mu_s = src.mean(dim=-2)
    mu_d = dst.mean(dim=-2)
    sc = src - mu_s[..., None, :]
    dc = dst - mu_d[..., None, :]
    cov = dc.transpose(-1, -2) @ sc / src.shape[-2]          # (..., 3, 3)
    U, S, Vt = torch.linalg.svd(cov)
    d = torch.sign(torch.linalg.det(U) * torch.linalg.det(Vt))
    diag = torch.ones(d.shape + (3,), dtype=src.dtype, device=src.device)
    diag[..., 2] = d
    R = (U * diag[..., None, :]) @ Vt
    if with_scale:
        var_s = torch.mean(torch.sum(sc * sc, dim=-1), dim=-1)
        s = torch.sum(S * diag, dim=-1) / torch.clamp(var_s, min=1e-12)
    else:
        s = torch.ones(d.shape, dtype=src.dtype, device=src.device)
    t = mu_d - s[..., None] * (R @ mu_s[..., None])[..., 0]
    return s, R, t


def align(src: torch.Tensor, dst: torch.Tensor,
          with_scale: bool = False) -> torch.Tensor:
    """src (..., T, 3) mapped onto dst's frame by the Umeyama transform."""
    s, R, t = umeyama(src, dst, with_scale)
    return s[..., None, None] * src @ R.transpose(-1, -2) + t[..., None, :]


def ate_rmse(est: torch.Tensor, gt: torch.Tensor, do_align: bool = True,
             with_scale: bool = False) -> torch.Tensor:
    """Absolute trajectory error, the RMSE over positions after removing
    the gauge. est, gt: (..., T, 3). Returns (...,)."""
    aligned = align(est, gt, with_scale) if do_align else est
    return torch.sqrt(torch.mean(torch.sum((aligned - gt) ** 2, dim=-1),
                                 dim=-1))


def _rel_pose(r0, q0, r1, q1):
    """Pose 0⁻¹ ∘ pose 1 of world-frame poses (position r, world-from-body
    quaternion q; the filter's x[0:3], x[3:7]): (Δr in frame 0, Δq)."""
    dr = (q2r(q0).transpose(-1, -2) @ (r1 - r0)[..., None])[..., 0]
    return dr, qprod(qconj(q0), q1)


def rpe(est_r: torch.Tensor, est_q: torch.Tensor, gt_r: torch.Tensor,
        gt_q: torch.Tensor, delta: int = 1):
    """Relative pose error over a horizon of `delta` frames.

    est_r, gt_r: (..., T, 3) positions; est_q, gt_q: (..., T, 4)
    quaternions. Returns (trans_rmse, rot_rmse_rad), each (...,): the RMS
    of the translation and of the rotation angle of gt_rel⁻¹ ∘ est_rel
    over the T − delta windows."""
    e_dr, e_dq = _rel_pose(est_r[..., :-delta, :], est_q[..., :-delta, :],
                           est_r[..., delta:, :], est_q[..., delta:, :])
    g_dr, g_dq = _rel_pose(gt_r[..., :-delta, :], gt_q[..., :-delta, :],
                           gt_r[..., delta:, :], gt_q[..., delta:, :])
    err_r = (q2r(g_dq).transpose(-1, -2) @ (e_dr - g_dr)[..., None])[..., 0]
    err_q = qprod(qconj(g_dq), e_dq)
    trans = torch.sqrt(torch.mean(torch.sum(err_r ** 2, dim=-1), dim=-1))
    # The angle as 2·atan2(‖vec‖, |w|): stable near 0.
    ang = 2.0 * torch.atan2(torch.linalg.vector_norm(err_q[..., 1:], dim=-1),
                            torch.abs(err_q[..., 0]))
    return trans, torch.sqrt(torch.mean(ang ** 2, dim=-1))


def evaluate_trajectory(traj: torch.Tensor, gt: torch.Tensor,
                        delta: int = 1, with_scale: bool = False) -> dict:
    """{ate, rpe_trans, rpe_rot} of a filter trajectory against ground
    truth. traj, gt: (..., T, >= 7) rows laid out like the filter's camera
    state (x[0:3] = r, x[3:7] = q); further columns are ignored."""
    ate = ate_rmse(traj[..., 0:3], gt[..., 0:3], with_scale=with_scale)
    tr, ro = rpe(traj[..., 0:3], traj[..., 3:7], gt[..., 0:3],
                 gt[..., 3:7], delta=delta)
    return {"ate": ate, "rpe_trans": tr, "rpe_rot": ro}
