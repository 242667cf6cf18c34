"""Loop-closure constraints fused into the EKF, batched over instances.

Port of ``ekf_slam_tpu/filter/loop_fusion.py``. A declared loop becomes a
masked EKF measurement against the matched frame's stored pose:

* ``apply_loop_constraint`` — the 3-DoF position snap;
* ``apply_loop_constraint_pose`` — the 6-DoF pose constraint: position,
  and orientation as the small-angle rotation vector
  e = 2·vec(q_j⁻¹ ⊗ q), whose Jacobian in q is two rows of the left
  quaternion-product matrix, so the update is linear in q;
* ``loop_noise_sigmas`` — noise that shrinks with the verification's
  inlier count.

Both updates go through ``ekf.update``, masked by ``enabled``: its gain
columns P·Hᵀ in K6 ``f32_matmul_big`` and its covariance tail in K4
``corr_apply_cols`` on the card. A masked update still renormalizes q and
applies its covariance transform; callers that mask (models/loop_runner)
run it every frame.
"""

from __future__ import annotations

import torch

from ekf_slam_tpu_torch.filter import ekf
from ekf_slam_tpu_torch.ops import quaternion as quat
from ekf_slam_tpu_torch.ops.consts import constant


def _per_instance(v, B: int, dtype, device) -> torch.Tensor:
    """A scalar or (B,) value as a (B,) tensor; a Python scalar from
    ops/consts.py (a tensor made from host data each frame would be a
    synchronous copy, which CUDA graph capture refuses)."""
    if not isinstance(v, torch.Tensor):
        v = constant(v, dtype, device)
    return v.to(dtype=dtype, device=device).expand(B)


def apply_loop_constraint(x: torch.Tensor, P: torch.Tensor,
                          z_pos: torch.Tensor, sigma, enabled):
    """Masked position update. x (B,D), P (B,D,D), z_pos (B,3) the
    loop-closed position, sigma a float or (B,), enabled a bool or (B,)
    bool. Returns (x_new, P_new)."""
    B, D = x.shape
    H = torch.zeros(B, 3, D, dtype=x.dtype, device=x.device)
    H[:, :, 0:3] = torch.eye(3, dtype=x.dtype, device=x.device)
    mask = _per_instance(enabled, B, torch.bool, x.device)[:, None].expand(
        B, 3)
    r = (_per_instance(sigma, B, x.dtype, x.device) ** 2)[:, None].expand(
        B, 3)
    return ekf.update(x, P, H, z_pos, x[:, 0:3], mask, r.contiguous())


def loop_noise_sigmas(inliers: torch.Tensor, base_pos: float = 0.5,
                      base_rot: float = 0.2, ref_inliers: int = 8):
    """(sigma_pos, sigma_rot), each shaped like `inliers`: base / √(n/ref),
    n = max(inliers, 1) — the constraint is the mean of n independent
    geometric agreements. float32, as in the JAX package."""
    scale = torch.sqrt(ref_inliers / torch.clamp(
        inliers.to(torch.float32), min=1.0))
    return base_pos * scale, base_rot * scale


def apply_loop_constraint_pose(x: torch.Tensor, P: torch.Tensor,
                               pose_j: torch.Tensor, sigma_pos, sigma_rot,
                               enabled):
    """Masked 6-DoF pose update against a stored frame pose.

    x (B,D), P (B,D,D); pose_j (B,7) [r_j, q_j] of the matched frame;
    sigma_pos, sigma_rot floats or (B,); enabled a bool or (B,) bool.
    Rows 0:3 the position residual r − r_j (H = I₃ on dims 0:3), rows 3:6
    e = 2·vec(q_j⁻¹ ⊗ q) (H = 2·L(q_j⁻¹)[1:4] on dims 3:7).
    Returns (x_new, P_new)."""
    B, D = x.shape
    dtype, dev = x.dtype, x.device
    r_j, q_j = pose_j[:, 0:3], pose_j[:, 3:7]
    # An empty DB slot stores an all-zero pose and the masked caller
    # evaluates this update every frame: a bare divide by ‖0‖ would put a
    # NaN in the gain that survives the mask. Such a q_j becomes the
    # identity quaternion.
    nj = torch.linalg.vector_norm(q_j, dim=1, keepdim=True)
    ident = constant((1.0, 0.0, 0.0, 0.0), dtype, dev)
    q_j = torch.where(nj > 1e-6, q_j / torch.clamp(nj, min=1e-6), ident)
    q = x[:, 3:7]
    # q and −q are one rotation: measure against the representative
    # nearest the estimate so that e stays small.
    q_j = q_j * torch.where(torch.sum(q * q_j, dim=1, keepdim=True) < 0,
                            -1.0, 1.0).to(dtype)
    Lj = quat.left_mult_matrix(quat.qconj(q_j))             # (B, 4, 4)
    e = 2.0 * (Lj @ q[..., None])[:, 1:4, 0]

    H = torch.zeros(B, 6, D, dtype=dtype, device=dev)
    H[:, 0:3, 0:3] = torch.eye(3, dtype=dtype, device=dev)
    H[:, 3:6, 3:7] = 2.0 * Lj[:, 1:4, :]
    z = torch.cat([r_j, torch.zeros_like(r_j)], dim=1)
    h = torch.cat([x[:, 0:3], e], dim=1)
    mask = _per_instance(enabled, B, torch.bool, dev)[:, None].expand(B, 6)
    sp = _per_instance(sigma_pos, B, dtype, dev) ** 2
    sr = _per_instance(sigma_rot, B, dtype, dev) ** 2
    r_diag = torch.cat([sp[:, None].expand(B, 3), sr[:, None].expand(B, 3)],
                       dim=1)
    return ekf.update(x, P, H, z, h, mask, r_diag)
