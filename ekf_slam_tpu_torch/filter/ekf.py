"""EKF predict and measurement update (L2), batched over instances.

Port of ``ekf_slam_tpu/filter/ekf.py`` in its default forms:

* ``predict``: the block-sparse time update in the "pred" stripe form —
  only the 13 camera rows and columns of P change
  (predict_state_and_covariance.m:26-27);
* ``update_gain``: the gain half of the masked update (update.m:8-11),
  with its two SPD-inverse solvers. Without the caller's gain columns it
  forms P·Hᵀ in ``kernels.f32_matmul_big`` (K6);
* ``update``: the whole masked update. Its covariance tail (downdate,
  symmetrize, quaternion renorm; update.m:13-24) runs in K5
  ``kernels.fused_update_tail`` when ``use_pallas`` is set and x is f32,
  else as the folded rank-(2M'+8) correction applied by K4
  ``kernels.corr_apply_cols``.

The fused step runs ``update_gain`` with the gain columns of K1/K2 and
its tails in K2/K3. Masked rows carry zero H and residual and unit noise,
so S has an identity block there and their gain columns are exactly zero.
Every product runs at the tensors' own precision: on the card in IEEE f32
(allow_tf32 off), on the CPU tests in f64.
"""

from __future__ import annotations

import torch

from ekf_slam_tpu_torch.config import CAM_DIM, FilterConfig
from ekf_slam_tpu_torch.filter import motion
from ekf_slam_tpu_torch.ops import kernels
from ekf_slam_tpu_torch.ops import quaternion as quat


def predict(x: torch.Tensor, P: torch.Tensor, cfg: FilterConfig):
    """EKF time update (predict_state_and_covariance.m:1-27). x (B,D),
    P (B,D,D). P⁻ = [F P₁₁ Fᵀ + Q, F P₁ₘ; Pₘ₁ Fᵀ, Pₘₘ]: top = F·P[:13]
    is written as the 13-row stripe, its map part transposed as the
    13-column stripe below it. Returns (x⁻, P⁻)."""
    xv = x[:, :CAM_DIM]
    x_pred = torch.cat([motion.fv(xv, cfg), x[:, CAM_DIM:]], dim=1)
    F = motion.dfv_by_dxv(xv, cfg)
    Q = motion.process_noise(xv, cfg)
    top = F @ P[:, :CAM_DIM, :]                                  # (B, 13, D)
    top = torch.cat([top[:, :, :CAM_DIM] @ F.transpose(1, 2) + Q,
                     top[:, :, CAM_DIM:]], dim=2)
    P_pred = P.clone()
    P_pred[:, :CAM_DIM, :] = top
    P_pred[:, CAM_DIM:, :CAM_DIM] = top[:, :, CAM_DIM:].transpose(1, 2)
    return x_pred, P_pred


def update_gain(x: torch.Tensor, P, H: torch.Tensor, z: torch.Tensor,
                h: torch.Tensor, row_mask: torch.Tensor,
                r_diag: torch.Tensor, gain_solver: str = "cholesky",
                PHt: torch.Tensor | None = None):
    """x (B,D); H (B,M,D); z, h, row_mask, r_diag (B,M); PHt (B,D,M) the
    gain columns P·Hᵀ if the caller has them (then P is not read; else
    K6 forms them from P (B,D,D)).
    Returns (x_new un-renormalized, K (B,D,M), PHt masked (B,D,M))."""
    mask = row_mask.to(x.dtype)
    H = H * mask[..., None]
    nu = (z - h) * mask
    r_eff = torch.where(row_mask, r_diag, torch.ones_like(r_diag))
    if PHt is None:
        PHt = kernels.f32_matmul_big(P, H.transpose(1, 2).contiguous())
    else:
        PHt = PHt * mask[:, None, :]
    S = H @ PHt + torch.diag_embed(r_eff)                  # (B, M, M), SPD
    W = (_spd_inverse_newton(S) if gain_solver == "newton"
         else _spd_inverse(S))
    K = PHt @ W
    return x + (K @ nu[..., None])[..., 0], K, PHt


def _renormalized(x: torch.Tensor) -> torch.Tensor:
    """x with its quaternion x[:, 3:7] scaled to unit norm."""
    q = x[:, 3:7]
    return torch.cat([x[:, :3], q / torch.linalg.vector_norm(
        q, dim=1, keepdim=True), x[:, 7:]], dim=1)


def _folded_tail_factors(x_new: torch.Tensor, P4: torch.Tensor,
                         K: torch.Tensor, PHt: torch.Tensor):
    """Factors (Ā, B̄) of the folded covariance tail P⁺ = P + Ā·B̄ᵀ: the
    symmetric downdate and the quaternion-renorm transform T = I + E₄GE₄ᵀ
    (G = normJac(q) − I₄ on dims 3:7) as one rank-(2M'+8) correction,
    valid for a symmetric P:

      Ā = [−½A | E₄ | W + E₄·(G·M₄₄·Gᵀ)],  B̄ = [B | W | E₄],
      A = [K | PHt],  B = [PHt | K],  M₄ = P₄ − ½A₄Bᵀ,  W = M₄ᵀGᵀ.

    x_new (B,D); P4 rows 3:7 of P (B,4,D); K, PHt (B,D,M').
    Returns (x renormalized, Ā (B,D,2M'+8), B̄ (B,D,2M'+8))."""
    B_, D, _ = K.shape
    dtype, device = K.dtype, K.device
    A = torch.cat([K, PHt], dim=2)                         # (B, D, 2M')
    Bm = torch.cat([PHt, K], dim=2)
    eye4 = torch.eye(4, dtype=dtype, device=device)
    G = quat.norm_jac(x_new[:, 3:7]) - eye4
    M4 = P4 - 0.5 * (A[:, 3:7, :] @ Bm.transpose(1, 2))   # (B, 4, D)
    M44 = M4[:, :, 3:7]
    W = M4.transpose(1, 2) @ G.transpose(1, 2)             # (B, D, 4)
    E4 = torch.zeros(D, 4, dtype=dtype, device=device)
    E4[3:7] = eye4
    E4 = E4.expand(B_, D, 4)
    A_f = torch.cat([-0.5 * A, E4, W + E4 @ (G @ M44 @ G.transpose(1, 2))],
                    dim=2)
    B_f = torch.cat([Bm, W, E4], dim=2)
    return _renormalized(x_new), A_f, B_f


def update(x: torch.Tensor, P: torch.Tensor, H: torch.Tensor,
           z: torch.Tensor, h: torch.Tensor, row_mask: torch.Tensor,
           r_diag: torch.Tensor, use_pallas: bool = False,
           gain_solver: str = "cholesky"):
    """Masked EKF measurement update (update.m:1-32). H (B,M,D) dense
    Jacobian; z, h, row_mask, r_diag (B,M). P enters symmetric.

    The tail runs in K5 when use_pallas is set and x is float32 (as the
    JAX package takes its fused_update_tail kernel only at f32), else as
    the folded correction in K4, whose output is bitwise symmetric.
    Returns (x_new, P_new)."""
    x_new, K, PHt = update_gain(x, P, H, z, h, row_mask, r_diag,
                                gain_solver)
    if use_pallas and x.dtype == torch.float32:
        Jq = quat.norm_jac(x_new[:, 3:7])
        return _renormalized(x_new), kernels.fused_update_tail(P, K, PHt, Jq)
    x_new, A_f, B_f = _folded_tail_factors(x_new, P[:, 3:7, :], K, PHt)
    return x_new, kernels.corr_apply_cols(P, A_f, B_f)


def _spd_inverse(S: torch.Tensor) -> torch.Tensor:
    """SPD inverse via Cholesky: S⁻¹ = L⁻ᵀ L⁻¹. cholesky_ex does not check
    for failure (no host sync); a non-SPD S yields non-finite values, as
    in JAX."""
    L = torch.linalg.cholesky_ex(S).L
    eye = torch.eye(S.shape[-1], dtype=S.dtype, device=S.device)
    Linv = torch.linalg.solve_triangular(L, eye.expand_as(S), upper=False)
    return Linv.transpose(-1, -2) @ Linv


def _spd_inverse_newton(S: torch.Tensor, iters: int = 20) -> torch.Tensor:
    """SPD inverse by Newton-Schulz iteration X ← X(2I − SX) from the
    Jacobi-preconditioned start X₀ = D⁻¹/λ̂ (λ̂ the Gershgorin bound of
    D^-½ S D^-½), whose spectrum of S·X₀ lies in (0, 1]. The JAX solver
    runs 17 of its 20 iterations at the TPU's bf16 matmul precision; here
    every iteration runs at the tensors' own precision (IEEE f32 on the
    card)."""
    eye = torch.eye(S.shape[-1], dtype=S.dtype, device=S.device)
    d = torch.diagonal(S, dim1=-2, dim2=-1)
    d = torch.where(d > 0, d, torch.ones_like(d))
    rsd = torch.rsqrt(d)
    S_hat_rows = torch.sum(
        torch.abs(S) * rsd[..., :, None] * rsd[..., None, :], dim=-1)
    lam_up = torch.amax(S_hat_rows, dim=-1)
    X = (eye / d[..., None, :]) / lam_up[..., None, None]
    for _ in range(iters):
        X = X @ (2.0 * eye - S @ X)
    return X
