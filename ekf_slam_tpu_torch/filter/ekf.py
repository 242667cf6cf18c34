"""EKF measurement-update gain (L2), batched over instances.

Port of ``ekf.update_gain`` and its two SPD-inverse solvers from
``ekf_slam_tpu/filter/ekf.py`` — the half of the masked update (update.m:
8-11) that the fused step runs outside the kernels; the covariance tail
runs in K2/K3 (ops/kernels.py).

Masked rows carry zero H and residual and unit noise, so S has an
identity block there and their gain columns are exactly zero. Every
product runs at the tensors' own precision: on the card in IEEE f32
(allow_tf32 off), on the CPU tests in f64.
"""

from __future__ import annotations

import torch


def update_gain(x: torch.Tensor, P, H: torch.Tensor, z: torch.Tensor,
                h: torch.Tensor, row_mask: torch.Tensor,
                r_diag: torch.Tensor, gain_solver: str = "cholesky",
                PHt: torch.Tensor | None = None):
    """x (B,D); H (B,M,D); z, h, row_mask, r_diag (B,M); PHt (B,D,M) the
    gain columns P·Hᵀ if the caller has them (then P is not read).
    Returns (x_new un-renormalized, K (B,D,M), PHt masked (B,D,M))."""
    mask = row_mask.to(x.dtype)
    H = H * mask[..., None]
    nu = (z - h) * mask
    r_eff = torch.where(row_mask, r_diag, torch.ones_like(r_diag))
    if PHt is None:
        PHt = P @ H.transpose(-1, -2)
    else:
        PHt = PHt * mask[:, None, :]
    S = H @ PHt + torch.diag_embed(r_eff)                  # (B, M, M), SPD
    W = (_spd_inverse_newton(S) if gain_solver == "newton"
         else _spd_inverse(S))
    K = PHt @ W
    return x + (K @ nu[..., None])[..., 0], K, PHt


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
