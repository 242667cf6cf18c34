"""Data association: individual compatibility + high-innovation rescue (L4).

Port of ``ekf_slam_tpu/filter/association.py``: the filter-side
acceptance logic of matching.m and rescue_hi_inliers.m over all slots of
all instances ((B, CAP) masks).
"""

from __future__ import annotations

import torch

from ekf_slam_tpu_torch.config import EngineConfig


def _solve_2x2(S: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched S⁻¹ v for (…,2,2) S and (…,2) v via the adjugate; a zero
    determinant divides by 1 instead."""
    det = S[..., 0, 0] * S[..., 1, 1] - S[..., 0, 1] * S[..., 1, 0]
    safe_det = torch.where(det == 0, torch.ones_like(det), det)
    x0 = (S[..., 1, 1] * v[..., 0] - S[..., 0, 1] * v[..., 1]) / safe_det
    x1 = (-S[..., 1, 0] * v[..., 0] + S[..., 0, 0] * v[..., 1]) / safe_det
    return torch.stack([x0, x1], dim=-1)


def mahalanobis2(nu: torch.Tensor, S: torch.Tensor) -> torch.Tensor:
    """νᵀ S⁻¹ ν for batched 2-vectors / 2x2 matrices."""
    return torch.sum(nu * _solve_2x2(S, nu), dim=-1)


def max_eig_2x2(S: torch.Tensor) -> torch.Tensor:
    """Largest eigenvalue of symmetric 2x2 blocks (matching.m:16 gate)."""
    tr = S[..., 0, 0] + S[..., 1, 1]
    det = S[..., 0, 0] * S[..., 1, 1] - S[..., 0, 1] * S[..., 1, 0]
    disc = torch.sqrt(torch.clamp(tr * tr / 4.0 - det, min=0.0))
    return tr / 2.0 + disc


def individually_compatible(z, z_valid, h, visible, S,
                            cfg: EngineConfig) -> torch.Tensor:
    """IC mask (matching.m): a measurement exists, the slot is predicted
    visible, νᵀS⁻¹ν < χ²(2, 95%) and the largest eigenvalue of S < 100."""
    mc = cfg.matching
    nu = z - h
    gate_chi2 = mahalanobis2(nu, S) < mc.chi2_inv_2_95
    gate_eig = max_eig_2x2(S) < mc.max_innovation_eig
    return z_valid & visible & gate_chi2 & gate_eig


def rescue_high_innovation(z, h_post, S_noR, ic, li,
                           cfg: EngineConfig) -> torch.Tensor:
    """HI mask: IC matches not already LI whose posterior innovation passes
    the χ² gate with S = H P Hᵀ, no R (rescue_hi_inliers.m:6-21)."""
    nu = z - h_post
    gate = mahalanobis2(nu, S_noR) < cfg.matching.chi2_inv_2_95
    return ic & ~li & gate
