"""Camera motion models, their analytic Jacobians and process noise (L2).

Port of ``ekf_slam_tpu/filter/motion.py`` (fv.m, dfv_by_dxv.m,
func_Q.m) for all four motion models, on camera blocks xv with any
leading batch axes and the 13-vector on the last axis.
"""

from __future__ import annotations

import torch

from ekf_slam_tpu_torch import config as cfg_mod
from ekf_slam_tpu_torch.config import FilterConfig
from ekf_slam_tpu_torch.ops import quaternion as quat
from ekf_slam_tpu_torch.ops.consts import constant


def fv(xv: torch.Tensor, cfg: FilterConfig) -> torch.Tensor:
    """One motion-model step of the camera block (fv.m). (..., 13)."""
    dt = cfg.delta_t
    r, q, v, w = xv[..., 0:3], xv[..., 3:7], xv[..., 7:10], xv[..., 10:13]
    model = cfg.motion_model
    if model == cfg_mod.CONSTANT_VELOCITY:
        r_new = r + v * dt
        q_new = quat.qprod(q, quat.v2q(w * dt))
    elif model == cfg_mod.CONSTANT_ORIENTATION:
        r_new = r + v * dt
        q_new = q
        w = torch.zeros_like(w)
    elif model == cfg_mod.CONSTANT_POSITION:
        r_new = r
        q_new = quat.qprod(q, quat.v2q(w * dt))
        v = torch.zeros_like(v)
    elif model == cfg_mod.CONSTANT_POSITION_AND_ORIENTATION:
        r_new = r
        q_new = q
        v = torch.zeros_like(v)
        w = torch.zeros_like(w)
    else:
        raise ValueError(f"unknown motion model {model}")
    return torch.cat([r_new, q_new, v, w], dim=-1)


def dfv_by_dxv(xv: torch.Tensor, cfg: FilterConfig) -> torch.Tensor:
    """13x13 analytic state-transition Jacobian F (dfv_by_dxv.m).
    Returns (..., 13, 13)."""
    dt = cfg.delta_t
    q, w = xv[..., 3:7], xv[..., 10:13]
    eye = torch.eye(13, dtype=xv.dtype, device=xv.device)
    F = eye.expand(xv.shape[:-1] + (13, 13)).clone()
    eye3 = eye[:3, :3]
    # ∂(q ⊗ q(wΔt))/∂q is the right-multiplication matrix of q(wΔt).
    F[..., 3:7, 3:7] = quat.right_mult_matrix(quat.v2q(w * dt))
    model = cfg.motion_model
    if model == cfg_mod.CONSTANT_VELOCITY:
        F[..., 0:3, 7:10] = eye3 * dt
        F[..., 3:7, 10:13] = (quat.left_mult_matrix(q)
                              @ quat.dqomegadt_by_domega(w, dt))
    elif model == cfg_mod.CONSTANT_ORIENTATION:
        F[..., 0:3, 7:10] = eye3 * dt
        F[..., 3:7, 3:7] = eye[:4, :4]
        F[..., 10:13, 10:13] = 0.0
    elif model == cfg_mod.CONSTANT_POSITION:
        F[..., 7:10, 7:10] = 0.0
        F[..., 3:7, 10:13] = (quat.left_mult_matrix(q)
                              @ quat.dqomegadt_by_domega(w, dt))
    elif model == cfg_mod.CONSTANT_POSITION_AND_ORIENTATION:
        F[..., 3:7, 3:7] = eye[:4, :4]
        F[..., 7:10, 7:10] = 0.0
        F[..., 10:13, 10:13] = 0.0
    else:
        raise ValueError(f"unknown motion model {model}")
    return F


def process_noise(xv: torch.Tensor, cfg: FilterConfig) -> torch.Tensor:
    """Q = G Pn Gᵀ (func_Q.m:12-27), Pn = diag(σa²Δt², σα²Δt²) ⊗ I₃.
    Returns (..., 13, 13)."""
    dt = cfg.delta_t
    q, w = xv[..., 3:7], xv[..., 10:13]
    G = torch.zeros(xv.shape[:-1] + (13, 6), dtype=xv.dtype, device=xv.device)
    eye3 = torch.eye(3, dtype=xv.dtype, device=xv.device)
    G[..., 0:3, 0:3] = eye3 * dt
    G[..., 3:7, 3:6] = (quat.left_mult_matrix(q)
                        @ quat.dqomegadt_by_domega(w, dt))
    G[..., 7:10, 0:3] = eye3
    G[..., 10:13, 3:6] = eye3
    pn = constant((((cfg.sigma_a * dt) ** 2,) * 3
                   + ((cfg.sigma_alpha * dt) ** 2,) * 3), xv.dtype, xv.device)
    return (G * pn) @ G.transpose(-1, -2)


def process_noise_euler(xv: torch.Tensor, cfg: FilterConfig) -> torch.Tensor:
    """Q = G Pn Gᵀ with the Euler-angle noise G of the
    constant_position_and_orientation_location_noise model
    (func_Q.m:3-11): IΔt into r, ∂q/∂(rpy) at the current attitude into q.
    Returns (..., 13, 13)."""
    dt = cfg.delta_t
    rpy = quat.r2rpy(quat.q2r(xv[..., 3:7]))
    G = torch.zeros(xv.shape[:-1] + (13, 6), dtype=xv.dtype, device=xv.device)
    G[..., 0:3, 0:3] = torch.eye(3, dtype=xv.dtype, device=xv.device) * dt
    G[..., 3:7, 3:6] = quat.dq_by_deuler(rpy)
    pn = constant((((cfg.sigma_a * dt) ** 2,) * 3
                   + ((cfg.sigma_alpha * dt) ** 2,) * 3), xv.dtype, xv.device)
    return (G * pn) @ G.transpose(-1, -2)
