"""Measurement model over all landmark slots of all instances (L3).

Port of the parts of ``ekf_slam_tpu/filter/measurement.py`` the two
steps use: prediction with the ±60° FoV and in-image gates
(hi_inverse_depth.m / hi_cartesian.m), the analytic per-slot Jacobian
blocks H_xv (B,CAP,2,13) / H_y (B,CAP,2,6) in the default chain form
(calculate_Hi_*.m), the dense transposed Jacobian the fused kernels
consume, the compact gathered Jacobian of the M-slot updates made dense
(slot-pair row order, which the column-form updates take as blocks,
ekf.JacobianBlocks; and the row-form update's block order), the
row-form H·P rows of every slot (``pht_rows_split``), and the per-slot
innovation covariances (search_IC_matches.m:8) — read off the fused
kernels' P·Hᵀ columns, the H·P rows, or in the unfused step from P's
camera rows and slot diagonal blocks. A cartesian landmark occupies the
first 3 dims of its 6-wide slot. ``predict_and_linearize`` gives
prediction, Jacobians and S in one call. What is read of P goes through
``ekf.p_compute`` (a bf16-stored P upcasts).
"""

from __future__ import annotations

import torch

from ekf_slam_tpu_torch.config import CAM_DIM, CameraConfig, EngineConfig
from ekf_slam_tpu_torch.filter.ekf import p_compute
from ekf_slam_tpu_torch.filter.state import FilterState
from ekf_slam_tpu_torch.ops import camera as cam_ops
from ekf_slam_tpu_torch.ops import quaternion as quat
from ekf_slam_tpu_torch.ops.consts import constant


def one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """jax.nn.one_hot: (..., n); an index outside [0, n) gives a zero row."""
    ar = torch.arange(n, device=idx.device)
    return (idx[..., None] == ar).to(dtype)


def camera_frame_points(x: torch.Tensor, slots: torch.Tensor,
                        cartesian: torch.Tensor) -> torch.Tensor:
    """h_C for every slot: R_cw((y−t)ρ + m) for inverse-depth
    (hi_inverse_depth.m:16), R_cw(y−t) for cartesian (hi_cartesian.m:8).
    x (B,D); slots (B,CAP,6); cartesian (B,CAP). Returns (B,CAP,3)."""
    t_wc = x[:, None, 0:3]
    R_wc = quat.q2r(x[:, 3:7])
    y3 = slots[..., 0:3]
    theta, phi, rho = slots[..., 3], slots[..., 4], slots[..., 5]
    mi = quat.azel_to_ray(theta, phi)
    v_id = (y3 - t_wc) * rho[..., None] + mi
    v_cart = y3 - t_wc
    v = torch.where(cartesian[..., None], v_cart, v_id)
    return v @ R_wc                                       # R_wcᵀ v per slot


def predict_measurements(x: torch.Tensor, active: torch.Tensor,
                         cartesian: torch.Tensor, cfg: EngineConfig):
    """Project every active slot; gate by FoV and image bounds.
    Returns (h (B,CAP,2) distorted pixels, visible (B,CAP), hc (B,CAP,3))."""
    cam = cfg.camera
    B, cap = active.shape
    slots = x[:, CAM_DIM:].reshape(B, cap, 6)
    hc = camera_frame_points(x, slots, cartesian)
    lim = torch.deg2rad(constant(cfg.matching.fov_limit_deg, x.dtype,
                                 x.device))
    ax = torch.atan2(hc[..., 0], hc[..., 2])
    ay = torch.atan2(hc[..., 1], hc[..., 2])
    in_fov = (torch.abs(ax) <= lim) & (torch.abs(ay) <= lim)
    dummy = constant((0.0, 0.0, 1.0), x.dtype, x.device)
    hc_safe = torch.where(in_fov[..., None], hc, dummy)
    h = cam_ops.distort(cam_ops.project(hc_safe, cam), cam)
    in_image = ((h[..., 0] > 0) & (h[..., 0] < cam.n_cols)
                & (h[..., 1] > 0) & (h[..., 1] < cam.n_rows))
    return h, active & in_fov & in_image, hc


def jacobians(x: torch.Tensor, h: torch.Tensor, hc: torch.Tensor,
              cartesian: torch.Tensor, cam: CameraConfig):
    """Analytic per-slot measurement Jacobians (calculate_Hi_*.m):
    dh_dhrl = inv(jacob_undistort(h))·dhu_dhrl, then the camera-position,
    quaternion and landmark chains. Returns H_xv (B,CAP,2,13),
    H_y (B,CAP,2,6)."""
    dtype, device = x.dtype, x.device
    B, cap = cartesian.shape
    slots = x[:, CAM_DIM:].reshape(B, cap, 6)
    rw, qwr = x[:, 0:3], x[:, 3:7]
    R_wc = quat.q2r(qwr)                                  # (B,3,3)
    R_cw = R_wc.transpose(-1, -2)
    y3 = slots[..., 0:3]
    theta, phi, rho = slots[..., 3], slots[..., 4], slots[..., 5]
    mi = quat.azel_to_ray(theta, phi)
    cart3 = cartesian[..., None, None]

    dh_dhrl = cam_ops.jacob_distort(h, cam) @ cam_ops.dhu_dhrl(hc, cam)

    dhrl_drw_id = -R_cw[:, None] * rho[..., None, None]
    dhrl_drw = torch.where(cart3, -R_cw[:, None], dhrl_drw_id)

    a_id = (y3 - rw[:, None]) * rho[..., None] + mi
    a = torch.where(cartesian[..., None], y3 - rw[:, None], a_id)
    qbar = quat.qconj(qwr)[:, None].expand(B, cap, 4)
    dhrl_dq = (quat.dRq_times_a_by_dq(qbar, a)
               @ quat.dqbar_dq(dtype, device))

    dmi_dth = quat.dm_dtheta(theta, phi) @ R_wc           # R_cw·dm per slot
    dmi_dph = quat.dm_dphi(theta, phi) @ R_wc
    ry = (y3 - rw[:, None]) @ R_wc                        # R_cw (y − r)
    dhrl_dy_id = torch.cat([
        R_cw[:, None] * rho[..., None, None],
        dmi_dth[..., None], dmi_dph[..., None], ry[..., None]], dim=-1)
    dhrl_dy_cart = torch.cat([
        R_cw[:, None].expand(B, cap, 3, 3),
        torch.zeros(B, cap, 3, 3, dtype=dtype, device=device)], dim=-1)
    dhrl_dy = torch.where(cart3, dhrl_dy_cart, dhrl_dy_id)

    H_xv = torch.cat([
        dh_dhrl @ dhrl_drw, dh_dhrl @ dhrl_dq,
        torch.zeros(B, cap, 2, 6, dtype=dtype, device=device)], dim=-1)
    return H_xv, dh_dhrl @ dhrl_dy


def dense_Ht(H_xv: torch.Tensor, H_y: torch.Tensor,
             row_mask: torch.Tensor) -> torch.Tensor:
    """Transposed dense Jacobian (B, D, 2·CAP), masked slots zeroed:
    camera rows from H_xv, block-diagonal landmark rows from H_y — the
    layout whose row blocks the K1/K2 products stream."""
    B, cap = row_mask.shape
    m = row_mask.to(H_xv.dtype)[..., None, None]
    Hxv_t = (H_xv * m).reshape(B, 2 * cap, CAM_DIM).transpose(1, 2)
    eye = torch.eye(cap, dtype=H_xv.dtype, device=H_xv.device)
    Hy_t = torch.einsum("nj,bnck->bjknc", eye, H_y * m).reshape(
        B, 6 * cap, 2 * cap)
    return torch.cat([Hxv_t, Hy_t], dim=1)


def compact_dense_H(H_xv: torch.Tensor, H_y: torch.Tensor,
                    slots: torch.Tensor, row_mask: torch.Tensor,
                    cap: int) -> torch.Tensor:
    """Dense Jacobian (B, 2M, 13+6·cap) of M gathered slots: H_xv
    (B,M,2,13), H_y (B,M,2,6) already gathered at `slots` (B,M); the
    landmark block lands at column 13+6·slots[m] through a one-hot."""
    B, M = slots.shape
    mask = row_mask.to(H_xv.dtype)[..., None, None]
    Hxv = (H_xv * mask).reshape(B, 2 * M, CAM_DIM)
    oh = one_hot(slots, cap, H_xv.dtype)                  # (B, M, CAP)
    Hy = torch.einsum("bmc,bmij->bmicj", oh, H_y * mask)
    return torch.cat([Hxv, Hy.reshape(B, 2 * M, 6 * cap)], dim=2)


def compact_dense_H_block(H_xv: torch.Tensor, H_y: torch.Tensor,
                          slots: torch.Tensor, row_mask: torch.Tensor,
                          cap: int) -> torch.Tensor:
    """compact_dense_H in block row order (B, 2M, D): rows [0:M] every
    gathered slot's u row, rows [M:2M] its v row — the order of the
    row-form update's H·P operand (the update is invariant to a
    permutation of its rows)."""
    B, M = slots.shape
    mask = row_mask.to(H_xv.dtype)[..., None]
    oh = one_hot(slots, cap, H_xv.dtype)                  # (B, M, CAP)
    rows = []
    for comp in range(2):
        Hy = torch.einsum("bmc,bmj->bmcj", oh, H_y[:, :, comp] * mask)
        rows.append(torch.cat([H_xv[:, :, comp] * mask,
                               Hy.reshape(B, M, 6 * cap)], dim=2))
    return torch.cat(rows, dim=1)


def pht_rows_split(P: torch.Tensor, H_xv: torch.Tensor, H_y: torch.Tensor):
    """Every slot's gain rows H·P, split by pixel component: (hp_u, hp_v),
    each (B, CAP, D), hp_comp[c] = H_{c,comp}·P from the 13 camera rows
    and slot c's own 6 rows of P (H's two blocks). P must be symmetric,
    so these rows are the gain columns P·Hᵀ transposed. H_xv (B,CAP,2,13),
    H_y (B,CAP,2,6) carry any slot mask already."""
    B, cap = H_xv.shape[:2]
    cam = p_compute(P[:, :CAM_DIM, :])                    # (B, 13, D)
    Pm = P[:, CAM_DIM:CAM_DIM + 6 * cap, :]
    hp = []
    for comp in range(2):
        acc = H_xv[:, :, comp] @ cam                      # (B, CAP, D)
        for j in range(6):
            acc = acc + H_y[:, :, comp, j, None] * p_compute(Pm[:, j::6])
        hp.append(acc)
    return hp[0], hp[1]


def innovation_covariances_from_hp(hp_u: torch.Tensor, hp_v: torch.Tensor,
                                   H_xv: torch.Tensor, H_y: torch.Tensor,
                                   sigma_z: float):
    """Per-slot S_i[a,b] = hp_a[i]·H_{i,b} + σ_z² δ_ab from the split gain
    rows (pht_rows_split): the camera block a 13-column slice, the slot
    block slot i's own 6 columns. H blocks carry the hp rows' mask.
    Returns (B, CAP, 2, 2)."""
    B, cap = H_xv.shape[:2]
    cols = (CAM_DIM + 6 * torch.arange(cap, device=hp_u.device)[:, None]
            + torch.arange(6, device=hp_u.device)).expand(B, cap, 6)
    rows = []
    for hp in (hp_u, hp_v):
        t_cam = torch.einsum("bck,bcjk->bcj", hp[:, :, :CAM_DIM], H_xv)
        t_slot = torch.einsum("bcp,bcjp->bcj", torch.gather(hp, 2, cols),
                              H_y)
        rows.append(t_cam + t_slot)                       # (B, CAP, 2)
    R = (sigma_z ** 2) * torch.eye(2, dtype=hp_u.dtype, device=hp_u.device)
    return torch.stack(rows, dim=2) + R


def _slot_diag_blocks(P: torch.Tensor, cap: int) -> torch.Tensor:
    """(B, CAP, 6, 6) diagonal landmark blocks of P in its compute dtype:
    the diagonal of the (B, CAP, 6, CAP, 6) view of the map block (an
    exact selection)."""
    B = P.shape[0]
    Pm = P[:, CAM_DIM:CAM_DIM + 6 * cap, CAM_DIM:CAM_DIM + 6 * cap]
    return p_compute(torch.diagonal(Pm.reshape(B, cap, 6, cap, 6), dim1=1,
                                    dim2=3).permute(0, 3, 1, 2))


def innovation_covariances(P: torch.Tensor, H_xv: torch.Tensor,
                           H_y: torch.Tensor, sigma_z: float):
    """Per-slot S_i = H_i P H_iᵀ + σ_z² I₂ for all slots from P (B,D,D)
    (search_IC_matches.m:8), through its 13 camera rows and its slot
    diagonal blocks. Returns (B, CAP, 2, 2)."""
    cap = H_xv.shape[1]
    return innovation_covariances_from_blocks(
        p_compute(P[:, :CAM_DIM, :]), _slot_diag_blocks(P, cap), H_xv, H_y,
        sigma_z)


def predict_and_linearize(x: torch.Tensor, P: torch.Tensor,
                          state: FilterState, cfg: EngineConfig):
    """h, visible, H_xv, H_y and the per-slot S at (x (B,D), P (B,D,D)) in
    one call (predict_camera_measurements + calculate_derivatives + the S
    loop of search_IC_matches.m:4-9)."""
    h, visible, hc = predict_measurements(x, state.active, state.cartesian,
                                          cfg)
    H_xv, H_y = jacobians(x, h, hc, state.cartesian, cfg.camera)
    S = innovation_covariances(P, H_xv, H_y, cfg.filter.sigma_z)
    return h, visible, H_xv, H_y, S


def innovation_covariances_from_blocks(top13: torch.Tensor,
                                       Pyy: torch.Tensor,
                                       H_xv: torch.Tensor, H_y: torch.Tensor,
                                       sigma_z: float):
    """S_i = Hxvᵢ P₁₁ Hxvᵢᵀ + Hxvᵢ P₁ᵧᵢ Hyᵢᵀ + (·)ᵀ + Hyᵢ Pᵧᵢᵧᵢ Hyᵢᵀ + R
    from the camera rows top13 (B,13,D) and the slot diagonal blocks Pyy
    (B,CAP,6,6). Returns (B, CAP, 2, 2)."""
    B, cap = H_xv.shape[:2]
    P11 = top13[:, :, :CAM_DIM]
    P1y = top13[:, :, CAM_DIM:CAM_DIM + 6 * cap].reshape(
        B, CAM_DIM, cap, 6).permute(0, 2, 1, 3)           # (B, CAP, 13, 6)
    t1 = torch.einsum("bnij,bjk,bnlk->bnil", H_xv, P11, H_xv)
    t2 = torch.einsum("bnij,bnjk,bnlk->bnil", H_xv, P1y, H_y)
    t3 = torch.einsum("bnij,bnjk,bnlk->bnil", H_y, Pyy, H_y)
    R = (sigma_z ** 2) * torch.eye(2, dtype=top13.dtype, device=top13.device)
    return t1 + t2 + t2.transpose(-1, -2) + t3 + R


def innovation_covariances_from_pht(pht3: torch.Tensor, H_xv: torch.Tensor,
                                    H_y: torch.Tensor, sigma_z: float):
    """Per-slot S_i = H_i (P H_iᵀ) + σ_z² I from the gain columns pht3
    (B, D, CAP, 2): the 13 camera rows and slot i's own 6 rows of its
    column pair contribute. Returns (B, CAP, 2, 2)."""
    B, D, cap, _ = pht3.shape
    t1 = torch.einsum("bcik,bkcj->bcij", H_xv, pht3[:, :CAM_DIM])
    pht_m = pht3[:, CAM_DIM:].reshape(B, cap, 6, cap, 2)
    diag = torch.diagonal(pht_m, dim1=1, dim2=3).permute(0, 3, 1, 2)
    t2 = torch.einsum("bcik,bckj->bcij", H_y, diag)       # (B, CAP, 2, 2)
    R = (sigma_z ** 2) * torch.eye(2, dtype=pht3.dtype, device=pht3.device)
    return t1 + t2 + R
