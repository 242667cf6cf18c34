"""Map management in closed low-rank form (L3), batched over instances.

Port of the parts of ``ekf_slam_tpu/filter/mapman.py`` the two steps and
``bootstrap`` use. Both map transforms are expressed as
P' = M∘P + EᵀU + UᵀE + EᵀCE, M∘ a keep-mask outer product:

* ``manage_params``: the delete rule (drop a feature once times_measured
  < ratio·times_predicted after >= min predictions — the policy of the
  reference's missing delete_features.m) plus at most one inverse-depth →
  cartesian conversion (inversedepth_2_cartesian.m), giving ManageParams;
  K1 applies its P transform in the fused step, ``apply_manage_P`` in
  the unfused one (``manage``).
* ``add_params``: the batched feature add of all K candidates
  (add_a_feature_covariance_inverse_depth.m:35-64), computable from the
  13 camera rows of P; K3 applies it, ``add_features_batch`` applies it
  with one stacked product (bootstrap).
* ``update_counters`` (update_features_info.m:4-10).

P is read through ``ekf.p_compute`` and a new full P written through
``ekf.p_store``, so a bf16-stored P stays bf16.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ekf_slam_tpu_torch.config import CAM_DIM, EngineConfig
from ekf_slam_tpu_torch.filter.ekf import p_compute, p_store
from ekf_slam_tpu_torch.filter.measurement import one_hot
from ekf_slam_tpu_torch.filter.state import FilterState
from ekf_slam_tpu_torch.ops import camera as cam_ops
from ekf_slam_tpu_torch.ops import quaternion as quat
from ekf_slam_tpu_torch.ops.consts import constant


class AddParams(NamedTuple):
    keep_f: torch.Tensor   # (B, D) 0/1 — zeroes the newly-assigned dims
    E: torch.Tensor        # (B, 6K, D) one-hot rows of the new dims
    U: torch.Tensor        # (B, 6K, D) new rows (new columns zeroed)
    C: torch.Tensor        # (B, 6K, 6K) new-block covariance (incl. noise)
    state: FilterState     # x / masks / counters updated; P untouched


class ManageParams(NamedTuple):
    keep_f: torch.Tensor   # (B, D) 0/1 — kept dims (delete + converted slot)
    E6: torch.Tensor       # (B, 6, D) one-hot rows of the converted slot
    U6: torch.Tensor       # (B, 6, D) replacement rows (masked)
    C66: torch.Tensor      # (B, 6, 6) replacement diagonal block
    slot: torch.Tensor     # (B,) int64 — converted slot (0 when do=False)
    do: torch.Tensor       # (B,) bool — a conversion happened
    state: FilterState     # x / masks / counters managed; P untouched


def _dim_mask(slot_mask: torch.Tensor) -> torch.Tensor:
    """(B, CAP) slot mask -> (B, D) dim mask, camera dims False."""
    B = slot_mask.shape[0]
    cam = torch.zeros(B, CAM_DIM, dtype=torch.bool, device=slot_mask.device)
    return torch.cat([cam, slot_mask.repeat_interleave(6, dim=1)], dim=1)


def add_feature_jacobians(uvd: torch.Tensor, x_cam: torch.Tensor,
                          cfg: EngineConfig):
    """dy_dxv (...,6,13) and dy_dhd (...,6,3) of new inverse-depth features
    at pixels uvd (...,2) seen from camera blocks x_cam (...,13)
    (add_a_feature_covariance_inverse_depth.m:28-57)."""
    cam = cfg.camera
    dtype, device = x_cam.dtype, x_cam.device
    lead = uvd.shape[:-1]
    fku = cam.f / cam.d
    q_wc = x_cam[..., 3:7].expand(lead + (4,))
    R_wc = quat.q2r(q_wc)
    uvu = cam_ops.undistort(uvd, cam)
    xyz_c = torch.stack([-(cam.cx - uvu[..., 0]) / fku,
                         -(cam.cy - uvu[..., 1]) / fku,
                         torch.ones_like(uvu[..., 0])], dim=-1)
    xyz_w = (R_wc @ xyz_c[..., None])[..., 0]
    Xw, Yw, Zw = xyz_w[..., 0], xyz_w[..., 1], xyz_w[..., 2]
    xz2 = Xw * Xw + Zw * Zw
    r2 = xz2 + Yw * Yw
    sxz = torch.sqrt(xz2)
    dtheta_dgw = torch.stack([Zw / xz2, torch.zeros_like(Zw), -Xw / xz2], -1)
    dphi_dgw = torch.stack([Xw * Yw / (r2 * sxz), -sxz / r2,
                            Zw * Yw / (r2 * sxz)], -1)
    dgw_dqwr = quat.dRq_times_a_by_dq(q_wc, xyz_c)          # (...,3,4)

    dy_dxv = torch.zeros(lead + (6, CAM_DIM), dtype=dtype, device=device)
    dy_dxv[..., 0:3, 0:3] = torch.eye(3, dtype=dtype, device=device)
    dy_dxv[..., 3, 3:7] = (dtheta_dgw[..., None, :] @ dgw_dqwr)[..., 0, :]
    dy_dxv[..., 4, 3:7] = (dphi_dgw[..., None, :] @ dgw_dqwr)[..., 0, :]

    zero3 = torch.zeros_like(dtheta_dgw)
    dyprima_dgw = torch.stack([zero3, zero3, zero3, dtheta_dgw, dphi_dgw],
                              dim=-2)                       # (...,5,3)
    dgc_dhu = constant(((1.0 / fku, 0.0), (0.0, 1.0 / fku), (0.0, 0.0)),
                       dtype, device)
    dhu_dhd = cam_ops.jacob_undistort(uvd, cam)
    dyprima_dhd = dyprima_dgw @ R_wc @ dgc_dhu @ dhu_dhd    # (...,5,2)
    dy_dhd = torch.zeros(lead + (6, 3), dtype=dtype, device=device)
    dy_dhd[..., 0:5, 0:2] = dyprima_dhd
    dy_dhd[..., 5, 2] = 1.0
    return dy_dxv, dy_dhd


def add_params(P_cam_rows: torch.Tensor, state: FilterState,
               uvd: torch.Tensor, cand_mask: torch.Tensor,
               lm_ids: torch.Tensor, cfg: EngineConfig):
    """Closed-form parameters of the batched feature add from the 13 camera
    rows of P (P_cam_rows (B,13,D)): candidate k of an instance takes the
    k-th accepted rank's free slot. uvd (B,K,2), cand_mask (B,K) bool,
    lm_ids (B,K). Returns (AddParams, assigned (B,K) int64, -1 if not)."""
    m = cfg.map
    B, K = cand_mask.shape
    dtype, device = state.x.dtype, state.x.device
    cap = state.capacity
    D = state.x.shape[1]
    x_cam = state.x[:, :CAM_DIM]

    # slot assignment: k-th accepted candidate -> k-th free slot (stable)
    free = ~state.active
    free_slots = torch.argsort((~free).to(torch.int8), dim=1, stable=True)
    n_free = free.sum(dim=1)
    rank = torch.cumsum(cand_mask.to(torch.int64), dim=1) - 1
    ok = cand_mask & (rank < n_free[:, None])
    slot = torch.gather(free_slots, 1, rank.clamp(0, cap - 1))
    assigned = torch.where(ok, slot, -1)

    y = cam_ops.back_project_inverse_depth(
        uvd, x_cam[:, None, 0:3].expand(B, K, 3), x_cam[:, None, 3:7],
        m.initial_rho, cfg.camera)                          # (B, K, 6)
    dy_dxv, dy_dhd = add_feature_jacobians(uvd, x_cam[:, None], cfg)
    Padd = torch.diag(constant(
        (cfg.filter.sigma_z ** 2, cfg.filter.sigma_z ** 2, m.std_rho ** 2),
        dtype, device))

    rows = dy_dxv @ P_cam_rows[:, None]                     # (B, K, 6, D)
    P11 = P_cam_rows[:, :, :CAM_DIM]
    cross = torch.einsum("bkij,bjl,bmnl->bkmin", dy_dxv, P11, dy_dxv)
    noise = torch.einsum("bkij,jl,bknl->bkin", dy_dhd, Padd, dy_dhd)
    eyeK = torch.eye(K, dtype=dtype, device=device)
    cross = cross + noise[:, :, None] * eyeK[:, :, None, None]

    onehot = one_hot(torch.where(ok, slot, cap), cap, dtype)   # (B, K, CAP)
    new_slot = onehot.sum(dim=1) > 0                        # (B, CAP)
    keep_f = (~_dim_mask(new_slot)).to(dtype)               # (B, D)

    row_flat = torch.where(
        ok[..., None],
        CAM_DIM + 6 * slot[..., None] + torch.arange(6, device=device),
        D).reshape(B, 6 * K)
    E = one_hot(row_flat, D, dtype)                         # (B, 6K, D)
    rows_flat = rows.reshape(B, 6 * K, D) * keep_f[:, None, :]
    cross_flat = cross.permute(0, 1, 3, 2, 4).reshape(
        B, 6 * K, 6 * K).contiguous()

    x = state.x * keep_f + torch.einsum("brd,br->bd", E, y.reshape(B, 6 * K))
    lm_new = torch.einsum("bkc,bk->bc", onehot, lm_ids.to(dtype)).to(
        torch.int32)
    z32 = torch.zeros_like(state.times_predicted)
    new_state = state.replace(
        x=x,
        active=state.active | new_slot,
        cartesian=state.cartesian & ~new_slot,
        times_predicted=torch.where(new_slot, z32, state.times_predicted),
        times_measured=torch.where(new_slot, z32, state.times_measured),
        landmark_id=torch.where(new_slot, lm_new, state.landmark_id))
    return AddParams(keep_f=keep_f, E=E, U=rows_flat, C=cross_flat,
                     state=new_state), assigned


def add_features_batch(state: FilterState, uvd: torch.Tensor,
                       cand_mask: torch.Tensor, lm_ids: torch.Tensor,
                       cfg: EngineConfig):
    """Add up to K candidate features per instance in closed form (the
    sequential append loop of add_features_inverse_depth.m:20-23 as one
    batch): P' = M∘P + Gᵀ·(Mid·G), G = [E; U], Mid = [[C, I], [I, 0]] —
    the single stacked product for EᵀU + UᵀE + EᵀCE.
    Returns (state, assigned (B, K))."""
    p, assigned = add_params(p_compute(state.P[:, :CAM_DIM, :]), state,
                             uvd, cand_mask, lm_ids, cfg)
    return p.state.replace(P=_stacked_apply(state.P, p.keep_f, p.E, p.U,
                                            p.C)), assigned


def _stacked_apply(P, keep_f, E, U, C):
    """keep∘P + EᵀU + UᵀE + EᵀCE as one stacked product Gᵀ·(Mid·G),
    G = [E; U], Mid = [[C, I], [I, 0]], in P's storage dtype. keep_f
    (B,D); E, U (B,k,D); C (B,k,k)."""
    B, k, _ = E.shape
    eye = torch.eye(k, dtype=U.dtype, device=U.device).expand(B, k, k)
    mid = torch.cat([torch.cat([C, eye], dim=2),
                     torch.cat([eye, torch.zeros_like(C)], dim=2)], dim=1)
    G = torch.cat([E, U], dim=1)                            # (B, 2k, D)
    return p_store(p_compute(P) * (keep_f[:, :, None] * keep_f[:, None, :])
                   + G.transpose(1, 2) @ (mid @ G), P)


def manage(state: FilterState, cfg: EngineConfig) -> FilterState:
    """Map management with its P transform applied (the unfused step; the
    fused step applies ManageParams in K1)."""
    p = manage_params(state, cfg)
    return p.state.replace(P=apply_manage_P(state.P, p))


def apply_manage_P(P: torch.Tensor, p: ManageParams) -> torch.Tensor:
    """P' = keep∘P + E6ᵀU6 + U6ᵀE6 + E6ᵀC66E6 in the stacked-dot form of
    the JAX apply_manage_P (mapman.py:437-451)."""
    return _stacked_apply(P, p.keep_f, p.E6, p.U6, p.C66)


def manage_params(state: FilterState, cfg: EngineConfig) -> ManageParams:
    """Closed-form map-management P transform (delete policy + at most one
    inverse-depth → cartesian conversion). The returned state carries the
    managed x / masks / counters; P is applied by K1."""
    m = cfg.map
    dtype = state.x.dtype
    tp = state.times_predicted.to(dtype)
    weak = ((state.times_predicted >= m.delete_min_predictions)
            & (state.times_measured.to(dtype) < m.delete_measured_ratio * tp))
    drop = state.active & weak
    keep = ~drop
    z32 = torch.zeros_like(state.times_predicted)
    st = state.replace(
        active=state.active & keep,
        cartesian=state.cartesian & keep,
        times_predicted=torch.where(drop, z32, state.times_predicted),
        times_measured=torch.where(drop, z32, state.times_measured),
        landmark_id=torch.where(drop, -1, state.landmark_id))
    return _convert_params(st, cfg, ~_dim_mask(drop))


def _convert_params(state: FilterState, cfg: EngineConfig,
                    dim_keep: torch.Tensor) -> ManageParams:
    """The conversion of the first eligible slot (linearity index
    L = 4σ_d cosα / d < threshold, inversedepth_2_cartesian.m:32-49),
    mapping P through J = [I₃ (1/ρ)∂m/∂θ (1/ρ)∂m/∂φ −m/ρ²]; deleted dims
    (dim_keep False) are masked on the fly."""
    m = cfg.map
    dtype, device = state.x.dtype, state.x.device
    B, cap = state.active.shape
    D = state.x.shape[1]
    ks = dim_keep.to(dtype)
    x_in = state.x * ks
    slots = x_in[:, CAM_DIM:].reshape(B, cap, 6)
    y3, theta, phi, rho = (slots[..., 0:3], slots[..., 3], slots[..., 4],
                           slots[..., 5])
    rho_dims = CAM_DIM + 6 * torch.arange(cap, device=device) + 5
    rho_var = p_compute(state.P[:, rho_dims, rho_dims]) * ks[:, rho_dims]
    safe_rho = torch.where(rho == 0, torch.ones_like(rho), rho)
    std_d = torch.sqrt(torch.clamp(rho_var, min=0.0)) / safe_rho ** 2
    mi = quat.azel_to_ray(theta, phi)
    p = y3 + mi / safe_rho[..., None]
    v1 = p - y3                     # p − x_c1 (init camera position ≈ y3)
    v2 = p - state.x[:, None, 0:3]  # p − x_c2
    n1 = torch.linalg.vector_norm(v1, dim=-1)
    n2 = torch.linalg.vector_norm(v2, dim=-1)
    denom = torch.where((n1 == 0) | (n2 == 0), torch.ones_like(n1), n1 * n2)
    cos_alpha = torch.sum(v1 * v2, dim=-1) / denom
    L = 4.0 * std_d * cos_alpha / torch.where(n2 == 0, torch.ones_like(n2), n2)

    eligible = state.active & ~state.cartesian & (L < m.linearity_threshold)
    do = eligible.any(dim=1)
    slot = torch.argmax(eligible.to(torch.int8), dim=1)     # first eligible
    onehot = one_hot(slot, cap, dtype) * do[:, None].to(dtype)   # (B, CAP)
    dim_mask = _dim_mask(onehot > 0)                        # (B, D)

    def pick(v):                    # (B, CAP, 3) -> the chosen slot's (B, 3)
        return torch.einsum("bc,bci->bi", onehot, v)

    eye3 = torch.eye(3, dtype=dtype, device=device).expand(B, 3, 3)
    J = torch.cat([
        eye3,
        pick(quat.dm_dtheta(theta, phi) / safe_rho[..., None])[..., None],
        pick(quat.dm_dphi(theta, phi) / safe_rho[..., None])[..., None],
        pick(-mi / safe_rho[..., None] ** 2)[..., None]], dim=2)   # (B,3,6)

    # The slot's 6 rows of P (zero when do=False): an exact row gather,
    # equal to the JAX one-hot contraction over the slot axis.
    six = torch.arange(6, device=device)
    row_idx = CAM_DIM + 6 * slot[:, None] + six             # (B, 6)
    slot_rows = (p_compute(torch.gather(state.P, 1,
                                        row_idx[..., None].expand(B, 6, D)))
                 * do[:, None, None].to(dtype) * ks[:, None, :])
    new_rows = torch.cat([J @ slot_rows,
                          torch.zeros(B, 3, D, dtype=dtype, device=device)],
                         dim=1)                             # (B, 6, D)
    slot66 = torch.gather(slot_rows, 2, row_idx[:, None, :].expand(B, 6, 6))
    diag66 = torch.zeros(B, 6, 6, dtype=dtype, device=device)
    diag66[:, 0:3, 0:3] = J @ slot66 @ J.transpose(1, 2)

    keep_f = (~dim_mask).to(dtype) * ks
    rows_masked = new_rows * (~dim_mask).to(dtype)[:, None, :]
    E6 = one_hot(torch.where(do[:, None], row_idx, D), D, dtype)   # (B,6,D)
    new_slot_x = torch.cat([pick(p), torch.zeros(B, 3, dtype=dtype,
                                                 device=device)], dim=1)
    x_new = (x_in * (~dim_mask).to(dtype)
             + torch.einsum("brd,br->bd", E6, new_slot_x))
    return ManageParams(
        keep_f=keep_f, E6=E6, U6=rows_masked, C66=diag66, slot=slot, do=do,
        state=state.replace(x=x_new, cartesian=state.cartesian | (onehot > 0)))


def update_counters(state: FilterState, predicted: torch.Tensor,
                    measured: torch.Tensor) -> FilterState:
    """times_predicted += predicted; times_measured += measured
    (update_features_info.m:4-10)."""
    return state.replace(
        times_predicted=state.times_predicted + predicted.to(torch.int32),
        times_measured=state.times_measured + measured.to(torch.int32))
