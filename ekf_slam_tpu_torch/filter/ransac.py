"""1-point RANSAC over a fixed batch of hypotheses (L4), batched.

Port of ``ekf_slam_tpu/filter/ransac.py``. Each hypothesis is a 1-match
state-only EKF update (ransac_hypotheses.m:20-26): in the fused step its
gain columns P·Hᵀ come from K1 (``pht``); in the unfused step's row form
from the shared H·P rows (``hp``, measurement.pht_rows_split), with no
read of P; otherwise all NHYP moves are P·G, G = Hᵀ·A built from the
picked slots' Jacobian blocks, one product in K6
(``kernels.f32_matmul_big``, P as stored). All hypotheses of all
instances are scored at once by reprojecting every slot
(compute_hypothesis_support_fast.m, no gating, residual threshold σ_z),
and the argmax-support hypothesis gives the low-innovation inliers.
``support_projection`` is the same reprojection in the measurement
model's per-slot form, for one hypothesis an instance.

The uniform draws are an input, u (B, NHYP): production draws them from
a ``torch.Generator``; the parity tests hand in JAX's own draws.
"""

from __future__ import annotations

import torch

from ekf_slam_tpu_torch.config import CAM_DIM, EngineConfig
from ekf_slam_tpu_torch.filter import association, measurement
from ekf_slam_tpu_torch.filter.measurement import one_hot
from ekf_slam_tpu_torch.ops import camera as cam_ops
from ekf_slam_tpu_torch.ops import kernels


def sample_ic_indices(u: torch.Tensor, ic_mask: torch.Tensor) -> torch.Tensor:
    """Slot indices drawn uniformly among each instance's IC matches
    (select_random_match.m): pick k = floor(u·n_ic), the slot of the k-th
    IC match (first slot where cumsum(ic) == k+1). An instance without
    IC matches gets the last slot (its RANSAC result is masked out).
    u (B,N), ic_mask (B,CAP) -> (B,N)."""
    cap = ic_mask.shape[1]
    csum = torch.cumsum(ic_mask.to(torch.int64), dim=1)
    n_ic = csum[:, -1:]
    ranks = torch.floor(u * n_ic.to(u.dtype)).to(torch.int64)
    slots = torch.searchsorted(csum, ranks + 1)
    return slots.clamp(0, cap - 1)


def support_projection(x_hyp: torch.Tensor, cartesian: torch.Tensor,
                       cfg: EngineConfig) -> torch.Tensor:
    """Every slot reprojected under hypothesis states x_hyp (B, D), the
    batched reprojection of compute_hypothesis_support_fast.m (no gating):
    -> (B, CAP, 2) distorted pixels. A dead slot's zero depth is set to 1
    (no 0/0)."""
    B, cap = cartesian.shape
    hc = measurement.camera_frame_points(
        x_hyp, x_hyp[:, CAM_DIM:].reshape(B, cap, 6), cartesian)
    hz = hc[..., 2:3]
    hc = torch.cat([hc[..., :2], torch.where(hz == 0, torch.ones_like(hz),
                                             hz)], dim=-1)
    return cam_ops.distort(cam_ops.project(hc, cfg.camera), cfg.camera)


def support_residuals_soa(x_hyps: torch.Tensor, z: torch.Tensor,
                          cartesian: torch.Tensor,
                          cfg: EngineConfig) -> torch.Tensor:
    """Squared reprojection residuals of every slot under every
    hypothesis: x_hyps (B,D,N) -> res2 (B,CAP,N). q2r / m.m / hu.m /
    distort_fm.m unrolled per component on (B,CAP,N) slices."""
    cam = cfg.camera
    m = x_hyps[:, CAM_DIM:, :]                            # (B, 6CAP, N)
    yx, yy, yz = m[:, 0::6], m[:, 1::6], m[:, 2::6]      # (B, CAP, N)
    az, el, rho = m[:, 3::6], m[:, 4::6], m[:, 5::6]
    tx, ty, tz = (x_hyps[:, i:i + 1] for i in range(3))   # (B, 1, N)
    qr, qx, qy, qz = (x_hyps[:, i:i + 1] for i in range(3, 7))

    cphi = torch.cos(el)
    mx, my, mz = cphi * torch.sin(az), -torch.sin(el), cphi * torch.cos(az)
    dx, dy, dz = yx - tx, yy - ty, yz - tz
    cart = cartesian[..., None]
    vx = torch.where(cart, dx, dx * rho + mx)
    vy = torch.where(cart, dy, dy * rho + my)
    vz = torch.where(cart, dz, dz * rho + mz)

    r00 = qr * qr + qx * qx - qy * qy - qz * qz
    r11 = qr * qr - qx * qx + qy * qy - qz * qz
    r22 = qr * qr - qx * qx - qy * qy + qz * qz
    r01, r10 = 2 * (qx * qy - qr * qz), 2 * (qx * qy + qr * qz)
    r02, r20 = 2 * (qz * qx + qr * qy), 2 * (qz * qx - qr * qy)
    r12, r21 = 2 * (qy * qz - qr * qx), 2 * (qy * qz + qr * qx)
    hx = vx * r00 + vy * r10 + vz * r20
    hy = vx * r01 + vy * r11 + vz * r21
    hz = vx * r02 + vy * r12 + vz * r22
    hz = torch.where(hz == 0, torch.ones_like(hz), hz)   # dead slots

    fku = cam.f / cam.d
    d, k1, k2 = cam.d, cam.k1, cam.k2
    xu, yu = (hx / hz) * fku * d, (hy / hz) * fku * d
    ru = torch.sqrt(xu * xu + yu * yu)
    rd = ru / (1.0 + k1 * ru ** 2 + k2 * ru ** 4)
    for _ in range(cam.distort_newton_iters):
        f = rd + k1 * rd ** 3 + k2 * rd ** 5 - ru
        fp = 1.0 + 3.0 * k1 * rd ** 2 + 5.0 * k2 * rd ** 4
        rd = rd - f / fp
    Dd = 1.0 + k1 * rd ** 2 + k2 * rd ** 4
    du = z[..., 0:1] - (xu / (Dd * d) + cam.cx)
    dv = z[..., 1:2] - (yu / (Dd * d) + cam.cy)
    return du * du + dv * dv


def run(x: torch.Tensor, z: torch.Tensor, h: torch.Tensor, S: torch.Tensor,
        ic_mask: torch.Tensor, cartesian: torch.Tensor, u: torch.Tensor,
        cfg: EngineConfig, pht: torch.Tensor | None = None,
        P: torch.Tensor | None = None, H_xv: torch.Tensor | None = None,
        H_y: torch.Tensor | None = None, hp=None, pg=None):
    """Full 1-point RANSAC: hypothesis n moves the state by P·Hₙᵀ·Sₙ⁻¹νₙ.
    Given the prior's visibility-masked gain columns pht (B,D,2·CAP) the
    move is read off pht's column pair of its slot; given its split H·P
    rows hp = (hp_u, hp_v), each (B,CAP,D), it is hp_uᵀ·A_u + hp_vᵀ·A_v
    with A the picks' weights at their slots; without either it is
    P·G with G = Hᵀ·A from the visibility-masked Jacobian blocks H_xv
    (B,CAP,2,13), H_y (B,CAP,2,6) of the picks, and P (B,D,D), or pg(G)
    when the caller forms the product (the row-sharded step). x (B,D);
    z, h (B,CAP,2); S (B,CAP,2,2); ic_mask, cartesian (B,CAP);
    u (B,NHYP). Returns (li_mask (B,CAP), best support (B,))."""
    B, cap = ic_mask.shape
    thr = cfg.filter.sigma_z
    picks = sample_ic_indices(u, ic_mask)                 # (B, N)
    N = picks.shape[1]
    idx2 = picks[..., None].expand(-1, -1, 2)
    nu_p = torch.gather(z, 1, idx2) - torch.gather(h, 1, idx2)
    S_p = torch.gather(S, 1, picks[..., None, None].expand(-1, -1, 2, 2))
    w_p = association._solve_2x2(S_p, nu_p)               # (B, N, 2)
    oh = one_hot(picks, cap, x.dtype)                     # (B, N, CAP)
    if pht is not None:
        A = torch.einsum("bnc,bnj->bcjn", oh, w_p).reshape(B, 2 * cap, -1)
        x_hyps = x[:, :, None] + pht @ A                  # (B, D, N)
    elif hp is not None:
        A = torch.einsum("bnc,bnj->bcjn", oh, w_p)        # (B, CAP, 2, N)
        x_hyps = (x[:, :, None] + hp[0].transpose(1, 2) @ A[:, :, 0]
                  + hp[1].transpose(1, 2) @ A[:, :, 1])
    else:
        # G = Hᵀ·A: camera rows Hxvᵀw, each pick's 6 map rows at its slot.
        def picked(a):              # (B, CAP, 2, k) -> (B, N, 2, k)
            return torch.gather(a, 1, picks[..., None, None].expand(
                B, N, *a.shape[2:]))
        cam_g = torch.einsum("bnij,bni->bjn", picked(H_xv), w_p)
        slot_g = torch.einsum("bnij,bni->bnj", picked(H_y), w_p)
        map_g = torch.einsum("bnc,bnj->bcjn", oh, slot_g).reshape(
            B, 6 * cap, N)
        G = torch.cat([cam_g, map_g], dim=1)              # (B, D, N)
        x_hyps = x[:, :, None] + (kernels.f32_matmul_big(P, G) if pg is None
                                  else pg(G))

    res2 = support_residuals_soa(x_hyps, z, cartesian, cfg)
    inliers = ic_mask[..., None] & (res2 < thr * thr)     # (B, CAP, N)
    supports = inliers.sum(dim=1)                         # (B, N)
    best = torch.argmax(supports, dim=1)                  # first maximum
    any_ic = ic_mask.any(dim=1)
    li_mask = (torch.gather(inliers, 2, best[:, None, None].expand(B, cap, 1))
               [..., 0] & any_ic[:, None])
    support = torch.gather(supports, 1, best[:, None])[:, 0]
    return li_mask, torch.where(any_ic, support, torch.zeros_like(support))
