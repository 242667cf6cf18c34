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
  ``kernels.fused_update_tail`` when ``use_pallas`` is set and P is f32,
  else as the folded rank-(2M'+8) correction applied by K4
  ``kernels.corr_apply_cols``;
* ``update_iterated``: the iterated (Gauss-Newton) update, each of its
  P·Hᵀ in K6 and its covariance tail the one ``update`` uses;
* ``update_rows``: the same update in row form (the engine's
  ``EKF_UPDATE=rows`` layout): the caller's H·P rows feed S, the state
  move and the folded rank-(2M'+8) row factors, whose correction K8
  ``kernels.corr_apply`` applies in the ``EKF_TAIL_SYM`` mode.

The fused step runs ``update_gain`` with the gain columns of K1/K2 and
its tails in K2/K3. Masked rows carry zero H and residual and unit noise,
so S has an identity block there and their gain columns are exactly zero.
Every product runs at the tensors' own precision: on the card in IEEE f32
(allow_tf32 off), on the CPU tests in f64. P may be stored in bfloat16
(FilterConfig.p_storage, the fast mode at f32): ``p_compute`` upcasts what
is read of it, ``p_store`` rounds a new full P back, and the kernels read
and write it as stored; no product takes a bf16 operand.
"""

from __future__ import annotations

import os

import torch

from ekf_slam_tpu_torch.config import CAM_DIM, FilterConfig
from ekf_slam_tpu_torch.filter import motion
from ekf_slam_tpu_torch.ops import kernels
from ekf_slam_tpu_torch.ops import quaternion as quat

# The update layout of the unfused step (engine.step_core_from_prior):
# "cols" (the default) updates from the gain columns P·Hᵀ (K6 products,
# K4 tail); "rows" from one shared H·P row read (measurement
# .pht_rows_split) that feeds the S gates, RANSAC and update_rows (K8
# tail). The same switch as the JAX engine's (ekf.py:142).
_UPDATE = os.environ.get("EKF_UPDATE", "cols")
# K8's mode in update_rows: "expr" (the default), "full" or "none"
# (kernels.corr_apply; the JAX package's ekf.py:158).
_TAIL_SYM = os.environ.get("EKF_TAIL_SYM", "expr")


def p_compute(P: torch.Tensor) -> torch.Tensor:
    """Storage -> compute view of (a part of) the covariance: a bfloat16
    P upcasts to float32; f32 / f64 storage is returned as it is."""
    return P.float() if P.dtype == torch.bfloat16 else P


def p_store(P_new: torch.Tensor, P_like: torch.Tensor) -> torch.Tensor:
    """Compute -> storage: a new covariance rounded to P_like's bfloat16
    storage (round to nearest even); unchanged for f32 / f64 storage."""
    return (P_new.to(torch.bfloat16) if P_like.dtype == torch.bfloat16
            else P_new)


def predict(x: torch.Tensor, P: torch.Tensor, cfg: FilterConfig):
    """EKF time update (predict_state_and_covariance.m:1-27). x (B,D),
    P (B,D,D). P⁻ = [F P₁₁ Fᵀ + Q, F P₁ₘ; Pₘ₁ Fᵀ, Pₘₘ]: top = F·P[:13]
    is written as the 13-row stripe, its map part transposed as the
    13-column stripe below it, both in P's storage dtype.
    Returns (x⁻, P⁻)."""
    xv = x[:, :CAM_DIM]
    x_pred = torch.cat([motion.fv(xv, cfg), x[:, CAM_DIM:]], dim=1)
    F = motion.dfv_by_dxv(xv, cfg)
    Q = motion.process_noise(xv, cfg)
    top = F @ p_compute(P[:, :CAM_DIM, :])                       # (B, 13, D)
    top = torch.cat([top[:, :, :CAM_DIM] @ F.transpose(1, 2) + Q,
                     top[:, :, CAM_DIM:]], dim=2).to(P.dtype)
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
    K6 forms them from P (B,D,D), as stored).
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

    The tail runs in K5 when use_pallas is set and x and P are float32 (as
    the JAX package takes its fused_update_tail kernel only for an f32 P),
    else as the folded correction in K4, whose output is bitwise symmetric
    and in P's storage dtype. Returns (x_new, P_new)."""
    x_new, K, PHt = update_gain(x, P, H, z, h, row_mask, r_diag,
                                gain_solver)
    return _update_tail(x_new, P, K, PHt, use_pallas)


def _update_tail(x_new: torch.Tensor, P: torch.Tensor, K: torch.Tensor,
                 PHt: torch.Tensor, use_pallas: bool):
    """The covariance tail of an update with gain K and gain columns PHt
    (B,D,M'), at the un-renormalized x_new: T·sym(P − K·PHtᵀ)·Tᵀ, T the
    quaternion-renorm Jacobian at x_new (update.m:13-24). In K5 when
    use_pallas is set and x and P are float32, else as the folded
    correction in K4. Returns (x_new renormalized, P_new in P's dtype)."""
    if (use_pallas and x_new.dtype == torch.float32
            and P.dtype == torch.float32):
        Jq = quat.norm_jac(x_new[:, 3:7])
        return _renormalized(x_new), kernels.fused_update_tail(P, K, PHt, Jq)
    x_new, A_f, B_f = _folded_tail_factors(x_new, p_compute(P[:, 3:7, :]),
                                           K, PHt)
    return x_new, kernels.corr_apply_cols(P, A_f, B_f)


def update_iterated(x: torch.Tensor, P: torch.Tensor, z: torch.Tensor,
                    h_fn, row_mask: torch.Tensor, r_diag: torch.Tensor,
                    num_iters: int = 3, use_pallas: bool = False):
    """Iterated EKF (Gauss-Newton) measurement update, the intent of the
    reference's ekf_update_iterated.m (ekf.py:691-731 of the JAX package).
    From the prior x̂ = x, num_iters re-linearizations of h about the
    iterate x_i with the innovation ν_i = (z − h(x_i))·mask − H_i·(x̂ − x_i)
    and x_{i+1} = x̂ + K_i·ν_i; the covariance is formed once, at the last
    iterate, by ``_update_tail`` (K4, or K5 with use_pallas).

    h_fn: x (B,D) -> (h (B,M), H (B,M,D)) at x; rows of inactive
    measurements are masked here. z, row_mask, r_diag (B,M). Each P·Hᵀ
    (num_iters + 1 of them) is a K6 product on P as stored. S is always
    inverted by Cholesky, whatever the config's gain_solver, as in JAX.
    Returns (x_new, P_new in P's dtype)."""
    mask = row_mask.to(x.dtype)
    R = torch.diag_embed(torch.where(row_mask, r_diag,
                                     torch.ones_like(r_diag)))

    def gain(xi):
        h, H = h_fn(xi)
        H = H * mask[..., None]
        PHt = kernels.f32_matmul_big(P, H.transpose(1, 2).contiguous())
        K = PHt @ _spd_inverse(H @ PHt + R)
        return h, H, PHt, K

    xi = x
    for _ in range(num_iters):
        h, H, _, K = gain(xi)
        nu = (z - h) * mask - (H @ (x - xi)[..., None])[..., 0]
        xi = x + (K @ nu[..., None])[..., 0]
    _, _, PHt, K = gain(xi)
    return _update_tail(xi, P, K, PHt, use_pallas)


def update_rows(x: torch.Tensor, P: torch.Tensor, H: torch.Tensor,
                HP: torch.Tensor, z: torch.Tensor, h: torch.Tensor,
                row_mask: torch.Tensor, r_diag: torch.Tensor,
                gain_solver: str = "cholesky"):
    """Masked EKF update in row form (ekf.py:492-583 of the JAX package;
    the same math as ``update``). H (B,2M,D) dense measurement rows in any
    order (the engine stacks u-rows then v-rows); HP (B,2M,D) their H·P
    rows, from the caller's one read of P (measurement.pht_rows_split);
    z, h, row_mask, r_diag (B,2M). P enters symmetric.

    K = P·Hᵀ·W is never formed: x moves by (HP)ᵀ·W·ν, and the covariance
    by the symmetric downdate −(HP)ᵀ·N, N = ½(W + Wᵀ)·HP, folded with the
    quaternion renorm T = I + E₄GE₄ᵀ (G = normJac(q) − I₄) into one
    rank-(2M+8) correction P⁺ = P + AtᵀBt,

      At = [−N ; E₄ᵀ ; G·M₄ + (G·M₄₄·Gᵀ)·E₄ᵀ],  Bt = [HP ; G·M₄ ; E₄ᵀ],
      M₄ = rows 3:7 of P − (HP)ᵀN,

    applied by K8 in the _TAIL_SYM mode ("expr": P + ½(AtᵀBt + BtᵀAt),
    the JAX XLA form ekf.py:579-582). Returns (x_new, P_new in P's
    dtype)."""
    dtype = x.dtype
    mask = row_mask.to(dtype)
    H = H * mask[..., None]
    HP = HP * mask[..., None]
    nu = (z - h) * mask
    r_eff = torch.where(row_mask, r_diag, torch.ones_like(r_diag))
    S = HP @ H.transpose(1, 2) + torch.diag_embed(r_eff)     # (B, 2M, 2M)
    W = (_spd_inverse_newton(S) if gain_solver == "newton"
         else _spd_inverse(S))
    x_new = x + torch.einsum("bmd,bm->bd", HP, (W @ nu[..., None])[..., 0])
    N = 0.5 * (W + W.transpose(1, 2)) @ HP                    # (B, 2M, D)
    B_, D = x.shape
    eye4 = torch.eye(4, dtype=dtype, device=x.device)
    G = quat.norm_jac(x_new[:, 3:7]) - eye4
    M4 = p_compute(P[:, 3:7, :]) - HP[:, :, 3:7].transpose(1, 2) @ N
    W2T = G @ M4                                              # (B, 4, D)
    E4T = torch.zeros(4, D, dtype=dtype, device=x.device)
    E4T[:, 3:7] = eye4
    E4T = E4T.expand(B_, 4, D)
    At = torch.cat([-N, E4T, W2T + (G @ M4[:, :, 3:7] @ G.transpose(1, 2))
                    @ E4T], dim=1)                            # (B, 2M+8, D)
    Bt = torch.cat([HP, W2T, E4T], dim=1)
    return _renormalized(x_new), kernels.corr_apply(P, At, Bt, _TAIL_SYM)


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
