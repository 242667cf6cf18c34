"""EKF predict and measurement update (L2), batched over instances.

Port of ``ekf_slam_tpu/filter/ekf.py`` in its default forms:

* ``predict``: the block-sparse time update in the "pred" stripe form —
  only the 13 camera rows and columns of P change
  (predict_state_and_covariance.m:26-27);
* ``update_gain``: the gain half of the masked update (update.m:8-11),
  with its two SPD-inverse solvers. H is a measurement Jacobian by its
  blocks (``JacobianBlocks``, never dense) or a dense (B,M,D) matrix.
  Without the caller's gain columns, P·Hᵀ and S = H·P·Hᵀ come from one
  ``kernels.pht_blocks`` pass over P for blocks, from K6
  ``kernels.f32_matmul_big`` and a product for a dense H;
* ``update``: the whole masked update. Its covariance tail (downdate,
  symmetrize, quaternion renorm; update.m:13-24) runs in K5
  ``kernels.fused_update_tail`` when ``use_pallas`` is set and P is f32,
  else as the folded rank-(M'+8) correction applied by K4
  ``kernels.corr_apply_cols``, the symmetric downdate carried once;
* ``update_iterated``: the iterated (Gauss-Newton) update, each of its
  gains as ``update_gain`` forms them and its covariance tail the one
  ``update`` uses;
* ``update_rows``: the same update in row form (the engine's row
  route): the caller's H·P rows feed S, the state move and the folded
  rank-(2M+8) row factors (2M rows, the downdate carried once), whose
  correction K8 ``kernels.corr_apply`` applies in its "expr" mode.

This module keeps no route: ``engine.route`` picks what a frame runs and
passes in whether a tail takes K5 (``use_pallas``). Every update shares
one gain set-up (``_gain_inputs``; ``r_diag`` None is unit noise) and one
choice of SPD inverse (``_inverse``).

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

import dataclasses

import torch

from ekf_slam_tpu_torch.config import CAM_DIM, FilterConfig
from ekf_slam_tpu_torch.filter import motion
from ekf_slam_tpu_torch.ops import kernels
from ekf_slam_tpu_torch.ops import quaternion as quat
from ekf_slam_tpu_torch.utils.metrics import trace_annotation

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


@dataclasses.dataclass(frozen=True)
class JacobianBlocks:
    """The measurement Jacobian of M gathered slots by its blocks, never
    dense: row 2m+c (c = u, v) holds H_xv[:, m, c] on the 13 camera
    columns and H_y[:, m, c] on the columns 13+6·sel[:, m] .. +5 of the
    slot it measures, zeros elsewhere (19 nonzeros of D a row). H_xv
    (B,M,2,13), H_y (B,M,2,6); sel (B,M) int64, an instance's slots
    distinct. measurement.compact_dense_H builds the same rows dense."""
    H_xv: torch.Tensor
    H_y: torch.Tensor
    sel: torch.Tensor

    def masked(self, mask: torch.Tensor) -> "JacobianBlocks":
        """The rows where mask (B,2M) is 0 zeroed."""
        m = mask.reshape(*self.sel.shape, 2, 1)
        return JacobianBlocks(self.H_xv * m, self.H_y * m, self.sel)

    def times(self, X: torch.Tensor) -> torch.Tensor:
        """H·X (B,2M,N) for X (B,D,N), from X's rows that H reads."""
        return kernels.blocks_times(self.H_xv, self.H_y, self.sel, X)


def _masked_rows(H, mask: torch.Tensor):
    """H (blocks or dense (B,M,D)) with the rows where mask is 0 zeroed."""
    if isinstance(H, JacobianBlocks):
        return H.masked(mask)
    return H * mask[..., None]


def _times(H, X: torch.Tensor) -> torch.Tensor:
    """H·X for H blocks or dense and X (B,D,N)."""
    return H.times(X) if isinstance(H, JacobianBlocks) else H @ X


def _gain_columns(P, H, r_eff: torch.Tensor):
    """(P·Hᵀ (B,D,M), S = H·P·Hᵀ + diag(r_eff) (B,M,M)) for a masked H on
    P as stored: both from one kernels.pht_blocks pass over P for blocks;
    K6's product and H·PHt for a dense H."""
    if isinstance(H, JacobianBlocks):
        return kernels.pht_blocks(P, H.H_xv.contiguous(),
                                  H.H_y.contiguous(), H.sel.contiguous(),
                                  r_eff.contiguous())
    PHt = kernels.f32_matmul_big(P, H.transpose(1, 2).contiguous())
    return PHt, H @ PHt + torch.diag_embed(r_eff)


def _gain_inputs(row_mask: torch.Tensor, r_diag, dtype):
    """An update's (mask, r_eff) for its M rows (B,M): row_mask as
    `dtype`, and the measurement noise r_diag (unit where None) on the
    active rows, 1 on the masked ones, whose S block is then the identity
    and gain columns exactly zero."""
    mask = row_mask.to(dtype)
    if r_diag is None:
        return mask, torch.ones_like(mask)
    return mask, torch.where(row_mask, r_diag, torch.ones_like(r_diag))


def _inverse(S: torch.Tensor, gain_solver: str) -> torch.Tensor:
    """S⁻¹ by the config's gain_solver: "newton" or Cholesky."""
    return (_spd_inverse_newton(S) if gain_solver == "newton"
            else _spd_inverse(S))


def update_gain(x: torch.Tensor, P, H, z: torch.Tensor,
                h: torch.Tensor, row_mask: torch.Tensor,
                r_diag: torch.Tensor | None, gain_solver: str = "cholesky",
                PHt: torch.Tensor | None = None):
    """x (B,D); H the Jacobian of the M rows, JacobianBlocks or dense
    (B,M,D); z, h, row_mask, r_diag (B,M), r_diag None for unit noise;
    PHt (B,D,M) the gain columns P·Hᵀ if the caller has them (then P is
    not read and S = H·PHt, for blocks from PHt's rows that H reads; else
    _gain_columns forms both from P (B,D,D), as stored).
    Returns (x_new un-renormalized, K (B,D,M), PHt masked (B,D,M))."""
    mask, r_eff = _gain_inputs(row_mask, r_diag, x.dtype)
    H = _masked_rows(H, mask)
    nu = (z - h) * mask
    if PHt is None:
        PHt, S = _gain_columns(P, H, r_eff)             # S (B, M, M), SPD
    else:
        PHt = PHt * mask[:, None, :]
        S = _times(H, PHt) + torch.diag_embed(r_eff)
    K = PHt @ _inverse(S, gain_solver)
    return x + (K @ nu[..., None])[..., 0], K, PHt


def _renormalized(x: torch.Tensor) -> torch.Tensor:
    """x with its quaternion x[:, 3:7] scaled to unit norm."""
    q = x[:, 3:7]
    return torch.cat([x[:, :3], q / torch.linalg.vector_norm(
        q, dim=1, keepdim=True), x[:, 7:]], dim=1)


def _folded_tail_factors(x_new: torch.Tensor, P4: torch.Tensor,
                         K: torch.Tensor, PHt: torch.Tensor):
    """Factors (Ā, B̄) of the folded covariance tail P⁺ = P + ½(Ā·B̄ᵀ +
    B̄·Āᵀ), the correction K4 applies: the symmetric downdate, carried
    once, and the quaternion-renorm transform T = I + E₄GE₄ᵀ
    (G = normJac(q) − I₄ on dims 3:7) as one rank-(M'+8) correction,
    valid for a symmetric P:

      Ā = [−K | E₄ | W + E₄·(G·M₄₄·Gᵀ)],  B̄ = [PHt | W | E₄],
      M₄ = P₄ − ½(K₄·PHtᵀ + PHt₄·Kᵀ),  W = M₄ᵀGᵀ.

    ½(Ā·B̄ᵀ + B̄·Āᵀ) = −½(K·PHtᵀ + PHt·Kᵀ) + E₄Wᵀ + WE₄ᵀ + E₄G·M₄₄·GᵀE₄ᵀ
    for any K; Ā·B̄ᵀ alone is not symmetric (``_one_sided_factors`` gives
    the pair whose single product is).
    x_new (B,D); P4 rows 3:7 of P (B,4,D); K, PHt (B,D,M').
    Returns (x renormalized, Ā (B,D,M'+8), B̄ (B,D,M'+8))."""
    B_, D, _ = K.shape
    dtype, device = K.dtype, K.device
    eye4 = torch.eye(4, dtype=dtype, device=device)
    G = quat.norm_jac(x_new[:, 3:7]) - eye4
    M4 = P4 - 0.5 * (K[:, 3:7, :] @ PHt.transpose(1, 2)
                     + PHt[:, 3:7, :] @ K.transpose(1, 2))   # (B, 4, D)
    M44 = M4[:, :, 3:7]
    W = M4.transpose(1, 2) @ G.transpose(1, 2)             # (B, D, 4)
    E4 = torch.zeros(D, 4, dtype=dtype, device=device)
    E4[3:7] = eye4
    E4 = E4.expand(B_, D, 4)
    A_f = torch.cat([-K, E4, W + E4 @ (G @ M44 @ G.transpose(1, 2))], dim=2)
    B_f = torch.cat([PHt, W, E4], dim=2)
    return _renormalized(x_new), A_f, B_f


def _one_sided_factors(A_f: torch.Tensor, B_f: torch.Tensor):
    """The folded tail's correction as one product: from the pair
    (Ā, B̄) of ``_folded_tail_factors`` (B,D,M'+8), the pair (Ā₂, B̄₂)
    (B,D,2M'+8) with Ā₂·B̄₂ᵀ = ½(Ā·B̄ᵀ + B̄·Āᵀ),

      Ā₂ = [−½K | −½PHt | Ā's last 8],  B̄₂ = [PHt | K | B̄'s last 8],

    for an apply that adds Ā₂·B̄₂ᵀ as it is (the row-sharded slab's K8
    "none")."""
    m = A_f.shape[2] - 8
    K_neg, PHt = A_f[:, :, :m], B_f[:, :, :m]
    return (torch.cat([0.5 * K_neg, -0.5 * PHt, A_f[:, :, m:]], dim=2),
            torch.cat([PHt, -K_neg, B_f[:, :, m:]], dim=2))


def update(x: torch.Tensor, P: torch.Tensor, H: torch.Tensor,
           z: torch.Tensor, h: torch.Tensor, row_mask: torch.Tensor,
           r_diag: torch.Tensor | None, use_pallas: bool = False,
           gain_solver: str = "cholesky"):
    """Masked EKF measurement update (update.m:1-32). H the Jacobian,
    JacobianBlocks or dense (B,M,D); z, h, row_mask, r_diag (B,M), r_diag
    None for unit noise. P enters symmetric.

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
                    h_fn, row_mask: torch.Tensor, r_diag: torch.Tensor | None,
                    num_iters: int = 3, use_pallas: bool = False):
    """Iterated EKF (Gauss-Newton) measurement update, the intent of the
    reference's ekf_update_iterated.m (ekf.py:691-731 of the JAX package).
    From the prior x̂ = x, num_iters re-linearizations of h about the
    iterate x_i with the innovation ν_i = (z − h(x_i))·mask − H_i·(x̂ − x_i)
    and x_{i+1} = x̂ + K_i·ν_i; the covariance is formed once, at the last
    iterate, by ``_update_tail`` (K4, or K5 with use_pallas).

    h_fn: x (B,D) -> (h (B,M), H) at x, H JacobianBlocks or dense
    (B,M,D); rows of inactive measurements are masked here. z, row_mask,
    r_diag (B,M), r_diag None for unit noise. Each gain's P·Hᵀ and S
    (num_iters + 1 of them) come from _gain_columns on P as stored: one
    kernels.pht_blocks pass for blocks. S is always inverted by Cholesky, whatever the config's
    gain_solver, as in JAX.
    The iterates that move only x run in the span iekf.iterate, the last
    gain and the covariance tail in iekf.tail (device marks on a CUDA x).
    Returns (x_new, P_new in P's dtype)."""
    mask, r_eff = _gain_inputs(row_mask, r_diag, x.dtype)

    def gain(xi):
        h, H = h_fn(xi)
        H = _masked_rows(H, mask)
        PHt, S = _gain_columns(P, H, r_eff)
        return h, H, PHt, PHt @ _spd_inverse(S)

    xi = x
    with trace_annotation("iekf.iterate", x.device):
        for _ in range(num_iters):
            h, H, _, K = gain(xi)
            nu = (z - h) * mask - _times(H, (x - xi)[..., None])[..., 0]
            xi = x + (K @ nu[..., None])[..., 0]
    with trace_annotation("iekf.tail", x.device):
        _, _, PHt, K = gain(xi)
        return _update_tail(xi, P, K, PHt, use_pallas)


def update_rows(x: torch.Tensor, P: torch.Tensor, H: torch.Tensor,
                HP: torch.Tensor, z: torch.Tensor, h: torch.Tensor,
                row_mask: torch.Tensor, r_diag: torch.Tensor | None,
                gain_solver: str = "cholesky"):
    """Masked EKF update in row form (ekf.py:492-583 of the JAX package;
    the same math as ``update``). H (B,2M,D) dense measurement rows in any
    order (the engine stacks u-rows then v-rows); HP (B,2M,D) their H·P
    rows, from the caller's one read of P (measurement.pht_rows_split);
    z, h, row_mask, r_diag (B,2M), r_diag None for unit noise. P enters
    symmetric.

    K = P·Hᵀ·W is never formed: x moves by (HP)ᵀ·W·ν, and the covariance
    by the symmetric downdate −(HP)ᵀ·N, N = ½(W + Wᵀ)·HP, folded with the
    quaternion renorm T = I + E₄GE₄ᵀ (G = normJac(q) − I₄) into one
    rank-(2M+8) correction P⁺ = P + AtᵀBt,

      At = [−N ; E₄ᵀ ; G·M₄ + (G·M₄₄·Gᵀ)·E₄ᵀ],  Bt = [HP ; G·M₄ ; E₄ᵀ],
      M₄ = rows 3:7 of P − (HP)ᵀN,

    applied by K8 in its "expr" mode (P + ½(AtᵀBt + BtᵀAt), the JAX XLA
    form ekf.py:579-582). Returns (x_new, P_new in P's dtype)."""
    dtype = x.dtype
    mask, r_eff = _gain_inputs(row_mask, r_diag, dtype)
    H = H * mask[..., None]
    HP = HP * mask[..., None]
    nu = (z - h) * mask
    S = HP @ H.transpose(1, 2) + torch.diag_embed(r_eff)     # (B, 2M, 2M)
    W = _inverse(S, gain_solver)
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
    return _renormalized(x_new), kernels.corr_apply(P, At, Bt, "expr")


def cholesky(S: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of ½(S + Sᵀ), which is what JAX's cholesky
    factors (symmetrize_input). A batch entry whose factor fails
    (cholesky_ex's info != 0; LAPACK and cuSOLVER leave different partial
    factors) is all NaN, as JAX's is. The mask is a torch.where, so
    nothing syncs the host."""
    L, info = torch.linalg.cholesky_ex(0.5 * (S + S.transpose(-1, -2)))
    return torch.where((info != 0)[..., None, None],
                       torch.full_like(L, float("nan")), L)


def _spd_inverse(S: torch.Tensor) -> torch.Tensor:
    """SPD inverse via Cholesky: S⁻¹ = L⁻ᵀ L⁻¹, L = cholesky(S); all NaN
    where S is not positive definite. On the card (cuSOLVER's batched
    factor and cuBLAS's batched triangular solve, no kernel of the port's)
    counted in kernels.COUNTS["cholesky_gain"]."""
    if S.is_cuda:
        kernels.count("cholesky_gain")
    L = cholesky(S)
    eye = torch.eye(S.shape[-1], dtype=S.dtype, device=S.device)
    Linv = torch.linalg.solve_triangular(L, eye.expand_as(S), upper=False)
    return Linv.transpose(-1, -2) @ Linv


def _spd_inverse_newton(S: torch.Tensor) -> torch.Tensor:
    """SPD inverse by Newton-Schulz iteration X ← X(2I − SX) from the
    Jacobi-preconditioned start X₀ = D⁻¹/λ̂ (λ̂ the Gershgorin bound of
    D^-½ S D^-½), whose spectrum of S·X₀ lies in (0, 1]. The JAX solver
    runs 17 of its 20 iterations at the TPU's bf16 matmul precision; here
    every iteration runs at the tensors' own precision (IEEE f32 on the
    card). kernels.spd_inverse_newton chooses by device, dtype and shape
    alone: an f32 S (B,n,n) on the card with n <= kernels.NEWTON_MAX_N
    runs in one launch of its kernel; any other S runs the batched
    torch.matmul iteration, on the card counted in
    kernels.COUNTS["newton_plain"]."""
    return kernels.spd_inverse_newton(S)
