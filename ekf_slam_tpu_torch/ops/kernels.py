"""The kernels of the SLAM step, with their plain versions — the
counterparts of ``ekf_slam_tpu/ops/pallas_kernels.py``'s kernels:

  fused step (csrc/fused_cov.cu):
  K1 fused_manage_predict_pht — map management + EKF predict + prior P·Hᵀ
  K2 fused_update_tail_pht    — LI-update tail + posterior P·Hᵀ
  K3 fused_update_tail_add    — HI-update tail + batched feature add
  unfused step:
  K4 corr_apply_cols          — the folded update tail's apply,
                                ½(P + Pᵀ) + ½(A·Bᵀ + B·Aᵀ) (unfused_cov.cu)
  K5 fused_update_tail        — the update tail alone, K3 without the
                                feature add (fused_cov.cu)
  K6 f32_matmul_big           — A·B with a large A, read once
                                (unfused_cov.cu)
  K8 corr_apply               — the row-form update's folded tail apply,
                                P + ½(AtᵀBt + BtᵀAt) and its "none" /
                                "full" modes (unfused_cov.cu)
     corr_apply_rows          — K8 "none" on a row slab of P, the tail of
                                the row-sharded step (unfused_cov.cu)
  image path (ncc.cu, one kernel template in two forms):
  K7 ncc_corr                 — the NCC matcher's correlation numerator
                                over N (window, template) pairs
     ncc_corr_norms           — the same, and from the same staging the
                                windows' patch variances and energies:
                                the form the image path runs
  loop closure (eight_point.cu; no Pallas kernel: it stands for XLA's
  eigh + svd in the 8-point RANSAC, which torch's host-checked
  torch.linalg.eigh / svd cannot be captured into a CUDA graph for):
     eight_point_fit          — each 9x9 system's smallest eigenvector,
                                reshaped 3x3 and projected to rank 2
  Newton gain (newton_inverse.cu; no Pallas kernel: it stands for XLA's
  matmuls in the JAX package's ekf.py:599 _spd_inverse_newton):
     spd_inverse_newton       — the SPD inverse by 20 Newton–Schulz
                                iterations, S, X and 2I − S·X of an instance
                                in one block's shared memory throughout
  measurement gain (pht_blocks.cu; it replaces K6 wherever K6's B is a
  measurement Jacobian, formed from the Jacobian's blocks, never dense):
     pht_blocks               — P·Hᵀ and S = H·P·Hᵀ + diag(r) in one pass
                                over P, from H's blocks (19 nonzeros a row)

Each wrapper takes batched tensors (leading instance axis B; K7 the pair
axis N, eight_point_fit the matrix axis N). A tensor on the CPU goes to
the plain version beside the wrapper; a CUDA tensor goes to the
hand-written kernel or the wrapper raises. On the card every operand is
float32, except P of K4 and K8 and A of K6, which may be the fast mode's
bfloat16 P (FilterConfig.p_storage):
those kernels read it as stored and upcast, and K4 / K8 store their
output in P's dtype. The plain versions upcast the same way.
``LAUNCHES[name]`` counts calls of a wrapper that launched its kernel (K1
launches three kernels a call, K2 and K3 two: one count).
``COUNTS[name]`` (raised by ``count``) counts the rest of what a frame
runs on the card: the launches of spd_inverse_newton and pht_blocks
(their time is the glue layer's: no FLOP count of them is kept beside
those of LAUNCHES), the spd_inverse_newton calls on the card that
launched no kernel (``newton_plain``) and the Cholesky gains
(``cholesky_gain``: cuSOLVER's factor and cuBLAS's solve, filter/ekf.py).
The kernels' size limits (the rank r ≤ 128 of K1's and K3's add;
K1/K2's R, K3/K5's M2, K4's and K8's R and K6's N have none; K7 a window
that fits shared memory; pht_blocks D = 13 + 6·CAP, CAP <= 200, M <= CAP)
are checked by the launchers, which return cudaErrorInvalidValue (1).

Precondition shared with the Pallas kernels: P enters K2/K3/K5 symmetric,
so sym(P − K·PHtᵀ) = P − ½(K·PHtᵀ + PHt·Kᵀ).
"""

from __future__ import annotations

import contextlib
from unittest import mock

import torch

from ekf_slam_tpu_torch.ops import _build

LAUNCHES = {"fused_manage_predict_pht": 0, "fused_update_tail_pht": 0,
            "fused_update_tail_add": 0, "corr_apply_cols": 0,
            "fused_update_tail": 0, "f32_matmul_big": 0, "ncc_corr": 0,
            "ncc_corr_norms": 0, "corr_apply": 0, "corr_apply_rows": 0,
            "eight_point_fit": 0}
COUNTS = {"spd_inverse_newton": 0, "pht_blocks": 0, "newton_plain": 0,
          "cholesky_gain": 0}
# spd_inverse_newton: its iterations, and the largest n its kernel takes.
NEWTON_ITERS = 20
NEWTON_MAX_N = 128


def count(name: str) -> None:
    """One more of `name` in COUNTS."""
    COUNTS[name] += 1


def reset_launches() -> None:
    """LAUNCHES and COUNTS to 0."""
    for table in (LAUNCHES, COUNTS):
        for k in table:
            table[k] = 0


# --- plain versions ---------------------------------------------------------

def _keep_mask(P, keep):
    both = (keep[:, :, None] > 0) & (keep[:, None, :] > 0)
    return torch.where(both, P, torch.zeros_like(P))


def _lowrank(P, E, U, C):
    """P + EᵀU + UᵀE + EᵀCE."""
    Et = E.transpose(1, 2)
    return P + Et @ U + U.transpose(1, 2) @ E + Et @ C @ E


def _stripe(P, J, lo, hi):
    """T·P·Tᵀ with T = I except J on dims lo:hi (rows first, then cols)."""
    P = torch.cat([P[:, :lo], J @ P[:, lo:hi], P[:, hi:]], dim=1)
    return torch.cat([P[:, :, :lo], P[:, :, lo:hi] @ J.transpose(1, 2),
                      P[:, :, hi:]], dim=2)


def _tail(P, K, PHt, Jq4):
    """T·(P − ½(K·PHtᵀ + PHt·Kᵀ))·Tᵀ, T = I ⊕ Jq4 on dims 3:7."""
    out = P - 0.5 * (K @ PHt.transpose(1, 2) + PHt @ K.transpose(1, 2))
    return _stripe(out, Jq4, 3, 7)


def manage_predict_pht_plain(P, keep, E6, U6, C66, F13, Q13, Ht):
    """P⁻ = Lp·(keep∘P + E6ᵀU6 + U6ᵀE6 + E6ᵀC66E6)·Lpᵀ + Q̃, Lp = diag(F13, I),
    Q̃ = Q13 on the camera block; PHt = P⁻·Ht. Returns (P⁻, PHt)."""
    Pm = _stripe(_lowrank(_keep_mask(P, keep), E6, U6, C66), F13, 0, 13)
    Q = torch.zeros_like(Pm)
    Q[:, :13, :13] = Q13
    Pm = Pm + Q
    return Pm, Pm @ Ht


def update_tail_pht_plain(P, K, PHt, Jq4, Ht):
    """P_li = T·sym(P − K·PHtᵀ)·Tᵀ and PHt2 = P_li·Ht. Returns both."""
    out = _tail(P, K, PHt, Jq4)
    return out, out @ Ht


def update_tail_add_plain(P, K, PHt, Jq4, keepN, EN, UN, CN):
    """keepN∘(T·sym(P − K·PHtᵀ)·Tᵀ) + ENᵀUN + UNᵀEN + ENᵀCN·EN."""
    return _lowrank(_keep_mask(_tail(P, K, PHt, Jq4), keepN), EN, UN, CN)


def corr_apply_cols_plain(P, A, B):
    """½(P + Pᵀ) + ½(A·Bᵀ + B·Aᵀ), B·Aᵀ taken as (A·Bᵀ)ᵀ: bitwise
    symmetric. P (B,D,D), computed in A's dtype and returned in P's;
    A, B (B,D,R)."""
    Pc = P.to(A.dtype)
    C = A @ B.transpose(1, 2)
    return (0.5 * (Pc + Pc.transpose(1, 2))
            + 0.5 * (C + C.transpose(1, 2))).to(P.dtype)


CORR_MODES = ("none", "expr", "full")


def _corr_mode(symmetrize) -> int:
    """K8's mode index of `symmetrize`; raises for a mode it has not."""
    if symmetrize not in CORR_MODES:
        raise ValueError(f"corr_apply: symmetrize={symmetrize!r}, not one "
                         f"of {CORR_MODES}")
    return CORR_MODES.index(symmetrize)


def corr_apply_plain(P, At, Bt, symmetrize="expr"):
    """P + C ("none"), P + ½(C + Cᵀ) ("expr"), ½(P + Pᵀ) + ½(C + Cᵀ)
    ("full") with C = Atᵀ·Bt, Cᵀ taken as the transpose of C: the
    correction of "expr" and "full" is bitwise symmetric. P (B,D,D),
    computed in At's dtype and returned in P's; At, Bt (B,R,D)."""
    _corr_mode(symmetrize)
    Pc = P.to(At.dtype)
    C = At.transpose(1, 2) @ Bt
    if symmetrize == "none":
        out = Pc + C
    else:
        if symmetrize == "full":
            Pc = 0.5 * (Pc + Pc.transpose(1, 2))
        out = Pc + 0.5 * (C + C.transpose(1, 2))
    return out.to(P.dtype)


def corr_apply_rows_plain(P_slab, At, Bt, r0: int):
    """P_slab + At[:, :, r0:r0+Dl]ᵀ·Bt: K8 "none" on rows r0 .. r0+Dl−1 of
    a P with Dc columns. P_slab (B,Dl,Dc), computed in At's dtype and
    returned in its own; At, Bt (B,R,Dc)."""
    Dl = P_slab.shape[1]
    C = At[:, :, r0:r0 + Dl].transpose(1, 2) @ Bt
    return (P_slab.to(At.dtype) + C).to(P_slab.dtype)


def update_tail_plain(P, K, PHt, Jq4):
    """T·(P − ½(K·PHtᵀ + PHt·Kᵀ))·Tᵀ, T = I ⊕ Jq4 on dims 3:7."""
    return _tail(P, K, PHt, Jq4)


def matmul_big_plain(A, B):
    """A·B for A (B,M,K), B (B,K,N), in B's dtype."""
    return A.to(B.dtype) @ B


def ncc_corr_plain(windows, tm):
    """out[n,oy,ox] = Σ_{dy,dx} windows[n,oy+dy,ox+dx]·tm[n,dy,dx] for
    windows (N,W2,W2), tm (N,t,t) -> (N,R2,R2), R2 = W2 − t + 1: t² shifted
    multiply-adds in dy-major order, in the operands' dtype."""
    t = tm.shape[-1]
    R2 = windows.shape[-1] - t + 1
    out = torch.zeros(windows.shape[0], R2, R2, dtype=windows.dtype,
                      device=windows.device)
    for dy in range(t):
        for dx in range(t):
            out = out + (windows[:, dy:dy + R2, dx:dx + R2]
                         * tm[:, dy, dx, None, None])
    return out


def _boxsum(x, t: int, R2: int):
    """Per-offset t×t patch sums of (..., W2, W2) windows via integral
    images: two prefix sums and four slices."""
    ii = torch.cumsum(torch.cumsum(x, dim=-2), dim=-1)
    ii = torch.nn.functional.pad(ii, (1, 0, 1, 0))
    return (ii[..., t:t + R2, t:t + R2] - ii[..., 0:R2, t:t + R2]
            - ii[..., t:t + R2, 0:R2] + ii[..., 0:R2, 0:R2])


def patch_variance_plain(windows, t: int):
    """Per-offset t×t patch variance (times t²) of windows (N, W2, W2),
    from box sums of the windows less their means, clamped at 0 ->
    (N, R2, R2); and each window's centered energy Σwc² (N,)."""
    R2 = windows.shape[-1] - t + 1
    wc = windows - windows.mean(dim=(-2, -1), keepdim=True)
    box = _boxsum(wc, t, R2)
    sq = _boxsum(wc * wc, t, R2)
    var = torch.clamp(sq - box * box / (t * t), min=0.0)
    return var, (wc * wc).sum(dim=(-2, -1))


def ncc_corr_norms_plain(windows, tm):
    """(ncc_corr_plain(windows, tm), *patch_variance_plain(windows, t)):
    the correlation (N,R2,R2), the patch variances (N,R2,R2) and the
    windows' centered energies (N,)."""
    return (ncc_corr_plain(windows, tm),
            *patch_variance_plain(windows, tm.shape[-1]))


def smallest_eigvec(M: torch.Tensor) -> torch.Tensor:
    """The eigenvector (..., n) of the smallest eigenvalue of ½(M + Mᵀ),
    M (..., n, n): JAX's eigh symmetrizes its input, torch's reads the
    lower triangle only."""
    M = 0.5 * (M + M.transpose(-1, -2))
    return torch.linalg.eigh(M).eigenvectors[..., :, 0]


def eight_point_fit_plain(M, eigvec: bool = False):
    """F₂ (N,3,3) of M (N,9,9): f = smallest_eigvec(M) reshaped row-major
    to F, projected to rank 2 as (U·diag(S₁, S₂, 0))·Vh (JAX's
    _eight_point); with eigvec, (F₂, f (N,9)). A non-finite M gives an
    all-NaN F₂ (and f), as JAX's eigh does; torch's eigh would raise on
    it, so such an M is solved as the identity and its result replaced,
    without a read on the host."""
    finite = torch.isfinite(M).flatten(1).all(1)[:, None]
    eye = torch.eye(9, dtype=M.dtype, device=M.device)
    f = smallest_eigvec(torch.where(finite[:, :, None], M, eye))
    U, S, Vh = torch.linalg.svd(f.reshape(-1, 3, 3))
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    F2 = torch.where(finite[:, :, None], (U * S[..., None, :]) @ Vh,
                     torch.nan)
    return (F2, torch.where(finite, f, torch.nan)) if eigvec else F2


def spd_inverse_newton_plain(S, iters: int = NEWTON_ITERS):
    """SPD inverse by Newton-Schulz iteration X ← X(2I − SX) from the
    Jacobi-preconditioned start X₀ = D⁻¹/λ̂ (λ̂ the Gershgorin bound of
    D^-½ S D^-½), whose spectrum of S·X₀ lies in (0, 1]: batched
    torch.matmul at the tensors' own precision. S (..., n, n)."""
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


def _slot_rows(sel):
    """(B, 6M) indices 13 + 6·sel[m] + j of the six landmark entries of
    each gathered slot, j fastest."""
    six = torch.arange(6, device=sel.device)
    return (13 + 6 * sel[..., None] + six).reshape(sel.shape[0], -1)


def blocks_times(H_xv, H_y, sel, X):
    """H·X (B,2M,N) for the Jacobian given by its blocks (row 2m+c: H_xv
    (B,M,2,13) on X's rows 0:13, H_y (B,M,2,6) on its rows 13+6·sel[m] ..
    +5) and X (B,D,N): the camera rows of X and each slot's six gathered,
    never a dense H."""
    B, M = sel.shape
    N = X.shape[2]
    rows = _slot_rows(sel)[..., None].expand(B, 6 * M, N)
    Xl = torch.gather(X, 1, rows).reshape(B, M, 6, N)
    return (H_xv.reshape(B, 2 * M, 13) @ X[:, :13]
            + (H_y @ Xl).reshape(B, 2 * M, N))


def pht_blocks_plain(P, H_xv, H_y, sel, r):
    """(PHt, S): PHt = P·Hᵀ (B,D,2M) from P's camera columns and each
    gathered slot's six, S = H·PHt + diag(r) (B,2M,2M) by blocks_times,
    for the Jacobian's blocks H_xv (B,M,2,13), H_y (B,M,2,6), sel (B,M)
    and r (B,2M); P (B,D,D) upcast to H_xv's dtype."""
    B, M = sel.shape
    Pc = P.to(H_xv.dtype)
    D = Pc.shape[1]
    cols = _slot_rows(sel)[:, None, :].expand(B, D, 6 * M)
    Pl = torch.gather(Pc, 2, cols).reshape(B, D, M, 6)
    PHt = (Pc[:, :, :13] @ H_xv.reshape(B, 2 * M, 13).transpose(1, 2)
           + torch.einsum("bdmj,bmcj->bdmc", Pl, H_y).reshape(B, D, 2 * M))
    return PHt, blocks_times(H_xv, H_y, sel, PHt) + torch.diag_embed(r)


PLAIN = {"fused_manage_predict_pht": manage_predict_pht_plain,
         "fused_update_tail_pht": update_tail_pht_plain,
         "fused_update_tail_add": update_tail_add_plain,
         "corr_apply_cols": corr_apply_cols_plain,
         "fused_update_tail": update_tail_plain,
         "f32_matmul_big": matmul_big_plain,
         "ncc_corr": ncc_corr_plain,
         "ncc_corr_norms": ncc_corr_norms_plain,
         "corr_apply": corr_apply_plain,
         "corr_apply_rows": corr_apply_rows_plain,
         "eight_point_fit": eight_point_fit_plain,
         "spd_inverse_newton": spd_inverse_newton_plain,
         "pht_blocks": pht_blocks_plain}


# --- checking a kernel against its plain version ----------------------------

# Limit of scaled_error for an f32 kernel against its f64 plain version.
# f32 rounding reads up to ~1e-5 on the slice's operands (K3, in the
# quaternion rows, where the renorm Jacobian leaves a variance ~1e-8 beside
# terms ~1e-4); a missing term of the camera block — K1 without Q̃, a
# stripe transform applied to one side only — reads 0.1 or more.
SCALED_TOL = 1e-4

def entry_error(diff, a, b, slack=None):
    """max |diff_ij| / sqrt(a_i·b_j); an entry whose bound is 0 must be 0.
    slack: a per-entry allowance taken off |diff| first."""
    diff = diff.abs()
    if slack is not None:
        diff = (diff - slack).clamp_min(0)
    bound = torch.sqrt(a[:, :, None] * b[:, None, :])
    err = torch.where(diff == 0, torch.zeros_like(diff), diff / bound)
    return float(err.max())


# Limits of eight_point_fit, f32, against its f64 plain version, with what
# chip_smoke.py phase 6 read on the 1,792 systems of a warm-DB loop query
# (NVIDIA H100 80GB HBM3, 700 W). eight_point_error, each F₂ in units of
# its first-order perturbation bound: the kernel 0.118 (0.115 on the first
# 448; one thread a system read 0.155), the f32 cuSOLVER pair (the plain
# version on the card) 3.41, the eigenvector of the largest eigenvalue
# (the kernel on −M, the planted fault) 1.1e5. Many of
# these 8-point systems are near-degenerate (λ₂ − λ₁ ≪ ‖S‖₂), so any f32
# solve's F₂ strays by up to O(1) along the near-null directions and an
# O(1) fault reads only as many bounds as the best-conditioned system
# allows.
EIGHT_POINT_TOL = 4.0
# eight_point_rayleigh, the eigenvector's Rayleigh quotient above λ₁ in
# units of ε·‖S‖₂ (the eigensolve's backward error, which near-degeneracy
# does not inflate): the kernel 0.244 (one thread a system: 0.262), the
# cuSOLVER pair 6.63, the planted fault 8.4e6.
EIGHT_POINT_RAYLEIGH_TOL = 16.0


def align_sign(out, ref):
    """Each (N,3,3) matrix of out times ±1, the sign that brings it nearest
    ref: an eigenvector's sign, and with it F₂'s, is the solver's choice."""
    dot = (out.to(ref.dtype) * ref).sum(dim=(1, 2), keepdim=True)
    return torch.where(dot < 0, -out, out)


def _eight_point_system(M):
    """S = ½(M + Mᵀ) in f64 (the identity where M is not finite), its
    eigenvalues and eigenvectors, and whether M is finite."""
    Md = M.double()
    finite = torch.isfinite(Md).flatten(1).all(1)
    eye = torch.eye(9, dtype=Md.dtype, device=Md.device)
    S = torch.where(finite[:, None, None], 0.5 * (Md + Md.transpose(1, 2)),
                    eye)
    lam, vec = torch.linalg.eigh(S)
    return S, lam, vec, finite


def _held(err, out, finite) -> float:
    """The largest per-matrix error; a non-finite M's output must be all
    NaN (else inf)."""
    nan_ok = torch.isnan(out.double()).flatten(1).all(1)
    err = torch.where(finite, err, torch.where(nan_ok, 0.0, torch.inf))
    return float(err.max())


def eight_point_error(out, ref, M) -> float:
    """eight_point_fit's error against its f64 reference ref (the plain
    version on M in f64): each matrix's largest |F₂ − ±F₂_ref| in units of
    its perturbation bound ε₃₂·κ_M·κ_F, with κ_M = ‖S‖₂/(λ₂ − λ₁) (S =
    ½(M + Mᵀ), λ₁ ≤ λ₂ its two smallest eigenvalues: the eigengap form of
    the Cauchy–Schwarz scaling) and κ_F = 1 + (σ₂ + σ₃)/(σ₂ − σ₃) (F =
    reshape(f)'s two smaller singular values: the rank-2 projection's own
    amplification; 1 where σ₂ = σ₃ = 0). A matrix with λ₁ = λ₂ (an
    8-point system with fewer than 8 valid points: its null space has more
    than one dimension) has no unique F₂ and is not held."""
    _, lam, vec, finite = _eight_point_system(M)
    sig = torch.linalg.svdvals(vec[:, :, 0].reshape(-1, 3, 3))
    gap_f = sig[:, 1] - sig[:, 2]
    k_f = torch.where(gap_f > 0, 1 + (sig[:, 1] + sig[:, 2])
                      / gap_f.clamp_min(1e-300),
                      torch.where(sig[:, 1] == 0, 1.0, torch.inf))
    gap_m = lam[:, 1] - lam[:, 0]
    k_m = torch.where(gap_m > 0, lam.abs().amax(1) / gap_m.clamp_min(1e-300),
                      torch.inf)
    unit = torch.finfo(torch.float32).eps * k_m * k_f
    diff = (align_sign(out, ref).double() - ref).abs().flatten(1).amax(1)
    return _held(torch.where(diff == 0, torch.zeros_like(diff), diff / unit),
                 out, finite)


def eight_point_rayleigh(f, M) -> float:
    """How far the eigenvector f (N,9) of eight_point_fit(M,
    eigvec=True) is from S's smallest eigenspace: each matrix's fᵀSf/fᵀf
    − λ₁ in units of ε₃₂·‖S‖₂ (S = ½(M + Mᵀ) in f64; 0 at or below
    λ₁)."""
    S, lam, _, finite = _eight_point_system(M)
    fd = torch.nan_to_num(f.double())
    rq = (torch.einsum("ni,nij,nj->n", fd, S, fd)
          / (fd * fd).sum(1).clamp_min(1e-300))
    unit = torch.finfo(torch.float32).eps * lam.abs().amax(1)
    return _held(((rq - lam[:, 0]) / unit.clamp_min(1e-300)).clamp_min(0),
                 f, finite)


# Limit of newton_error, spd_inverse_newton in f32 against its f64 plain
# version: Newton–Schulz settles where each step's rounding (ε relative to
# ‖X‖·‖S‖·‖X‖) meets the residual's contraction, about κ·ε from the f64
# iteration relative to X's own scale. The kernel reads up to 0.29 of
# those units in the CPU emulation (tests/cuda_emulation, n 1-128,
# condition 1e1-1e4; 0.29 at n = 1, where κ̂ = 1 and a unit is one ulp),
# and 0.17-0.19 on a sim frame's S on an H100, as the f32 torch.matmul
# iteration does; a wrong index, mask or edge reads O(1/(κ̂·ε)).
NEWTON_TOL = 4.0


def newton_error(W, S) -> float:
    """spd_inverse_newton's output W (B,n,n) against the plain version in
    f64 on S, X = spd_inverse_newton_plain(S.double()): each entry's
    |W − X| in units of κ̂·ε₃₂·√(|X_ii|·|X_jj|) (the Cauchy–Schwarz bound
    of an entry of an SPD inverse), κ̂ = ‖Ŝ‖_∞·‖X̂‖_∞ of the
    Jacobi-scaled Ŝ = D^-½·S·D^-½ and X̂ = D^½·X·D^½ (d not > 0 replaced
    by 1, as the solver does): the condition the iteration sees. Where X
    is NaN, W must be NaN, where X is ±inf not finite (else inf); an
    instance with a non-finite X is held to that alone."""
    Sd = S.double()
    X = spd_inverse_newton_plain(Sd)
    d = torch.diagonal(Sd, dim1=1, dim2=2)
    d = torch.where(d > 0, d, torch.ones_like(d))
    sq = torch.sqrt(d[:, :, None] * d[:, None, :])
    kappa = ((Sd.abs() / sq).sum(2).amax(1)
             * (X.abs() * sq).sum(2).amax(1))[:, None, None]
    xd = torch.diagonal(X, dim1=1, dim2=2).abs()
    unit = kappa * torch.finfo(torch.float32).eps * torch.sqrt(
        xd[:, :, None] * xd[:, None, :])
    Wd = W.double()
    diff = (Wd - X).abs()
    err = torch.where(diff == 0, torch.zeros_like(diff), diff / unit)
    held = torch.isfinite(X).flatten(1).all(1)[:, None, None]
    err = torch.where(held, err, torch.zeros_like(err))
    miss = ((torch.isnan(X) & ~torch.isnan(Wd))
            | (torch.isinf(X) & torch.isfinite(Wd))
            | (~held & torch.isfinite(X) & ~torch.isfinite(Wd)))
    err = torch.where(miss | torch.isnan(err), torch.inf, err)
    return float(err.max()) if err.numel() else 0.0


def bf16_ulp(ref):
    """The spacing of bfloat16 numbers at each entry of ref (8 significant
    bits: 2^(e−8) for |ref| in [2^(e−1), 2^e)); 0 where ref is 0."""
    _, e = torch.frexp(ref)
    return torch.where(ref == 0, torch.zeros_like(ref),
                       torch.ldexp(torch.ones_like(ref), e - 8))


def scaled_error(out, ref, Ht=None) -> float:
    """A kernel's error against its reference, each entry in units of its
    Cauchy–Schwarz bound: |P_ij| ≤ sqrt(P_ii·P_jj) for the covariance and
    |(P·Ht)_ik| ≤ sqrt(P_ii·(Htᵀ·P·Ht)_kk) for the P·Hᵀ product.

    ``out`` and ``ref`` are a kernel's outputs (P, or (P, P·Ht)), ``Ht``
    the kernel's Ht operand when it has one. A scale taken over the whole
    matrix would hide a wrong camera block: K1's process noise is ~5e-5
    where P's largest entry is ~5, but it is a large share of the velocity
    variances it lands on. A bfloat16 P output (the fast mode's K4 and K8)
    is rounded once from f32, so each entry may also stray one bf16 ulp of
    ref (``bf16_ulp``) beyond that."""
    out = out if isinstance(out, tuple) else (out,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    d = torch.diagonal(ref[0], dim1=1, dim2=2).clamp_min(0)
    slack = bf16_ulp(ref[0]) if out[0].dtype == torch.bfloat16 else None
    errs = [entry_error(out[0].to(ref[0].dtype) - ref[0], d, d, slack)]
    if len(ref) == 2:
        errs.append(product_error(out[1], ref[1], d, Ht))
    return max(errs)


def product_error(out, ref, P_diag, Ht) -> float:
    """The error of a product P·Ht (K6, or K1/K2's second output) against
    its reference ref = P·Ht, each entry in units of its bound
    sqrt(P_ii·(Htᵀ·P·Ht)_kk); P_diag (B,D) is P's diagonal."""
    hph = (Ht.to(ref.dtype) * ref).sum(dim=1).clamp_min(0)
    return entry_error(out.to(ref.dtype) - ref,
                        P_diag.to(ref.dtype).clamp_min(0), hph)


def pht_blocks_error(out, P, H_xv, H_y, sel, r) -> float:
    """pht_blocks' output (PHt, S) against its f64 plain version on the
    same operands, each entry in units of its Cauchy–Schwarz bound:
    |PHt_ik| ≤ sqrt(P_ii·(H·P·Hᵀ)_kk), (H·P·Hᵀ)_kk = S_kk − r_k, and
    |S_rs| ≤ sqrt(S_rr·S_ss)."""
    ref, ref_S = pht_blocks_plain(P.double(), H_xv.double(), H_y.double(),
                                  sel, r.double())
    dS = torch.diagonal(ref_S, dim1=1, dim2=2)
    dP = torch.diagonal(P.double(), dim1=1, dim2=2).clamp_min(0)
    return max(entry_error(out[0].double() - ref, dP,
                           (dS - r.double()).clamp_min(0)),
               entry_error(out[1].double() - ref_S, dS, dS))


def ncc_error(out, ref, windows, tm) -> float:
    """K7's error against its reference ref, each entry in units of its
    Cauchy–Schwarz bound |out[n,oy,ox]| ≤ ‖window patch at (oy,ox)‖·‖tm_n‖,
    both norms from f64 box sums. A whole-output relative error would miss
    a wrong tap."""
    w, tm = windows.double(), tm.double()
    patch_sq = ncc_corr_plain(w * w, torch.ones_like(tm)).clamp_min(0)
    tnorm = torch.linalg.vector_norm(tm, dim=(1, 2))[:, None, None]
    bound = torch.sqrt(patch_sq) * tnorm
    diff = out.double() - ref.double()
    err = torch.where(diff == 0, torch.zeros_like(diff), diff.abs() / bound)
    return float(err.max())


def var_stray(var, ref_var, ref_energy) -> float:
    """The largest stray of patch variances `var` from their reference,
    in units of eps_f32·Σwc² of the pair's window (ref_energy): the units
    of ncc.FLAT_EPS, the floor under which the matcher scores a patch as
    flat."""
    unit = torch.finfo(torch.float32).eps * ref_energy.double()
    return float(((var.double() - ref_var.double()).abs()
                  / unit[:, None, None]).max())


def energy_error(energy, ref_energy) -> float:
    """The largest relative error of the windows' energies Σwc²."""
    ref = ref_energy.double()
    return float(((energy.double() - ref).abs() / ref).max())


def stale_slots(P, keepN):
    """P with a stale variance on each dim that keepN drops (the largest
    landmark variance of its instance), as a slot freed without zeroing
    would hold: the operand of K3's planted keep fault. On the path the
    new slots' rows enter K3 as zeros (a deleted feature's rows are zeroed
    where it is deleted), so a K3 that ignored keepN would read right
    there."""
    var = torch.diagonal(P, dim1=1, dim2=2)[:, 13:].max(dim=1).values
    return P + torch.diag_embed((keepN == 0) * var[:, None])


@contextlib.contextmanager
def capture_operands():
    """Within the block every wrapper records a copy of its operands, then
    runs as before. Yields {name: [args of each call, in call order]}."""
    captured = {}

    def recorder(name, fn):
        def record(*args):
            captured.setdefault(name, []).append(tuple(
                a.clone() if isinstance(a, torch.Tensor) else a
                for a in args))
            return fn(*args)
        return record

    with mock.patch.multiple(__name__, **{
            name: recorder(name, globals()[name]) for name in PLAIN}):
        yield captured


# --- kernel wrappers --------------------------------------------------------

def _check(name, shapes: dict, tensors: dict, bf16=()):
    """Shapes, contiguity and one device for every operand; True when they
    lie on a CUDA device (then all float32, the operands named in `bf16`
    float32 or bfloat16), False on the CPU."""
    first, dev = next((k, t.device) for k, t in tensors.items())
    for k, t in tensors.items():
        if tuple(t.shape) != shapes[k]:
            raise ValueError(f"{name}: {k} has shape {tuple(t.shape)}, "
                             f"expected {shapes[k]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} is not contiguous")
        if t.device != dev:
            raise ValueError(f"{name}: {k} on {t.device}, {first} on {dev}")
    if dev.type == "cuda":
        for k, t in tensors.items():
            ok = (torch.float32, torch.bfloat16) if k in bf16 else (
                torch.float32,)
            if t.dtype not in ok:
                raise TypeError(f"{name}: the CUDA kernel takes "
                                f"{' or '.join(map(str, ok))} for {k}, "
                                f"got {t.dtype}")
        return True
    if dev.type != "cpu":
        raise ValueError(f"{name}: no kernel or plain version for {dev}")
    return False


def _launch(name, fn, *args):
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{err} (1: a size outside the kernel's limits)")


def _run(name, fn, *args):
    _launch(name, fn, *args)
    LAUNCHES[name] += 1


def _j8(Jq4):
    """(B,4,4) -> (B,8,8) I₈ with Jq4 at 3:7 (the stripe transform)."""
    J8 = torch.eye(8, dtype=Jq4.dtype, device=Jq4.device).repeat(
        Jq4.shape[0], 1, 1)
    J8[:, 3:7, 3:7] = Jq4
    return J8


def fused_manage_predict_pht(P, keep, E6, U6, C66, F13, Q13, Ht):
    """K1: P (B,D,D); keep (B,D); E6, U6 (B,r,D); C66 (B,r,r);
    F13, Q13 (B,13,13); Ht (B,D,R). Returns (P⁻ (B,D,D), PHt (B,D,R))."""
    name = "fused_manage_predict_pht"
    B, D, _ = P.shape
    r, R = E6.shape[1], Ht.shape[2]
    on_card = _check(name, {
        "P": (B, D, D), "keep": (B, D), "E6": (B, r, D), "U6": (B, r, D),
        "C66": (B, r, r), "F13": (B, 13, 13), "Q13": (B, 13, 13),
        "Ht": (B, D, R)}, dict(P=P, keep=keep, E6=E6, U6=U6, C66=C66,
                               F13=F13, Q13=Q13, Ht=Ht))
    if not on_card:
        return manage_predict_pht_plain(P, keep, E6, U6, C66, F13, Q13, Ht)
    # Lp padded to a 16-stripe, identity on 13:16; Q̃ zero-padded.
    F16 = torch.eye(16, dtype=P.dtype, device=P.device).repeat(B, 1, 1)
    F16[:, :13, :13] = F13
    Q16 = torch.zeros(B, 16, 16, dtype=P.dtype, device=P.device)
    Q16[:, :13, :13] = Q13
    out = torch.empty_like(P)
    pht = torch.empty(B, D, R, dtype=P.dtype, device=P.device)
    V = torch.empty_like(U6)            # the kernel's scratch: U6 + ½·C66·E6
    lib = _build.load()
    ptrs = (t.data_ptr() for t in (P, keep, E6, U6, C66, F16, Q16, Ht, V,
                                   out, pht))
    _run(name, lib.ekf_k1_manage_predict_pht, *ptrs, B, D, R, r)
    return out, pht


def fused_update_tail_pht(P, K, PHt, Jq4, Ht):
    """K2: P (B,D,D); K, PHt (B,D,M2); Jq4 (B,4,4); Ht (B,D,R).
    Returns (P_li (B,D,D), PHt2 (B,D,R))."""
    name = "fused_update_tail_pht"
    B, D, _ = P.shape
    M2, R = K.shape[2], Ht.shape[2]
    on_card = _check(name, {
        "P": (B, D, D), "K": (B, D, M2), "PHt": (B, D, M2),
        "Jq4": (B, 4, 4), "Ht": (B, D, R)},
        dict(P=P, K=K, PHt=PHt, Jq4=Jq4, Ht=Ht))
    if not on_card:
        return update_tail_pht_plain(P, K, PHt, Jq4, Ht)
    J8 = _j8(Jq4)
    out = torch.empty_like(P)
    pht2 = torch.empty(B, D, R, dtype=P.dtype, device=P.device)
    lib = _build.load()
    ptrs = (t.data_ptr() for t in (P, K, PHt, J8, Ht, out, pht2))
    _run(name, lib.ekf_k2_update_tail_pht, *ptrs, B, D, M2, R)
    return out, pht2


def fused_update_tail_add(P, K, PHt, Jq4, keepN, EN, UN, CN):
    """K3: P (B,D,D); K, PHt (B,D,M2); Jq4 (B,4,4); keepN (B,D);
    EN, UN (B,r,D); CN (B,r,r). Returns P' (B,D,D)."""
    name = "fused_update_tail_add"
    B, D, _ = P.shape
    M2, r = K.shape[2], EN.shape[1]
    on_card = _check(name, {
        "P": (B, D, D), "K": (B, D, M2), "PHt": (B, D, M2),
        "Jq4": (B, 4, 4), "keepN": (B, D), "EN": (B, r, D),
        "UN": (B, r, D), "CN": (B, r, r)},
        dict(P=P, K=K, PHt=PHt, Jq4=Jq4, keepN=keepN, EN=EN, UN=UN, CN=CN))
    if not on_card:
        return update_tail_add_plain(P, K, PHt, Jq4, keepN, EN, UN, CN)
    J8 = _j8(Jq4)
    out = torch.empty_like(P)
    V = torch.empty_like(UN)            # the kernel's scratch: UN + ½·CN·EN
    lib = _build.load()
    ptrs = (t.data_ptr() for t in (P, K, PHt, J8, keepN, EN, UN, CN, V, out))
    _run(name, lib.ekf_k3_update_tail_add, *ptrs, B, D, M2, r)
    return out


def corr_apply_cols(P, A, B):
    """K4: P (B,D,D), f32 or bf16; A, B (B,D,R), any R. Returns
    ½(P + Pᵀ) + ½(A·Bᵀ + B·Aᵀ) (B,D,D) in P's dtype, bitwise symmetric."""
    name = "corr_apply_cols"
    Bn, D, _ = P.shape
    R = A.shape[2]
    on_card = _check(name, {"P": (Bn, D, D), "A": (Bn, D, R),
                            "B": (Bn, D, R)}, dict(P=P, A=A, B=B), ("P",))
    if not on_card:
        return corr_apply_cols_plain(P, A, B)
    out = torch.empty_like(P)
    lib = _build.load()
    _run(name, lib.ekf_k4_corr_apply_cols, P.data_ptr(), A.data_ptr(),
         B.data_ptr(), out.data_ptr(), Bn, D, R,
         int(P.dtype == torch.bfloat16))
    return out


def corr_apply(P, At, Bt, symmetrize="expr"):
    """K8: P (B,D,D), f32 or bf16; At, Bt (B,R,D), any R; symmetrize one
    of CORR_MODES. Returns P + C, P + ½(C + Cᵀ) or ½(P + Pᵀ) + ½(C + Cᵀ),
    C = Atᵀ·Bt, (B,D,D) in P's dtype; the correction of "expr" and "full"
    is bitwise symmetric (the kernel computes C + Cᵀ once a tile pair, as
    one sum over [At; Bt]ᵀ[Bt; At], and mirrors it)."""
    name = "corr_apply"
    mode = _corr_mode(symmetrize)
    Bn, D, _ = P.shape
    R = At.shape[1]
    on_card = _check(name, {"P": (Bn, D, D), "At": (Bn, R, D),
                            "Bt": (Bn, R, D)}, dict(P=P, At=At, Bt=Bt),
                     ("P",))
    if not on_card:
        return corr_apply_plain(P, At, Bt, symmetrize)
    out = torch.empty_like(P)
    lib = _build.load()
    _run(name, lib.ekf_k8_corr_apply, P.data_ptr(), At.data_ptr(),
         Bt.data_ptr(), out.data_ptr(), Bn, D, R, mode,
         int(P.dtype == torch.bfloat16))
    return out


def corr_apply_rows(P_slab, At, Bt, r0: int):
    """K8's row-slab form: P_slab (B,Dl,Dc), f32 or bf16, rows r0 ..
    r0+Dl−1 of a P with Dc columns (r0 + Dl <= Dc); At, Bt (B,R,Dc), any
    R, the whole factors. Returns P_slab + At[:, :, r0:r0+Dl]ᵀ·Bt (B,Dl,Dc)
    in P_slab's dtype: rows r0 .. of corr_apply(P, At, Bt, "none"), which
    the kernel reproduces bit for bit."""
    name = "corr_apply_rows"
    Bn, Dl, Dc = P_slab.shape
    R = At.shape[1]
    if not 0 <= r0 <= Dc - Dl:
        raise ValueError(f"{name}: rows {r0} .. {r0 + Dl - 1} outside "
                         f"a P with {Dc} columns")
    on_card = _check(name, {"P_slab": (Bn, Dl, Dc), "At": (Bn, R, Dc),
                            "Bt": (Bn, R, Dc)},
                     dict(P_slab=P_slab, At=At, Bt=Bt), ("P_slab",))
    if not on_card:
        return corr_apply_rows_plain(P_slab, At, Bt, r0)
    out = torch.empty_like(P_slab)
    lib = _build.load()
    _run(name, lib.ekf_k8_corr_apply_rows, P_slab.data_ptr(), At.data_ptr(),
         Bt.data_ptr(), out.data_ptr(), Bn, Dl, Dc, R, r0,
         int(P_slab.dtype == torch.bfloat16))
    return out


def fused_update_tail(P, K, PHt, Jq4):
    """K5: P (B,D,D); K, PHt (B,D,M2), any M2; Jq4 (B,4,4). Returns
    T·(P − ½(K·PHtᵀ + PHt·Kᵀ))·Tᵀ (B,D,D)."""
    name = "fused_update_tail"
    B, D, _ = P.shape
    M2 = K.shape[2]
    on_card = _check(name, {"P": (B, D, D), "K": (B, D, M2),
                            "PHt": (B, D, M2), "Jq4": (B, 4, 4)},
                     dict(P=P, K=K, PHt=PHt, Jq4=Jq4))
    if not on_card:
        return update_tail_plain(P, K, PHt, Jq4)
    J8 = _j8(Jq4)
    out = torch.empty_like(P)
    lib = _build.load()
    _run(name, lib.ekf_k5_update_tail, P.data_ptr(), K.data_ptr(),
         PHt.data_ptr(), J8.data_ptr(), out.data_ptr(), B, D, M2)
    return out


def f32_matmul_big(A, B):
    """K6: A (B,M,K), f32 or bf16; B (B,K,N), any N. Returns A·B (B,M,N)
    in B's dtype (f32 on the card) with every partial sum in f32, A read
    once for N ≤ 128 (once per 128-column chunk beyond)."""
    name = "f32_matmul_big"
    Bn, M, Kd = A.shape
    N = B.shape[2]
    on_card = _check(name, {"A": (Bn, M, Kd), "B": (Bn, Kd, N)},
                     dict(A=A, B=B), ("A",))
    if not on_card:
        return matmul_big_plain(A, B)
    out = torch.empty(Bn, M, N, dtype=B.dtype, device=B.device)
    lib = _build.load()
    _run(name, lib.ekf_k6_matmul_big, A.data_ptr(), B.data_ptr(),
         out.data_ptr(), Bn, M, Kd, N, int(A.dtype == torch.bfloat16))
    return out


def eight_point_fit(M, eigvec: bool = False):
    """M (N,9,9). Returns F₂ (N,3,3): the eigenvector f of the smallest
    eigenvalue of ½(M + Mᵀ), reshaped row-major to 3x3 and projected to
    rank 2 (F·(I − v₃v₃ᵀ)); all NaN for a non-finite M. With eigvec, (F₂,
    f (N,9)), for checking the solve. The kernel reads nothing back to the
    host, so a frame that calls it can be captured."""
    name = "eight_point_fit"
    N = M.shape[0]
    on_card = _check(name, {"M": (N, 9, 9)}, dict(M=M))
    if not on_card:
        return eight_point_fit_plain(M, eigvec)
    out = torch.empty(N, 3, 3, dtype=M.dtype, device=M.device)
    f = torch.empty(N, 9, dtype=M.dtype, device=M.device) if eigvec else None
    lib = _build.load()
    _run(name, lib.ekf_eight_point_fit, M.data_ptr(), out.data_ptr(),
         0 if f is None else f.data_ptr(), N)
    return (out, f) if eigvec else out


def spd_inverse_newton(S):
    """S (B,n,n). Returns spd_inverse_newton_plain(S) (B,n,n). On the card
    an f32 S with n <= NEWTON_MAX_N takes one kernel launch (one block an
    instance, every iteration in shared memory, ascending-k FFMA chains:
    deterministic, and an instance's bits do not depend on its batch),
    counted in COUNTS, not in LAUNCHES; where the plain version is NaN
    for a non-finite S (λ̂ NaN), so is the kernel. Any other S on the card
    (f64, or n past what shared memory holds) takes the plain version's
    batched torch.matmul iteration, counted in COUNTS["newton_plain"]."""
    name = "spd_inverse_newton"
    Bn, n = S.shape[0], S.shape[-1]
    if S.is_cuda and (S.dtype != torch.float32 or n > NEWTON_MAX_N):
        count("newton_plain")
        return spd_inverse_newton_plain(S)
    if not _check(name, {"S": (Bn, n, n)}, dict(S=S)):
        return spd_inverse_newton_plain(S)
    W = torch.empty_like(S)
    if Bn == 0:
        return W
    _launch(name, _build.load().ekf_spd_inverse_newton, S.data_ptr(),
            W.data_ptr(), Bn, n)
    count(name)
    return W


def pht_blocks(P, H_xv, H_y, sel, r):
    """P (B,D,D), f32 or bf16, D = 13 + 6·CAP; H_xv (B,M,2,13), H_y
    (B,M,2,6), r (B,2M); sel (B,M) int64, distinct slots in [0, CAP).
    Returns pht_blocks_plain(P, H_xv, H_y, sel, r): (P·Hᵀ (B,D,2M), H·P·Hᵀ
    + diag(r) (B,2M,2M)) for the Jacobian whose row 2m+c is H_xv[:, m, c]
    on the camera columns and H_y[:, m, c] on the columns of slot sel[:,
    m]. On the card (f32 operands, P f32 or bf16) one kernel launch, P
    read once as stored, counted in COUNTS, not in LAUNCHES; the
    launcher refuses CAP > 200, whose stage ring overflows shared memory
    (RuntimeError)."""
    name = "pht_blocks"
    B, D, _ = P.shape
    M = sel.shape[1]
    on_card = _check(name, {"P": (B, D, D), "H_xv": (B, M, 2, 13),
                            "H_y": (B, M, 2, 6), "r": (B, 2 * M)},
                     dict(P=P, H_xv=H_xv, H_y=H_y, r=r), ("P",))
    if (tuple(sel.shape) != (B, M) or sel.dtype != torch.int64
            or not sel.is_contiguous() or sel.device != P.device):
        raise ValueError(f"{name}: sel must be a contiguous int64 (B, M) "
                         f"= ({B}, {M}) tensor on {P.device}")
    if not on_card:
        return pht_blocks_plain(P, H_xv, H_y, sel, r)
    PHt = torch.empty(B, D, 2 * M, dtype=H_xv.dtype, device=P.device)
    S = torch.empty(B, 2 * M, 2 * M, dtype=H_xv.dtype, device=P.device)
    if B == 0 or M == 0:
        return PHt, S
    _launch(name, _build.load().ekf_pht_blocks, P.data_ptr(),
            H_xv.data_ptr(), H_y.data_ptr(), sel.data_ptr(), r.data_ptr(),
            PHt.data_ptr(), S.data_ptr(), B, D, M,
            int(P.dtype == torch.bfloat16))
    count(name)
    return PHt, S


def _ncc_operands(name, windows, tm):
    """K7's operand checks: (on the card?, N, W2, t)."""
    N, W2 = windows.shape[0], windows.shape[-1]
    t = tm.shape[-1]
    if not 1 <= t <= W2:
        raise ValueError(f"{name}: template {t} wider than window {W2}")
    on_card = _check(name, {"windows": (N, W2, W2), "tm": (N, t, t)},
                     dict(windows=windows, tm=tm))
    return on_card, N, W2, t


def ncc_corr(windows, tm):
    """K7: windows (N,W2,W2); tm (N,t,t) zero-mean templates, t ≤ W2.
    Returns out (N,R2,R2), R2 = W2 − t + 1, out[n,oy,ox] =
    Σ_{dy,dx} windows[n,oy+dy,ox+dx]·tm[n,dy,dx]."""
    name = "ncc_corr"
    on_card, N, W2, t = _ncc_operands(name, windows, tm)
    if not on_card:
        return ncc_corr_plain(windows, tm)
    R2 = W2 - t + 1
    out = torch.empty(N, R2, R2, dtype=windows.dtype, device=windows.device)
    lib = _build.load()
    _run(name, lib.ekf_k7_ncc_corr, windows.data_ptr(), tm.data_ptr(),
         out.data_ptr(), N, W2, t)
    return out


def ncc_corr_norms(windows, tm):
    """K7 with the NCC norms, as ncc_corr takes its operands. Returns
    (corr (N,R2,R2), var (N,R2,R2), energy (N,)): ncc_corr's output; each
    offset's t×t patch variance (times t²) of the window less its mean,
    clamped at 0; each window's Σwc². The kernel forms the norms from
    direct box sums of the staged window, the plain version from integral
    images."""
    name = "ncc_corr_norms"
    on_card, N, W2, t = _ncc_operands(name, windows, tm)
    if not on_card:
        return ncc_corr_norms_plain(windows, tm)
    R2 = W2 - t + 1
    corr = torch.empty(N, R2, R2, dtype=windows.dtype, device=windows.device)
    var = torch.empty_like(corr)
    energy = torch.empty(N, dtype=windows.dtype, device=windows.device)
    lib = _build.load()
    _run(name, lib.ekf_k7_ncc_corr_norms, windows.data_ptr(), tm.data_ptr(),
         corr.data_ptr(), var.data_ptr(), energy.data_ptr(), N, W2, t)
    return corr, var, energy
