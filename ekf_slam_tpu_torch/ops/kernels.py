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
  image path:
  K7 ncc_corr                 — the NCC matcher's correlation numerator
                                over N (window, template) pairs (ncc.cu)

Each wrapper takes batched tensors (leading instance axis B; K7 the pair
axis N). A tensor on the CPU goes to the plain version beside the
wrapper; a CUDA tensor goes to the hand-written kernel or the wrapper
raises. On the card every operand is float32, except P of K4 and K8 and
A of K6, which may be the fast mode's bfloat16 P (FilterConfig.p_storage):
those kernels read it as stored and upcast, and K4 / K8 store their
output in P's dtype. The plain versions upcast the same way.
``LAUNCHES[name]`` counts kernel launches. The kernels' size limits
(R = 2·CAP ≤ 256 for K1/K2, feature-add rank ≤ 128 for K3; K4-K6 and K8
take any width; K7 a window that fits shared memory) are checked by the
launchers, which return cudaErrorInvalidValue (1).

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
            "corr_apply": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


PLAIN = {"fused_manage_predict_pht": manage_predict_pht_plain,
         "fused_update_tail_pht": update_tail_pht_plain,
         "fused_update_tail_add": update_tail_add_plain,
         "corr_apply_cols": corr_apply_cols_plain,
         "fused_update_tail": update_tail_plain,
         "f32_matmul_big": matmul_big_plain,
         "ncc_corr": ncc_corr_plain,
         "corr_apply": corr_apply_plain}


# --- checking a kernel against its plain version ----------------------------

# Limit of scaled_error for an f32 kernel against its f64 plain version.
# f32 rounding reads up to ~1e-5 on the slice's operands (K3, in the
# quaternion rows, where the renorm Jacobian leaves a variance ~1e-8 beside
# terms ~1e-4); a missing term of the camera block — K1 without Q̃, a
# stripe transform applied to one side only — reads 0.1 or more.
SCALED_TOL = 1e-4

def _entry_error(diff, a, b, slack=None):
    """max |diff_ij| / sqrt(a_i·b_j); an entry whose bound is 0 must be 0.
    slack: a per-entry allowance taken off |diff| first."""
    diff = diff.abs()
    if slack is not None:
        diff = (diff - slack).clamp_min(0)
    bound = torch.sqrt(a[:, :, None] * b[:, None, :])
    err = torch.where(diff == 0, torch.zeros_like(diff), diff / bound)
    return float(err.max())


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
    errs = [_entry_error(out[0].to(ref[0].dtype) - ref[0], d, d, slack)]
    if len(ref) == 2:
        errs.append(product_error(out[1], ref[1], d, Ht))
    return max(errs)


def product_error(out, ref, P_diag, Ht) -> float:
    """The error of a product P·Ht (K6, or K1/K2's second output) against
    its reference ref = P·Ht, each entry in units of its bound
    sqrt(P_ii·(Htᵀ·P·Ht)_kk); P_diag (B,D) is P's diagonal."""
    hph = (Ht.to(ref.dtype) * ref).sum(dim=1).clamp_min(0)
    return _entry_error(out.to(ref.dtype) - ref,
                        P_diag.to(ref.dtype).clamp_min(0), hph)


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


def _run(name, fn, *args):
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{err} (1: a size outside the kernel's limits)")
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
    lib = _build.load()
    ptrs = (t.data_ptr() for t in (P, keep, E6, U6, C66, F16, Q16, Ht, out,
                                   pht))
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
    lib = _build.load()
    ptrs = (t.data_ptr() for t in (P, K, PHt, J8, keepN, EN, UN, CN, out))
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
    is bitwise symmetric."""
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
    once for N ≤ 256."""
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


def ncc_corr(windows, tm):
    """K7: windows (N,W2,W2); tm (N,t,t) zero-mean templates, t ≤ W2.
    Returns out (N,R2,R2), R2 = W2 − t + 1, out[n,oy,ox] =
    Σ_{dy,dx} windows[n,oy+dy,ox+dx]·tm[n,dy,dx]."""
    name = "ncc_corr"
    N, W2 = windows.shape[0], windows.shape[-1]
    t = tm.shape[-1]
    if not 1 <= t <= W2:
        raise ValueError(f"{name}: template {t} wider than window {W2}")
    on_card = _check(name, {"windows": (N, W2, W2), "tm": (N, t, t)},
                     dict(windows=windows, tm=tm))
    if not on_card:
        return ncc_corr_plain(windows, tm)
    R2 = W2 - t + 1
    out = torch.empty(N, R2, R2, dtype=windows.dtype, device=windows.device)
    lib = _build.load()
    _run(name, lib.ekf_k7_ncc_corr, windows.data_ptr(), tm.data_ptr(),
         out.data_ptr(), N, W2, t)
    return out
