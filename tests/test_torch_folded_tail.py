"""The folded covariance tail's factors (ekf._folded_tail_factors) at
rank M'+8, the symmetric downdate carried once, against the rank-(2M'+8)
pair that carries it twice (``wide_pair``, the form K4 was handed before)
and against T·sym(P − K·PHtᵀ)·Tᵀ written out; and the row-sharded slab's
one-sided pair (ekf._one_sided_factors), whose single product is the
symmetric correction.

Operands: a random SPD P (D = 13 + 6·16), a dense random H of M' rows,
PHt = P·Hᵀ, S = H·PHt + diag(r), K = PHt·S⁻¹ (or, "skew", through the
inverse of a non-symmetric S + 0.1·N, so that K·PHtᵀ is not symmetric),
and an iterate x_new whose quaternion is off unit norm (a renorm Jacobian
far from I₄). Torch only; on the CPU the K4 and K8 wrappers are their
plain versions. Limits: 1e-12 at f64 (read ≤ 6e-15), at f32 K4's card
limit kernels.SCALED_TOL = 1e-4 (read ≤ 1e-5, the rank-(2M'+8) pair's
worst), each entry in units of sqrt(P⁺ᵢᵢ·P⁺ⱼⱼ) of the f64 formula
(kernels.entry_error)."""

import pytest
import torch

from ekf_slam_tpu_torch.filter import ekf
from ekf_slam_tpu_torch.ops import kernels
from ekf_slam_tpu_torch.ops import quaternion as quat

torch.set_num_threads(1)

B, D = 3, 13 + 6 * 16
TOL = {torch.float64: 1e-12, torch.float32: kernels.SCALED_TOL}


def wide_pair(x_new, P4, K, PHt):
    """The rank-(2M'+8) factors with the downdate carried twice:
    Ā = [−½A | E₄ | W + E₄·(G·M₄₄·Gᵀ)], B̄ = [B | W | E₄], A = [K | PHt],
    B = [PHt | K], M₄ = P₄ − ½A₄Bᵀ, W = M₄ᵀGᵀ."""
    B_, D_, _ = K.shape
    A = torch.cat([K, PHt], dim=2)
    Bm = torch.cat([PHt, K], dim=2)
    eye4 = torch.eye(4, dtype=K.dtype, device=K.device)
    G = quat.norm_jac(x_new[:, 3:7]) - eye4
    M4 = P4 - 0.5 * (A[:, 3:7, :] @ Bm.transpose(1, 2))
    W = M4.transpose(1, 2) @ G.transpose(1, 2)
    E4 = torch.zeros(D_, 4, dtype=K.dtype, device=K.device)
    E4[3:7] = eye4
    E4 = E4.expand(B_, D_, 4)
    A_f = torch.cat([-0.5 * A, E4, W + E4 @ (G @ M4[:, :, 3:7]
                                             @ G.transpose(1, 2))], dim=2)
    return A_f, torch.cat([Bm, W, E4], dim=2)


def tail_operands(m, dtype, skew=False, seed=0, batch=B, dim=D):
    """(P, x_new, K, PHt) at M' = m in `dtype` (formed at f64 on the CPU),
    `batch` instances of a state of `dim`."""
    g = torch.Generator().manual_seed(seed)
    f64 = torch.float64
    X = torch.randn(batch, dim, dim, generator=g, dtype=f64)
    P = X @ X.transpose(1, 2) / dim + 0.1 * torch.eye(dim, dtype=f64)
    H = torch.randn(batch, m, dim, generator=g, dtype=f64)
    PHt = P @ H.transpose(1, 2)
    S = H @ PHt + torch.diag_embed(
        torch.rand(batch, m, generator=g, dtype=f64) + 0.5)
    if skew:
        N = torch.randn(batch, m, m, generator=g, dtype=f64)
        S = S + 0.1 * float(S.abs().max()) * (N - N.transpose(1, 2)) / m
    K = PHt @ torch.linalg.inv(S)
    x_new = torch.randn(batch, dim, generator=g, dtype=f64)
    x_new[:, 3:7] *= 1.3 / torch.linalg.vector_norm(x_new[:, 3:7], dim=1,
                                                    keepdim=True)
    return tuple(t.to(dtype) for t in (P, x_new, K, PHt))


def tail_formula(P, x_new, K, PHt):
    """T·sym(P − K·PHtᵀ)·Tᵀ, T = I ⊕ normJac(q) on dims 3:7, dense."""
    T = torch.eye(P.shape[1], dtype=P.dtype, device=P.device).repeat(
        P.shape[0], 1, 1)
    T[:, 3:7, 3:7] = quat.norm_jac(x_new[:, 3:7])
    M = P - K @ PHt.transpose(1, 2)
    return T @ (0.5 * (M + M.transpose(1, 2))) @ T.transpose(1, 2)


def scaled(got, want):
    """max |got − want| in units of sqrt(want_ii·want_jj)."""
    d = torch.diagonal(want, dim1=1, dim2=2).clamp_min(0)
    return kernels.entry_error(got.double() - want, d, d)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("skew", [False, True], ids=["spd_inverse", "skew"])
@pytest.mark.parametrize("m", [6, 24, 64])
def test_fold_at_rank_m_plus_8_is_the_tail(m, skew, dtype):
    """R = M'+8; K4's plain version on the new pair equals it on the
    rank-(2M'+8) pair and equals T·sym(P − K·PHtᵀ)·Tᵀ, bitwise symmetric;
    the renormalized x is the iterate's with a unit quaternion."""
    P, x_new, K, PHt = tail_operands(m, dtype, skew)
    P4 = P[:, 3:7, :]
    x_out, A_f, B_f = ekf._folded_tail_factors(x_new, P4, K, PHt)
    assert A_f.shape == B_f.shape == (B, D, m + 8)
    assert A_f.dtype == B_f.dtype == dtype
    got = kernels.corr_apply_cols(P, A_f, B_f)
    assert torch.equal(got, got.transpose(1, 2))
    old = kernels.corr_apply_cols(P, *wide_pair(x_new, P4, K, PHt))
    want = tail_formula(*(t.double() for t in (P, x_new, K, PHt)))
    assert scaled(got, want) <= TOL[dtype]
    assert scaled(old, want) <= TOL[dtype]
    assert scaled(got, old.double()) <= TOL[dtype]
    assert torch.equal(x_out[:, 7:], x_new[:, 7:])
    q = torch.linalg.vector_norm(x_out[:, 3:7].double(), dim=1)
    assert float((q - 1).abs().max()) <= 10 * torch.finfo(dtype).eps


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("m", [6, 24, 64])
def test_one_sided_pair_alone_is_the_symmetric_correction(m, dtype):
    """The slab's pair (2M'+8 wide): Ā₂·B̄₂ᵀ alone equals ½(Ā·B̄ᵀ + B̄·Āᵀ)
    of K4's pair, and P + Ā₂·B̄₂ᵀ (K8 "none", and every row slab of it)
    equals T·sym(P − K·PHtᵀ)·Tᵀ, with K taken through a non-symmetric
    inverse."""
    P, x_new, K, PHt = tail_operands(m, dtype, skew=True, seed=1)
    _, A_f, B_f = ekf._folded_tail_factors(x_new, P[:, 3:7, :], K, PHt)
    A2, B2 = ekf._one_sided_factors(A_f, B_f)
    assert A2.shape == B2.shape == (B, D, 2 * m + 8)
    C = A_f.double() @ B_f.double().transpose(1, 2)
    sym = 0.5 * (C + C.transpose(1, 2))
    one = A2.double() @ B2.double().transpose(1, 2)
    scale = (A_f.double().abs() @ B_f.double().abs().transpose(1, 2))
    scale = scale + scale.transpose(1, 2)
    assert bool(((one - sym).abs() <= TOL[dtype] * scale).all())
    want = tail_formula(*(t.double() for t in (P, x_new, K, PHt)))
    At, Bt = (t.transpose(1, 2).contiguous() for t in (A2, B2))
    whole = kernels.corr_apply(P, At, Bt, "none")
    assert scaled(whole, want) <= TOL[dtype]
    for r0 in (0, 40, D - 29):
        rows = kernels.corr_apply_rows(P[:, r0:r0 + 29].contiguous(), At,
                                       Bt, r0)
        assert torch.equal(rows, whole[:, r0:r0 + 29])


def test_update_hands_k4_the_rank_m_plus_8_pair():
    """ekf.update's tail: K4 called once with factors M'+8 wide (M' the
    update's rows), its output the tail written out."""
    P, x_new, K, PHt = tail_operands(24, torch.float64, seed=2)
    with kernels.capture_operands() as calls:
        x_out, P_new = ekf._update_tail(x_new, P, K, PHt, use_pallas=False)
    (args,) = calls["corr_apply_cols"]
    assert args[1].shape == args[2].shape == (B, D, 24 + 8)
    assert torch.equal(P_new, P_new.transpose(1, 2))
    assert scaled(P_new, tail_formula(P, x_new, K, PHt)) <= 1e-12
