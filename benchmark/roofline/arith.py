"""Operations and bytes of one call of each of the port's kernels, and
the card's peaks: the roofline's frozen arithmetic.

A frozen copy of the repository's kernel arithmetic (``chip_smoke.py``'s
``FLOPS``), so that what the per-layer roofline metrics count cannot move
with the program. Each entry takes the call's operands (only their
shapes are read; meta tensors serve) and returns the floating-point
operations the function needs; ``bytes`` counts each operand and output
once. A call's least time on the card is max(flops / PEAK_F32_FLOPS,
bytes / PEAK_BYTES), whichever binds.

The peaks are NVIDIA's data-sheet figures for the H100 SXM at its full
power limit of 700 W: 67 TFLOP/s in float32 outside the tensor cores
(the port's kernels are float32 FFMA code, with TF32 off) and 3.35 TB/s
of device memory. A card set below 700 W runs slower under load, so every
traced run prints the card's ``power.limit`` beside its numbers.
"""

from __future__ import annotations

PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The call's least time on the card, seconds."""
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)


def _sym(D: int) -> int:
    """Entries of a symmetric D x D output that must be computed."""
    return D * (D + 1) // 2


# Floating-point operations of one call, from its operands: the plain
# version's multiply-adds, each entry of a symmetric output counted once
# (the downdate ½(K·PHtᵀ + PHt·Kᵀ): 4R an entry; the low-rank EᵀU + UᵀE +
# EᵀCE as [E; V]ᵀ[V; E] with V = U + ½·C·E: 4r an entry and 2r²D for V;
# K4's ½(A·Bᵀ + B·Aᵀ) and K8's ½(AtᵀBt + BtᵀAt) in "expr" / "full": 4R;
# K8's AtᵀBt in "none", not symmetric: 2R an entry over all D² entries),
# the low-rank factors dense, as the kernels compute them. K7's norms, a
# pair, the least that direct sums need (no running sums): W2² each for
# the mean, the centring, the squares and Σwc²; t − 1 adds for each row
# sum of wc and of wc² (W2·R2 of each) and for each column sum of those
# (R2² of each); 4 an offset for the variance.
def _ncc_flops(win, tm, norms: bool) -> int:
    N, W2, t = win.shape[0], win.shape[-1], tm.shape[-1]
    R2 = W2 - t + 1
    corr = 2 * N * R2 ** 2 * t ** 2
    if not norms:
        return corr
    return corr + N * (4 * W2 ** 2 + 2 * (t - 1) * (W2 * R2 + R2 ** 2)
                       + 4 * R2 ** 2)


FLOPS = {
    "fused_manage_predict_pht": lambda P, keep, E6, U6, C66, F13, Q13, Ht:
        P.shape[0] * (2 * P.shape[1] ** 2 * Ht.shape[2]
                      + 4 * _sym(P.shape[1]) * E6.shape[1]
                      + 2 * E6.shape[1] ** 2 * P.shape[1]
                      + 4 * 13 * 13 * P.shape[1]),
    "fused_update_tail_pht": lambda P, K, PHt, Jq4, Ht:
        P.shape[0] * (4 * _sym(P.shape[1]) * K.shape[2]
                      + 2 * P.shape[1] ** 2 * Ht.shape[2]
                      + 4 * 4 * 4 * P.shape[1]),
    "fused_update_tail_add": lambda P, K, PHt, Jq4, keepN, EN, UN, CN:
        P.shape[0] * (4 * _sym(P.shape[1]) * K.shape[2]
                      + 4 * _sym(P.shape[1]) * EN.shape[1]
                      + 2 * EN.shape[1] ** 2 * P.shape[1]
                      + 4 * 4 * 4 * P.shape[1]),
    "corr_apply_cols": lambda P, A, B:
        P.shape[0] * 4 * _sym(P.shape[1]) * A.shape[2],
    "fused_update_tail": lambda P, K, PHt, Jq4:
        P.shape[0] * (4 * _sym(P.shape[1]) * K.shape[2]
                      + 4 * 4 * 4 * P.shape[1]),
    "f32_matmul_big": lambda A, B:
        2 * A.shape[0] * A.shape[1] * A.shape[2] * B.shape[2],
    "ncc_corr": lambda win, tm: _ncc_flops(win, tm, False),
    "ncc_corr_norms": lambda win, tm: _ncc_flops(win, tm, True),
    "corr_apply": lambda P, At, Bt, mode="expr":
        P.shape[0] * (2 * P.shape[1] ** 2 * At.shape[1] if mode == "none"
                      else 4 * _sym(P.shape[1]) * At.shape[1]),
    # K8's row-slab form: "none" on the slab's Dl x Dc entries
    "corr_apply_rows": lambda P, At, Bt, r0:
        2 * P.shape[0] * P.shape[1] * P.shape[2] * At.shape[1],
    # eight_point_fit, a matrix: the least its Jacobi needs, one sweep (its
    # convergence test ends the loop where the data allows): the symmetric
    # half (135), the off-diagonal sum (72), 36 rotations of 6 flops on
    # each of 7 (a_kp, a_kq) pairs and 9 rows of the rotations plus 12 for
    # t, c, s and the diagonal; the 3x3's sweep of 3 column pairs (18 for
    # the dot products, 36 for rotating G and W, 12 for the rotation) and
    # the projection (36)
    "eight_point_fit": lambda M, *_: M.shape[0] * (
        135 + 72 + 36 * (6 * 7 + 6 * 9 + 12) + 3 * (18 + 36 + 12) + 36),
}
