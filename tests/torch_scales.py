"""Each entry's scale of the fused kernels' outputs — the function's sums
over absolute values — and the check of an output against its reference
in units of that scale. Shared by tests/test_torch_kernel_schedules.py and
tests/test_torch_cuda.py; imports torch and the port only."""

import torch

from ekf_slam_tpu_torch.ops import kernels


def k3_scale(P, K, PHt, Jq4, keepN=None, EN=None, UN=None, CN=None):
    """Of K3's P (K5's without keepN, EN, UN, CN)."""
    a = torch.abs
    S = a(P) + 0.5 * (a(K) @ a(PHt).transpose(1, 2)
                      + a(PHt) @ a(K).transpose(1, 2))
    S = kernels._stripe(S, a(Jq4), 3, 7)
    if EN is None:
        return S
    Et = a(EN).transpose(1, 2)
    return (kernels._keep_mask(S, keepN) + Et @ a(UN)
            + a(UN).transpose(1, 2) @ a(EN) + Et @ a(CN) @ a(EN))


def k1_scale(P, keep, E6, U6, C66, F13, Q13, Ht):
    """Of K1's P⁻ and P⁻·Ht."""
    a = torch.abs
    Et = a(E6).transpose(1, 2)
    S = (kernels._keep_mask(a(P), keep) + Et @ a(U6)
         + a(U6).transpose(1, 2) @ a(E6) + Et @ a(C66) @ a(E6))
    S = kernels._stripe(S, a(F13), 0, 13)
    S[:, :13, :13] += a(Q13)
    return S, S @ a(Ht)


def within(got, want, scales, tol):
    """Every entry of every output within tol of its scale."""
    return all(bool(((g.double() - w.double()).abs() <= tol * s).all())
               for g, w, s in zip(got, want, scales))
