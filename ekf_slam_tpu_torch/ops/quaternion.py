"""Quaternion / rotation algebra with analytic Jacobians (layer L0).

Port of ``ekf_slam_tpu/ops/quaternion.py``: the functions the sim-path
step calls, on tensors with any leading batch axes and the quaternion or
vector on the last axis. Quaternion convention q = [w, x, y, z], Hamilton
product (MonoSLAM's q2r.m / qprod.m / qconj.m / v2q.m). Singularity-safe
branchless forms as in the JAX module.
"""

from __future__ import annotations

import torch

from ekf_slam_tpu_torch.ops.consts import constant

_EPS = 2.220446049250313e-16  # MATLAB eps (double); v2q.m:11 threshold


def qprod(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Hamilton product q ⊗ p (qprod.m:1-7)."""
    a, v = q[..., 0], q[..., 1:]
    x, u = p[..., 0], p[..., 1:]
    w = a * x - torch.sum(v * u, dim=-1)
    xyz = (a[..., None] * u + x[..., None] * v
           + torch.linalg.cross(v, u, dim=-1))
    return torch.cat([w[..., None], xyz], dim=-1)


def qconj(q: torch.Tensor) -> torch.Tensor:
    """Quaternion conjugate (qconj.m:1-5)."""
    return q * constant((1.0, -1.0, -1.0, -1.0), q.dtype, q.device)


def q2r(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> rotation matrix (..., 3, 3), Davison form
    (q2r.m:1-10); assumes |q| = 1 like the reference."""
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack([r * r + x * x - y * y - z * z, 2 * (x * y - r * z),
                        2 * (z * x + r * y)], dim=-1)
    row1 = torch.stack([2 * (x * y + r * z), r * r - x * x + y * y - z * z,
                        2 * (y * z - r * x)], dim=-1)
    row2 = torch.stack([2 * (z * x - r * y), 2 * (y * z + r * x),
                        r * r - x * x - y * y + z * z], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def r2q(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion [w x y z], w >= 0
    (the reference's missing tr2q): the branchless Shepperd-style choice
    of the largest of the four squared components, as the JAX module."""
    r00, r11, r22 = R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]
    mags = torch.stack([1.0 + r00 + r11 + r22, 1.0 + r00 - r11 - r22,
                        1.0 - r00 + r11 - r22, 1.0 - r00 - r11 + r22], -1)
    s = 2.0 * torch.sqrt(torch.clamp(mags, min=1e-12))        # (..., 4)
    d21, d02, d10 = (R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1])
    a01, a02, a12 = (R[..., 0, 1] + R[..., 1, 0], R[..., 0, 2] + R[..., 2, 0],
                     R[..., 1, 2] + R[..., 2, 1])
    sw, sx, sy, sz = s.unbind(-1)
    cands = torch.stack([
        torch.stack([sw / 4.0, d21 / sw, d02 / sw, d10 / sw], -1),
        torch.stack([d21 / sx, sx / 4.0, a01 / sx, a02 / sx], -1),
        torch.stack([d02 / sy, a01 / sy, sy / 4.0, a12 / sy], -1),
        torch.stack([d10 / sz, a02 / sz, a12 / sz, sz / 4.0], -1)], -2)
    best = torch.argmax(mags, dim=-1)
    q = torch.take_along_dim(cands, best[..., None, None], dim=-2)[..., 0, :]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return torch.where(q[..., :1] < 0, -q, q)


def v2q(v: torch.Tensor) -> torch.Tensor:
    """Rotation vector -> quaternion [cos(θ/2), sin(θ/2) v/θ], θ = |v|;
    the identity quaternion for θ < eps (v2q.m:1-16)."""
    theta = torch.sqrt(torch.sum(v * v, dim=-1))
    small = theta < _EPS
    safe_theta = torch.where(small, torch.ones_like(theta), theta)
    half = 0.5 * safe_theta
    w = torch.where(small, torch.ones_like(theta), torch.cos(half))
    s = torch.where(small, torch.zeros_like(theta),
                    torch.sin(half) / safe_theta)
    return torch.cat([w[..., None], s[..., None] * v], dim=-1)


def azel_to_ray(theta: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """Azimuth/elevation -> unit ray m = [cosφ sinθ, −sinφ, cosφ cosθ]
    (m.m:1-16)."""
    cphi = torch.cos(phi)
    return torch.stack([cphi * torch.sin(theta), -torch.sin(phi),
                        cphi * torch.cos(theta)], dim=-1)


def dm_dtheta(theta: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """∂m/∂θ (inversedepth_2_cartesian.m:38)."""
    cphi = torch.cos(phi)
    return torch.stack([cphi * torch.cos(theta), torch.zeros_like(theta),
                        -cphi * torch.sin(theta)], dim=-1)


def dm_dphi(theta: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """∂m/∂φ (inversedepth_2_cartesian.m:39)."""
    sphi = torch.sin(phi)
    return torch.stack([-sphi * torch.sin(theta), -torch.cos(phi),
                        -sphi * torch.cos(theta)], dim=-1)


def norm_jac(q: torch.Tensor) -> torch.Tensor:
    """4x4 Jacobian of q / |q| (normJac.m:1-15). Returns (..., 4, 4)."""
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = (r * r + x * x + y * y + z * z) ** -1.5
    rows = [
        torch.stack([x * x + y * y + z * z, -r * x, -r * y, -r * z], dim=-1),
        torch.stack([-x * r, r * r + y * y + z * z, -x * y, -x * z], dim=-1),
        torch.stack([-y * r, -y * x, r * r + x * x + z * z, -y * z], dim=-1),
        torch.stack([-z * r, -z * x, -z * y, r * r + x * x + y * y], dim=-1),
    ]
    return n[..., None, None] * torch.stack(rows, dim=-2)


def left_mult_matrix(q: torch.Tensor) -> torch.Tensor:
    """L(q): qprod(q, p) == L(q) @ p (dq3_by_dq2.m:1-14)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        torch.stack([w, -x, -y, -z], dim=-1),
        torch.stack([x, w, -z, y], dim=-1),
        torch.stack([y, z, w, -x], dim=-1),
        torch.stack([z, -y, x, w], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def right_mult_matrix(p: torch.Tensor) -> torch.Tensor:
    """R(p): qprod(q, p) == R(p) @ q (the reference's missing dq3_by_dq1)."""
    w, x, y, z = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    rows = [
        torch.stack([w, -x, -y, -z], dim=-1),
        torch.stack([x, w, z, -y], dim=-1),
        torch.stack([y, -z, w, x], dim=-1),
        torch.stack([z, y, -x, w], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def dqbar_dq(dtype: torch.dtype, device=None) -> torch.Tensor:
    """∂(q̄)/∂q = diag(1,-1,-1,-1) (dqbar_by_dq.m:1-4)."""
    return torch.diag(constant((1.0, -1.0, -1.0, -1.0), dtype, device))


def dqomegadt_by_domega(omega: torch.Tensor, delta_t: float) -> torch.Tensor:
    """4x3 ∂q(ω·Δt)/∂ω (dqomegadt_by_domega.m:1-50), singularity-safe:
    at |ω| -> 0 the limit [0; (Δt/2)·I₃] is selected branchlessly."""
    dt = delta_t
    mod = torch.sqrt(torch.sum(omega * omega, dim=-1))
    small = mod < 1e-30
    safe = torch.where(small, torch.ones_like(mod), mod)
    s = torch.sin(safe * dt / 2.0)
    c = torch.cos(safe * dt / 2.0)
    w = omega

    row0 = (-dt / 2.0) * (w / safe[..., None]) * s[..., None]
    row0 = torch.where(small[..., None], torch.zeros_like(row0), row0)

    frac = (w * w) / safe[..., None] ** 2
    diag = ((dt / 2.0) * frac * c[..., None]
            + (1.0 / safe[..., None]) * (1.0 - frac) * s[..., None])
    diag = torch.where(small[..., None], torch.full_like(diag, dt / 2.0), diag)

    factor = (dt / 2.0) * c - s / safe
    outer = (w[..., :, None] * w[..., None, :]) / safe[..., None, None] ** 2
    off = outer * factor[..., None, None]
    off = torch.where(small[..., None, None], torch.zeros_like(off), off)

    eye = torch.eye(3, dtype=omega.dtype, device=omega.device)
    lower = off + (diag[..., :, None] - off) * eye
    return torch.cat([row0[..., None, :], lower], dim=-2)


def dRq_times_a_by_dq(q: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """3x4 ∂(R(q)·a)/∂q (dRq_times_a_by_dq.m:1-77). q (..., 4), a (..., 3)
    with matching leading axes. Returns (..., 3, 4)."""
    q0, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]

    def mat(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    two = 2.0
    dR0 = mat([[two * q0, -two * qz, two * qy],
               [two * qz, two * q0, -two * qx],
               [-two * qy, two * qx, two * q0]])
    dRx = mat([[two * qx, two * qy, two * qz],
               [two * qy, -two * qx, -two * q0],
               [two * qz, two * q0, -two * qx]])
    dRy = mat([[-two * qy, two * qx, two * q0],
               [two * qx, two * qy, two * qz],
               [-two * q0, two * qz, -two * qy]])
    dRz = mat([[-two * qz, -two * q0, two * qx],
               [two * q0, -two * qz, two * qy],
               [two * qx, two * qy, two * qz]])
    cols = [torch.sum(dR * a[..., None, :], dim=-1)
            for dR in (dR0, dRx, dRy, dRz)]
    return torch.stack(cols, dim=-1)
