"""A plain-NumPy float64 implementation of the reference MonoSLAM math.

This module is the *golden oracle* for the TPU engine's fidelity tests
(BASELINE.json: trajectory RMSE <= 1e-6 vs the MATLAB-reference numerics).
It mirrors the reference equations in their original dynamic-shape form
(growing state vector, per-feature lists) with explicit inverses where the
reference uses them, so any divergence in the padded/masked TPU path shows up
against this.

It is intentionally NOT TPU-idiomatic and NOT a performance path.

Behavior sources: matlab_code/{fv,dfv_by_dxv,func_Q,predict_state_and_covariance,
update,hinv,hi_inverse_depth,hi_cartesian,calculate_Hi_inverse_depth,
calculate_Hi_cartesian,add_a_feature_covariance_inverse_depth,
inversedepth_2_cartesian}.m — equations re-derived, see per-function notes.

The PyTorch port's copy of ``ekf_slam_tpu/oracle/oracle.py``, line for
line, reading the port's own ``config``: every field it reads
(``CameraConfig``'s calibration and ``distort_newton_iters``,
``FilterConfig``'s noise and initial values) has the same name, type and
default in both packages. Two functions are the port's own, for the
iterated update of ``pipeline.OracleSLAM``: ``ekf_update_iterated`` and
``h_and_jacobian``.
"""

from __future__ import annotations

import numpy as np

from ekf_slam_tpu_torch.config import CameraConfig, FilterConfig

EPS = np.finfo(np.float64).eps


# ----------------------------------------------------------------- quaternion

def qprod(q, p):
    a, v = q[0], q[1:]
    x, u = p[0], p[1:]
    return np.concatenate([[a * x - v @ u], a * u + x * v + np.cross(v, u)])


def qconj(q):
    return np.array([q[0], -q[1], -q[2], -q[3]])


def q2r(q):
    r, x, y, z = q
    return np.array([
        [r * r + x * x - y * y - z * z, 2 * (x * y - r * z), 2 * (z * x + r * y)],
        [2 * (x * y + r * z), r * r - x * x + y * y - z * z, 2 * (y * z - r * x)],
        [2 * (z * x - r * y), 2 * (y * z + r * x), r * r - x * x - y * y + z * z]])


def v2q(v):
    theta = np.linalg.norm(v)
    if theta < EPS:
        return np.array([1.0, 0.0, 0.0, 0.0])
    vn = v / theta
    return np.concatenate([[np.cos(theta / 2)], np.sin(theta / 2) * vn])


def m_ray(theta, phi):
    cphi = np.cos(phi)
    return np.array([cphi * np.sin(theta), -np.sin(phi), cphi * np.cos(theta)])


def norm_jac(q):
    r, x, y, z = q
    n = (r * r + x * x + y * y + z * z) ** -1.5
    return n * np.array([
        [x * x + y * y + z * z, -r * x, -r * y, -r * z],
        [-x * r, r * r + y * y + z * z, -x * y, -x * z],
        [-y * r, -y * x, r * r + x * x + z * z, -y * z],
        [-z * r, -z * x, -z * y, r * r + x * x + y * y]])


def left_mult_matrix(q):   # dq3_by_dq2
    w, x, y, z = q
    return np.array([[w, -x, -y, -z],
                     [x, w, -z, y],
                     [y, z, w, -x],
                     [z, -y, x, w]])


def right_mult_matrix(p):  # dq3_by_dq1 (missing in the reference)
    w, x, y, z = p
    return np.array([[w, -x, -y, -z],
                     [x, w, z, -y],
                     [y, -z, w, x],
                     [z, y, -x, w]])


def dqomegadt_by_domega(omega, dt):
    mod = np.linalg.norm(omega)
    if mod < 1e-30:
        out = np.zeros((4, 3))
        out[1:, :] = np.eye(3) * dt / 2
        return out
    s, c = np.sin(mod * dt / 2), np.cos(mod * dt / 2)
    out = np.zeros((4, 3))
    for a in range(3):
        out[0, a] = (-dt / 2) * (omega[a] / mod) * s
        for b in range(3):
            if a == b:
                out[a + 1, b] = ((dt / 2) * omega[a] ** 2 / mod**2 * c
                                 + (1 / mod) * (1 - omega[a] ** 2 / mod**2) * s)
            else:
                out[a + 1, b] = (omega[a] * omega[b] / mod**2) * (
                    (dt / 2) * c - (1 / mod) * s)
    return out


def dRq_times_a_by_dq(q, a):
    q0, qx, qy, qz = q
    dR0 = 2 * np.array([[q0, -qz, qy], [qz, q0, -qx], [-qy, qx, q0]])
    dRx = 2 * np.array([[qx, qy, qz], [qy, -qx, -q0], [qz, q0, -qx]])
    dRy = 2 * np.array([[-qy, qx, q0], [qx, qy, qz], [-q0, qz, -qy]])
    dRz = 2 * np.array([[-qz, -q0, qx], [q0, -qz, qy], [qx, qy, qz]])
    return np.stack([dR @ a for dR in (dR0, dRx, dRy, dRz)], axis=1)


# --------------------------------------------------------------------- camera

def undistort(uvd, cam: CameraConfig):
    uvd = np.asarray(uvd, np.float64)
    xy = (uvd - [cam.cx, cam.cy]) * cam.d
    rd2 = np.sum(xy * xy)
    D = 1 + cam.k1 * rd2 + cam.k2 * rd2 * rd2
    return xy * D / cam.d + [cam.cx, cam.cy]


def distort(uvu, cam: CameraConfig):
    uvu = np.asarray(uvu, np.float64)
    xy = (uvu - [cam.cx, cam.cy]) * cam.d
    ru = np.sqrt(np.sum(xy * xy))
    rd = ru / (1 + cam.k1 * ru**2 + cam.k2 * ru**4)
    for _ in range(cam.distort_newton_iters):
        f = rd + cam.k1 * rd**3 + cam.k2 * rd**5 - ru
        fp = 1 + 3 * cam.k1 * rd**2 + 5 * cam.k2 * rd**4
        rd = rd - f / fp
    D = 1 + cam.k1 * rd**2 + cam.k2 * rd**4
    return xy / (D * cam.d) + [cam.cx, cam.cy]


def project(hrl, cam: CameraConfig):
    fku = cam.f / cam.d
    return np.array([cam.cx + hrl[0] / hrl[2] * fku,
                     cam.cy + hrl[1] / hrl[2] * fku])


def jacob_undistort(uvd, cam: CameraConfig):
    du, dv = uvd[0] - cam.cx, uvd[1] - cam.cy
    xd, yd = du * cam.d, dv * cam.d
    rd2 = xd * xd + yd * yd
    base = 1 + cam.k1 * rd2 + cam.k2 * rd2 * rd2
    g = cam.k1 + 2 * cam.k2 * rd2
    return np.array([
        [base + du * g * 2 * du * cam.d**2, du * g * 2 * dv * cam.d**2],
        [dv * g * 2 * du * cam.d**2, base + dv * g * 2 * dv * cam.d**2]])


def hinv(uvd, x_cam, cam: CameraConfig, initial_rho):
    uv = undistort(uvd, cam)
    fku = cam.f / cam.d
    h_lr = np.array([-(cam.cx - uv[0]) / fku, -(cam.cy - uv[1]) / fku, 1.0])
    n = q2r(x_cam[3:7]) @ h_lr
    theta = np.arctan2(n[0], n[2])
    phi = np.arctan2(-n[1], np.sqrt(n[0] ** 2 + n[2] ** 2))
    return np.concatenate([x_cam[0:3], [theta, phi, initial_rho]])


# --------------------------------------------------------------------- motion

def fv(xv, dt, cfg: FilterConfig):
    """constant_velocity branch of fv.m:42-47."""
    r, q, v, w = xv[0:3], xv[3:7], xv[7:10], xv[10:13]
    return np.concatenate([r + v * dt, qprod(q, v2q(w * dt)), v, w])


def dfv_by_dxv(xv, dt):
    # ∂(q⊗qwt)/∂q = R(qwt); ∂(q⊗qwt)/∂w = L(q)·dq(wΔt)/dw. (The reference's
    # dq3_by_dq2 builds the right-mult matrix despite the name.)
    q, w = xv[3:7], xv[10:13]
    F = np.eye(13)
    F[3:7, 3:7] = right_mult_matrix(v2q(w * dt))
    F[0:3, 7:10] = np.eye(3) * dt
    F[3:7, 10:13] = left_mult_matrix(q) @ dqomegadt_by_domega(w, dt)
    return F


def func_Q(xv, dt, cfg: FilterConfig):
    q, w = xv[3:7], xv[10:13]
    Pn = np.diag([(cfg.sigma_a * dt) ** 2] * 3 + [(cfg.sigma_alpha * dt) ** 2] * 3)
    G = np.zeros((13, 6))
    G[7:10, 0:3] = np.eye(3)
    G[10:13, 3:6] = np.eye(3)
    G[0:3, 0:3] = np.eye(3) * dt
    G[3:7, 3:6] = left_mult_matrix(q) @ dqomegadt_by_domega(w, dt)
    return G @ Pn @ G.T


def predict(x, P, cfg: FilterConfig):
    """predict_state_and_covariance.m:1-27 (block-sparse P update)."""
    dt = cfg.delta_t
    xv = fv(x[0:13], dt, cfg)
    x_new = np.concatenate([xv, x[13:]])
    F = dfv_by_dxv(x[0:13], dt)
    Q = func_Q(x[0:13], dt, cfg)
    n = P.shape[0]
    P_new = P.copy()
    P_new[0:13, 0:13] = F @ P[0:13, 0:13] @ F.T + Q
    if n > 13:
        P_new[0:13, 13:] = F @ P[0:13, 13:]
        P_new[13:, 0:13] = P[13:, 0:13] @ F.T
    return x_new, P_new


# --------------------------------------------------------------------- update

def ekf_update(x, P, H, R, z, h):
    """update.m:1-32: explicit inv(S), P−KSK', symmetrize, quaternion renorm."""
    if len(z) == 0:
        return x.copy(), P.copy()
    S = H @ P @ H.T + R
    K = P @ H.T @ np.linalg.inv(S)
    x_new = x + K @ (z - h)
    P_new = P - K @ S @ K.T
    P_new = 0.5 * P_new + 0.5 * P_new.T
    J = norm_jac(x_new[3:7])
    T = np.eye(P_new.shape[0])
    T[3:7, 3:7] = J
    P_new = T @ P_new @ T.T
    x_new[3:7] = x_new[3:7] / np.linalg.norm(x_new[3:7])
    return x_new, P_new


def ekf_update_iterated(x, P, h_fn, R, z, num_iters):
    """The iterated (Gauss-Newton) EKF update of Bell & Cathey (IEEE TAC
    38(2), 1993), what ekf_update_iterated.m:1-4 calls (its
    update_iterated is missing from the reference code): from the prior
    x̂ = x, num_iters re-linearizations h_fn(x_i) -> (h_i, H_i), each with
    K_i = P·H_iᵀ·(H_i·P·H_iᵀ + R)⁻¹ and
    x_{i+1} = x̂ + K_i·((z − h_i) − H_i·(x̂ − x_i)); then update.m's tail
    once, with the gain at the last iterate x_n: P − K·S·Kᵀ, symmetrized,
    the quaternion renormalized at x_n. With num_iters = 1, x is
    ekf_update's and P is not (its gain is re-linearized at x_1)."""
    if len(z) == 0:
        return x.copy(), P.copy()

    def gain(xi):
        h, H = h_fn(xi)
        S = H @ P @ H.T + R
        return h, H, S, P @ H.T @ np.linalg.inv(S)

    xi = x
    for _ in range(num_iters):
        h, H, _, K = gain(xi)
        xi = x + K @ ((z - h) - H @ (x - xi))
    _, _, S, K = gain(xi)
    P_new = P - K @ S @ K.T
    P_new = 0.5 * P_new + 0.5 * P_new.T
    J = norm_jac(xi[3:7])
    T = np.eye(P_new.shape[0])
    T[3:7, 3:7] = J
    P_new = T @ P_new @ T.T
    x_new = xi.copy()
    x_new[3:7] = x_new[3:7] / np.linalg.norm(x_new[3:7])
    return x_new, P_new


# --------------------------------------------------------- measurement models

def hi_inverse_depth(y, t_wc, R_wc, cam: CameraConfig, fov_deg=60.0):
    """hi_inverse_depth.m:1-57. Returns (uv, visible)."""
    mi = m_ray(y[3], y[4])
    hrl = R_wc.T @ ((y[0:3] - t_wc) * y[5] + mi)
    lim = np.deg2rad(fov_deg)
    ax = np.arctan2(hrl[0], hrl[2])
    ay = np.arctan2(hrl[1], hrl[2])
    if abs(ax) > lim or abs(ay) > lim:
        return np.zeros(2), False
    uv = distort(project(hrl, cam), cam)
    vis = (0 < uv[0] < cam.n_cols) and (0 < uv[1] < cam.n_rows)
    return uv, vis


def hi_cartesian(y, t_wc, R_wc, cam: CameraConfig, fov_deg=60.0):
    hrl = np.linalg.inv(R_wc) @ (y - t_wc)
    lim = np.deg2rad(fov_deg)
    if abs(np.arctan2(hrl[0], hrl[2])) > lim or abs(np.arctan2(hrl[1], hrl[2])) > lim:
        return np.zeros(2), False
    uv = distort(project(hrl, cam), cam)
    vis = (0 < uv[0] < cam.n_cols) and (0 < uv[1] < cam.n_rows)
    return uv, vis


def dhu_dhrl(hrl, cam: CameraConfig):
    f = cam.f / cam.d
    x, y, z = hrl
    return np.array([[f / z, 0, -x * f / z**2],
                     [0, f / z, -y * f / z**2]])


def Hi_inverse_depth(x_cam, y, zi, cam: CameraConfig):
    """(2,13) and (2,6) blocks of the measurement Jacobian
    (calculate_Hi_inverse_depth.m:1-165)."""
    rw, qwr = x_cam[0:3], x_cam[3:7]
    Rrw = np.linalg.inv(q2r(qwr))
    theta, phi, rho = y[3], y[4], y[5]
    mi = m_ray(theta, phi)
    hc = Rrw @ ((y[0:3] - rw) * rho + mi)
    dh_dhrl = np.linalg.inv(jacob_undistort(zi, cam)) @ dhu_dhrl(hc, cam)
    dhrl_drw = -Rrw * rho
    dhrl_dqwr = dRq_times_a_by_dq(qconj(qwr), (y[0:3] - rw) * rho + mi) @ np.diag(
        [1, -1, -1, -1])
    H_xv = np.hstack([dh_dhrl @ dhrl_drw, dh_dhrl @ dhrl_dqwr, np.zeros((2, 6))])
    dmi_dtheta = Rrw @ np.array([np.cos(phi) * np.cos(theta), 0,
                                 -np.cos(phi) * np.sin(theta)])
    dmi_dphi = Rrw @ np.array([-np.sin(phi) * np.sin(theta), -np.cos(phi),
                               -np.sin(phi) * np.cos(theta)])
    dhrl_dy = np.column_stack([rho * Rrw, dmi_dtheta, dmi_dphi,
                               Rrw @ (y[0:3] - rw)])
    H_y = dh_dhrl @ dhrl_dy
    return H_xv, H_y


def Hi_cartesian(x_cam, y, zi, cam: CameraConfig):
    """calculate_Hi_cartesian.m:1-115; dhrl_dy = R_cw."""
    rw, qwr = x_cam[0:3], x_cam[3:7]
    Rrw = np.linalg.inv(q2r(qwr))
    hc = Rrw @ (y - rw)
    dh_dhrl = np.linalg.inv(jacob_undistort(zi, cam)) @ dhu_dhrl(hc, cam)
    dhrl_drw = -Rrw
    dhrl_dqwr = dRq_times_a_by_dq(qconj(qwr), y - rw) @ np.diag([1, -1, -1, -1])
    H_xv = np.hstack([dh_dhrl @ dhrl_drw, dh_dhrl @ dhrl_dqwr, np.zeros((2, 6))])
    H_y = dh_dhrl @ Rrw
    return H_xv, H_y


def h_and_jacobian(x, y, cartesian: bool, cam: CameraConfig):
    """A feature's measurement at state x, without the view gates, and its
    Jacobian blocks (h (2,), H_xv (2,13), H_y (2, len(y))): the point
    R_wcᵀ·((y − t)·ρ + m) (or R_wcᵀ·(y − t)) projected and distorted, as
    hi_inverse_depth.m computes it, and calculate_Hi_*.m's blocks with the
    quaternion columns divided by |q|⁴. Those blocks differentiate
    inv(q2r(q)) = q2r(q)ᵀ/|q|⁴, a scale the projection does not see, by
    the derivative of q2r(q)ᵀ, so at |q| != 1 (the iterates of
    ekf_update_iterated) their quaternion columns are |q|⁴ times the
    derivative of h; at a unit q they are unchanged."""
    R_wc = q2r(x[3:7])
    if cartesian:
        hrl, Hi = R_wc.T @ (y - x[0:3]), Hi_cartesian
    else:
        hrl = R_wc.T @ ((y[0:3] - x[0:3]) * y[5] + m_ray(y[3], y[4]))
        Hi = Hi_inverse_depth
    h = distort(project(hrl, cam), cam)
    H_xv, H_y = Hi(x[0:13], y, h, cam)
    H_xv[:, 3:7] = H_xv[:, 3:7] / np.sum(x[3:7] ** 2) ** 2
    return h, H_xv, H_y


# ------------------------------------------------------------ feature algebra

def add_feature_covariance_inverse_depth(P, uvd, x_cam, std_pxl, std_rho,
                                         cam: CameraConfig):
    """add_a_feature_covariance_inverse_depth.m:1-64."""
    fku = cam.f / cam.d
    q_wc = x_cam[3:7]
    R_wc = q2r(q_wc)
    uvu = undistort(uvd, cam)
    XYZ_c = np.array([-(cam.cx - uvu[0]) / fku, -(cam.cy - uvu[1]) / fku, 1.0])
    XYZ_w = R_wc @ XYZ_c
    Xw, Yw, Zw = XYZ_w
    dtheta_dgw = np.array([Zw / (Xw**2 + Zw**2), 0, -Xw / (Xw**2 + Zw**2)])
    r2 = Xw**2 + Yw**2 + Zw**2
    sxz = np.sqrt(Xw**2 + Zw**2)
    dphi_dgw = np.array([Xw * Yw / (r2 * sxz), -sxz / r2, Zw * Yw / (r2 * sxz)])
    dgw_dqwr = dRq_times_a_by_dq(q_wc, XYZ_c)
    dy_dqwr = np.vstack([np.zeros((3, 4)), dtheta_dgw @ dgw_dqwr,
                         dphi_dgw @ dgw_dqwr, np.zeros((1, 4))])
    dy_drw = np.vstack([np.eye(3), np.zeros((3, 3))])
    dy_dxv = np.hstack([dy_drw, dy_dqwr, np.zeros((6, 6))])
    dyprima_dgw = np.vstack([np.zeros((3, 3)), dtheta_dgw, dphi_dgw])
    dgc_dhu = np.array([[1 / fku, 0], [0, 1 / fku], [0, 0]])
    dhu_dhd = jacob_undistort(uvd, cam)
    dyprima_dhd = dyprima_dgw @ R_wc @ dgc_dhu @ dhu_dhd
    dy_dhd = np.block([[dyprima_dhd, np.zeros((5, 1))], [np.zeros((1, 2)), 1.0]])
    Padd = np.diag([std_pxl**2, std_pxl**2, std_rho**2])
    n = P.shape[0]
    out = np.zeros((n + 6, n + 6))
    out[:n, :n] = P
    cross = np.hstack([P[:, 0:13] @ dy_dxv.T])
    out[:n, n:] = cross
    out[n:, :n] = cross.T
    out[n:, n:] = dy_dxv @ P[0:13, 0:13] @ dy_dxv.T + dy_dhd @ Padd @ dy_dhd.T
    return out


def inversedepth_to_cartesian_point(y):
    return y[0:3] + m_ray(y[3], y[4]) / y[5]


def id2cartesian_jacobian(y):
    theta, phi, rho = y[3], y[4], y[5]
    mi = m_ray(theta, phi)
    dm_dth = np.array([np.cos(phi) * np.cos(theta), 0, -np.cos(phi) * np.sin(theta)])
    dm_dph = np.array([-np.sin(phi) * np.sin(theta), -np.cos(phi),
                       -np.sin(phi) * np.cos(theta)])
    return np.column_stack([np.eye(3), dm_dth / rho, dm_dph / rho, -mi / rho**2])


def initialize_x_and_p(cfg: FilterConfig):
    """initialize_x_and_p.m:1-24."""
    x = np.array([0, 0, 0, 1, 0, 0, 0] + [cfg.v_0] * 3 + [cfg.w_0] * 3,
                 np.float64)
    P = np.diag([cfg.eps_pose] * 7 + [cfg.std_v_0**2] * 3 + [cfg.std_w_0**2] * 3)
    return x, P
