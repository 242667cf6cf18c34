"""Patch appearance prediction via plane-induced homography, batched.

Port of ``ekf_slam_tpu/vision/patch_warp.py`` (predict_features_appearance.m,
pred_patch_fc.m): a feature's stored 41x41 init patch is warped into the
current view by the homography H = K (R − t nᵀ / d) K⁻¹ that a
fronto-parallel plane at the feature induces between the init camera and
the current camera, and sampled bilinearly into the 13x13 matching
template. Every function takes any leading batch axes. Lens distortion
takes one of three forms (``predict_appearance``'s ``distortion``):

* "affine" (the default): anchor-exact first-order distortion maps folded
  into the 3x3 (``distortion_corrected_hinv``), one projective map a slot;
* "exact": the reference's per-pixel round trip
  (rotate_with_dist_fc_c1c2.m:12-17, ``warp_patch_distorted``): every
  template pixel undistorted, mapped through H⁻¹ and re-distorted by the
  Newton iterations, all B·CAP·169 points at once;
* "none": H applied to raw pixels (``warp_patch``).

The JAX package's one-hot matmul sampling (EKF_WARP_SAMPLE=dot) and its
``jnp.linalg.inv`` form (EKF_WARP_INV=linalg) are TPU lowerings of the same
algebra, written here once in plain torch (``_bilinear``, ``inv3``).
"""

from __future__ import annotations

import torch

from ekf_slam_tpu_torch.config import CameraConfig
from ekf_slam_tpu_torch.ops import camera as cam_ops
from ekf_slam_tpu_torch.ops import quaternion as quat
from ekf_slam_tpu_torch.ops.consts import constant


def inv3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 inverse (adjugate / determinant), batched over
    leading axes."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d  # noqa: E741
    det = a * A + b * D + c * G
    adj = torch.stack([torch.stack([A, B, C], -1),
                       torch.stack([D, E, F], -1),
                       torch.stack([G, H, I], -1)], -2)
    return adj / det[..., None, None]


def camera_matrix(cam: CameraConfig, dtype: torch.dtype,
                  device) -> torch.Tensor:
    fku = cam.f / cam.d
    return constant(((fku, 0.0, cam.cx), (0.0, fku, cam.cy), (0.0, 0.0, 1.0)),
                    dtype, device)


def camera_matrix_inv(cam: CameraConfig, dtype: torch.dtype,
                      device) -> torch.Tensor:
    fku = cam.f / cam.d
    return constant(((1.0 / fku, 0.0, -cam.cx / fku),
                     (0.0, 1.0 / fku, -cam.cy / fku),
                     (0.0, 0.0, 1.0)), dtype, device)


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., i, j) · (..., j) -> (..., i)."""
    return (M @ v[..., None])[..., 0]


def plane_homography(r1, q1, r2, q2, p_w, cam: CameraConfig) -> torch.Tensor:
    """Homography mapping pixels of camera 1 (init pose r1, q1) to camera 2
    (current pose r2, q2) for the plane through world point p_w whose
    normal is the init viewing ray (pred_patch_fc.m:20-38). Inputs
    broadcast over leading axes; returns (..., 3, 3)."""
    K = camera_matrix(cam, p_w.dtype, p_w.device)
    R1 = quat.q2r(q1)                       # world <- cam1
    R2t = quat.q2r(q2).transpose(-1, -2)
    R = R2t @ R1                            # cam2 <- cam1
    t = _mv(R2t, r1 - r2)
    p1 = _mv(R1.transpose(-1, -2), p_w - r1)    # the point in cam1
    d1 = torch.linalg.vector_norm(p1, dim=-1, keepdim=True)
    d_safe = torch.where(d1 == 0, torch.ones_like(d1), d1)
    n1 = p1 / d_safe
    H_metric = R + t[..., :, None] * n1[..., None, :] / d_safe[..., None]
    return K @ H_metric @ camera_matrix_inv(cam, p_w.dtype, p_w.device)


def _grid(center_dst: torch.Tensor, out_size: int):
    """The destination pixels (u, v) of an (out, out) patch centered at
    center_dst (..., 2), row-major: two (..., K) tensors."""
    o = out_size // 2
    d = torch.arange(-o, o + 1, dtype=center_dst.dtype,
                     device=center_dst.device)
    gy, gx = torch.meshgrid(d, d, indexing="ij")
    return (gx.reshape(-1) + center_dst[..., 0, None],
            gy.reshape(-1) + center_dst[..., 1, None])


def _sample(patch: torch.Tensor, su: torch.Tensor, sv: torch.Tensor,
            center_src, out_size: int) -> torch.Tensor:
    """Bilinear samples of patch (..., P, P), centered at pixel center_src
    (..., 2), at source-image pixels (su, sv) (..., K) -> (..., out, out)."""
    P = patch.shape[-1]
    su = su - center_src[..., 0, None] + P // 2
    sv = sv - center_src[..., 1, None] + P // 2
    return _bilinear(patch, su, sv).reshape(*su.shape[:-1], out_size,
                                            out_size)


def warp_patch(patch: torch.Tensor, H: torch.Tensor, center_src,
               center_dst, out_size: int) -> torch.Tensor:
    """Warp patch (..., P, P), centered at pixel center_src (..., 2) of the
    source image, through H (..., 3, 3) applied to raw pixels: the
    (..., out, out) patch centered at center_dst, sampled by the inverse
    map dst -> src (pred_patch_fc.m's meshgrid + interp2)."""
    return warp_patch_inv(patch, inv3(H), center_src, center_dst, out_size)


def warp_patch_inv(patch: torch.Tensor, Hinv: torch.Tensor, center_src,
                   center_dst, out_size: int) -> torch.Tensor:
    """Sample the (out, out) destination patch centered at pixel
    center_dst (..., 2) = (u, v) from the source patch (..., P, P) centered
    at center_src, through the dst->src homography Hinv (..., 3, 3)."""
    du, dv = _grid(center_dst.to(patch.dtype), out_size)      # (..., K)
    pts = torch.stack([du, dv, torch.ones_like(du)], dim=-2)  # (..., 3, K)
    src = Hinv @ pts
    return _sample(patch, src[..., 0, :] / src[..., 2, :],
                   src[..., 1, :] / src[..., 2, :], center_src, out_size)


def warp_patch_distorted(patch: torch.Tensor, H: torch.Tensor, center_src,
                         center_dst, out_size: int,
                         cam: CameraConfig) -> torch.Tensor:
    """warp_patch with the reference's per-pixel distortion round trip
    (rotate_with_dist_fc_c1c2.m:12-17): each destination pixel (distorted
    image coordinates) is undistorted, mapped through the inverse
    undistorted-space homography H⁻¹, then re-distorted by the Newton
    iterations into source image coordinates before the bilinear sample.
    The (out, out) grid is one axis of every elementwise pass, beside the
    leading batch axes."""
    du, dv = _grid(center_dst.to(patch.dtype), out_size)
    dst_u = cam_ops.undistort(torch.stack([du, dv], dim=-1), cam)  # (...,K,2)
    pts = torch.cat([dst_u, torch.ones_like(dst_u[..., :1])], dim=-1)
    src = pts @ inv3(H).transpose(-1, -2)                          # (...,K,3)
    src_d = cam_ops.distort(src[..., :2] / src[..., 2:3], cam)
    return _sample(patch, src_d[..., 0], src_d[..., 1], center_src,
                   out_size)


def _bilinear(patch: torch.Tensor, su: torch.Tensor,
              sv: torch.Tensor) -> torch.Tensor:
    """Bilinear samples (..., K) of patch (..., P, P) at (su, sv), the
    corner clamped inside the patch: rows first, (1−ty)·p[y0] + ty·p[y0+1],
    then columns, as the JAX module's Wy·patch·Wxᵀ contraction sums."""
    P = patch.shape[-1]
    x0 = torch.floor(su).long().clamp(0, P - 2)
    y0 = torch.floor(sv).long().clamp(0, P - 2)
    tx = (su - x0).clamp(0.0, 1.0)
    ty = (sv - y0).clamp(0.0, 1.0)
    flat = patch.reshape(*patch.shape[:-2], P * P)

    def at(y, x):
        return torch.gather(flat, -1, y * P + x)

    left = (1 - ty) * at(y0, x0) + ty * at(y0 + 1, x0)
    right = (1 - ty) * at(y0, x0 + 1) + ty * at(y0 + 1, x0 + 1)
    return (1 - tx) * left + tx * right


def _affine(J: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) affine map [[J, c], [0, 0, 1]] from J (..., 2, 2) and
    c (..., 2)."""
    top = torch.cat([J, c[..., None]], dim=-1)               # (..., 2, 3)
    last = torch.zeros_like(top[..., :1, :])
    last[..., 0, 2] = 1.0
    return torch.cat([top, last], dim=-2)


def distortion_corrected_homography(H: torch.Tensor, center_src,
                                    center_dst,
                                    cam: CameraConfig) -> torch.Tensor:
    """The undistorted-space homography H (..., 3, 3) composed with the
    first-order distortion maps so that it applies to distorted pixels:
    M = A_dst⁻¹ ∘ H ∘ A_src⁻¹ with distort(H · undistort(p)) ≈ M · p near
    the patch, exact at center_dst (whose anchor goes through the true
    round trip). center_src is not read: the source anchor is H⁻¹'s image
    of center_dst, as in the JAX function."""
    del center_src
    A_dst, A_src, _ = _distortion_affine_anchors(H, center_dst, cam)
    return _inv_affine(A_dst) @ H @ _inv_affine(A_src)


def distortion_corrected_hinv(H: torch.Tensor, center_dst,
                              cam: CameraConfig) -> torch.Tensor:
    """The inverse distortion-corrected map A_src ∘ H⁻¹ ∘ A_dst that
    warp_patch_inv samples through, composed in closed form."""
    A_dst, A_src, Hinv = _distortion_affine_anchors(H, center_dst, cam)
    return A_src @ Hinv @ A_dst


def _distortion_affine_anchors(H: torch.Tensor, center_dst,
                               cam: CameraConfig):
    """(A_dst, A_src, H⁻¹): A_dst maps distorted dst pixels to undistorted
    ones, exact at center_dst; A_src maps undistorted src pixels to
    distorted ones, exact at H⁻¹(center_dst)."""
    c_dst = center_dst.to(H.dtype)
    u_dst = cam_ops.undistort(c_dst, cam)                   # anchor, exact
    Ju = cam_ops.jacob_undistort(c_dst, cam)                # d undist/d dist
    A_dst = _affine(Ju, u_dst - _mv(Ju, c_dst))
    Hinv = inv3(H)
    s = _mv(Hinv, torch.cat([u_dst, torch.ones_like(u_dst[..., :1])], -1))
    s_u = s[..., :2] / s[..., 2:3]
    s_d = cam_ops.distort(s_u, cam)                         # exact anchor
    Jd = cam_ops.jacob_distort(s_d, cam)    # d dist / d undist, AT s_d
    A_src = _affine(Jd, s_d - _mv(Jd, s_u))
    return A_dst, A_src, Hinv


def _inv_affine(A: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of an affine 3x3 (last row 0 0 1)."""
    a, b = A[..., 0, 0], A[..., 0, 1]
    c, d = A[..., 1, 0], A[..., 1, 1]
    det = a * d - b * c
    inv2 = torch.stack([torch.stack([d, -b], -1),
                        torch.stack([-c, a], -1)], -2) / det[..., None, None]
    return _affine(inv2, -_mv(inv2, A[..., :2, 2]))


def predict_appearance(patches: torch.Tensor, init_pose: torch.Tensor,
                       x_cam: torch.Tensor, p_w: torch.Tensor,
                       h_init: torch.Tensor, h_now: torch.Tensor,
                       cam: CameraConfig, out_size: int = 13,
                       distortion: str = "affine") -> torch.Tensor:
    """Predicted matching templates of every slot of every instance.

    patches (B, CAP, P, P) stored init patches; init_pose (B, CAP, 7)
    [r q] at initialization; x_cam (B, 13) current camera states; p_w
    (B, CAP, 3) current landmark estimates; h_init / h_now (B, CAP, 2)
    pixels at init / predicted now. Returns (B, CAP, out, out).

    `distortion`: how rotate_with_dist_fc_c1c2.m's per-pixel round trip is
    treated — "exact" (per pixel, reference-faithful), "affine" (default:
    anchor-exact first-order correction folded into the homography, <0.1
    px from "exact"), "none" (raw pixels, up to ~16 px template shift at
    frame corners with the reference calibration)."""
    if distortion not in ("exact", "affine", "none"):
        raise ValueError(f"unknown distortion {distortion!r}")
    H = plane_homography(init_pose[..., 0:3], init_pose[..., 3:7],
                         x_cam[:, None, 0:3], x_cam[:, None, 3:7], p_w, cam)
    if distortion == "exact":
        return warp_patch_distorted(patches, H, h_init, h_now, out_size, cam)
    if distortion == "affine":
        H = distortion_corrected_hinv(H, h_now, cam)
        return warp_patch_inv(patches, H, h_init, h_now, out_size)
    return warp_patch(patches, H, h_init, h_now, out_size)
