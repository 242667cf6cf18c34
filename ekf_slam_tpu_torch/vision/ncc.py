"""Normalized cross-correlation template matching over a gated window.

Port of ``ekf_slam_tpu/vision/ncc.py`` (crosscorr.m's zero-mean NCC and
matching.m's χ²-gated search) on one form: each feature's static
(2R+1)² search window is cut from the shared frame by index arithmetic,
and the correlation numerator and the per-offset patch norms of ALL
features of ALL instances are one launch of K7's norms form
(``kernels.ncc_corr_norms``: direct box sums on the card, integral images
in its plain version). Positions outside the χ² ellipse are masked before
the argmax.

Beside the search: ``ncc_scores``, the one-feature scorer of a window
and its template, and crosscorr.m's scalar ``crosscorr`` and its
rotation-invariant SVD variant ``crosscorr_svd``, which the frame does not
call. The JAX package's other numerator lowerings (EKF_NCC), their
precision knob (EKF_NCC_PREC: the port computes in true f32, or in f64 on
f64 inputs) and the full-image form ``ncc_scores_plane`` compute the same
scores (ncc.py:338-346: "Output is identical across forms").
"""

from __future__ import annotations

import torch

from ekf_slam_tpu_torch.filter.association import mahalanobis2
from ekf_slam_tpu_torch.ops import kernels


# Roundoff units (eps times the window's centered energy Σwc²) below
# which a patch variance counts as 0: above the largest stray of the f32
# variance from its f64 value over real windows, which chip_smoke.py
# measures on the card (`flat_stray`, failing at FLAT_EPS) and PERF.md
# records.
FLAT_EPS = 16


def cut(plane: torch.Tensor, v0: torch.Tensor, u0: torch.Tensor,
        size: int) -> torch.Tensor:
    """(..., size, size) blocks of plane (..., H, W)'s last two axes at
    top-left anchors (v0, u0) (N,), which must lie inside:
    -> (N, ..., size, size), one gather."""
    k = torch.arange(size, device=plane.device)
    rows = (v0[:, None] + k).long()[:, :, None]                 # (N, size, 1)
    cols = (u0[:, None] + k).long()[:, None, :]                 # (N, 1, size)
    return plane[..., rows, cols].movedim(-3, 0)


def extract_patch(img: torch.Tensor, center_uv: torch.Tensor,
                  half: int) -> torch.Tensor:
    """(..., 2h+1, 2h+1) patches of img (H, W) around centers (..., 2) =
    (u, v), clamped inside the image."""
    return extract_patch_anchored(img, center_uv, half)[0]


def extract_patch_anchored(img: torch.Tensor, center_uv: torch.Tensor,
                           half: int):
    """Like extract_patch, also returning the clamped top-left anchors
    (u0, v0) (...,) int32 — near the border they differ from
    round(center) − half, and any pixel coordinate derived from a patch
    must come from its anchor. Rounding is half to even (jnp.round)."""
    H, W = img.shape
    size = 2 * half + 1
    lead = center_uv.shape[:-1]
    u0 = (torch.round(center_uv[..., 0]).to(torch.int32) - half).clamp(
        0, W - size)
    v0 = (torch.round(center_uv[..., 1]).to(torch.int32) - half).clamp(
        0, H - size)
    patches = cut(img, v0.reshape(-1), u0.reshape(-1), size)
    return patches.reshape(*lead, size, size), u0, v0


def patch_variance(windows: torch.Tensor, t: int):
    """Per-offset t×t patch variance (times t²) of windows (N, W2, W2),
    from integral images of the windows less their means, clamped at 0 ->
    (N, R2, R2); and each window's centered energy Σwc² (N,): the norms of
    K7's plain version (kernels.patch_variance_plain)."""
    return kernels.patch_variance_plain(windows, t)


def ncc_scores_all(windows: torch.Tensor,
                   templates: torch.Tensor) -> torch.Tensor:
    """Zero-mean NCC of templates (N, t, t) against every offset of their
    windows (N, W2, W2) -> (N, R2, R2), R2 = W2 − t + 1, in [-1, 1]
    (crosscorr.m:14-27). The numerator needs no patch means (Σ tm = 0);
    it and the norms are one K7 launch for all N pairs.

    Two departures from the JAX function, both exact in exact arithmetic:
    the norms' box sums run on windows less their means (the same
    variance; in f32 the raw integral images' cancellation moved NCC
    argmaxes off their f64 positions where the centered ones did not), and
    an offset whose patch variance lies within the box sums' rounding of 0
    — below FLAT_EPS units of roundoff of the window's centered energy
    Σw² — scores 0. Its NCC is 0/0: in f32 the template's
    rounding residue Σtm ≠ 0 over sqrt(1e-12) scored such flat background
    patches up to 38.9 in the JAX function and here alike, winning the
    argmax by rounding, differently on the card and the CPU. At f64 the
    floor is ~1e-15 of the window's energy and leaves every score as it
    was."""
    tm = templates - templates.mean(dim=(-2, -1), keepdim=True)
    tnorm = torch.sqrt((tm * tm).sum(dim=(-2, -1)) + 1e-12)    # (N,)
    corr, var, energy = kernels.ncc_corr_norms(windows, tm)
    floor = (FLAT_EPS * torch.finfo(windows.dtype).eps
             * energy)[:, None, None]
    scores = corr / (torch.sqrt(var + 1e-12) * tnorm[:, None, None])
    return torch.where(var > floor, scores, torch.zeros_like(scores))


def ncc_scores(window: torch.Tensor, template: torch.Tensor) -> torch.Tensor:
    """Zero-mean NCC of one template (t, t) against every offset of its
    window (t+2R, t+2R) -> (2R+1, 2R+1) scores in [-1, 1]
    (crosscorr.m:14-27): ncc_scores_all on a batch of one."""
    return ncc_scores_all(window[None], template[None])[0]


def _safe_ratio(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num / den, 0 where den is 0 (the reference's (den ~= 0) guard)."""
    ok = den > 0
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)),
                       torch.zeros_like(den))


def crosscorr(a: torch.Tensor, b: torch.Tensor,
              svd: bool = False) -> torch.Tensor:
    """Scalar zero-mean NCC of equal-size patches a, b (..., h, w) -> (...)
    (crosscorr.m:14-27), population normalization; with svd=True the
    rotation-invariant variant (crosscorr.m's third-argument mode)."""
    if svd:
        return crosscorr_svd(a, b)
    am = a - a.mean(dim=(-2, -1), keepdim=True)
    bm = b - b.mean(dim=(-2, -1), keepdim=True)
    num = (am * bm).sum(dim=(-2, -1))
    den = torch.sqrt((am * am).sum(dim=(-2, -1))
                     * (bm * bm).sum(dim=(-2, -1)))
    return _safe_ratio(num, den)


def crosscorr_svd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Rotation-invariant patch similarity (crosscorrsvd, crosscorr.m:29-42):
    the population correlation coefficient of the two patches' singular
    values, which an in-plane rotation or reflection leaves unchanged.
    a, b (..., h, w) -> (...); 0 where a spectrum is constant."""
    d1, d2 = torch.linalg.svdvals(a), torch.linalg.svdvals(b)
    d1m = d1 - d1.mean(dim=-1, keepdim=True)
    d2m = d2 - d2.mean(dim=-1, keepdim=True)
    num = (d1m * d2m).mean(dim=-1)
    den = torch.sqrt((d1m * d1m).mean(dim=-1) * (d2m * d2m).mean(dim=-1))
    return _safe_ratio(num, den)


def _select_candidate(scores: torch.Tensor, u0: torch.Tensor,
                      v0: torch.Tensor, h_pred: torch.Tensor,
                      S: torch.Tensor, half_t: int, chi2_gate: float,
                      min_ncc: float):
    """χ²-gated argmax over each feature's (R2, R2) score window: scores
    (N, R2, R2), anchors u0, v0 (N,), h_pred (N, 2), S (N, 2, 2). Offset
    (bx, by) puts the template center at (u0+half_t+bx, v0+half_t+by), the
    innovation of the gate is measured from there. Returns (z (N, 2),
    score (N,), found (N,)); the first maximum wins ties."""
    N, R2 = scores.shape[0], scores.shape[-1]
    dtype = scores.dtype
    k = torch.arange(R2, dtype=dtype, device=scores.device)
    cu = u0.to(dtype)[:, None] + half_t + k                    # (N, R2)
    cv = v0.to(dtype)[:, None] + half_t + k
    du = (cu - h_pred[:, 0:1])[:, None, :].expand(N, R2, R2)   # [n, y, x]
    dv = (cv - h_pred[:, 1:2])[:, :, None].expand(N, R2, R2)
    nu = torch.stack([du, dv], dim=-1)
    gate = mahalanobis2(nu, S[:, None, None]) < chi2_gate
    masked = torch.where(gate, scores, torch.full_like(scores, -torch.inf))
    best = torch.argmax(masked.reshape(N, -1), dim=1)
    by, bx = best // R2, best % R2
    score = masked.reshape(N, -1).gather(1, best[:, None])[:, 0]
    z = torch.stack([cu.gather(1, bx[:, None])[:, 0],
                     cv.gather(1, by[:, None])[:, 0]], dim=-1)
    found = torch.isfinite(score) & (score > min_ncc)
    return z, torch.where(torch.isfinite(score), score,
                          torch.full_like(score, -1.0)), found


def match_feature(img: torch.Tensor, templates: torch.Tensor,
                  h_pred: torch.Tensor, S: torch.Tensor, chi2_gate: float,
                  search_radius: int, min_ncc: float):
    """The NCC search of every feature (matching.m re-design) in one pass:
    img (H, W) in [0, 1], shared; templates (..., t, t) predicted
    appearances; h_pred (..., 2) predicted pixels; S (..., 2, 2)
    innovation covariances. Returns (z (..., 2), score (...), found (...))."""
    t = templates.shape[-1]
    lead = h_pred.shape[:-1]
    win, u0, v0 = extract_patch_anchored(img, h_pred, search_radius + t // 2)
    scores = ncc_scores_all(win.reshape(-1, *win.shape[-2:]),
                            templates.reshape(-1, t, t))
    z, score, found = _select_candidate(
        scores, u0.reshape(-1), v0.reshape(-1), h_pred.reshape(-1, 2),
        S.reshape(-1, 2, 2), t // 2, chi2_gate, min_ncc)
    return z.reshape(*lead, 2), score.reshape(lead), found.reshape(lead)


def match_all(img: torch.Tensor, templates: torch.Tensor,
              h_pred: torch.Tensor, S: torch.Tensor, visible: torch.Tensor,
              chi2_gate: float, search_radius: int, min_ncc: float):
    """All-feature NCC search, templates (B, CAP, t, t), h_pred
    (B, CAP, 2), S (B, CAP, 2, 2), visible (B, CAP): one K7 launch for the
    batch. Returns (z (B, CAP, 2), score, found & visible)."""
    z, score, found = match_feature(img, templates, h_pred, S, chi2_gate,
                                    search_radius, min_ncc)
    return z, score, found & visible
