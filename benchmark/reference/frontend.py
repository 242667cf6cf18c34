"""The reference image front-end in float64 NumPy, one filter instance.

What a frame from pixels adds to the filter loop of ``slam``: FAST-16
corners with non-maximum suppression on the shared frame, the matching
template of each feature predicted from its 41x41 init patch through the
plane-induced homography (pred_patch_fc.m) with the lens distortion folded
in to first order at the patch (the configuration's "affine" form), the
zero-mean NCC search (crosscorr.m) over the χ²-gated window around the
predicted pixel (matching.m), and new features at the strongest corners
away from the predicted ones (initialize_a_feature.m).

Ties and edges follow the program's stated rules: the first maximum wins
an argmax (row-major), a top-k keeps equal values lowest index first, a
pixel is rounded half to even, a patch's anchor is clamped inside the
image, and an offset whose patch variance is within FLAT_EPS roundoff
units of the frames' own precision (float32) of its window's centred
energy scores 0: such a patch is flat in the data, and its NCC is 0/0.
A template is flat by the same measure of itself: with t the template as
handed in and tm = t − mean(t), where Σtm² ≤ FLAT_EPS · eps_f32 · Σt²
(an RMS contrast of at most ~1.4e-3 of its RMS level: under a tenth of
one 8-bit grey level on the frames' 0.2 grey, where a FAST corner has
0.08). A flat template scores 0 at every offset and is never found: a
float32 program's score of it rests on rounding (the residue Σtm ≠ 0 of
its mean, times each patch's mean), not on the data. Where its argmax
falls then decides nothing, and its tie is not noted.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import oracle

INIT_HALF = 20          # 41x41 init patch (initialize_a_feature.m:4)
MATCH_HALF = 6          # 13x13 matching patch (initialize_a_feature.m:5)
BORDER = 21             # border of new features (initialize_a_feature.m:22)
FLAT_EPS = 16
# The appearance store's fields that the reference writes for a new
# feature: its 41x41 patch, the camera pose and its pixel at init.
STORE_FIELDS = ("patches", "init_pose", "init_px")
# 16-point Bresenham circle of radius 3, clockwise, as (dy, dx)
CIRCLE = ((-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
          (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2),
          (-3, -1))


def top_k(v: np.ndarray, k: int):
    """The k largest entries of v (1-D), ties lowest index first."""
    idx = np.argsort(-v, kind="stable")[:k]
    return v[idx], idx


def fast_score(img: np.ndarray, threshold: float, arc: int) -> np.ndarray:
    """Mean contrast margin of the qualifying circle taps where at least
    `arc` contiguous taps are all brighter than centre + threshold or all
    darker than centre − threshold, else 0; the taps wrap around the
    image and a 3-pixel border is zeroed."""
    taps = np.stack([np.roll(img, (-dy, -dx), axis=(0, 1))
                     for dy, dx in CIRCLE])
    diff = taps - img[None]
    bright, dark = diff > threshold, diff < -threshold

    def longest_run(mask):
        run = np.zeros(img.shape, np.int64)
        best = np.zeros(img.shape, np.int64)
        for k in range(32):                # twice round the circle
            run = np.where(mask[k % 16], run + 1, 0)
            best = np.maximum(best, run)
        return np.minimum(best, 16)

    corner = (longest_run(bright) >= arc) | (longest_run(dark) >= arc)
    excess = np.where(bright | dark, np.abs(diff) - threshold, 0.0)
    score = np.where(corner, excess.sum(axis=0) / 16, 0.0)
    H, W = img.shape
    score[:3], score[H - 3:], score[:, :3], score[:, W - 3:] = 0, 0, 0, 0
    return score


def non_max_suppress(score: np.ndarray) -> np.ndarray:
    """Keep the 3x3 local maxima (wrapped; plateaus all kept)."""
    neigh = score.copy()
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            neigh = np.maximum(neigh, np.roll(score, (dy, dx), axis=(0, 1)))
    return np.where(score >= neigh, score, 0.0)


def patch_anchor(center, half: int, H: int, W: int):
    """Top-left (u0, v0) of the (2h+1)² patch around center (u, v),
    rounded half to even and clamped inside the image."""
    size = 2 * half + 1
    u0 = int(np.clip(np.round(center[0]) - half, 0, W - size))
    v0 = int(np.clip(np.round(center[1]) - half, 0, H - size))
    return u0, v0


def extract_patch(img: np.ndarray, center, half: int) -> np.ndarray:
    u0, v0 = patch_anchor(center, half, *img.shape)
    size = 2 * half + 1
    return img[v0:v0 + size, u0:u0 + size].copy()


# ------------------------------------------------------- template prediction

def _camera_matrix(cam):
    fku = cam.f / cam.d
    return np.array([[fku, 0.0, cam.cx], [0.0, fku, cam.cy], [0, 0, 1.0]])


def plane_homography(r1, q1, r2, q2, p_w, cam) -> np.ndarray:
    """Pixels of the init camera (r1, q1) to the current one (r2, q2)
    through the plane at p_w facing the init ray (pred_patch_fc.m:20-38)."""
    K = _camera_matrix(cam)
    R1, R2t = oracle.q2r(q1), oracle.q2r(q2).T
    R = R2t @ R1
    t = R2t @ (r1 - r2)
    p1 = R1.T @ (p_w - r1)
    d = np.linalg.norm(p1)
    d = 1.0 if d == 0 else d
    return K @ (R + np.outer(t, p1 / d) / d) @ np.linalg.inv(K)


def _affine(J, c) -> np.ndarray:
    A = np.eye(3)
    A[:2, :2], A[:2, 2] = J, c
    return A


def corrected_hinv(H, center_dst, cam) -> np.ndarray:
    """The destination-to-source map of distorted pixels: A_src ∘ H⁻¹ ∘
    A_dst, with A_dst the first-order undistortion exact at center_dst and
    A_src the first-order distortion exact at H⁻¹'s image of it."""
    c = np.asarray(center_dst, np.float64)
    u_dst = oracle.undistort(c, cam)
    Ju = oracle.jacob_undistort(c, cam)
    A_dst = _affine(Ju, u_dst - Ju @ c)
    Hinv = np.linalg.inv(H)
    s = Hinv @ np.array([u_dst[0], u_dst[1], 1.0])
    s_u = s[:2] / s[2]
    s_d = oracle.distort(s_u, cam)
    Jd = np.linalg.inv(oracle.jacob_undistort(s_d, cam))
    A_src = _affine(Jd, s_d - Jd @ s_u)
    return A_src @ Hinv @ A_dst


def bilinear(patch: np.ndarray, su: np.ndarray, sv: np.ndarray):
    """Bilinear samples of patch at (su, sv), the corner clamped inside."""
    P = patch.shape[-1]
    x0 = np.clip(np.floor(su).astype(np.int64), 0, P - 2)
    y0 = np.clip(np.floor(sv).astype(np.int64), 0, P - 2)
    tx = np.clip(su - x0, 0.0, 1.0)
    ty = np.clip(sv - y0, 0.0, 1.0)
    left = (1 - ty) * patch[y0, x0] + ty * patch[y0 + 1, x0]
    right = (1 - ty) * patch[y0, x0 + 1] + ty * patch[y0 + 1, x0 + 1]
    return (1 - tx) * left + tx * right


def predict_template(patch, init_pose, x_cam, p_w, h_init, h_now, cam,
                     out_size: int = 2 * MATCH_HALF + 1) -> np.ndarray:
    """The (out, out) template of a feature: its init patch (41x41,
    centred at pixel h_init) seen from x_cam around pixel h_now."""
    H = plane_homography(init_pose[0:3], init_pose[3:7], x_cam[0:3],
                         x_cam[3:7], p_w, cam)
    Hinv = corrected_hinv(H, h_now, cam)
    o = out_size // 2
    d = np.arange(-o, o + 1, dtype=np.float64)
    gy, gx = np.meshgrid(d, d, indexing="ij")
    pts = np.stack([gx.ravel() + h_now[0], gy.ravel() + h_now[1],
                    np.ones(out_size * out_size)])
    src = Hinv @ pts
    P = patch.shape[-1]
    su = src[0] / src[2] - h_init[0] + P // 2
    sv = src[1] / src[2] - h_init[1] + P // 2
    return bilinear(patch, su, sv).reshape(out_size, out_size)


# ---------------------------------------------------------------- NCC search

def template_flat(template: np.ndarray):
    """Whether template is flat (module docstring), and the relative
    distance of Σtm² / Σt² from the threshold FLAT_EPS · eps_f32."""
    tm = template - template.mean()
    sum_t2, sum_tm2 = (template * template).sum(), (tm * tm).sum()
    floor = FLAT_EPS * np.finfo(np.float32).eps
    ratio = sum_tm2 / sum_t2 if sum_t2 > 0 else 0.0
    return bool(sum_tm2 <= floor * sum_t2), float(abs(ratio - floor) / floor)


def ncc_scores(win: np.ndarray, template: np.ndarray, flat: bool):
    """Zero-mean NCC of template (t, t) at every offset of win (W2, W2) ->
    (R2, R2), R2 = W2 − t + 1: 0 at an offset whose patch is flat, and
    at every offset where the template is `flat`."""
    t = template.shape[0]
    if flat:
        return np.zeros((win.shape[0] - t + 1, win.shape[1] - t + 1))
    tm = template - template.mean()
    tnorm = np.sqrt((tm * tm).sum() + 1e-12)
    patches = np.lib.stride_tricks.sliding_window_view(win, (t, t))
    corr = np.einsum("yxij,ij->yx", patches, tm)
    var = np.maximum(((patches - patches.mean(axis=(2, 3), keepdims=True))
                      ** 2).sum(axis=(2, 3)), 0.0)
    energy = ((win - win.mean()) ** 2).sum()
    scores = corr / (np.sqrt(var + 1e-12) * tnorm)
    return np.where(var > FLAT_EPS * np.finfo(np.float32).eps * energy,
                    scores, 0.0)


def ncc_match(img, template, h, S, chi2: float, radius: int,
              min_ncc: float, turn: str | None = None):
    """The best zero-mean NCC position of template in the (2R+1)² search
    around h, inside the χ² ellipse of S: (z (2,), found, the margins of
    its decisions). `turn` "ncc_tie" takes the runner-up where it lies
    within turn_limit of the best, "ncc_min" turns found where the score
    lies within turn_limit of min_ncc, "ncc_flat" turns the flat-template
    decision where Σtm² / Σt² lies within turn_limit (relative) of its
    threshold."""
    from benchmark.reference.slam import turn_limit
    t = template.shape[0]
    H, W = img.shape
    half = radius + t // 2
    u0, v0 = patch_anchor(h, half, H, W)
    size = 2 * half + 1
    R2 = size - t + 1
    flat, flat_margin = template_flat(template)
    if turn == "ncc_flat" and flat_margin < turn_limit(turn):
        flat = not flat
    scores = ncc_scores(img[v0:v0 + size, u0:u0 + size], template, flat)
    k = np.arange(R2, dtype=np.float64)
    cu, cv = u0 + t // 2 + k, v0 + t // 2 + k
    du = (cu - h[0])[None, :]                       # [by, bx]
    dv = (cv - h[1])[:, None]
    det = S[0, 0] * S[1, 1] - S[0, 1] * S[1, 0]
    det = 1.0 if det == 0 else det
    m2 = (du * (S[1, 1] * du - S[0, 1] * dv)
          + dv * (-S[1, 0] * du + S[0, 0] * dv)) / det
    masked = np.where(m2 < chi2, scores, -np.inf)
    best = int(np.argmax(masked))                   # the first maximum
    rest = np.delete(masked.ravel(), best)
    if turn == "ncc_tie" and not flat and (masked.ravel()[best] - rest.max()
                                           < turn_limit(turn)):
        second = int(np.argmax(rest))
        best, rest = second + (second >= best), np.delete(
            masked.ravel(), second + (second >= best))
    by, bx = divmod(best, R2)
    score = masked[by, bx]
    frac = np.abs(np.asarray(h) % 1.0 - 0.5)
    margins = {"ncc_tie": float(score - rest.max()) if np.isfinite(
                   rest.max()) and not flat else np.inf,
               "ncc_min": abs(float(score) - min_ncc),
               "ncc_gate": abs(float(m2[by, bx]) - chi2) / chi2,
               "anchor": float(frac.min()),
               "ncc_flat": flat_margin}
    found = bool(np.isfinite(score) and score > min_ncc)
    if turn == "ncc_min" and margins["ncc_min"] < turn_limit(turn):
        found = not found
    return np.array([cu[bx], cv[by]]), found, margins


# ------------------------------------------------------------- the sequence

def corners(img: np.ndarray, s, count: int):
    """The frame's `count` strongest suppressed FAST corners off the
    border: (yx (count, 2), response (count,)); response 0 is none."""
    v = s.vision
    score = non_max_suppress(fast_score(img, v.fast_threshold, v.fast_arc))
    H, W = img.shape
    score[:BORDER], score[H - BORDER:] = 0.0, 0.0
    score[:, :BORDER], score[:, W - BORDER:] = 0.0, 0.0
    vals, idx = top_k(score.ravel(), count)
    return np.stack([idx // W, idx % W], axis=1), vals


def image_step(s, st: dict, img: np.ndarray, found, u, turn=None):
    """One frame of one instance from padded state `st` with its
    appearance store (patches (CAP, 41, 41), init_pose (CAP, 7), init_px
    (CAP, 2)): manage, predict, the NCC search of every matchable
    feature at the prior, the filter's gates and updates, then new features
    at the frame's corners (`found`, from ``corners``) when fewer than
    min_features_in_image were matched, each storing its 41x41 patch, the
    camera pose and its pixel; `turn` a noted decision to turn. Returns the
    padded state after the frame with its camera block, gate counts, noted
    decisions and the store's new entries {slot: (patch, pose, pixel)}."""
    from benchmark.reference.slam import CAM_DIM, RefSLAM, max_eig_2x2
    m, v, cam, mc = s.map, s.vision, s.camera, s.matching
    img = np.asarray(img, np.float64)
    slam = RefSLAM.from_padded(s, st)
    slam.turn = turn

    def measure(sl, lin):
        n = len(sl.recs)
        z, zv = np.zeros((n, 2)), np.zeros(n, bool)
        for i, r in enumerate(sl.recs):
            h, vis = lin[i][0], lin[i][1]
            if not vis:
                continue
            S = sl.innovation_cov(lin, i, s.filter.sigma_z)
            if max_eig_2x2(S) >= mc.max_innovation_eig:
                continue
            tmpl = predict_template(
                np.asarray(st["patches"][r.slot], np.float64),
                np.asarray(st["init_pose"][r.slot], np.float64),
                sl.x[:CAM_DIM], sl.world_point(i),
                np.asarray(st["init_px"][r.slot], np.float64), h, cam)
            z[i], zv[i], margins = ncc_match(
                img, tmpl, h, S, mc.chi2_inv_2_95, v.search_radius,
                v.min_ncc, sl.turn[0] if sl.turn and sl.turn[1] == r.slot
                else None)
            for kind, margin in margins.items():
                sl.note(kind, r.slot, margin)
        return z, zv

    def candidates(sl, lin, n_ic):
        if n_ic >= m.min_features_in_image:
            return []
        yx, vals = found
        pred = np.array([lin[i][0] for i in range(len(sl.recs))
                         if lin[i][1]]).reshape(-1, 2)
        d2 = ((yx[:, None, 0] - pred[None, :, 1]) ** 2
              + (yx[:, None, 1] - pred[None, :, 0]) ** 2)
        clear = d2.min(axis=1, initial=np.inf) > v.exclusion_radius ** 2
        picked, order = top_k(vals * clear, m.max_new_per_step)
        deficit = m.min_features_in_image - n_ic
        return [(np.array([yx[j, 1], yx[j, 0]], np.float64), -1)
                for k, (p, j) in enumerate(zip(picked, order))
                if p > 0 and k < deficit]

    res = slam.frame(measure, candidates, u)
    added = {slot: (extract_patch(img, uv, INIT_HALF), slam.x[:7].copy(), uv)
             for slot, uv in res["added"]}
    return dict(slam.padded(), cam=slam.x[:CAM_DIM].copy(), added=added,
                near=res["near"],
                counts=(int(res["ic"].sum()), int(res["li"].sum()),
                        int(res["hi"].sum())))
