"""Visualization reproducing the reference's overlay semantics (plots.m).

Color code (plots.m:13,26-50):
  thick red    — low-innovation inliers (RANSAC consensus)
  thin red     — high-innovation rescued inliers
  magenta      — individually compatible but RANSAC-rejected
  blue         — predicted but unmatched
95% ellipses are the chi^2(2)-scaled innovation covariances; the 3D view
shows the trajectory polyline, landmark estimates, and per-landmark
uncertainty ellipsoids (plots.m:73-116 / plotUncertainEllip3D.m).

Matplotlib is an optional dependency: importing this module works without
it; calling the plot functions raises a clear error if absent.

The PyTorch port's copy of ``ekf_slam_tpu/viz/plots.py`` (numpy only),
reading the port's ``io.poses``.
"""

from __future__ import annotations

import numpy as np

CHI2_2_95 = 5.9915   # matching.m:2
CHI2_3_95 = 7.8147


def _mpl():
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        return plt
    except ImportError as e:  # pragma: no cover
        raise ImportError("matplotlib is required for viz") from e


def uncertainty_ellipse_points(S: np.ndarray, center: np.ndarray,
                               chi2: float = CHI2_2_95, n: int = 32):
    """Cholesky-mapped unit circle at the chi^2 radius
    (plotUncertainEllip2D.m:1-20); falls back to the symmetrized matrix if
    not PD (the reference prints a warning and skips)."""
    S = 0.5 * (S + S.T)
    try:
        L = np.linalg.cholesky(S)
    except np.linalg.LinAlgError:
        w, V = np.linalg.eigh(S)
        L = V @ np.diag(np.sqrt(np.maximum(w, 0.0)))
    t = np.linspace(0, 2 * np.pi, n)
    circle = np.stack([np.cos(t), np.sin(t)])
    return center[:, None] + np.sqrt(chi2) * (L @ circle)


def plot_frame(ax_or_path, image, h_pred, S, visible, ic, li, hi,
               z=None, patches=None):
    """Image overlay with the plots.m color code. `image` may be None
    (ellipses only). Saves to path if a str is given.

    Optional plots.m:22-50 extras: `z` (CAP, 2) draws a green '+' at the
    actual measurement of every individually-compatible feature
    (plots.m:48-50); `patches` (CAP, t, t) blits each matched template at
    h - half_patch, the imagesc of patch_when_matching (plots.m:22-23)."""
    plt = _mpl()
    own = isinstance(ax_or_path, str)
    if own:
        fig, ax = plt.subplots(figsize=(6, 4.5))
    else:
        ax = ax_or_path
    if image is not None:
        ax.imshow(np.asarray(image), cmap="gray", vmin=0, vmax=1)
    h_pred = np.asarray(h_pred)
    S = np.asarray(S)
    if patches is not None:
        patches = np.asarray(patches)
        half = patches.shape[-1] // 2
        for i in np.nonzero(np.asarray(visible))[0]:
            u, v = h_pred[i]
            ax.imshow(patches[i], cmap="gray", vmin=0, vmax=1,
                      extent=(u - half, u + half, v + half, v - half))
    groups = [
        (np.asarray(visible) & ~np.asarray(ic), "tab:blue", 0.8, "unmatched"),
        (np.asarray(ic) & ~np.asarray(li) & ~np.asarray(hi), "magenta", 0.8,
         "IC, RANSAC-rejected"),
        (np.asarray(hi), "red", 0.8, "HI inlier"),
        (np.asarray(li), "red", 2.0, "LI inlier"),
    ]
    for mask, color, lw, label in groups:
        first = True
        for i in np.nonzero(mask)[0]:
            pts = uncertainty_ellipse_points(S[i], h_pred[i])
            ax.plot(pts[0], pts[1], color=color, lw=lw,
                    label=label if first else None)
            ax.plot(h_pred[i, 0], h_pred[i, 1], marker="+", ms=6,
                    color=color, ls="none")
            first = False
    if z is not None:
        zz = np.asarray(z)
        icm = np.nonzero(np.asarray(ic))[0]
        if icm.size:
            ax.plot(zz[icm, 0], zz[icm, 1], "g+", ms=8, ls="none",
                    label="measurement")
    ax.legend(loc="upper right", fontsize=6)
    ax.set_title("thick red: LI / thin red: HI / magenta: rejected / "
                 "blue: unmatched", fontsize=7)
    if own:
        fig.savefig(ax_or_path, dpi=110)
        plt.close(fig)


def chi2_shell_samples(dim: int = 6, n: int = 1000, seed: int = 0,
                       chi2=None) -> np.ndarray:
    """Random points on the chi^2 95% shell of a `dim`-dim unit Gaussian —
    generate_random_6D_sphere.m:1-14 (1000 points scaled to the
    chi^2_95(6) = 12.5916 radius), used by plotUncertainSurfaceXZ.m."""
    chi2 = {2: CHI2_2_95, 3: CHI2_3_95, 6: 12.5916}.get(dim, chi2) \
        if chi2 is None else chi2
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, dim))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v * np.sqrt(chi2)


def _convex_hull_2d(pts: np.ndarray) -> np.ndarray:
    """Indices of the convex hull of (N, 2) points, counter-clockwise
    (Andrew monotone chain — no scipy dependency)."""
    order = np.lexsort((pts[:, 1], pts[:, 0]))
    pts_s = pts[order]

    def half(idx):
        out = []
        for i in idx:
            while len(out) >= 2:
                o, a = pts_s[out[-2]], pts_s[out[-1]]
                if (a[0] - o[0]) * (pts_s[i][1] - o[1]) - \
                   (a[1] - o[1]) * (pts_s[i][0] - o[0]) <= 0:
                    out.pop()
                else:
                    break
            out.append(i)
        return out

    lower = half(range(len(pts_s)))
    upper = half(range(len(pts_s) - 1, -1, -1))
    return order[np.array(lower[:-1] + upper[:-1], dtype=np.int64)]


def uncertain_surface_xz_hull(C6: np.ndarray, y6: np.ndarray,
                              n: int = 1000, seed: int = 0):
    """XZ-plane convex hull of an inverse-depth feature's 95% uncertainty
    region (plotUncertainSurfaceXZ.m:1-30): sample the chi^2_95(6) shell,
    map through chol(C6) around y6 = (x, y, z, theta, phi, rho), keep
    rho > 0 samples (>10 required, like the reference), convert to
    cartesian p = xyz + m(theta, phi)/rho, and hull the (x, z) projection.
    Returns (K, 2) closed hull polygon or None if too few rho>0 samples."""
    C = 0.5 * (np.asarray(C6, np.float64) + np.asarray(C6, np.float64).T)
    y6 = np.asarray(y6, np.float64)
    try:
        L = np.linalg.cholesky(C)
    except np.linalg.LinAlgError:
        w, V = np.linalg.eigh(C)
        L = V @ np.diag(np.sqrt(np.maximum(w, 0.0)))
    pts = chi2_shell_samples(6, n, seed) @ L.T + y6      # (n, 6)
    pts = pts[pts[:, 5] > 0]
    if pts.shape[0] <= 10:
        return None
    theta, phi, rho = pts[:, 3], pts[:, 4], pts[:, 5]
    m = np.stack([np.cos(phi) * np.sin(theta), -np.sin(phi),
                  np.cos(phi) * np.cos(theta)], axis=-1)
    cart = pts[:, 0:3] + m / rho[:, None]
    xz = cart[:, [0, 2]]
    hull = _convex_hull_2d(xz)
    return xz[np.concatenate([hull, hull[:1]])]


def plot_uncertain_surface_xz(ax, C6, y6, color="b", n: int = 1000,
                              seed: int = 0):
    """Draw the XZ uncertainty hull at y=0 on a 3D axis
    (plotUncertainSurfaceXZ.m's plot3 of the hull)."""
    poly = uncertain_surface_xz_hull(C6, y6, n, seed)
    if poly is None:
        return False
    ax.plot(poly[:, 0], np.zeros(len(poly)), poly[:, 1], color=color,
            lw=1.5)
    return True


def draw_camera(ax, r, R, scale=0.1, color="k"):
    """Camera frustum glyph at pose (r, R) — the reference's missing
    draw_camera (plots.m:73, SURVEY.md §2.9)."""
    corners = np.array([[-1, -1, 2.0], [1, -1, 2.0], [1, 1, 2.0],
                        [-1, 1, 2.0]]) * scale
    pts = (np.asarray(R) @ corners.T).T + np.asarray(r)
    order = [0, 1, 2, 3, 0]
    ax.plot(pts[order, 0], pts[order, 1], pts[order, 2], color=color, lw=0.8)
    for p in pts:
        ax.plot([r[0], p[0]], [r[1], p[1]], [r[2], p[2]], color=color,
                lw=0.6)


def plot_map_3d(path, traj, landmarks, landmark_cov=None, active=None,
                truth_traj=None, camera_R=None):
    """3D trajectory + landmark map (plots.m:73-116)."""
    plt = _mpl()
    fig = plt.figure(figsize=(6, 5))
    ax = fig.add_subplot(projection="3d")
    traj = np.asarray(traj)
    ax.plot(traj[:, 0], traj[:, 1], traj[:, 2], "k-", lw=1.5,
            label="estimate")
    if camera_R is not None:
        draw_camera(ax, traj[-1, 0:3], camera_R)
    if truth_traj is not None:
        t = np.asarray(truth_traj)
        ax.plot(t[:, 0], t[:, 1], t[:, 2], "g--", lw=1.0, label="truth")
    lm = np.asarray(landmarks)
    if active is not None:
        lm = lm[np.asarray(active)]
    ax.scatter(lm[:, 0], lm[:, 1], lm[:, 2], s=6, c="tab:red",
               label="landmarks")
    if landmark_cov is not None:
        for i, C in enumerate(np.asarray(landmark_cov)):
            if active is not None and not np.asarray(active)[i]:
                continue
            w, V = np.linalg.eigh(0.5 * (C + C.T))
            r = np.sqrt(np.maximum(w, 0.0) * CHI2_3_95)
            u = np.linspace(0, 2 * np.pi, 12)
            v = np.linspace(0, np.pi, 8)
            sph = np.stack([np.outer(np.cos(u), np.sin(v)),
                            np.outer(np.sin(u), np.sin(v)),
                            np.outer(np.ones_like(u), np.cos(v))])
            pts = np.einsum("ij,j...->i...", V * r, sph)
            ax.plot_wireframe(pts[0] + lm[i, 0], pts[1] + lm[i, 1],
                              pts[2] + lm[i, 2], color="tab:red",
                              lw=0.3, alpha=0.4)
    ax.legend(fontsize=7)
    fig.savefig(path, dpi=110)
    plt.close(fig)


def load_loop_artifacts(traj_path: str, loops_path: str):
    """Parse the two close_loops.py text artifacts.

    kitti_traj.txt: KITTI 12-float rows -> (T, 3) positions.
    kitti_loops.txt: `i j pose_i(7) pose_j(7)` rows (this framework's
    richer format — the reference stores only the two (x, z) endpoint
    positions, close_kitti_loops.py:144-150) -> (L,) i, (L,) j,
    (L, 3) r_i, (L, 3) r_j. Returns (traj_xyz, i, j, r_i, r_j); the
    loops arrays are empty when no loops were declared.
    """
    from ekf_slam_tpu_torch.io.poses import load_kitti_poses, load_loops
    traj = load_kitti_poses(traj_path)[:, :, 3]
    i, j, pi, pj = load_loops(loops_path)
    return traj, i, j, pi[:, 0:3], pj[:, 0:3]


def plot_loops(path, traj_path: str, loops_path: str):
    """The plot_loops.m analog (plot_loops.m:17-27): the trajectory's
    ground-plane track (x, z) drawn as a blue 3D polyline with frame id
    on the vertical axis, plus a thick red chord for every declared loop
    connecting the two endpoint poses at their frame ids. The reference
    recovers each chord's frame ids by nearest-trajectory-point search
    (plot_loops.m:23-24) because its loops file stores only positions;
    close_loops.py stores the ids directly, so no search is needed.
    KITTI camera convention: x right, z forward — the ground plane is
    (x, z), same columns close_kitti_loops.py:84-86 uses."""
    plt = _mpl()
    traj, li, lj, ri, rj = load_loop_artifacts(traj_path, loops_path)
    ids = np.arange(traj.shape[0])
    fig = plt.figure(figsize=(6, 5))
    ax = fig.add_subplot(projection="3d")
    ax.plot(traj[:, 0], traj[:, 2], ids, "b-", lw=2, label="trajectory")
    for k in range(li.shape[0]):
        ax.plot([ri[k, 0], rj[k, 0]], [ri[k, 2], rj[k, 2]],
                [li[k], lj[k]], "r-", lw=2,
                label="loop" if k == 0 else None)
    ax.set_xlabel("x (m)")
    ax.set_ylabel("z (m)")
    ax.set_zlabel("Frame ID")
    ax.legend(fontsize=7)
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return li.shape[0]
