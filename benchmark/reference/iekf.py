"""The reference frame with the iterated EKF update: MonoSLAM's per-frame
loop of ``slam.py`` with its LI update replaced by the Gauss-Newton
iterated one, in float64 NumPy.

The iterated update of Bell & Cathey (IEEE TAC 38(2), 1993), what the
reference's ekf_update_iterated.m:1-4 calls (its update_iterated is
missing from the reference code), as a frozen copy of the repository's
oracle (``oracle.ekf_update_iterated`` and ``oracle.h_and_jacobian`` of
the port's float64 oracle, its ``pipeline.OracleSLAM`` stage 5), kept here
so that later changes to the measured program cannot move the yardstick:

* from the prior x̂, P̂, the LI records fixed in slot order, as
  ``RefSLAM._update`` stacks them;
* ``iekf_iterations`` re-linearizations of those records at the iterate
  x_i, K_i = P̂·H_iᵀ(H_i·P̂·H_iᵀ + I)⁻¹ and
  x_{i+1} = x̂ + K_i·((z − h(x_i)) − H_i·(x̂ − x_i));
* the covariance once, with the gain at the last iterate, by update.m's
  tail: P̂ − K·S·Kᵀ, symmetrized, the quaternion renormalized through
  normJac.

The HI update, the gates, RANSAC, the "near" notes and their turns are
``RefSLAM``'s. Where it departs from the JAX package's update (ekf.py:
691-731): S is inverted explicitly, as update.m does (JAX by Cholesky);
each iterate's rows are the exact derivative of h at the iterate, whose
quaternion is off the unit sphere (calculate_Hi_*.m differentiate
inv(q2r(q)), which scales their quaternion columns by |q|⁴; the program
differentiates q2r(q)ᵀ, the same derivative); a record that an iterate
takes out of view keeps its rows, projected without the ±60° gate.
NumPy rather than torch: the verdict's reference workers import NumPy
and ``benchmark.reference`` alone.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import oracle
from benchmark.reference.slam import CAM_DIM, RefSLAM


def h_and_jacobian(x, y, cartesian: bool, cam):
    """A feature's measurement at state x, without the view gates, and its
    Jacobian blocks (h (2,), H_xv (2,13), H_y (2, len(y))):
    calculate_Hi_*.m's blocks with the quaternion columns divided by |q|⁴,
    so that at |q| != 1 they are the derivative of h."""
    R_wc = oracle.q2r(x[3:7])
    if cartesian:
        hrl, Hi = R_wc.T @ (y - x[0:3]), oracle.Hi_cartesian
    else:
        hrl = R_wc.T @ ((y[0:3] - x[0:3]) * y[5] + oracle.m_ray(y[3], y[4]))
        Hi = oracle.Hi_inverse_depth
    h = oracle.distort(oracle.project(hrl, cam), cam)
    H_xv, H_y = Hi(x[0:13], y, h, cam)
    H_xv[:, 3:7] = H_xv[:, 3:7] / np.sum(x[3:7] ** 2) ** 2
    return h, H_xv, H_y


def ekf_update_iterated(x, P, h_fn, R, z, num_iters):
    """The iterated update from the prior (x, P): h_fn(x_i) -> (h_i, H_i);
    see the module docstring. With num_iters = 1, x is update.m's and P is
    not (its gain is re-linearized at x_1)."""
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
    T = np.eye(P_new.shape[0])
    T[3:7, 3:7] = oracle.norm_jac(xi[3:7])
    P_new = T @ P_new @ T.T
    x_new = xi.copy()
    x_new[3:7] = x_new[3:7] / np.linalg.norm(x_new[3:7])
    return x_new, P_new


class IEKFSLAM(RefSLAM):
    """One filter instance whose LI update (a frame's first ``_update``)
    is the iterated one; the HI update stays update.m's."""

    def frame(self, measure, candidates, u: np.ndarray) -> dict:
        self._iterate_next = True
        return super().frame(measure, candidates, u)

    def _update(self, lin, z, mask) -> None:
        if not self._iterate_next:
            return super()._update(lin, z, mask)
        self._iterate_next = False
        order = sorted((i for i in range(len(self.recs)) if mask[i]),
                       key=lambda i: self.recs[i].slot)
        if not order:
            return
        zs = np.concatenate([z[i] for i in order])
        self.x, self.P = ekf_update_iterated(
            self.x, self.P, self.relinearized(order), np.eye(len(zs)), zs,
            self.s.filter.iekf_iterations)

    def relinearized(self, order):
        """h_fn of the iterated update: a state x -> (h (2n,), H (2n, D)) of
        records `order` at x, every one projected and differentiated
        whether or not x keeps it in view."""
        cam = self.s.camera

        def h_fn(x):
            hs, rows = [], []
            for i in order:
                off, k = self.offset(i), self._size(self.recs[i])
                h, H_xv, H_y = h_and_jacobian(x, x[off:off + k],
                                              self.recs[i].kind == "c", cam)
                H = np.zeros((2, len(x)))
                H[:, 0:CAM_DIM] = H_xv
                H[:, off:off + k] = H_y
                hs.append(h)
                rows.append(H)
            return np.concatenate(hs), np.concatenate(rows)
        return h_fn


def iekf_step(s, st: dict, pixels: np.ndarray, visible: np.ndarray,
              u: np.ndarray, turn=None) -> dict:
    """``slam.sim_step`` with the iterated LI update: one frame of one
    instance from padded state `st` (pixels (L, 2) and visible (L,) the
    landmarks' observations, u (NHYP,) the RANSAC draws, `turn` a noted
    decision to turn). Returns the padded state after the frame with its
    camera block, gate counts and noted decisions."""
    m = s.map
    slam = IEKFSLAM.from_padded(s, st)
    slam.turn = turn
    z_by = {r.slot: pixels[r.lm_id] for r in slam.recs}
    zv_by = {r.slot: bool(visible[r.lm_id]) for r in slam.recs}

    def measure(sl, lin):
        z = np.array([z_by[r.slot] for r in sl.recs]).reshape(-1, 2)
        return z, np.array([zv_by[r.slot] for r in sl.recs], bool)

    def candidates(sl, lin, n_ic):
        if n_ic >= m.min_features_in_image:
            return []
        in_map = {r.lm_id for r in sl.recs}
        cand = [j for j in np.flatnonzero(visible)
                if j not in in_map][:m.max_new_per_step]
        return [(pixels[j], j)
                for j in cand[:m.min_features_in_image - n_ic]]

    res = slam.frame(measure, candidates, u)
    return dict(slam.padded(), cam=slam.x[:CAM_DIM].copy(), near=res["near"],
                counts=(int(res["ic"].sum()), int(res["li"].sum()),
                        int(res["hi"].sum())))
