"""Sequential float64 oracle of the WHOLE per-frame SLAM pipeline.

Extends oracle/oracle.py (single-op golden math) to the full eight-stage
mono_slam.m loop (mono_slam.m:50-82) in the reference's dynamic-shape
idiom: a compact state vector that physically grows on feature init
(add_features_inverse_depth.m:20-23), shrinks on delete
(delete_a_feature.m:21-25) and reparametrizes on inverse-depth→cartesian
conversion (inversedepth_2_cartesian.m:37-45), with per-feature records
mirroring features_info. The padded TPU engine must match this trajectory
through ALL stages — map management, predict, association, 1-point RANSAC,
LI update, HI rescue/update, counters, feature init — to RMSE <= 1e-6
(tests/test_golden_pipeline.py).

Determinism contract with the engine:
* discrete decisions (chi^2 / eig gates, RANSAC support) use the engine's
  exact closed forms (2x2 adjugate solve with the zero-det guard) so f64
  boundary decisions agree;
* RANSAC hypothesis picks are an INPUT (the test draws them with the
  engine's own sample_ic_indices on the oracle's ic mask — identical masks
  give identical picks);
* ordering rules mirror the engine: deletes all-at-once, ONE conversion
  per step at the lowest eligible slot id, LI/HI update rows stacked in
  slot-id order (the EKF update is row-permutation invariant), k-th
  accepted init candidate into the k-th lowest free slot.

The PyTorch port's copy of ``ekf_slam_tpu/oracle/pipeline.py``, line for
line, reading the port's own ``EngineConfig``: every field it reads
(``dtype``, the ``map`` / ``matching`` / ``filter`` / ``camera`` settings)
has the same name, type and default in both packages. The engine named
above is the port's: the golden check is ``oracle/golden.py``.

Two additions are the port's own. ``from_padded`` builds an oracle from
one instance of the engine's padded state. With
``cfg.filter.use_iterated_update`` the LI update (stage 5) is the
iterated EKF update of Bell & Cathey (IEEE TAC 38(2), 1993), what the
reference's ekf_update_iterated.m:1-4 calls and its code lacks, as the
JAX package's ``ekf.update_iterated`` (ekf.py:691-731) computes it: the
LI records fixed in slot order, as the plain update stacks them;
``iekf_iterations`` re-linearizations of them at the iterate x_i, each
gain K_i = P̂·H_iᵀ(H_i·P̂·H_iᵀ + I)⁻¹ from the prior P̂ and
x_{i+1} = x̂ + K_i·((z − h(x_i)) − H_i·(x̂ − x_i)); the covariance once,
with the gain at the last iterate, by update.m's tail (P̂ − K·S·Kᵀ,
symmetrized, the quaternion renormalized through normJac)
(``oracle.ekf_update_iterated``). The HI update stays the plain one.
Where it departs from the JAX package: S is inverted explicitly, as
update.m does (JAX by Cholesky); each iterate's rows are the exact
derivative of h at the iterate, whose quaternion is off the unit sphere
(``oracle.h_and_jacobian``: calculate_Hi_*.m's inv(q2r(q)) scales their
quaternion columns by |q|⁴; JAX and the port differentiate with
q2r(q)ᵀ, the same derivative); a record that an iterate takes out of
view keeps its rows, projected without the ±60° gate (JAX projects a
dummy point outside that gate, never reached within a frame's update).
Float64 NumPy, like the rest of the oracle: no kernels, batching or
padding.
"""

from __future__ import annotations

import numpy as np

from ekf_slam_tpu_torch.config import EngineConfig
from ekf_slam_tpu_torch.oracle import oracle


class Rec:
    """One features_info record (add_feature_to_info_vector.m:7-32 subset)."""

    def __init__(self, slot, lm_id):
        self.slot = slot
        self.lm_id = lm_id
        self.kind = "id"          # 'id' (6 dims) or 'c' (3 dims)
        self.times_predicted = 0
        self.times_measured = 0


def _solve_2x2(S, v):
    """The engine's adjugate solve incl. the zero-det guard
    (association._solve_2x2) — used so gate decisions agree bit-for-bit."""
    det = S[0, 0] * S[1, 1] - S[0, 1] * S[1, 0]
    safe = 1.0 if det == 0 else det
    return np.array([(S[1, 1] * v[0] - S[0, 1] * v[1]) / safe,
                     (-S[1, 0] * v[0] + S[0, 0] * v[1]) / safe])


def _mahal2(nu, S):
    return float(nu @ _solve_2x2(S, nu))


def _max_eig_2x2(S):
    tr = S[0, 0] + S[1, 1]
    det = S[0, 0] * S[1, 1] - S[0, 1] * S[1, 0]
    return tr / 2.0 + np.sqrt(max(tr * tr / 4.0 - det, 0.0))


class OracleSLAM:
    def __init__(self, cfg: EngineConfig):
        assert cfg.dtype == "float64"
        self.cfg = cfg
        x, P = oracle.initialize_x_and_p(cfg.filter)
        self.x = x
        self.P = P
        self.recs: list[Rec] = []

    @classmethod
    def from_padded(cls, cfg: EngineConfig, x, P, active, cartesian,
                    times_predicted, times_measured, landmark_id):
        """An oracle holding one instance of the engine's padded state
        (x (13 + 6·CAP,), P (D, D), the per-slot fields (CAP,); numpy),
        its records in slot order, in float64."""
        orc = cls(cfg)
        idx = list(range(13))
        for slot in np.flatnonzero(active):
            r = Rec(int(slot), int(landmark_id[slot]))
            r.kind = "c" if cartesian[slot] else "id"
            r.times_predicted = int(times_predicted[slot])
            r.times_measured = int(times_measured[slot])
            base = 13 + 6 * int(slot)
            idx += range(base, base + (3 if r.kind == "c" else 6))
            orc.recs.append(r)
        orc.x = np.asarray(x, np.float64)[idx]
        orc.P = np.asarray(P, np.float64)[np.ix_(idx, idx)]
        return orc

    # ------------------------------------------------------------- layout
    def _sizes(self):
        return [6 if r.kind == "id" else 3 for r in self.recs]

    def offset(self, i):
        return 13 + int(np.sum(self._sizes()[:i], dtype=int))

    def rec_value(self, i):
        off = self.offset(i)
        return self.x[off: off + (6 if self.recs[i].kind == "id" else 3)]

    def by_slot(self):
        return {r.slot: i for i, r in enumerate(self.recs)}

    # -------------------------------------------------------- stage 1: manage
    def manage(self):
        m = self.cfg.map
        # delete (all weak at once — mask-equivalent to sequential deletes)
        weak = [i for i, r in enumerate(self.recs)
                if r.times_predicted >= m.delete_min_predictions
                and r.times_measured < m.delete_measured_ratio * r.times_predicted]
        for i in sorted(weak, reverse=True):
            off = self.offset(i)
            n = 6 if self.recs[i].kind == "id" else 3
            keep = np.r_[0:off, off + n: self.x.shape[0]]
            self.x = self.x[keep]
            self.P = self.P[np.ix_(keep, keep)]
            del self.recs[i]
        # convert: ONE per step, lowest eligible slot id
        # (inversedepth_2_cartesian.m:32-49; engine argmax(eligible))
        best = None
        for i, r in enumerate(self.recs):
            if r.kind != "id":
                continue
            off = self.offset(i)
            y = self.x[off: off + 6]
            rho = y[5]
            if rho == 0:
                continue
            rho_var = self.P[off + 5, off + 5]
            std_d = np.sqrt(max(rho_var, 0.0)) / rho**2
            mi = oracle.m_ray(y[3], y[4])
            p = y[0:3] + mi / rho
            v1 = p - y[0:3]
            v2 = p - self.x[0:3]
            n1, n2 = np.linalg.norm(v1), np.linalg.norm(v2)
            if n1 == 0 or n2 == 0:
                continue
            cos_a = float(v1 @ v2) / (n1 * n2)
            L = 4.0 * std_d * cos_a / n2
            if L < m.linearity_threshold and (
                    best is None or r.slot < self.recs[best].slot):
                best = i
        if best is not None:
            i = best
            off = self.offset(i)
            y = self.x[off: off + 6]
            J = oracle.id2cartesian_jacobian(y)          # (3, 6)
            D = self.x.shape[0]
            Jall = np.zeros((D - 3, D))
            Jall[:off, :off] = np.eye(off)
            Jall[off: off + 3, off: off + 6] = J
            Jall[off + 3:, off + 6:] = np.eye(D - off - 6)
            self.P = Jall @ self.P @ Jall.T
            self.x = np.concatenate([
                self.x[:off], oracle.inversedepth_to_cartesian_point(y),
                self.x[off + 6:]])
            self.recs[i].kind = "c"

    # ---------------------------------------------------- stage 3: linearize
    def linearize(self):
        """h, visible, per-rec (H_xv, H_y) at the current self.x."""
        cam = self.cfg.camera
        fov = self.cfg.matching.fov_limit_deg
        R_wc = oracle.q2r(self.x[3:7])
        out = []
        for i, r in enumerate(self.recs):
            y = self.rec_value(i)
            if r.kind == "id":
                h, vis = oracle.hi_inverse_depth(y, self.x[0:3], R_wc, cam,
                                                 fov)
            else:
                h, vis = oracle.hi_cartesian(y, self.x[0:3], R_wc, cam, fov)
            if vis:
                if r.kind == "id":
                    H_xv, H_y = oracle.Hi_inverse_depth(
                        self.x[0:13], y, h, cam)
                else:
                    H_xv, H_y = oracle.Hi_cartesian(self.x[0:13], y, h, cam)
            else:
                H_xv = np.zeros((2, 13))
                H_y = np.zeros((2, 6 if r.kind == "id" else 3))
            out.append((h, vis, H_xv, H_y))
        return out

    def dense_rows(self, lin, mask):
        """Stack (H, z-idx) rows for recs where mask[i], slot-id order."""
        D = self.x.shape[0]
        order = sorted(range(len(self.recs)),
                       key=lambda i: self.recs[i].slot)
        rows, hs, idxs = [], [], []
        for i in order:
            if not mask[i]:
                continue
            h, vis, H_xv, H_y = lin[i]
            off = self.offset(i)
            Hrow = np.zeros((2, D))
            Hrow[:, 0:13] = H_xv
            Hrow[:, off: off + H_y.shape[1]] = H_y
            rows.append(Hrow)
            hs.append(h)
            idxs.append(i)
        return rows, hs, idxs

    def relinearized(self, idxs):
        """h_fn of the iterated update: a state x -> (h (2n,), H (2n, D))
        of records idxs (the LI records, in slot order) at x, every one
        projected and differentiated whether or not x keeps it in view
        (oracle.h_and_jacobian)."""
        cam = self.cfg.camera

        def h_fn(x):
            hs, rows = [], []
            for i in idxs:
                off = self.offset(i)
                n = 6 if self.recs[i].kind == "id" else 3
                h, H_xv, H_y = oracle.h_and_jacobian(
                    x, x[off: off + n], self.recs[i].kind == "c", cam)
                Hrow = np.zeros((2, x.shape[0]))
                Hrow[:, 0:13] = H_xv
                Hrow[:, off: off + n] = H_y
                hs.append(h)
                rows.append(Hrow)
            return np.concatenate(hs), np.concatenate(rows, axis=0)
        return h_fn

    def innovation_cov(self, lin, i, sigma_z):
        h, vis, H_xv, H_y = lin[i]
        off = self.offset(i)
        n = H_y.shape[1]
        D = self.x.shape[0]
        H = np.zeros((2, D))
        H[:, 0:13] = H_xv
        H[:, off: off + n] = H_y
        return H @ self.P @ H.T + (sigma_z ** 2) * np.eye(2), H

    # ------------------------------------------------------------- one frame
    def step(self, z_by_slot, zvalid_by_slot, picks_fn, obs_visible,
             obs_pixels):
        """One full frame. z_by_slot/zvalid_by_slot: dicts slot -> value
        (computed by the caller from PRE-manage records, matching
        engine.gather_measurements); picks_fn: padded (CAP,) ic mask ->
        (NHYP,) RANSAC slot draws (the test passes the engine's own
        sample_ic_indices with the frame key, so identical ic masks give
        identical picks); obs_visible/obs_pixels: the frame's landmark
        observations for feature init. Returns per-stage masks."""
        cfg = self.cfg
        f = cfg.filter
        self.manage()
        # stage 2: predict
        self.x, self.P = oracle.predict(self.x, self.P, f)

        # stage 3: linearize + IC gate
        lin = self.linearize()
        n = len(self.recs)
        z = np.zeros((n, 2))
        zv = np.zeros(n, bool)
        for i, r in enumerate(self.recs):
            if r.slot in z_by_slot:
                z[i] = z_by_slot[r.slot]
                zv[i] = zvalid_by_slot[r.slot]
        visible = np.array([lin[i][1] for i in range(n)], bool)
        ic = np.zeros(n, bool)
        S_all = []
        for i in range(n):
            S, _ = self.innovation_cov(lin, i, f.sigma_z)
            S_all.append(S)
            if not (zv[i] and visible[i]):
                continue
            nu = z[i] - lin[i][0]
            ic[i] = (_mahal2(nu, S) < cfg.matching.chi2_inv_2_95
                     and _max_eig_2x2(S) < cfg.matching.max_innovation_eig)

        # stage 4: 1-point RANSAC over the picks drawn from this ic mask
        ic_padded = np.zeros(cfg.map.capacity, bool)
        for i, r in enumerate(self.recs):
            ic_padded[r.slot] = ic[i]
        picks = picks_fn(ic_padded)
        thr2 = f.sigma_z ** 2
        by_slot = self.by_slot()
        best_sup, best_inliers = -1, np.zeros(n, bool)
        for pick in np.asarray(picks):
            i = by_slot.get(int(pick))
            if i is None:          # pick of a dead slot: engine clips; a
                continue           # no-IC frame masks RANSAC out entirely
            nu = z[i] - lin[i][0]
            w = _solve_2x2(S_all[i], nu)
            _, H = self.innovation_cov(lin, i, f.sigma_z)
            x_hyp = self.x + (self.P @ H.T) @ w
            inl = np.zeros(n, bool)
            R_wc = oracle.q2r(x_hyp[3:7])
            for k, r in enumerate(self.recs):
                if not ic[k]:
                    continue
                off = self.offset(k)
                yk = x_hyp[off: off + (6 if r.kind == "id" else 3)]
                if r.kind == "id":
                    mi = oracle.m_ray(yk[3], yk[4])
                    hrl = R_wc.T @ ((yk[0:3] - x_hyp[0:3]) * yk[5] + mi)
                else:
                    hrl = R_wc.T @ (yk - x_hyp[0:3])
                if hrl[2] == 0:
                    hrl = np.array([hrl[0], hrl[1], 1.0])
                uv = oracle.distort(oracle.project(hrl, cfg.camera),
                                    cfg.camera)
                if np.sum((z[k] - uv) ** 2) < thr2:
                    inl[k] = True
            sup = int(inl.sum())
            if sup > best_sup:
                best_sup, best_inliers = sup, inl
        li = best_inliers & ic.any()

        # stage 5: LI update from the prior (R = I, ekf_update_li_inliers.m;
        # with use_iterated_update the iterated one, ekf_update_iterated.m)
        rows, hs, idxs = self.dense_rows(lin, li)
        if rows and f.use_iterated_update:
            zs = np.concatenate([z[i] for i in idxs])
            self.x, self.P = oracle.ekf_update_iterated(
                self.x, self.P, self.relinearized(idxs), np.eye(len(zs)),
                zs, f.iekf_iterations)
        elif rows:
            H = np.concatenate(rows, axis=0)
            zs = np.concatenate([z[i] for i in idxs])
            hcat = np.concatenate(hs)
            self.x, self.P = oracle.ekf_update(
                self.x, self.P, H, np.eye(len(zs)), zs, hcat)

        # stage 6: HI rescue from the posterior (rescue_hi_inliers.m)
        lin2 = self.linearize()
        vis2 = np.array([lin2[i][1] for i in range(n)], bool)
        hi = np.zeros(n, bool)
        for i in range(n):
            if not (ic[i] and vis2[i]) or li[i]:
                continue
            S_noR, _ = self.innovation_cov(lin2, i, 0.0)
            nu = z[i] - lin2[i][0]
            hi[i] = _mahal2(nu, S_noR) < cfg.matching.chi2_inv_2_95

        # stage 7: HI update from the posterior (R = I)
        rows, hs, idxs = self.dense_rows(lin2, hi)
        if rows:
            H = np.concatenate(rows, axis=0)
            zs = np.concatenate([z[i] for i in idxs])
            hcat = np.concatenate(hs)
            self.x, self.P = oracle.ekf_update(
                self.x, self.P, H, np.eye(len(zs)), zs, hcat)

        # stage 8a: counters (update_features_info.m semantics)
        for i, r in enumerate(self.recs):
            r.times_predicted += int(visible[i])
            r.times_measured += int(ic[i])

        # stage 8b: feature init (engine._init_candidates +
        # add_features_batch ordering rules)
        m = cfg.map
        n_measured = int(ic.sum())
        need = n_measured < m.min_features_in_image
        in_map = {r.lm_id for r in self.recs}
        Lm = obs_visible.shape[0]
        candidate = np.array([obs_visible[j] and j not in in_map
                              for j in range(Lm)])
        order = np.argsort(~candidate, kind="stable")
        picks_init = order[: m.max_new_per_step]
        deficit = max(m.min_features_in_image - n_measured, 0)
        cap = m.capacity
        used = {r.slot for r in self.recs}
        free_slots = [s for s in range(cap) if s not in used]
        n_added = 0
        for k, j in enumerate(picks_init):
            take = candidate[j] and (k < deficit) and need
            if not take or n_added >= len(free_slots):
                continue
            slot = free_slots[n_added]
            n_added += 1
            uvd = np.asarray(obs_pixels[j], np.float64)
            y = oracle.hinv(uvd, self.x[0:13], cfg.camera, m.initial_rho)
            self.P = oracle.add_feature_covariance_inverse_depth(
                self.P, uvd, self.x[0:13], f.sigma_z, m.std_rho, cfg.camera)
            self.x = np.concatenate([self.x, y])
            self.recs.append(Rec(slot, int(j)))
        return dict(ic=ic, li=li, hi=hi, visible=visible,
                    support=best_sup)
