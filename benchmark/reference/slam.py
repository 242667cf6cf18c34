"""The reference frame: MonoSLAM's whole per-frame loop in float64 NumPy.

mono_slam.m:50-82 in the reference's own dynamic-shape idiom: a compact
state that grows on feature init, shrinks on delete and reparametrizes on
the inverse-depth -> cartesian conversion, with one record a feature. It
is a frozen copy of the repository's sequential oracle
(``oracle/pipeline.py``), with the measurement and the feature-init
candidates handed in by the caller, so that one loop serves both kinds of
input:

* synthetic observations (``sim_bootstrap``, ``sim_step``): ground-truth
  association, the candidates the first visible landmarks not in the map;
* rendered frames (``frontend.image_step``): the NCC search of every
  matchable feature, the candidates FAST corners.

Determinism rules shared with the program (the batched, padded filter):
discrete decisions use the same closed forms (the 2x2 adjugate solve with
its zero-determinant guard, the closed-form largest eigenvalue); RANSAC's
hypotheses are picked from the uniform draws u by ``sample_ic_indices``,
an input; deletes happen all at once, at most one conversion a frame at
the lowest eligible slot, update rows stack in slot order, and the k-th
accepted candidate takes the k-th lowest free slot.
"""

from __future__ import annotations

import types

import numpy as np

from benchmark.reference import oracle

CAM_DIM = 13
# A decision whose statistic lies within NEAR of its threshold (relative;
# an NCC score gap in score units) is noted; where the program parts from
# the reference in a frame, the verdict turns, one at a time, the noted
# decisions within turn_limit(kind) and follows the branch that the
# program took. One float32 frame moves the filter's statistics by ~1e-6
# of themselves. An NCC score moves further: K7's norms form keeps a
# patch variance within 16 roundoff units of its window's centred energy
# (ncc.FLAT_EPS), so a patch of 1% of that energy scores within ~1e-4 and
# one of 0.1% within ~1e-3. A template's flat ratio Σtm² / Σt² moves by
# up to 2.8e-4 of itself from the program's float32 template to the
# reference's float64 one near the threshold (PERF.md §2): ten times that.
NEAR = 1e-2
TURN = {"ncc_tie": 2e-3, "ncc_min": 2e-3, "ncc_flat": 3e-3}


def turn_limit(kind: str) -> float:
    return TURN.get(kind, 1e-4)


def settings(engine: dict) -> types.SimpleNamespace:
    """Attribute namespaces of a configuration's ``engine`` dict, one a
    section (camera, filter, map, matching, ransac, vision, sim)."""
    return types.SimpleNamespace(**{
        k: types.SimpleNamespace(**v) if isinstance(v, dict) else v
        for k, v in engine.items()})


def sample_ic_indices(u: np.ndarray, ic: np.ndarray) -> np.ndarray:
    """Hypothesis slots drawn among the IC matches (select_random_match.m):
    rank k = floor(u·n_ic), the draws and their product in single
    precision as they are handed in; the slot of the k-th match, the last
    slot when there is none. u (N,) float32, ic (CAP,) bool -> (N,)."""
    csum = np.cumsum(ic.astype(np.int64))
    n = np.float32(csum[-1])
    ranks = np.floor(u.astype(np.float32) * n).astype(np.int64)
    return np.searchsorted(csum, ranks + 1, side="left").clip(0, len(ic) - 1)


def _solve_2x2(S, v):
    det = S[0, 0] * S[1, 1] - S[0, 1] * S[1, 0]
    safe = 1.0 if det == 0 else det
    return np.array([(S[1, 1] * v[0] - S[0, 1] * v[1]) / safe,
                     (-S[1, 0] * v[0] + S[0, 0] * v[1]) / safe])


def mahal2(nu, S) -> float:
    return float(nu @ _solve_2x2(S, nu))


def max_eig_2x2(S) -> float:
    tr = S[0, 0] + S[1, 1]
    det = S[0, 0] * S[1, 1] - S[0, 1] * S[1, 0]
    return tr / 2.0 + np.sqrt(max(tr * tr / 4.0 - det, 0.0))


class Rec:
    """One features_info record (add_feature_to_info_vector.m:7-32)."""

    def __init__(self, slot: int, lm_id: int):
        self.slot = slot
        self.lm_id = lm_id
        self.kind = "id"            # "id" (6 dims) or "c" (3 dims)
        self.times_predicted = 0
        self.times_measured = 0


class RefSLAM:
    """One filter instance."""

    def __init__(self, s: types.SimpleNamespace):
        self.s = s
        self.x, self.P = oracle.initialize_x_and_p(s.filter)
        self.recs: list[Rec] = []
        self.near: list = []
        self.turn = None            # (kind, slot): the decision to turn

    def turned(self, kind: str, slot: int, margin: float) -> bool:
        """Whether this decision is the one to turn (and may be)."""
        return self.turn == (kind, slot) and margin < turn_limit(kind)

    def note(self, kind: str, slot: int, margin: float) -> None:
        """Record a decision whose statistic lay within NEAR (relative) of
        its threshold: where the program parts from the reference, these
        say which decisions rounding could have turned."""
        if margin < NEAR:
            self.near.append((float(margin), kind, int(slot)))

    @classmethod
    def from_padded(cls, s, st: dict) -> "RefSLAM":
        """An instance holding a padded state (``PADDED`` fields: x
        (13 + 6·CAP,), P (D, D), active, cartesian, times_predicted,
        times_measured, landmark_id (CAP,)), its records in slot order."""
        slam = cls(s)
        idx = list(range(CAM_DIM))
        for slot in np.flatnonzero(st["active"]):
            r = Rec(int(slot), int(st["landmark_id"][slot]))
            r.kind = "c" if st["cartesian"][slot] else "id"
            r.times_predicted = int(st["times_predicted"][slot])
            r.times_measured = int(st["times_measured"][slot])
            base = CAM_DIM + 6 * int(slot)
            idx += range(base, base + slam._size(r))
            slam.recs.append(r)
        slam.x = np.asarray(st["x"], np.float64)[idx]
        slam.P = np.asarray(st["P"], np.float64)[np.ix_(idx, idx)]
        return slam

    # ------------------------------------------------------------ layout
    def _size(self, r: Rec) -> int:
        return 6 if r.kind == "id" else 3

    def offset(self, i: int) -> int:
        return CAM_DIM + sum(self._size(r) for r in self.recs[:i])

    def rec_value(self, i: int) -> np.ndarray:
        off = self.offset(i)
        return self.x[off:off + self._size(self.recs[i])]

    def by_slot(self) -> dict:
        return {r.slot: i for i, r in enumerate(self.recs)}

    def world_point(self, i: int) -> np.ndarray:
        y = self.rec_value(i)
        if self.recs[i].kind == "c":
            return y.copy()
        return oracle.inversedepth_to_cartesian_point(y)

    # ---------------------------------------------------- stage 1: manage
    def manage(self) -> None:
        m = self.s.map
        weak = [i for i, r in enumerate(self.recs)
                if r.times_predicted >= m.delete_min_predictions
                and r.times_measured
                < m.delete_measured_ratio * r.times_predicted]
        for i in sorted(weak, reverse=True):
            off = self.offset(i)
            keep = np.r_[0:off, off + self._size(self.recs[i]):len(self.x)]
            self.x = self.x[keep]
            self.P = self.P[np.ix_(keep, keep)]
            del self.recs[i]
        best = None
        for i, r in enumerate(self.recs):
            if r.kind != "id":
                continue
            off = self.offset(i)
            y = self.x[off:off + 6]
            rho = y[5]
            if rho == 0:
                continue
            std_d = np.sqrt(max(self.P[off + 5, off + 5], 0.0)) / rho**2
            p = y[0:3] + oracle.m_ray(y[3], y[4]) / rho
            v1, v2 = p - y[0:3], p - self.x[0:3]
            n1, n2 = np.linalg.norm(v1), np.linalg.norm(v2)
            if n1 == 0 or n2 == 0:
                continue
            lin = 4.0 * std_d * (float(v1 @ v2) / (n1 * n2)) / n2
            margin = (abs(lin - m.linearity_threshold)
                      / m.linearity_threshold)
            self.note("convert", r.slot, margin)
            if ((lin < m.linearity_threshold)
                    != self.turned("convert", r.slot, margin)) and (
                    best is None or r.slot < self.recs[best].slot):
                best = i
        if best is not None:
            off = self.offset(best)
            y = self.x[off:off + 6]
            D = len(self.x)
            J = np.zeros((D - 3, D))
            J[:off, :off] = np.eye(off)
            J[off:off + 3, off:off + 6] = oracle.id2cartesian_jacobian(y)
            J[off + 3:, off + 6:] = np.eye(D - off - 6)
            self.P = J @ self.P @ J.T
            self.x = np.concatenate([
                self.x[:off], oracle.inversedepth_to_cartesian_point(y),
                self.x[off + 6:]])
            self.recs[best].kind = "c"

    # ------------------------------------------------- stage 3: linearize
    def linearize(self) -> list:
        """(h, visible, H_xv, H_y) of every record at the current x."""
        cam, fov = self.s.camera, self.s.matching.fov_limit_deg
        R_wc = oracle.q2r(self.x[3:7])
        out = []
        for i, r in enumerate(self.recs):
            y = self.rec_value(i)
            hi = (oracle.hi_inverse_depth if r.kind == "id"
                  else oracle.hi_cartesian)
            h, vis = hi(y, self.x[0:3], R_wc, cam, fov)
            if vis:
                Hi = (oracle.Hi_inverse_depth if r.kind == "id"
                      else oracle.Hi_cartesian)
                H_xv, H_y = Hi(self.x[0:13], y, h, cam)
            else:
                H_xv, H_y = np.zeros((2, 13)), np.zeros((2, len(y)))
            out.append((h, vis, H_xv, H_y))
        return out

    def H_row(self, lin, i: int) -> np.ndarray:
        _, _, H_xv, H_y = lin[i]
        off = self.offset(i)
        H = np.zeros((2, len(self.x)))
        H[:, 0:13] = H_xv
        H[:, off:off + H_y.shape[1]] = H_y
        return H

    def innovation_cov(self, lin, i: int, sigma_z: float) -> np.ndarray:
        H = self.H_row(lin, i)
        return H @ self.P @ H.T + sigma_z**2 * np.eye(2)

    def _update(self, lin, z, mask) -> None:
        """ekf_update_*_inliers.m: the masked records' rows in slot order,
        R = I."""
        order = sorted((i for i in range(len(self.recs)) if mask[i]),
                       key=lambda i: self.recs[i].slot)
        if not order:
            return
        H = np.concatenate([self.H_row(lin, i) for i in order])
        zs = np.concatenate([z[i] for i in order])
        hs = np.concatenate([lin[i][0] for i in order])
        self.x, self.P = oracle.ekf_update(self.x, self.P, H,
                                           np.eye(len(zs)), zs, hs)

    def _map_rows(self, x) -> tuple:
        """(Y (n, 6), is_id (n,)) of every record in state x."""
        Y = np.zeros((len(self.recs), 6))
        off = CAM_DIM
        for i, r in enumerate(self.recs):
            k = self._size(r)
            Y[i, :k] = x[off:off + k]
            off += k
        return Y, np.array([r.kind == "id" for r in self.recs], bool)

    # --------------------------------------------------------- one frame
    def frame(self, measure, candidates, u: np.ndarray) -> dict:
        """One frame. measure(self, lin) -> (z (n, 2), z_valid (n,)) at
        the prior, aligned with self.recs; candidates(self, lin, n_ic) ->
        [(pixel (2,), landmark id)] in candidate order, those taken; u the
        frame's RANSAC draws (NHYP,). Returns the gate masks, the RANSAC
        support and the slots given to new features."""
        s = self.s
        f = s.filter
        self.manage()
        self.x, self.P = oracle.predict(self.x, self.P, f)
        lin = self.linearize()
        n = len(self.recs)
        z, zv = measure(self, lin)
        visible = np.array([lin[i][1] for i in range(n)], bool)
        S_all = [self.innovation_cov(lin, i, f.sigma_z) for i in range(n)]
        ic = np.zeros(n, bool)
        chi2, eig = s.matching.chi2_inv_2_95, s.matching.max_innovation_eig
        for i in range(n):
            if zv[i] and visible[i]:
                slot = self.recs[i].slot
                m2, lmax = mahal2(z[i] - lin[i][0], S_all[i]), max_eig_2x2(
                    S_all[i])
                gate, room = abs(m2 - chi2) / chi2, abs(lmax - eig) / eig
                ic[i] = (((m2 < chi2) != self.turned("ic", slot, gate))
                         and ((lmax < eig) != self.turned("eig", slot, room)))
                self.note("ic", slot, gate)
                self.note("eig", slot, room)

        # 1-point RANSAC: hypotheses drawn among the IC matches
        ic_pad = np.zeros(s.map.capacity, bool)
        for i, r in enumerate(self.recs):
            ic_pad[r.slot] = ic[i]
        by_slot = self.by_slot()
        _, is_id = self._map_rows(self.x)
        zic, thr2 = z[ic], f.sigma_z**2
        slots_ic = np.array([r.slot for r in self.recs], int)[ic]
        best_sup, best_in, tried = -1, np.zeros(n, bool), []
        for pick in sample_ic_indices(u, ic_pad):
            i = by_slot.get(int(pick))
            if i is None:
                continue
            w = _solve_2x2(S_all[i], z[i] - lin[i][0])
            H = self.H_row(lin, i)
            x_hyp = self.x + (self.P @ H.T) @ w
            inl = np.zeros(n, bool)
            res2 = np.zeros(0)
            if ic.any():
                Y, _ = self._map_rows(x_hyp)
                uv = oracle.reproject(Y[ic], is_id[ic], x_hyp, s.camera)
                res2 = np.sum((zic - uv) ** 2, axis=1)
                test = res2 < thr2
                if self.turn is not None and self.turn[0] == "ransac":
                    k = np.flatnonzero(slots_ic == self.turn[1])
                    if len(k) and (abs(res2[k[0]] - thr2) / thr2
                                   < turn_limit("ransac")):
                        test[k[0]] = not test[k[0]]
                inl[ic] = test
            sup = int(inl.sum())
            tried.append((sup, res2))
            if sup > best_sup:
                best_sup, best_in = sup, inl
        for sup, res2 in tried:         # a test that could turn the best
            if sup >= best_sup - 1 and len(res2):
                k = int(np.argmin(np.abs(res2 - thr2)))
                self.note("ransac", slots_ic[k], abs(res2[k] - thr2) / thr2)
        li = best_in & ic.any()

        self._update(lin, z, li)                   # LI update, the prior's H
        lin2 = self.linearize()                    # HI rescue, posterior
        hi = np.zeros(n, bool)
        for i in range(n):
            if ic[i] and lin2[i][1] and not li[i]:
                slot = self.recs[i].slot
                m2 = mahal2(z[i] - lin2[i][0],
                            self.innovation_cov(lin2, i, 0.0))
                gate = abs(m2 - chi2) / chi2
                hi[i] = (m2 < chi2) != self.turned("hi", slot, gate)
                self.note("hi", slot, gate)
        self._update(lin2, z, hi)

        for i, r in enumerate(self.recs):          # update_features_info.m
            r.times_predicted += int(visible[i])
            r.times_measured += int(ic[i])

        added = self.add_features(candidates(self, lin, int(ic.sum())))
        return dict(ic=ic, li=li, hi=hi, visible=visible,
                    support=max(best_sup, 0) if ic.any() else 0,
                    added=added,
                    near=sorted(self.near,
                                key=lambda n: n[0] / turn_limit(n[1]))[:8])

    def add_features(self, cands) -> list:
        """Inverse-depth features at the candidates' pixels, the k-th
        into the k-th lowest free slot while slots last
        (add_features_inverse_depth.m). Returns [(slot, pixel)]."""
        m, f, cam = self.s.map, self.s.filter, self.s.camera
        used = {r.slot for r in self.recs}
        free = [k for k in range(m.capacity) if k not in used]
        added = []
        for (uvd, lm_id), slot in zip(cands, free):
            uvd = np.asarray(uvd, np.float64)
            y = oracle.hinv(uvd, self.x[0:13], cam, m.initial_rho)
            self.P = oracle.add_feature_covariance_inverse_depth(
                self.P, uvd, self.x[0:13], f.sigma_z, m.std_rho, cam)
            self.x = np.concatenate([self.x, y])
            self.recs.append(Rec(slot, int(lm_id)))
            added.append((slot, uvd))
        return added

    # ------------------------------------------------------------- views
    def padded(self) -> dict:
        """The state in the program's padded layout (x, active, cartesian,
        the counters and landmark ids), the compact covariance P, and
        ``dst``: each compact state index's place in the padded x."""
        cap = self.s.map.capacity
        x = np.zeros(CAM_DIM + 6 * cap)
        x[:CAM_DIM] = self.x[:CAM_DIM]
        out = dict(active=np.zeros(cap, bool), cartesian=np.zeros(cap, bool),
                   times_predicted=np.zeros(cap, np.int64),
                   times_measured=np.zeros(cap, np.int64),
                   landmark_id=np.full(cap, -1, np.int64))
        dst = list(range(CAM_DIM))
        off = CAM_DIM
        for r in self.recs:
            k = self._size(r)
            base = CAM_DIM + 6 * r.slot
            x[base:base + k] = self.x[off:off + k]
            dst += range(base, base + k)
            out["active"][r.slot] = True
            out["cartesian"][r.slot] = r.kind == "c"
            out["times_predicted"][r.slot] = r.times_predicted
            out["times_measured"][r.slot] = r.times_measured
            out["landmark_id"][r.slot] = r.lm_id
            off += k
        return dict(out, x=x, P=self.P.copy(), dst=np.array(dst))


def empty_state(s) -> dict:
    """The padded state of an instance before its first frame."""
    return RefSLAM(s).padded()


def sim_bootstrap(s, pixels0: np.ndarray, visible0: np.ndarray) -> dict:
    """The map initialized from frame 0 before the first prediction (the
    first max_new_per_step visible landmarks): the padded state."""
    m = s.map
    slam = RefSLAM(s)
    first = np.flatnonzero(visible0)[:m.max_new_per_step]
    slam.add_features([(pixels0[j], j)
                       for j in first[:max(m.min_features_in_image, 0)]])
    return slam.padded()


def sim_step(s, st: dict, pixels: np.ndarray, visible: np.ndarray,
             u: np.ndarray, turn=None) -> dict:
    """One frame of one instance from padded state `st`: pixels (L, 2)
    and visible (L,) the landmarks' observations, u (NHYP,) the RANSAC
    draws. Measurements by ground-truth association from the records
    before management; new features at the first visible landmarks not in
    the map; `turn` a noted decision to turn. Returns the padded state
    after the frame with its camera block, gate counts and noted
    decisions."""
    m = s.map
    slam = RefSLAM.from_padded(s, st)
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
