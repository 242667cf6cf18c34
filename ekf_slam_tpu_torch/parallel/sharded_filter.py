"""The row-sharded (tensor-parallel) EKF-SLAM step over a process mesh.

Port of ``ekf_slam_tpu/parallel/sharded_filter.py``. P is (D, D) with
D = 13 + 6·CAP, the filter's memory wall; its ROW axis is split over the
mesh's "model" axis so that a rank holds D·D/k of it. JAX pins the
shardings and lets the partitioner place the collectives, swapping three
lowering forms for TP-shaped twins (predsel, dotsel, rowsel); torch has
none of that, so this module writes the unfused step (``engine.step_core``
and ``initialize_features``) in slab form with every collective explicit
(``mesh.all_gather`` / ``mesh.all_reduce``, which record each payload).

Layout: each rank holds x (B_l, Dp), the masks and counters (replicated
over "model") and the slab P[:, r0:r0 + Dl, :] (B_l, Dl, Dp) of a P
zero-padded to Dp = ⌈D/k⌉·k, Dl = Dp/k, r0 = Dl·(its "model" index). The
pad block is zero and stays zero. The step, stage by stage:

* every read of P that the replicated part of the step needs is gathered
  as rows (``Slab.rows``: the owner's rows, zeros elsewhere, summed over
  "model" — a slot's 6 rows may straddle two slabs): the 13 camera rows
  (predict, the S gates, the feature add), rows 3:7 (the update tails'
  renorm), a converted slot's 6 rows; and P's diagonal (the conversion's
  ρ variances) and the slot diagonal blocks (the S gates), each rank's
  part gathered;
* the products with P — the update's P·Hᵀ and RANSAC's P·G — run in K6
  on the slab (``kernels.f32_matmul_big`` on (B_l, Dl, Dp)) and the
  (B_l, Dl, N) results are gathered: O(D·N), N = 2M or NHYP;
* predict rewrites the camera rows the slab owns and the camera columns
  of its other rows from the gathered camera rows (JAX's "predsel");
  map management and the feature add form their slab's rows of
  keep∘P + EᵀU + UᵀE + EᵀCE from the replicated factors (its "rowsel");
* each update's tail is the folded correction P + Ā₂·B̄₂ᵀ on the slab's
  rows (Ā₂, B̄₂ (D, 2M'+8), replicated after the P·Hᵀ gather: the pair
  ``ekf._one_sided_factors`` derives from K4's rank-(M'+8) pair, whose
  single product is the symmetric correction): K8's row-slab form
  ``kernels.corr_apply_rows``, not K4, whose ½(P + Pᵀ) would need the
  other ranks' columns of the slab's rows. With an exactly symmetric P
  the two agree to rounding (JAX's sharded step takes the same folded
  tail).

Every collective's payload is factor-sized, at most
B_l·Dp·max(12·max_new, 4·CAP + 8, NHYP) elements (``payload_bound``); the
covariance never crosses ranks. The fused K1–K3 are single-device passes:
``make_sharded_step`` requires ``fused_step="off"``; it also takes neither
the iterated update, the row-form update, nor a bf16-stored P.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ekf_slam_tpu_torch.config import CAM_DIM, EngineConfig
from ekf_slam_tpu_torch.filter import (association, ekf, engine, mapman,
                                       measurement, motion, ransac)
from ekf_slam_tpu_torch.filter.state import FilterState
from ekf_slam_tpu_torch.ops import kernels
from ekf_slam_tpu_torch.parallel import mesh as pmesh
from ekf_slam_tpu_torch.parallel.mesh import Mesh


def padded_dim(cfg: EngineConfig, n_model: int) -> tuple[int, int]:
    """(D, Dp): the exact state dim and its model-axis-divisible pad."""
    D = CAM_DIM + 6 * cfg.map.capacity
    return D, -(-D // n_model) * n_model


def pad_state(state: FilterState, Dp: int) -> FilterState:
    """x zero-padded to (..., Dp) and P to (..., Dp, Dp)."""
    ext = Dp - state.x.shape[-1]
    if ext == 0:
        return state
    return state.replace(x=F.pad(state.x, (0, ext)),
                         P=F.pad(state.P, (0, ext, 0, ext)))


def unpad_state(state: FilterState, D: int) -> FilterState:
    return state.replace(x=state.x[..., :D], P=state.P[..., :D, :D])


def shard_state_batch(state_b: FilterState, mesh: Mesh, cfg: EngineConfig,
                      data_axis: str = "data",
                      model_axis: str = "model") -> FilterState:
    """This rank's part of a global batch of states: its block of
    instances over `data_axis`, x padded to Dp, and the slab of P's rows
    it owns over `model_axis` (B_l, Dl, Dp), on the mesh's device."""
    _, Dp = padded_dim(cfg, mesh.size(model_axis))
    st = pad_state(pmesh.shard_batch(state_b, mesh, data_axis), Dp)
    return st.replace(P=st.P[:, pmesh.block(Dp, mesh, model_axis)]
                      .contiguous())


def gather_state(state_p: FilterState, mesh: Mesh, cfg: EngineConfig,
                 model_axis: str = "model") -> FilterState:
    """The rank's instances with the whole P (B_l, D, D) gathered from the
    slabs and the pad cut: for reading results, never inside the step."""
    D, _ = padded_dim(cfg, mesh.size(model_axis))
    P = pmesh.all_gather(state_p.P, mesh, model_axis, dim=1)
    st = unpad_state(state_p.replace(P=P), D)
    return st.replace(x=st.x.contiguous(), P=st.P.contiguous())


def payload_bound(cfg: EngineConfig, b_local: int, Dp: int) -> int:
    """The largest collective the step may make, in elements: a factor of
    B_l·Dp·rows wide, rows the widest of the step's tall-skinny factors
    (the feature add's 12·max_new, the full-width tail's 4·CAP + 8,
    RANSAC's NHYP) — JAX's test_tp_step_collectives_stay_small bound."""
    m = cfg.map
    return b_local * Dp * max(12 * m.max_new_per_step, 4 * m.capacity + 8,
                              cfg.ransac.num_hypotheses)


def collective_inventory() -> list:
    """The collectives recorded since mesh.reset_collectives(), one
    "op axis elements" line each (JAX's reads them off the HLO)."""
    return [f"{op} {axis} {n}" for op, axis, n in pmesh.COLLECTIVES]


class Slab:
    """A rank's slab of P's rows, P (B, Dl, Dp) rows r0 .. r0+Dl−1 of a
    (B, Dp, Dp) P whose exact part is D x D, and the reads of the whole P
    the step makes, each through one collective over `axis`."""

    def __init__(self, P: torch.Tensor, mesh: Mesh, axis: str, D: int):
        self.P, self.mesh, self.axis, self.D = P, mesh, axis, D
        self.Dl, self.Dp = P.shape[1], P.shape[2]
        self.r0 = mesh.rank(axis) * self.Dl
        self.rows_here = slice(self.r0, self.r0 + self.Dl)

    def rows(self, idx: torch.Tensor) -> torch.Tensor:
        """Rows idx (B, n) of P, (B, n, D) in the compute dtype: each rank
        contributes the rows it owns and zeros for the rest."""
        B, n = idx.shape
        loc = idx - self.r0
        own = (loc >= 0) & (loc < self.Dl)
        part = torch.gather(self.P, 1, loc.clamp(0, self.Dl - 1)[..., None]
                            .expand(B, n, self.Dp))
        part = torch.where(own[..., None], part, torch.zeros_like(part))
        return ekf.p_compute(pmesh.all_reduce(part, self.mesh, self.axis)
                             [:, :, :self.D])

    def cam_rows(self) -> torch.Tensor:
        """P's 13 camera rows (B, 13, D)."""
        B = self.P.shape[0]
        return self.rows(torch.arange(CAM_DIM, device=self.P.device)
                         .expand(B, CAM_DIM))

    def diag_at(self, dims: torch.Tensor) -> torch.Tensor:
        """P's diagonal at dims (n,): (B, n); the ranks' diagonal entries
        gathered."""
        d = torch.diagonal(self.P[:, :, self.rows_here], dim1=1, dim2=2)
        return ekf.p_compute(pmesh.all_gather(d, self.mesh, self.axis,
                                              dim=1)[:, dims])

    def slot_blocks(self, cap: int) -> torch.Tensor:
        """The slot diagonal blocks (B, CAP, 6, 6) in the compute dtype:
        each rank fills the rows of them it owns."""
        B, dev = self.P.shape[0], self.P.device
        g = self.r0 + torch.arange(self.Dl, device=dev)
        ok = (g >= CAM_DIM) & (g < CAM_DIM + 6 * cap)
        loc, g = torch.nonzero(ok)[:, 0], g[ok]
        slot, j = (g - CAM_DIM) // 6, (g - CAM_DIM) % 6
        cols = CAM_DIM + 6 * slot[:, None] + torch.arange(6, device=dev)
        out = torch.zeros(B, cap, 6, 6, dtype=self.P.dtype, device=dev)
        out[:, slot, j] = self.P[:, loc[:, None], cols]
        return ekf.p_compute(pmesh.all_reduce(out, self.mesh, self.axis))

    def matmul(self, X: torch.Tensor) -> torch.Tensor:
        """P·X (B, D, N) for X (B, D, N): K6 on the slab, the (B, Dl, N)
        parts gathered."""
        Xp = F.pad(X, (0, 0, 0, self.Dp - self.D)).contiguous()
        part = kernels.f32_matmul_big(self.P, Xp)
        return pmesh.all_gather(part, self.mesh, self.axis,
                                dim=1)[:, :self.D]

    def pad(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """t with its D-long `dim` zero-padded to Dp."""
        pads = [0, 0] * (t.dim() - 1 - dim) + [0, self.Dp - self.D]
        return F.pad(t, pads)

    def corr_apply(self, A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
        """The slab's rows of P + A·Bᵀ (A, B (B, D, R), replicated): K8's
        row-slab form."""
        At = self.pad(A, 1).transpose(1, 2).contiguous()
        Bt = self.pad(B, 1).transpose(1, 2).contiguous()
        return kernels.corr_apply_rows(self.P, At, Bt, self.r0)

    def stacked_apply(self, keep_f, E, U, C) -> torch.Tensor:
        """The slab's rows of keep∘P + EᵀU + UᵀE + EᵀCE (mapman's stacked
        form) from the replicated factors keep_f (B, D), E, U (B, k, D)."""
        return mapman._stacked_apply(self.P, self.pad(keep_f, 1),
                                     self.pad(E, 2), self.pad(U, 2), C,
                                     self.rows_here)

    def predict(self, F13, Q13) -> torch.Tensor:
        """The slab of P⁻ (ekf.predict's stripe form): top = F·P[:13],
        its camera block F·P₁₁·Fᵀ + Q, written to the camera rows the
        slab owns and, transposed, to the camera columns of its other
        rows."""
        top = F13 @ self.cam_rows()
        top = torch.cat([top[:, :, :CAM_DIM] @ F13.transpose(1, 2) + Q13,
                         top[:, :, CAM_DIM:]], dim=2).to(self.P.dtype)
        top = self.pad(top, 2)                              # (B, 13, Dp)
        g = torch.arange(self.r0, self.r0 + self.Dl, device=self.P.device)
        cam = g < CAM_DIM
        out = self.P.clone()
        out[:, cam] = top[:, g[cam]]
        out[:, ~cam, :CAM_DIM] = top[:, :, g[~cam]].transpose(1, 2)
        return out

    def update(self, x, _P, H, z, h, row_mask, r_diag, use_pallas=False,
               gain_solver="cholesky"):
        """ekf.update on the slab (its P argument unused; H the
        update's ekf.JacobianBlocks): P·Hᵀ by K6 on the slab, from the
        masked blocks made dense, and gathered, S and the gain replicated
        from the blocks, the tail P + Ā₂·B̄₂ᵀ on the slab's rows. Returns
        (x_new, the slab of P_new). use_pallas is not taken: the K5 tail
        needs the whole P."""
        Hm = H.masked(row_mask.to(x.dtype))
        PHt = self.matmul(measurement.compact_dense_H(
            Hm.H_xv, Hm.H_y, Hm.sel, torch.ones_like(Hm.sel, dtype=torch.bool),
            (self.D - CAM_DIM) // 6).transpose(1, 2))
        x_new, K, PHt = ekf.update_gain(x, None, H, z, h, row_mask, r_diag,
                                        gain_solver, PHt)
        rows4 = torch.arange(3, 7, device=x.device).expand(x.shape[0], 4)
        x_new, A_f, B_f = ekf._folded_tail_factors(x_new, self.rows(rows4),
                                                   K, PHt)
        return x_new, self.corr_apply(*ekf._one_sided_factors(A_f, B_f))


def make_sharded_step(cfg: EngineConfig, mesh: Mesh, data_axis: str = "data",
                      model_axis: str = "model"):
    """The batched SLAM frame with P's rows sharded over `model_axis` and
    the instances over `data_axis`: ``step(states_p, obs, u) ->
    (states_p, StepInfo)``, states_p this rank's ``shard_state_batch``
    part, obs one frame (the same on every rank), u (B_l, NHYP) its
    instances' RANSAC draws. ``gather_state`` reads a result. Its route
    (engine.route) must be the unfused step's column form."""
    r = engine.route(cfg, mesh.device)
    if r.fused:
        raise ValueError("the row-sharded step requires fused_step='off': "
                         "the fused K1-K3 are single-device passes")
    f = cfg.filter
    if f.use_iterated_update:
        raise ValueError("the row-sharded step does not take the iterated "
                         "update")
    if f.p_storage != "f32" and cfg.dtype == "float32":
        raise ValueError("the row-sharded step stores P in the state's "
                         "dtype (p_storage='f32')")
    if r.rows:
        raise ValueError("the row-sharded step takes the column-form "
                         "update (EKF_UPDATE=cols)")
    D, _ = padded_dim(cfg, mesh.size(model_axis))
    cap = cfg.map.capacity

    def step(states_p: FilterState, obs, u: torch.Tensor):
        state = states_p.replace(x=states_p.x[:, :D])
        sp = Slab(states_p.P, mesh, model_axis, D)
        z, z_valid = engine.gather_measurements(state, obs)

        # 1+2. map management, then the prediction (camera stripe)
        mp = mapman.manage_params(state, cfg, read=sp)
        state = mp.state
        sp.P = sp.stacked_apply(mp.keep_f, mp.E6, mp.U6, mp.C66)
        xv = state.x[:, :CAM_DIM]
        x_prior = torch.cat([motion.fv(xv, f), state.x[:, CAM_DIM:]], dim=1)
        sp.P = sp.predict(motion.dfv_by_dxv(xv, f),
                          motion.process_noise(xv, f))

        # 3+4. IC gates, 1-point RANSAC (P·G in K6 on the slab)
        h, visible, H_xv, H_y = engine._linearize(x_prior, state, cfg)
        S = measurement.innovation_covariances_from_blocks(
            sp.cam_rows(), sp.slot_blocks(cap), H_xv, H_y, f.sigma_z)
        ic = association.individually_compatible(z, z_valid, h, visible, S,
                                                 cfg)
        vm = visible.to(H_xv.dtype)[..., None, None]
        li, support = ransac.run(x_prior, z, h, S, ic, state.cartesian, u,
                                 cfg, H_xv=H_xv * vm, H_y=H_y * vm,
                                 pg=sp.matmul)

        # 5-7. LI update, HI rescue from the posterior, HI update
        x_post, sp.P = engine.masked_update(x_prior, None, H_xv, H_y, z, h,
                                            li, cfg, update=sp.update)
        h2, vis2, H_xv2, H_y2 = engine._linearize(x_post, state, cfg)
        S_noR = measurement.innovation_covariances_from_blocks(
            sp.cam_rows(), sp.slot_blocks(cap), H_xv2, H_y2, 0.0)
        hi = association.rescue_high_innovation(z, h2, S_noR, ic & vis2, li,
                                                cfg)
        x_post, sp.P = engine.masked_update(x_post, None, H_xv2, H_y2, z,
                                            h2, hi, cfg, update=sp.update)
        state, _, ic, info = engine._step_core_epilogue(
            state, x_post, None, visible, ic, li, hi, support)

        # 8. feature init from the camera rows
        uvd, take, lm_ids = engine._init_candidates(state, obs,
                                                    ic.sum(dim=1), cfg)
        ap, _ = mapman.add_params(sp.cam_rows(), state, uvd, take, lm_ids,
                                  cfg)
        P_new = sp.stacked_apply(ap.keep_f, ap.E, ap.U, ap.C)
        return ap.state.replace(x=sp.pad(ap.state.x, 1), P=P_new), info

    return step
