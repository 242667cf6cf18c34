"""The per-frame SLAM step on the sim path, batched over filter instances.

Port of ``ekf_slam_tpu/filter/engine.py``: the MonoSLAM hot loop
(mono_slam.m:50-82) in its two forms, which ``step`` picks between as
the JAX engine does (``_use_fused``):

* ``step_fused``: all full-covariance work in three kernels
  (ops/kernels.py):

    K1 manage + predict + prior P·Hᵀ   (map_management, ekf_prediction,
                                        search_IC_matches' S)
    K2 LI tail + posterior P·Hᵀ        (ekf_update_li_inliers, rescue_hi)
    K3 HI tail + feature-init growth   (ekf_update_hi_inliers,
                                        initialize_features)

* ``step_core`` + ``initialize_features``: the unfused step, for every
  config outside the fused one's conditions (the library default and the
  bf16-P fast mode included). Its dense products on P run in K6
  (``f32_matmul_big``) and its two update tails in K4
  (``corr_apply_cols``) or, with ``pallas_update``, K5
  (``fused_update_tail``). With ``use_iterated_update`` its LI update
  is the IEKF (``ekf.update_iterated``: K6 for each P·Hᵀ, the same
  tail). Under ``ekf._UPDATE == "rows"``
  (EKF_UPDATE=rows) it takes the row form instead: one H·P row read a
  phase (``measurement.pht_rows_split``) feeds the S gates, RANSAC and
  ``ekf.update_rows``, whose tails run in K8 (``corr_apply``); no K6.

Stage order per frame: manage → predict → linearize → IC gates → 1-point
RANSAC → LI update → HI rescue → HI update → counters + feature init.
Every stage is masked, so instances never branch apart; the only
randomness is RANSAC's uniform draws, an input ``u`` (B, NHYP).

Measurements come by ground-truth association from a ``FrameObs`` shared
by all instances (the synthetic scene, sim/scene.py).

``run_sequence`` drives ``step`` over a sequence: on a CUDA device by
replaying one frame captured as a CUDA graph (filter/graph.py, the
counterpart of the JAX engine's scan under jit), else, or with
``eager=True``, by the eager loop.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ekf_slam_tpu_torch.config import CAM_DIM, EngineConfig
from ekf_slam_tpu_torch.filter import (association, ekf, graph, mapman,
                                       measurement, motion, ransac)
from ekf_slam_tpu_torch.filter.state import FIELDS, FilterState
from ekf_slam_tpu_torch.ops import kernels
from ekf_slam_tpu_torch.ops import quaternion as quat
from ekf_slam_tpu_torch.sim.scene import FrameObs
from ekf_slam_tpu_torch.utils.metrics import trace_annotation


@dataclasses.dataclass(frozen=True)
class StepInfo:
    """Per-step diagnostics, each (B,) — or (B, T) from run_sequence."""
    n_visible: torch.Tensor
    n_ic: torch.Tensor
    n_li: torch.Tensor
    n_hi: torch.Tensor
    ransac_support: torch.Tensor
    # The χ²-reach of the image matcher's search this frame, max
    # sqrt(chi2·λmax(S)) over the searched slots (vision/frontend
    # .step_image); zeros on the sim path.
    search_r_needed: torch.Tensor


def stack_infos(infos) -> StepInfo:
    """T per-frame StepInfos -> one with (B, T) fields."""
    return StepInfo(*(torch.stack([getattr(i, f.name) for i in infos], dim=1)
                      for f in dataclasses.fields(StepInfo)))


def gather_measurements(state: FilterState, obs: FrameObs):
    """Ground-truth association: slot i's measurement is the observation of
    the landmark it was initialized from. Returns (z (B,CAP,2),
    z_valid (B,CAP))."""
    lm = state.landmark_id.long()
    safe = lm.clamp(0, obs.pixels.shape[0] - 1)
    return obs.pixels[safe], (lm >= 0) & obs.visible[safe] & state.active


def _in_map_mask(state: FilterState, num_landmarks: int) -> torch.Tensor:
    """(B, L) bool — landmark already owned by an active slot."""
    lm = torch.where(state.active, state.landmark_id.long(), -1)
    counts = torch.zeros(lm.shape[0], num_landmarks, dtype=torch.int64,
                         device=lm.device)
    counts.scatter_add_(1, lm.clamp(0, num_landmarks - 1), (lm >= 0).long())
    return counts > 0


def _init_candidates(state: FilterState, obs: FrameObs, n_measured,
                     cfg: EngineConfig):
    """Candidate selection of map_management.m:27-34: when fewer than
    min_features were measured, up to max_new_per_step visible landmarks
    not yet in the map, first come first (stable order), at most the
    deficit. Returns (uvd (B,K,2), take (B,K), lm_ids (B,K))."""
    m = cfg.map
    L = obs.pixels.shape[0]
    need = n_measured < m.min_features_in_image
    candidate = obs.visible[None] & ~_in_map_mask(state, L)
    order = torch.argsort((~candidate).to(torch.int8), dim=1, stable=True)
    picks = order[:, :m.max_new_per_step]
    k = torch.arange(m.max_new_per_step, device=picks.device)
    deficit = torch.clamp(m.min_features_in_image - n_measured, min=0)
    take = (torch.gather(candidate, 1, picks) & (k < deficit[:, None])
            & need[:, None])
    return obs.pixels[picks], take, picks


def initialize_features(state: FilterState, obs: FrameObs, n_measured,
                        cfg: EngineConfig) -> FilterState:
    """Add the _init_candidates picks as new inverse-depth features."""
    uvd, take, lm_ids = _init_candidates(state, obs, n_measured, cfg)
    return mapman.add_features_batch(state, uvd, take, lm_ids, cfg)[0]


def bootstrap(state: FilterState, obs: FrameObs,
              cfg: EngineConfig) -> FilterState:
    """Initialize the map from the first frame (mono_slam.m runs
    map_management before the first prediction)."""
    zero = torch.zeros(state.batch, dtype=torch.int64, device=state.x.device)
    return initialize_features(state, obs, zero, cfg)


def _fused_fits(cfg: EngineConfig) -> bool:
    m, f = cfg.map, cfg.filter
    return (6 * m.max_new_per_step <= 128
            and 0 < m.max_update_obs < m.capacity
            and not f.use_iterated_update and f.p_storage == "f32")


def _use_fused(cfg: EngineConfig, device: torch.device) -> bool:
    """engine.py:351-368: "off" runs the unfused step; "on" the fused one,
    or raises for a config it cannot run; "auto" the fused one on a CUDA
    device at f32 when the config fits (a CUDA device is the port's
    counterpart of pallas_supported())."""
    mode = cfg.filter.fused_step
    if mode == "off":
        return False
    if mode == "on":
        if not _fused_fits(cfg):
            raise ValueError("fused_step=on requires 6*max_new_per_step "
                             "<= 128, 0 < max_update_obs < capacity, no "
                             "iterated update and f32 covariance storage")
        return True
    return (device.type == "cuda" and cfg.dtype == "float32"
            and _fused_fits(cfg))


def _use_pallas(cfg: EngineConfig, device: torch.device) -> bool:
    """engine.py:602-609: whether ekf.update's tail runs in K5."""
    mode = cfg.filter.pallas_update
    if mode in ("on", "off"):
        return mode == "on"
    return device.type == "cuda"


def step(state: FilterState, obs: FrameObs, u: torch.Tensor,
         cfg: EngineConfig):
    """One full SLAM frame on the sim path. u: (B, NHYP) uniform draws in
    [0, 1) for RANSAC. Returns (new_state, StepInfo)."""
    if _use_fused(cfg, state.x.device):
        return step_fused(state, obs, u, cfg)
    z, z_valid = gather_measurements(state, obs)
    state, _, ic, info = step_core(state, z, z_valid, u, cfg)
    return initialize_features(state, obs, ic.sum(dim=1), cfg), info


def step_core(state: FilterState, z: torch.Tensor, z_valid: torch.Tensor,
              u: torch.Tensor, cfg: EngineConfig):
    """Stages 1-7 of the unfused frame given per-slot measurements
    (z (B,CAP,2), z_valid (B,CAP)): manage, predict, then
    ``step_core_from_prior``. Returns (state, visible, ic, StepInfo)."""
    check_ported(cfg)
    state = mapman.manage(state, cfg)
    x_prior, P_prior = ekf.predict(state.x, state.P, cfg.filter)
    return step_core_from_prior(state, x_prior, P_prior, z, z_valid, u, cfg)


def check_ported(cfg: EngineConfig) -> None:
    """Raise ValueError for the filter setting the unfused step (and the
    image step built on it) does not port: share_pht."""
    if cfg.filter.share_pht:
        raise ValueError("share_pht is not ported")


def _rows_mode(cfg: EngineConfig, device: torch.device) -> bool:
    """engine.py:174-175: the row-form update under EKF_UPDATE=rows, unless
    share_pht, the IEKF or the K5 tail (pallas_update) is taken."""
    f = cfg.filter
    return (ekf._UPDATE == "rows" and not f.share_pht
            and not f.use_iterated_update and not _use_pallas(cfg, device))


def step_core_from_prior(state: FilterState, x_prior, P_prior, z, z_valid,
                         u: torch.Tensor, cfg: EngineConfig):
    """Stages 3-7 given the managed state and its prediction
    (engine.py:152-312 on its default and its row-form branches): IC
    gates, RANSAC, the LI update, the HI rescue from the posterior, the HI
    update. Column form: S from P's blocks, RANSAC's moves in K6, the
    updates by _masked_update. Row form: each phase reads P once into the
    H·P rows of every visible slot, which give S, RANSAC's moves and
    _masked_update_rows' operand. With use_iterated_update the LI update
    is the IEKF (_masked_update_iterated, column form only).
    Returns (state, visible, ic, StepInfo)."""
    f = cfg.filter
    rows = _rows_mode(cfg, x_prior.device)
    h, visible, H_xv, H_y = _linearize(x_prior, state, cfg)
    S, hp = _phase_gates(P_prior, H_xv, H_y, visible, f.sigma_z, rows)
    ic = association.individually_compatible(z, z_valid, h, visible, S, cfg)
    vm = visible.to(H_xv.dtype)[..., None, None]
    li, support = ransac.run(x_prior, z, h, S, ic, state.cartesian, u, cfg,
                             P=P_prior, H_xv=H_xv * vm, H_y=H_y * vm, hp=hp)
    if f.use_iterated_update:
        x_post, P_post = _masked_update_iterated(x_prior, P_prior, z, li,
                                                 state, cfg)
    else:
        x_post, P_post = _phase_update(x_prior, P_prior, hp, H_xv, H_y, z, h,
                                       li, cfg)
    h2, vis2, H_xv2, H_y2 = _linearize(x_post, state, cfg)
    S_noR, hp2 = _phase_gates(P_post, H_xv2, H_y2, vis2, 0.0, rows)
    hi = association.rescue_high_innovation(z, h2, S_noR, ic & vis2, li, cfg)
    x_post, P_post = _phase_update(x_post, P_post, hp2, H_xv2, H_y2, z, h2,
                                   hi, cfg)
    return _step_core_epilogue(state, x_post, P_post, visible, ic, li, hi,
                               support)


def _phase_gates(P, H_xv, H_y, visible, sigma_z: float, rows: bool):
    """A phase's per-slot S (B,CAP,2,2) and, in row form, the split H·P
    rows of the visible slots it was read off (else None)."""
    if not rows:
        return measurement.innovation_covariances(P, H_xv, H_y, sigma_z), None
    vm = visible.to(H_xv.dtype)[..., None, None]
    hp = measurement.pht_rows_split(P, H_xv * vm, H_y * vm)
    return measurement.innovation_covariances_from_hp(
        *hp, H_xv * vm, H_y * vm, sigma_z), hp


def _phase_update(x, P, hp, H_xv, H_y, z, h, slot_mask, cfg: EngineConfig):
    """A phase's update: row form from its H·P rows hp, else column form."""
    if hp is None:
        return _masked_update(x, P, H_xv, H_y, z, h, slot_mask, cfg)
    return _masked_update_rows(x, P, hp, H_xv, H_y, z, h, slot_mask, cfg)


def _step_core_epilogue(state: FilterState, x_post, P_post, visible, ic, li,
                        hi, support):
    """State write, counters (update_features_info.m; measured ⇔ an IC
    match) and StepInfo. Returns (state, visible, ic, StepInfo)."""
    state = mapman.update_counters(state.replace(x=x_post, P=P_post),
                                   visible, ic)
    info = StepInfo(n_visible=visible.sum(dim=1), n_ic=ic.sum(dim=1),
                    n_li=li.sum(dim=1), n_hi=hi.sum(dim=1),
                    ransac_support=support,
                    search_r_needed=x_post.new_zeros(x_post.shape[0]))
    return state, visible, ic, info


def _gather_slots(slot_mask: torch.Tensor, M: int):
    """The M most relevant slots, the mask's slots first in stable order:
    (sel (B,M), sel_mask (B,M), take) with take(a) gathering a (B,CAP,...)
    tensor at sel."""
    B = slot_mask.shape[0]
    sel = torch.argsort((~slot_mask).to(torch.int8), dim=1,
                        stable=True)[:, :M]
    sel_mask = torch.gather(slot_mask, 1, sel)

    def take(a):                    # (B, CAP, ...) -> (B, M, ...)
        idx = sel.reshape(B, M, *([1] * (a.dim() - 2)))
        return torch.gather(a, 1, idx.expand(B, M, *a.shape[2:]))

    return sel, sel_mask, take


def _masked_update(x, P, H_xv, H_y, z, h, slot_mask, cfg: EngineConfig,
                   update=None):
    """EKF update over the masked slots (engine.py:482-517). With
    0 < max_update_obs = M < CAP the M most relevant slots are gathered
    into a compact (2M, D) Jacobian; otherwise every slot's rows enter the
    dense (2·CAP, D) one. `update` takes ekf.update's arguments and
    applies them (ekf.update by default; the row-sharded step's applies
    them to its slab). Returns (x_new, P_new)."""
    update = ekf.update if update is None else update
    B, cap = slot_mask.shape
    M = cfg.map.max_update_obs
    use_pallas = _use_pallas(cfg, x.device)
    solver = cfg.filter.gain_solver
    if M <= 0 or M >= cap:
        H = measurement.dense_H(H_xv, H_y, slot_mask)
        return update(
            x, P, H, z.reshape(B, 2 * cap), h.reshape(B, 2 * cap),
            slot_mask.repeat_interleave(2, dim=1),
            torch.ones(B, 2 * cap, dtype=x.dtype, device=x.device),
            use_pallas, solver)
    sel, sel_mask, take = _gather_slots(slot_mask, M)
    H = measurement.compact_dense_H(take(H_xv), take(H_y), sel, sel_mask,
                                    cap)
    return update(
        x, P, H, take(z).reshape(B, 2 * M), take(h).reshape(B, 2 * M),
        sel_mask.repeat_interleave(2, dim=1),
        torch.ones(B, 2 * M, dtype=x.dtype, device=x.device),
        use_pallas, solver)


def _masked_update_rows(x, P, hp, H_xv, H_y, z, h, slot_mask,
                        cfg: EngineConfig):
    """Row-form _masked_update (engine.py:577-599): the M most relevant
    slots (M = max_update_obs, or CAP when M <= 0 or M > CAP), their
    Jacobian rows in block order [u-rows; v-rows] and the same rows of the
    phase's split H·P (hp = (hp_u, hp_v), each (B,CAP,D)), through
    ekf.update_rows. Returns (x_new, P_new)."""
    B, cap = slot_mask.shape
    M = cfg.map.max_update_obs
    if M <= 0 or M > cap:
        M = cap
    sel, sel_mask, take = _gather_slots(slot_mask, M)
    Hc = measurement.compact_dense_H_block(take(H_xv), take(H_y), sel,
                                           sel_mask, cap)
    HP = torch.cat([take(hp[0]), take(hp[1])], dim=1)       # (B, 2M, D)
    zs, hs = take(z), take(h)
    return ekf.update_rows(
        x, P, Hc, HP, torch.cat([zs[..., 0], zs[..., 1]], dim=1),
        torch.cat([hs[..., 0], hs[..., 1]], dim=1), sel_mask.repeat(1, 2),
        torch.ones(B, 2 * M, dtype=x.dtype, device=x.device),
        cfg.filter.gain_solver)


def _masked_update_iterated(x, P, z, slot_mask, state: FilterState,
                            cfg: EngineConfig):
    """The Gauss-Newton iterated LI update (engine.py:612-633): the M most
    relevant slots as in _masked_update when 0 < M < CAP, every slot in
    slot order otherwise, their rows u,v interleaved; h_fn re-linearizes
    at each iterate through _linearize. Returns (x_new, P_new)."""
    B, cap = slot_mask.shape
    M = cfg.map.max_update_obs
    if 0 < M < cap:
        sel, sel_mask, take = _gather_slots(slot_mask, M)
    else:
        M = cap
        sel = torch.arange(cap, device=slot_mask.device).expand(B, cap)
        sel_mask = slot_mask

        def take(a):
            return a

    def h_fn(xi):
        h_i, _, H_xv_i, H_y_i = _linearize(xi, state, cfg)
        H = measurement.compact_dense_H(take(H_xv_i), take(H_y_i), sel,
                                        sel_mask, cap)
        return take(h_i).reshape(B, 2 * M), H

    return ekf.update_iterated(
        x, P, take(z).reshape(B, 2 * M), h_fn,
        sel_mask.repeat_interleave(2, dim=1),
        torch.ones(B, 2 * M, dtype=x.dtype, device=x.device),
        cfg.filter.iekf_iterations, _use_pallas(cfg, x.device))


def _linearize(x, state: FilterState, cfg: EngineConfig):
    h, visible, hc = measurement.predict_measurements(
        x, state.active, state.cartesian, cfg)
    H_xv, H_y = measurement.jacobians(x, h, hc, state.cartesian, cfg.camera)
    return h, visible, H_xv, H_y


def _compact_gain(x, pht_flat, H_xv, H_y, z, h, slot_mask,
                  cfg: EngineConfig):
    """Gain half of the fused step's compact masked update: gather the M
    most relevant slots, their Jacobian rows and their P·Hᵀ column pairs
    from pht_flat (B, D, 2·CAP), and solve.
    Returns (x_new un-renormalized, K (B,D,2M), PHt (B,D,2M))."""
    B, cap = slot_mask.shape
    M = cfg.map.max_update_obs
    sel, sel_mask, take = _gather_slots(slot_mask, M)
    Hc = measurement.compact_dense_H(take(H_xv), take(H_y), sel, sel_mask,
                                     cap)
    cols = (2 * sel[..., None] + torch.arange(2, device=sel.device)
            ).reshape(B, 2 * M)
    D = pht_flat.shape[1]
    PHt_sel = torch.gather(pht_flat, 2, cols[:, None, :].expand(B, D, 2 * M))
    return ekf.update_gain(
        x, None, Hc, take(z).reshape(B, 2 * M), take(h).reshape(B, 2 * M),
        sel_mask.repeat_interleave(2, dim=1),
        torch.ones(B, 2 * M, dtype=x.dtype, device=x.device),
        cfg.filter.gain_solver, PHt_sel)


def step_fused(state: FilterState, obs: FrameObs, u: torch.Tensor,
               cfg: EngineConfig):
    """The full SLAM frame with all covariance work in K1-K3; the same
    math stage by stage as the JAX engine.step_fused (engine.py:371-479).
    Each numbered section below runs in its span (utils/metrics.py SPANS:
    sim.manage_predict, sim.linearize_ic, sim.ransac, sim.li_update,
    sim.hi_rescue, sim.hi_update, sim.init), with device marks on a CUDA
    state. Returns (new_state, StepInfo)."""
    f = cfg.filter
    B, cap = state.active.shape
    D = state.x.shape[1]
    dev = state.x.device

    # -- 1+2. map management + EKF prediction (P transforms in K1) ----------
    with trace_annotation("sim.manage_predict", dev):
        mp = mapman.manage_params(state, cfg)
        state_m = mp.state
        xv = state_m.x[:, :CAM_DIM]         # camera block: manage-invariant
        F = motion.dfv_by_dxv(xv, f)
        Q = motion.process_noise(xv, f)
        x_prior = torch.cat([motion.fv(xv, f), state_m.x[:, CAM_DIM:]],
                            dim=1)

    # -- 3. linearization at the prior, IC gates from K1's gain columns -----
    with trace_annotation("sim.linearize_ic", dev):
        z, z_valid = gather_measurements(state, obs)
        h, visible, H_xv, H_y = _linearize(x_prior, state_m, cfg)
        Ht = measurement.dense_Ht(H_xv, H_y, visible)             # (B,D,2CAP)
        P_prior, pht_flat = kernels.fused_manage_predict_pht(
            state.P, mp.keep_f, mp.E6, mp.U6, mp.C66, F, Q, Ht)
        S = measurement.innovation_covariances_from_pht(
            pht_flat.reshape(B, D, cap, 2), H_xv, H_y, f.sigma_z)
        ic = association.individually_compatible(z, z_valid, h, visible, S,
                                                 cfg)

    # -- 4. 1-point RANSAC (gain columns re-used from K1) --------------------
    with trace_annotation("sim.ransac", dev):
        li, support = ransac.run(x_prior, z, h, S, ic, state_m.cartesian, u,
                                 cfg, pht_flat)

    # -- 5. LI update: gain here, covariance tail + posterior P·Hᵀ in K2 ----
    with trace_annotation("sim.li_update", dev):
        x_li, K_li, PHt_li = _compact_gain(x_prior, pht_flat, H_xv, H_y, z,
                                           h, li, cfg)
        Jq1 = quat.norm_jac(x_li[:, 3:7])
        x_li = ekf._renormalized(x_li)

    # -- 6. HI rescue from the posterior -------------------------------------
    with trace_annotation("sim.hi_rescue", dev):
        h2, vis2, H_xv2, H_y2 = _linearize(x_li, state_m, cfg)
        Ht2 = measurement.dense_Ht(H_xv2, H_y2, vis2)
        P_li, pht2_flat = kernels.fused_update_tail_pht(P_prior, K_li,
                                                        PHt_li, Jq1, Ht2)
        S_noR = measurement.innovation_covariances_from_pht(
            pht2_flat.reshape(B, D, cap, 2), H_xv2, H_y2, 0.0)
        hi = association.rescue_high_innovation(z, h2, S_noR, ic & vis2, li,
                                                cfg)

    # -- 7. HI update: gain here, tail + feature-init growth in K3 ----------
    with trace_annotation("sim.hi_update", dev):
        x_hi, K_hi, PHt_hi = _compact_gain(x_li, pht2_flat, H_xv2, H_y2, z,
                                           h2, hi, cfg)
        Jq2 = quat.norm_jac(x_hi[:, 3:7])
        x_fin = ekf._renormalized(x_hi)

    # -- 8. bookkeeping + feature init (P growth fused into K3) --------------
    with trace_annotation("sim.init", dev):
        state2 = mapman.update_counters(state_m.replace(x=x_fin), visible,
                                        ic)
        # The post-HI camera stripe (B, 13, D) — what K3 computes for rows
        # 0:13 — from the stripe alone: sym-downdate, then the renorm
        # transform.
        stripe = P_li[:, :CAM_DIM] - 0.5 * (
            K_hi[:, :CAM_DIM] @ PHt_hi.transpose(1, 2)
            + PHt_hi[:, :CAM_DIM] @ K_hi.transpose(1, 2))
        stripe = torch.cat([stripe[:, :3], Jq2 @ stripe[:, 3:7],
                            stripe[:, 7:]], dim=1)
        stripe = torch.cat([stripe[:, :, :3],
                            stripe[:, :, 3:7] @ Jq2.transpose(1, 2),
                            stripe[:, :, 7:]], dim=2)
        n_ic = ic.sum(dim=1)
        uvd, take, lm_ids = _init_candidates(state2, obs, n_ic, cfg)
        ap, _ = mapman.add_params(stripe, state2, uvd, take, lm_ids, cfg)
        P_fin = kernels.fused_update_tail_add(P_li, K_hi, PHt_hi, Jq2,
                                              ap.keep_f, ap.E, ap.U, ap.C)
        info = StepInfo(n_visible=visible.sum(dim=1), n_ic=n_ic,
                        n_li=li.sum(dim=1), n_hi=hi.sum(dim=1),
                        ransac_support=support,
                        search_r_needed=P_fin.new_zeros(P_fin.shape[0]))
    return ap.state.replace(P=P_fin), info


def _sim_frame(carry, inputs, cfg: EngineConfig):
    """One `step` as graph.py's frame function: carry the FilterState's
    fields, inputs (pixels, visible, u) of the frame. Outputs: the camera
    block of the new state and the StepInfo's fields."""
    pixels, visible, u = inputs
    state, info = step(FilterState(*carry), FrameObs(pixels, visible), u,
                       cfg)
    return (tuple(getattr(state, f) for f in FIELDS),
            (state.x[:, :CAM_DIM].contiguous(),
             *(getattr(info, f.name) for f in dataclasses.fields(StepInfo))))


def frame_driver(state: FilterState, obs_seq: FrameObs, u_seq: torch.Tensor,
                 cfg: EngineConfig, capture: bool = True):
    """run_sequence through graph.py's static buffers: the frame captured
    once (kept by config, route and shapes) and replayed, or with
    capture=False the same frame callable over the same buffers without a
    graph (how the CPU tests see what replay runs). Returns what
    run_sequence returns."""
    final, (traj, *info) = graph.run(
        functools.partial(_sim_frame, cfg=cfg),
        tuple(getattr(state, f) for f in FIELDS),
        lambda t: (obs_seq.pixels[t], obs_seq.visible[t], u_seq[t]),
        obs_seq.pixels.shape[0], ("sim", cfg), capture)
    return FilterState(*final), traj, StepInfo(*info)


def run_sequence(state: FilterState, obs_seq: FrameObs, u_seq: torch.Tensor,
                 cfg: EngineConfig, eager: bool | None = None):
    """`step` over a sequence: obs_seq fields carry a leading time axis T,
    u_seq is (T, B, NHYP). On a CUDA device one frame is captured as a
    CUDA graph and replayed T times (frame_driver; the counterpart of the
    JAX package's jitted scan); eager=True, or a CPU state, runs the eager
    loop of `step`, and eager=False without a card raises. Returns
    (final_state, camera trajectory (B, T, 13), StepInfo with (B, T)
    fields). Runs in the host span sim.run_sequence."""
    with trace_annotation("sim.run_sequence"):
        if graph.replays(state.x.device, eager):
            return frame_driver(state, obs_seq, u_seq, cfg)
        traj, infos = [], []
        for t in range(obs_seq.pixels.shape[0]):
            state, info = step(state, obs_seq.frame(t), u_seq[t], cfg)
            traj.append(state.x[:, :CAM_DIM])
            infos.append(info)
        return state, torch.stack(traj, dim=1), stack_infos(infos)
