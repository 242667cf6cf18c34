"""The per-frame SLAM step on the sim path, batched over filter instances.

Port of ``ekf_slam_tpu/filter/engine.py``: the MonoSLAM hot loop
(mono_slam.m:50-82) in its two forms. ``route`` alone picks a frame's
form (and the unfused step's layout, IEKF and K5 tail) from the config,
the device and ``UPDATE``; every step takes it from there, ekf.py keeps
none, and the frame drivers key their captured frames by it.

* ``step_fused``: all full-covariance work in three kernels
  (ops/kernels.py):

    K1 manage + predict + prior P·Hᵀ   (map_management, ekf_prediction,
                                        search_IC_matches' S)
    K2 LI tail + posterior P·Hᵀ        (ekf_update_li_inliers, rescue_hi)
    K3 HI tail + feature-init growth   (ekf_update_hi_inliers,
                                        initialize_features)

* ``step_core`` + ``initialize_features``: the unfused step, for every
  config outside the fused one's conditions (the library default and the
  bf16-P fast mode included). Each update's P·Hᵀ and S come from the
  Jacobian's blocks in one pass over P (``kernels.pht_blocks``), RANSAC's
  P·G from K6 (``f32_matmul_big``), and its two update tails run in K4
  (``corr_apply_cols``) or, with ``pallas_update``, K5
  (``fused_update_tail``). With ``use_iterated_update`` its LI update
  is the IEKF (``ekf.update_iterated``: each gain by pht_blocks, the
  same tail). On the row route (EKF_UPDATE=rows) it takes the row form
  instead: one H·P row read a phase (``measurement.pht_rows_split``)
  feeds the S gates, RANSAC and ``ekf.update_rows``, whose tails run in
  K8 (``corr_apply``); no K6.

Stage order per frame: manage → predict → linearize → IC gates → 1-point
RANSAC → LI update → HI rescue → HI update → counters + feature init.
Every stage is masked, so instances never branch apart; the only
randomness is RANSAC's uniform draws, an input ``u`` (B, NHYP).
Both forms run their stages in the spans sim.manage_predict,
sim.linearize_ic, sim.ransac, sim.li_update, sim.hi_rescue, sim.hi_update
and sim.init (utils/metrics.py SPANS; device marks on a CUDA state), the
IEKF's iterates and its tail nested in sim.li_update as iekf.iterate and
iekf.tail.

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
import os

import torch

from ekf_slam_tpu_torch.config import CAM_DIM, EngineConfig
from ekf_slam_tpu_torch.filter import (association, ekf, graph, mapman,
                                       measurement, motion, ransac)
from ekf_slam_tpu_torch.filter.state import FIELDS, FilterState
from ekf_slam_tpu_torch.ops import kernels
from ekf_slam_tpu_torch.ops import quaternion as quat
from ekf_slam_tpu_torch.sim.scene import FrameObs
from ekf_slam_tpu_torch.utils.metrics import trace_annotation

# The unfused step's update layout, "cols" (the default; pht_blocks, K4)
# or "rows" (one H·P row read a phase, K8): the JAX engine's switch
# (ekf.py:142), the only environment read on the filter path.
UPDATE = os.environ.get("EKF_UPDATE", "cols")


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


@dataclasses.dataclass(frozen=True)
class Route:
    """A frame's form: `fused` step_fused (K1-K3; the rest then False),
    else the unfused step in row (`rows`) or column form, its LI update
    the IEKF (`iterated`), its tails in K5 (`use_pallas`)."""
    fused: bool
    rows: bool
    iterated: bool
    use_pallas: bool


def route(cfg: EngineConfig, device: torch.device,
          fused: bool = True) -> Route:
    """The route of a frame of `cfg` on `device`; fused=False for a step
    with no fused form (the image step, the unfused step itself).
    fused_step (engine.py:351-368): "off" the unfused step; "on" the fused
    one, or ValueError for a config it cannot run; "auto" the fused one on
    a CUDA device (the port's pallas_supported()) at f32 when the config
    fits. The unfused step raises for share_pht, takes K5 as pallas_update
    says ("auto": on a CUDA device; engine.py:602-609) and the row form
    under UPDATE "rows" unless the IEKF or K5 is taken (engine.py:174)."""
    f, m = cfg.filter, cfg.map
    cuda = torch.device(device).type == "cuda"
    fits = (6 * m.max_new_per_step <= 128
            and 0 < m.max_update_obs < m.capacity
            and not f.use_iterated_update and f.p_storage == "f32")
    if fused and f.fused_step == "on" and not fits:
        raise ValueError("fused_step=on requires 6*max_new_per_step "
                         "<= 128, 0 < max_update_obs < capacity, no "
                         "iterated update and f32 covariance storage")
    if fused and fits and (f.fused_step == "on" or (
            f.fused_step != "off" and cuda and cfg.dtype == "float32")):
        return Route(True, False, False, False)
    if f.share_pht:
        raise ValueError("share_pht is not ported")
    use_pallas = (f.pallas_update == "on" if f.pallas_update in ("on", "off")
                  else cuda)
    rows = UPDATE == "rows" and not f.use_iterated_update and not use_pallas
    return Route(False, rows, f.use_iterated_update, use_pallas)


def step(state: FilterState, obs: FrameObs, u: torch.Tensor,
         cfg: EngineConfig):
    """One full SLAM frame on the sim path. u: (B, NHYP) uniform draws in
    [0, 1) for RANSAC. Returns (new_state, StepInfo)."""
    if route(cfg, state.x.device).fused:
        return step_fused(state, obs, u, cfg)
    z, z_valid = gather_measurements(state, obs)
    state, _, ic, info = step_core(state, z, z_valid, u, cfg)
    with trace_annotation("sim.init", state.x.device):
        state = initialize_features(state, obs, ic.sum(dim=1), cfg)
    return state, info


def step_core(state: FilterState, z: torch.Tensor, z_valid: torch.Tensor,
              u: torch.Tensor, cfg: EngineConfig):
    """Stages 1-7 of the unfused frame given per-slot measurements
    (z (B,CAP,2), z_valid (B,CAP)): manage, predict, then
    ``step_core_from_prior``, manage and predict in the span
    sim.manage_predict. Returns (state, visible, ic, StepInfo)."""
    with trace_annotation("sim.manage_predict", state.x.device):
        state = mapman.manage(state, cfg)
        x_prior, P_prior = ekf.predict(state.x, state.P, cfg.filter)
    return step_core_from_prior(state, x_prior, P_prior, z, z_valid, u, cfg)


def step_core_from_prior(state: FilterState, x_prior, P_prior, z, z_valid,
                         u: torch.Tensor, cfg: EngineConfig):
    """Stages 3-7 given the managed state and its prediction
    (engine.py:152-312 on its default and its row-form branches): IC
    gates, RANSAC, the LI update, the HI rescue from the posterior, the HI
    update, on the unfused route (``route(cfg, device, fused=False)``).
    Column form: S from P's blocks, RANSAC's moves in K6, the updates by
    masked_update (their gains by pht_blocks). Row form: each phase reads
    P once into the H·P rows of every visible slot, which give S,
    RANSAC's moves and _masked_update_rows' operand. With
    use_iterated_update the LI update is the IEKF
    (_masked_update_iterated, column form only). The stages run in the
    spans of step_fused's sections 3-7 (sim.linearize_ic, sim.ransac,
    sim.li_update, sim.hi_rescue, sim.hi_update).
    Returns (state, visible, ic, StepInfo)."""
    f = cfg.filter
    dev = x_prior.device
    r = route(cfg, dev, fused=False)
    with trace_annotation("sim.linearize_ic", dev):
        h, visible, H_xv, H_y = _linearize(x_prior, state, cfg)
        S, hp = _phase_gates(P_prior, H_xv, H_y, visible, f.sigma_z, r.rows)
        ic = association.individually_compatible(z, z_valid, h, visible, S,
                                                 cfg)
    with trace_annotation("sim.ransac", dev):
        vm = visible.to(H_xv.dtype)[..., None, None]
        li, support = ransac.run(x_prior, z, h, S, ic, state.cartesian, u,
                                 cfg, P=P_prior, H_xv=H_xv * vm,
                                 H_y=H_y * vm, hp=hp)
    with trace_annotation("sim.li_update", dev):
        if r.iterated:
            x_post, P_post = _masked_update_iterated(x_prior, P_prior, z, li,
                                                     state, cfg, r.use_pallas)
        else:
            x_post, P_post = _phase_update(x_prior, P_prior, hp, H_xv, H_y,
                                           z, h, li, cfg, r.use_pallas)
    with trace_annotation("sim.hi_rescue", dev):
        h2, vis2, H_xv2, H_y2 = _linearize(x_post, state, cfg)
        S_noR, hp2 = _phase_gates(P_post, H_xv2, H_y2, vis2, 0.0, r.rows)
        hi = association.rescue_high_innovation(z, h2, S_noR, ic & vis2, li,
                                                cfg)
    with trace_annotation("sim.hi_update", dev):
        x_post, P_post = _phase_update(x_post, P_post, hp2, H_xv2, H_y2, z,
                                       h2, hi, cfg, r.use_pallas)
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


def _phase_update(x, P, hp, H_xv, H_y, z, h, slot_mask, cfg: EngineConfig,
                  use_pallas: bool):
    """A phase's update: row form from its H·P rows hp, else column form."""
    if hp is None:
        return masked_update(x, P, H_xv, H_y, z, h, slot_mask, cfg,
                             use_pallas)
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


def _update_slots(slot_mask: torch.Tensor, M: int):
    """The slots a column-form update takes: the M most relevant
    (_gather_slots) when 0 < M < CAP, else every slot in slot order.
    Returns (M, sel (B,M), sel_mask (B,M), take)."""
    B, cap = slot_mask.shape
    if 0 < M < cap:
        return (M, *_gather_slots(slot_mask, M))
    sel = torch.arange(cap, device=slot_mask.device).expand(B, cap)
    return cap, sel.contiguous(), slot_mask, lambda a: a


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


def masked_update(x, P, H_xv, H_y, z, h, slot_mask, cfg: EngineConfig,
                  use_pallas: bool = False, update=None):
    """EKF update over the masked slots (engine.py:482-517), unit noise.
    With 0 < max_update_obs = M < CAP the M most relevant slots are
    gathered, otherwise every slot enters in slot order; their Jacobian
    rows go to the update as blocks (ekf.JacobianBlocks, 2M rows), never
    dense. `update` takes ekf.update's arguments and applies them
    (ekf.update by default, its tail in K5 with the route's use_pallas;
    the row-sharded step's applies them to its slab).
    Returns (x_new, P_new)."""
    update = ekf.update if update is None else update
    B = slot_mask.shape[0]
    M, sel, sel_mask, take = _update_slots(slot_mask, cfg.map.max_update_obs)
    return update(
        x, P, ekf.JacobianBlocks(take(H_xv), take(H_y), sel),
        take(z).reshape(B, 2 * M), take(h).reshape(B, 2 * M),
        sel_mask.repeat_interleave(2, dim=1), None, use_pallas,
        cfg.filter.gain_solver)


def _masked_update_rows(x, P, hp, H_xv, H_y, z, h, slot_mask,
                        cfg: EngineConfig):
    """Row-form masked_update (engine.py:577-599): the M most relevant
    slots (M = max_update_obs, or CAP when M <= 0 or M > CAP), their
    Jacobian rows in block order [u-rows; v-rows] and the same rows of the
    phase's split H·P (hp = (hp_u, hp_v), each (B,CAP,D)), through
    ekf.update_rows. Returns (x_new, P_new)."""
    cap = slot_mask.shape[1]
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
        None, cfg.filter.gain_solver)


def _masked_update_iterated(x, P, z, slot_mask, state: FilterState,
                            cfg: EngineConfig, use_pallas: bool):
    """The Gauss-Newton iterated LI update (engine.py:612-633): the slots
    of masked_update (_update_slots), their rows u,v interleaved; h_fn
    re-linearizes at each iterate through _linearize and gives the
    Jacobian's blocks. Returns (x_new, P_new)."""
    B = slot_mask.shape[0]
    M, sel, sel_mask, take = _update_slots(slot_mask, cfg.map.max_update_obs)

    def h_fn(xi):
        h_i, _, H_xv_i, H_y_i = _linearize(xi, state, cfg)
        return (take(h_i).reshape(B, 2 * M),
                ekf.JacobianBlocks(take(H_xv_i), take(H_y_i), sel))

    return ekf.update_iterated(
        x, P, take(z).reshape(B, 2 * M), h_fn,
        sel_mask.repeat_interleave(2, dim=1), None,
        cfg.filter.iekf_iterations, use_pallas)


def _linearize(x, state: FilterState, cfg: EngineConfig):
    h, visible, hc = measurement.predict_measurements(
        x, state.active, state.cartesian, cfg)
    H_xv, H_y = measurement.jacobians(x, h, hc, state.cartesian, cfg.camera)
    return h, visible, H_xv, H_y


def _compact_gain(x, pht_flat, H_xv, H_y, z, h, slot_mask,
                  cfg: EngineConfig):
    """Gain half of the fused step's compact masked update: gather the M
    most relevant slots, their Jacobian blocks and their P·Hᵀ column pairs
    from pht_flat (B, D, 2·CAP), and solve (S from the rows of those
    columns that the blocks read).
    Returns (x_new un-renormalized, K (B,D,2M), PHt (B,D,2M))."""
    B = slot_mask.shape[0]
    M = cfg.map.max_update_obs
    sel, sel_mask, take = _gather_slots(slot_mask, M)
    cols = (2 * sel[..., None] + torch.arange(2, device=sel.device)
            ).reshape(B, 2 * M)
    D = pht_flat.shape[1]
    PHt_sel = torch.gather(pht_flat, 2, cols[:, None, :].expand(B, D, 2 * M))
    return ekf.update_gain(
        x, None, ekf.JacobianBlocks(take(H_xv), take(H_y), sel),
        take(z).reshape(B, 2 * M), take(h).reshape(B, 2 * M),
        sel_mask.repeat_interleave(2, dim=1), None, cfg.filter.gain_solver,
        PHt_sel)


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
        obs_seq.pixels.shape[0], ("sim", cfg, route(cfg, state.x.device)),
        capture)
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
