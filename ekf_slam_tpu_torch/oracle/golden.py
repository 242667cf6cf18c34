"""The port's unfused SLAM step held against the float64 oracle, frame by
frame: the check of tests/test_golden_pipeline.py, on the port's own
scene, at any dtype and on any device.

The config is that test's (``GOLDEN``: CAP 20, max_update_obs 0 — full
width updates —, NHYP 16, the moderate-noise scene of a healthy filter).
``run`` simulates it with the port's ``sim.simulate`` from a generator
seeded ``seed`` and bootstraps B instances on frame 0; the instances share
the observations and differ in RANSAC's uniforms u (T, B, NHYP), drawn
from a generator seeded ``seed + 1``. Each instance is held against its
own ``OracleSLAM`` at f64 on the host, fed the same observations (the
simulated pixels as f64) and the same RANSAC picks: the oracle's
``picks_fn`` draws with the port's own sampler
(``ransac.sample_ic_indices``) on that instance's u and the oracle's IC
mask. At frame T // 2 one inverse-depth feature of every instance is
forced to convert to cartesian on both sides (its ρ variance set to
1e-6).

``run`` returns both sides' gate counts of every frame and the RMSE over
the camera state and every live feature after every frame (NaN where the
two sides' slot sets differ). The gates (counts equal, RMSE within the
dtype's tolerance) are the caller's: ``GOLDEN_F64_TOL`` at f64 (the JAX
test's), ``GOLDEN_F32_TOL`` at f32 (set from a CPU reading, below).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ekf_slam_tpu_torch.config import CAM_DIM, EngineConfig
from ekf_slam_tpu_torch.filter import engine, ransac
from ekf_slam_tpu_torch.filter.state import init_state
from ekf_slam_tpu_torch.oracle import oracle as onp
from ekf_slam_tpu_torch.oracle.pipeline import OracleSLAM, Rec
from ekf_slam_tpu_torch.sim import simulate

# tests/test_golden_pipeline.py's _cfg(): the moderate-noise scene of a
# healthy filter, full-width updates. The unfused step on every device
# (the fused one takes no full-width update).
GOLDEN = {
    "filter": {"fused_step": "off"},
    "map": {"capacity": 20, "min_features_in_image": 10,
            "max_new_per_step": 6, "max_update_obs": 0,
            "delete_min_predictions": 4},
    "ransac": {"num_hypotheses": 16},
    "sim": {"num_landmarks": 28, "depth_min": 2.0, "depth_max": 6.0,
            "pixel_noise_std": 0.5, "outlier_fraction": 0.05,
            "v_init": (0.003, 0.0, 0.005), "w_init": (0.0, 0.002, 0.0),
            "traj_accel_std": 3e-4, "traj_alpha_std": 3e-4},
}
COUNTS = ("n_ic", "n_li", "n_hi", "support")
# The golden gate at f64 (BASELINE.json: trajectory RMSE <= 1e-6).
GOLDEN_F64_TOL = 1e-6
# The gate at f32: F32_MARGIN times the largest RMSE of the f32 unfused
# step on the CPU over seeds 0-3, B = 4, T = 10, each over the frames
# before its counts part from the oracle's (tests/test_torch_oracle.py
# measures it: 3.738e-5, seed 0, the last frame), rounded up. The margin
# covers the card's other summation order.
F32_MARGIN = 10
GOLDEN_F32_TOL = 4e-4


def golden_config(dtype: str = "float64") -> EngineConfig:
    return EngineConfig.from_dict({**GOLDEN, "dtype": dtype})


def oracle_bootstrap(cfg: EngineConfig, pixels0, visible0) -> OracleSLAM:
    """The oracle after the engine's bootstrap: stage 8 only (feature init
    from frame 0), as tests/test_golden_pipeline.py builds it. cfg at
    f64; pixels0 (L, 2), visible0 (L,) numpy."""
    orc = OracleSLAM(cfg)
    m = cfg.map
    order = np.argsort(~visible0, kind="stable")
    for k, j in enumerate(order[:m.max_new_per_step]):
        if not visible0[j]:
            continue
        uvd = pixels0[j]
        orc.P = onp.add_feature_covariance_inverse_depth(
            orc.P, uvd, orc.x[0:13], cfg.filter.sigma_z, m.std_rho,
            cfg.camera)
        orc.x = np.concatenate([
            orc.x, onp.hinv(uvd, orc.x[0:13], cfg.camera, m.initial_rho)])
        orc.recs.append(Rec(k, int(j)))
    return orc


def rmse(x: np.ndarray, active: np.ndarray, cartesian: np.ndarray,
         orc: OracleSLAM) -> float:
    """RMSE of one instance's padded state x (D,) against the oracle's
    compact one through the slot map; NaN if the slot sets or the
    parametrizations differ."""
    errs = [x[:CAM_DIM] - orc.x[:CAM_DIM]]
    slots = x[CAM_DIM:].reshape(-1, 6)
    by_slot = orc.by_slot()
    if set(np.flatnonzero(active).tolist()) != set(by_slot):
        return float("nan")
    for s, i in by_slot.items():
        v = orc.rec_value(i)
        errs.append(slots[s][:len(v)] - v)
        if bool(cartesian[s]) != (orc.recs[i].kind == "c"):
            return float("nan")
    return float(np.sqrt(np.mean(np.concatenate(errs) ** 2)))


@dataclasses.dataclass
class GoldenRun:
    """port / oracle: {count: (T-1, B) int} of frames 1..T-1; rmse
    (T, B), frame 0 the bootstrap; converted (B,) whether the oracle holds
    a cartesian feature at the end."""
    port: dict
    oracle: dict
    rmse: np.ndarray
    converted: np.ndarray

    def first_parting(self) -> int | None:
        """The first frame (1..T-1) at which a count differs in any
        instance, or None."""
        same = np.all([self.port[k] == self.oracle[k] for k in COUNTS],
                      axis=(0, 2))
        bad = np.flatnonzero(~same)
        return int(bad[0]) + 1 if bad.size else None


def run(dtype: str, frames: int, batch: int, seed: int,
        device) -> GoldenRun:
    """Drive the port's step and B oracles over `frames` frames of the
    golden scene; see the module docstring."""
    cfg = golden_config(dtype)
    ocfg = golden_config("float64")
    nh = cfg.ransac.num_hypotheses
    _, _, obs = simulate(torch.Generator().manual_seed(seed), cfg, frames,
                         device)
    pixels = obs.pixels.cpu().double().numpy()           # (T, L, 2)
    visible = obs.visible.cpu().numpy()                  # (T, L)
    u = torch.rand(frames, batch, nh, dtype=cfg.torch_dtype,
                   generator=torch.Generator().manual_seed(seed + 1))
    u_dev = u.to(device)

    st = engine.bootstrap(init_state(cfg, batch, device), obs.frame(0), cfg)
    orcs = [oracle_bootstrap(ocfg, pixels[0], visible[0])
            for _ in range(batch)]
    port = {k: np.zeros((frames - 1, batch), np.int64) for k in COUNTS}
    orac = {k: np.zeros((frames - 1, batch), np.int64) for k in COUNTS}
    err = np.full((frames, batch), np.nan)

    def record(t):
        x = st.x.cpu().double().numpy()
        act, cart = st.active.cpu().numpy(), st.cartesian.cpu().numpy()
        for b, orc in enumerate(orcs):
            err[t, b] = rmse(x[b], act[b], cart[b], orc)

    record(0)
    for t in range(1, frames):
        if t == frames // 2:
            # One inverse-depth -> cartesian conversion on both sides: the
            # lowest active inverse-depth slot's rho variance shrunk.
            live = st.active & ~st.cartesian
            for b, orc in enumerate(orcs):
                slot = int(torch.nonzero(live[b])[0, 0])
                rd = CAM_DIM + 6 * slot + 5
                st.P[b, rd, rd] = 1e-6
                off = orc.offset(orc.by_slot()[slot]) + 5
                orc.P[off, off] = 1e-6
        st, info = engine.step(st, obs.frame(t), u_dev[t], cfg)
        for k, f in zip(COUNTS, ("n_ic", "n_li", "n_hi", "ransac_support")):
            port[k][t - 1] = getattr(info, f).cpu().numpy()
        for b, orc in enumerate(orcs):
            # The oracle's inputs by pre-manage slot (gather_measurements).
            z_by = {r.slot: pixels[t, r.lm_id] for r in orc.recs}
            zv_by = {r.slot: bool(visible[t, r.lm_id]) for r in orc.recs}
            ub = u[t, b:b + 1]

            def picks_fn(ic_padded, ub=ub):
                return ransac.sample_ic_indices(
                    ub, torch.from_numpy(ic_padded)[None])[0].numpy()

            masks = orc.step(z_by, zv_by, picks_fn, visible[t], pixels[t])
            n_ic = int(masks["ic"].sum())
            orac["n_ic"][t - 1, b] = n_ic
            orac["n_li"][t - 1, b] = int(masks["li"].sum())
            orac["n_hi"][t - 1, b] = int(masks["hi"].sum())
            # Without an IC match the port's RANSAC is masked out (support
            # 0) where the oracle reports -1.
            orac["support"][t - 1, b] = (max(int(masks["support"]), 0)
                                         if n_ic else
                                         port["support"][t - 1, b])
        record(t)
    converted = np.array([any(r.kind == "c" for r in o.recs) for o in orcs])
    return GoldenRun(port, orac, err, converted)
