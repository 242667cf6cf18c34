"""The port's unfused SLAM step against the float64 NumPy oracle
(ekf_slam_tpu.oracle.pipeline.OracleSLAM): the port of
tests/test_golden_pipeline.py.

The oracle is a sequential, dynamic-shape implementation of the whole
frame — map management (delete + convert), predict, association, 1-point
RANSAC, LI update, HI rescue and update, counters, inverse-depth feature
init — independent of both packages. The port runs its unfused step at
f64 on the CPU (the kernels' plain versions), B = 1, on the JAX file's
config (CAP 20, max_update_obs 0: full-width updates, NHYP 16, a
moderate-noise scene) and on observations JAX simulates from key(4), as
arrays. Both consume the same RANSAC picks: the port's step takes the
uniforms u of jax.random.key(300 + t) (torch_parity.ransac_u), and the
oracle's picks_fn draws with the port's own sampler
(ransac.sample_ic_indices) on those u and its own IC mask. At t = T // 2
one inverse-depth feature is forced to convert to cartesian on both sides.

Gates: n_ic, n_li, n_hi and RANSAC support equal every frame; RMSE
<= 1e-6 over the camera state and every live feature at the end (and
1e-9 after the bootstrap). T = 10 in tier-1 (it reaches the conversion at
t = 5), T = 24 under -m slow, as in the JAX file."""

import jax
import numpy as np
import pytest
import torch

import ekf_slam_tpu.oracle.oracle as onp
from ekf_slam_tpu.oracle.pipeline import OracleSLAM, Rec
from ekf_slam_tpu.sim import simulate
from torch_parity import configs, ransac_u

from ekf_slam_tpu_torch.config import CAM_DIM
from ekf_slam_tpu_torch.filter import engine, ransac
from ekf_slam_tpu_torch.filter.state import init_state
from ekf_slam_tpu_torch.sim.scene import FrameObs

torch.set_num_threads(1)

# tests/test_golden_pipeline.py's _cfg(): the moderate-noise scene of a
# healthy filter, full-width updates.
GOLDEN = {
    "map": {"capacity": 20, "min_features_in_image": 10,
            "max_new_per_step": 6, "max_update_obs": 0,
            "delete_min_predictions": 4},
    "ransac": {"num_hypotheses": 16},
    "sim": {"num_landmarks": 28, "depth_min": 2.0, "depth_max": 6.0,
            "pixel_noise_std": 0.5, "outlier_fraction": 0.05,
            "v_init": (0.003, 0.0, 0.005), "w_init": (0.0, 0.002, 0.0),
            "traj_accel_std": 3e-4, "traj_alpha_std": 3e-4},
    "dtype": "float64",
}


def _frame(pixels, visible, t):
    return FrameObs(torch.tensor(pixels[t]), torch.tensor(visible[t]))


def _oracle_bootstrap(jc, pixels0, visible0):
    """The oracle after the engine's bootstrap: stage 8 only (feature init
    from frame 0), as in the JAX file."""
    orc = OracleSLAM(jc)
    m = jc.map
    order = np.argsort(~visible0, kind="stable")
    for k, j in enumerate(order[:m.max_new_per_step]):
        if not visible0[j]:
            continue
        uvd = pixels0[j]
        orc.P = onp.add_feature_covariance_inverse_depth(
            orc.P, uvd, orc.x[0:13], jc.filter.sigma_z, m.std_rho,
            jc.camera)
        orc.x = np.concatenate([
            orc.x, onp.hinv(uvd, orc.x[0:13], jc.camera, m.initial_rho)])
        orc.recs.append(Rec(k, int(j)))
    return orc


def _rmse(st, orc):
    """RMSE of the port's padded state against the oracle's compact one
    through the slot map; the slot sets must agree."""
    x = st.x[0].numpy()
    errs = [x[:CAM_DIM] - orc.x[:CAM_DIM]]
    slots = x[CAM_DIM:].reshape(-1, 6)
    by_slot = orc.by_slot()
    assert set(np.flatnonzero(st.active[0].numpy())) == set(by_slot)
    for s, i in by_slot.items():
        v = orc.rec_value(i)
        errs.append(slots[s][:len(v)] - v)
        if orc.recs[i].kind == "c":
            np.testing.assert_allclose(slots[s][3:], 0.0, atol=1e-12)
    return float(np.sqrt(np.mean(np.concatenate(errs) ** 2)))


@pytest.mark.parametrize("T", [10, pytest.param(24, marks=pytest.mark.slow)])
def test_unfused_step_matches_the_f64_oracle(T):
    jc, tc = configs(GOLDEN)
    nh = tc.ransac.num_hypotheses
    _, _, obs = simulate(jax.random.key(4), jc, T)
    pixels = np.asarray(obs.pixels, np.float64)          # (T, L, 2)
    visible = np.asarray(obs.visible)                    # (T, L)

    st = engine.bootstrap(init_state(tc, 1, "cpu"), _frame(pixels, visible, 0),
                          tc)
    orc = _oracle_bootstrap(jc, pixels[0], visible[0])
    assert _rmse(st, orc) < 1e-9

    for t in range(1, T):
        u = torch.tensor(ransac_u(jax.random.key(300 + t)[None], nh))
        if t == T // 2:
            # Force one inverse-depth -> cartesian conversion on both
            # sides: shrink the lowest active slot's rho variance.
            slot = int(np.flatnonzero(st.active[0].numpy()
                                      & ~st.cartesian[0].numpy())[0])
            rd = CAM_DIM + 6 * slot + 5
            st.P[0, rd, rd] = 1e-6
            off = orc.offset(orc.by_slot()[slot]) + 5
            orc.P[off, off] = 1e-6
        # The oracle's inputs by pre-manage slot (gather_measurements).
        z_by = {r.slot: pixels[t, r.lm_id] for r in orc.recs}
        zv_by = {r.slot: bool(visible[t, r.lm_id]) for r in orc.recs}

        def picks_fn(ic_padded):
            return ransac.sample_ic_indices(
                u, torch.tensor(ic_padded)[None])[0].numpy()

        st, info = engine.step(st, _frame(pixels, visible, t), u, tc)
        masks = orc.step(z_by, zv_by, picks_fn, visible[t], pixels[t])
        assert int(info.n_ic) == int(masks["ic"].sum()), t
        assert int(info.n_li) == int(masks["li"].sum()), t
        assert int(info.n_hi) == int(masks["hi"].sum()), t
        assert (int(info.ransac_support) == max(int(masks["support"]), 0)
                or int(masks["ic"].sum()) == 0), t

    assert any(r.kind == "c" for r in orc.recs), "conversion never exercised"
    assert int(st.cartesian.sum()) >= 1
    assert _rmse(st, orc) < 1e-6
