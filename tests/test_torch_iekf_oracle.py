"""The engine's iterated EKF update (engine.step with use_iterated_update,
eager on the CPU) held frame by frame to the float64 oracle's
(ekf_slam_tpu_torch/oracle/pipeline.py, oracle.ekf_update_iterated).

The scene is the golden check's (oracle/golden.py GOLDEN's moderate-noise
sim) at CAP 24, B = 2 and 6 frames; the instances share the observations
and differ in RANSAC's uniforms u, and the oracle draws its picks with the
port's own sampler on its own IC mask, as golden.run does.

(a) f64, from the bootstrap, the two sides run apart: the gate counts equal
    every frame, the state's RMSE within the golden check's
    GOLDEN_F64_TOL (1e-6), P within 1e-9 of its Cauchy-Schwarz bound; at
    max_update_obs 16 < CAP (the gathered slots) and 0 (every slot), with
    1 and 3 iterations;
(b) f32, each frame from the engine's own state (as the benchmark's
    sim_f32_iekf.offline_b1024 cell holds it): the counts equal, and the
    camera, state and covariance gaps within that cell's limits;
(c) h_and_jacobian, the iterates' rows, against central differences of h
    at a quaternion off the unit sphere;
(d) with use_iterated_update off, the oracle is the JAX package's copy bit
    for bit on this config, and with one iteration its x after the LI
    update is the plain update's.
"""

import copy
import json
import pathlib

import numpy as np
import pytest
import torch

from ekf_slam_tpu.oracle.pipeline import OracleSLAM as JOracle
from torch_parity import configs

from ekf_slam_tpu_torch.config import CAM_DIM, EngineConfig
from ekf_slam_tpu_torch.filter import engine, ransac
from ekf_slam_tpu_torch.filter.state import init_state
from ekf_slam_tpu_torch.oracle import golden
from ekf_slam_tpu_torch.oracle import oracle as onp
from ekf_slam_tpu_torch.oracle.pipeline import OracleSLAM
from ekf_slam_tpu_torch.sim import simulate

torch.set_num_threads(1)

T, B = 6, 2
FIELDS = ("x", "P", "active", "cartesian", "times_predicted",
          "times_measured", "landmark_id")
LIMITS = pathlib.Path(__file__).resolve().parents[1] / "benchmark" / \
    "limits" / "sim_f32_iekf.offline_b1024.json"


def _config(M: int, iters: int, dtype: str, iterated: bool = True) -> dict:
    return {"filter": {"use_iterated_update": iterated,
                       "iekf_iterations": iters},
            "map": {"capacity": 24, "min_features_in_image": 10,
                    "max_new_per_step": 6, "max_update_obs": M,
                    "delete_min_predictions": 4},
            "ransac": {"num_hypotheses": 16},
            "sim": golden.GOLDEN["sim"], "dtype": dtype}


def _scene(cfg: EngineConfig, seed: int):
    _, _, obs = simulate(torch.Generator().manual_seed(seed), cfg, T, "cpu")
    u = torch.rand(T, B, cfg.ransac.num_hypotheses, dtype=cfg.torch_dtype,
                   generator=torch.Generator().manual_seed(seed + 1))
    return obs, obs.pixels.double().numpy(), obs.visible.numpy(), u


def _padded(state, b: int) -> list:
    return [getattr(state, f)[b].double().numpy() if f in ("x", "P")
            else getattr(state, f)[b].numpy() for f in FIELDS]


def _oracle_frame(orc, pixels, visible, u_b):
    """One oracle frame on frame (pixels, visible) with the port's sampler
    on the draws u_b (1, NHYP); returns the gate counts."""
    z_by = {r.slot: pixels[r.lm_id] for r in orc.recs}
    zv_by = {r.slot: bool(visible[r.lm_id]) for r in orc.recs}
    masks = orc.step(z_by, zv_by, lambda ic: ransac.sample_ic_indices(
        u_b, torch.from_numpy(ic)[None])[0].numpy(), visible, pixels)
    return tuple(int(masks[k].sum()) for k in ("ic", "li", "hi"))


def _gaps(state, b: int, orc) -> tuple:
    """(camera gap, state gap, RMSE, P gap in units of the oracle's
    sqrt(P_ii·P_jj)) of instance b against the oracle, whose slots must be
    the state's."""
    held = OracleSLAM.from_padded(orc.cfg, *_padded(state, b))
    order = sorted(range(len(orc.recs)), key=lambda i: orc.recs[i].slot)
    assert [orc.recs[i].slot for i in order] == [r.slot for r in held.recs]
    assert [orc.recs[i].kind for i in order] == [r.kind for r in held.recs]
    idx = list(range(CAM_DIM))
    for i in order:
        off = orc.offset(i)
        idx += range(off, off + (6 if orc.recs[i].kind == "id" else 3))
    x, P = orc.x[idx], orc.P[np.ix_(idx, idx)]
    d = np.abs(held.x - x)
    var = np.abs(np.diag(P))
    bound = np.sqrt(np.outer(var, var))
    cov = np.abs(held.P - P) / np.maximum(bound, 1e-9 * bound.max())
    return (d[:CAM_DIM].max(), d.max(), float(np.sqrt(np.mean(d ** 2))),
            cov.max())


@pytest.mark.parametrize("iters", [1, 3])
@pytest.mark.parametrize("M", [16, 0])
def test_iekf_step_f64_follows_the_oracle(M, iters):
    cfg = EngineConfig.from_dict(_config(M, iters, "float64"))
    obs, pixels, visible, u = _scene(cfg, 0)
    st = engine.bootstrap(init_state(cfg, B, "cpu"), obs.frame(0), cfg)
    orcs = [OracleSLAM.from_padded(cfg, *_padded(st, b)) for b in range(B)]
    most = 0
    for t in range(1, T):
        st, info = engine.step(st, obs.frame(t), u[t], cfg)
        for b, orc in enumerate(orcs):
            want = _oracle_frame(orc, pixels[t], visible[t], u[t, b:b + 1])
            got = (int(info.n_ic[b]), int(info.n_li[b]), int(info.n_hi[b]))
            assert got == want, (t, b)
            _, _, rmse, cov = _gaps(st, b, orc)
            assert rmse <= golden.GOLDEN_F64_TOL and cov <= 1e-9, (t, b)
            most = max(most, got[1])
    # the LI updates ran with several rows, none cut by the update cap
    assert 4 <= most <= (M or cfg.map.capacity)


def test_iekf_step_f32_within_the_cells_limits():
    with open(LIMITS) as f:
        limits = json.load(f)
    cfg = EngineConfig.from_dict(_config(16, 3, "float32"))
    ocfg = EngineConfig.from_dict(_config(16, 3, "float64"))
    obs, pixels, visible, u = _scene(cfg, 3)
    st = engine.bootstrap(init_state(cfg, B, "cpu"), obs.frame(0), cfg)
    worst = np.zeros(3)
    for t in range(1, T):
        orcs = [OracleSLAM.from_padded(ocfg, *_padded(st, b))
                for b in range(B)]
        st, info = engine.step(st, obs.frame(t), u[t], cfg)
        for b, orc in enumerate(orcs):
            want = _oracle_frame(orc, pixels[t], visible[t], u[t, b:b + 1])
            assert (int(info.n_ic[b]), int(info.n_li[b]),
                    int(info.n_hi[b])) == want, (t, b)
            cam, state, _, cov = _gaps(st, b, orc)
            worst = np.maximum(worst, (cam, state, cov))
    assert worst[0] <= limits["cam_err"]
    assert worst[1] <= limits["state_err"]
    assert worst[2] <= limits["cov_err"]
    # f32 rounding shows: the comparison is not of a float64 run
    assert worst[1] > 1e-9


@pytest.mark.parametrize("cartesian", [False, True])
def test_relinearized_rows_are_the_derivative_of_h(cartesian):
    cam = EngineConfig().camera
    rng = np.random.default_rng(5)
    q = onp.v2q(np.array([0.05, -0.1, 0.02])) * 1.03     # |q| != 1
    x = np.concatenate([[0.1, -0.05, 0.2], q, rng.normal(0, 0.01, 6)])
    y = (np.array([0.3, -0.2, 3.0]) if cartesian
         else np.array([0.05, 0.02, -0.1, 0.1, -0.05, 0.4]))
    _, H_xv, H_y = onp.h_and_jacobian(x, y, cartesian, cam)
    eps = 1e-6
    for block, n, at in ((H_xv, 13, "x"), (H_y, len(y), "y")):
        for k in range(n):
            xp, xm, yp, ym = x.copy(), x.copy(), y.copy(), y.copy()
            if at == "x":
                xp[k] += eps
                xm[k] -= eps
            else:
                yp[k] += eps
                ym[k] -= eps
            fd = (onp.h_and_jacobian(xp, yp, cartesian, cam)[0]
                  - onp.h_and_jacobian(xm, ym, cartesian, cam)[0]) / (2 * eps)
            np.testing.assert_allclose(block[:, k], fd, rtol=1e-6,
                                       atol=1e-6)


def test_oracle_without_iekf_is_jaxs_bit_for_bit():
    jc, tc = configs(_config(16, 3, "float64", iterated=False))
    obs, pixels, visible, u = _scene(tc, 0)
    st = engine.bootstrap(init_state(tc, 1, "cpu"), obs.frame(0), tc)
    j, p = JOracle(jc), OracleSLAM.from_padded(tc, *_padded(st, 0))
    j.x, j.P, j.recs = p.x.copy(), p.P.copy(), copy.deepcopy(p.recs)
    for t in range(1, T):
        out = [_oracle_frame(orc, pixels[t], visible[t], u[t, 0:1])
               for orc in (j, p)]
        assert out[0] == out[1]
        np.testing.assert_array_equal(p.x, j.x)
        np.testing.assert_array_equal(p.P, j.P)
        assert [(r.slot, r.kind, r.times_measured) for r in p.recs] == \
            [(r.slot, r.kind, r.times_measured) for r in j.recs]


def test_one_iteration_moves_x_as_the_plain_update():
    """ekf_update_iterated with one iteration: x is ekf_update's (to
    rounding), P is not (its gain is re-linearized at x_1)."""
    cfg = EngineConfig.from_dict(_config(16, 1, "float64"))
    obs, pixels, visible, u = _scene(cfg, 1)
    st = engine.bootstrap(init_state(cfg, 1, "cpu"), obs.frame(0), cfg)
    st, _ = engine.step(st, obs.frame(1), u[1, :1], cfg)
    orc = OracleSLAM.from_padded(cfg, *_padded(st, 0))
    orc.x, orc.P = onp.predict(orc.x, orc.P, cfg.filter)
    idxs = [i for i, r in enumerate(orc.recs)
            if visible[2, r.lm_id]][:6]
    assert len(idxs) >= 3
    h_fn = orc.relinearized(idxs)
    z = np.concatenate([pixels[2, orc.recs[i].lm_id] for i in idxs])
    h, H = h_fn(orc.x)
    R = np.eye(len(z))
    x1, P1 = onp.ekf_update(orc.x, orc.P, H, R, z, h)
    xi, Pi = onp.ekf_update_iterated(orc.x, orc.P, h_fn, R, z, 1)
    np.testing.assert_allclose(xi, x1, rtol=0, atol=1e-12)
    assert np.abs(Pi - P1).max() > 1e-12
