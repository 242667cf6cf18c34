"""ops/quaternion, ops/camera, filter/motion and the simulator's geometry of
the port against the JAX package at f64, and the port's analytic
Jacobians against torch.func.jacfwd of its own functions.

Tolerance: rtol 1e-12 (atol 1e-14 for entries at zero) against JAX — the
same formulas in f64, differing only in the last bits of transcendental
and summation order. Jacobians against forward-mode autodiff: rtol 1e-10
(1e-8 through the 10-step Newton distortion solve, which the analytic
inverse matches only up to the solve's convergence)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

from ekf_slam_tpu import config as jcfg
from ekf_slam_tpu.filter import motion as jmot
from ekf_slam_tpu.ops import camera as jcam
from ekf_slam_tpu.ops import quaternion as jq
from ekf_slam_tpu.sim import scene as jscene
from ekf_slam_tpu_torch import config as tcfg
from ekf_slam_tpu_torch.filter import motion as tmot
from ekf_slam_tpu_torch.ops import camera as tcam
from ekf_slam_tpu_torch.ops import quaternion as tq
from ekf_slam_tpu_torch.sim import scene as tscene

torch.set_num_threads(1)

RTOL, ATOL = 1e-12, 1e-14
CAM_J, CAM_T = jcfg.CameraConfig(), tcfg.CameraConfig()


def _quat(rng, n=6):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _pixels(rng, n=6):
    return rng.uniform([5.0, 5.0], [315.0, 235.0], size=(n, 2))


def _points(rng, n=6):
    return np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                     rng.uniform(1, 5, n)], axis=1)


def _omega(rng, n=6):
    w = rng.normal(scale=0.05, size=(n, 3))
    w[0] = 0.0            # the Taylor-safe branch
    w[1:2] = 1e-16        # below v2q's eps
    return w


# name -> (fn(Q, C, cam, *inputs), inputs from a numpy Generator)
CASES = {
    "qprod": (lambda Q, C, cam, a, b: Q.qprod(a, b),
              lambda r: (_quat(r), _quat(r))),
    "qconj": (lambda Q, C, cam, a: Q.qconj(a), lambda r: (_quat(r),)),
    "q2r": (lambda Q, C, cam, a: Q.q2r(a), lambda r: (_quat(r),)),
    "v2q": (lambda Q, C, cam, w: Q.v2q(w), lambda r: (_omega(r),)),
    "azel_to_ray": (lambda Q, C, cam, a, b: Q.azel_to_ray(a, b),
                    lambda r: (r.uniform(-1, 1, 6), r.uniform(-1, 1, 6))),
    "dm_dtheta": (lambda Q, C, cam, a, b: Q.dm_dtheta(a, b),
                  lambda r: (r.uniform(-1, 1, 6), r.uniform(-1, 1, 6))),
    "dm_dphi": (lambda Q, C, cam, a, b: Q.dm_dphi(a, b),
                lambda r: (r.uniform(-1, 1, 6), r.uniform(-1, 1, 6))),
    "norm_jac": (lambda Q, C, cam, a: Q.norm_jac(a),
                 lambda r: (1.3 * _quat(r),)),
    "left_mult_matrix": (lambda Q, C, cam, a: Q.left_mult_matrix(a),
                         lambda r: (_quat(r),)),
    "right_mult_matrix": (lambda Q, C, cam, a: Q.right_mult_matrix(a),
                          lambda r: (_quat(r),)),
    "dqomegadt_by_domega": (
        lambda Q, C, cam, w: Q.dqomegadt_by_domega(w, 1.0),
        lambda r: (_omega(r),)),
    "dRq_times_a_by_dq": (lambda Q, C, cam, q, a: Q.dRq_times_a_by_dq(q, a),
                          lambda r: (_quat(r), r.normal(size=(6, 3)))),
    "project": (lambda Q, C, cam, p: C.project(p, cam),
                lambda r: (_points(r),)),
    "undistort": (lambda Q, C, cam, p: C.undistort(p, cam),
                  lambda r: (_pixels(r),)),
    "distort": (lambda Q, C, cam, p: C.distort(p, cam),
                lambda r: (_pixels(r),)),
    "jacob_undistort": (lambda Q, C, cam, p: C.jacob_undistort(p, cam),
                        lambda r: (_pixels(r),)),
    "jacob_distort": (lambda Q, C, cam, p: C.jacob_distort(p, cam),
                      lambda r: (_pixels(r),)),
    "dhu_dhrl": (lambda Q, C, cam, p: C.dhu_dhrl(p, cam),
                 lambda r: (_points(r),)),
    "back_project_inverse_depth": (
        lambda Q, C, cam, p, t, q: C.back_project_inverse_depth(
            p, t, q, 1.0, cam),
        lambda r: (_pixels(r), r.normal(size=(6, 3)), _quat(r))),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_ops_match_jax(name):
    fn, build = CASES[name]
    inputs = build(np.random.default_rng(sorted(CASES).index(name)))
    want = fn(jq, jcam, CAM_J, *(jnp.asarray(a) for a in inputs))
    got = fn(tq, tcam, CAM_T, *(torch.tensor(a) for a in inputs))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_dqbar_dq():
    np.testing.assert_array_equal(tq.dqbar_dq(torch.float64).numpy(),
                                  np.asarray(jq.dqbar_dq(jnp.float64)))


def _camera_states(rng, n=5):
    xv = np.concatenate([rng.normal(size=(n, 3)), _quat(rng, n),
                         rng.normal(scale=0.02, size=(n, 3)),
                         _omega(rng, n)], axis=1)
    return xv


MODELS = [tcfg.CONSTANT_VELOCITY, tcfg.CONSTANT_ORIENTATION,
          tcfg.CONSTANT_POSITION, tcfg.CONSTANT_POSITION_AND_ORIENTATION]


@pytest.mark.parametrize("fn", ["fv", "dfv_by_dxv", "process_noise"])
@pytest.mark.parametrize("model", MODELS)
def test_motion_matches_jax(fn, model):
    xv = _camera_states(np.random.default_rng(model))
    want = getattr(jmot, fn)(jnp.asarray(xv),
                             jcfg.FilterConfig(motion_model=model))
    got = getattr(tmot, fn)(torch.tensor(xv),
                            tcfg.FilterConfig(motion_model=model))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


# --- analytic Jacobians against forward-mode autodiff ------------------------

def _jac_cases():
    rng = np.random.default_rng(7)
    q = torch.tensor(_quat(rng, 1)[0])
    p = torch.tensor(_quat(rng, 1)[0])
    a = torch.tensor(rng.normal(size=3))
    w = torch.tensor([0.03, -0.02, 0.05], dtype=torch.float64)
    uv = torch.tensor(_pixels(rng, 1)[0])
    pt = torch.tensor(_points(rng, 1)[0])
    th, ph = torch.tensor(0.3, dtype=torch.float64), torch.tensor(
        -0.2, dtype=torch.float64)
    return {
        "norm_jac": (tq.norm_jac(1.3 * q),
                     jacfwd(lambda v: v / torch.linalg.vector_norm(v))(
                         1.3 * q), 1e-10),
        "dqomegadt_by_domega": (tq.dqomegadt_by_domega(w, 1.0),
                                jacfwd(lambda v: tq.v2q(v * 1.0))(w), 1e-10),
        "dRq_times_a_by_dq": (tq.dRq_times_a_by_dq(q, a),
                              jacfwd(lambda v: tq.q2r(v) @ a)(q), 1e-10),
        "left_mult_matrix": (tq.left_mult_matrix(q),
                             jacfwd(lambda v: tq.qprod(q, v))(p), 1e-10),
        "right_mult_matrix": (tq.right_mult_matrix(p),
                              jacfwd(lambda v: tq.qprod(v, p))(q), 1e-10),
        "dm_dtheta": (tq.dm_dtheta(th, ph),
                      jacfwd(lambda v: tq.azel_to_ray(v, ph))(th), 1e-10),
        "dm_dphi": (tq.dm_dphi(th, ph),
                    jacfwd(lambda v: tq.azel_to_ray(th, v))(ph), 1e-10),
        "jacob_undistort": (tcam.jacob_undistort(uv, CAM_T),
                            jacfwd(lambda v: tcam.undistort(v, CAM_T))(uv),
                            1e-10),
        "jacob_distort": (tcam.jacob_distort(uv, CAM_T),
                          jacfwd(lambda v: tcam.distort(v, CAM_T))(
                              tcam.undistort(uv, CAM_T)), 1e-8),
        "dhu_dhrl": (tcam.dhu_dhrl(pt, CAM_T),
                     jacfwd(lambda v: tcam.project(v, CAM_T))(pt), 1e-10),
    }


JAC_NAMES = ["dRq_times_a_by_dq", "dhu_dhrl", "dm_dphi", "dm_dtheta",
             "dqomegadt_by_domega", "jacob_distort", "jacob_undistort",
             "left_mult_matrix", "norm_jac", "right_mult_matrix"]


@pytest.mark.parametrize("name", JAC_NAMES)
def test_jacobian_matches_jacfwd(name):
    cases = _jac_cases()
    assert sorted(cases) == JAC_NAMES
    analytic, auto, rtol = cases[name]
    np.testing.assert_allclose(analytic.numpy(), auto.numpy(), rtol=rtol,
                               atol=1e-12)


@pytest.mark.parametrize("model", MODELS)
def test_dfv_by_dxv_matches_jacfwd(model):
    f = tcfg.FilterConfig(motion_model=model)
    xv = torch.tensor(_camera_states(np.random.default_rng(3), 1)[0])
    xv[10:13] = torch.tensor([0.03, -0.01, 0.02])
    np.testing.assert_allclose(
        tmot.dfv_by_dxv(xv, f).numpy(),
        jacfwd(lambda v: tmot.fv(v, f))(xv).numpy(), rtol=1e-10, atol=1e-12)


# --- simulator geometry -----------------------------------------------------

NOISELESS = {"pixel_noise_std": 0.0, "outlier_fraction": 0.0,
             "traj_accel_std": 0.0, "traj_alpha_std": 0.0}


def _noiseless_cfgs():
    jc = jcfg.EngineConfig(sim=jcfg.SimConfig(**NOISELESS), dtype="float64")
    tc = tcfg.EngineConfig.from_dict({"sim": NOISELESS, "dtype": "float64"})
    return jc, tc


def test_simulate_trajectory_noiseless_matches_jax():
    jc, tc = _noiseless_cfgs()
    want = jscene.simulate_trajectory(jax.random.key(0), jc, 12)
    got = tscene.simulate_trajectory(torch.Generator().manual_seed(0), tc, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_observe_noiseless_matches_jax():
    jc, tc = _noiseless_cfgs()
    scene = jscene.make_scene(jax.random.key(1), jc)
    xs = jscene.simulate_trajectory(jax.random.key(2), jc, 6)
    tscene_ = tscene.Scene(torch.tensor(np.asarray(scene.landmarks)))
    gen = torch.Generator().manual_seed(0)
    for t in range(6):
        want = jscene.observe(jax.random.key(3 + t), scene, xs[t], jc)
        got = tscene.observe(gen, tscene_, torch.tensor(np.asarray(xs[t])),
                             tc)
        np.testing.assert_array_equal(got.visible.numpy(),
                                      np.asarray(want.visible))
        np.testing.assert_allclose(got.pixels.numpy(),
                                   np.asarray(want.pixels), rtol=RTOL,
                                   atol=1e-12)


def test_make_scene_inside_initial_frustum():
    """Landmarks are back-projections of pixels in the central 70% of the
    image at depths in [depth_min, depth_max] — as in JAX, by construction
    (the draws themselves differ)."""
    _, tc = _noiseless_cfgs()
    lm = tscene.make_scene(torch.Generator().manual_seed(4), tc).landmarks
    s, cam = tc.sim, tc.camera
    assert lm.shape == (s.num_landmarks, 3)
    assert bool(((lm[:, 2] >= s.depth_min) & (lm[:, 2] <= s.depth_max)).all())
    px = tcam.distort(tcam.project(lm, cam), cam)
    tol = 1e-9
    assert bool((px[:, 0] >= 0.15 * cam.n_cols - tol).all()
                and (px[:, 0] <= 0.85 * cam.n_cols + tol).all()
                and (px[:, 1] >= 0.15 * cam.n_rows - tol).all()
                and (px[:, 1] <= 0.85 * cam.n_rows + tol).all())


def test_simulate_shapes_and_dtypes():
    tc = tcfg.EngineConfig.from_dict({"sim": {"num_landmarks": 16}})
    scene, xs, obs = tscene.simulate(torch.Generator().manual_seed(0), tc, 5,
                                        "cpu")
    assert scene.landmarks.shape == (16, 3)
    assert xs.shape == (5, 13) and xs.dtype == torch.float32
    assert obs.pixels.shape == (5, 16, 2) and obs.pixels.dtype == torch.float32
    assert obs.visible.shape == (5, 16) and obs.visible.dtype == torch.bool
    assert obs.frame(2).pixels.shape == (16, 2)
    assert obs.window(1, 3).visible.shape == (2, 16)
