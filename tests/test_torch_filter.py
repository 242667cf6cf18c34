"""filter/ modules of the port against the JAX package at f64, on a real
engine state (test_fused_step.py's config, B = 3 instances): the JAX
function is vmapped over the instances, the port takes the batch as is.

Tolerance rtol 1e-10 / atol 1e-12 for floats (the same math in another
summation order); masks, indices and counters exactly equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_slam_tpu.filter import association as jassoc
from ekf_slam_tpu.filter import ekf as jekf
from ekf_slam_tpu.filter import engine as jengine
from ekf_slam_tpu.filter import mapman as jmapman
from ekf_slam_tpu.filter import measurement as jmeas
from ekf_slam_tpu.filter import ransac as jransac
from ekf_slam_tpu.filter.state import init_state as j_init_state
from torch_parity import (FUSED, configs, frame, frame_keys, interpret_mode,
                          n, port_obs, port_state, ransac_u,
                          sim_and_bootstrap, step_fn, t)

from ekf_slam_tpu_torch.filter import association, ekf, engine, mapman
from ekf_slam_tpu_torch.filter import measurement, ransac
from ekf_slam_tpu_torch.filter.state import (init_state, state_from_numpy,
                                             state_to_numpy)

torch.set_num_threads(1)

B = 3
TOL = dict(rtol=1e-10, atol=1e-12)
JC, TC = configs(FUSED)
CAP = TC.map.capacity


def close(got, want, **kw):
    np.testing.assert_allclose(n(got), np.asarray(want), **(kw or TOL))


def equal(got, want):
    np.testing.assert_array_equal(n(got), np.asarray(want))


def vm(fn, *args):
    """The JAX function vmapped over the instance axis (jitted: one compile
    beats op-by-op batching of a long function)."""
    return jax.jit(jax.vmap(fn))(*args)


@pytest.fixture(scope="module")
def world():
    """A JAX state after bootstrap + 2 fused frames, frame 3's obs, and
    the linearization of the state at that point."""
    with interpret_mode():
        _, obs, jst = sim_and_bootstrap(JC, 4, 4, B)
        step = step_fn(JC)
        for k in range(1, 3):
            jst, _ = step(jst, frame(obs, k), frame_keys(k, B))
    o3 = frame(obs, 3)
    z, zv = vm(lambda s: jengine.gather_measurements(s, o3), jst)
    h, vis, hc = vm(lambda x, a, c: jmeas.predict_measurements(x, a, c, JC),
                    jst.x, jst.active, jst.cartesian)
    Hxv, Hy = vm(lambda x, h_, hc_, c: jmeas.jacobians(x, h_, hc_, c,
                                                       JC.camera),
                 jst.x, h, hc, jst.cartesian)
    Ht = vm(jmeas.dense_Ht, Hxv, Hy, vis)
    pht = jnp.einsum("bij,bjk->bik", jst.P, Ht)
    S = vm(lambda p, a, b: jmeas.innovation_covariances_from_pht(
        p.reshape(p.shape[0], CAP, 2), a, b, JC.filter.sigma_z), pht, Hxv, Hy)
    ic = vm(lambda *a: jassoc.individually_compatible(*a, JC),
            z, zv, h, vis, S)
    return dict(jst=jst, st=port_state(jst), obs=o3, z=z, zv=zv, h=h,
                vis=vis, hc=hc, Hxv=Hxv, Hy=Hy, Ht=Ht, pht=pht, S=S, ic=ic)


def test_state_round_trip_and_init(world):
    st = world["st"]
    back = state_from_numpy(state_to_numpy(st), "cpu")
    for k, v in state_to_numpy(back).items():
        np.testing.assert_array_equal(v, state_to_numpy(st)[k])
    j0 = j_init_state(JC)
    p0 = init_state(TC, 2, "cpu")
    for k, v in state_to_numpy(p0).items():
        np.testing.assert_array_equal(v, np.broadcast_to(
            np.asarray(getattr(j0, k)), v.shape), err_msg=k)
    assert p0.P.dtype == torch.float64 and p0.landmark_id.dtype == torch.int32


def test_gather_measurements(world):
    z, zv = engine.gather_measurements(world["st"], port_obs(world["obs"]))
    close(z, world["z"])
    equal(zv, world["zv"])


def test_predict_measurements(world):
    st = world["st"]
    h, vis, hc = measurement.predict_measurements(st.x, st.active,
                                                  st.cartesian, TC)
    close(h, world["h"])
    equal(vis, world["vis"])
    close(hc, world["hc"])
    assert int(vis.sum()) > 0


def test_jacobians(world):
    st = world["st"]
    Hxv, Hy = measurement.jacobians(st.x, t(world["h"]), t(world["hc"]),
                                    st.cartesian, TC.camera)
    close(Hxv, world["Hxv"])
    close(Hy, world["Hy"])


def test_jacobians_match_jacfwd_of_the_prediction(world):
    """H_xv / H_y are the derivatives of h w.r.t. the camera block and the
    slot's own 6 dims (torch.func.jacfwd of predict_measurements)."""
    st = world["st"]
    x = st.x[:1]
    act, cart = st.active[:1], st.cartesian[:1]
    h, vis, hc = measurement.predict_measurements(x, act, cart, TC)
    Hxv, Hy = measurement.jacobians(x, h, hc, cart, TC.camera)
    J = torch.func.jacfwd(lambda v: measurement.predict_measurements(
        v, act, cart, TC)[0])(x)[0, :, :, 0, :]          # (CAP, 2, D)
    for c in torch.nonzero(vis[0]).flatten().tolist():
        np.testing.assert_allclose(n(Hxv[0, c]), n(J[c, :, :13]),
                                   rtol=1e-7, atol=1e-9)
        np.testing.assert_allclose(n(Hy[0, c]),
                                   n(J[c, :, 13 + 6 * c:19 + 6 * c]),
                                   rtol=1e-7, atol=1e-9)


def test_dense_Ht(world):
    close(measurement.dense_Ht(t(world["Hxv"]), t(world["Hy"]),
                               t(world["vis"])), world["Ht"])


def test_compact_dense_H(world):
    sel = np.stack([np.random.default_rng(b).permutation(CAP)[:16]
                    for b in range(B)])
    mask = np.arange(16)[None] < np.array([[5], [16], [0]])
    take = lambda a: np.take_along_axis(
        np.asarray(a), sel.reshape(B, 16, 1, 1), axis=1)
    want = vm(lambda a, b, s, m: jmeas.compact_dense_H(a, b, s, m, CAP),
              take(world["Hxv"]), take(world["Hy"]), sel, mask)
    got = measurement.compact_dense_H(t(take(world["Hxv"])),
                                      t(take(world["Hy"])), t(sel), t(mask),
                                      CAP)
    close(got, want)


def test_innovation_covariances_from_pht(world):
    pht3 = t(world["pht"]).reshape(B, -1, CAP, 2)
    close(measurement.innovation_covariances_from_pht(
        pht3, t(world["Hxv"]), t(world["Hy"]), TC.filter.sigma_z),
        world["S"])


def test_individually_compatible(world):
    ic = association.individually_compatible(
        t(world["z"]), t(world["zv"]), t(world["h"]), t(world["vis"]),
        t(world["S"]), TC)
    equal(ic, world["ic"])
    assert int(ic.sum()) > 0


def test_rescue_high_innovation(world):
    li = np.random.default_rng(0).random((B, CAP)) < 0.3
    S0 = np.asarray(world["S"]) - np.eye(2)          # S without R
    want = vm(lambda *a: jassoc.rescue_high_innovation(*a, JC),
              world["z"], world["h"], S0, world["ic"], li)
    got = association.rescue_high_innovation(
        t(world["z"]), t(world["h"]), t(S0), t(world["ic"]), t(li), TC)
    equal(got, want)


@pytest.mark.parametrize("case", ["random", "singular", "zero"])
def test_solve_2x2_mahalanobis_max_eig(case):
    rng = np.random.default_rng(1)
    S = rng.normal(size=(7, 2, 2))
    S = S @ np.swapaxes(S, 1, 2) + 0.1 * np.eye(2)
    if case == "singular":
        S[:, 1] = S[:, 0]
    elif case == "zero":
        S[:] = 0.0
    v = rng.normal(size=(7, 2))
    close(association._solve_2x2(t(S), t(v)), jassoc._solve_2x2(S, v))
    close(association.mahalanobis2(t(v), t(S)), jassoc.mahalanobis2(v, S))
    close(association.max_eig_2x2(t(S)), jassoc.max_eig_2x2(S))


def test_sample_ic_indices(world):
    keys = frame_keys(9, B)
    nh = JC.ransac.num_hypotheses
    want = vm(lambda k, m: jransac.sample_ic_indices(k, m, nh), keys,
              world["ic"])
    got = ransac.sample_ic_indices(t(ransac_u(keys, nh)), t(world["ic"]))
    equal(got, want)


def test_sample_ic_indices_without_matches():
    """No IC match: the search runs off the end and clamps to the last slot
    (as in JAX; the RANSAC result is masked out by any_ic then)."""
    keys = frame_keys(5, 2)
    ic = np.zeros((2, 5), bool)
    want = vm(lambda k, m: jransac.sample_ic_indices(k, m, 8), keys, ic)
    got = ransac.sample_ic_indices(t(ransac_u(keys, 8)), t(ic))
    equal(got, want)
    assert bool((got == 4).all())


def test_support_residuals_soa(world):
    rng = np.random.default_rng(2)
    x = np.asarray(world["jst"].x)
    x_hyps = x[:, :, None] + 1e-3 * rng.normal(size=x.shape + (9,))
    want = vm(lambda xh, z, c: jransac.support_residuals_soa(xh, z, c, JC),
              x_hyps, world["z"], world["jst"].cartesian)
    got = ransac.support_residuals_soa(t(x_hyps), t(world["z"]),
                                       world["st"].cartesian, TC)
    close(got, want, rtol=1e-9, atol=1e-9)


def test_ransac_run(world):
    keys = frame_keys(11, B)
    jst, vmask = world["jst"], world["vis"][..., None, None]
    want_li, want_sup = vm(
        lambda x, P, z, h, a, b, S, ic, c, k, p: jransac.run(
            x, P, z, h, a, b, S, ic, c, k, JC, pht=p),
        jst.x, jst.P, world["z"], world["h"], world["Hxv"] * vmask,
        world["Hy"] * vmask, world["S"], world["ic"], jst.cartesian, keys,
        world["pht"])
    li, sup = ransac.run(t(jst.x), t(world["z"]), t(world["h"]),
                         t(world["S"]), t(world["ic"]), world["st"].cartesian,
                         t(ransac_u(keys, JC.ransac.num_hypotheses)), TC,
                         t(world["pht"]))
    equal(li, want_li)
    equal(sup, want_sup)
    assert int(li.sum()) > 0


def _managed_state(world):
    """Frame-3 state with a conversion due in every instance (tiny rho
    variance on its first active slot) and a delete due on its last."""
    jst = world["jst"]
    P = np.array(jst.P)
    tp = np.array(jst.times_predicted)
    tm = np.array(jst.times_measured)
    for b in range(B):
        act = np.flatnonzero(np.asarray(jst.active[b]))
        rd = 13 + 6 * act[0] + 5
        P[b, rd, rd] = 1e-8
        tp[b, act[-1]], tm[b, act[-1]] = 9, 1
    return jst.replace(P=jnp.asarray(P), times_predicted=jnp.asarray(tp),
                       times_measured=jnp.asarray(tm))


def test_manage_params(world):
    jst = _managed_state(world)
    want = vm(lambda s: jmapman.manage_params(s, JC), jst)
    got = mapman.manage_params(port_state(jst), TC)
    for f in ("keep_f", "E6", "U6", "C66"):
        close(getattr(got, f), getattr(want, f))
    equal(got.slot, want.slot)
    equal(got.do, want.do)
    assert bool(got.do.all())
    ref = state_to_numpy(got.state)
    for k, v in ref.items():
        if k == "P":
            continue
        np.testing.assert_allclose(v, np.asarray(getattr(want.state, k)),
                                   err_msg=k, **TOL)
    assert int((got.keep_f == 0).sum()) >= 12 * B       # delete + convert


def test_add_params_and_add_features_batch(world):
    jst, o3 = world["jst"], world["obs"]
    n_meas = jnp.zeros(B, jnp.int32)
    uvd, take, lm = vm(lambda s: jengine._init_candidates(s, o3, 0, JC), jst)
    want, want_as = vm(lambda s, u_, tk, l: jmapman.add_params(
        s.P[:13], s, u_, tk, l, JC), jst, uvd, take, lm)
    st = world["st"]
    puvd, ptake, plm = engine._init_candidates(st, port_obs(o3),
                                               t(np.asarray(n_meas)), TC)
    equal(ptake, take)
    equal(plm, lm)
    got, got_as = mapman.add_params(st.P[:, :13], st, puvd, ptake, plm, TC)
    for f in ("keep_f", "E", "U", "C"):
        close(getattr(got, f), getattr(want, f))
    equal(got_as, want_as)
    assert int((got_as >= 0).sum()) > 0
    want_st = vm(lambda s, u_, tk, l: jmapman.add_features_batch(
        s, u_, tk, l, JC)[0], jst, uvd, take, lm)
    got_st = mapman.add_features_batch(st, puvd, ptake, plm, TC)[0]
    for k, v in state_to_numpy(got_st).items():
        np.testing.assert_allclose(v, np.asarray(getattr(want_st, k)),
                                   err_msg=k, **TOL)


def test_in_map_mask(world):
    L = JC.sim.num_landmarks
    want = vm(lambda s: jengine._in_map_mask(s, L), world["jst"])
    equal(engine._in_map_mask(world["st"], L), want)


def test_update_counters(world):
    pred = np.asarray(world["vis"])
    meas = np.asarray(world["ic"])
    want = vm(jmapman.update_counters, world["jst"], pred, meas)
    got = mapman.update_counters(world["st"], t(pred), t(meas))
    equal(got.times_predicted, want.times_predicted)
    equal(got.times_measured, want.times_measured)


@pytest.mark.parametrize("solver", ["cholesky", "newton"])
def test_update_gain(world, solver):
    """The compact gain of the LI update with the first 16 IC slots."""
    jst = world["jst"]
    M = 16
    sel = np.argsort(~np.asarray(world["ic"]), axis=1, kind="stable")[:, :M]
    mask = np.take_along_axis(np.asarray(world["ic"]), sel, axis=1)
    g = lambda a: np.take_along_axis(np.asarray(a), sel.reshape(
        B, M, *([1] * (np.ndim(a) - 2))), axis=1)
    Hc = vm(lambda a, b, s, m: jmeas.compact_dense_H(a, b, s, m, CAP),
            g(world["Hxv"]), g(world["Hy"]), sel, mask)
    cols = (2 * sel[..., None] + np.arange(2)).reshape(B, 2 * M)
    PHt = np.take_along_axis(np.asarray(world["pht"]), cols[:, None, :],
                             axis=2)
    zc, hc = g(world["z"]).reshape(B, -1), g(world["h"]).reshape(B, -1)
    rm = np.repeat(mask, 2, axis=1)
    r = np.ones((B, 2 * M))
    want = vm(lambda x, P, H, z, h, m, r_, p: jekf.update_gain(
        x, P, H, z, h, m, r_, solver, p), jst.x, jst.P, Hc, zc, hc, rm, r,
        PHt)
    got = ekf.update_gain(t(jst.x), None, t(Hc), t(zc), t(hc), t(rm), t(r),
                          solver, t(PHt))
    for g_, w in zip(got, want):
        close(g_, w, rtol=1e-9, atol=1e-11)
    dense = ekf.update_gain(t(jst.x), t(jst.P), t(Hc), t(zc), t(hc), t(rm),
                            t(r), solver)
    for d_, w in zip(dense, want):
        close(d_, w, rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("solver", ["cholesky", "newton"])
def test_spd_inverse(solver):
    rng = np.random.default_rng(3)
    A = rng.normal(size=(2, 12, 12))
    S = A @ np.swapaxes(A, 1, 2) + np.diag(np.logspace(0, 3, 12))
    fn = {"cholesky": (ekf._spd_inverse, jekf._spd_inverse),
          "newton": (ekf._spd_inverse_newton, jekf._spd_inverse_newton)}
    got = fn[solver][0](t(S))
    close(got, vm(fn[solver][1], S), rtol=1e-9, atol=1e-12)
    close(got @ t(S), np.broadcast_to(np.eye(12), S.shape), rtol=0,
          atol=1e-8)
