"""The port's iterated EKF update (filter/ekf.update_iterated and the
engine's LI branch, engine._masked_update_iterated) against the JAX
package's.

(a) ekf.update_iterated on tests/test_parity_extras.py's strongly
nonlinear problem (z = [x0², x1 + x2], a biased prior, r = 1e-4) and on a
problem whose rows move the quaternion, at f64: x and P within 1e-12.
(b) The covariance tail at f64: K4's folded correction and K5's
T·sym(P − K·PHtᵀ)·Tᵀ (their plain versions) against JAX's subtract →
symmetrize → renorm, within 1e-12 (the same math reassociated).
(c) The unfused step with use_iterated_update at f64 over 5 frames, B = 2,
CAP 24, M = 16 < CAP and M = 0 (every slot), 2 and 3 iterations, and
the Newton gain for the HI update: equal n_ic / n_li / n_hi / support
every frame, masks equal, x and P within 1e-10.
(d) bf16 storage: update_iterated on a bf16 P at f32 against its f64
value (within one bf16 ulp plus kernels.SCALED_TOL of each entry's
Cauchy–Schwarz bound) and against JAX's bf16 IEKF.
(e) The kernels an IEKF frame calls: K6 iekf_iterations + 3 times (RANSAC,
each iterate and the final gain, the HI update), K4 twice, or K5 twice with
pallas_update; the row form (EKF_UPDATE=rows) does not take the IEKF, as in
JAX.

On CPU tensors the kernel wrappers run their plain versions."""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_slam_tpu.filter import ekf as jekf
from torch_parity import (FUSED, configs, frame, frame_keys, n, port_obs,
                          port_state, ransac_u, sim_and_bootstrap, step_fn)

from ekf_slam_tpu_torch.filter import ekf, engine
from ekf_slam_tpu_torch.ops import kernels
from ekf_slam_tpu_torch.ops import quaternion as quat

torch.set_num_threads(1)

B = 2
TOL = 1e-12
STEP_TOL = dict(rtol=0, atol=1e-10)
COUNTS = ("n_visible", "n_ic", "n_li", "n_hi", "ransac_support")
MASKS = ("active", "cartesian", "landmark_id", "times_predicted",
         "times_measured")
IEKF = {**FUSED, "filter": {"fused_step": "off",
                            "use_iterated_update": True}}


def _with(d, **sections):
    out = {k: dict(v) if isinstance(v, dict) else v for k, v in d.items()}
    for k, v in sections.items():
        out[k] = {**out.get(k, {}), **v}
    return out


# --- (a) update_iterated on nonlinear problems --------------------------------

def _h(name, xp, x):
    """h of problem `name` at x (..., D), for numpy-like module xp:
    test_parity_extras.py's [x0², x1 + x2], or four rows of which two
    move the quaternion, so the iterate's q leaves the unit sphere and
    the renorm Jacobian matters."""
    rows = [x[..., 0] ** 2, x[..., 1] + x[..., 2]]
    if name == "quaternion":
        rows += [xp.sin(x[..., 3]) * x[..., 8],
                 xp.exp(0.1 * x[..., 20]) + x[..., 5] * x[..., 6]]
    return xp.stack(rows, -1)


def _jac(name, xp, x):
    """(h, H) of problem `name` at x (..., D), H by hand."""
    D = x.shape[-1]
    rows = [[(0, 2 * x[..., 0])], [(1, 1.0), (2, 1.0)]]
    if name == "quaternion":
        rows += [[(3, xp.cos(x[..., 3]) * x[..., 8]),
                  (8, xp.sin(x[..., 3]))],
                 [(20, 0.1 * xp.exp(0.1 * x[..., 20])), (5, x[..., 6]),
                  (6, x[..., 5])]]
    eye = xp.eye(D, dtype=x.dtype)
    one = xp.ones_like(x[..., :1])
    H = xp.stack([sum(eye[j] * (one * (v[..., None] if hasattr(v, "ndim")
                                       else v)) for j, v in row)
                  for row in rows], -2)
    return _h(name, xp, x), H


def _problem(name, seed):
    """Prior x (B,D), P (B,D,D), z (B,M), mask, r for problem `name`."""
    rng = np.random.default_rng(seed)
    if name == "extras":
        D = 13
        x_true = np.zeros(D)
        x_true[3], x_true[0], x_true[1] = 1.0, 1.4, 0.3
        x0 = np.stack([x_true + np.eye(D)[0] * 0.6,
                       x_true + np.eye(D)[0] * 0.4 + 0.01 * np.eye(D)[1]])
        P = np.stack([np.eye(D) * 0.5] * B)
        z = np.stack([np.array([x_true[0] ** 2, x_true[1] + x_true[2]])] * B)
        r = np.full((B, 2), 1e-4)
    else:
        D = 13 + 6 * 4
        q = rng.normal(size=(B, 4))
        x0 = rng.normal(0, 0.5, (B, D))
        x0[:, 3:7] = q / np.linalg.norm(q, axis=1, keepdims=True)
        A = rng.normal(size=(B, D, D))
        P = 0.05 * (A @ A.transpose(0, 2, 1) / D + 0.1 * np.eye(D))
        z = _h(name, np, x0 + rng.normal(0, 0.3, (B, D)))
        r = np.full((B, 4), 1e-3)
    mask = np.ones(z.shape, bool)
    return x0, P, z, mask, r


@pytest.mark.parametrize("masked_row", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("iters", [1, 3, 5])
@pytest.mark.parametrize("name", ["extras", "quaternion"])
def test_update_iterated_matches_jax(name, iters, masked_row):
    x0, P, z, mask, r = _problem(name, 0)
    if masked_row:
        mask[:, 1] = False
    jx, jP = jax.vmap(lambda x, P, z, m, r: jekf.update_iterated(
        x, P, z, lambda xi: _jac(name, jnp, xi), m, r, num_iters=iters))(
        *map(jnp.asarray, (x0, P, z, mask, r)))
    x, Pn = ekf.update_iterated(
        torch.tensor(x0), torch.tensor(P), torch.tensor(z),
        lambda xi: _jac(name, torch, xi), torch.tensor(mask),
        torch.tensor(r), iters)
    np.testing.assert_allclose(n(x), np.asarray(jx), rtol=0, atol=TOL)
    np.testing.assert_allclose(n(Pn), np.asarray(jP), rtol=0, atol=TOL)
    assert torch.equal(Pn, Pn.transpose(1, 2))          # K4: bitwise


def test_update_iterated_beats_one_update_on_the_extras_problem():
    """The claim of test_parity_extras.py in the port: on the nonlinear h
    the IEKF lands closer to the truth (x0 = 1.4) than one EKF step."""
    x0, P, z, mask, r = _problem("extras", 0)
    args = [torch.tensor(a) for a in (x0, P, z, mask, r)]
    x_iekf, _ = ekf.update_iterated(*args[:3], lambda xi: _jac(
        "extras", torch, xi), *args[3:], 5)
    h1, H1 = _jac("extras", torch, args[0])
    x_ekf, _ = ekf.update(args[0], args[1], H1, args[2], h1, args[3],
                          args[4])
    err_iekf = (x_iekf[:, 0] - 1.4).abs()
    assert bool((err_iekf < (x_ekf[:, 0] - 1.4).abs()).all())
    assert float(err_iekf.max()) < 0.02


# --- (b) the covariance tail: K4's and K5's forms vs JAX's ---------------------

def test_tail_forms_equal_jax_subtract_symmetrize_renorm():
    rng = np.random.default_rng(3)
    D, M2 = 13 + 6 * 5, 8
    A = rng.normal(size=(B, D, D))
    P = A @ A.transpose(0, 2, 1) / D + 0.1 * np.eye(D)
    PHt = rng.normal(size=(B, D, M2))
    W = rng.normal(size=(B, M2, M2))
    K = PHt @ (W @ W.transpose(0, 2, 1) / M2 + np.eye(M2)) * 0.1
    x = rng.normal(size=(B, D))
    x[:, 3:7] *= 1.3 / np.linalg.norm(x[:, 3:7], axis=1, keepdims=True)

    def jax_tail(x, P, K, PHt):
        Pn = P - K @ PHt.T
        return jekf._renormalize_quaternion(x, 0.5 * (Pn + Pn.T))

    jx, jP = jax.vmap(jax_tail)(*map(jnp.asarray, (x, P, K, PHt)))
    xt, Pt, Kt, PHtt = map(torch.tensor, (x, P, K, PHt))
    x4, P4 = ekf._update_tail(xt, Pt, Kt, PHtt, use_pallas=False)
    P5 = kernels.fused_update_tail(Pt, Kt, PHtt, quat.norm_jac(xt[:, 3:7]))
    np.testing.assert_allclose(n(x4), np.asarray(jx), rtol=0, atol=TOL)
    for got in (P4, P5):
        np.testing.assert_allclose(n(got), np.asarray(jP), rtol=0, atol=TOL)


# --- (c) the unfused step with the IEKF vs JAX's -------------------------------

@pytest.mark.parametrize("M,iters,solver", [
    (16, 2, "cholesky"), (16, 3, "cholesky"), (0, 2, "cholesky"),
    (0, 3, "cholesky"), (16, 3, "newton")],
    ids=["M_lt_cap-2", "M_lt_cap-3", "every_slot-2", "every_slot-3",
         "newton_hi"])
def test_iekf_step_matches_jax(M, iters, solver):
    """The IEKF inverts S by Cholesky whatever gain_solver says; with the
    Newton gain only the HI update takes it, in both packages."""
    d = _with(IEKF, map={"max_update_obs": M},
              filter={"iekf_iterations": iters, "gain_solver": solver})
    jc, tc = configs(d)
    nh = jc.ransac.num_hypotheses
    _, obs, jst = sim_and_bootstrap(jc, 0, 5, B)
    step = step_fn(jc)
    st = port_state(jst)
    calls = []
    real = ekf.update_iterated
    with mock.patch.object(ekf, "update_iterated",
                           lambda *a: (calls.append(a[-2]), real(*a))[1]):
        for t in range(1, 5):
            keys = frame_keys(t, B)
            jst, jinfo = step(jst, frame(obs, t), keys)
            st, info = engine.step(st, port_obs(frame(obs, t)),
                                   torch.tensor(ransac_u(keys, nh)), tc)
            for f in COUNTS:
                np.testing.assert_array_equal(
                    n(getattr(info, f)), np.asarray(getattr(jinfo, f)),
                    err_msg=f"{f} frame {t}")
            np.testing.assert_allclose(n(st.x), np.asarray(jst.x),
                                       **STEP_TOL)
            np.testing.assert_allclose(n(st.P), np.asarray(jst.P),
                                       **STEP_TOL)
            for f in MASKS:
                np.testing.assert_array_equal(
                    n(getattr(st, f)), np.asarray(getattr(jst, f)),
                    err_msg=f)
    assert calls == [iters] * 4
    assert int(np.asarray(jinfo.n_li).sum()) > 0


# --- (d) bf16 storage -------------------------------------------------------------

def test_update_iterated_bf16_storage():
    x0, P, z, mask, r = _problem("quaternion", 1)
    Pb = torch.tensor(P, dtype=torch.float32).to(torch.bfloat16)
    h_fn = lambda xi: _jac("quaternion", torch, xi)         # noqa: E731
    x, Pn = ekf.update_iterated(torch.tensor(x0, dtype=torch.float32), Pb,
                                torch.tensor(z, dtype=torch.float32), h_fn,
                                torch.tensor(mask),
                                torch.tensor(r, dtype=torch.float32), 3)
    assert Pn.dtype == torch.bfloat16 and x.dtype == torch.float32
    x64, P64 = ekf.update_iterated(torch.tensor(x0), Pb.double(),
                                   torch.tensor(z), h_fn, torch.tensor(mask),
                                   torch.tensor(r), 3)
    assert kernels.scaled_error(Pn, P64) <= kernels.SCALED_TOL
    np.testing.assert_allclose(n(x), n(x64), rtol=0,
                               atol=1e-5 * float(x64.abs().max()))
    jx, jP = jax.vmap(lambda x, P, z, m, r: jekf.update_iterated(
        x, P, z, lambda xi: _jac("quaternion", jnp, xi), m, r,
        num_iters=3))(jnp.asarray(x0, jnp.float32),
                      jnp.asarray(n(Pb.float()), jnp.bfloat16),
                      jnp.asarray(z, jnp.float32), jnp.asarray(mask),
                      jnp.asarray(r, jnp.float32))
    assert jP.dtype == jnp.bfloat16
    jP64 = torch.tensor(np.asarray(jP.astype(jnp.float32)), dtype=torch.float64)
    assert kernels.scaled_error(Pn, jP64) <= kernels.SCALED_TOL
    np.testing.assert_allclose(n(x), np.asarray(jx), rtol=0,
                               atol=1e-5 * float(x64.abs().max()))


# --- (e) the kernels an IEKF frame calls ---------------------------------------

@pytest.mark.parametrize("route", ["cols", "pallas_update", "rows"])
def test_iekf_frame_kernel_calls(route):
    """One IEKF frame (3 iterations) on the CPU: the wrappers it calls and
    how often, as the card's launch counts will read. The K5 route takes
    an f32 x and P, as on the card."""
    d, dtype = IEKF, torch.float64
    if route == "pallas_update":
        d = {**_with(IEKF, filter={"pallas_update": "on"}),
             "dtype": "float32"}
        dtype = torch.float32
    jc, tc = configs(d)
    _, obs, jst = sim_and_bootstrap(jc, 0, 3, B)
    st = port_state(jst, dtype)
    u = torch.tensor(ransac_u(frame_keys(1, B), jc.ransac.num_hypotheses),
                     dtype=dtype)
    with mock.patch.object(ekf, "_UPDATE", route if route == "rows"
                           else "cols"), kernels.capture_operands() as calls:
        _, info = engine.step(st, port_obs(frame(obs, 1), dtype), u, tc)
    assert int(info.n_li.sum()) > 0
    tail = "fused_update_tail" if route == "pallas_update" \
        else "corr_apply_cols"
    got = {k: len(v) for k, v in calls.items()}
    assert got == {"f32_matmul_big": 3 + 3, tail: 2}, got
