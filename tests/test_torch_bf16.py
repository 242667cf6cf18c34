"""The bf16-P fast mode (FilterConfig.p_storage="bf16" at float32: P stored
in bfloat16, every product in f32) of the port against the JAX package's.

(a) init_state, state_from_numpy and state_to_numpy carry a bf16 P bit for
bit (a JAX bf16 array converts to numpy's ml_dtypes bfloat16); at float64
p_storage="bf16" is ignored, as in JAX.
(b) One unfused step from the same JAX-stepped bf16 state, column and row
form, the port (plain versions of K4 / K6 / K8) against JAX (its XLA
tails): equal gate counts; P within one bf16 ulp plus 1e-4 of each entry's
Cauchy–Schwarz bound (both round once to bf16 from f32 values that differ
by f32 rounding); x within 1e-5 of max|x|.
(c) tests/test_bf16_storage.py's contract on the port (CAP 40, 12 frames,
the port's own scene): finite, P stays bf16, tracking error below
max(2·f32's, 0.05), diagonal ≥ −1e-3; fused_step="auto" gates bf16 off.
(d) K4's and K6's plain versions on a bf16 P against the Pallas
corr_apply_cols (interpret mode, "highest") and JAX's p_compute(P)·Hᵀ.
(e) The headline-shape twin of test_bf16_storage.py's slow test (CAP 100,
M 24, 16 frames).
(f) step_image at bf16 against JAX's bf16 step_image."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_slam_tpu.filter import ekf as jekf
from ekf_slam_tpu.filter.state import init_state as j_init_state
from ekf_slam_tpu.ops import pallas_kernels as pk
from ekf_slam_tpu.sim import scene as jscene
from ekf_slam_tpu.vision import frontend as jfront
from torch_parity import (FUSED, batch, configs, frame, frame_keys,
                          interpret_mode, n, port_obs, port_state, ransac_u,
                          rows_step_fn, sim_and_bootstrap, step_fn)

from ekf_slam_tpu_torch.filter import ekf, engine
from ekf_slam_tpu_torch.filter.state import (init_state, state_from_numpy,
                                             state_to_numpy)
from ekf_slam_tpu_torch.ops import kernels
from ekf_slam_tpu_torch.sim import simulate
from ekf_slam_tpu_torch.vision import frontend

torch.set_num_threads(1)

B = 2
COUNTS = ("n_visible", "n_ic", "n_li", "n_hi", "ransac_support")
MASKS = ("active", "cartesian", "landmark_id", "times_predicted",
         "times_measured")
# tests/test_fused_step.py's map at the fast mode's settings: bf16 P at
# f32, Newton gain, unfused step.
FAST = {"filter": {"fused_step": "off", "gain_solver": "newton",
                   "p_storage": "bf16"},
        "map": FUSED["map"], "sim": FUSED["sim"], "dtype": "float32"}


def _bits(a):
    """The bf16 bit patterns of a torch or numpy (ml_dtypes) bf16 array."""
    if isinstance(a, torch.Tensor):
        return n(a.view(torch.int16))
    return np.asarray(a).view(np.int16)


# --- (a) the state carries a bf16 P ----------------------------------------

def test_init_state_stores_bf16_as_jax_does():
    jc, tc = configs(FAST)
    st = init_state(tc, B, "cpu")
    assert st.P.dtype == torch.bfloat16 and st.x.dtype == torch.float32
    jst = j_init_state(jc)
    assert jst.P.dtype == jnp.bfloat16
    np.testing.assert_array_equal(_bits(st.P[0]), _bits(jst.P))


def test_bf16_is_ignored_at_float64():
    jc, tc = configs({**FAST, "dtype": "float64"})
    assert init_state(tc, B, "cpu").P.dtype == torch.float64
    assert j_init_state(jc).P.dtype == jnp.float64


def test_state_numpy_round_trip_keeps_bf16_bits():
    """A JAX-stepped bf16 state crosses to the port and back bit for bit."""
    jc, _ = configs(FAST)
    _, obs, jst = sim_and_bootstrap(jc, 0, 3, B)
    jst, _ = step_fn(jc)(jst, frame(obs, 1), frame_keys(1, B))
    assert jst.P.dtype == jnp.bfloat16
    st = port_state(jst, torch.float32)
    assert st.P.dtype == torch.bfloat16 and st.x.dtype == torch.float32
    np.testing.assert_array_equal(_bits(st.P), _bits(jst.P))
    back = state_to_numpy(st)
    assert back["P"].dtype == np.float32
    np.testing.assert_array_equal(
        _bits(jnp.asarray(back["P"], jnp.bfloat16)), _bits(jst.P))
    np.testing.assert_array_equal(back["x"], np.asarray(jst.x))
    again = state_from_numpy({**back, "P": jnp.asarray(back["P"],
                                                       jnp.bfloat16)},
                             "cpu", torch.float32)
    assert torch.equal(again.P, st.P)


# --- (b) one step from the same bf16 state ---------------------------------

@pytest.fixture(scope="module")
def bf16_state():
    """JAX's bf16 state after 2 frames, the observations, config."""
    jc, _ = configs(FAST)
    _, obs, jst = sim_and_bootstrap(jc, 1, 4, B)
    step = step_fn(jc)
    for t in (1, 2):
        jst, _ = step(jst, frame(obs, t), frame_keys(t, B))
    return jc, obs, jst


@pytest.mark.parametrize("form", ["cols", "rows"])
def test_one_bf16_step_matches_jax(bf16_state, form, monkeypatch):
    jc, obs, jst0 = bf16_state
    _, tc = configs(FAST)
    keys = frame_keys(3, B)
    step = step_fn(jc) if form == "cols" else rows_step_fn(jc)[0]
    jst, jinfo = step(jst0, frame(obs, 3), keys)
    monkeypatch.setattr(engine, "UPDATE", form)
    with kernels.capture_operands() as calls:
        st, info = engine.step(port_state(jst0, torch.float32),
                               port_obs(frame(obs, 3), torch.float32),
                               torch.tensor(ransac_u(keys, 64),
                                            dtype=torch.float32), tc)
    tail = "corr_apply" if form == "rows" else "corr_apply_cols"
    assert len(calls[tail]) == 2 and calls[tail][0][0].dtype == torch.bfloat16
    assert jst.P.dtype == jnp.bfloat16 and st.P.dtype == torch.bfloat16
    for f in COUNTS:
        np.testing.assert_array_equal(n(getattr(info, f)),
                                      np.asarray(getattr(jinfo, f)),
                                      err_msg=f)
    for f in MASKS:
        np.testing.assert_array_equal(n(getattr(st, f)),
                                      np.asarray(getattr(jst, f)), err_msg=f)
    assert int(n(info.n_li).sum()) > 0
    ref = torch.tensor(np.asarray(jst.P, np.float64))
    assert kernels.scaled_error(st.P, ref) <= 1e-4
    xj = np.asarray(jst.x)
    np.testing.assert_allclose(n(st.x), xj, rtol=0,
                               atol=1e-5 * np.abs(xj).max())


# --- (c) test_bf16_storage.py's contract ------------------------------------

def _storage_cfg(p_storage, **filt):
    _, tc = configs({
        "filter": {"p_storage": p_storage, "fused_step": "off", **filt},
        "map": {"capacity": 40, "min_features_in_image": 16,
                "max_new_per_step": 16},
        "sim": {"num_landmarks": 48}, "dtype": "float32"})
    return tc


def _port_run(cfg, frames, batch=B):
    _, xs, obs = simulate(torch.Generator().manual_seed(0), cfg, frames,
                          "cpu")
    st = engine.bootstrap(init_state(cfg, batch, "cpu"), obs.frame(0), cfg)
    u = torch.rand(frames, batch, cfg.ransac.num_hypotheses,
                   generator=torch.Generator().manual_seed(1))
    final, traj, infos = engine.run_sequence(st, obs, u, cfg)
    err = torch.linalg.vector_norm(traj[..., :3] - xs[None, :, :3],
                                   dim=-1).mean()
    return final, traj, infos, float(err)


@pytest.mark.parametrize("form", ["cols", "rows"])
def test_bf16_storage_contract(form, monkeypatch):
    monkeypatch.setattr(engine, "UPDATE", form)
    final16, traj16, _, err16 = _port_run(_storage_cfg("bf16"), 12)
    assert final16.P.dtype == torch.bfloat16
    assert bool(torch.isfinite(traj16).all())
    assert bool(torch.isfinite(final16.P.float()).all())
    _, _, _, err32 = _port_run(_storage_cfg("f32"), 12)
    assert err16 < max(2.0 * err32, 0.05), (err16, err32)
    diag = torch.diagonal(final16.P.float(), dim1=1, dim2=2)
    assert bool((diag >= -1e-3).all())


def test_fused_auto_gates_bf16_off():
    cfg = _storage_cfg("bf16")
    cfg = cfg.replace(filter=dataclasses.replace(cfg.filter,
                                                 fused_step="auto"))
    assert not engine.route(cfg, torch.device("cuda")).fused
    assert not engine.route(cfg, torch.device("cpu")).fused


# --- (d) K4 and K6 plain on a bf16 P ----------------------------------------

def _bf16_operands(seed=5, D=157, R=40, N=48):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((B, D, D))
    P = jnp.asarray(X @ X.transpose(0, 2, 1) / D + np.eye(D), jnp.bfloat16)
    A = (rng.standard_normal((B, D, R)) / np.sqrt(R)).astype(np.float32)
    Bf = (rng.standard_normal((B, D, R)) / np.sqrt(R)).astype(np.float32)
    H = rng.standard_normal((B, N, D)).astype(np.float32)
    tP = torch.tensor(np.asarray(P, np.float32)).to(torch.bfloat16)
    return P, tP, A, Bf, H


def test_corr_apply_cols_plain_on_bf16_matches_pallas():
    P, tP, A, Bf, _ = _bf16_operands()
    prec = pk._CORR_PREC
    pk._CORR_PREC = "highest"
    try:
        with interpret_mode():
            want = jax.jit(pk.corr_apply_cols)(P, jnp.asarray(A),
                                               jnp.asarray(Bf))
    finally:
        pk._CORR_PREC = prec
    got = kernels.corr_apply_cols(tP, torch.tensor(A), torch.tensor(Bf))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    want32 = torch.tensor(np.asarray(want, np.float32))
    diff = (got.float() - want32).abs()
    assert bool((diff <= kernels.bf16_ulp(want32)).all()), float(diff.max())
    assert torch.equal(got, got.transpose(1, 2))


def test_matmul_big_plain_on_bf16_matches_jax():
    P, tP, _, _, H = _bf16_operands(6)
    want = jax.vmap(lambda p, h: jekf.p_compute(p) @ h.T)(P, jnp.asarray(H))
    got = kernels.f32_matmul_big(tP, torch.tensor(H).transpose(1, 2)
                                 .contiguous())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_p_compute_and_p_store():
    P = torch.tensor([[1.0, 1 / 3]], dtype=torch.bfloat16)
    assert ekf.p_compute(P).dtype == torch.float32
    assert ekf.p_store(ekf.p_compute(P) / 3, P).dtype == torch.bfloat16
    P64 = torch.ones(2, dtype=torch.float64)
    assert ekf.p_compute(P64) is P64 and ekf.p_store(P64 * 2, P64).dtype \
        == torch.float64


# --- (e) the headline shape -------------------------------------------------

@pytest.mark.slow
def test_bf16_drift_band_headline_shape():
    """CAP 100, M 24, NHYP 64, Newton gain, 16 frames, one instance: the
    bench's 0.2 tracking gate, and bf16 within 2.5x of f32."""
    def cfg(p_storage):
        _, tc = configs({
            "filter": {"gain_solver": "newton", "p_storage": p_storage,
                       "fused_step": "off"},
            "map": {"capacity": 100, "min_features_in_image": 25,
                    "max_new_per_step": 10, "max_update_obs": 24},
            "ransac": {"num_hypotheses": 64},
            "sim": {"num_landmarks": 128}, "dtype": "float32"})
        return tc

    _, _, _, err16 = _port_run(cfg("bf16"), 16, 1)
    _, _, _, err32 = _port_run(cfg("f32"), 16, 1)
    assert np.isfinite(err16) and np.isfinite(err32)
    assert err32 < 0.2 and err16 < 0.2
    assert err16 < 2.5 * max(err32, 0.02), (err16, err32)


# --- (f) the image step at bf16 --------------------------------------------

PIXELS = {
    "map": {"capacity": 24, "min_features_in_image": 10,
            "max_new_per_step": 10},
    "vision": {"search_radius": 10, "min_ncc": 0.4, "max_hamming": 80.0},
    "sim": {"num_landmarks": 40, "depth_min": 2.0, "depth_max": 6.0,
            "v_init": (0.002, 0.0, 0.004), "w_init": (0.0, 0.001, 0.0),
            "traj_accel_std": 2e-4, "traj_alpha_std": 2e-4},
    "filter": {"p_storage": "bf16"},
    "dtype": "float32",
}


def test_step_image_bf16_matches_jax():
    """tests/test_torch_image.py's pixels config at f32 with bf16 P, 3
    frames from both packages' own empty states on JAX's rendered frames:
    equal gate counts every frame, P stays bf16."""
    jc, tc = configs(PIXELS)
    scn, xs, _ = jscene.simulate(jax.random.key(0), jc, 3)
    render = jax.jit(jfront.render_scene_image, static_argnames="cfg")
    step = jax.jit(jax.vmap(
        lambda s, a, im, k: jfront.step_image(s, a, im, k, jc),
        in_axes=(0, 0, None, 0)))
    jst, japp = batch(j_init_state(jc), B), batch(jfront.init_appearance(jc),
                                                  B)
    st = init_state(tc, B, "cpu")
    app = frontend.init_appearance(tc, B, "cpu")
    for i in range(3):
        img = np.asarray(render(scn, xs[i], jc), np.float32)
        keys = jax.random.split(jax.random.key(10 + i), B)
        jst, japp, jinfo = step(jst, japp, jnp.asarray(img), keys)
        st, app, info = frontend.step_image(
            st, app, torch.tensor(img),
            torch.tensor(ransac_u(keys, 64), dtype=torch.float32), tc)
        for f in ("n_visible", "n_ic", "n_li", "n_hi"):
            np.testing.assert_array_equal(n(getattr(info, f)),
                                          np.asarray(getattr(jinfo, f)),
                                          err_msg=f"{f} frame {i}")
    assert st.P.dtype == torch.bfloat16 and jst.P.dtype == jnp.bfloat16
    assert int(n(info.n_li).sum()) > 0


# --- the fast mode's scene --------------------------------------------------

def test_scene0_fast_mode_goes_non_finite_in_both_packages():
    """The port's 16-frame scene 0 (sim.simulate on torch seed 0) at the
    fast mode (CAP 100, M 24, Newton, bf16 P), B = 4, draws from torch seed
    1, frames 0-3 from the port's bootstrap: JAX's engine, handed the same
    observations, state and draws, goes non-finite in the same instance at
    the same frame as the port (instance 3, frame 3). The reference's bf16
    storage, not the port, loses this scene, so the chip runs take the fast
    mode on profile_slice.FAST_SCENE."""
    from unittest import mock

    from ekf_slam_tpu.filter import engine as jengine
    from ekf_slam_tpu.filter import ransac as jransac
    from ekf_slam_tpu_torch.profile_slice import slice_config, slice_inputs

    def sample(u, ic_mask, num):
        """JAX's sample_ic_indices on given draws u (num,)."""
        csum = jnp.cumsum(ic_mask.astype(jnp.int32))
        ranks = jnp.floor(u * jnp.sum(ic_mask)).astype(jnp.int32)
        return jnp.clip(jnp.searchsorted(csum, ranks + 1), 0,
                        ic_mask.shape[0] - 1)

    tc = slice_config("fast")
    jc, _ = configs({"filter": {"fused_step": "off", "gain_solver": "newton",
                                "p_storage": "bf16"},
                     "map": {"capacity": 100, "min_features_in_image": 25,
                             "max_new_per_step": 10, "max_update_obs": 24},
                     "ransac": {"num_hypotheses": 64},
                     "sim": {"num_landmarks": 128}, "dtype": "float32"})
    st, _, obs, u = slice_inputs(tc, "cpu", batch=4, frames=16)
    arrs = state_to_numpy(st)
    jst = j_init_state(jc).replace(**{k: jnp.asarray(
        v, jnp.bfloat16 if k == "P" else None) for k, v in arrs.items()})
    step = jax.jit(jax.vmap(lambda s, o, k: jengine.step(s, o, k, jc),
                            in_axes=(0, None, 0)))
    bad = []
    for t in range(4):
        o = jscene.FrameObs(jnp.asarray(n(obs.pixels[t])),
                            jnp.asarray(n(obs.visible[t])))
        with mock.patch.object(jransac, "sample_ic_indices", sample):
            jst, _ = step(jst, o, jnp.asarray(n(u[t])))
        st, _ = engine.step(st, obs.frame(t), u[t], tc)
        port = ~(torch.isfinite(st.x).all(1)
                 & torch.isfinite(st.P.float()).flatten(1).all(1))
        ref = ~(np.isfinite(np.asarray(jst.x)).all(1) & np.isfinite(
            np.asarray(jst.P, np.float32)).reshape(4, -1).all(1))
        bad.append((t, n(port).nonzero()[0].tolist(),
                    ref.nonzero()[0].tolist()))
    assert bad[2][1:] == ([], []), bad
    assert bad[3][1] == bad[3][2] != [], bad
