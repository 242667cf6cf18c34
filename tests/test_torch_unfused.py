"""The port's unfused SLAM step (engine.step_core + initialize_features)
against the JAX engine's, and the dispatch between the two steps.

The JAX side runs engine.step with fused_step="off", jitted and vmapped
over the batch; the port runs on CPU tensors, i.e. through the kernels'
plain versions (K4 corr_apply_cols or K5 fused_update_tail for the update
tails, K6 f32_matmul_big for the products on P). Both consume the same
JAX-simulated observations; the port is handed JAX's own RANSAC draws as
u (torch_parity.ransac_u).

Tolerances at f64 are test_fused_step.py's: x rtol 1e-9 / atol 1e-11,
P rtol 1e-8 / atol 1e-10; masks, counters and per-frame gate counts
exactly equal. The port's tail symmetrizes P (K4) where JAX adds the
folded correction to P as it is; with P symmetric the two agree to
rounding (~1e-13 here)."""

from unittest import mock

import jax
import numpy as np
import pytest
import torch

from ekf_slam_tpu.filter import engine as jengine
from ekf_slam_tpu.filter import mapman as jmapman
from torch_parity import (FUSED, configs, frame, frame_keys, interpret_mode,
                          n, port_obs, port_state, ransac_u,
                          sim_and_bootstrap, step_fn)

from ekf_slam_tpu_torch.filter import engine, mapman
from ekf_slam_tpu_torch.filter.state import init_state
from ekf_slam_tpu_torch.sim.scene import FrameObs

torch.set_num_threads(1)

B = 3
FRAMES = 8           # bootstrap on frame 0, then 7 steps
X_TOL = dict(rtol=1e-9, atol=1e-11)
P_TOL = dict(rtol=1e-8, atol=1e-10)
MASKS = ("active", "cartesian", "landmark_id")
COUNTS = ("n_visible", "n_ic", "n_li", "n_hi", "ransac_support")
CPU = torch.device("cpu")


def _with(d, **sections):
    """A copy of config dict d with the given section fields replaced."""
    out = {k: dict(v) if isinstance(v, dict) else v for k, v in d.items()}
    for k, v in sections.items():
        out[k] = {**out.get(k, {}), **v}
    return out


UNFUSED = _with(FUSED, filter={"fused_step": "off"})


def _assert_states(port, jst):
    np.testing.assert_allclose(n(port.x), np.asarray(jst.x), **X_TOL)
    np.testing.assert_allclose(n(port.P), np.asarray(jst.P), **P_TOL)
    for f in MASKS + ("times_predicted", "times_measured"):
        np.testing.assert_array_equal(n(getattr(port, f)),
                                      np.asarray(getattr(jst, f)), err_msg=f)


def _assert_counts(info, jinfo, t):
    for f in COUNTS:
        np.testing.assert_array_equal(
            n(getattr(info, f)), np.asarray(getattr(jinfo, f)),
            err_msg=f"{f} frame {t}")


def _run_both(d, frames, batch, seed=0, dtype=torch.float64, start=None):
    """`frames - 1` steps of JAX and of the port from JAX's bootstrap
    state (or from start = (obs, state)); per frame (JAX state, JAX info,
    port state, port info)."""
    jc, tc = configs(d)
    nh = jc.ransac.num_hypotheses
    obs, jst = start or sim_and_bootstrap(jc, seed, frames, batch)[1:]
    step = step_fn(jc)
    st = port_state(jst, dtype)
    out = []
    for t in range(1, frames):
        keys = frame_keys(t, batch)
        jst, jinfo = step(jst, frame(obs, t), keys)
        st, info = engine.step(st, port_obs(frame(obs, t), dtype),
                               torch.tensor(ransac_u(keys, nh)), tc)
        out.append((jst, jinfo, st, info))
    return out


@pytest.fixture(scope="module")
def multiframe():
    """(a) the observations and JAX's bootstrap state, then 7 unfused
    frames of JAX and of the port from it."""
    jc, _ = configs(UNFUSED)
    start = sim_and_bootstrap(jc, 0, FRAMES, B)[1:]
    return start, _run_both(UNFUSED, FRAMES, B, start=start)


def test_unfused_step_matches_jax_multiframe(multiframe):
    """(a) x, P, masks and counters after every one of the 7 frames."""
    for jst, _, st, _ in multiframe[1]:
        _assert_states(st, jst)


@pytest.mark.parametrize("field", COUNTS)
def test_unfused_step_counts_match_jax(multiframe, field):
    for t, (_, jinfo, _, info) in enumerate(multiframe[1], start=1):
        np.testing.assert_array_equal(
            n(getattr(info, field)), np.asarray(getattr(jinfo, field)),
            err_msg=f"frame {t}")


def test_unfused_window_exercises_every_stage(multiframe):
    """Adds, deletes, LI and HI updates all happen in the 7 frames."""
    (_, jst0), frames = multiframe
    prev = np.asarray(jst0.landmark_id)
    added = deleted = 0
    for jst, _, _, _ in frames:
        cur = np.asarray(jst.landmark_id)
        added += int(((prev < 0) & (cur >= 0)).sum())
        deleted += int(((prev >= 0) & (cur != prev)).sum())
        prev = cur
    assert added > 0 and deleted > 0
    assert sum(int(np.asarray(f[1].n_li).sum()) for f in frames) > 0
    assert sum(int(np.asarray(f[1].n_hi).sum()) for f in frames) > 0


@pytest.mark.parametrize("change", [
    {"map": {"max_update_obs": 0}},
    {"map": {"max_update_obs": 24}},
    {"filter": {"gain_solver": "newton"}},
], ids=["full_width_update", "M_eq_cap", "newton_gain"])
def test_unfused_variants_match_jax(change):
    """(b) 3 frames of the full-width update (every slot in slot order;
    M = 0 and M = CAP) and of the Newton gain, at (a)'s tolerances."""
    for t, (jst, jinfo, st, info) in enumerate(
            _run_both(_with(UNFUSED, **change), 4, B), start=1):
        _assert_states(st, jst)
        _assert_counts(info, jinfo, t)


def test_library_default_config_matches_jax():
    """(c) the bare EngineConfig() at f64 — CAP 100, max_new_per_step 25
    (feature-add rank 150 > 128), fused_step "auto" — which the JAX
    engine runs unfused off a TPU and the port unfused on the CPU: B = 2,
    3 frames."""
    frames = _run_both({"dtype": "float64"}, 4, 2)
    assert frames[-1][2].P.shape == (2, 613, 613)
    for t, (jst, jinfo, st, info) in enumerate(frames, start=1):
        _assert_states(st, jst)
        _assert_counts(info, jinfo, t)
    assert int(frames[0][3].n_li.sum()) > 0


def test_pallas_update_route_matches_jax_f32():
    """(d) pallas_update="on" at f32 (B = 2, CAP 24, 3 frames): the update
    tails run in K5's plain version here and in JAX's fused_update_tail
    kernel (interpret mode). Equal gate counts and masks; x within 1e-3 of
    the state's scale max|x| (1.73). Both sides round in IEEE f32 in
    different orders, amplified by the Cholesky gain: at this config the
    port's f32 x drifts from its f64 value by up to 2.6e-4 after two
    frames on both of its steps, fused and unfused (JAX's f32 by 8.8e-5),
    and the two f32 results differ by up to 3.4e-4."""
    d = _with(UNFUSED, filter={"pallas_update": "on"})
    d["dtype"] = "float32"
    with interpret_mode():
        frames = _run_both(d, 4, 2, dtype=torch.float32)
    for t, (_, jinfo, _, info) in enumerate(frames, start=1):
        _assert_counts(info, jinfo, t)
    jst, _, st, _ = frames[-1]
    assert st.P.dtype == torch.float32
    for f in MASKS:
        np.testing.assert_array_equal(n(getattr(st, f)),
                                      np.asarray(getattr(jst, f)))
    xj = np.asarray(jst.x)
    np.testing.assert_allclose(n(st.x), xj, rtol=0,
                               atol=1e-3 * np.abs(xj).max())


def test_convert_and_delete_match_jax():
    """(e) test_fused_step.py's conversion case through the port's
    apply_manage_P: shrink the first active slot's rho variance so its
    linearity index drops below the threshold; the next manage converts
    it to cartesian. The managed state and the full unfused step after it
    match JAX."""
    jc, tc = configs(UNFUSED)
    nh = jc.ransac.num_hypotheses
    _, obs, jst = sim_and_bootstrap(jc, 3, 4, B)
    step = step_fn(jc)
    for t in range(1, 3):
        jst, _ = step(jst, frame(obs, t), frame_keys(t, B))
    active = np.asarray(jst.active)
    P = np.array(jst.P)
    for b in range(B):
        rd = 13 + 6 * int(np.flatnonzero(active[b])[0]) + 5
        P[b, rd, rd] = 1e-8
    jst = jst.replace(P=jax.numpy.asarray(P))
    jman = jax.vmap(lambda s: jmapman.manage(s, jc))(jst)
    man = mapman.manage(port_state(jst), tc)
    assert n(man.cartesian).sum(axis=1).tolist() == [1] * B
    _assert_states(man, jman)
    keys = jax.random.split(jax.random.key(7), B)
    st, info = engine.step(port_state(jst), port_obs(frame(obs, 3)),
                           torch.tensor(ransac_u(keys, nh)), tc)
    jst, jinfo = step(jst, frame(obs, 3), keys)
    assert n(st.cartesian).sum(axis=1).tolist() == [1] * B
    _assert_states(st, jst)
    _assert_counts(info, jinfo, 3)


def test_fused_step_equals_unfused_step(multiframe):
    """(f) the port's fused step against its unfused step on the same
    inputs at f64 over 7 frames — the claim of test_fused_step.py, at its
    tolerances."""
    jc, tc_off = configs(UNFUSED)
    _, tc_on = configs(FUSED)
    nh = jc.ransac.num_hypotheses
    obs, jst = multiframe[0]
    on = off = port_state(jst)
    for t in range(1, FRAMES):
        u = torch.tensor(ransac_u(frame_keys(t, B), nh))
        o = port_obs(frame(obs, t))
        on, i_on = engine.step_fused(on, o, u, tc_on)
        off, i_off = engine.step(off, o, u, tc_off)
        for f in COUNTS:
            torch.testing.assert_close(getattr(i_on, f), getattr(i_off, f),
                                       rtol=0, atol=0)
    np.testing.assert_allclose(n(on.x), n(off.x), **X_TOL)
    np.testing.assert_allclose(n(on.P), n(off.P), **P_TOL)
    for f in MASKS:
        torch.testing.assert_close(getattr(on, f), getattr(off, f))


def _tiny(tc):
    """A zero-observation frame for one instance of config tc."""
    L = tc.sim.num_landmarks
    return (init_state(tc, 1, "cpu"),
            FrameObs(torch.zeros(L, 2, dtype=torch.float64),
                     torch.zeros(L, dtype=torch.bool)),
            torch.zeros(1, tc.ransac.num_hypotheses, dtype=torch.float64))


def test_auto_picks_the_unfused_step_on_the_cpu():
    """(g) fused_step="auto" takes the fused step only on a CUDA device at
    f32 when the config fits; on the CPU `step` runs step_core."""
    f32 = _with(FUSED, filter={"fused_step": "auto"})
    f32["dtype"] = "float32"
    _, tc = configs(f32)
    assert not engine.route(tc, CPU).fused
    assert engine.route(tc, torch.device("cuda")).fused
    _, tc64 = configs(_with(FUSED, filter={"fused_step": "auto"}))
    assert not engine.route(tc64, torch.device("cuda")).fused
    _, tc_big = configs({})
    assert not engine.route(tc_big, torch.device("cuda")).fused
    with mock.patch.object(engine, "step_fused",
                           side_effect=AssertionError("fused step taken")):
        st, info = engine.step(*_tiny(tc64), tc64)
    assert bool(torch.isfinite(st.P).all())


def test_pallas_update_dispatch():
    """(g) pallas_update: "on"/"off" as set, "auto" only on a CUDA device
    (engine.py:602-609 with a CUDA device for pallas_supported())."""
    for mode, cpu, cuda in (("on", True, True), ("off", False, False),
                            ("auto", False, True)):
        _, tc = configs(_with(UNFUSED, filter={"pallas_update": mode}))
        assert engine.route(tc, CPU).use_pallas == cpu
        assert engine.route(tc, torch.device("cuda")).use_pallas == cuda


@pytest.mark.parametrize("change", [
    {"use_iterated_update": True},
    {"share_pht": True},
], ids=["iekf", "share_pht"])
def test_step_core_raises_for_what_is_not_ported(change):
    """(g) share_pht stays unported: the unfused step raises rather than
    take another path. The IEKF, once unported too, is now ported: step_core
    runs it, and 3 frames of the step match JAX's at (a)'s tolerances
    (tests/test_torch_iekf.py holds it in full)."""
    d = _with(UNFUSED, filter=change)
    _, tc = configs(d)
    st, obs, u = _tiny(tc)
    z, zv = engine.gather_measurements(st, obs)
    if change.get("use_iterated_update"):
        engine.step_core(st, z, zv, u, tc)
        for t, (jst, jinfo, st, info) in enumerate(_run_both(d, 4, B),
                                                   start=1):
            _assert_states(st, jst)
            _assert_counts(info, jinfo, t)
        return
    with pytest.raises(ValueError, match="not ported"):
        engine.step_core(st, z, zv, u, tc)
    with pytest.raises(ValueError, match="not ported"):
        engine.step(st, obs, u, tc)


@pytest.mark.parametrize("change", [
    {"map": {"max_new_per_step": 25}},
    {"map": {"max_update_obs": 0}},
    {"map": {"max_update_obs": 24}},
    {"filter": {"use_iterated_update": True}},
    {"filter": {"p_storage": "bf16"}},
], ids=["add_rank_150", "full_width_update", "M_eq_cap", "iekf",
        "bf16_storage"])
def test_fused_on_raises_where_jax_raises(change):
    """(g) fused_step="on" with a config the fused step cannot run raises
    in the port and in the JAX engine alike."""
    jc, tc = configs(_with(FUSED, **change))
    assert tc.filter.fused_step == "on"
    with pytest.raises(ValueError):
        jengine._use_fused(jc)
    with pytest.raises(ValueError):
        engine.route(tc, CPU)
