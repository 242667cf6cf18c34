"""The port's batched fused SLAM step against the JAX engine.

The JAX side runs engine.step with fused_step="on" (its Pallas kernels in
interpret mode), jitted and vmapped over the batch; the port runs on CPU
tensors, i.e. through the kernels' plain versions. Both consume the same
JAX-simulated observations, and the port is handed JAX's own RANSAC draws
jax.random.uniform(key, (NHYP,)) as u — in f64, as JAX draws them under
the suite's x64 mode, so the rank floor of the pick is the same.

Tolerances at f64 are test_fused_step.py's (fused vs unfused JAX):
x rtol 1e-9 / atol 1e-11, P rtol 1e-8 / atol 1e-10; masks and per-frame
gate counts exactly equal."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from ekf_slam_tpu.filter import mapman as jmapman
from torch_parity import (FUSED, SLICE, configs, frame, frame_keys,
                          interpret_mode, n, port_obs, port_state, ransac_u,
                          sim_and_bootstrap, step_fn)

from ekf_slam_tpu_torch.filter import engine
from ekf_slam_tpu_torch.filter.state import init_state
from ekf_slam_tpu_torch.sim.scene import FrameObs

torch.set_num_threads(1)

B = 3
FRAMES = 8           # bootstrap on frame 0, then 7 steps
X_TOL = dict(rtol=1e-9, atol=1e-11)
P_TOL = dict(rtol=1e-8, atol=1e-10)
MASKS = ("active", "cartesian", "landmark_id")


def _assert_states(port, jst):
    np.testing.assert_allclose(n(port.x), np.asarray(jst.x), **X_TOL)
    np.testing.assert_allclose(n(port.P), np.asarray(jst.P), **P_TOL)
    for f in MASKS + ("times_predicted", "times_measured"):
        np.testing.assert_array_equal(n(getattr(port, f)),
                                      np.asarray(getattr(jst, f)), err_msg=f)


@pytest.fixture(scope="module")
def multiframe():
    """7 fused frames of JAX and of the port from JAX's bootstrap state;
    per-frame (JAX state, JAX info, port state, port info)."""
    jc, tc = configs(FUSED)
    nh = jc.ransac.num_hypotheses
    with interpret_mode():
        _, obs, jst = sim_and_bootstrap(jc, 0, FRAMES, B)
        step = step_fn(jc)
        st = port_state(jst)
        boot = (jst, engine.bootstrap(init_state(tc, B, "cpu"),
                                      port_obs(frame(obs, 0)), tc))
        frames = []
        for t in range(1, FRAMES):
            keys = frame_keys(t, B)
            jst, jinfo = step(jst, frame(obs, t), keys)
            st, info = engine.step(st, port_obs(frame(obs, t)),
                                   torch.tensor(ransac_u(keys, nh)), tc)
            frames.append((jst, jinfo, st, info))
    return boot, frames


def test_bootstrap_matches_jax(multiframe):
    (jst, st), _ = multiframe
    _assert_states(st, jst)


def test_fused_step_matches_jax_multiframe(multiframe):
    """(a) x, P, masks and counters after every one of the 7 frames."""
    _, frames = multiframe
    for jst, _, st, _ in frames:
        _assert_states(st, jst)


@pytest.mark.parametrize("field", ["n_visible", "n_ic", "n_li", "n_hi",
                                   "ransac_support"])
def test_fused_step_counts_match_jax(multiframe, field):
    _, frames = multiframe
    for t, (_, jinfo, _, info) in enumerate(frames, start=1):
        np.testing.assert_array_equal(
            n(getattr(info, field)), np.asarray(getattr(jinfo, field)),
            err_msg=f"frame {t}")


def test_multiframe_window_exercises_every_stage(multiframe):
    """Adds, deletes, LI and HI updates all happen in the 7 frames."""
    (jst0, _), frames = multiframe
    prev = np.asarray(jst0.landmark_id)
    added = deleted = 0
    for jst, jinfo, _, _ in frames:
        cur = np.asarray(jst.landmark_id)
        added += int(((prev < 0) & (cur >= 0)).sum())
        deleted += int(((prev >= 0) & (cur != prev)).sum())
        prev = cur
    assert added > 0 and deleted > 0
    assert sum(int(np.asarray(f[1].n_li).sum()) for f in frames) > 0
    assert sum(int(np.asarray(f[1].n_hi).sum()) for f in frames) > 0


def test_fused_step_convert_and_delete_matches_jax():
    """(b) test_fused_step.py's conversion case: shrink the first active
    slot's rho variance so its linearity index drops below the threshold,
    and the next step converts it to cartesian through K1's rank-6 term."""
    jc, tc = configs(FUSED)
    nh = jc.ransac.num_hypotheses
    with interpret_mode():
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
        managed = jax.vmap(lambda s: jmapman.manage(s, jc))(jst)
        assert np.asarray(managed.cartesian).sum(axis=1).tolist() == [1] * B
        keys = jax.random.split(jax.random.key(7), B)
        st = port_state(jst)
        jst, jinfo = step(jst, frame(obs, 3), keys)
        st, info = engine.step(st, port_obs(frame(obs, 3)),
                               torch.tensor(ransac_u(keys, nh)), tc)
    assert n(st.cartesian).sum(axis=1).tolist() == [1] * B
    _assert_states(st, jst)
    np.testing.assert_array_equal(n(info.n_li), np.asarray(jinfo.n_li))


def test_slice_config_f32_matches_jax():
    """(c) f32 at the bench workload's map config (CAP 100, 128 landmarks,
    Newton gain), B = 2 for 3 frames: equal gate counts and masks; x within
    1e-4 of the state's scale max|x| — both sides round in IEEE f32 (CPU)
    in different summation orders, and the gains (fresh features carry
    σ_ρ = 1 beside pixel-level rows in S) amplify that rounding frame over
    frame (seen: at most 7.6e-5)."""
    jc, tc = configs(SLICE)
    nh = jc.ransac.num_hypotheses
    with interpret_mode():
        _, obs, jst = sim_and_bootstrap(jc, 0, 4, 2)
        step = step_fn(jc)
        st = port_state(jst, torch.float32)
        for t in range(1, 4):
            keys = frame_keys(t, 2)
            jst, jinfo = step(jst, frame(obs, t), keys)
            st, info = engine.step(
                st, port_obs(frame(obs, t), torch.float32),
                torch.tensor(ransac_u(keys, nh)), tc)
            for f in ("n_ic", "n_li", "n_hi"):
                np.testing.assert_array_equal(
                    n(getattr(info, f)), np.asarray(getattr(jinfo, f)),
                    err_msg=f"{f} frame {t}")
    assert st.x.dtype == torch.float32 and st.P.dtype == torch.float32
    for f in MASKS:
        np.testing.assert_array_equal(n(getattr(st, f)),
                                      np.asarray(getattr(jst, f)))
    xj = np.asarray(jst.x)
    np.testing.assert_allclose(n(st.x), xj, rtol=0,
                               atol=1e-4 * np.abs(xj).max())


def test_run_sequence_equals_stepping():
    """run_sequence is step in a loop: same final state, the camera block
    of each frame as the trajectory, per-frame infos stacked on axis 1."""
    jc, tc = configs(FUSED)
    _, obs, jst = sim_and_bootstrap(jc, 1, 4, 2)
    st0 = port_state(jst)
    seq = port_obs(obs)
    u = torch.rand(4, 2, tc.ransac.num_hypotheses, dtype=torch.float64,
                   generator=torch.Generator().manual_seed(0))
    final, traj, infos = engine.run_sequence(st0, seq, u, tc)
    assert traj.shape == (2, 4, 13) and infos.n_ic.shape == (2, 4)
    st = st0
    for t in range(4):
        st, info = engine.step(st, seq.frame(t), u[t], tc)
        torch.testing.assert_close(traj[:, t], st.x[:, :13], rtol=0, atol=0)
        torch.testing.assert_close(infos.n_li[:, t], info.n_li)
    torch.testing.assert_close(final.P, st.P, rtol=0, atol=0)


@pytest.mark.parametrize("change", [
    {"filter": {"fused_step": "off"}},
    {"map": {"max_new_per_step": 25}},
    {"map": {"max_update_obs": 0}},
    {"map": {"max_update_obs": 24}},
    {"filter": {"use_iterated_update": True}},
    {"filter": {"p_storage": "bf16"}},
], ids=["fused_off", "add_rank_150", "full_width_update", "M_eq_cap",
        "iekf", "bf16_storage"])
def test_step_raises_outside_fused_conditions(change):
    """fused_step="on" raises for a config the fused step cannot run, as
    the JAX engine does (engine.py:361-366); "off" runs the unfused step
    (tests/test_torch_unfused.py holds it against JAX)."""
    d = {k: dict(v) if isinstance(v, dict) else v for k, v in FUSED.items()}
    for k, v in change.items():
        d[k] = {**d[k], **v}
    _, tc = configs(d)
    st = init_state(tc, 1, "cpu")
    L = tc.sim.num_landmarks
    obs = FrameObs(torch.zeros(L, 2, dtype=torch.float64),
                   torch.zeros(L, dtype=torch.bool))
    u = torch.zeros(1, tc.ransac.num_hypotheses, dtype=torch.float64)
    if tc.filter.fused_step == "off":
        st, info = engine.step(st, obs, u, tc)
        assert bool(torch.isfinite(st.P).all()) and int(info.n_ic) == 0
        return
    with pytest.raises(ValueError):
        engine.step(st, obs, u, tc)


def test_default_map_config_is_outside_the_fused_step():
    """The bare MapConfig() adds up to 25 features a step (rank 150 > 128):
    the fused step cannot run it, on any device, and `step` runs the
    unfused step there, as the JAX engine does. The bench workload's map
    config fits the fused step."""
    _, tc = configs({"dtype": "float64"})
    for dev in ("cpu", "cuda"):
        assert not engine.route(tc, torch.device(dev)).fused
    st = init_state(tc, 1, "cpu")
    L = tc.sim.num_landmarks
    obs = FrameObs(torch.rand(L, 2, dtype=torch.float64,
                              generator=torch.Generator().manual_seed(0))
                   * 200, torch.ones(L, dtype=torch.bool))
    st = engine.bootstrap(st, obs, tc)
    assert int(st.active.sum()) == 25
    st, _ = engine.step(st, obs, torch.zeros(1, 64, dtype=torch.float64), tc)
    assert st.P.shape == (1, 613, 613) and bool(torch.isfinite(st.P).all())
    _, tc = configs(SLICE)
    assert engine.route(tc, torch.device("cuda")).fused
    assert dataclasses.asdict(tc)["map"]["capacity"] == 100
