"""The port's trajectory metrics and its dumps and metrics helpers
(ekf_slam_tpu_torch.utils) against the JAX package's
(ekf_slam_tpu.utils).

Inputs are random, well-conditioned trajectories made with numpy from a
seed, at f64 in both packages, B = 3 instances for the port against one
JAX call an instance. Tolerance 1e-10 absolute (the same f64 math; the
SVD of a 3x3 is the one place the libraries differ, and on these inputs
its singular values are well separated). A pure pan (positions fixed,
the cross-covariance zero) leaves R to the SVD library; its ATE does not
depend on R and is held to 1e-9 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_slam_tpu.utils import checkpoint as jckpt
from ekf_slam_tpu.utils import metrics as jmetrics
from ekf_slam_tpu.utils import trajectory as jtraj
from ekf_slam_tpu_torch.utils import checkpoint, metrics, trajectory

torch.set_num_threads(1)

TOL = 1e-10
B, T = 3, 40


def _unit(q):
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _trajectories(seed: int):
    """Positions (B, T, 3) of a wandering camera, an estimate of them
    rotated, shifted, scaled and perturbed, and quaternions (B, T, 4)."""
    rng = np.random.default_rng(seed)
    gt = np.cumsum(rng.normal(0.0, 0.2, (B, T, 3)), axis=1)
    ang = rng.uniform(-1.0, 1.0, (B, 3))
    est = np.empty_like(gt)
    for b in range(B):
        q = _unit(np.concatenate([[1.0], 0.5 * ang[b]]))
        R = np.asarray(jtraj.q2r(jnp.asarray(q)))
        est[b] = 1.3 * gt[b] @ R.T + rng.normal(0, 1, 3) \
            + rng.normal(0, 0.02, (T, 3))
    gq = _unit(rng.normal(0, 1, (B, T, 4)) * [4.0, 0.3, 0.3, 0.3])
    eq = _unit(gq + rng.normal(0, 0.01, (B, T, 4)))
    return gt, est, gq, eq


def _jax(fn, *arrays, **kw):
    """fn applied to each instance's arrays in JAX, stacked."""
    outs = [fn(*(jnp.asarray(a[b]) for a in arrays), **kw)
            for b in range(arrays[0].shape[0])]
    return jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                        *outs)


@pytest.mark.parametrize("with_scale", [False, True])
@pytest.mark.parametrize("reflected", [False, True])
def test_umeyama_and_align(with_scale, reflected):
    gt, est, _, _ = _trajectories(0)
    if reflected:       # a mirror image: the determinant-sign fix engages
        est = est * np.array([1.0, 1.0, -1.0])
    s_j, R_j, t_j = _jax(jtraj.umeyama, est, gt, with_scale=with_scale)
    s, R, tr = trajectory.umeyama(torch.tensor(est), torch.tensor(gt),
                                  with_scale)
    np.testing.assert_allclose(s.numpy(), s_j, rtol=0, atol=TOL)
    np.testing.assert_allclose(R.numpy(), R_j, rtol=0, atol=TOL)
    np.testing.assert_allclose(tr.numpy(), t_j, rtol=0, atol=TOL)
    assert np.allclose(np.linalg.det(R.numpy()), 1.0)
    al_j = _jax(jtraj.align, est, gt, with_scale=with_scale)
    al = trajectory.align(torch.tensor(est), torch.tensor(gt), with_scale)
    np.testing.assert_allclose(al.numpy(), al_j, rtol=0, atol=TOL)


@pytest.mark.parametrize("do_align,with_scale",
                         [(True, False), (True, True), (False, False)])
def test_ate_rmse(do_align, with_scale):
    gt, est, _, _ = _trajectories(1)
    ref = _jax(jtraj.ate_rmse, est, gt, do_align=do_align,
               with_scale=with_scale)
    got = trajectory.ate_rmse(torch.tensor(est), torch.tensor(gt),
                              do_align, with_scale)
    assert got.shape == (B,)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=TOL)


def test_ate_of_a_pure_pan():
    """Positions of the truth fixed at the origin: R is the SVD library's
    choice; the ATE is the spread of the estimate about its mean in both
    packages, to 1e-9 relative."""
    rng = np.random.default_rng(2)
    gt = np.zeros((B, T, 3))
    est = np.cumsum(rng.normal(0, 0.01, (B, T, 3)), axis=1)
    ref = _jax(jtraj.ate_rmse, est, gt)
    got = trajectory.ate_rmse(torch.tensor(est), torch.tensor(gt)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-9)
    spread = np.sqrt(np.mean(np.sum(
        (est - est.mean(axis=1, keepdims=True)) ** 2, axis=-1), axis=-1))
    np.testing.assert_allclose(got, spread, rtol=1e-9)


@pytest.mark.parametrize("delta", [1, 5])
def test_rpe(delta):
    gt, est, gq, eq = _trajectories(3)
    ref = _jax(lambda *a: jtraj.rpe(*a, delta=delta), est, eq, gt, gq)
    got = trajectory.rpe(*(torch.tensor(a) for a in (est, eq, gt, gq)),
                         delta=delta)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=TOL)


def test_evaluate_trajectory():
    gt, est, gq, eq = _trajectories(4)
    traj = np.concatenate([est, eq, np.zeros((B, T, 6))], axis=-1)
    truth = np.concatenate([gt, gq], axis=-1)
    ref = _jax(lambda a, b: jtraj.evaluate_trajectory(a, b, delta=2),
               traj, truth)
    got = trajectory.evaluate_trajectory(torch.tensor(traj),
                                         torch.tensor(truth), delta=2)
    assert set(got) == set(ref) == {"ate", "rpe_trans", "rpe_rot"}
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=0, atol=TOL)


def test_dump_trajectory_matches_jax(tmp_path):
    """The same arrays dump to the same npz keys and values."""
    from ekf_slam_tpu_torch.filter.engine import StepInfo
    rng = np.random.default_rng(5)
    traj, truth = rng.normal(size=(T, 13)), rng.normal(size=(T, 13))
    info = {k: rng.integers(0, 9, (1, T)) for k in
            ("n_visible", "n_ic", "n_li", "n_hi", "ransac_support")}
    jckpt.dump_trajectory(str(tmp_path / "j.npz"), traj, truth,
                          type("I", (), info)())
    checkpoint.dump_trajectory(
        str(tmp_path / "t.npz"), torch.tensor(traj), torch.tensor(truth),
        StepInfo(**{k: torch.tensor(v) for k, v in info.items()},
                 search_r_needed=torch.zeros(1, T)))
    a = jckpt.load_trajectory(str(tmp_path / "j.npz"))
    b = checkpoint.load_trajectory(str(tmp_path / "t.npz"))
    assert set(a) <= set(b) and set(b) - set(a) == {"info_search_r_needed"}
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_save_and_restore_a_state(tmp_path):
    from ekf_slam_tpu_torch.config import EngineConfig
    from ekf_slam_tpu_torch.filter.state import init_state
    st = init_state(EngineConfig(), 2, "cpu")
    st = st.replace(x=st.x + torch.arange(st.x.shape[1]))
    path = str(tmp_path / "st.pt")
    checkpoint.save_pytree(path, st)
    back = checkpoint.restore_pytree(path, init_state(EngineConfig(), 2,
                                                      "cpu"))
    assert torch.equal(back.x, st.x) and torch.equal(back.P, st.P)
    assert set(checkpoint.restore_pytree(path)) >= {"x", "P", "active"}


def test_metrics_helpers_match_jax(tmp_path):
    x = np.array([1.0, np.nan, 2.0])
    assert not bool(metrics.check_finite(torch.tensor(x))[1])
    assert bool(metrics.check_finite(torch.ones(3))[1])
    assert bool(jmetrics.check_finite(jnp.ones(3))[1])
    res = {}
    with metrics.step_timer(res, "block"), metrics.trace_annotation("frame"):
        sum(range(1000))
    assert res["block"] >= 0.0
    with pytest.raises(ValueError, match="SPANS"):
        with metrics.trace_annotation("x"):
            pass
    logs = []
    for mod in (jmetrics, metrics):
        log = mod.MetricsLogger()
        for i in range(3):
            log.log(i, loss=1.0 / (i + 1), ate=0.1 * i)
        log.dump_jsonl(str(tmp_path / f"{mod.__name__}.jsonl"))
        logs.append((log.table(2), log.series("loss"),
                     (tmp_path / f"{mod.__name__}.jsonl").read_text()))
    assert logs[0] == logs[1]
