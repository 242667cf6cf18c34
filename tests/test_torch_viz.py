"""The port's viz package (ekf_slam_tpu_torch/viz) and the public helpers
of its filter API, against the JAX package: the cases of
tests/test_utils_viz.py, ported.

- The numeric functions (no matplotlib): the ellipse points and the
  uncertain-surface hull against JAX's numpy output to 1e-12, with the
  JAX tests' own geometry checks; LinearPCA.
- The plot smoke tests write PNGs; the GIF, and save_video's GIF fallback
  without ffmpeg; drawing without matplotlib raises ImportError.
- local_descriptor_projections on Flax's key-2 draw of the width-8 VSS
  (models/flax_init.py, 32x32): the port's VSS against the Flax module on
  the same weights and images, each direction within 1e-5 up to the sign
  of its PCA component (both run in f32); the plot writes a PNG.
- ops/quaternion's Euler helpers (rotx, roty, rotz, rpy2r, r2rpy,
  dq_by_deuler), motion.process_noise_euler, ransac.support_projection
  and measurement.predict_and_linearize against JAX's to 1e-12 at f64."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_slam_tpu.filter import measurement as jmeas
from ekf_slam_tpu.filter import motion as jmotion
from ekf_slam_tpu.filter import ransac as jransac
from ekf_slam_tpu.filter.state import init_state as j_init_state
from ekf_slam_tpu.models import vss as jvss
from ekf_slam_tpu.ops import quaternion as jquat
from ekf_slam_tpu.viz import descriptors as jdescr
from ekf_slam_tpu.viz import plots as jplots
from torch_parity import configs, n, port_state, t

from ekf_slam_tpu_torch.filter import measurement, motion, ransac
from ekf_slam_tpu_torch.models import flax_init, vss
from ekf_slam_tpu_torch.ops import quaternion as quat
from ekf_slam_tpu_torch.viz import (plot_frame, plot_map_3d,
                                    uncertain_surface_xz_hull,
                                    uncertainty_ellipse_points)
from ekf_slam_tpu_torch.viz import animation, descriptors, plots

torch.set_num_threads(1)


@pytest.mark.parametrize("S", [np.diag([4.0, 1.0]),
                               np.array([[3.0, 1.2], [1.2, 2.0]]),
                               np.array([[1.0, 2.0], [2.0, 1.0]])],
                         ids=["diag", "full", "indefinite"])
def test_uncertainty_ellipse_matches_jax(S):
    c = np.array([10.0, -3.0])
    got = uncertainty_ellipse_points(S, c, n=33)
    np.testing.assert_allclose(got, jplots.uncertainty_ellipse_points(
        S, c, n=33), rtol=0, atol=1e-12)
    if S[0, 1] == 0:
        # n=33: the grid holds pi/2, so both semi-axes are sampled exactly
        assert abs(got[0].max() - c[0] - np.sqrt(5.9915 * 4)) < 1e-6
        assert abs(got[1].max() - c[1] - np.sqrt(5.9915)) < 1e-6


def test_uncertain_surface_xz_hull_matches_jax():
    y6 = np.array([0.0, 0.0, 0.0, 0.0, 0.0, 0.5])
    C6 = np.diag([1e-4] * 3 + [1e-4, 1e-4, 1e-3])
    poly = uncertain_surface_xz_hull(C6, y6, n=500)
    np.testing.assert_allclose(
        poly, jplots.uncertain_surface_xz_hull(C6, y6, n=500), rtol=0,
        atol=1e-12)
    assert poly.shape[1] == 2 and np.allclose(poly[0], poly[-1])
    cx, cz = poly[:-1].mean(axis=0)
    assert abs(cx) < 0.1 and abs(cz - 2.0) < 0.3
    assert poly[:, 1].min() < 2.0 < poly[:, 1].max()
    np.testing.assert_array_equal(plots.chi2_shell_samples(6, 50, 3),
                                  jplots.chi2_shell_samples(6, 50, 3))
    # rho mostly negative: too few samples (the reference's > 10 rule)
    assert uncertain_surface_xz_hull(C6, np.array([0, 0, 0, 0, 0, -50.0]),
                                     n=500) is None


def test_plot_functions_smoke(tmp_path):
    rng = np.random.default_rng(0)
    k = 6
    h = rng.random((k, 2)) * 100 + 10
    S = np.tile(np.eye(2) * 4, (k, 1, 1))
    vis = np.ones(k, bool)
    ic = np.array([1, 1, 1, 1, 0, 0], bool)
    li = np.array([1, 1, 0, 0, 0, 0], bool)
    hi = np.array([0, 0, 1, 0, 0, 0], bool)
    img = rng.random((120, 160))
    p1 = str(tmp_path / "frame.png")
    plot_frame(p1, img, h, S, vis, ic, li, hi)
    p2 = str(tmp_path / "frame_full.png")
    plot_frame(p2, img, h, S, vis, ic, li, hi, z=h + rng.normal(size=(k, 2)),
               patches=rng.random((k, 13, 13)))
    p3 = str(tmp_path / "map.png")
    traj = np.cumsum(rng.normal(size=(20, 3)) * 0.01, axis=0)
    plot_map_3d(p3, traj, rng.normal(size=(10, 3)),
                np.tile(np.eye(3) * 0.01, (10, 1, 1)),
                active=np.ones(10, bool), truth_traj=traj + 0.01,
                camera_R=np.eye(3))
    for p in (p1, p2, p3):
        assert os.path.getsize(p) > 0


def test_drawing_without_matplotlib_raises(tmp_path, monkeypatch):
    """As the JAX package's: importing viz needs no matplotlib; drawing
    does (the numeric functions above need none)."""
    for mod in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        plot_map_3d(str(tmp_path / "m.png"), np.zeros((3, 3)),
                    np.zeros((2, 3)))


def test_save_animation_gif(tmp_path):
    from PIL import Image
    frames = [np.random.default_rng(i).random((16, 20)) for i in range(4)]
    p = str(tmp_path / "anim.gif")
    assert animation.save_animation(p, frames, fps=5) == 4
    assert Image.open(p).n_frames == 4


def test_save_video_falls_back_to_gif(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", "/nonexistent")
    frames = [np.random.default_rng(i).random((16, 20)) for i in range(3)]
    assert animation.save_video(str(tmp_path / "out.mp4"), frames, 5) == 3
    assert os.path.getsize(tmp_path / "out.gif") > 0
    assert not (tmp_path / "out.mp4").exists()


def test_render_overlay_frames(tmp_path):
    T, k = 2, 3
    rng = np.random.default_rng(1)
    m = np.ones((T, k), bool)
    out = list(animation.render_overlay_frames(
        rng.random((T, 40, 50)), rng.random((T, k, 2)) * 40,
        np.tile(np.eye(2), (T, k, 1, 1)), m, m, m, ~m))
    assert len(out) == T and out[0].ndim == 3 and out[0].shape[2] == 3


def test_local_descriptor_projections_match_jax(tmp_path):
    hw = (32, 32)
    cfg = vss.VSSConfig(width=8)
    variables = flax_init.flax_variables(cfg, hw, 2)
    model = vss.VSS(cfg, hw)
    model.load_state_dict(vss.from_flax(variables))
    rng = np.random.default_rng(0)
    train_ims = rng.random((5,) + hw + (3,), np.float32)
    db = rng.random(hw + (3,), np.float32)
    triplet = np.stack([db, db, rng.random(hw + (3,), np.float32)])

    model.train()                  # eval inside the call, restored after
    got = descriptors.local_descriptor_projections(
        model, triplet, train_ims, device="cpu")
    want = jdescr.local_descriptor_projections(
        jvss.VSS(jvss.VSSConfig(width=8)), variables, triplet, train_ims)
    assert set(got) == set(want) == {"appearance", "building", "vegetation"}
    for name, v in got.items():
        w = np.asarray(want[name])
        assert v.shape == (3, 2)
        sign = np.sign(np.sum(v * w, axis=0))        # each component's sign
        np.testing.assert_allclose(v * sign, w, rtol=0, atol=1e-5,
                                   err_msg=name)
        np.testing.assert_allclose(np.linalg.norm(v, axis=-1), 1.0,
                                   rtol=1e-6)
        np.testing.assert_allclose(v[0], v[1], atol=1e-9)
    assert model.training
    out = descriptors.plot_local_descriptors(
        got, str(tmp_path / "descr.png"),
        order=["building", "vegetation", "appearance"])
    assert os.path.getsize(out) > 0

    X = rng.random((6, 2)) @ np.array([[1.0, 0.5, 0.0], [0.0, 1.0, 2.0]])
    p = descriptors.LinearPCA(2).fit(X)
    np.testing.assert_allclose(p.transform(X) @ p.components + p.mean, X,
                               atol=1e-9)


def test_euler_helpers_match_jax():
    rng = np.random.default_rng(2)
    a = rng.uniform(-1.2, 1.2, (5, 3))
    for name in ("rotx", "roty", "rotz"):
        np.testing.assert_allclose(
            n(getattr(quat, name)(t(a[:, 0]))),
            np.asarray(getattr(jquat, name)(jnp.asarray(a[:, 0]))),
            rtol=0, atol=1e-12, err_msg=name)
    R = quat.rpy2r(t(a[:, 0]), t(a[:, 1]), t(a[:, 2]))
    np.testing.assert_allclose(n(R), np.asarray(jquat.rpy2r(
        *(jnp.asarray(a[:, i]) for i in range(3)))), rtol=0, atol=1e-12)
    rpy = quat.r2rpy(R)
    np.testing.assert_allclose(n(rpy), np.asarray(jquat.r2rpy(
        jnp.asarray(n(R)))), rtol=0, atol=1e-12)
    np.testing.assert_allclose(n(rpy), a, rtol=0, atol=1e-12)  # round trip
    np.testing.assert_allclose(n(quat.dq_by_deuler(t(a))), np.asarray(
        jquat.dq_by_deuler(jnp.asarray(a))), rtol=0, atol=1e-12)


def test_process_noise_euler_matches_jax():
    rng = np.random.default_rng(3)
    xv = rng.normal(size=(4, 13)) * 0.1
    xv[:, 3:7] /= np.linalg.norm(xv[:, 3:7], axis=1, keepdims=True)
    jc, tc = configs({"dtype": "float64"})
    got = motion.process_noise_euler(t(xv), tc.filter)
    want = jmotion.process_noise_euler(jnp.asarray(xv), jc.filter)
    assert got.shape == (4, 13, 13)
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=0, atol=1e-12)


def test_support_projection_and_predict_and_linearize_match_jax():
    """Two instances of 12 slots: inverse-depth features 2-6 m ahead of a
    perturbed camera, slots 1 and 4 cartesian, slots 10-11 inactive, and
    a random SPD covariance."""
    jc, tc = configs({"map": {"capacity": 12}, "dtype": "float64"})
    rng = np.random.default_rng(4)
    Bn, cap = 2, 12
    D = 13 + 6 * cap
    x = np.zeros((Bn, D))
    x[:, 0:3] = rng.normal(size=(Bn, 3)) * 0.05
    x[:, 3] = 1.0
    x[:, 4:7] = rng.normal(size=(Bn, 3)) * 0.02
    x[:, 3:7] /= np.linalg.norm(x[:, 3:7], axis=1, keepdims=True)
    y = x[:, 13:].reshape(Bn, cap, 6)
    y[..., 0:3] = rng.normal(size=(Bn, cap, 3)) * 0.05
    y[..., 3:5] = rng.uniform(-0.4, 0.4, (Bn, cap, 2))
    y[..., 5] = 1.0 / rng.uniform(2, 6, (Bn, cap))
    cart = np.zeros((Bn, cap), bool)
    for s in (1, 4):
        m = np.stack([np.cos(y[:, s, 4]) * np.sin(y[:, s, 3]),
                      -np.sin(y[:, s, 4]),
                      np.cos(y[:, s, 4]) * np.cos(y[:, s, 3])], -1)
        y[:, s, 0:3] += m / y[:, s, 5:6]
        y[:, s, 3:] = 0.0
        cart[:, s] = True
    A = rng.normal(size=(Bn, D, D)) * 0.01
    active = np.ones((Bn, cap), bool)
    active[:, 10:] = False
    jst = jax.vmap(lambda _: j_init_state(jc))(jnp.arange(Bn)).replace(
        x=jnp.asarray(x), P=jnp.asarray(A @ A.transpose(0, 2, 1)
                                        + 1e-3 * np.eye(D)),
        active=jnp.asarray(active), cartesian=jnp.asarray(cart))
    st = port_state(jst)

    got = ransac.support_projection(st.x, st.cartesian, tc)
    want = jax.vmap(lambda xh, c: jransac.support_projection(xh, c, jc))(
        jst.x, jst.cartesian)
    assert got.shape == (2, 12, 2)
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=0, atol=1e-9)

    outs = measurement.predict_and_linearize(st.x, st.P, st, tc)
    wants = jax.vmap(lambda s: jmeas.predict_and_linearize(s.x, s.P, s, jc))(
        jst)
    for name, g, w in zip(("h", "visible", "H_xv", "H_y", "S"), outs, wants):
        w = np.asarray(w)
        if w.dtype == bool:
            np.testing.assert_array_equal(n(g), w, err_msg=name)
        else:
            np.testing.assert_allclose(n(g), w, rtol=1e-12,
                                       atol=1e-12 * np.abs(w).max(),
                                       err_msg=name)
    assert int(n(outs[1]).sum()) >= 12
