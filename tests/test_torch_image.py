"""The port's image path as a whole (vision/frontend.step_image and
run_images) against the JAX package's step_image, and the device defaults
of the port's entry points.

(a) tests/test_vision.py's pixels config (CAP 24, R = 10) in f64 over 8
frames, B = 2, for both matchers: JAX renders the frames and both packages
consume the same images (numpy) and the same RANSAC draws (JAX's own,
torch_parity.ransac_u); frame 0 initializes features from FAST, as
bench.py does. Gate counts must be equal every frame, masks and counters
equal, x within 1e-9 of max|x| (the same f64 math in another order: it
reads ~1e-13) and the appearance store equal (its pose to 1e-9).

(b) the pixels-bench config (bench.py:107-135: CAP 100, 128 landmarks,
R = 12, Newton gain, affine warp, 240x320) at f32 with B = 2 for 3
frames, NCC matcher: frame 0 (features initialized from FAST at full
width) gives equal counts, masks, x and appearance store, and in each
frame the port's f32 matcher, handed JAX's state, appearance store and
prior, finds the same features at the same pixels as JAX's matcher does
at f64 on the same inputs. The gate counts of frames 1-2 are not
compared: at f32 they are decided by rounding in the JAX package:
- frame 1's matches: a window offset whose 13x13 patch is flat background
  has var = Σw² − (Σw)²/n cancelling to ~0, and the template's f32
  residue Σtm ≠ 0 over sqrt(1e-12) then scores it far above 1 (4.8 and
  38.9 here); such an offset wins JAX's f32 argmax for 6 of 20 slots,
  against none at f64. The port scores a patch whose variance is within
  rounding of 0 as 0 (vision/ncc.ncc_scores_all), so its f32 matches are
  the f64 ones; n_hi reads 2 in JAX's f32 run and 3 in the port's (3 in
  both packages at f64);
- the first update with fresh inverse-depth features (ρ std 1) amplifies
  rounding: JAX's own f32 and f64 runs differ in frame 1's n_li (5 vs 7).
At f64 the two packages agree to ~2e-13 with equal counts over 4 frames
of this config.

On CPU tensors the port's kernels run their plain versions; the JAX
package runs its default forms (no Pallas kernel on this path off a
TPU)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_slam_tpu.filter import ekf as jekf
from ekf_slam_tpu.filter import mapman as jmapman
from ekf_slam_tpu.filter.state import init_state as j_init_state
from ekf_slam_tpu.sim import scene as jscene
from ekf_slam_tpu.vision import frontend as jfront
from torch_parity import batch, configs, n, port_state, ransac_u, t

from ekf_slam_tpu_torch.config import EngineConfig
from ekf_slam_tpu_torch.filter import engine
from ekf_slam_tpu_torch.filter.state import init_state, state_from_numpy
from ekf_slam_tpu_torch.ops import kernels
from ekf_slam_tpu_torch.sim import simulate
from ekf_slam_tpu_torch.sim.scene import Scene
from ekf_slam_tpu_torch.vision import frontend

torch.set_num_threads(1)

B = 2
FRAMES = 8
COUNTS = ("n_visible", "n_ic", "n_li", "n_hi", "ransac_support")
MASKS = ("active", "cartesian", "landmark_id", "times_predicted",
         "times_measured")
PIXELS = {
    "map": {"capacity": 24, "min_features_in_image": 10,
            "max_new_per_step": 10},
    "vision": {"search_radius": 10, "min_ncc": 0.4, "max_hamming": 80.0},
    "sim": {"num_landmarks": 40, "depth_min": 2.0, "depth_max": 6.0,
            "v_init": (0.002, 0.0, 0.004), "w_init": (0.0, 0.001, 0.0),
            "traj_accel_std": 2e-4, "traj_alpha_std": 2e-4},
    "dtype": "float64",
}
# bench.py:107-135, the NCC matcher at its bench batch knee (BENCH_PIXB).
PIXELS_BENCH = {
    "filter": {"gain_solver": "newton"},
    "map": {"capacity": 100, "min_features_in_image": 25,
            "max_new_per_step": 10, "max_update_obs": 64},
    "vision": {"matcher": "ncc", "search_radius": 12,
               "corners_per_window": 8, "warp_distortion": "affine"},
    "sim": {"num_landmarks": 128},
    "dtype": "float32",
}


def _with_vision(d, **vision):
    return {**d, "vision": {**d["vision"], **vision}}


def _run_both(d, frames, dtype, before=None):
    """JAX step_image (jit, vmap over B, frame shared) and the port's over
    `frames` JAX-rendered frames; before(jc, tc, JAX state, JAX app, image)
    runs ahead of each frame's steps. Returns per frame (JAX state, JAX
    app, JAX info, port state, port app, port info)."""
    jc, tc = configs(d)
    scn, xs, _ = jscene.simulate(jax.random.key(0), jc, frames)
    render = jax.jit(jfront.render_scene_image, static_argnames="cfg")
    imgs = [np.asarray(render(scn, xs[i], jc)).astype(np.dtype(
        str(dtype).removeprefix("torch."))) for i in range(frames)]
    step = jax.jit(jax.vmap(
        lambda s, a, im, k: jfront.step_image(s, a, im, k, jc),
        in_axes=(0, 0, None, 0)))
    jst = batch(j_init_state(jc), B)
    japp = batch(jfront.init_appearance(jc), B)
    st = init_state(tc, B, "cpu")
    app = frontend.init_appearance(tc, B, "cpu")
    out = []
    for i in range(frames):
        if before is not None:
            before(jc, tc, jst, japp, imgs[i])
        keys = jax.random.split(jax.random.key(10 + i), B)
        jst, japp, jinfo = step(jst, japp, jnp.asarray(imgs[i]), keys)
        u = torch.tensor(ransac_u(keys, jc.ransac.num_hypotheses),
                         dtype=dtype)
        st, app, info = frontend.step_image(st, app, torch.tensor(imgs[i]),
                                            u, tc)
        out.append((jst, japp, jinfo, st, app, info))
    return out


@pytest.fixture(scope="module", params=["ncc", "descriptor"])
def pixels_run(request):
    return request.param, _run_both(
        _with_vision(PIXELS, matcher=request.param), FRAMES, torch.float64)


@pytest.mark.parametrize("field", COUNTS)
def test_step_image_counts_match_jax(pixels_run, field):
    _, frames = pixels_run
    for i, (_, _, jinfo, _, _, info) in enumerate(frames):
        np.testing.assert_array_equal(
            n(getattr(info, field)), np.asarray(getattr(jinfo, field)),
            err_msg=f"frame {i}")


def test_step_image_tracks_and_matches_jax_x(pixels_run):
    """x within 1e-9 of max|x| every frame; masks and counters equal; the
    window does real work (features initialized on frame 0, later frames
    matched and updated)."""
    _, frames = pixels_run
    for jst, _, _, st, _, _ in frames:
        xj = np.asarray(jst.x)
        np.testing.assert_allclose(n(st.x), xj, rtol=0,
                                   atol=1e-9 * np.abs(xj).max())
        for f in MASKS:
            np.testing.assert_array_equal(n(getattr(st, f)),
                                          np.asarray(getattr(jst, f)),
                                          err_msg=f)
    assert int(n(frames[0][5].n_ic).sum()) == 0
    assert int(n(frames[0][3].active).sum()) >= 2 * 10
    assert min(int(n(f[5].n_li).min()) for f in frames[1:]) >= 5


def test_step_image_search_reach_matches_jax(pixels_run):
    _, frames = pixels_run
    for _, _, jinfo, _, _, info in frames:
        np.testing.assert_allclose(n(info.search_r_needed),
                                   np.asarray(jinfo.search_r_needed),
                                   rtol=1e-9)
    assert float(n(frames[-1][5].search_r_needed).max()) > 0


def test_step_image_appearance_matches_jax(pixels_run):
    _, frames = pixels_run
    _, japp, _, _, app, _ = frames[-1]
    for f in ("patches", "init_px", "descr"):
        np.testing.assert_array_equal(n(getattr(app, f)),
                                      np.asarray(getattr(japp, f)),
                                      err_msg=f)
    np.testing.assert_allclose(n(app.init_pose), np.asarray(japp.init_pose),
                               rtol=0, atol=1e-9)


def test_pixels_bench_config_matches_jax_f32():
    """(b) CAP 100 at f32: frame 0 equal; in each of 3 frames the port's
    f32 matcher on JAX's state finds what JAX's finds at f64."""
    found_total = []

    def same_matches(jc, tc, jst, japp, img):
        def prior(s):
            s = jmapman.manage(s, jc)
            return (s,) + jekf.predict(s.x, s.P, jc.filter)

        jm, xp, Pp = jax.jit(jax.vmap(prior))(jst)
        jc64 = dataclasses.replace(jc, dtype="float64")
        f64 = jax.tree.map(lambda a: a.astype(jnp.float64)
                           if jnp.issubdtype(a.dtype, jnp.floating) else a,
                           (jm, japp, xp, Pp, jnp.asarray(img)))
        want = jax.vmap(lambda s, a, x, P: jfront.measure_at_prior(
            s, a, f64[4], x, P, jc64))(*f64[:4])
        f32 = torch.float32
        got = frontend.measure_at_prior(
            port_state(jm, f32), frontend.appearance_from_numpy(
                {f: np.asarray(getattr(japp, f))
                 for f in frontend.APPEARANCE_FIELDS}, "cpu", f32),
            frontend.prepare_frame(torch.tensor(img), tc), t(xp, f32),
            t(Pp, f32), tc)
        found = n(got[1])
        np.testing.assert_array_equal(found, np.asarray(want[1]))
        np.testing.assert_array_equal(n(got[0])[found],
                                      np.asarray(want[0])[found])
        found_total.append(int(found.sum()))

    frames = _run_both(PIXELS_BENCH, 3, torch.float32, same_matches)
    jst, japp, jinfo, st, app, info = frames[0]
    assert st.x.dtype == torch.float32
    for f in COUNTS:
        np.testing.assert_array_equal(n(getattr(info, f)),
                                      np.asarray(getattr(jinfo, f)))
    for f in MASKS:
        np.testing.assert_array_equal(n(getattr(st, f)),
                                      np.asarray(getattr(jst, f)))
    np.testing.assert_allclose(n(st.x), np.asarray(jst.x), rtol=0,
                               atol=1e-6)
    for f in frontend.APPEARANCE_FIELDS:
        np.testing.assert_allclose(n(getattr(app, f)),
                                   np.asarray(getattr(japp, f)), rtol=0,
                                   atol=1e-6)
    assert int(n(st.active).sum()) == 2 * 10
    assert found_total[0] == 0 and min(found_total[1:]) >= 2 * 10


@pytest.fixture(scope="module")
def small_sequence():
    """3 frames of the pixels config rendered by the port, f64 on CPU."""
    _, tc = configs(_with_vision(PIXELS, matcher="ncc"))
    scn, xs, _ = simulate(torch.Generator().manual_seed(0), tc, 3, "cpu")
    imgs = torch.stack([frontend.render_scene_image(scn, xs[i], tc, "cpu")
                        for i in range(3)])
    u = torch.rand(3, B, tc.ransac.num_hypotheses, dtype=torch.float64,
                   generator=torch.Generator().manual_seed(1))
    return tc, xs, imgs, u


def test_run_images_equals_the_step_loop(small_sequence):
    """run_images is step_image over the frames: final state and
    appearance, the camera trajectory (B, T, 13) and StepInfo (B, T)."""
    tc, _, imgs, u = small_sequence
    st0 = init_state(tc, B, "cpu")
    app0 = frontend.init_appearance(tc, B, "cpu")
    final, app, traj, infos = frontend.run_images(st0, app0, imgs, u, tc,
                                                  "cpu")
    assert traj.shape == (B, 3, 13) and infos.n_ic.shape == (B, 3)
    assert infos.search_r_needed.shape == (B, 3)
    st, ap = st0, app0
    for i in range(3):
        st, ap, info = frontend.step_image(st, ap, imgs[i], u[i], tc)
        torch.testing.assert_close(traj[:, i], st.x[:, :13], rtol=0, atol=0)
        torch.testing.assert_close(infos.n_li[:, i], info.n_li)
    torch.testing.assert_close(final.P, st.P, rtol=0, atol=0)
    torch.testing.assert_close(app.descr, ap.descr, rtol=0, atol=0)


def test_ncc_numerator_is_one_call_a_frame_for_the_batch(small_sequence):
    """K7's norms form is called once a frame with all B·CAP pairs (its
    plain version on the CPU); the descriptor matcher never calls it, and
    neither matcher calls the correlation-only form."""
    tc, _, imgs, u = small_sequence
    st = init_state(tc, B, "cpu")
    app = frontend.init_appearance(tc, B, "cpu")
    with kernels.capture_operands() as calls:
        frontend.run_images(st, app, imgs, u, tc, "cpu")
    cap, W2 = tc.map.capacity, 2 * tc.vision.search_radius + 13
    assert [tuple(c[0].shape) for c in calls["ncc_corr_norms"]] == [
        (B * cap, W2, W2)] * 3
    assert "ncc_corr" not in calls
    assert len(calls["corr_apply_cols"]) == 2 * 3
    assert len(calls["f32_matmul_big"]) == 3
    assert len(calls["pht_blocks"]) == 2 * 3
    _, tcd = configs(_with_vision(PIXELS, matcher="descriptor"))
    with kernels.capture_operands() as calls:
        frontend.run_images(st, app, imgs, u, tcd, "cpu")
    assert "ncc_corr_norms" not in calls and "ncc_corr" not in calls


def test_sim_path_step_info_has_zero_search_reach():
    """StepInfo.search_r_needed is 0 on the sim path; stacked over a
    sequence by run_sequence it is a (B, T) tensor of zeros."""
    _, tc = configs({"map": {"capacity": 24, "min_features_in_image": 10,
                             "max_new_per_step": 10},
                     "sim": {"num_landmarks": 40}, "dtype": "float64"})
    _, _, obs = simulate(torch.Generator().manual_seed(0), tc, 3, "cpu")
    st = engine.bootstrap(init_state(tc, B, "cpu"), obs.frame(0), tc)
    u = torch.rand(3, B, tc.ransac.num_hypotheses, dtype=torch.float64,
                   generator=torch.Generator().manual_seed(1))
    _, _, infos = engine.run_sequence(st, obs, u, tc)
    assert infos.n_ic.shape == (B, 3) and int(infos.n_ic.sum()) > 0
    assert infos.search_r_needed.dtype == torch.float64
    assert infos.search_r_needed.tolist() == [[0.0] * 3] * B


def test_step_image_makes_the_frame_planes_once(small_sequence, monkeypatch):
    """FAST, non-max suppression and smoothing run once a frame on either
    matcher, shared by the matcher, the feature init and the store."""
    tc, _, imgs, u = small_sequence
    calls = []
    for mod, name in ((frontend.fast, "fast_score"),
                      (frontend.fast, "non_max_suppress"),
                      (frontend.descriptor, "_smooth3")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    for matcher in ("ncc", "descriptor"):
        _, cfg = configs(_with_vision(PIXELS, matcher=matcher))
        calls.clear()
        frontend.run_images(init_state(cfg, B, "cpu"),
                            frontend.init_appearance(cfg, B, "cpu"), imgs,
                            u, cfg, "cpu")
        assert sorted(calls) == sorted(
            ["fast_score", "non_max_suppress", "_smooth3"] * 3), matcher


@pytest.mark.parametrize("change", [
    {"use_iterated_update": True},
    {"share_pht": True},
], ids=["iekf", "share_pht"])
def test_step_image_raises_for_what_is_not_ported(small_sequence, change):
    """share_pht stays unported: step_image raises. The IEKF, once unported
    too, is now ported: 3 frames of step_image with it (frame 0 initializes
    from FAST, frames 1-2 update) match JAX's at (a)'s tolerances."""
    tc, _, imgs, u = small_sequence
    cfg = tc.replace(filter=dataclasses.replace(tc.filter, **change))
    if change.get("use_iterated_update"):
        d = {**PIXELS, "filter": {"use_iterated_update": True}}
        frames = _run_both(d, 3, torch.float64)
        for i, (jst, _, jinfo, st, _, info) in enumerate(frames):
            for f in COUNTS:
                np.testing.assert_array_equal(
                    n(getattr(info, f)), np.asarray(getattr(jinfo, f)),
                    err_msg=f"{f} frame {i}")
            xj = np.asarray(jst.x)
            np.testing.assert_allclose(n(st.x), xj, rtol=0,
                                       atol=1e-9 * np.abs(xj).max())
            for f in MASKS:
                np.testing.assert_array_equal(n(getattr(st, f)),
                                              np.asarray(getattr(jst, f)))
        assert int(n(frames[-1][5].n_li).min()) > 0
        return
    with pytest.raises(ValueError, match="not ported"):
        frontend.step_image(init_state(cfg, B, "cpu"),
                            frontend.init_appearance(cfg, B, "cpu"),
                            imgs[0], u[0], cfg)


def _no_device_calls():
    """The port's public constructors and entry points, each called
    without a device."""
    cfg = EngineConfig.from_dict({"map": {"capacity": 4}, "dtype":
                                  "float64"})
    st = init_state(cfg, 1, "cpu")
    app = frontend.init_appearance(cfg, 1, "cpu")
    x = torch.zeros(13, dtype=torch.float64)
    x[3] = 1.0
    return {
        "init_state": lambda: init_state(cfg, 1),
        "state_from_numpy": lambda: state_from_numpy(
            {f: getattr(st, f).numpy() for f in
             ("x", "P", "active", "cartesian", "times_predicted",
              "times_measured", "landmark_id")}),
        "simulate": lambda: simulate(torch.Generator().manual_seed(0), cfg,
                                     2),
        "init_appearance": lambda: frontend.init_appearance(cfg, 1),
        "appearance_from_numpy": lambda: frontend.appearance_from_numpy(
            frontend.appearance_to_numpy(app)),
        "render_scene_image": lambda: frontend.render_scene_image(
            Scene(torch.ones(3, 3, dtype=torch.float64)), x, cfg),
        "run_images": lambda: frontend.run_images(
            st, app, torch.zeros(1, 240, 320, dtype=torch.float64),
            torch.zeros(1, 1, 64, dtype=torch.float64), cfg),
    }


@pytest.mark.parametrize("entry", sorted(_no_device_calls()))
def test_entry_point_without_device_raises_without_a_card(entry):
    """The port's entry points run on the card unless the caller names
    another device: with no card, a call naming none raises instead of
    returning CPU tensors."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _no_device_calls()[entry]()
