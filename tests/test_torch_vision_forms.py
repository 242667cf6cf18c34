"""The image path's distortion forms and the legacy matching API of the
port against the JAX package.

(a) patch_warp.predict_appearance in its three forms ("exact": the
per-pixel undistort / H⁻¹ / Newton distort round trip, "affine", "none")
at f64, B = 2, CAP 8, on random patches, poses and landmarks: to 1e-10.
The port's "affine" against its "exact" on the JAX test's own case
(tests/test_vision.py:204-225, identity pose on a blob patch) to that
test's 0.02, and each form's round trip to its 0.05; and warp_patch /
distortion_corrected_homography against JAX's.

(b) vision/frontend.step_image with warp_distortion "exact" and "none",
3 frames of tests/test_torch_image.py's pixels config (CAP 24, R = 10,
NCC matcher) at f64, B = 2, the same JAX-rendered images and RANSAC
draws: counts equal every frame, x within 1e-9 of max|x|; then
frontend.measure on the next frame against JAX's measure (z, z_valid, h,
visible).

(c) crosscorr, crosscorr_svd and ncc_scores against JAX to 1e-12 (with
crosscorr.m's cases: identical patches 1, a 90° rotation keeps the SVD
score at 1, flat patches 0), descriptor.hamming_distance and match
equal.

(d) The torch calls of one step_image in each form (the count the
card's host-bound step follows): exact < affine, none < exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_slam_tpu.filter.state import init_state as j_init_state
from ekf_slam_tpu.sim import scene as jscene
from ekf_slam_tpu.vision import descriptor as jdesc
from ekf_slam_tpu.vision import frontend as jfront
from ekf_slam_tpu.vision import ncc as jncc
from ekf_slam_tpu.vision import patch_warp as jwarp
from torch_parity import batch, configs, n, ransac_u, t

from ekf_slam_tpu_torch.config import EngineConfig
from ekf_slam_tpu_torch.filter.state import init_state
from ekf_slam_tpu_torch.vision import descriptor, frontend, ncc, patch_warp

torch.set_num_threads(1)

B, CAP = 2, 8
FORMS = ("exact", "affine", "none")
COUNTS = ("n_visible", "n_ic", "n_li", "n_hi", "ransac_support")
PIXELS = {
    "map": {"capacity": 24, "min_features_in_image": 10,
            "max_new_per_step": 10},
    "vision": {"search_radius": 10, "min_ncc": 0.4, "matcher": "ncc"},
    "sim": {"num_landmarks": 40, "depth_min": 2.0, "depth_max": 6.0,
            "v_init": (0.002, 0.0, 0.004), "w_init": (0.0, 0.001, 0.0),
            "traj_accel_std": 2e-4, "traj_alpha_std": 2e-4},
    "dtype": "float64",
}


def _quat(rng, n_, scale):
    v = rng.normal(size=(n_, 3)) * scale
    q = np.concatenate([np.ones((n_, 1)), v / 2], axis=1)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def warp_inputs():
    """Random slots seen from an init pose and the current pose: patches
    (B, CAP, 41, 41), init poses, camera states, points 3-5 m ahead,
    pixels at init (h_init) and now (h_now) spread over the frame."""
    rng = np.random.default_rng(5)
    pose = np.concatenate([rng.normal(size=(B, CAP, 3)) * 0.05,
                           _quat(rng, B * CAP, 0.05).reshape(B, CAP, 4)], -1)
    x_cam = np.zeros((B, 13))
    x_cam[:, 0:3] = rng.normal(size=(B, 3)) * 0.05
    x_cam[:, 3:7] = _quat(rng, B, 0.05)
    p_w = np.concatenate([rng.uniform(-1.5, 1.5, (B, CAP, 2)),
                          rng.uniform(3, 5, (B, CAP, 1))], -1)
    return dict(patches=rng.random((B, CAP, 41, 41)), pose=pose,
                x_cam=x_cam, p_w=p_w,
                h_init=rng.uniform([20, 20], [300, 220], (B, CAP, 2)),
                h_now=rng.uniform([20, 20], [300, 220], (B, CAP, 2)))


@pytest.mark.parametrize("form", FORMS)
def test_predict_appearance_matches_jax(warp_inputs, form):
    w = warp_inputs
    cam = EngineConfig().camera
    jc, _ = configs({"dtype": "float64"})
    want = jax.vmap(lambda a, p, x, pw, hi, hn: jwarp.predict_appearance(
        a, p, x, pw, hi, hn, jc.camera, 13, distortion=form))(
        w["patches"], w["pose"], w["x_cam"], w["p_w"], w["h_init"],
        w["h_now"])
    got = patch_warp.predict_appearance(
        t(w["patches"]), t(w["pose"]), t(w["x_cam"]), t(w["p_w"]),
        t(w["h_init"]), t(w["h_now"]), cam, 13, distortion=form)
    assert got.shape == (B, CAP, 13, 13)
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=0, atol=1e-10)
    assert np.abs(np.asarray(want)).max() > 0.5


def test_unknown_distortion_raises(warp_inputs):
    w = warp_inputs
    with pytest.raises(ValueError, match="unknown distortion"):
        patch_warp.predict_appearance(
            t(w["patches"]), t(w["pose"]), t(w["x_cam"]), t(w["p_w"]),
            t(w["h_init"]), t(w["h_now"]), EngineConfig().camera, 13,
            distortion="affine2")


def test_warp_patch_and_corrected_homography_match_jax(warp_inputs):
    w = warp_inputs
    jc, tc = configs({"dtype": "float64"})
    H = patch_warp.plane_homography(
        t(w["pose"][..., :3]), t(w["pose"][..., 3:]),
        t(w["x_cam"][:, None, :3]), t(w["x_cam"][:, None, 3:7]),
        t(w["p_w"]), tc.camera)
    Hn = n(H).reshape(-1, 3, 3)
    hi, hn = w["h_init"].reshape(-1, 2), w["h_now"].reshape(-1, 2)
    pat = w["patches"].reshape(-1, 41, 41)
    want_raw = jax.vmap(lambda p, h, a, b: jwarp.warp_patch(
        p, h, a, b, 13))(pat, Hn, hi, hn)
    want_dist = jax.vmap(lambda p, h, a, b: jwarp.warp_patch_distorted(
        p, h, a, b, 13, jc.camera))(pat, Hn, hi, hn)
    want_M = jax.vmap(lambda h, a, b: jwarp.distortion_corrected_homography(
        h, a, b, jc.camera))(Hn, hi, hn)
    np.testing.assert_allclose(
        n(patch_warp.warp_patch(t(pat), t(Hn), t(hi), t(hn), 13)),
        np.asarray(want_raw), rtol=0, atol=1e-10)
    np.testing.assert_allclose(
        n(patch_warp.warp_patch_distorted(t(pat), t(Hn), t(hi), t(hn), 13,
                                          tc.camera)),
        np.asarray(want_dist), rtol=0, atol=1e-10)
    M = patch_warp.distortion_corrected_homography(t(Hn), t(hi), t(hn),
                                                   tc.camera)
    np.testing.assert_allclose(n(M), np.asarray(want_M), rtol=1e-12,
                               atol=1e-12 * np.abs(want_M).max())


def _blob_image(h=64, w=64, centers=((20, 30), (40, 12)), sig=1.5):
    """tests/test_vision.py's blob_image, in torch at f32."""
    yy = torch.arange(h, dtype=torch.float32)[:, None]
    xx = torch.arange(w, dtype=torch.float32)[None, :]
    img = torch.full((h, w), 0.2)
    for cy, cx in centers:
        img = img + 0.7 * torch.exp(-((yy - cy) ** 2 + (xx - cx) ** 2)
                                    / (2 * sig * sig))
    return img.clamp(0.0, 1.0)


def test_distortion_forms_agree_on_the_jax_tests_case():
    """tests/test_vision.py:204-225 on the port: identity pose, a blob
    patch; every form reproduces the stored patch's center (0.05) and
    "affine" tracks "exact" (0.02)."""
    cam = EngineConfig().camera
    img = _blob_image()
    c = torch.tensor([30.0, 20.0])
    patches = ncc.extract_patch(img, c, 20)[None, None]
    pose = torch.tensor([[[0.0, 0, 0, 1, 0, 0, 0]]])
    x_cam = torch.zeros(1, 13)
    x_cam[0, 3] = 1.0
    p_w = torch.tensor([[[0.0, 0.0, 3.0]]])
    h = c[None, None]
    outs = {m: patch_warp.predict_appearance(
        patches, pose, x_cam, p_w, h, h, cam, 13, distortion=m)
        for m in FORMS}
    ref = ncc.extract_patch(img, c, 6)
    for m, out in outs.items():
        np.testing.assert_allclose(n(out[0, 0]), n(ref), atol=0.05,
                                   err_msg=m)
    np.testing.assert_allclose(n(outs["affine"]), n(outs["exact"]),
                               atol=0.02)


@pytest.fixture(scope="module", params=["exact", "none"])
def pixels_run(request):
    """3 frames of step_image in both packages at f64 with the warp form,
    then each package's measure on frame 3."""
    d = {**PIXELS, "vision": {**PIXELS["vision"],
                              "warp_distortion": request.param}}
    jc, tc = configs(d)
    scn, xs, _ = jscene.simulate(jax.random.key(0), jc, 4)
    render = jax.jit(jfront.render_scene_image, static_argnames="cfg")
    imgs = [np.asarray(render(scn, xs[i], jc)) for i in range(4)]
    step = jax.jit(jax.vmap(
        lambda s, a, im, k: jfront.step_image(s, a, im, k, jc),
        in_axes=(0, 0, None, 0)))
    jst, japp = batch(j_init_state(jc), B), batch(jfront.init_appearance(jc),
                                                   B)
    st, app = init_state(tc, B, "cpu"), frontend.init_appearance(tc, B, "cpu")
    frames = []
    for i in range(3):
        keys = jax.random.split(jax.random.key(10 + i), B)
        jst, japp, jinfo = step(jst, japp, jnp.asarray(imgs[i]), keys)
        u = torch.tensor(ransac_u(keys, jc.ransac.num_hypotheses))
        st, app, info = frontend.step_image(st, app, torch.tensor(imgs[i]),
                                            u, tc)
        frames.append((jst, jinfo, st, info))
    jmeas = jax.jit(jax.vmap(lambda s, a, im: jfront.measure(s, a, im, jc),
                             in_axes=(0, 0, None)))(jst, japp,
                                                    jnp.asarray(imgs[3]))
    meas = frontend.measure(st, app, torch.tensor(imgs[3]), tc)
    return frames, jmeas, meas


def test_step_image_in_the_form_matches_jax(pixels_run):
    frames, _, _ = pixels_run
    for i, (jst, jinfo, st, info) in enumerate(frames):
        for f in COUNTS:
            np.testing.assert_array_equal(
                n(getattr(info, f)), np.asarray(getattr(jinfo, f)),
                err_msg=f"{f} frame {i}")
        xj = np.asarray(jst.x)
        np.testing.assert_allclose(n(st.x), xj, rtol=0,
                                   atol=1e-9 * np.abs(xj).max())
    assert int(n(frames[-1][3].n_li).min()) > 0


def test_measure_matches_jax(pixels_run):
    _, want, got = pixels_run
    z, zv, h, vis = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(n(got[1]), zv)
    np.testing.assert_array_equal(n(got[3]), vis)
    np.testing.assert_allclose(n(got[2]), h, rtol=0, atol=1e-9)
    np.testing.assert_allclose(n(got[0])[zv], z[zv], rtol=0, atol=1e-9)
    assert zv.sum() >= 5


def test_crosscorr_matches_jax():
    rng = np.random.default_rng(3)
    a, b = rng.random((4, 7, 7)), rng.random((4, 7, 7))
    for svd in (False, True):
        np.testing.assert_allclose(
            n(ncc.crosscorr(t(a), t(b), svd=svd)),
            np.asarray(jncc.crosscorr(jnp.asarray(a), jnp.asarray(b),
                                      svd=svd)), rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        n(ncc.crosscorr_svd(t(a), t(b))),
        np.asarray(jncc.crosscorr_svd(jnp.asarray(a), jnp.asarray(b))),
        rtol=0, atol=1e-12)
    # crosscorr.m's cases (tests/test_utils_viz.py)
    a0 = t(a[0])
    assert abs(float(ncc.crosscorr(a0, a0)) - 1.0) < 1e-12
    assert abs(float(ncc.crosscorr_svd(a0, torch.rot90(a0))) - 1.0) < 1e-12
    assert float(ncc.crosscorr(a0, torch.rot90(a0))) < 0.9
    assert float(ncc.crosscorr(torch.ones(7, 7, dtype=a0.dtype), a0)) == 0.0
    zero = torch.zeros(7, 7, dtype=a0.dtype)
    assert float(ncc.crosscorr_svd(zero, zero)) == 0.0


def test_ncc_scores_matches_jax():
    rng = np.random.default_rng(4)
    win = rng.random((13 + 2 * 5, 13 + 2 * 5))
    tm = win[3:16, 6:19] + 0.01 * rng.random((13, 13))
    got = ncc.ncc_scores(t(win), t(tm))
    want = np.asarray(jncc.ncc_scores(jnp.asarray(win), jnp.asarray(tm)))
    assert got.shape == (11, 11)
    np.testing.assert_allclose(n(got), want, rtol=0, atol=1e-12)
    assert np.unravel_index(np.argmax(want), want.shape) == (3, 6)


def test_hamming_match_equals_jax():
    rng = np.random.default_rng(6)
    d2 = np.where(rng.random((12, descriptor.N_BITS)) > 0.5, 1.0, -1.0)
    d1 = d2[[3, 7, 7, 0, 11]].copy()
    d1[:, :40] *= np.where(rng.random((5, 40)) > 0.7, -1.0, 1.0)
    d1 = np.concatenate([d1, -d2[:1]])                 # one far descriptor
    got_d = descriptor.hamming_distance(t(d1), t(d2))
    np.testing.assert_array_equal(
        n(got_d), np.asarray(jdesc.hamming_distance(jnp.asarray(d1),
                                                     jnp.asarray(d2))))
    idx, ok = descriptor.match(t(d1), t(d2), 64.0)
    jidx, jok = jdesc.match(jnp.asarray(d1), jnp.asarray(d2), 64.0)
    np.testing.assert_array_equal(n(idx), np.asarray(jidx))
    np.testing.assert_array_equal(n(ok), np.asarray(jok))
    assert n(idx)[:5].tolist() == [3, 7, 7, 0, 11]
    assert n(ok).tolist() == [True] * 5 + [False]


def test_exact_warp_adds_no_torch_calls():
    """The image step is host-bound on the card, so its cost follows the
    torch calls a frame makes. One step_image of the bench map
    (profile_slice.image_config) at B = 4 on the CPU, after one frame:
    the per-pixel round trip ("exact") makes fewer top-level torch calls
    than the affine anchors, and "none" fewer still (the counts are
    printed; PERF.md §6 records them)."""
    from torch.profiler import ProfilerActivity, profile

    from ekf_slam_tpu_torch.profile_slice import image_config, image_inputs
    calls = {}
    for form in FORMS:
        cfg = image_config("ncc", form)
        st0, app0, _, imgs, u = image_inputs(cfg, "cpu", batch=4, frames=2)
        st, app, _, _ = frontend.run_images(st0, app0, imgs[:1], u[:1], cfg,
                                            "cpu")
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            frontend.step_image(st, app, imgs[1], u[1], cfg)
        calls[form] = sum(1 for e in prof.events()
                          if e.name.startswith("aten::")
                          and e.cpu_parent is None)
    print("top-level torch calls of one step_image:", calls)
    assert calls["none"] < calls["exact"] < calls["affine"]
