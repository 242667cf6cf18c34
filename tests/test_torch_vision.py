"""The port's image front-end (ekf_slam_tpu_torch.vision), stage by stage,
against the JAX package's (ekf_slam_tpu.vision).

One world at tests/test_vision.py's pixels config (CAP 24, 40 landmarks,
R = 10) in f64, B = 2: the JAX package renders frames 0-3 and runs
step_image over frames 0-2 (features initialized from FAST on frame 0,
then tracked), vmapped over the batch with the frame shared. Each stage of
frame 3 then gets the same inputs — the JAX state, appearance store,
prior, predicted pixels and innovation covariances, as numpy arrays — in
both packages. The port runs on CPU tensors, so K7 is its plain version;
the JAX package runs its default forms.

Tolerances: discrete outputs (FAST scores and suppression, corner
indices, descriptor bits, matches, new-feature picks, the appearance
store) must be equal; the render to 1e-12 and the warped templates to
1e-10 (the same f64 math in another order; the templates pass through a
bilinear interpolation of a 10-step Newton undistortion); the NCC scores
at f32 to 2e-4 (the bound tests/test_vision.py pins between the JAX
package's own numerator forms; JAX's default is a grouped convolution,
the port's K7 + integral images) and at f64 to 1e-10."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_slam_tpu.filter import ekf as jekf
from ekf_slam_tpu.filter import mapman as jmapman
from ekf_slam_tpu.filter import measurement as jmeas
from ekf_slam_tpu.filter.state import init_state as j_init_state
from ekf_slam_tpu.sim import scene as jscene
from ekf_slam_tpu.vision import descriptor as jdesc
from ekf_slam_tpu.vision import fast as jfast
from ekf_slam_tpu.vision import frontend as jfront
from ekf_slam_tpu.vision import ncc as jncc
from ekf_slam_tpu.vision import patch_warp as jwarp
from torch_parity import batch, configs, n, port_state, t

from ekf_slam_tpu_torch.sim.scene import Scene
from ekf_slam_tpu_torch.vision import descriptor, fast, frontend, ncc
from ekf_slam_tpu_torch.vision import patch_warp

torch.set_num_threads(1)

B = 2
# tests/test_vision.py:235-242 (test_slam_from_pixels_e2e) in f64.
PIXELS = {
    "map": {"capacity": 24, "min_features_in_image": 10,
            "max_new_per_step": 10},
    "vision": {"search_radius": 10, "min_ncc": 0.4, "matcher": "ncc",
               "max_hamming": 80.0},
    "sim": {"num_landmarks": 40, "depth_min": 2.0, "depth_max": 6.0,
            "v_init": (0.002, 0.0, 0.004), "w_init": (0.0, 0.001, 0.0),
            "traj_accel_std": 2e-4, "traj_alpha_std": 2e-4},
    "dtype": "float64",
}


def pixels_config(**vision):
    d = {**PIXELS, "vision": {**PIXELS["vision"], **vision}}
    return configs(d)


def frame_keys(t_, B_=B):
    return jax.random.split(jax.random.key(10 + t_), B_)


def port_app(japp):
    return frontend.appearance_from_numpy(
        {f.name: np.asarray(getattr(japp, f.name))
         for f in dataclasses.fields(japp)}, "cpu")


@pytest.fixture(scope="module")
def world():
    """JAX scene, frames 0-3, and the state / appearance after step_image
    on frames 0-2; then frame 3's managed state, prior, predictions and
    innovation covariances, computed by the JAX package."""
    jc, tc = pixels_config()
    scn, xs, _ = jscene.simulate(jax.random.key(0), jc, 4)
    imgs = np.stack([np.asarray(jfront.render_scene_image(scn, xs[i], jc))
                     for i in range(4)])
    jst = batch(j_init_state(jc), B)
    japp = batch(jfront.init_appearance(jc), B)
    step = jax.jit(jax.vmap(
        lambda s, a, im, k: jfront.step_image(s, a, im, k, jc),
        in_axes=(0, 0, None, 0)))
    for i in range(3):
        jst, japp, _ = step(jst, japp, jnp.asarray(imgs[i]), frame_keys(i))

    def prior(s):
        s = jmapman.manage(s, jc)
        xp, Pp = jekf.predict(s.x, s.P, jc.filter)
        h, vis, hc = jmeas.predict_measurements(xp, s.active, s.cartesian,
                                                jc)
        H_xv, H_y = jmeas.jacobians(xp, h, hc, s.cartesian, jc.camera)
        S = jmeas.innovation_covariances(Pp, H_xv, H_y, jc.filter.sigma_z)
        return s, xp, Pp, h, vis, S

    jman, xp, Pp, h, vis, S = jax.jit(jax.vmap(prior))(jst)
    tr = S[..., 0, 0] + S[..., 1, 1]
    det = S[..., 0, 0] * S[..., 1, 1] - S[..., 0, 1] * S[..., 1, 0]
    lmax = tr / 2 + jnp.sqrt(jnp.maximum(tr * tr / 4 - det, 0.0))
    matchable = vis & (lmax < jc.matching.max_innovation_eig)
    assert int(jst.active.sum()) >= 2 * 10 and int(matchable.sum()) >= 10
    return dict(jc=jc, tc=tc, scn=scn, xs=xs, imgs=imgs, jst=jst,
                japp=japp, jman=jman, xp=xp, Pp=Pp, h=h, vis=vis, S=S,
                matchable=matchable, img=imgs[3])


def test_descriptor_pattern_equals_jax():
    np.testing.assert_array_equal(descriptor._PAT_A, jdesc._PAT_A)
    np.testing.assert_array_equal(descriptor._PAT_B, jdesc._PAT_B)
    assert descriptor._PAT_A.shape == (descriptor.N_BITS, 2)


@pytest.mark.parametrize("frame", [0, 3])
def test_render_scene_image_matches_jax(world, frame):
    scene = Scene(t(world["scn"].landmarks))
    got = frontend.render_scene_image(scene, t(world["xs"][frame]),
                                      world["tc"], "cpu")
    assert got.shape == (240, 320) and got.dtype == torch.float64
    np.testing.assert_allclose(n(got), world["imgs"][frame], rtol=0,
                               atol=1e-12)


def _noisy_image(seed=0):
    """Texture with many corners (and plateau ties where it clips)."""
    rng = np.random.default_rng(seed)
    return np.clip(0.5 + 0.3 * rng.standard_normal((48, 64)), 0.0, 1.0)


@pytest.mark.parametrize("which", ["rendered", "noisy"])
def test_fast_score_and_nms_equal_jax(world, which):
    img = world["img"] if which == "rendered" else _noisy_image()
    sc = fast.fast_score(t(img), 0.08, 9)
    want = jfast.fast_score(jnp.asarray(img), 0.08, 9)
    np.testing.assert_array_equal(n(sc), np.asarray(want))
    assert int((n(sc) > 0).sum()) >= 10
    np.testing.assert_array_equal(
        n(fast.non_max_suppress(sc)),
        np.asarray(jfast.non_max_suppress(want)))


def test_top_corners_equal_jax_with_planted_ties(world):
    """Plateau ties (equal scores at neighbours, which NMS keeps) and
    equal scores far apart come lowest flat index first, as lax.top_k
    orders them; zero scores fill the tail in index order."""
    score = np.array(jfast.non_max_suppress(jfast.fast_score(
        jnp.asarray(world["img"]), 0.08, 9)))
    score[100, 200] = score[100, 201] = 5.0          # plateau tie
    score[7, 9] = score[230, 310] = 4.0              # distant tie
    score[50, 60] = 4.0
    k = int((score > 0).sum()) + 5                   # reaches the zeros
    yx, vals = fast.top_corners(t(score), k)
    jyx, jvals = jfast.top_corners(jnp.asarray(score), k)
    np.testing.assert_array_equal(n(yx), np.asarray(jyx))
    np.testing.assert_array_equal(n(vals), np.asarray(jvals))
    assert n(yx)[:5].tolist() == [[100, 200], [100, 201], [7, 9], [50, 60],
                                  [230, 310]]


def test_top_k_orders_ties_lowest_index_first():
    x = torch.tensor([[1.0, 3.0, 3.0, 0.0, 3.0, 1.0],
                      [0.0, 0.0, 0.0, 0.0, 0.0, 0.0]])
    vals, idx = fast.top_k(x, 4)
    assert idx.tolist() == [[1, 2, 4, 0], [0, 1, 2, 3]]
    assert vals.tolist() == [[3.0, 3.0, 3.0, 1.0], [0.0] * 4]


def test_describe_equal_bits_jax():
    img = _noisy_image(1)
    rng = np.random.default_rng(2)
    # Interior keypoints and ones the support clip moves off the border.
    yx = np.concatenate([rng.integers(0, 48, (20, 1)),
                         rng.integers(0, 64, (20, 1))], axis=1)
    yx = np.concatenate([yx, [[0, 0], [47, 63], [3, 60]]]).astype(np.int32)
    got = descriptor.describe(t(img), torch.tensor(yx))
    want = np.asarray(jdesc.describe(jnp.asarray(img), jnp.asarray(yx)))
    np.testing.assert_array_equal(n(got), want)
    assert set(np.unique(want)) == {-1.0, 1.0}


def test_describe_regions_equal_jax():
    """Regions cut from a zero-padded smoothed plane, anchors negative at
    the border (the shared-window form): the JAX one-hot extraction and
    the port's gather give the same bits, equal to describe_presmoothed at
    the candidates."""
    img = _noisy_image(3)
    H, W = img.shape
    R, C, r = 4, 5, descriptor.PATCH // 2
    W2, RG = 2 * R + 1, 2 * R + 1 + 2 * r
    sm = np.asarray(jdesc._smooth3(jnp.asarray(img)))
    plane = np.pad(sm, r)
    rng = np.random.default_rng(4)
    u0 = np.array([0, W - W2, 17, 30], np.int32)
    v0 = np.array([0, H - W2, 20, 5], np.int32)
    regions = np.stack([plane[v:v + RG, u:u + RG] for u, v in zip(u0, v0)])
    wy = rng.integers(0, W2, (4, C)).astype(np.int32)
    wx = rng.integers(0, W2, (4, C)).astype(np.int32)
    args = (regions, u0 - r, v0 - r, u0, v0, wy, wx)
    want = np.asarray(jdesc.describe_regions(
        *(jnp.asarray(a) for a in args), H, W))
    got = descriptor.describe_regions(*(torch.tensor(a) for a in args), H, W)
    np.testing.assert_array_equal(n(got), want)
    yx = torch.tensor(np.stack([v0[:, None] + wy, u0[:, None] + wx], -1))
    np.testing.assert_array_equal(
        n(descriptor.describe_presmoothed(t(sm), yx)), want)


def test_extract_patch_anchored_rounds_half_to_even_and_clamps():
    img = _noisy_image(5)
    centers = np.array([[10.5, 11.5], [2.5, 3.5], [63.0, 47.9], [30.2, 0.0],
                        [12.49, 20.51]])
    got, u0, v0 = ncc.extract_patch_anchored(t(img), t(centers), 4)
    want, ju0, jv0 = jax.vmap(
        lambda c: jncc.extract_patch_anchored(jnp.asarray(img), c, 4))(
            jnp.asarray(centers))
    np.testing.assert_array_equal(n(got), np.asarray(want))
    np.testing.assert_array_equal(n(u0), np.asarray(ju0))
    np.testing.assert_array_equal(n(v0), np.asarray(jv0))
    assert n(u0).tolist()[:2] == [6, 0]               # round(10.5) = 10


def test_warp_helpers_match_jax(world):
    """inv3, the plane homography, the corrected inverse map and
    _inv_affine at f64 on the world's slots."""
    jst, xp, tc, jc = world["jman"], world["xp"], world["tc"], world["jc"]
    japp = world["japp"]
    p_w = jax.vmap(jfront.landmark_world_points)(jst)
    got_pw = frontend.landmark_world_points(port_state(jst))
    np.testing.assert_allclose(n(got_pw), np.asarray(p_w), rtol=1e-13,
                               atol=1e-13)
    pose = np.asarray(japp.init_pose)
    H = jax.vmap(jax.vmap(
        lambda po, p, x: jwarp.plane_homography(po[:3], po[3:7], x[:3],
                                                x[3:7], p, jc.camera),
        in_axes=(0, 0, None)))(pose, p_w, xp)
    got = patch_warp.plane_homography(
        t(pose[..., :3]), t(pose[..., 3:7]), t(xp[:, None, :3]),
        t(xp[:, None, 3:7]), t(p_w), tc.camera)
    np.testing.assert_allclose(n(got), np.asarray(H), rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(n(patch_warp.inv3(got)),
                               np.linalg.inv(np.asarray(H)), rtol=1e-9,
                               atol=1e-12)
    h = np.asarray(world["h"])
    want = jax.vmap(jax.vmap(lambda Hm, c: jwarp.distortion_corrected_hinv(
        Hm, c, jc.camera)))(H, h)
    got_c = patch_warp.distortion_corrected_hinv(t(H), t(h), tc.camera)
    np.testing.assert_allclose(n(got_c), np.asarray(want), rtol=1e-10,
                               atol=1e-10)
    A = n(got_c).copy()
    A[..., 2, :] = [0.0, 0.0, 1.0]
    np.testing.assert_allclose(n(patch_warp._inv_affine(t(A))),
                               np.asarray(jwarp._inv_affine(jnp.asarray(A))),
                               rtol=1e-12, atol=1e-12)


def _templates_jax(world, distortion="affine"):
    jc = world["jc"]
    p_w = jax.vmap(jfront.landmark_world_points)(world["jman"])
    return jax.vmap(lambda a, x, p, hn: jwarp.predict_appearance(
        a.patches, a.init_pose, x[:13], p, a.init_px, hn, jc.camera,
        out_size=13, distortion=distortion))(world["japp"], world["xp"], p_w,
                                             world["h"])


def test_predict_appearance_matches_jax(world):
    want = np.asarray(_templates_jax(world))
    p_w = frontend.landmark_world_points(port_state(world["jman"]))
    app = port_app(world["japp"])
    got = patch_warp.predict_appearance(
        app.patches, app.init_pose, t(world["xp"][:, :13]), p_w,
        app.init_px, t(world["h"]), world["tc"].camera, 13)
    assert got.shape == (B, 24, 13, 13)
    np.testing.assert_allclose(n(got), want, rtol=0, atol=1e-10)
    assert np.abs(want).max() > 0.2                   # real patches
    # The per-pixel form ("exact"), once unported, on the same slots.
    got = patch_warp.predict_appearance(
        app.patches, app.init_pose, t(world["xp"][:, :13]), p_w,
        app.init_px, t(world["h"]), world["tc"].camera, 13, "exact")
    np.testing.assert_allclose(n(got), np.asarray(_templates_jax(
        world, "exact")), rtol=0, atol=1e-10)


@pytest.mark.parametrize("dtype,tol", [(np.float32, 2e-4),
                                       (np.float64, 1e-10)],
                         ids=["f32", "f64"])
def test_ncc_scores_all_matches_jax(dtype, tol):
    """Random windows and templates (tests/test_vision.py's NCC case):
    scores within tol, identical argmax."""
    rng = np.random.default_rng(3)
    win = rng.uniform(0, 1, (7, 37, 37)).astype(dtype)
    tpl = rng.uniform(0, 1, (7, 13, 13)).astype(dtype)
    want = np.asarray(jncc.ncc_scores_all(jnp.asarray(win),
                                          jnp.asarray(tpl)))
    got = n(ncc.ncc_scores_all(torch.tensor(win), torch.tensor(tpl)))
    assert got.dtype == dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    np.testing.assert_array_equal(got.reshape(7, -1).argmax(-1),
                                  want.reshape(7, -1).argmax(-1))


def _matcher_inputs(world):
    return (t(world["h"]), t(world["S"]), torch.tensor(
        np.asarray(world["matchable"])))


def test_match_all_equal_jax(world):
    jc = world["jc"]
    v = jc.vision
    tpl = _templates_jax(world)
    img = jnp.asarray(world["img"])
    jz, jscore, jfound = jax.vmap(lambda tp, h, S, m: jncc.match_all(
        img, tp, h, S, m, jc.matching.chi2_inv_2_95, v.search_radius,
        v.min_ncc))(tpl, world["h"], world["S"], world["matchable"])
    h, S, m = _matcher_inputs(world)
    z, score, found = ncc.match_all(t(world["img"]), t(tpl), h, S, m,
                                    jc.matching.chi2_inv_2_95,
                                    v.search_radius, v.min_ncc)
    np.testing.assert_array_equal(n(found), np.asarray(jfound))
    np.testing.assert_array_equal(n(z), np.asarray(jz))
    np.testing.assert_allclose(n(score), np.asarray(jscore), rtol=0,
                               atol=1e-10)
    assert int(n(found).sum()) >= 10


def test_match_all_descriptor_equal_jax(world):
    jc, tc = pixels_config(matcher="descriptor")
    img = jnp.asarray(world["img"])
    want = jax.vmap(lambda d, h, S, m: jfront.match_all_descriptor(
        img, d, h, S, m, jc))(world["japp"].descr, world["h"], world["S"],
                              world["matchable"])
    h, S, m = _matcher_inputs(world)
    got = frontend.match_all_descriptor(
        frontend.prepare_frame(t(world["img"]), tc), t(world["japp"].descr),
        h, S, m, tc)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g), np.asarray(w))
    assert int(n(got[2]).sum()) >= 10


@pytest.mark.parametrize("matcher", ["ncc", "descriptor"])
def test_measure_at_prior_matches_jax(world, matcher):
    jc, tc = pixels_config(matcher=matcher)
    img = jnp.asarray(world["img"])
    want = jax.vmap(lambda s, a, xp, Pp: jfront.measure_at_prior(
        s, a, img, xp, Pp, jc))(world["jman"], world["japp"], world["xp"],
                                world["Pp"])
    got = frontend.measure_at_prior(
        port_state(world["jman"]), port_app(world["japp"]),
        frontend.prepare_frame(t(world["img"]), tc), t(world["xp"]),
        t(world["Pp"]), tc)
    z, found, h, vis, r = got
    np.testing.assert_array_equal(n(found), np.asarray(want[1]))
    np.testing.assert_array_equal(n(vis), np.asarray(want[3]))
    np.testing.assert_allclose(n(h), np.asarray(want[2]), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(n(r), np.asarray(want[4]), rtol=1e-12)
    np.testing.assert_array_equal(n(z)[n(found)],
                                  np.asarray(want[0])[n(found)])


def test_select_new_feature_pixels_equal_jax(world):
    jc, tc = world["jc"], world["tc"]
    img = jnp.asarray(world["img"])
    juv, jmask = jax.vmap(lambda h, v: jfront.select_new_feature_pixels(
        img, h, v, jc))(world["h"], world["vis"])
    uv, mask = frontend.select_new_feature_pixels(
        frontend.prepare_frame(t(world["img"]), tc), t(world["h"]),
        torch.tensor(np.asarray(world["vis"])), tc)
    assert uv.shape == (B, 10, 2)
    np.testing.assert_array_equal(n(uv), np.asarray(juv))
    np.testing.assert_array_equal(n(mask), np.asarray(jmask))
    assert int(n(mask).sum()) > 0


def test_store_appearance_equal_jax(world):
    """Distinct slots per instance, some candidates assigned nowhere."""
    jc, tc = world["jc"], world["tc"]
    img = jnp.asarray(world["img"])
    uv, _ = jax.vmap(lambda h, v: jfront.select_new_feature_pixels(
        img, h, v, jc))(world["h"], world["vis"])
    assigned = np.full((B, 10), -1, np.int32)
    assigned[0, [0, 2, 3]] = [5, 0, 23]
    assigned[1, [1, 9]] = [7, 6]
    want = jax.vmap(lambda a, s, u, g: jfront.store_appearance(
        a, s, img, u, g))(world["japp"], world["jst"], uv,
                          jnp.asarray(assigned))
    got = frontend.store_appearance(
        port_app(world["japp"]), port_state(world["jst"]),
        frontend.prepare_frame(t(world["img"]), tc), t(uv),
        torch.tensor(assigned))
    for f in frontend.APPEARANCE_FIELDS:
        np.testing.assert_array_equal(n(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


def test_appearance_round_trip(world):
    app = port_app(world["japp"])
    back = frontend.appearance_from_numpy(frontend.appearance_to_numpy(app),
                                          "cpu")
    for f in frontend.APPEARANCE_FIELDS:
        torch.testing.assert_close(getattr(back, f), getattr(app, f),
                                   rtol=0, atol=0)
    one = frontend.appearance_from_numpy(
        {f: v[0] for f, v in frontend.appearance_to_numpy(app).items()},
        "cpu")
    assert one.patches.shape == (1, 24, 41, 41)
    fresh = frontend.init_appearance(world["tc"], B, "cpu")
    jfresh = batch(jfront.init_appearance(world["jc"]), B)
    for f in frontend.APPEARANCE_FIELDS:
        np.testing.assert_array_equal(n(getattr(fresh, f)),
                                      np.asarray(getattr(jfresh, f)))


def test_ncc_scores_flat_patches_score_zero_f32():
    """A window of flat background with one blob: every offset whose patch
    misses the blob has variance 0 (its NCC is 0/0) and scores exactly 0 at
    f32, and no score leaves [-1, 1] beyond rounding. The blob's own
    offset still scores ~1."""
    yy, xx = np.mgrid[0:37, 0:37]
    blob = 0.7 * np.exp(-((yy - 8.0) ** 2 + (xx - 9.0) ** 2) / (2 * 1.7 ** 2))
    win = (0.2 + np.where(blob > 1e-9, blob, 0.0)).astype(np.float32)
    tpl = win[2:15, 3:16]
    got = n(ncc.ncc_scores_all(torch.tensor(win[None]),
                               torch.tensor(tpl[None])))[0]
    flat = np.ones((25, 25), bool)
    for oy in range(25):
        for ox in range(25):
            flat[oy, ox] = np.ptp(win[oy:oy + 13, ox:ox + 13]) == 0
    assert flat.sum() > 100
    assert (got[flat] == 0).all()
    assert np.abs(got).max() <= 1 + 1e-5
    assert got[2, 3] > 0.999


def test_flat_floor_lies_above_the_f32_variance_stray(world):
    """ncc.FLAT_EPS holds: over the windows of a real frame, the f32 patch
    variance strays from its f64 value by less than FLAT_EPS units of
    eps·Σwc² (chip_smoke.py reads the same on the card)."""
    h = t(world["h"])
    R = world["tc"].vision.search_radius
    win64, _, _ = ncc.extract_patch_anchored(t(world["img"]), h, R + 6)
    win64 = win64.reshape(-1, *win64.shape[-2:])
    var32, _ = ncc.patch_variance(win64.float(), 13)
    var64, energy = ncc.patch_variance(win64.float().double(), 13)
    stray = ((var32.double() - var64).abs()
             / (torch.finfo(torch.float32).eps * energy[:, None, None]))
    assert 0 < float(stray.max()) < ncc.FLAT_EPS
