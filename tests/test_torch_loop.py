"""The port's loop-closure path (ekf_slam_tpu_torch: filter/loop_fusion,
models/keypoints, models/loopclosure, models/loop_runner and the
run_loop_closure harness) against the JAX package's.

Inputs are made with numpy from a seed. RANSAC's draws are rebuilt from
JAX's keys exactly as the JAX code splits them (run_online over the
frames, query over top_k, fundamental_ransac over the hypotheses, one
uniform(k, (K,)) a hypothesis) and handed to the port. Tolerances:
loop fusion at f64, x and P to 1e-10; keypoints at f64, positions equal
and values to 1e-12; retrieval at f64: slots, ids, gate decisions and
declarations equal, similarities to 1e-12. Inlier counts are compared
only where the candidate has at least 8 ratio-test matches: with fewer
the 8-point system's null space has more than one dimension and the two
eigen-solvers pick different vectors (gate decisions still agree,
min_inliers being >= 8). run_online runs the JAX side's float32 VSS and
database: similarities to 1e-5 there, and inliers compared only where
the best candidate is also a valid slot."""

import ast
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_slam_tpu.filter import loop_fusion as jfusion
from ekf_slam_tpu.models import keypoints as jkp
from ekf_slam_tpu.models import loop_runner as jrunner
from ekf_slam_tpu.models import loopclosure as jlc
from ekf_slam_tpu.models import vss as jvss
from ekf_slam_tpu_torch import run_loop_closure as harness
from ekf_slam_tpu_torch.filter import loop_fusion
from ekf_slam_tpu_torch.models import flax_init, keypoints, loop_runner
from ekf_slam_tpu_torch.models import loopclosure as lc
from ekf_slam_tpu_torch.models import vss

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOL = 1e-10
# The JAX functions compiled once (eager op-by-op dispatch is slower).
j_pose = jax.jit(jfusion.apply_loop_constraint_pose)
j_position = jax.jit(jfusion.apply_loop_constraint)
j_sigmas = jax.jit(jfusion.loop_noise_sigmas)
j_kp = jax.jit(jkp.kp_descriptor)
j_ransac = jax.jit(jlc.fundamental_ransac, static_argnames="cfg")


def hypothesis_draws(key, n: int, K: int) -> np.ndarray:
    """fundamental_ransac's draws: (n, K)."""
    return np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (K,)))(
        jax.random.split(key, n)))


def query_draws(key, cfg, K: int) -> np.ndarray:
    """query's draws: (top_k, NH, K)."""
    return np.stack([hypothesis_draws(k, cfg.ransac_hypotheses, K)
                     for k in jax.random.split(key, cfg.top_k)])


# --- (b) loop fusion ---------------------------------------------------------

D = 13 + 6 * 4


def _filter_inputs(seed: int, B: int = 2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, D))
    q = rng.normal(size=(B, 4))
    x[:, 3:7] = q / np.linalg.norm(q, axis=1, keepdims=True)
    A = rng.normal(size=(B, D, D))
    P = A @ A.transpose(0, 2, 1) / D + 1e-3 * np.eye(D)
    pose = np.concatenate([x[:, 0:3] + rng.normal(0, 0.1, (B, 3)),
                           x[:, 3:7] + rng.normal(0, 0.05, (B, 4))], axis=1)
    pose[:, 3:7] /= np.linalg.norm(pose[:, 3:7], axis=1, keepdims=True)
    pose[1, 3:7] *= -1.0             # the other hemisphere: the flip engages
    return x, P, pose


@pytest.mark.parametrize("enabled", [(True, True), (False, False),
                                     (True, False)])
@pytest.mark.parametrize("form", ["pose", "position"])
def test_loop_constraint(form, enabled):
    x, P, pose = _filter_inputs(0)
    inliers = np.array([9, 40], np.int32)
    refs = []
    for b in range(2):
        on = jnp.asarray(enabled[b])
        if form == "pose":
            sp, sr = j_sigmas(jnp.asarray(inliers[b]))
            refs.append(j_pose(
                jnp.asarray(x[b]), jnp.asarray(P[b]), jnp.asarray(pose[b]),
                sp, sr, on))
        else:
            refs.append(j_position(
                jnp.asarray(x[b]), jnp.asarray(P[b]),
                jnp.asarray(pose[b, 0:3]), 0.05, on))
    on = torch.tensor(enabled)
    if form == "pose":
        sp, sr = loop_fusion.loop_noise_sigmas(torch.tensor(inliers))
        assert sp.dtype == torch.float32
        np.testing.assert_array_equal(sp.numpy(), np.stack(
            [np.asarray(j_sigmas(jnp.asarray(n))[0])
             for n in inliers]))
        x2, P2 = loop_fusion.apply_loop_constraint_pose(
            torch.tensor(x), torch.tensor(P), torch.tensor(pose), sp, sr, on)
    else:
        x2, P2 = loop_fusion.apply_loop_constraint(
            torch.tensor(x), torch.tensor(P), torch.tensor(pose[:, 0:3]),
            0.05, on)
    for b in range(2):
        np.testing.assert_allclose(x2[b].numpy(), np.asarray(refs[b][0]),
                                   rtol=0, atol=TOL)
        np.testing.assert_allclose(P2[b].numpy(), np.asarray(refs[b][1]),
                                   rtol=0, atol=TOL)
    if enabled[0]:
        assert float(np.abs(P2[0].numpy() - P[0]).max()) > 1e-3


def test_pose_constraint_against_an_empty_slot():
    """An all-zero stored pose (an empty ring slot) under the mask: finite,
    and equal to JAX's (q renormalized, P transformed)."""
    x, P, pose = _filter_inputs(1)
    pose[0] = 0.0
    refs = [j_pose(jnp.asarray(x[b]), jnp.asarray(P[b]),
                   jnp.asarray(pose[b]), 0.5, 0.2, jnp.asarray(False))
            for b in range(2)]
    x2, P2 = loop_fusion.apply_loop_constraint_pose(
        torch.tensor(x), torch.tensor(P), torch.tensor(pose), 0.5, 0.2,
        False)
    assert torch.isfinite(x2).all() and torch.isfinite(P2).all()
    for b in range(2):
        np.testing.assert_allclose(x2[b].numpy(), np.asarray(refs[b][0]),
                                   rtol=0, atol=TOL)
        np.testing.assert_allclose(P2[b].numpy(), np.asarray(refs[b][1]),
                                   rtol=0, atol=TOL)


# --- (c) keypoints -----------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 16, 24, 6), (2, 36, 52, 8)])
def test_kp_descriptor(shape):
    c5 = np.random.default_rng(2).normal(size=shape)
    c5[0, 2, 3, 0] = 100.0                     # a peak in cell 0, channel 0
    c5[1, 0, :, 1] = 50.0                      # a tie along a border row
    ref = j_kp(jnp.asarray(c5))
    got = keypoints.kp_descriptor(torch.tensor(c5))
    assert got.yx.shape == (shape[0], 16 * shape[3], 2)
    np.testing.assert_array_equal(got.yx.numpy(), np.asarray(ref.yx))
    for f in ("response", "orientation", "descr"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=0,
                                   atol=1e-12, err_msg=f)


def test_ratio_test_matches():
    rng = np.random.default_rng(3)
    d2 = rng.normal(size=(2, 30, 16))
    d1 = d2[:, rng.permutation(30)[:20]] + rng.normal(0, 0.3, (2, 20, 16))
    d1[:, :5] = rng.normal(size=(2, 5, 16))    # unmatched ones
    idx, ok = keypoints.ratio_test_matches(torch.tensor(d1), torch.tensor(d2))
    for b in range(2):
        ri, rv = jkp.ratio_test_matches(jnp.asarray(d1[b]),
                                        jnp.asarray(d2[b]))
        np.testing.assert_array_equal(idx[b].numpy(), np.asarray(ri))
        np.testing.assert_array_equal(ok[b].numpy(), np.asarray(rv))
    assert 0 < int(ok.sum()) < ok.numel()


# --- (e) retrieval, verification, temporal consistency -----------------------

@pytest.mark.parametrize("case", ["planar_shift", "random"])
def test_fundamental_ransac(case):
    """test_loopclosure.py's planar shift (every point an inlier of a
    family of F) and random correspondences, with JAX's draws."""
    cfg = lc.LoopConfig(ransac_hypotheses=32, ransac_threshold=1.0)
    jcfg = jlc.LoopConfig(ransac_hypotheses=32, ransac_threshold=1.0)
    pts1 = np.asarray(jax.random.uniform(jax.random.key(2), (64, 2))) * 100.0
    pts2 = (pts1 + np.array([3.0, 0.0]) if case == "planar_shift" else
            np.asarray(jax.random.uniform(jax.random.key(4), (64, 2))) * 100)
    valid = np.ones(64, bool)
    valid[::9] = False
    key = jax.random.key(3)
    ref = int(j_ransac(jnp.asarray(pts1), jnp.asarray(pts2),
                       jnp.asarray(valid), jcfg, key))
    got = lc.fundamental_ransac(
        torch.tensor(pts1), torch.tensor(pts2), torch.tensor(valid), cfg,
        torch.tensor(hypothesis_draws(key, 32, 64)))
    assert int(got) == ref
    if case == "planar_shift":
        assert ref == int(valid.sum())


LCFG = dict(capacity=8, top_k=4, exclude_recent=3, min_db=0,
            sim_threshold=0.8, min_inliers=8, ransac_hypotheses=16,
            consistency_count=2, consistency_window=2)
DD, KP, DK = 16, 24, 8


def _places(seed: int, n_frames: int = 14, n_places: int = 7):
    """Frames 0..6 are distinct places; 7..13 revisit places 0..6: the
    descriptor with noise, the keypoints shifted (2, 1) px with noise and
    their descriptors with noise."""
    rng = np.random.default_rng(seed)
    descr = rng.normal(size=(n_places, DD))
    yx = rng.uniform(0, 60, (n_places, KP, 2))
    kd = rng.normal(size=(n_places, KP, DK))
    f = np.arange(n_frames) % n_places
    rev = (np.arange(n_frames) >= n_places)[:, None]
    d = descr[f] + rev * rng.normal(0, 0.05, (n_frames, DD))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    y = yx[f] + rev[:, :, None] * (np.array([2.0, 1.0])
                                   + rng.normal(0, 0.05, (n_frames, KP, 2)))
    k = kd[f] + rev[:, :, None] * rng.normal(0, 0.05, (n_frames, KP, DK))
    pose = np.concatenate([rng.normal(size=(n_frames, 3)),
                           np.tile([1.0, 0, 0, 0], (n_frames, 1))], axis=1)
    return d, y, k, pose


def test_push_query_temporal_over_a_wrapped_ring():
    """14 frames through a ring of 8 at f64, B = 2 against two JAX
    databases: query, step_temporal, push each frame. The early frames
    query a DB with fewer valid slots than top_k (the −inf ties), the late
    ones a ring that has wrapped."""
    cfg, jcfg = lc.LoopConfig(**LCFG), jlc.LoopConfig(**LCFG)
    data = [_places(s) for s in (4, 5)]
    B, T = 2, 14
    db = lc.init_db(cfg, B, DD, KP, DK, torch.float64, "cpu")
    jdbs = [jlc.init_db(jcfg, DD, KP, DK, jnp.float64) for _ in range(B)]
    jquery = jax.jit(jlc.query, static_argnames="cfg")
    declared_any = False
    for t in range(T):
        kp = keypoints.Keypoints(
            yx=torch.tensor(np.stack([d[1][t] for d in data])),
            response=torch.ones(B, KP), orientation=torch.zeros(B, KP),
            descr=torch.tensor(np.stack([d[2][t] for d in data])))
        descr = torch.tensor(np.stack([d[0][t] for d in data]))
        pose = torch.tensor(np.stack([d[3][t] for d in data]))
        keys = [jax.random.key(100 * b + t) for b in range(B)]
        draws = torch.tensor(np.stack([query_draws(k, jcfg, KP)
                                       for k in keys]))
        res = lc.query(db, descr, kp, cfg, draws)
        db2, decl, slot, frame = lc.step_temporal(db, res, cfg)
        for b in range(B):
            jkps = jkp.Keypoints(*(jnp.asarray(getattr(kp, f)[b].numpy())
                                   for f in jkp.Keypoints._fields))
            r = jquery(jdbs[b], jnp.asarray(descr[b].numpy()), jkps, jcfg,
                       keys[b])
            jdb2, jdecl, jslot, jframe = jlc.step_temporal(jdbs[b], r, jcfg)
            np.testing.assert_array_equal(res.candidate_ids[b].numpy(),
                                          np.asarray(r.candidate_ids))
            np.testing.assert_allclose(res.similarities[b].numpy(),
                                       np.asarray(r.similarities), rtol=0,
                                       atol=1e-12)
            for got, ref in ((res.best_slot, r.best_slot),
                             (res.best_id, r.best_id),
                             (res.is_hypothesis, r.is_hypothesis),
                             (decl, jdecl), (slot, jslot), (frame, jframe),
                             (db2.streak, jdb2.streak),
                             (db2.last_match, jdb2.last_match)):
                assert int(got[b]) == int(ref), t
            best = int(res.best_slot[b])
            _, ok = keypoints.ratio_test_matches(kp.descr[b],
                                                 db.kp_descr[b, best])
            if int(ok.sum()) >= 8:
                assert int(res.best_inliers[b]) == int(r.best_inliers), t
            jdbs[b] = jlc.push(jdb2, jnp.asarray(descr[b].numpy()), jkps,
                               jnp.asarray(pose[b].numpy()))
            declared_any |= bool(jdecl)
        db = lc.push(db2, descr, kp, pose)
        for b in range(B):
            for f in ("descr", "kp_yx", "kp_descr", "pose", "frame_id",
                      "count"):
                np.testing.assert_array_equal(
                    getattr(db, f)[b].numpy(), np.asarray(getattr(jdbs[b], f)))
    assert declared_any
    assert int(db.count[0]) == T and int(db.frame_id[0, 1]) == 9


# --- (f) run_online ----------------------------------------------------------

H, W = 48, 64


def _sequence(seed: int) -> np.ndarray:
    """12 frames (T, H, W, 3): six smooth random views, then the same six
    with pixel noise 0.01."""
    rng = np.random.default_rng(seed)
    base = np.asarray(jax.image.resize(rng.uniform(0, 1, (6, 12, 16, 3)),
                                       (6, H, W, 3), "linear"))
    rev = np.clip(base + rng.normal(0, 0.01, base.shape), 0, 1)
    return np.concatenate([base, rev]).astype(np.float32)


def test_run_online_matches_jax():
    """Width-8 Flax weights carried across, a small LoopConfig, JAX's
    draws rebuilt: per frame equal declared / match_id (and inliers where
    the best candidate is valid and has >= 8 matches), similarity to 1e-5
    (the float32 VSS and database of both packages), final x and P to
    1e-10. The revisits declare loops in both."""
    kw = dict(capacity=16, top_k=3, exclude_recent=4, min_db=4,
              sim_threshold=0.9, min_inliers=10, ransac_hypotheses=16,
              consistency_count=2, consistency_window=3)
    jcfg, cfg = jlc.LoopConfig(**kw), lc.LoopConfig(**kw)
    variables = flax_init.flax_variables(vss.VSSConfig(width=8), (H, W), 0)
    model = jvss.VSS(jvss.VSSConfig(width=8))
    B = 2
    imgs = np.stack([_sequence(s) for s in range(B)], axis=1)  # (T,B,H,W,3)
    T = imgs.shape[0]
    rng = np.random.default_rng(6)
    x0 = np.zeros((B, D))
    x0[:, 3] = 1.0
    x0[:, 0:3] = rng.normal(size=(B, 3))
    P0 = np.stack([0.1 * np.eye(D)] * B)
    keys = jax.random.split(jax.random.key(10), B)
    ref = jax.jit(jax.vmap(
        lambda im, x, P, k: jrunner.run_online(model, variables, im, x, P,
                                               jcfg, k),
        in_axes=(1, 0, 0, 0)))(jnp.asarray(imgs), jnp.asarray(x0),
                               jnp.asarray(P0), keys)
    K = 16 * 8
    draws = np.stack([np.stack([query_draws(k, jcfg, K)
                                for k in jax.random.split(key, T)])
                      for key in keys], axis=1)     # (T, B, top_k, NH, K)
    port = vss.VSS(vss.VSSConfig(width=8), (H, W))
    port.load_state_dict(vss.from_flax(variables))
    db, x, P, out = loop_runner.run_online(
        port, torch.tensor(imgs), torch.tensor(x0), torch.tensor(P0), cfg,
        torch.tensor(draws), device="cpu")
    jout = jax.tree.map(np.asarray, ref[3])       # fields (B, T)
    np.testing.assert_array_equal(out.declared.numpy().T, jout.declared)
    np.testing.assert_array_equal(out.match_id.numpy().T, jout.match_id)
    sim = out.similarity.numpy().T
    fin = np.isfinite(jout.similarity)
    np.testing.assert_array_equal(np.isfinite(sim), fin)
    np.testing.assert_allclose(sim[fin], jout.similarity[fin], rtol=0,
                               atol=1e-5)
    # inliers where the best candidate is a valid slot (finite similarity)
    # with >= 8 ratio-test matches (the ring has not wrapped: frame t sits
    # in slot t). The first frames' candidates are recency-excluded slots:
    # float32 8-point fits to random correspondences, near the Sampson
    # gate, which the two eigensolvers round apart (frame 1: 8 against 6).
    compared = 0
    for b in range(B):
        for t in range(T):
            m = int(out.match_id[t, b])
            if m < 0 or not fin[b, t]:
                continue
            _, ok = keypoints.ratio_test_matches(db.kp_descr[b, t],
                                                 db.kp_descr[b, m])
            if int(ok.sum()) >= 8:
                assert int(out.inliers[t, b]) == int(jout.inliers[b, t])
                compared += 1
    assert compared >= T // 2
    assert jout.declared.sum() >= B
    np.testing.assert_allclose(x.numpy(), np.asarray(ref[1]), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(P.numpy(), np.asarray(ref[2]), rtol=0,
                               atol=TOL)
    assert float(np.abs(P.numpy() - P0).max()) > 1e-3
    assert db.count.tolist() == [T] * B
    assert db.frame_id[:, :T].tolist() == [list(range(T))] * B


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults resolve")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lc.init_db(lc.LoopConfig(capacity=4), 1, 8, 4, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loop_runner.run_online(vss.VSS(vss.VSSConfig(width=2), (16, 16)),
                               torch.zeros(1, 1, 16, 16, 3),
                               torch.zeros(1, D), torch.eye(D)[None],
                               lc.LoopConfig(capacity=4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        harness.main(["--frames", "4"])


# --- (g) the harness ---------------------------------------------------------

def _dict_keys(name: str):
    """Keys of the dict literals the JAX example assigns to `name`
    ("summary") or appends to it ("rows")."""
    tree = ast.parse((ROOT / "examples" / "run_loop_closure.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == name
                        for t in node.targets)):
            return {k.value for k in node.value.keys}
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", None) == "append"
                and getattr(node.func.value, "id", None) == name
                and isinstance(node.args[0], ast.Dict)):
            return {k.value for k in node.args[0].keys}
    raise AssertionError(name)


def test_harness_has_the_examples_flags_and_defaults():
    """The port's parser takes the JAX example's flags, no more, with the
    same defaults."""
    tree = ast.parse((ROOT / "examples" / "run_loop_closure.py").read_text())
    want = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", None) == "add_argument"):
            kw = {k.arg: k.value for k in node.keywords}
            want[node.args[0].value] = (ast.literal_eval(kw["default"])
                                        if "default" in kw else None)
    defaults = vars(harness.parse_args([]))
    got = {f"--{k.replace('_', '-')}": v for k, v in defaults.items()}
    assert set(got) == set(want)
    for flag, default in want.items():
        if flag not in ("--out", "--cpu") and default is not None:
            assert np.all(np.asarray(got[flag]) == np.asarray(default)), flag


@pytest.mark.parametrize("frontend,traj", [("pixels", "pan"),
                                           ("sim", "outback")])
def test_harness_writes_the_examples_summary(tmp_path, frontend, traj):
    out = tmp_path / "s.json"
    summary = harness.main([
        "--cpu", "--frontend", frontend, "--traj", traj, "--frames", "8",
        "--out", str(tmp_path), "--json", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(summary))
    assert set(summary) == _dict_keys("summary")
    assert set(summary["rows"][0]) == _dict_keys("rows")
    assert np.isfinite([summary[k] for k in ("ate_off_p50", "ate_on_p50",
                                             "final_off_p50",
                                             "final_on_p50")]).all()
    assert (tmp_path / "trajectory.npz").exists()


def test_auto_threshold_without_an_impostor_stays_ungated():
    """The reference's behaviour, kept: when the calibration window sees
    no finite similarity, the gate is never set — past the window the
    run is at threshold 0 with declarations unmasked."""
    base = lc.LoopConfig(min_db=8, sim_threshold=0.0)
    auto = harness.AutoThreshold(base)
    assert auto.calib_end == 16
    for n_db in range(30):
        cfg = auto.config(n_db)
        warm = auto.observe(n_db, float("-inf"))
        assert cfg.sim_threshold == 0.0
        assert warm == (n_db >= 16)
    assert auto.imp_max == -1.0
    # with impostors sampled the gate lands halfway to 1
    auto = harness.AutoThreshold(base)
    for n_db in range(20):
        cfg = auto.config(n_db)
        auto.observe(n_db, 0.8)
    assert cfg.sim_threshold == pytest.approx(0.9)


def test_to_vss_matches_jax_resize():
    img = np.random.default_rng(7).uniform(0, 1, (240, 320))
    ref = np.asarray(jax.image.resize(jnp.asarray(img), (48, 64), "linear"))
    got = harness.to_vss(torch.tensor(img), (48, 64))
    assert got.shape == (1, 48, 64, 3)
    np.testing.assert_allclose(got[0, :, :, 1].numpy(), ref, rtol=0,
                               atol=1e-12)


def test_pan_descriptors_match_jax_on_the_ports_world():
    """The harness's retrieval input over bench.py's 150-frame pan, on the
    port's own surround world (drawn from a torch generator, so not the
    JAX example's world): the same trajectory as the example's, and every
    frame rendered, resized and embedded by the key-2 width-8 VSS in both
    packages from the same float32 poses gives the same 150 x 150 cosine
    matrix to 1e-6 (both VSS compute in float32). Which pairs alias is
    then the world's doing."""
    import importlib.util

    from ekf_slam_tpu.sim import scene as jscene
    from ekf_slam_tpu.vision import frontend as jfront
    from ekf_slam_tpu_torch.sim import scene as sim_scene
    from ekf_slam_tpu_torch.vision import frontend

    spec = importlib.util.spec_from_file_location(
        "run_loop_closure_example", ROOT / "examples" / "run_loop_closure.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    T, hw = 150, (48, 64)
    cfg = harness.harness_config()
    xs = harness.pan_trajectory(cfg, T)
    from ekf_slam_tpu.config import EngineConfig, MapConfig, SimConfig
    jc = EngineConfig(map=MapConfig(**{f: getattr(cfg.map, f) for f in (
        "capacity", "min_features_in_image", "max_new_per_step")}),
        sim=SimConfig(**{f: getattr(cfg.sim, f) for f in (
            "num_landmarks", "depth_min", "depth_max", "pixel_noise_std")}))
    # the example's pan at float64 here; the harness runs float32
    np.testing.assert_allclose(xs.numpy(),
                               np.asarray(example.pan_trajectory(jc, T)),
                               rtol=0, atol=1e-5)
    jxs = jnp.asarray(xs.numpy())
    world = harness.make_surround_scene(torch.Generator().manual_seed(0),
                                        cfg)
    variables = flax_init.flax_variables(vss.VSSConfig(width=8), hw, 2)
    port = vss.VSS(vss.VSSConfig(width=8), hw)
    port.load_state_dict(vss.from_flax(variables))
    with torch.no_grad():
        d = port(torch.cat([
            harness.to_vss(frontend.render_scene_image(
                sim_scene.Scene(world.landmarks), xs[t], cfg, "cpu"), hw)
            for t in range(T)]), descriptor_only=True)["descriptor"]
    model = jvss.VSS(jvss.VSSConfig(width=8))
    jscn = jscene.Scene(jnp.asarray(world.landmarks.numpy()))

    @jax.jit
    def j_input(x):
        g = jax.image.resize(jfront.render_scene_image(jscn, x, jc), hw,
                             "linear")
        return jnp.repeat(g[..., None], 3, axis=-1)

    jd = jax.jit(lambda im: model.apply(variables, im, train=False,
                                        descriptor_only=True)["descriptor"])(
        jnp.stack([j_input(jxs[t]) for t in range(T)]))
    d, jd = d.double().numpy(), np.asarray(jd).astype(np.float64)
    assert d.shape == jd.shape == (T, d.shape[1])
    np.testing.assert_allclose(d @ d.T, jd @ jd.T, rtol=0, atol=1e-6)


def test_unported_flags_raise(tmp_path):
    """An orbax checkpoint of the JAX trainer (a directory) cannot be read
    (--ckpt reads the port's own, and --lc-severity is ported:
    tests/test_torch_train.py runs both)."""
    orbax = tmp_path / "ckpt_orbax"
    orbax.mkdir()
    with pytest.raises(ValueError, match="not ported"):
        harness.main(["--cpu", "--ckpt", str(orbax), "--out",
                      str(tmp_path)])
