"""The port's retrieval evaluation (ekf_slam_tpu_torch.models.evaluate)
against the JAX package's (ekf_slam_tpu.models.evaluate).

* The similarity matrix at f64 to 1e-12; the retrieval scores, the PR
  curve and its area exact (the same NumPy code on the same matrix).
* geometric_rerank at f64 on the same keypoints and descriptors, the
  port handed JAX's RANSAC draws (key split over the live images, then
  over top_k, then over the hypotheses, uniform(k, (K,)) each): labels
  equal, scores to 1e-12.
* evaluate_pairs on eval_view pairs against JAX's with a Flax VSS carried
  across by from_flax: the port runs at f64 and Flax in f32, so the
  similarities agree to Flax's f32 rounding (2e-5, as
  tests/test_torch_vss.py), the labels exactly and the AUC to 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_slam_tpu.models import evaluate as jev
from ekf_slam_tpu.models import keypoints as jkp
from ekf_slam_tpu.models import loopclosure as jlc
from ekf_slam_tpu.models import vss as jvss
from ekf_slam_tpu_torch.models import evaluate, flax_init, vss
from ekf_slam_tpu_torch.models import keypoints as kp_mod
from ekf_slam_tpu_torch.models import loopclosure as lc

torch.set_num_threads(1)


def _unit(a):
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


def _sim_inputs(seed=0, L=12, D=32):
    rng = np.random.default_rng(seed)
    live = _unit(rng.normal(size=(L, D)))
    mem = _unit(live + 0.9 * rng.normal(size=(L, D)))
    return live, mem


def test_similarity_scores_curve_and_auc():
    live, mem = _sim_inputs()
    ref = np.asarray(jev.cosine_similarity_matrix(jnp.asarray(live),
                                                  jnp.asarray(mem)))
    sim = evaluate.cosine_similarity_matrix(torch.tensor(live),
                                            torch.tensor(mem)).numpy()
    np.testing.assert_allclose(sim, ref, rtol=0, atol=1e-12)
    lab, sc = evaluate.nn_retrieval_scores(ref)
    jl, js = jev.nn_retrieval_scores(ref)
    np.testing.assert_array_equal(lab, jl)
    np.testing.assert_array_equal(sc, js)
    assert 0 < lab.sum() < len(lab)
    for a, b in zip(evaluate.precision_recall_curve(lab, sc),
                    jev.precision_recall_curve(jl, js)):
        np.testing.assert_array_equal(a, b)
    assert evaluate.pr_auc(lab, sc) == jev.pr_auc(jl, js)
    assert evaluate.TRAPEZOID == "trapezoid"


def _keypoints(seed=1, L=5, K=24, Dk=16):
    """Live keypoints, and memory ones: image i's moved by a translation
    (a valid epipolar geometry) with its descriptors perturbed and
    reordered; image 3's memory positions scrambled (no geometry)."""
    rng = np.random.default_rng(seed)
    yx = np.stack([rng.uniform(0, 48, (L, K)), rng.uniform(0, 64, (L, K))],
                  -1)
    descr = rng.normal(size=(L, K, Dk))
    perm = np.stack([rng.permutation(K) for _ in range(L)])
    take = lambda a: np.take_along_axis(a, perm[..., None], 1)
    yx_m = take(yx + np.array([1.5, 3.0]))
    yx_m[3] = rng.uniform(0, 48, (K, 2))
    descr_m = take(descr + 0.05 * rng.normal(size=descr.shape))
    return (yx, descr), (yx_m, descr_m)


def _jax_draws(key, L, top_k, nh, K):
    out = []
    for k in jax.random.split(key, L):
        out.append([np.asarray(jax.vmap(lambda h: jax.random.uniform(
            h, (K,)))(jax.random.split(kk, nh)))
            for kk in jax.random.split(k, top_k)])
    return torch.tensor(np.asarray(out))


def test_geometric_rerank_matches_jax():
    live, mem = _sim_inputs(seed=2, L=5)
    (yx, de), (yx_m, de_m) = _keypoints()
    cfg = lc.LoopConfig(min_inliers=10, ransac_hypotheses=16)
    jcfg = jlc.LoopConfig(min_inliers=10, ransac_hypotheses=16)
    key = jax.random.key(9)
    z = np.zeros(yx.shape[:2])
    jk = lambda y, d: jkp.Keypoints(jnp.asarray(y), jnp.asarray(z),
                                    jnp.asarray(z), jnp.asarray(d))
    tk = lambda y, d: kp_mod.Keypoints(torch.tensor(y), torch.tensor(z),
                                       torch.tensor(z), torch.tensor(d))
    jl, js = jev.geometric_rerank(jnp.asarray(live), jk(yx, de),
                                  jnp.asarray(mem), jk(yx_m, de_m), jcfg,
                                  key, top_k=3)
    draws = _jax_draws(key, 5, 3, 16, yx.shape[1])
    gl, gs = evaluate.geometric_rerank(
        torch.tensor(live), tk(yx, de), torch.tensor(mem), tk(yx_m, de_m),
        cfg, top_k=3, draws=draws)
    np.testing.assert_array_equal(gl, np.asarray(jl))
    np.testing.assert_allclose(gs, np.asarray(js), rtol=0, atol=1e-12)
    assert gl.sum() >= 3 and gs[3] == 0.0 and gs.dtype == np.float64


def test_geometric_rerank_draws_from_a_generator():
    live, mem = _sim_inputs(seed=2, L=5)
    (yx, de), (yx_m, de_m) = _keypoints()
    z = torch.zeros(yx.shape[:2], dtype=torch.float64)
    tk = lambda y, d: kp_mod.Keypoints(torch.tensor(y), z, z,
                                       torch.tensor(d))
    cfg = lc.LoopConfig(min_inliers=10, ransac_hypotheses=16)
    run = lambda: evaluate.geometric_rerank(
        torch.tensor(live), tk(yx, de), torch.tensor(mem), tk(yx_m, de_m),
        cfg, top_k=3, generator=torch.Generator().manual_seed(3))
    (a, b), (c, d) = run(), run()
    np.testing.assert_array_equal(a, c)
    np.testing.assert_array_equal(b, d)


@pytest.mark.parametrize("severity", [0.0, 1.0])
def test_evaluate_pairs_matches_jax(severity):
    """8 places at 48x64, their eval_view revisits (JAX's draws), a
    width-8 Flax VSS (Flax's key-0 draw) in both packages."""
    from ekf_slam_tpu.models import augment as jaug
    hw = (48, 64)
    v = flax_init.flax_variables(vss.VSSConfig(width=8), hw, 0)
    mem = np.random.default_rng(3).uniform(0, 1, (8,) + hw + (3,))
    live = np.asarray(jaug.eval_view(jax.random.key(4), jnp.asarray(mem),
                                     severity=severity))
    ref = jev.evaluate_pairs(jvss.VSS(jvss.VSSConfig(width=8)), v,
                             jnp.asarray(live, jnp.float32),
                             jnp.asarray(mem, jnp.float32), batch=4)
    model = vss.VSS(vss.VSSConfig(width=8), hw)
    model.load_state_dict(vss.from_flax(v))
    got = evaluate.evaluate_pairs(model.double().train(), live, mem,
                                  batch=3)
    assert model.training            # restored after the eval-mode embed
    np.testing.assert_allclose(got["similarity"], ref["similarity"],
                               rtol=0, atol=2e-5)
    np.testing.assert_array_equal(got["labels"], ref["labels"])
    assert abs(got["auc"] - ref["auc"]) <= 1e-4
    assert 0.0 <= got["auc"] <= 1.0
