"""The port's models on the multi-process layer: loop_runner.run_online
on the capacity-sharded loop DB, and the data-parallel CALC2 train step
(models/train.make_sharded_train_step) against the step on the global
batch and the JAX package's make_sharded_train_step.

The port runs in gloo ranks on the CPU (tests/torch_parallel_ranks.py,
no JAX in them; numpy in and out). Tolerances: run_online equal to the
unsharded run (declared, match ids, inliers; similarities, x and P to
1e-12). The train step at width 8, 32x32 crops of a 40x44 batch of 4
split 2 x 2, at f64 against the unsharded step on the same draws: the
metrics to 1e-9 relative, Adam's first moment and the new weights and
running statistics to 1e-9 of each tensor's largest entry (measured
~1e-13; the global moments are the mean of the ranks' means, another
summation order); "triplet" and "infonce", and with remat (the
checkpointed blocks rerun their all-reduces in the backward, in the
same order on every rank). Against JAX's data-parallel step (2 devices,
f32, its draws replayed): test_torch_train's tolerances, the metrics to
1e-5 relative and Adam's first moment to 2e-4 of each tensor's
largest entry."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_slam_tpu.models import train as jtrain
from ekf_slam_tpu.models import vss as jvss
from ekf_slam_tpu.parallel import make_mesh as jmake_mesh
from ekf_slam_tpu_torch import train_calc2
from ekf_slam_tpu_torch.models import loop_runner, train, vss
from ekf_slam_tpu_torch.models import loopclosure as lc
from ekf_slam_tpu_torch.parallel import mesh as pmesh
from torch_draws import jax_train_draws
from torch_parallel_ranks import draws_to_numpy, online_rank, train_rank

torch.set_num_threads(1)

# --- run_online on the sharded DB ----------------------------------------------

H, W = 48, 64


def test_run_online_on_the_sharded_db_equals_the_unsharded_run():
    """Width-8 VSS (its own seeded weights) at f64, 10 frames of 2
    instances (five views, then their noisy revisits), capacity 8 over
    data = 2 ranks against the unsharded ring: every output equal."""
    kw = dict(capacity=8, top_k=3, exclude_recent=3, min_db=3,
              sim_threshold=0.0, min_inliers=1, ransac_hypotheses=8,
              consistency_count=2, consistency_window=3)
    rng = np.random.default_rng(1)
    base = rng.uniform(0, 1, (5, 2, H, W, 3))
    imgs = np.concatenate([base, np.clip(
        base + rng.normal(0, 0.01, base.shape), 0, 1)])
    T = imgs.shape[0]
    model = vss.VSS(vss.VSSConfig(width=8), (H, W),
                    torch.Generator().manual_seed(4)).double()
    x0 = np.zeros((2, 37))
    x0[:, 3] = 1.0
    P0 = np.stack([0.1 * np.eye(37)] * 2)
    draws = rng.uniform(size=(T, 2, 3, 8, model.num_kp))
    cfg = lc.LoopConfig(**kw)
    _, x, P, out = loop_runner.run_online(
        model, torch.tensor(imgs), torch.tensor(x0), torch.tensor(P0), cfg,
        torch.tensor(draws), device="cpu")
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    ranks = pmesh.spawn(online_rank, 2, "gloo", sd, (H, W), imgs, x0, P0,
                        kw, draws, 2)
    for r in ranks:
        for f in ("declared", "match_id", "inliers"):
            np.testing.assert_array_equal(r[f], getattr(out, f).numpy())
        np.testing.assert_allclose(r["similarity"], out.similarity.numpy(),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(r["x"], x.numpy(), rtol=0, atol=1e-12)
        np.testing.assert_allclose(r["P"], P.numpy(), rtol=0, atol=1e-12)
        assert r["count"].tolist() == [T, T]
    assert out.declared.any()


# --- the data-parallel train step ----------------------------------------------

HW, BIG, B = (32, 32), (40, 44), 4


@functools.cache
def _batch():
    rng = np.random.default_rng(0)
    imgs = rng.uniform(0, 1, (B,) + BIG + (3,))
    labels = np.eye(13)[rng.integers(0, 13, (B,) + BIG)]
    w = 1 / np.maximum(labels.mean((0, 1, 2)), 1e-3)
    return imgs, labels, w


def _unsharded(sd, vss_kw, tcfg, draws):
    model = vss.VSS(vss.VSSConfig(**vss_kw), HW).double()
    model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    state = train.init_state(model, tcfg)
    metrics = []
    for d in draws:
        state, m = train.train_step(tcfg, state, *(
            torch.tensor(a) for a in _batch()), d)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


CASES = [("triplet", False), ("infonce", False), ("triplet", True)]


@functools.cache
def _cases():
    """For each of CASES: the unsharded run (state, metrics) and the two
    ranks' results of the same two steps (one spawn for all)."""
    todo, refs = [], []
    for objective, remat in CASES:
        vss_kw = {"width": 8, "remat": remat}
        tcfg = train.TrainConfig(batch_size=B, image_hw=HW,
                                 sim_objective=objective)
        model = vss.VSS(vss.VSSConfig(**vss_kw), HW,
                        torch.Generator().manual_seed(1)).double()
        sd = {k: v.numpy() for k, v in model.state_dict().items()}
        g = torch.Generator().manual_seed(2)
        draws = [train.train_draws(tcfg, model, (B,) + BIG + (3,), g, "cpu",
                                   torch.float64) for _ in range(2)]
        refs.append(_unsharded(sd, vss_kw, tcfg, draws))
        todo.append((sd, vss_kw, {"batch_size": B, "image_hw": HW,
                                  "sim_objective": objective}, _batch(),
                     [draws_to_numpy(d) for d in draws]))
    ranks = pmesh.spawn(train_rank, 2, "gloo", todo, 2)
    return {c: (refs[i], [r[i] for r in ranks]) for i, c in enumerate(CASES)}


@pytest.mark.parametrize("objective,remat", CASES)
def test_sharded_train_step_equals_the_global_batch_step(objective, remat):
    """Two steps on 2 ranks against train_step on the whole batch."""
    (state, metrics), ranks = _cases()[(objective, remat)]
    ref_sd = {k: v.numpy() for k, v in state.model.state_dict().items()}
    ref_mu = {n: state.optimizer.state[p]["exp_avg"].numpy()
              for n, p in state.model.named_parameters()}
    for r in ranks:
        for got, ref in zip(r["metrics"], metrics):
            assert set(got) == set(ref)
            for k in ref:
                assert abs(got[k] - ref[k]) <= 1e-9 * abs(ref[k]), k
        for k, v in ref_sd.items():
            if v.dtype.kind == "f":
                assert _rel(r["sd"][k], v) <= 1e-9, k
        for n, v in ref_mu.items():
            assert _rel(r["mu"][n], v) <= 1e-9, n
    np.testing.assert_array_equal(ranks[0]["sd"]["decoder.head.weight"],
                                  ranks[1]["sd"]["decoder.head.weight"])


def test_sharded_train_step_matches_jax():
    """JAX's make_sharded_train_step on 2 devices from its initial state,
    the port's on 2 ranks from the same weights (vss.from_flax) with
    JAX's draws replayed."""
    model = jtrain.create_model(jvss.VSSConfig(width=8))
    jt = jtrain.TrainConfig(batch_size=B, image_hw=HW)
    st0 = jax.jit(jtrain.init_state, static_argnums=(0, 1))(
        model, jt, jax.random.key(0))
    imgs, labels, w = (a.astype(np.float32) for a in _batch())
    batch = tuple(map(jnp.asarray, (imgs, labels, w)))
    key = jax.random.key(11)
    st1, m1 = jtrain.make_sharded_train_step(model, jt, jmake_mesh(data=2))(
        st0, *batch, key)
    variables = {"params": jax.tree.map(np.asarray, st0.params),
                 "batch_stats": jax.tree.map(np.asarray, st0.batch_stats)}
    sd = {k: v.double().numpy() for k, v in vss.from_flax(variables).items()}
    d = jax_train_draws(model, variables, jt, batch[0], batch[1], key)
    d = train.TrainDraws(d.crop, type(d.positive)(*(
        x.double() if x.is_floating_point() else x for x in d.positive)),
        None, d.eps.double())
    r = pmesh.spawn(train_rank, 2, "gloo", [(
        sd, {"width": 8}, {"batch_size": B, "image_hw": HW}, _batch(),
        [draws_to_numpy(d)])], 2)[0][0]
    for k, v in m1.items():
        assert abs(r["metrics"][0][k] - float(v)) <= 1e-5 * abs(float(v)), k
    mu = vss.from_flax({"params": jax.tree.map(
        np.asarray, st1.opt_state[1][0].mu), "batch_stats": jax.tree.map(
        np.asarray, st1.batch_stats)})
    for n, got in r["mu"].items():
        ref = mu[n].double().numpy()
        assert np.abs(got - ref).max() <= 2e-4 * np.abs(ref).max(), n


def test_sharded_train_step_raises_for_an_uneven_batch():
    mesh = pmesh.Mesh(None, ("data",), {"data": 3}, torch.device("cpu"),
                      "gloo")
    model = vss.VSS(vss.VSSConfig(width=8), HW)
    with pytest.raises(ValueError, match="split"):
        train.make_sharded_train_step(model, train.TrainConfig(
            batch_size=4, image_hw=HW), mesh)


def test_train_calc2_data_parallel_equals_one_rank(tmp_path):
    """train_calc2 --world 2 --backend gloo --cpu against --world 1: the
    same metrics a step (to 1e-9 relative, f32 on the CPU ranks in
    another summation order: to 1e-5) and the same PR-AUC."""
    flags = ["--steps", "2", "--batch", "4", "--width", "8", "--hw", "32",
             "32", "--ckpt-every", "2", "--cpu"]
    one = train_calc2.main(flags + ["--out", str(tmp_path / "one")])
    two = train_calc2.main(flags + ["--out", str(tmp_path / "two"),
                                    "--world", "2", "--backend", "gloo"])
    rows = [[__import__("json").loads(x) for x in
             (tmp_path / d / "train_metrics.jsonl").read_text().splitlines()]
            for d in ("one", "two")]
    for a, b in zip(*rows):
        for k in ("loss", "segloss", "simloss", "grad_norm"):
            assert abs(a[k] - b[k]) <= 1e-5 * abs(a[k]), k
    assert (tmp_path / "two" / "ckpt_final").is_file()
    assert abs(one["auc"] - two["auc"]) <= 1e-6 and two["world"] == 2
