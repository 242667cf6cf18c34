"""The port's CALC2 training (ekf_slam_tpu_torch.models.train) against the
JAX package's untouched train.train_step, and the training loop.

One step at width 8, 32x32, batch 3 on an oversized 40x44 batch (so the
random crop runs), at aug_severity 0 (JAX's four-key layout) and 1.5
(five keys): the port starts from JAX's initial state (vss.from_flax)
and is handed JAX's draws (tests/torch_draws.py; the reparameterization
noise recovered from JAX's own apply). Then step 2 from JAX's state after
step 1 carried across by from_flax_state. The port runs at f64, JAX in
f32, so the tolerances are JAX's f32 rounding:
* the metrics to 1e-5 relative (measured ≤ 1.5e-6);
* Adam's first moment (0.1 x the clipped gradient after step 1) to
  2e-4 of each tensor's largest entry (measured ≤ 5e-5);
* the running statistics to 2e-5 of their scale, and each step's
  increment to 1e-3 relative (+ 2e-7 of the value);
* the new weights to 1e-6 where |mu| > 1e-2 of the tensor's largest:
  Adam's first step is lr·sign(g), decided by rounding where g is ~0.

Also: the clip and Adam against optax at f64 (1e-12), the loss falling
over 5 steps, fit with its checkpoint sweep and a save / restore round
trip."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ekf_slam_tpu.models import train as jtrain
from ekf_slam_tpu.models import vss as jvss
from ekf_slam_tpu_torch.data import synthetic
from ekf_slam_tpu_torch.models import train, vss
from ekf_slam_tpu_torch.utils.metrics import MetricsLogger
from torch_draws import jax_train_draws

torch.set_num_threads(1)

HW, BIG, B = (32, 32), (40, 44), 3


def _adam_mu(opt_state):
    return opt_state[1][0].mu


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_run():
    """{severity: (JAX states 0, 1, 2, the two keys, the batch)}."""
    model = jtrain.create_model(jvss.VSSConfig(width=8))
    rng = np.random.default_rng(0)
    imgs = rng.uniform(0, 1, (B,) + BIG + (3,)).astype(np.float32)
    labels = np.eye(13, dtype=np.float32)[rng.integers(0, 13, (B,) + BIG)]
    w = (1 / np.maximum(labels.mean((0, 1, 2)), 1e-3)).astype(np.float32)
    batch = tuple(map(jnp.asarray, (imgs, labels, w)))
    out = {}
    for sev in (0.0, 1.5):
        tcfg = jtrain.TrainConfig(batch_size=B, image_hw=HW,
                                  aug_severity=sev)
        st0 = jax.jit(jtrain.init_state, static_argnums=(0, 1))(
            model, tcfg, jax.random.key(0))
        step = jax.jit(lambda s, i, l, w_, r: jtrain.train_step(
            model, tcfg, s, i, l, w_, r))
        keys = (jax.random.key(11), jax.random.key(12))
        st1, m1 = step(st0, *batch, keys[0])
        st2, m2 = step(st1, *batch, keys[1])
        out[sev] = (model, tcfg, (st0, st1, st2), (m1, m2), keys, batch)
    return out


def _draws(model, tcfg, st, batch, key):
    d = jax_train_draws(model, {"params": st.params,
                                "batch_stats": st.batch_stats},
                        tcfg, batch[0], batch[1], key)
    f64 = lambda t: None if t is None else type(t)(*(
        x.double() if x.is_floating_point() else x for x in t))
    return train.TrainDraws(d.crop, f64(d.positive), f64(d.seasonal),
                            d.eps.double())


def _check_step(ps, pm, jst_before, jst, jm):
    """The port's state after a step against JAX's (module docstring)."""
    for k in jm:
        assert abs(float(pm[k]) - float(jm[k])) <= 1e-5 * abs(float(jm[k])), \
            (k, float(pm[k]), float(jm[k]))
    model = ps.model
    mu = vss.from_flax({"params": _np(_adam_mu(jst.opt_state)),
                        "batch_stats": _np(jst.batch_stats)})
    new = vss.from_flax({"params": _np(jst.params),
                         "batch_stats": _np(jst.batch_stats)})
    old = vss.from_flax({"params": _np(jst_before.params),
                         "batch_stats": _np(jst_before.batch_stats)})
    sd = model.state_dict()
    checked = 0
    for name, p in model.named_parameters():
        ref_mu = mu[name].double()
        scale = float(ref_mu.abs().max())
        got_mu = ps.optimizer.state[p]["exp_avg"]
        assert float((got_mu - ref_mu).abs().max()) <= 2e-4 * scale, name
        sure = ref_mu.abs() > 1e-2 * scale
        dp = (p.detach() - new[name].double())[sure].abs()
        assert float(dp.max()) <= 1e-6, name
        checked += int(sure.sum())
        assert float((p.detach() - old[name].double()).abs().max()) > 0
    assert checked > 1000
    for k, v in sd.items():
        if "running" in k:
            ref, prev = new[k].double(), old[k].double()
            scale = float(ref.abs().max())
            assert float((v - ref).abs().max()) <= 2e-5 * max(scale, 1.0), k
            inc, ref_inc = v - prev, ref - prev
            assert float((inc - ref_inc).abs().max()) <= (
                1e-3 * float(ref_inc.abs().max()) + 2e-7 * scale), k


@pytest.mark.parametrize("severity", [0.0, 1.5])
def test_train_step_matches_jax(jax_run, severity):
    model, jt, (st0, st1, _), (m1, _), keys, batch = jax_run[severity]
    port = vss.VSS(vss.VSSConfig(width=8), HW)
    port.load_state_dict(vss.from_flax({"params": _np(st0.params),
                                        "batch_stats": _np(st0.batch_stats)}))
    tcfg = train.TrainConfig(batch_size=B, image_hw=HW,
                             aug_severity=severity)
    state = train.init_state(port.double(), tcfg)
    state, pm = train.train_step(
        tcfg, state, *(torch.tensor(np.asarray(a)).double() for a in batch),
        draws=_draws(model, jt, st0, batch, keys[0]))
    assert state.step == 1 and set(pm) == set(m1)
    _check_step(state, pm, st0, st1, m1)


@pytest.mark.parametrize("severity", [0.0, 1.5])
def test_second_step_from_a_carried_jax_state(jax_run, severity):
    """JAX's state after step 1 (weights, statistics, optax's Adam state,
    step) through from_flax_state, then step 2 in both packages."""
    model, jt, (_, st1, st2), (_, m2), keys, batch = jax_run[severity]
    tcfg = train.TrainConfig(batch_size=B, image_hw=HW,
                             aug_severity=severity)
    state = train.from_flax_state(_np(st1.params), _np(st1.batch_stats),
                                  _np(st1.opt_state), _np(st1.step), HW,
                                  tcfg)
    assert state.step == 1 and state.model.cfg == vss.VSSConfig(width=8)
    state.model.double()
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            s = state.optimizer.state[p]
            s["exp_avg"], s["exp_avg_sq"] = (s["exp_avg"].double(),
                                             s["exp_avg_sq"].double())
    state, pm = train.train_step(
        tcfg, state, *(torch.tensor(np.asarray(a)).double() for a in batch),
        draws=_draws(model, jt, st1, batch, keys[1]))
    assert state.step == 2
    _check_step(state, pm, st1, st2, m2)


def test_clip_and_adam_are_optax():
    """clip_by_global_norm_ + torch Adam against optax's chain at f64 over
    three steps, the norm below and above the clip."""
    rng = np.random.default_rng(1)
    params = [rng.normal(size=(4, 3)), rng.normal(size=(5,))]
    tx = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(1e-3))
    jp = [jnp.asarray(p) for p in params]
    js = tx.init(jp)
    tp = [torch.tensor(p, requires_grad=True) for p in params]
    opt = torch.optim.Adam(tp, lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    for scale in (0.1, 10.0, 3.0):
        grads = [scale * rng.normal(size=p.shape) for p in params]
        upd, js = tx.update([jnp.asarray(g) for g in grads], js, jp)
        jp = optax.apply_updates(jp, upd)
        for p, g in zip(tp, grads):
            p.grad = torch.tensor(g)
        norm = train.clip_by_global_norm_([p.grad for p in tp], 5.0)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(
            [jnp.asarray(g) for g in grads])), rtol=1e-14)
        opt.step()
        for p, q in zip(tp, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(q),
                                       rtol=0, atol=1e-12)


def _tiny(seed=0):
    model = train.create_model(vss.VSSConfig(width=8), HW,
                               torch.Generator().manual_seed(seed))
    tcfg = train.TrainConfig(batch_size=2, image_hw=HW, ckpt_every=2)
    imgs, labels = synthetic.synthetic_batch(
        2, HW, generator=torch.Generator().manual_seed(seed + 1))
    return model, tcfg, imgs, labels


def test_loss_falls_over_five_steps():
    """The port alone, as tests/test_models.py holds JAX: every metric
    finite each step, the loss lower after five steps on one batch."""
    model, tcfg, imgs, labels = _tiny()
    state = train.init_state(model, tcfg)
    w = synthetic.class_weights(labels)
    gen = torch.Generator().manual_seed(2)
    losses = []
    for _ in range(5):
        state, m = train.train_step(tcfg, state, imgs, labels, w,
                                    generator=gen)
        assert all(bool(torch.isfinite(v)) for v in m.values()), m
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses


def test_fit_checkpoint_sweep_and_round_trip(tmp_path):
    """fit writes ckpt_0000002 and ckpt_0000004 (ckpt_every 2); the sweep
    picks the later one under a score of the step; a checkpoint restores
    into a fresh model and optimizer to equal tensors."""
    model, tcfg, imgs, labels = _tiny(3)
    logger = MetricsLogger()
    calls = []
    state, metrics = train.fit(model, tcfg, [(imgs, labels)], 4,
                               eval_fn=lambda s, i: calls.append(i),
                               ckpt_dir=str(tmp_path), logger=logger)
    assert state.step == 4 and calls == [1, 3]
    assert len(logger.series("loss")) == 4 and "grad_norm" in metrics
    fresh = train.init_state(train.create_model(vss.VSSConfig(width=8), HW),
                             tcfg)
    path, score = train.find_best_checkpoint(str(tmp_path), fresh,
                                             lambda s: float(s.step))
    assert path.endswith("ckpt_0000004") and score == 4.0
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, fresh.model.state_dict()[k]), k
    a, b = state.optimizer.state_dict(), fresh.optimizer.state_dict()
    for i, s in a["state"].items():
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(s[k], b["state"][i][k])
    with pytest.raises(RuntimeError, match="size mismatch"):
        train.restore_checkpoint(path, train.init_state(
            train.create_model(vss.VSSConfig(width=16), HW), tcfg))


# --- the drivers, on the CPU at a tiny size -----------------------------------

def test_train_calc2_then_run_loop_closure_with_its_checkpoint(tmp_path):
    """train_calc2 writes train_metrics.jsonl, the checkpoints and
    ckpt_final; run_loop_closure --ckpt restores ckpt_final to the trained
    model's descriptors and runs with --lc-severity on the pixels path."""
    from ekf_slam_tpu_torch import run_loop_closure, train_calc2
    out = tmp_path / "run"
    s = train_calc2.main(["--cpu", "--steps", "3", "--batch", "2", "--width",
                          "4", "--hw", "32", "32", "--ckpt-every", "2",
                          "--out", str(out)])
    assert (out / "ckpt_0000002").is_file() and (out / "ckpt_final").is_file()
    rows = (out / "train_metrics.jsonl").read_text().splitlines()
    assert len(rows) == 3 and 0.0 <= s["auc"] <= 1.0
    assert np.isfinite([s["loss_first"], s["loss_last"], s["steps_per_s"]]
                       ).all()
    model = run_loop_closure.load_vss(vss.VSSConfig(width=4), (32, 32),
                                      str(out / "ckpt_final"))
    assert not model.training
    ref = train.create_model(vss.VSSConfig(width=4), (32, 32),
                             torch.Generator().manual_seed(0))
    state = train.restore_checkpoint(str(out / "ckpt_final"),
                                     train.init_state(ref, train.TrainConfig(
                                         image_hw=(32, 32))))
    assert state.step == 3
    imgs = torch.rand(3, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a = model(imgs, descriptor_only=True)["descriptor"]
        b = state.model.eval()(imgs, descriptor_only=True)["descriptor"]
    assert torch.equal(a, b)
    summary = run_loop_closure.main([
        "--cpu", "--frontend", "pixels", "--traj", "pan", "--frames", "12",
        "--ckpt", str(out / "ckpt_final"), "--vss-width", "4", "--vss-hw",
        "32", "32", "--lc-severity", "0.5", "--out", str(tmp_path / "lc")])
    assert summary["lc_severity"] == 0.5
    assert np.isfinite([summary["ate_on_p50"], summary["final_on_p50"]]
                       ).all()
    with pytest.raises(RuntimeError, match="size mismatch"):
        run_loop_closure.load_vss(vss.VSSConfig(width=8), (32, 32),
                                  str(out / "ckpt_final"))


def test_lc_severity_corrupts_the_retrieval_input():
    """The harness's corruption: seasonal_change of the grey frame, the
    same draws for the same generator seed, severity 0 the identity."""
    from ekf_slam_tpu_torch import run_loop_closure
    img = torch.rand(40, 56, generator=torch.Generator().manual_seed(2))
    g = lambda: torch.Generator().manual_seed(9000)
    a = run_loop_closure.corrupt(img, 0.5, g())
    assert torch.equal(a, run_loop_closure.corrupt(img, 0.5, g()))
    assert a.shape == img.shape and float((a - img).abs().max()) > 0.05
    torch.testing.assert_close(run_loop_closure.corrupt(img, 0.0, g()), img,
                               rtol=1e-6, atol=0)


def test_calc2_bundled_run(tmp_path):
    """Shards at 40x40 cropped to 32x32, train severity 1, the aliased
    evaluation and its sweep, the G-CALC2 re-rank, the calibrated loop
    run: calc2_metrics.json holds the JAX script's keys, finite."""
    from ekf_slam_tpu_torch import calc2_bundled_run
    res = calc2_bundled_run.main([
        "--cpu", "--steps", "2", "--batch", "4", "--width", "4", "--hw",
        "32", "32", "--data-hw", "40", "40", "--images", "16", "--places",
        "8", "--aliasing", "2", "--aliasing-sweep", "2", "--train-severity",
        "1.0", "--out", str(tmp_path)])
    assert set(res) >= {
        "steps", "width", "hw", "images", "places", "loss_first",
        "loss_last", "pr_auc_untrained", "pr_auc_trained", "pr_auc_gcalc2",
        "loops_declared", "loops_correct", "loop_sim_threshold",
        "eval_severity", "aliasing", "train_aliasing", "train_severity",
        "sim_objective", "sim_tau", "aliasing_sweep", "train_steps_per_s",
        "class_weights", "true_revisit_p50", "aliased_impostor_p50",
        "aliased_impostor_p99", "cross_arch_impostor_p99"}
    for k in ("pr_auc_untrained", "pr_auc_trained", "pr_auc_gcalc2"):
        assert 0.0 <= res[k] <= 1.0, k
    assert len(res["class_weights"]) == 13 and res["loops_declared"] >= 0
    assert (tmp_path / "calc2_metrics.json").exists()
    assert (tmp_path / "ckpt_final").is_file()
    assert len(list((tmp_path / "shards").glob("shard_*.npz"))) == 1
    bf16 = calc2_bundled_run.main([
        "--cpu", "--dtype", "bfloat16", "--steps", "1", "--batch", "4",
        "--width", "4", "--hw", "32", "32", "--images", "16", "--places",
        "8", "--out", str(tmp_path / "bf16")])
    assert bf16["dtype"] == "bfloat16" and np.isfinite(bf16["loss_last"])


@pytest.mark.parametrize("name", ["train_calc2", "calc2_bundled_run"])
def test_training_drivers_take_the_examples_flags(name):
    import importlib
    from test_torch_drivers import _example_flags
    want = _example_flags(name)
    mod = importlib.import_module(f"ekf_slam_tpu_torch.{name}")
    got = {f"--{k.replace('_', '-')}": v
           for k, v in vars(mod.parse_args([])).items()}
    # and the data-parallel ranks (the JAX scripts count JAX's devices)
    assert set(got) == set(want) | {"--world", "--backend"}
    for flag, default in want.items():
        if flag != "--out" and default is not None:
            assert np.all(np.asarray(got[flag]) == np.asarray(default)), flag


def test_training_drivers_default_to_the_card(tmp_path):
    from ekf_slam_tpu_torch import calc2_bundled_run, train_calc2
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults resolve")
    for main in (train_calc2.main, calc2_bundled_run.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--steps", "1", "--out", str(tmp_path)])
