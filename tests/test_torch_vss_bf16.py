"""The port's VSS at compute_dtype "bfloat16" against the JAX package's
bf16 Flax VSS: the forward (eval and train mode) and one train step.

Weights: Flax's initial draw at width 8, 48x64 (models/flax_init.py),
the batch statistics set from a seed, carried across by from_flax (the
parameters are f32 in both packages whatever compute_dtype says). Both
sides compute in bf16 on the CPU with the same cast points, so the
outputs differ by bf16 roundings that land apart where the f32 sums
under them differ in their last bits (XLA's CPU convs and torch's
accumulate bf16 products in f32 in other orders). Tolerances, measured
on this CPU and set with room: the descriptor's cosine to JAX's >= 0.999
in eval and train mode (the floor asked for is 0.995; measured >= 0.99998
in eval, >= 0.99983 in train mode); mu, log_sig_sq, rec, seg, z and c5
within 2e-2 of their largest magnitude in eval mode (measured <= 9.3e-3)
and 8e-2 in train mode, where BatchNorm normalizes by the batch's own
moments (measured <= 3.8e-2). One train step: the metrics to 5e-3
relative (measured <= 1.4e-3); Adam's first moment over all parameters
to 0.25 in relative 2-norm (measured 0.152; JAX's own bf16 model differs
from its f32 one by 0.144 there: bf16's noise in the deep encoder's
gradients), and each decoder and head tensor's to 0.1 of its largest
entry (measured <= 0.06)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_slam_tpu.models import train as jtrain
from ekf_slam_tpu.models import vss as jvss
from ekf_slam_tpu_torch.models import flax_init, train, vss
from torch_draws import jax_train_draws

torch.set_num_threads(1)

HW = (48, 64)
BF16 = vss.VSSConfig(width=8, compute_dtype="bfloat16")


@functools.cache
def _variables():
    v = flax_init.flax_variables(vss.VSSConfig(width=8), HW, 0)
    rng = np.random.default_rng(0)
    v["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.5, 1.5, a.shape) if p[-1].key == "var"
                      else rng.uniform(-0.5, 0.5, a.shape)).astype(
            np.float32), v["batch_stats"])
    return v


def _port():
    m = vss.VSS(BF16, HW)
    m.load_state_dict(vss.from_flax(_variables()))
    return m


def _images(n=4, seed=1):
    return np.random.default_rng(seed).uniform(0, 1, (n,) + HW + (3,)
                                               ).astype(np.float32)


def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(
        b, axis=-1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_bf16_forward_matches_jax(mode):
    imgs = _images()
    model = jvss.VSS(jvss.VSSConfig(width=8, compute_dtype="bfloat16"))
    key = jax.random.key(3)
    train_mode = mode == "train"
    apply = jax.jit(lambda v, x: model.apply(
        v, x, train=train_mode, rng=key,
        mutable=["batch_stats"] if train_mode else False))
    out = apply(_variables(), jnp.asarray(imgs))
    jout = out[0] if train_mode else out
    eps = (jout["z"] - jout["mu"]) / jnp.sqrt(jnp.exp(jout["log_sig_sq"]))
    port = _port().train(train_mode)
    with torch.no_grad():
        pout = port(torch.tensor(imgs), eps=torch.tensor(np.asarray(eps)))
    assert pout["c5"].dtype == torch.bfloat16
    assert jout["c5"].dtype == jnp.bfloat16
    for k in ("descriptor", "mu", "log_sig_sq", "rec", "seg", "z"):
        assert pout[k].dtype == torch.float32, k
    assert _cos(pout["descriptor"].numpy(), jout["descriptor"]).min() \
        >= 0.999
    tol = 8e-2 if train_mode else 2e-2
    for k in ("mu", "log_sig_sq", "rec", "seg", "z", "c5"):
        assert _rel(pout[k].float().numpy(),
                    np.asarray(jout[k], np.float32)) <= tol, k


def test_bf16_is_not_f32():
    """The bf16 model rounds its activations: its descriptor differs from
    the f32 model's on the same weights (by more than f32 rounding) but
    stays within the cosine floor."""
    imgs = torch.tensor(_images())
    f32 = vss.VSS(vss.VSSConfig(width=8), HW)
    f32.load_state_dict(vss.from_flax(_variables()))
    with torch.no_grad():
        a = _port()(imgs, descriptor_only=True)["descriptor"].numpy()
        b = f32(imgs, descriptor_only=True)["descriptor"].numpy()
    cos = _cos(a, b)
    assert cos.min() >= 0.995 and np.abs(a - b).max() > 1e-4


def test_bf16_train_step_matches_jax():
    """One train step (batch 4, 48x64, triplet) from the same weights and
    JAX's draws: the gradients land on the f32 parameters."""
    model = jvss.VSS(jvss.VSSConfig(width=8, compute_dtype="bfloat16"))
    jt = jtrain.TrainConfig(batch_size=4, image_hw=HW)
    st0 = jtrain.TrainState(
        params=jax.tree.map(jnp.asarray, _variables()["params"]),
        batch_stats=jax.tree.map(jnp.asarray, _variables()["batch_stats"]),
        opt_state=jtrain.make_optimizer(jt).init(
            jax.tree.map(jnp.asarray, _variables()["params"])),
        step=jnp.int32(0))
    rng = np.random.default_rng(2)
    imgs = rng.uniform(0, 1, (4,) + HW + (3,)).astype(np.float32)
    labels = np.eye(13, dtype=np.float32)[rng.integers(0, 13, (4,) + HW)]
    w = (1 / np.maximum(labels.mean((0, 1, 2)), 1e-3)).astype(np.float32)
    key = jax.random.key(7)
    st1, jm = jax.jit(lambda s, i, l, ww, r: jtrain.train_step(
        model, jt, s, i, l, ww, r))(st0, jnp.asarray(imgs),
                                    jnp.asarray(labels), jnp.asarray(w), key)
    draws = jax_train_draws(model, _variables(), jt, jnp.asarray(imgs),
                            jnp.asarray(labels), key)
    port = _port()
    state = train.init_state(port, train.TrainConfig(batch_size=4,
                                                     image_hw=HW))
    state, pm = train.train_step(
        train.TrainConfig(batch_size=4, image_hw=HW), state,
        torch.tensor(imgs), torch.tensor(labels), torch.tensor(w), draws)
    assert all(p.dtype == torch.float32 for p in port.parameters())
    for k, v in jm.items():
        assert abs(float(pm[k]) - float(v)) <= 5e-3 * abs(float(v)), (
            k, float(pm[k]), float(v))
    mu = vss.from_flax({"params": jax.tree.map(
        np.asarray, st1.opt_state[1][0].mu), "batch_stats": jax.tree.map(
        np.asarray, st1.batch_stats)})
    num = den = 0.0
    for n, p in port.named_parameters():
        got = state.optimizer.state[p]["exp_avg"].double().numpy()
        ref = mu[n].double().numpy()
        num += float(((got - ref) ** 2).sum())
        den += float((ref ** 2).sum())
        if n.startswith("decoder."):
            assert _rel(got, ref) <= 0.1, n
    assert (num / den) ** 0.5 <= 0.25


def test_from_flax_state_carries_a_bf16_model():
    """from_flax_state with compute_dtype "bfloat16": the same f32
    weights, a bf16 model."""
    v = _variables()
    opt = jtrain.make_optimizer(jtrain.TrainConfig()).init(
        jax.tree.map(jnp.asarray, v["params"]))
    st = train.from_flax_state(
        v["params"], v["batch_stats"], jax.tree.map(np.asarray, opt), 0, HW,
        compute_dtype="bfloat16")
    assert st.model.cfg.compute_dtype == "bfloat16"
    ref = vss.from_flax(v)
    for k, t in st.model.state_dict().items():
        assert torch.equal(t, ref[k]), k


def test_unknown_compute_dtype_raises():
    with pytest.raises(ValueError, match="compute_dtype"):
        vss.VSS(vss.VSSConfig(width=8, compute_dtype="float16"), HW)
