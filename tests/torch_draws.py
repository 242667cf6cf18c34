"""JAX's augmentation and training draws, replayed from the keys the JAX
package's functions split (ekf_slam_tpu/models/augment.py:87, 124, 131,
144, 168, 200; train.py:97-101), as the port's draw tuples: the parity
tests hand them to ekf_slam_tpu_torch.models.augment and train."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ekf_slam_tpu_torch.models import augment, train


def _t(a):
    return torch.tensor(np.asarray(a))


def jax_dst(key, B, max_warp, dt=jnp.float64):
    """rand_warp's corners (B, 4, 2) as JAX draws them from `key`."""
    kx1, kx2, ky1, ky2 = jax.random.split(key, 4)
    u = lambda k, lo, hi: jax.random.uniform(k, (B, 2, 1), dt, lo, hi)
    rx = jnp.concatenate([u(kx1, -1.0, -1.0 + max_warp),
                          u(kx2, 1.0 - max_warp, 1.0)], axis=1)
    ry = jnp.concatenate([u(ky1, -1.0, -1.0 + max_warp),
                          u(ky2, 1.0 - max_warp, 1.0)], axis=2)
    return _t(jnp.concatenate([rx, ry.reshape(B, 4, 1)], axis=2))


def jax_seasonal(key, shape, severity, n_occluders=3, dt=jnp.float64):
    B, H, W, C = shape
    kg, kn, kb, kv, kf = jax.random.split(key, 5)
    u = lambda k, s, lo, hi: _t(jax.random.uniform(k, s, dt, lo, hi))
    occ = (B, n_occluders, 1, 1, 1)
    return augment.SeasonalDraws(
        u(kg, (B, 4, 5, 1), 1.0 - 0.6 * severity, 1.0 + 0.6 * severity),
        _t(jax.random.normal(kn, shape, dt)),
        u(kb, occ, 0.0, H), u(kv, occ, 0.0, W), u(kf, (B, 1, 1, C), 0.3, 0.7))


def jax_positive(key, B, dt=jnp.float64):
    kf, kw, kb = jax.random.split(key, 3)
    return augment.PositiveDraws(
        _t(jax.random.bernoulli(kf, 0.5, (B,))), jax_dst(kw, B, 0.5, dt),
        _t(jax.random.uniform(kb, (B, 1, 1, 1), dt, -0.8, 0.0)))


def jax_eval(key, shape, severity, dt=jnp.float64):
    kw, kb, ks = jax.random.split(key, 3)
    return augment.EvalDraws(
        jax_dst(kw, shape[0], 0.3, dt),
        _t(jax.random.uniform(kb, (shape[0], 1, 1, 1), dt, -0.5, 0.0)),
        jax_seasonal(ks, shape, severity, dt=dt) if severity > 0 else None)


def jax_crop(key, shape, out_hw, per_image=True):
    B, H, W, _ = shape
    ky, kx = jax.random.split(key)
    s = (B,) if per_image else ()
    return (_t(jax.random.randint(ky, s, 0, H - out_hw[0] + 1)).long(),
            _t(jax.random.randint(kx, s, 0, W - out_hw[1] + 1)).long())


def jax_train_keys(rng, severity):
    """(k_crop, k_aug, k_sev or None, k_rep1) as train_step splits rng:
    four keys at severity 0, five above (train.py:97-101)."""
    if severity > 0.0:
        k_crop, k_aug, k_sev, k_rep1, _ = jax.random.split(rng, 5)
    else:
        (k_crop, k_aug, k_rep1, _), k_sev = jax.random.split(rng, 4), None
    return k_crop, k_aug, k_sev, k_rep1


def jax_train_draws(model, variables, tcfg, images, labels, rng):
    """The port's TrainDraws of JAX's train_step(..., rng) on f32 images:
    the crop, the positive view's and the seasonal draws replayed, and
    the reparameterization noise recovered from JAX's own apply with the
    same rngs as eps = (z − mu) / √exp(log_sig_sq)."""
    from ekf_slam_tpu.models import augment as jaug
    k_crop, k_aug, k_sev, k_rep1 = jax_train_keys(rng, tcfg.aug_severity)
    B = images.shape[0]
    crop = None
    if images.shape[1:3] != tuple(tcfg.image_hw):
        crop = jax_crop(k_crop, images.shape, tcfg.image_hw)
        images, _ = jaug.random_crop(k_crop, images, labels, tcfg.image_hw)
    shape = (B,) + tuple(tcfg.image_hw) + (3,)
    outs, _ = jax.jit(lambda v, x, k: model.apply(
        v, x, train=True, mutable=["batch_stats"],
        rngs={"reparam": k}))(variables, images, k_rep1)
    eps = (outs["z"] - outs["mu"]) / jnp.sqrt(jnp.exp(outs["log_sig_sq"]))
    return train.TrainDraws(
        crop, jax_positive(k_aug, B, jnp.float32),
        jax_seasonal(k_sev, shape, tcfg.aug_severity, dt=jnp.float32)
        if k_sev is not None else None, _t(eps))
