"""The port's CALC2 losses (ekf_slam_tpu_torch.models.losses) against the
JAX package's (ekf_slam_tpu.models.losses) at f64, each term, the total
under both objectives and its gradient: to 1e-12 of scale (both sides
evaluate the same expressions; reductions round apart at ~1e-16)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_slam_tpu.models import losses as jlosses
from ekf_slam_tpu_torch.models import losses

torch.set_num_threads(1)

TOL = 1e-12
B, H, W, D = 4, 8, 10, 24


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(B, D))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dp = d + 0.3 * rng.normal(size=(B, D))
    dp /= np.linalg.norm(dp, axis=1, keepdims=True)
    rec = rng.uniform(0, 1, (B, H, W, 3))
    rec[0, 0, 0] = [0.0, 1.0, 1e-12]            # inside the 1e-10 clamps
    seg = rng.normal(size=(B, H, W, 13)) * 4
    seg[1, 2, 3, 5] = 40.0                      # softmax under 1e-6
    outs = {"descriptor": d, "seg": seg, "rec": rec,
            "mu": rng.normal(size=(B, 2, 3, 56)),
            "log_sig_sq": 0.3 * rng.normal(size=(B, 2, 3, 56))}
    images = rng.uniform(0, 1, (B, H, W, 3))
    labels = np.eye(13)[rng.integers(0, 13, (B, H, W))]
    weights = rng.uniform(0.5, 20.0, 13)
    return outs, dp, images, labels, weights


def _close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0,
                               atol=TOL * max(np.abs(ref).max(), 1.0))


def _t(tree):
    return {k: torch.tensor(v) for k, v in tree.items()} \
        if isinstance(tree, dict) else torch.tensor(tree)


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()} \
        if isinstance(tree, dict) else jnp.asarray(tree)


def test_terms():
    outs, dp, images, labels, w = _inputs()
    to, jo = _t(outs), _j(outs)
    d = outs["descriptor"]
    _close(losses.hard_negative_mine(to["descriptor"]),
           jlosses.hard_negative_mine(jo["descriptor"]))
    dn = np.asarray(jlosses.hard_negative_mine(jo["descriptor"]))
    for margin in (0.5, 2.0):
        _close(losses.triplet_loss(_t(d), _t(dp), _t(dn), margin),
               jlosses.triplet_loss(_j(d), _j(dp), _j(dn), margin))
    for tau in (0.01, 0.5):
        _close(losses.infonce_loss(_t(d), _t(dp), tau),
               jlosses.infonce_loss(_j(d), _j(dp), tau))
    _close(losses.seg_loss(to["seg"], _t(labels), _t(w)),
           jlosses.seg_loss(jo["seg"], _j(labels), _j(w)))
    _close(losses.recon_loss(to["rec"], _t(images)),
           jlosses.recon_loss(jo["rec"], _j(images)))
    _close(losses.kld_loss(to["mu"], to["log_sig_sq"]),
           jlosses.kld_loss(jo["mu"], jo["log_sig_sq"]))


def test_hard_negative_ties_take_the_first_index():
    """Two identical other descriptors: argmax takes the lower index, as
    jnp.argmax does; each row's own similarity never wins."""
    d = np.eye(4)[[0, 1, 1, 2]] * 1.0
    d[3] = d[0]
    got = losses.hard_negative_mine(torch.tensor(d)).numpy()
    ref = np.asarray(jlosses.hard_negative_mine(jnp.asarray(d)))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, d[[3, 2, 1, 0]])


@pytest.mark.parametrize("objective", ["triplet", "infonce"])
def test_total_loss_and_gradient(objective):
    outs, dp, images, labels, w = _inputs(seed=1)
    ref_loss, ref_m = jlosses.total_loss(_j(outs), _j(dp), _j(images),
                                         _j(labels), _j(w), 0.5, objective,
                                         0.05)
    to = {k: v.requires_grad_() for k, v in _t(outs).items()}
    tdp = _t(dp).requires_grad_()
    loss, m = losses.total_loss(to, tdp, _t(images), _t(labels), _t(w),
                                0.5, objective, 0.05)
    assert set(m) == set(ref_m)
    for k in m:
        _close(m[k], ref_m[k])
    _close(loss, ref_loss)

    def jloss(o, p):
        return jlosses.total_loss(o, p, _j(images), _j(labels), _j(w), 0.5,
                                  objective, 0.05)[0]

    g_o, g_p = jax.grad(jloss, argnums=(0, 1))(_j(outs), _j(dp))
    loss.backward()
    for k in outs:
        _close(to[k].grad, g_o[k])
    _close(tdp.grad, g_p)
