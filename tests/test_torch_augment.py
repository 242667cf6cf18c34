"""The port's augmentation (ekf_slam_tpu_torch.models.augment) against the
JAX package's (ekf_slam_tpu.models.augment), at f64 on JAX's own draws.

Each random JAX function is run from a key; tests/torch_draws.py replays
the same jax.random.split calls and draws (augment.py:87, 124, 131, 144,
168, 200), and the port is handed their values. Tolerance: 1e-10 of the
output's scale (both sides compute the same f64 expressions; the
homography solve and the grid's linspace round apart at ~1e-15)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_slam_tpu.models import augment as jaug
from ekf_slam_tpu_torch.models import augment
from torch_draws import (jax_crop, jax_dst, jax_eval, jax_positive,
                         jax_seasonal)

torch.set_num_threads(1)

TOL = 1e-10


def _close(got, ref):
    ref = np.asarray(ref)
    got = got.detach().numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=TOL * max(np.abs(ref).max(), 1.0))


def _images(b=3, hw=(24, 32), c=3, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (b,) + hw + (c,))


def test_estimate_hom():
    rng = np.random.default_rng(1)
    src = np.broadcast_to(np.array(augment.CORNERS), (4, 4, 2))
    dst = src * rng.uniform(0.6, 1.3, (4, 4, 2))
    ref = jaug.estimate_hom(jnp.asarray(src), jnp.asarray(dst))
    got = augment.estimate_hom(torch.tensor(src), torch.tensor(dst))
    _close(got, ref)
    mapped = got @ torch.cat([torch.tensor(src),
                              torch.ones(4, 4, 1, dtype=torch.float64)],
                             -1).transpose(1, 2)
    np.testing.assert_allclose((mapped[:, :2] / mapped[:, 2:]).transpose(
        1, 2).numpy(), dst, atol=1e-12)


@pytest.mark.parametrize("scale,out_hw", [(0.8, (24, 32)), (1.4, (20, 28)),
                                          (2.5, (24, 32))])
def test_hom_warp(scale, out_hw):
    """Warps inside the image (0.8) and out past its edges (1.4, 2.5:
    most of the grid clamps), at the input size and a smaller one."""
    imgs = _images()
    rng = np.random.default_rng(2)
    src = np.broadcast_to(np.array(augment.CORNERS), (3, 4, 2))
    dst = src * scale + rng.uniform(-0.1, 0.1, (3, 4, 2))
    H = jaug.estimate_hom(jnp.asarray(src), jnp.asarray(dst))
    ref = jaug.hom_warp(jnp.asarray(imgs), out_hw, H)
    got = augment.hom_warp(torch.tensor(imgs), out_hw,
                           torch.tensor(np.asarray(H)))
    _close(got, ref)
    if scale > 1:
        fx = (np.asarray(dst)[..., 0] + 1) * imgs.shape[2] / 2
        assert (fx < 0).any() or (fx > imgs.shape[2]).any()


@pytest.mark.parametrize("max_warp", [0.5, 0.3])
def test_rand_warp(max_warp):
    imgs = _images()
    key = jax.random.key(3)
    ref = jaug.rand_warp(key, jnp.asarray(imgs), (24, 32), max_warp)
    got = augment.rand_warp(torch.tensor(imgs), (24, 32), max_warp,
                            jax_dst(key, 3, max_warp))
    _close(got, ref)


@pytest.mark.parametrize("per_image", [True, False])
def test_random_crop(per_image):
    imgs = _images(hw=(30, 40))
    labels = np.eye(13)[np.random.default_rng(4).integers(0, 13,
                                                          (3, 30, 40))]
    key = jax.random.key(4)
    ri, rl = jaug.random_crop(key, jnp.asarray(imgs), jnp.asarray(labels),
                              (24, 32), per_image)
    gi, gl = augment.random_crop(
        torch.tensor(imgs), torch.tensor(labels), (24, 32), per_image,
        jax_crop(key, imgs.shape, (24, 32), per_image))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(rl))


def test_positive_view():
    """Both flip branches, and a dark image that keeps the warped view."""
    imgs = _images(b=6)
    imgs[5] *= 0.1
    key = jax.random.key(5)
    draws = jax_positive(key, 6)
    assert 0 < int(draws.flip.sum()) < 6
    ref = jaug.positive_view(key, jnp.asarray(imgs))
    _close(augment.positive_view(torch.tensor(imgs), draws=draws), ref)


@pytest.mark.parametrize("severity", [0.0, 1.0])
def test_eval_view(severity):
    """eval_view splits three keys at every severity (augment.py:168)."""
    imgs = _images()
    key = jax.random.key(6)
    ref = jaug.eval_view(key, jnp.asarray(imgs), severity=severity)
    got = augment.eval_view(torch.tensor(imgs), severity=severity,
                            draws=jax_eval(key, imgs.shape, severity))
    _close(got, ref)


@pytest.mark.parametrize("severity,c,hw", [
    (0.0, 3, (24, 32)), (1.0, 3, (24, 32)), (1.5, 3, (24, 32)),
    (1.0, 1, (37, 53)), (0.5, 3, (4, 5))])
def test_seasonal_change(severity, c, hw):
    """Severities 0 (the identity), 1 and 1.5, a grey
    image at an odd size (run_loop_closure's --lc-severity input) and the
    grid's own size: the gain's bilinear upsampling equals
    jax.image.resize's at the edges."""
    imgs = _images(hw=hw, c=c)
    key = jax.random.key(7)
    ref = jaug.seasonal_change(key, jnp.asarray(imgs), severity)
    got = augment.seasonal_change(torch.tensor(imgs), severity,
                                  draws=jax_seasonal(key, imgs.shape,
                                                     severity))
    _close(got, ref)
    if severity == 0.0:     # the gain's interpolated ones round by an ulp
        np.testing.assert_allclose(got.numpy(), imgs, rtol=1e-15, atol=0)


def test_gain_upsampling_is_jax_resize():
    """The gain field alone, 4 x 5 -> 23 x 37 and -> 4 x 5, against
    jax.image.resize "bilinear"."""
    g = np.random.default_rng(8).uniform(0.4, 1.6, (2, 4, 5, 1))
    for hw in ((23, 37), (4, 5), (8, 10)):
        ref = jax.image.resize(jnp.asarray(g), (2,) + hw + (1,), "bilinear")
        got = torch.nn.functional.interpolate(
            torch.tensor(g).permute(0, 3, 1, 2), size=hw, mode="bilinear",
            align_corners=False).permute(0, 2, 3, 1)
        _close(got, ref)


def test_seasonal_change_refuses_to_shrink_the_grid():
    with pytest.raises(ValueError, match="4 x 5"):
        augment.seasonal_change(torch.zeros(1, 3, 8, 3))


def test_generator_draws():
    """Drawn from a torch generator: within each draw's range, the same
    seed gives the same views, and every function runs on them."""
    imgs = torch.tensor(_images(b=4, hw=(30, 40)))
    g = lambda: torch.Generator().manual_seed(9)
    dst = augment.warp_corners(imgs, 0.5, g())
    src = torch.tensor(augment.CORNERS, dtype=dst.dtype)
    assert ((dst - src).abs() <= 0.5).all() and (dst.abs() <= 1).all()
    d = augment.seasonal_draws(imgs, 1.0, generator=g())
    assert (d.gain >= 0.4).all() and (d.gain <= 1.6).all()
    assert (d.cy < 30).all() and (d.cx < 40).all()
    oy, ox = augment.crop_offsets(imgs, (24, 32), generator=g())
    assert (oy <= 6).all() and (ox <= 8).all()
    for fn in (lambda g_: augment.positive_view(imgs, generator=g_),
               lambda g_: augment.eval_view(imgs, severity=1.0,
                                            generator=g_),
               lambda g_: augment.random_crop(imgs, imgs, (24, 32),
                                              generator=g_)[0]):
        a, b = fn(g()), fn(g())
        assert torch.equal(a, b) and torch.isfinite(a).all()
