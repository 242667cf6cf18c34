"""The port's VSS (ekf_slam_tpu_torch.models.vss) against the JAX
package's Flax VSS (ekf_slam_tpu.models.vss).

Flax VSS weights at width 8 are drawn at 48x64 and at 36x52 (odd sizes
after the second pool: Flax's SAME max pool against the port's
ceil_mode) with descr_source "multi", which holds every parameter
(models/flax_init.py, Flax's own init stream; checked against Flax's
init at width 8, 48x64 and width 16, 36x52); the batch statistics are
then set from a numpy seed (means in [-0.5, 0.5], variances in
[0.5, 1.5]) so that BatchNorm is not the identity.
``from_flax`` carries them across; the d5 and d4 configurations take the
subset they use.

The Flax module computes in float32 whatever the inputs (its convs,
BatchNorm and heads are f32), so the port runs at float64 and the
difference is the JAX side's rounding: every output within 2e-5 of its
largest magnitude (measured ~2e-7). The reparameterization noise eps is
drawn in the test from the key passed to the Flax module as `rng`, and
handed to the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_slam_tpu.models import vss as jvss
from ekf_slam_tpu_torch.models import flax_init, vss

torch.set_num_threads(1)

REL = 2e-5
HWS = [(48, 64), (36, 52)]


@pytest.fixture(scope="module")
def flax_variables():
    """{hw: numpy variables of a Flax multi-source VSS at width 8}: Flax's
    initial draw from key 0 (models/flax_init.py, held to Flax's own by
    test_flax_init_is_flax_init) with batch statistics set from a seed."""
    out = {}
    rng = np.random.default_rng(0)
    for hw in HWS:
        v = flax_init.flax_variables(
            vss.VSSConfig(width=8, descr_source="multi"), hw, 0)
        v["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda p, a: (rng.uniform(0.5, 1.5, a.shape) if p[-1].key == "var"
                          else rng.uniform(-0.5, 0.5, a.shape)).astype(
                np.float32), v["batch_stats"])
        out[hw] = v
    return out


@pytest.mark.parametrize("width,hw", [(8, (48, 64)), (16, (36, 52))])
def test_flax_init_is_flax_init(width, hw):
    """The port's draw of Flax's initial weights is Flax's init, at the
    harness's default size and at another width and an odd input: the
    same tree and shapes as Flax's (jax.eval_shape of the whole init), the
    encoder's and the heads' values to 1e-6 relative (erf⁻¹'s last bits;
    Flax's init with descriptor_only), and decoder and log_sig_sq kernels'
    keys and values as Flax derives and draws them. "multi" holds both
    offsets (the VSS scope's parameter counters 1 and 2)."""
    from flax.core.scope import _fold_in_static
    jcfg = jvss.VSSConfig(width=width, descr_source="multi")
    cfg = vss.VSSConfig(width=width, descr_source="multi")
    key = jax.random.key(2)
    got = flax_init.flax_variables(cfg, hw, 2)

    def init(descriptor_only):
        return jvss.VSS(jcfg).init({"params": key, "reparam": key},
                                   jnp.zeros((1,) + hw + (3,)), train=False,
                                   descriptor_only=descriptor_only)

    scopes = (("Decoder_0", "GroupedConvBNElu_0", "Conv_0"),
              ("Decoder_0", "Conv_0"), ("log_sig_sq",))
    lecun = jax.nn.initializers.lecun_normal()

    def kernel(tree, scope):
        for name in scope:
            tree = tree[name]
        return tree["kernel"]

    @jax.jit
    def flax_draws():
        return init(True), [lecun(_fold_in_static(key, sc + (1,)),
                                  kernel(got["params"], sc).shape,
                                  jnp.float32) for sc in scopes]

    shapes = jax.tree_util.tree_flatten_with_path(
        jax.eval_shape(lambda: init(False)))[0]
    got_leaves = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(shapes) == len(got_leaves)
    for path, s in shapes:
        assert got_leaves[path].shape == s.shape, path
        assert got_leaves[path].dtype == s.dtype, path
    encoder, kernels = flax_draws()
    for path, a in jax.tree_util.tree_flatten_with_path(encoder)[0]:
        np.testing.assert_allclose(got_leaves[path], np.asarray(a),
                                   rtol=1e-6, atol=0, err_msg=str(path))
    for sc, ref in zip(scopes, kernels):
        assert tuple(int(v) for v in flax_init.param_key(
            flax_init.prng_key(2), sc + (1,))) == tuple(
            int(v) for v in jax.random.key_data(
                _fold_in_static(key, sc + (1,))))
        np.testing.assert_allclose(kernel(got["params"], sc),
                                   np.asarray(ref), rtol=1e-6, atol=0)


def _subset(v, source):
    """The variables a descr_source uses."""
    drop = {"d5": ("mu_d4", "offset_d4"), "d4": ("offset",),
            "multi": ()}[source]
    return {"params": {k: p for k, p in v["params"].items()
                       if k not in drop},
            "batch_stats": v["batch_stats"]}


def _images(hw, seed=1, b=2):
    return np.random.default_rng(seed).uniform(
        0, 1, (b,) + hw + (3,)).astype(np.float32)


def _port(cfg, hw, variables):
    m = vss.VSS(cfg, hw)
    m.load_state_dict(vss.from_flax(variables))
    return m.double()


def _close(got, ref, name):
    got = got.detach().numpy()
    ref = np.asarray(ref)
    assert got.shape == ref.shape, name
    err = np.abs(got - ref).max()
    assert err <= REL * max(np.abs(ref).max(), 1e-30), (name, err)


def test_from_flax_shapes_and_order(flax_variables):
    """Every converted tensor has its torch module's shape; Flax's
    construction order maps onto the data flow (ConvBNElu_1 is the
    3x3 w/2 -> w applied after ConvBNElu_2's 1x1)."""
    v = flax_variables[(48, 64)]
    sd = vss.from_flax(v)
    model = vss.VSS(vss.VSSConfig(width=8, descr_source="multi"), (48, 64))
    want = model.state_dict()
    assert set(sd) == set(want)
    for k, t in sd.items():
        assert t.shape == want[k].shape, k
    enc = v["params"]["Encoder_0"]
    assert sd["encoder.blocks.1.conv.weight"].shape == (4, 8, 1, 1)
    np.testing.assert_array_equal(
        sd["encoder.blocks.2.conv.weight"].numpy(),
        enc["ConvBNElu_1"]["Conv_0"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd["encoder.blocks.11.bn.running_var"].numpy(),
        v["batch_stats"]["Encoder_0"]["ConvBNElu_12"]["BatchNorm_0"]["var"])
    assert sd["decoder.blocks.11.conv.weight"].shape == (224, 16, 3, 3)
    with pytest.raises(ValueError, match="GroupedConvBNElu"):
        bad = {"params": dict(v["params"]), "batch_stats": v["batch_stats"]}
        bad["params"]["Decoder_0"] = {
            k: p for k, p in v["params"]["Decoder_0"].items()
            if k != "GroupedConvBNElu_10"}
        vss.from_flax(bad)


@pytest.mark.parametrize("source,intra_norm,hw", [
    (s, i, (48, 64)) for s in ("d5", "d4", "multi") for i in (True, False)]
    + [("multi", True, (36, 52))])
def test_descriptor_and_c5(flax_variables, source, intra_norm, hw):
    jcfg = jvss.VSSConfig(width=8, descr_source=source,
                          descr_intra_norm=intra_norm)
    v = _subset(flax_variables[hw], source)
    imgs = _images(hw)
    ref = jax.jit(lambda v, x: jvss.VSS(jcfg).apply(
        v, x, train=False, descriptor_only=True))(v, jnp.asarray(imgs))
    model = _port(vss.VSSConfig(width=8, descr_source=source,
                                descr_intra_norm=intra_norm), hw, v)
    with torch.no_grad():
        got = model(torch.tensor(imgs), descriptor_only=True)
    assert set(got) == {"descriptor", "c5"}
    for k in ("descriptor", "c5"):
        _close(got[k], ref[k], k)
    assert got["descriptor"].shape[1] == model.descr_dim
    np.testing.assert_allclose(got["descriptor"].norm(dim=1).numpy(), 1.0,
                               atol=1e-12)


def test_full_forward_with_jax_eps(flax_variables, hw=(48, 64)):
    """Every output (mu, log_sig_sq, z, rec, seg too) with the noise JAX
    draws from its key."""
    v = _subset(flax_variables[hw], "d5")
    imgs = _images(hw, seed=2)
    key = jax.random.key(5)
    ref = jax.jit(lambda v, x: jvss.VSS(jvss.VSSConfig(width=8)).apply(
        v, x, train=False, rng=key))(v, jnp.asarray(imgs))
    eps = np.asarray(jax.random.normal(key, ref["mu"].shape, jnp.float32))
    with torch.no_grad():
        got = _port(vss.VSSConfig(width=8), hw, v)(
            torch.tensor(imgs), eps=torch.tensor(eps))
    assert set(got) == set(ref)
    for k in ref:
        _close(got[k], ref[k], k)
    # the decoder upsamples the latent grid 16x
    up = tuple(16 * n for n in ref["mu"].shape[1:3])
    assert got["rec"].shape == (2,) + up + (3,)
    assert got["seg"].shape == (2,) + up + (vss.N_CLASSES,)


def test_grouped_depth_to_space():
    """NCHW port against the JAX function on NHWC (its default lowering)
    and its reshape form: a rearrangement, so bit for bit."""
    x = np.random.default_rng(3).normal(size=(2, 3, 5, 14 * 8))
    ref = np.asarray(jvss.grouped_depth_to_space(jnp.asarray(x), 14))
    got = vss.grouped_depth_to_space(
        torch.tensor(x).permute(0, 3, 1, 2), 14).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got.shape == (2, 6, 10, 14 * 2)


def test_generator_draws_from_flax_distributions():
    """The port's own weights: lecun-normal convs (truncated at ±2σ),
    zero biases, BatchNorm at identity statistics, offset ~ N(0, 1); the
    same seed gives the same weights."""
    a = vss.VSS(vss.VSSConfig(width=8), (48, 64),
                torch.Generator().manual_seed(7)).state_dict()
    b = vss.VSS(vss.VSSConfig(width=8), (48, 64),
                torch.Generator().manual_seed(7)).state_dict()
    for k, p in a.items():
        assert torch.equal(p, b[k]), k
    w = a["decoder.blocks.2.conv.weight"]            # fan-in 128·9
    std = (1.0 / (128 * 9)) ** 0.5
    assert abs(float(w.std()) / std - 1.0) < 0.02
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    assert float(a["mu.bias"].abs().max()) == 0.0
    assert torch.equal(a["encoder.blocks.0.bn.weight"], torch.ones(8))
    assert torch.equal(a["encoder.blocks.0.bn.running_var"], torch.ones(8))
    assert abs(float(a["offset"].std()) - 1.0) < 0.1


def test_unported_settings_raise():
    with pytest.raises(ValueError, match="not ported"):
        vss.VSS(vss.VSSConfig(width=8, compute_dtype="bfloat16"), (48, 64))
    with pytest.raises(ValueError, match="descr_source"):
        vss.VSS(vss.VSSConfig(width=8, descr_source="d3"), (48, 64))
    m = vss.VSS(vss.VSSConfig(width=8, remat=True), (48, 64)).train()
    with pytest.raises(RuntimeError, match="eval mode"):
        m(torch.zeros(1, 48, 64, 3))
