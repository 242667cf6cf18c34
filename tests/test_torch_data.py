"""The port's training data (ekf_slam_tpu_torch.data) against the JAX
package's (ekf_slam_tpu.data).

* synthetic.py cannot replay jax.random, so the port renders from JAX's
  draws handed in as arrays (seeds, classes, palette, noise; for the
  aliased set also the jitter, the reassigned cells and their classes):
  images and labels equal JAX's to 1e-12 at f64. The port's own draws
  hold the structure tests/test_data.py pins for JAX's.
* classes.py, records.py, coco.py and coco_min.py are copies: the tables
  equal, the records round trip, ShardReader feeding the port's fit, and
  the COCO fixture of tests/test_coco_fixture.py to one port train step
  with coco_pairs equal to JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_slam_tpu.data import classes as jclasses
from ekf_slam_tpu.data import synthetic as jsyn
from ekf_slam_tpu_torch.data import classes, records, synthetic
from ekf_slam_tpu_torch.models import train, vss

torch.set_num_threads(1)

HW = (32, 40)


def _t(a):
    return torch.tensor(np.asarray(a))


def _noise(key, B, hw):
    return _t(jnp.stack([jax.random.normal(k, hw + (3,))
                         for k in jax.random.split(key, B)]))


def _same(got, ref):
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-12)


def test_render_voronoi():
    rng = np.random.default_rng(0)
    seeds = rng.uniform(0, 1, (3, 10, 2)) * np.array(HW)
    seeds[0, 1] = seeds[0, 0]                  # a tie: the lower seed wins
    cls = rng.integers(0, 13, (3, 10))
    palette = rng.uniform(0.1, 0.9, (13, 3))
    key = jax.random.key(1)
    ref = jsyn._render_voronoi(jnp.asarray(seeds), jnp.asarray(cls),
                               jnp.asarray(palette), HW, key)
    got = synthetic.render_voronoi(_t(seeds), _t(cls), _t(palette), HW,
                                   _noise(key, 3, HW))
    _same(got, ref)


def test_synthetic_batch_from_jax_draws():
    key = jax.random.key(2)
    ref = jsyn.synthetic_batch(key, 4, HW, num_cells=24)
    kc, kcls, kcol, kn = jax.random.split(key, 4)
    seeds = jax.random.uniform(kc, (4, 24, 2)) * jnp.array(HW)
    cls = jax.random.randint(kcls, (4, 24), 0, 13)
    palette = jax.random.uniform(kcol, (13, 3), minval=0.1, maxval=0.9)
    got = synthetic.render_voronoi(_t(seeds), _t(cls), _t(palette), HW,
                                   _noise(kn, 4, HW))
    _same(got, ref)
    _same([synthetic.class_weights(got[1])], [jsyn.class_weights(ref[1])])


def test_aliased_places_from_jax_draws():
    key = jax.random.key(3)
    P, group, N, d = 8, 4, 48, 2
    ref = jsyn.aliased_places(key, P, group=group, hw=HW)
    ka, kcls, kcol, kj, kd, kdc, kn = jax.random.split(key, 7)
    base = jax.random.uniform(ka, (2, N, 2)) * jnp.array(HW)
    base_cls = jax.random.randint(kcls, (2, N), 0, 13)
    palette = jax.random.uniform(kcol, (13, 3), minval=0.1, maxval=0.9)
    jitter = 0.5 * jax.random.normal(kj, (P, N, 2))
    which = jax.vmap(lambda k: jax.random.choice(k, N, (d,), replace=False))(
        jax.random.split(kd, P))
    new_cls = jax.random.randint(kdc, (P, d), 0, 13)
    seeds, cell_cls = synthetic.alias_cells(_t(base), _t(base_cls), group,
                                            _t(jitter), _t(which).long(),
                                            _t(new_cls))
    imgs, labels = synthetic.render_voronoi(seeds, cell_cls, _t(palette), HW,
                                            _noise(kn, P, HW))
    _same((imgs, labels), ref[:2])
    np.testing.assert_array_equal(np.repeat(np.arange(2), 4),
                                  np.asarray(ref[2]))


def test_generator_draws_hold_the_structure():
    """Seeded draws repeat; the aliased set's same-archetype places are
    near-duplicates and the cross-archetype ones are not
    (tests/test_data.py's bounds); aliased_batches yields batches."""
    g = lambda s: torch.Generator().manual_seed(s)
    a = synthetic.synthetic_batch(2, HW, generator=g(0))
    b = synthetic.synthetic_batch(2, HW, generator=g(0))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert a[0].shape == (2,) + HW + (3,) and a[1].shape == (2,) + HW + (13,)
    assert float(a[0].min()) >= 0 and float(a[0].max()) <= 1
    imgs, labels, arch = synthetic.aliased_places(16, 4, (48, 64),
                                                  generator=g(3))
    assert labels.shape == (16, 48, 64, 13) and arch.dtype == torch.int32
    np.testing.assert_array_equal(arch.numpy(), np.repeat(np.arange(4), 4))
    flat = imgs.reshape(16, -1).double()
    flat = flat - flat.mean(-1, keepdim=True)
    flat = flat / flat.norm(dim=-1, keepdim=True)
    sim = (flat @ flat.T).numpy()
    a_ = arch.numpy()
    same = (a_[:, None] == a_[None, :]) & ~np.eye(16, dtype=bool)
    cross = a_[:, None] != a_[None, :]
    assert sim[same].mean() > 0.7 and sim[same].max() < 0.999
    assert sim[same].mean() > sim[cross].mean() + 0.5
    x, y = next(synthetic.aliased_batches(8, 4, HW, generator=g(4)))
    assert x.shape == (8,) + HW + (3,) and y.shape == (8,) + HW + (13,)
    with pytest.raises(ValueError, match="multiple"):
        synthetic.aliased_places(10, 4, HW)


def test_class_tables_are_the_jax_tables():
    assert classes.CALC_CLASS_NAMES == jclasses.CALC_CLASS_NAMES
    assert classes.COCO_TO_CALC == jclasses.COCO_TO_CALC
    np.testing.assert_array_equal(classes.coco_to_calc_lut(),
                                  jclasses.coco_to_calc_lut())
    assert classes.N_CALC_CLASSES == vss.N_CLASSES == 13


def _pairs(n, hw, seed):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        yield (rng.integers(0, 256, hw + (3,), dtype=np.uint8),
               rng.integers(0, 13, hw, dtype=np.uint8))


@pytest.mark.parametrize("prefetch", [0, 2])
def test_records_round_trip_and_reader_feeds_fit(tmp_path, prefetch):
    """write_shards / load_weights equal the JAX package's on the same
    pairs; ShardReader (its producer thread at prefetch 2) yields every
    image once an epoch, in a new order each epoch, and feeds fit."""
    from ekf_slam_tpu.data import records as jrecords
    n = records.write_shards(str(tmp_path / "t"), _pairs(10, (32, 32), 0),
                             shard_size=4)
    jrecords.write_shards(str(tmp_path / "j"), _pairs(10, (32, 32), 0),
                          shard_size=4)
    assert n == 3
    np.testing.assert_array_equal(records.load_weights(str(tmp_path / "t")),
                                  jrecords.load_weights(str(tmp_path / "j")))
    reader = records.ShardReader(str(tmp_path / "t"), 2, seed=1,
                                 prefetch=prefetch)
    epochs = [list(reader) for _ in range(2)]
    for ep in epochs:
        assert len(ep) == 5                    # 4 + 4 + 2 images, batch 2
        x, y = ep[0]
        assert x.shape == (2, 32, 32, 3) and x.max() <= 1.0
        np.testing.assert_allclose(y.sum(-1), 1.0)
    assert not all(np.array_equal(a[0], b[0])
                   for a, b in zip(*epochs))
    model = train.create_model(vss.VSSConfig(width=8), (32, 32))
    tcfg = train.TrainConfig(batch_size=2, image_hw=(32, 32))
    state, metrics = train.fit(model, tcfg, reader, 3,
                               data_dir=str(tmp_path / "t"))
    assert state.step == 3 and bool(torch.isfinite(metrics["loss"]))


def test_val_shards_round_trip(tmp_path):
    rng = np.random.default_rng(5)
    ex = [tuple(rng.integers(0, 256, s, dtype=np.uint8) for s in
                ((16, 16, 3), (16, 16), (16, 16, 3), (16, 16, 3)))
          for _ in range(5)]
    assert records.write_val_shards(str(tmp_path), iter(ex),
                                    shard_size=4) == 2
    live, mem = records.load_eval_pairs(str(tmp_path))
    np.testing.assert_array_equal(
        live, np.stack([e[2] for e in ex]).astype(np.float32) / 255.0)
    np.testing.assert_array_equal(
        mem, np.stack([e[3] for e in ex]).astype(np.float32) / 255.0)


def test_coco_fixture_to_one_port_train_step(tmp_path):
    """tests/test_coco_fixture.py's miniature COCO-Stuff through the
    port's coco_pairs (equal to JAX's), write_shards, ShardReader and one
    train step."""
    from ekf_slam_tpu.data.coco import coco_pairs as jcoco_pairs
    from ekf_slam_tpu_torch.data import coco, coco_min
    from test_coco_fixture import _write_fixture
    ann, img_dir, rle_a, _ = _write_fixture(str(tmp_path))
    pairs = list(coco.coco_pairs(ann, img_dir, size=(32, 32)))
    ref = list(jcoco_pairs(ann, img_dir, size=(32, 32)))
    assert len(pairs) == len(ref) == 2
    for (img, mask), (ri, rm) in zip(pairs, ref):
        np.testing.assert_array_equal(img, ri)
        np.testing.assert_array_equal(mask, rm)
        assert mask.max() > 0
    m = coco_min.MiniCOCO(ann)
    np.testing.assert_array_equal(m.annToMask(m.loadAnns(11)[0]), rle_a)
    shard_dir = str(tmp_path / "shards")
    assert records.write_shards(shard_dir, iter(pairs), shard_size=2) == 1
    x, y = next(iter(records.ShardReader(shard_dir, 2, prefetch=0)))
    model = train.create_model(vss.VSSConfig(width=4), (32, 32))
    tcfg = train.TrainConfig(batch_size=2, image_hw=(32, 32))
    state = train.init_state(model, tcfg)
    state, metrics = train.train_step(
        tcfg, state, torch.tensor(x), torch.tensor(y),
        torch.tensor(records.load_weights(shard_dir)),
        generator=torch.Generator().manual_seed(1))
    assert state.step == 1 and bool(torch.isfinite(metrics["loss"]))
