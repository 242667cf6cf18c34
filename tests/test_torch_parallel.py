"""The port's multi-process layer (ekf_slam_tpu_torch.parallel: the mesh,
the data-parallel ensemble, the capacity-sharded loop DB and
loop_runner.run_online on it) against the JAX package's parallel/ and
the port's single-process functions.

The port runs in gloo ranks on the CPU (parallel.mesh.spawn of the
functions in tests/torch_parallel_ranks.py, which import no JAX; numpy
in and out); JAX on conftest's 8 virtual devices. Tolerances (f64 on both
sides unless stated): run_ensemble's trajectories, mean and covariance to
1e-9 of their largest entry against JAX's 8-device run_ensemble with the
draws of its keys, two all_reduces after the loop and none in it; the
sharded ring's candidates, frame ids, gates and best pose equal to the
unsharded query's, its similarities to 1e-12, and its retrieval equal to
JAX's 8-shard sdb.query (tests/test_torch_parallel_models.py holds
run_online on the sharded DB and the data-parallel train step)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_slam_tpu.models import keypoints as jkp
from ekf_slam_tpu.models import loopclosure as jlc
from ekf_slam_tpu.parallel import make_mesh as jmake_mesh
from ekf_slam_tpu.parallel import run_ensemble as jrun_ensemble
from ekf_slam_tpu.parallel import sharded_loopdb as jsdb
from ekf_slam_tpu_torch.models import keypoints
from ekf_slam_tpu_torch.models import loopclosure as lc
from ekf_slam_tpu_torch.parallel import mesh as pmesh
from ekf_slam_tpu_torch.parallel import sharded_loopdb as sdb
from torch_parallel_ranks import ensemble_rank, loopdb_rank, mesh_rank
from torch_parity import configs, ransac_u, sim_and_bootstrap

torch.set_num_threads(1)


def test_make_mesh_blocks_and_replicate():
    """4 ranks as data 2 x model 2: axis names and sizes, row-major
    ranks, each rank's contiguous block of the batch, rank 0's tensor
    on every rank."""
    out = pmesh.spawn(mesh_rank, 4, "gloo", 2, 2)
    x0 = np.arange(12.0).reshape(6, 2)
    for r, o in enumerate(out):
        assert o["names"] == ("data", "model")
        assert o["shape"] == {"data": 2, "model": 2}
        assert o["device"] == "cpu"
        assert o["rank"] == {"data": r // 2, "model": r % 2}
        lo = 3 * (r // 2)
        np.testing.assert_array_equal(o["block"], x0[lo:lo + 3] + 100 * r)
        np.testing.assert_array_equal(o["replicated"], x0)


def test_block_and_tree_map():
    mesh = pmesh.Mesh(None, ("data",), {"data": 3}, torch.device("cpu"),
                      "gloo")
    with pytest.raises(ValueError, match="split"):
        pmesh.block(7, mesh)
    tree = {"a": [torch.ones(2), (torch.zeros(1), 3)]}
    out = pmesh.tree_map(lambda t: t + 1, tree)
    assert out["a"][1][1] == 3 and float(out["a"][1][0]) == 1.0


# --- run_ensemble -------------------------------------------------------------

ENS = {"filter": {"fused_step": "off"},
       "map": {"capacity": 16, "min_features_in_image": 8,
               "max_new_per_step": 8},
       "sim": {"num_landmarks": 24}, "dtype": "float64"}


def test_run_ensemble_matches_jax():
    """B = 8 instances, 3 frames: JAX's run_ensemble on 8 devices against
    the port's on data = 2 ranks, each instance's draws those of its JAX
    key (run_sequence splits it over the frames)."""
    jc, _ = configs(ENS)
    B, T = 8, 3
    _, obs, st = sim_and_bootstrap(jc, 2, T, B)
    keys = jax.random.split(jax.random.key(3), B)
    _, jtraj, jmean, jcov = jrun_ensemble(st, obs, keys, jc, jmake_mesh())
    fkeys = jax.vmap(lambda k: jax.random.split(k, T))(keys)    # (B, T)
    draws = np.stack([ransac_u(fkeys[:, t], jc.ransac.num_hypotheses)
                      for t in range(T)])                       # (T, B, N)
    state = {f: np.asarray(getattr(st, f)) for f in
             ("x", "P", "active", "cartesian", "times_predicted",
              "times_measured", "landmark_id")}
    out = pmesh.spawn(ensemble_rank, 2, "gloo", ENS, state,
                      np.asarray(obs.pixels), np.asarray(obs.visible),
                      draws, 2)
    traj = np.concatenate([o["traj"] for o in out])
    for got, ref in ((traj, jtraj), (out[0]["mean"], jmean),
                     (out[1]["mean"], jmean), (out[0]["cov"], jcov)):
        ref = np.asarray(ref)
        assert np.abs(got - ref).max() <= 1e-9 * np.abs(ref).max()
    np.testing.assert_array_equal(out[0]["cov"], out[1]["cov"])
    # the ensemble statistics' two reductions of whole trajectories, after
    # the loop; nothing inside it
    for o in out:
        assert o["collectives"] == [("all_reduce", "data", T * 13),
                                    ("all_reduce", "data", T * 9)]


# --- the capacity-sharded loop DB ---------------------------------------------

LDB = dict(capacity=16, top_k=4, exclude_recent=3, min_db=0,
           sim_threshold=0.5, ransac_hypotheses=16, min_inliers=6)
NKP, DKP, DD, NT = 16, 6, 12, 23          # 23 frames > capacity: a wrap
QUERIES = (2, 9, 14, 20, 22)


@functools.cache
def _ring_data():
    """Frames for B = 2 instances (T, B, ...) f64, each query a noisy
    revisit of an older frame, and query draws (T, B, top_k, NH, K)."""
    rng = np.random.default_rng(0)
    d = rng.normal(size=(NT, 2, DD))
    yx = rng.uniform(0, 100, (NT, 2, NKP, 2))
    kd = rng.normal(size=(NT, 2, NKP, DKP))
    for t in QUERIES:               # the keypoints shifted (2, 1) px
        src = t - 3 - t % 5
        d[t] = d[src] + 0.01 * rng.normal(size=(2, DD))
        yx[t] = yx[src] + [2.0, 1.0] + 0.05 * rng.normal(size=(2, NKP, 2))
        kd[t] = kd[src] + 0.05 * rng.normal(size=(2, NKP, DKP))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pose = rng.normal(size=(NT, 2, 7))
    draws = rng.uniform(size=(NT, 2, LDB["top_k"], LDB["ransac_hypotheses"],
                              NKP))
    return (d, yx, kd, pose), draws


def _kp(yx, kd):
    B = yx.shape[0]
    return keypoints.Keypoints(torch.tensor(yx), torch.ones(B, NKP),
                               torch.zeros(B, NKP), torch.tensor(kd))


@functools.cache
def _unsharded():
    """The unsharded ring's results at QUERIES and its final state."""
    (d, yx, kd, pose), draws = _ring_data()
    cfg = lc.LoopConfig(**LDB)
    db = lc.init_db(cfg, 2, DD, NKP, DKP, torch.float64, "cpu")
    out = []
    for t in range(NT):
        if t in QUERIES:
            r = lc.query(db, torch.tensor(d[t]), _kp(yx[t], kd[t]), cfg,
                         torch.tensor(draws[t]))
            slot = r.best_slot
            out.append((r, db.pose[torch.arange(2), slot].clone()))
        db = lc.push(db, torch.tensor(d[t]), _kp(yx[t], kd[t]),
                     torch.tensor(pose[t]))
    return out, db


@pytest.mark.parametrize("k", [2, 4])
def test_sharded_loopdb_equals_the_single_ring_and_jax(k):
    (d, yx, kd, pose), draws = _ring_data()
    ranks = pmesh.spawn(loopdb_rank, k, "gloo", LDB, (d, yx, kd, pose),
                        QUERIES, draws, k)
    ref, db = _unsharded()
    for f in ("descr", "kp_yx", "kp_descr", "pose", "frame_id"):
        np.testing.assert_array_equal(
            np.concatenate([r["db"][f] for r in ranks], axis=1),
            getattr(db, f).numpy())
    for r in ranks:
        assert r["shard_db_equal"]
        np.testing.assert_array_equal(r["db"]["count"], db.count.numpy())
        for q, (res, best_pose) in zip(r["queries"], ref):
            for f in ("candidate_ids", "best_slot", "best_id",
                      "best_inliers", "is_hypothesis"):
                np.testing.assert_array_equal(q[f], getattr(res, f).numpy())
            np.testing.assert_allclose(q["similarities"],
                                       res.similarities.numpy(), rtol=0,
                                       atol=1e-12)
            np.testing.assert_array_equal(q["pose"], best_pose.numpy())
            # one all_gather of the candidate packets, one all_reduce of
            # the best pose; nothing ring-sized crosses ranks
            (op1, _, n1), (op2, _, n2) = q["collectives"]
            assert (op1, op2) == ("all_gather", "all_reduce")
            assert n1 == 2 * k * min(LDB["top_k"], 16 // k) * (
                3 + 2 * NKP + NKP * DKP + 7) and n2 == 2 * 7
    assert any(bool(res.is_hypothesis.any()) for res, _ in ref)


@functools.cache
def _jax_sharded_queries():
    """JAX's 8-shard ring (instance 0 of the data) at QUERIES."""
    (d, yx, kd, pose), _ = _ring_data()
    cfg = jlc.LoopConfig(**LDB)
    mesh = jmake_mesh()
    db = jsdb.shard_db(jlc.init_db(cfg, DD, NKP, DKP, jnp.float64), mesh)
    push = jax.jit(lambda db, q, kp, p: jsdb.push(db, q, kp, p, mesh))
    query = jax.jit(lambda db, q, kp, key: jsdb.query(db, q, kp, cfg, key,
                                                      mesh))
    fetch = jax.jit(lambda db, s: jsdb.best_pose(db, s, mesh))
    out = []
    for t in range(NT):
        kp = jkp.Keypoints(jnp.asarray(yx[t, 0]), jnp.ones(NKP),
                           jnp.zeros(NKP), jnp.asarray(kd[t, 0]))
        if t in QUERIES:
            r = query(db, jnp.asarray(d[t, 0]), kp, jax.random.key(t))
            out.append((jax.device_get(r), np.asarray(fetch(db,
                                                            r.best_slot))))
        db = push(db, jnp.asarray(d[t, 0]), kp, jnp.asarray(pose[t, 0]))
    return out


def test_sharded_loopdb_retrieval_matches_jax():
    """The port's retrieval (its sharded candidates equal the unsharded
    query's, above) against JAX's 8-shard sdb.query on instance 0: the
    same candidate slots and similarities; JAX's best_pose of its best
    slot is the pose pushed into that slot. Verification runs on each
    side's own draws, so the gate decisions are not compared here."""
    (_, _, _, pose), _ = _ring_data()
    ref, _ = _unsharded()
    for t, (res, _), (jr, jpose) in zip(QUERIES, ref,
                                        _jax_sharded_queries()):
        np.testing.assert_array_equal(res.candidate_ids[0].numpy(),
                                      np.asarray(jr.candidate_ids))
        np.testing.assert_allclose(res.similarities[0].numpy(),
                                   np.asarray(jr.similarities), rtol=0,
                                   atol=1e-12)
        frame = int(jr.best_id)
        if frame >= 0:
            np.testing.assert_array_equal(jpose, pose[frame, 0])


def test_sharded_loopdb_raises_for_an_uneven_split():
    mesh = pmesh.Mesh(None, ("data",), {"data": 3}, torch.device("cpu"),
                      "gloo")
    with pytest.raises(ValueError, match="divisible"):
        sdb.init_db(lc.LoopConfig(capacity=32), 1, DD, NKP, DKP, mesh)
