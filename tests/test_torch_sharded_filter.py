"""The port's row-sharded covariance step (ekf_slam_tpu_torch.parallel
.sharded_filter) against the JAX package's make_sharded_step and the
port's single-device step, and K8's row-slab form against K8.

JAX's tp_cfg (CAP 12, 16 landmarks, max_new 6; here at f64) from one
bootstrapped state broadcast to B = 4, 4 frames, RANSAC's draws from
JAX's keys. JAX runs its sharded step on make_mesh(data=2, model=4) of
conftest's 8 virtual devices; the port runs in gloo ranks on the CPU
(tests/torch_parallel_ranks.py, no JAX in them) on data 1 x model 4 and
data 2 x model 2. Tolerances: x and P to 1e-9 of their largest entry
(measured ~1e-14), every gate count equal, the pad block exactly 0;
every collective's payload within B_l·Dp·max(12·max_new, 4·CAP + 8,
NHYP), the bound of JAX's test_tp_step_collectives_stay_small."""

import functools

import jax
import numpy as np
import pytest
import torch

from ekf_slam_tpu.parallel import sharded_filter as jsf
from ekf_slam_tpu.parallel.mesh import make_mesh as jmake_mesh
from ekf_slam_tpu_torch.config import EngineConfig
from ekf_slam_tpu_torch.filter import engine
from ekf_slam_tpu_torch.ops import kernels
from ekf_slam_tpu_torch.parallel import mesh as pmesh
from ekf_slam_tpu_torch.parallel import sharded_filter as sf
from torch_parallel_ranks import tp_rank
from torch_parity import (configs, frame, frame_keys, port_obs, port_state,
                          ransac_u, sim_and_bootstrap)

TP = {"filter": {"fused_step": "off"},
      "map": {"capacity": 12, "min_features_in_image": 6,
              "max_new_per_step": 6},
      "sim": {"num_landmarks": 16}, "dtype": "float64"}
B, T = 4, 4
RTOL = 1e-9
COUNTS = ("n_visible", "n_ic", "n_li", "n_hi")


@functools.cache
def _inputs():
    jc, _ = configs(TP)
    _, obs, st = sim_and_bootstrap(jc, 0, T, B)
    keys = [frame_keys(t, B) for t in range(T)]
    u = np.stack([ransac_u(k, jc.ransac.num_hypotheses) for k in keys])
    return jc, obs, st, keys, u


@functools.cache
def jax_sharded():
    """JAX's sharded step over the frames: (state, per-frame infos)."""
    jc, obs, st, keys, _ = _inputs()
    mesh = jmake_mesh(data=2, model=4)
    step = jsf.make_sharded_step(jc, mesh)
    D, _ = jsf.padded_dim(jc, 4)
    s = jsf.shard_state_batch(st, mesh, jc)
    infos = []
    for t in range(1, T):
        s, info = step(s, frame(obs, t), keys[t])
        infos.append(info)
    return jsf.unpad_state(jax.device_get(s), D), infos


@functools.cache
def port_single():
    """The port's single-device step over the frames."""
    _, obs, st, _, u = _inputs()
    cfg = EngineConfig.from_dict(TP)
    s = port_state(st)
    infos = []
    for t in range(1, T):
        s, info = engine.step(s, port_obs(frame(obs, t)),
                              torch.tensor(u[t]), cfg)
        infos.append(info)
    return s, infos


@functools.cache
def port_sharded(data, model):
    """The ranks' results of the port's sharded step on data x model."""
    _, obs, st, _, u = _inputs()
    state = {f: np.asarray(getattr(st, f)) for f in
             ("x", "P", "active", "cartesian", "times_predicted",
              "times_measured", "landmark_id")}
    return pmesh.spawn(tp_rank, data * model, "gloo", TP, state,
                       np.asarray(obs.pixels), np.asarray(obs.visible), u,
                       data, model)


def _joined(ranks, data, model, field):
    """A state field of the global batch from the ranks of model index 0."""
    return np.concatenate([ranks[d * model]["state"][field]
                           for d in range(data)])


def _close(got, ref, what):
    scale = np.abs(ref).max()
    err = np.abs(got - ref).max() / scale
    assert err <= RTOL, (what, err)


MESHES = [(1, 4), (2, 2)]          # model k = 4, and k = 2 beside data 2


@pytest.mark.parametrize("data,model", MESHES)
def test_sharded_step_matches_jax_and_the_single_device_step(data, model):
    ranks = port_sharded(data, model)
    jst, jinfos = jax_sharded()
    single, sinfos = port_single()
    for field in ("x", "P"):
        got = _joined(ranks, data, model, field)
        _close(got, np.asarray(getattr(jst, field)), f"{field} vs JAX")
        _close(got, getattr(single, field).numpy(), f"{field} vs port")
    for field in ("active", "cartesian", "landmark_id", "times_measured",
                  "times_predicted"):
        np.testing.assert_array_equal(_joined(ranks, data, model, field),
                                      np.asarray(getattr(jst, field)))
    for t in range(T - 1):
        for f in COUNTS:
            got = np.concatenate([ranks[d * model]["counts"][t][f]
                                  for d in range(data)])
            np.testing.assert_array_equal(got, np.asarray(
                getattr(jinfos[t], f)))
            np.testing.assert_array_equal(got, getattr(sinfos[t], f).numpy())
    # every model rank of a data index holds the same replicated state
    for i, r in enumerate(ranks):
        np.testing.assert_array_equal(
            r["state"]["x"], ranks[i // model * model]["state"]["x"])
    D, Dp = sf.padded_dim(EngineConfig.from_dict(TP), model)
    assert all(r["slab"] == (B // data, Dp // model, Dp) for r in ranks)
    assert all(r["pad_zero"] for r in ranks)


@pytest.mark.parametrize("data,model", MESHES)
def test_sharded_step_collectives_stay_factor_sized(data, model):
    """Every collective a frame makes is at most the factor bound, which
    lies below the covariance's own size; K6 and K8's slab form run,
    K4 never."""
    ranks = port_sharded(data, model)
    cfg = EngineConfig.from_dict(TP)
    D, Dp = sf.padded_dim(cfg, model)
    blk = B // data
    bound = sf.payload_bound(cfg, blk, Dp)
    assert bound < blk * Dp * D
    for r in ranks:
        assert r["bound"] == bound and 0 < r["payload"] <= bound
        ops = [line.split() for line in r["ops"]]
        assert all(op in ("all_gather", "all_reduce") and axis == "model"
                   and int(n) <= bound for op, axis, n in ops)
        # CPU tensors take the plain versions: no kernel launched
        assert all(v == 0 for v in r["launches"].values())


@pytest.mark.parametrize("data,model", MESHES)
def test_sharded_step_calls_k6_on_the_slab_and_k8_slab_for_the_tails(
        data, model):
    """A frame calls K6 on the (B_l, Dp/k, Dp) slab three times (RANSAC's
    P·G and the two updates' P·Hᵀ) and K8's slab form twice (the two
    tails), nothing else; the single-device step calls K6 (RANSAC's P·G),
    pht_blocks (the updates' P·Hᵀ and S) and K4."""
    ranks = port_sharded(data, model)
    _, Dp = sf.padded_dim(EngineConfig.from_dict(TP), model)
    slab = (B // data, Dp // model, Dp)
    for r in ranks:
        assert r["calls"] == {"f32_matmul_big": [slab] * 3,
                              "corr_apply_rows": [slab] * 2}
    _, obs, st, _, u = _inputs()
    with kernels.capture_operands() as calls:
        engine.step(port_state(st), port_obs(frame(obs, 1)),
                    torch.tensor(u[1]), EngineConfig.from_dict(TP))
    assert set(calls) == {"f32_matmul_big", "pht_blocks", "corr_apply_cols"}


@pytest.mark.parametrize("data,model", [(2, 2)])
def test_sharded_step_raises_for_what_it_does_not_take(data, model):
    cfg = EngineConfig.from_dict({**TP, "filter": {"fused_step": "on"}})
    mesh = pmesh.Mesh(None, ("data", "model"), {"data": data,
                                                "model": model},
                      torch.device("cpu"), "gloo")
    with pytest.raises(ValueError, match="fused_step"):
        sf.make_sharded_step(cfg, mesh)
    it = EngineConfig.from_dict({**TP, "filter": {
        "fused_step": "off", "use_iterated_update": True}})
    with pytest.raises(ValueError, match="iterated"):
        sf.make_sharded_step(it, mesh)


@pytest.mark.parametrize("r0,dl", [(0, 43), (43, 43), (66, 22), (10, 5)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_corr_apply_rows_plain_is_the_slab_of_corr_apply(r0, dl, dtype):
    """corr_apply_rows_plain on rows r0 .. r0+dl−1 equals those rows of
    corr_apply_plain(..., "none"), bit for bit (f64 factors; a bf16 P is
    upcast and the sum rounded once in both)."""
    g = torch.Generator().manual_seed(r0 + dl)
    Dc, R = 88, 32
    P = torch.randn(2, Dc, Dc, generator=g, dtype=torch.float64).to(dtype)
    At = torch.randn(2, R, Dc, generator=g, dtype=torch.float64)
    Bt = torch.randn(2, R, Dc, generator=g, dtype=torch.float64)
    full = kernels.corr_apply_plain(P, At, Bt, "none")
    slab = P[:, r0:r0 + dl].contiguous()
    got = kernels.corr_apply_rows(slab, At, Bt, r0)
    assert got.dtype == dtype
    assert torch.equal(got, full[:, r0:r0 + dl])
    with pytest.raises(ValueError, match="outside"):
        kernels.corr_apply_rows(slab, At, Bt, Dc - dl + 1)
