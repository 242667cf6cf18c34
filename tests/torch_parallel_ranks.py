"""The ranks of the port's multi-process tests (tests/test_torch_parallel.py,
tests/test_torch_sharded_filter.py): module-level functions that
parallel.mesh.spawn runs in gloo ranks on the CPU. They import torch and
the port only, never JAX; the tests hand them numpy arrays and get numpy
arrays back."""

import torch

from ekf_slam_tpu_torch.config import EngineConfig
from ekf_slam_tpu_torch.filter.state import state_from_numpy, state_to_numpy
from ekf_slam_tpu_torch.models import keypoints, loop_runner, train, vss
from ekf_slam_tpu_torch.models import loopclosure as lc
from ekf_slam_tpu_torch.ops import kernels
from ekf_slam_tpu_torch.parallel import mesh as pmesh
from ekf_slam_tpu_torch.parallel import sharded_filter as sf
from ekf_slam_tpu_torch.parallel import sharded_loopdb as sdb
from ekf_slam_tpu_torch.sim.scene import FrameObs


def _np(t):
    return t.detach().cpu().numpy()


def mesh_rank(data, model):
    """The mesh as this rank sees it, shard_batch and replicate."""
    m = pmesh.make_mesh(data, model, device="cpu")
    rank = torch.distributed.get_rank()
    x = torch.arange(12.0).reshape(6, 2) + 100 * rank
    return {"names": m.names, "shape": m.shape, "device": str(m.device),
            "rank": {a: m.rank(a) for a in m.names},
            "block": _np(pmesh.shard_batch({"x": x}, m)["x"]),
            "replicated": _np(pmesh.replicate([x], m)[0])}


def tp_rank(cfg_dict, state, pixels, visible, u, data, model,
            device="cpu"):
    """make_sharded_step over frames 1 .. T−1 on a data x model mesh from
    the global batch `state` (numpy fields): the gathered result, each
    frame's counts, the largest collective, the pad block, the slab, the
    kernel wrappers the last frame called (the shape of their first
    operand) and the launches of the run."""
    cfg = EngineConfig.from_dict(cfg_dict)
    m = pmesh.make_mesh(data, model, device=device)
    st = state_from_numpy(state, m.device, cfg.torch_dtype)
    step = sf.make_sharded_step(cfg, m)
    sp = sf.shard_state_batch(st, m, cfg)
    mine = pmesh.block(st.batch, m, "data")
    counts, payloads, ops = [], [], []
    kernels.reset_launches()
    for t in range(1, pixels.shape[0]):
        obs = FrameObs(torch.tensor(pixels[t], dtype=cfg.torch_dtype),
                       torch.tensor(visible[t])).to(m.device)
        pmesh.reset_collectives()
        with kernels.capture_operands() as calls:
            sp, info = step(sp, obs, torch.tensor(
                u[t][mine], dtype=cfg.torch_dtype, device=m.device))
        payloads.append(max(n for _, _, n in pmesh.COLLECTIVES))
        ops.append(sf.collective_inventory())
        counts.append({f: _np(getattr(info, f)) for f in
                       ("n_visible", "n_ic", "n_li", "n_hi")})
    D, Dp = sf.padded_dim(cfg, model)
    r0 = m.rank("model") * (Dp // model)
    rows = torch.arange(r0, r0 + Dp // model, device=m.device)
    pad_zero = bool((sp.P[:, :, D:] == 0).all() and (sp.P[:, rows >= D] == 0)
                    .all() and (sp.x[:, D:] == 0).all())
    full = sf.gather_state(sp, m, cfg)
    return {"state": state_to_numpy(full), "counts": counts,
            "payload": max(payloads), "ops": ops[-1], "pad_zero": pad_zero,
            "slab": tuple(sp.P.shape), "launches": dict(kernels.LAUNCHES),
            "calls": {k: [tuple(c[0].shape) for c in v]
                      for k, v in calls.items()},
            "bound": sf.payload_bound(cfg, sp.P.shape[0], Dp)}


def ensemble_rank(cfg_dict, state, pixels, visible, draws, data):
    """run_ensemble over a ("data",) mesh; the collectives it made."""
    cfg = EngineConfig.from_dict(cfg_dict)
    m = pmesh.make_mesh(data, device="cpu")
    pmesh.reset_collectives()
    final, traj, mean, cov = pmesh.run_ensemble(
        state_from_numpy(state, "cpu"),
        FrameObs(torch.tensor(pixels), torch.tensor(visible)),
        torch.tensor(draws), cfg, m)
    return {"traj": _np(traj), "mean": _np(mean), "cov": _np(cov),
            "x": _np(final.x), "collectives": list(pmesh.COLLECTIVES)}


def _kps(yx, descr):
    B, K = yx.shape[:2]
    return keypoints.Keypoints(torch.tensor(yx), torch.ones(B, K),
                               torch.zeros(B, K), torch.tensor(descr))


def loopdb_rank(cfg_kw, frames, queries, draws, data):
    """Push every frame of `frames` (descr (T, B, Dd), yx, kd, pose) into
    a ring sharded over `data` ranks, querying before each push at the
    steps in `queries` with draws[t]: each query's result and best pose,
    this rank's block of the final ring, and whether shard_db cuts the
    same block from the whole ring pushed alongside."""
    cfg = lc.LoopConfig(**cfg_kw)
    m = pmesh.make_mesh(data, device="cpu")
    descr, yx, kd, pose = frames
    db = sdb.init_db(cfg, descr.shape[1], descr.shape[2], yx.shape[2],
                     kd.shape[3], m, dtype=torch.float64)
    whole = lc.init_db(cfg, descr.shape[1], descr.shape[2], yx.shape[2],
                       kd.shape[3], torch.float64, "cpu")
    out = []
    for t in range(descr.shape[0]):
        kp = _kps(yx[t], kd[t])
        if t in queries:
            pmesh.reset_collectives()
            r = sdb.query(db, torch.tensor(descr[t]), kp, cfg, m,
                          draws=torch.tensor(draws[t]))
            out.append({**{f: _np(getattr(r, f)) for f in r._fields},
                        "pose": _np(sdb.best_pose(db, r.best_slot, m)),
                        "collectives": list(pmesh.COLLECTIVES)})
        db = sdb.push(db, torch.tensor(descr[t]), kp, torch.tensor(pose[t]),
                      m)
        whole = lc.push(whole, torch.tensor(descr[t]), kp,
                        torch.tensor(pose[t]))
    cut = sdb.shard_db(whole, m)
    return {"queries": out, "db": {f: _np(getattr(db, f))
                                   for f in lc.DB_FIELDS},
            "shard_db_equal": all(torch.equal(getattr(cut, f),
                                              getattr(db, f))
                                  for f in lc.DB_FIELDS)}


def online_rank(state_dict, hw, images, x0, P0, cfg_kw, draws, data):
    """loop_runner.run_online with the DB sharded over `data` ranks."""
    model = vss.VSS(vss.VSSConfig(width=8), hw)
    model.load_state_dict({k: torch.tensor(v) for k, v in
                           state_dict.items()})
    m = pmesh.make_mesh(data, device="cpu")
    db, x, P, out = loop_runner.run_online(
        model.double(), torch.tensor(images), torch.tensor(x0),
        torch.tensor(P0), lc.LoopConfig(**cfg_kw), torch.tensor(draws),
        mesh=m)
    return {"x": _np(x), "P": _np(P), "count": _np(db.count),
            **{f: _np(getattr(out, f)) for f in out._fields}}


def train_rank(cases, data):
    """make_sharded_train_step over a ("data",) mesh, for each case
    (state_dict, vss_kw, tcfg_kw, batch, draws): from the weights
    `state_dict`, on the global `batch` with the global `draws` (one
    TrainDraws a step, numpy leaves). Returns a list over the cases of
    the metrics, the weights and statistics and Adam's first moments
    after the steps."""
    m = pmesh.make_mesh(data, device="cpu")
    out = []
    for state_dict, vss_kw, tcfg_kw, batch, draws in cases:
        tcfg = train.TrainConfig(**tcfg_kw)
        model = vss.VSS(vss.VSSConfig(**vss_kw), tcfg.image_hw).double()
        model.load_state_dict({k: torch.tensor(v) for k, v in
                               state_dict.items()})
        step = train.make_sharded_train_step(model, tcfg, m)
        state = train.init_state(model, tcfg)
        imgs, labels, w = (torch.tensor(a) for a in batch)
        metrics = []
        for d in draws:
            state, mt = step(state, imgs, labels, w,
                             _convert(d, torch.tensor))
            metrics.append({k: float(v) for k, v in mt.items()})
        opt = state.optimizer
        out.append({"metrics": metrics,
                    "sd": {k: _np(v) for k, v in model.state_dict().items()},
                    "mu": {n: _np(opt.state[p]["exp_avg"])
                           for n, p in model.named_parameters()}})
    return out


def _convert(tree, fn):
    """fn over the array leaves of nested (named) tuples."""
    if isinstance(tree, tuple):
        items = [_convert(v, fn) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(
            items)
    return None if tree is None else fn(tree)


def draws_to_numpy(d: train.TrainDraws):
    """A TrainDraws with numpy leaves (what train_rank takes)."""
    return _convert(d, _np)
