"""A dry run of every multi-process path of the port on a few ranks, at
tiny shapes.

    python -m ekf_slam_tpu_torch.dryrun_multichip [--world 2]
        [--backend gloo] [--cpu]

The port of ``__graft_entry__.dryrun_multichip``'s four legs on
torch.distributed: (a) one data-parallel EKF frame, the instances over
the "data" ranks and their mean camera pose all-reduced; (b) one
row-sharded frame (parallel/sharded_filter.py), P's rows over "model"
ranks; (c) one data-parallel CALC2 train step
(train.make_sharded_train_step); (d) the capacity-sharded loop DB
(parallel/sharded_loopdb.py): four pushes and a query. Each leg checks
its output is finite and of the expected shape; rank 0 prints a line a
leg. ``--backend gloo`` lets several ranks share one card; the default
is nccl when every rank has a card of its own, else gloo. Runs on the
card unless --cpu.
"""

from __future__ import annotations

import argparse

import torch

from ekf_slam_tpu_torch.config import EngineConfig
from ekf_slam_tpu_torch.data import synthetic
from ekf_slam_tpu_torch.filter import engine
from ekf_slam_tpu_torch.filter.state import init_state
from ekf_slam_tpu_torch.models import keypoints, train
from ekf_slam_tpu_torch.models import loopclosure as lc
from ekf_slam_tpu_torch.models.vss import VSSConfig
from ekf_slam_tpu_torch.ops import device as devices
from ekf_slam_tpu_torch.parallel import mesh as pmesh
from ekf_slam_tpu_torch.parallel import sharded_filter as sf
from ekf_slam_tpu_torch.parallel import sharded_loopdb as sdb
from ekf_slam_tpu_torch.sim import simulate

CFG = {"filter": {"fused_step": "off"},
       "map": {"capacity": 12, "min_features_in_image": 6,
               "max_new_per_step": 6},
       "sim": {"num_landmarks": 16}}


def _say(line: str) -> None:
    if torch.distributed.get_rank() == 0:
        print(line, flush=True)


def legs(device) -> dict:
    """The four legs on the default group's ranks; returns what rank 0
    printed, by leg."""
    n = torch.distributed.get_world_size()
    out = {}
    cfg = EngineConfig.from_dict(CFG)
    mesh = pmesh.make_mesh(device=device)
    dev = mesh.device
    _, _, obs = simulate(torch.Generator().manual_seed(0), cfg, 2, dev)
    B = 2 * n
    st = engine.bootstrap(init_state(cfg, B, dev), obs.frame(0), cfg)
    u = torch.rand(B, cfg.ransac.num_hypotheses,
                   generator=torch.Generator().manual_seed(1)).to(dev)
    mine = pmesh.block(B, mesh)

    # (a) data-parallel EKF frame
    new, _ = engine.step(pmesh.shard_batch(st, mesh), obs.frame(1), u[mine],
                         cfg)
    mean = pmesh.all_reduce(new.x[:, :13].sum(dim=0), mesh, "data") / B
    assert mean.shape == (13,) and bool(torch.isfinite(mean).all())
    out["ekf"] = (f"dryrun_multichip EKF OK on {n} ranks: mean cam pose "
                  f"{[round(v, 6) for v in mean[:3].tolist()]}")
    _say(out["ekf"])

    # (b) row-sharded EKF frame, P's rows over every rank
    tp = pmesh.make_mesh(1, n, device=device)
    D, Dp = sf.padded_dim(cfg, n)
    sp = sf.shard_state_batch(st, tp, cfg)
    sp, _ = sf.make_sharded_step(cfg, tp)(sp, obs.frame(1), u)
    assert tuple(sp.P.shape) == (B, Dp // n, Dp)
    assert bool(torch.isfinite(sp.x).all() & torch.isfinite(sp.P).all())
    out["tp"] = (f"dryrun_multichip TP-EKF OK on {n} ranks (data=1 x "
                 f"model={n}): P rows a rank {Dp}/{n}={Dp // n}")
    _say(out["tp"])

    # (c) data-parallel CALC2 train step
    hw = (32, 32)
    model = train.create_model(VSSConfig(width=8), hw,
                               torch.Generator().manual_seed(0)).to(dev)
    tcfg = train.TrainConfig(batch_size=2 * n, image_hw=hw)
    imgs, labels = synthetic.synthetic_batch(
        2 * n, hw, generator=torch.Generator(device=dev).manual_seed(1))
    step = train.make_sharded_train_step(model, tcfg, mesh)
    _, m = step(train.init_state(model, tcfg), imgs, labels,
                synthetic.class_weights(labels),
                generator=torch.Generator(device=dev).manual_seed(2))
    assert bool(torch.isfinite(m["loss"]))
    out["train"] = (f"dryrun_multichip CALC2 train OK on {n} ranks: loss "
                    f"{float(m['loss']):.3f}")
    _say(out["train"])

    # (d) capacity-sharded loop DB
    lcfg = lc.LoopConfig(capacity=8 * n, top_k=3, exclude_recent=1,
                         min_db=0, ransac_hypotheses=8, min_inliers=4)
    db = sdb.init_db(lcfg, 1, 16, 8, 4, mesh)
    kp = keypoints.Keypoints(torch.zeros(1, 8, 2, device=dev),
                             torch.zeros(1, 8, device=dev),
                             torch.zeros(1, 8, device=dev),
                             torch.ones(1, 8, 4, device=dev))
    for i in range(4):
        db = sdb.push(db, torch.full((1, 16), float(i + 1), device=dev), kp,
                      torch.zeros(1, 7, device=dev), mesh)
    res = sdb.query(db, torch.ones(1, 16, device=dev), kp, lcfg, mesh,
                    generator=torch.Generator(device=dev).manual_seed(3))
    assert res.similarities.shape == (1, lcfg.top_k)
    out["loopdb"] = (f"dryrun_multichip sharded loop DB OK on {n} ranks: "
                     f"best frame {int(res.best_id[0])}")
    _say(out["loopdb"])
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=2, help="ranks")
    ap.add_argument("--backend", default=None, choices=["gloo", "nccl"])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = devices.resolve("cpu" if args.cpu else None)
    backend = args.backend or pmesh.default_backend(args.world, device)
    return pmesh.spawn(legs, args.world, backend, device)[0]


if __name__ == "__main__":
    main()
