"""The bench gates of the bf16-P fast mode, scene by scene.

    python -m ekf_slam_tpu_torch.scene_gates [--device cuda|cpu]
        [--batch 128] [--scenes 0,1,2,3]

For each scene seed (sim.simulate on a torch generator) and each path of
``profile_slice.FAST_PATHS``, the fast-mode sim workload
(``profile_slice.slice_config``) runs 16 frames at B instances, RANSAC
draws from seed 1, and prints bench.py's gates (bench.py:383-404): the
instances whose trajectory and P stayed finite, the mean and the largest
tracking error over them (gate: mean < 0.2), and the largest update
against the cap (max_update_obs 24). profile_slice.FAST_SCENE was chosen
from these readings. On the card unless --device names another; the
readings depend on the device's draws.
"""

from __future__ import annotations

import argparse

import torch

from ekf_slam_tpu_torch.profile_slice import (BATCH, FAST_PATHS, FRAMES,
                                              slice_config, slice_inputs,
                                              update_form)
from ekf_slam_tpu_torch.filter import engine


def gates(path: str, scene: int, dev, batch: int) -> dict:
    """bench.py's gate readings of one fast path on one scene."""
    cfg = slice_config(path)
    st0, xs, obs, u = slice_inputs(cfg, dev, batch, FRAMES, scene)
    with update_form(path):
        final, traj, infos = engine.run_sequence(st0, obs, u, cfg)
    ok = (torch.isfinite(traj).flatten(1).all(1)
          & torch.isfinite(final.P.float()).flatten(1).all(1))
    err = torch.linalg.vector_norm(traj[..., :3] - xs[None, :, :3],
                                   dim=-1).mean(1)[ok]
    return {"finite": int(ok.sum()), "batch": batch,
            "mean_err": float(err.mean()) if len(err) else None,
            "max_err": float(err.max()) if len(err) else None,
            "largest_update": int(torch.maximum(infos.n_li.max(),
                                                infos.n_hi.max())),
            "update_cap": cfg.map.max_update_obs}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--batch", type=int, default=BATCH)
    parser.add_argument("--scenes", default="0,1,2,3")
    args = parser.parse_args(argv)
    for scene in map(int, args.scenes.split(",")):
        for path in FAST_PATHS:
            g = gates(path, scene, torch.device(args.device), args.batch)
            print(f"[gates] scene={scene} path={path} device={args.device} "
                  + " ".join(f"{k}={v}" for k, v in g.items()), flush=True)


if __name__ == "__main__":
    main()
