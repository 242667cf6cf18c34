"""The row-sharded EKF-SLAM driver: P's rows sharded over the ranks of a
mesh's "model" axis.

    python -m ekf_slam_tpu_torch.run_tp_filter --frames 12 --cap 48 \
        --model 2 --backend gloo [--cpu]

Port of ``examples/run_tp_filter.py``. The joint covariance is D x D with
D = 13 + 6·CAP; here each rank holds a (B_l, Dp/k, Dp) slab of it
(parallel/sharded_filter.py). Spawns data x model ranks (processes,
parallel/mesh.spawn); rank 0 prints the mesh, each rank's slab shape, the
largest collective payload of a frame against its bound and the full P's
size, the run's time, the tracking error against the synthetic ground
truth and the largest difference of x and P from the single-device
unfused step on the same draws. ``--backend gloo`` lets several ranks
share one card (NCCL refuses two ranks on one GPU); the default is nccl
when every rank has a card of its own, else gloo. Runs on the card unless
--cpu.
"""

from __future__ import annotations

import argparse
import time

import torch

from ekf_slam_tpu_torch.config import EngineConfig
from ekf_slam_tpu_torch.filter import engine
from ekf_slam_tpu_torch.filter.state import init_state
from ekf_slam_tpu_torch.ops import device as devices
from ekf_slam_tpu_torch.ops import kernels
from ekf_slam_tpu_torch.parallel import mesh as pmesh
from ekf_slam_tpu_torch.parallel import sharded_filter as sf
from ekf_slam_tpu_torch.sim import simulate


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--cap", type=int, default=48)
    ap.add_argument("--landmarks", type=int, default=64)
    ap.add_argument("--batch", type=int, default=2,
                    help="instances a data rank")
    ap.add_argument("--model", type=int, default=2,
                    help="model-axis size (covariance slabs)")
    ap.add_argument("--data", type=int, default=1, help="data-axis size")
    ap.add_argument("--backend", default=None, choices=["gloo", "nccl"])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    return ap.parse_args(argv)


def config(cap: int, landmarks: int) -> EngineConfig:
    """The driver's map: capacity `cap`, the unfused step."""
    return EngineConfig.from_dict({
        "filter": {"fused_step": "off"},
        "map": {"capacity": cap, "min_features_in_image": min(20, cap // 2),
                "max_new_per_step": min(20, cap // 2)},
        "sim": {"num_landmarks": landmarks}})


def inputs(cfg: EngineConfig, frames: int, batch: int, device):
    """The sequence, the bootstrapped batch and RANSAC's draws, from
    generators seeded 0 and 1 (the same on every rank)."""
    _, xs, obs = simulate(torch.Generator().manual_seed(0), cfg, frames,
                          device)
    st = engine.bootstrap(init_state(cfg, batch, device), obs.frame(0), cfg)
    u = torch.rand(frames, batch, cfg.ransac.num_hypotheses,
                   generator=torch.Generator().manual_seed(1)).to(device)
    return xs, obs, st, u


def run(args) -> dict:
    """One rank's run: the sharded frames, then (rank 0) the single-device
    unfused run for the difference. Returns rank 0's report."""
    dev = devices.resolve("cpu" if args.cpu else None)
    mesh = pmesh.make_mesh(args.data, args.model, device=dev)
    dev = mesh.device
    cfg = config(args.cap, args.landmarks)
    B = args.batch * args.data
    xs, obs, st, u = inputs(cfg, args.frames, B, dev)
    D, Dp = sf.padded_dim(cfg, args.model)
    step = sf.make_sharded_step(cfg, mesh)
    sp = sf.shard_state_batch(st, mesh, cfg)
    mine = pmesh.block(B, mesh, "data")
    payload = 0
    kernels.reset_launches()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(1, args.frames):
        pmesh.reset_collectives()
        sp, _ = step(sp, obs.frame(t), u[t, mine])
        payload = max([payload] + [n for _, _, n in pmesh.COLLECTIVES])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    full = sf.gather_state(sp, mesh, cfg)
    xg = pmesh.all_gather(full.x, mesh, "data")
    Pg = pmesh.all_gather(full.P, mesh, "data")
    if torch.distributed.get_rank() != 0:
        return {}
    ref = st
    for t in range(1, args.frames):
        ref, _ = engine.step(ref, obs.frame(t), u[t], cfg)
    err = torch.linalg.vector_norm(xg[:, 0:3] - xs[-1, 0:3].to(dev), dim=-1)
    report = {
        "mesh": f"{args.data}x{args.model}", "D": D, "Dp": Dp,
        "slab": list(sp.P.shape), "frames": args.frames - 1, "batch": B,
        "largest_payload": payload,
        "payload_bound": sf.payload_bound(cfg, args.batch, Dp),
        "full_P": args.batch * Dp * D, "seconds": seconds,
        "frames_per_s": (args.frames - 1) / seconds,
        "max_dx": float((xg - ref.x).abs().max()),
        "max_dP": float((Pg - ref.P).abs().max()),
        "max_P": float(ref.P.abs().max()),
        "finite": bool(torch.isfinite(Pg).all()),
        "pos_err": [round(float(e), 4) for e in err],
        "launches": {k: v for k, v in launches.items() if v}}
    print(f"mesh data={args.data} x model={args.model}; D={D} (padded {Dp});"
          f" slab {tuple(sp.P.shape)} a rank "
          f"({Dp // args.model * Dp * 4 / 2**20:.2f} MiB an instance vs "
          f"{D * D * 4 / 2**20:.2f} unsharded)")
    print(f"largest collective {payload} elements (bound "
          f"{report['payload_bound']}; the slab rank's full P "
          f"{report['full_P']})")
    print(f"{args.frames - 1} frames x {B} instances in {seconds:.2f} s; "
          f"finite={report['finite']}; pos err at the last frame "
          f"{report['pos_err']}; vs the single-device step max|dx| "
          f"{report['max_dx']:.3e} max|dP| {report['max_dP']:.3e} "
          f"(max|P| {report['max_P']:.3e}); kernel launches "
          f"{report['launches']}", flush=True)
    return report


def main(argv=None) -> dict:
    args = parse_args(argv)
    world = args.data * args.model
    backend = args.backend or pmesh.default_backend(
        world, "cpu" if args.cpu else None)
    return pmesh.spawn(run, world, backend, args)[0]


if __name__ == "__main__":
    main()
