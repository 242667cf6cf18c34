"""End-to-end SLAM driver on the port: the mono_slam.m equivalent.

    python -m ekf_slam_tpu_torch.run_slam --frames 60 --batch 4 --out out
    python -m ekf_slam_tpu_torch.run_slam --mode pixels --frames 20
    python -m ekf_slam_tpu_torch.run_slam --mode sequence \
        --pattern 'seq/%06d.pgm' --start 0 --frames 100

Port of ``examples/run_slam.py`` with its flags and defaults. Modes:

* ``sim``: ground-truth association on the synthetic scene
  (engine.run_sequence over --batch instances of one scene; the scene
  from a generator seeded 0, RANSAC's draws from one seeded 1);
* ``pixels``: frames rendered from the scene through the image front-end
  (vision/frontend.step_image);
* ``sequence``: PGM / PPM files on disk (io.ImageSequence: the native
  loader built from native/imageio.cpp, else the NumPy reader) through
  step_image.

In pixels and sequence mode every instance sees the same frame and draws
its own RANSAC uniforms, from a generator seeded 100 + t at frame t
(``frame_draws``; the JAX script's key(100 + t)). --batch defaults to
1, which is what the JAX script runs in those modes.

Writes trajectory.npz (instance 0's camera states, with the ground truth
in sim and pixels mode; utils/checkpoint.dump_trajectory) and
metrics.jsonl (utils/metrics.MetricsLogger), prints the ATE / RPE report
(utils/trajectory) where there is a ground truth, the launches of the
card's kernels (ops/kernels.LAUNCHES; none on the CPU) and steps/s. The
filter's configuration is the JAX script's: CAP --capacity,
min_features_in_image and max_new_per_step --min-features, --landmarks
landmarks, f32, every other setting its default (engine.step then takes
the fused step on the card where the config fits it). The iterated update
is reached from the Python API (FilterConfig.use_iterated_update); the
JAX script has no flag for it. Runs on the card unless --cpu. On the
card each frame is one replay of a frame captured as a CUDA graph
(filter/graph.py; the JAX script jits step_image and run_sequence's
step), in pixels and sequence mode with the frame and its draws copied
in as the frame's inputs and metrics.jsonl read from the stacked
outputs after the run; ``main(argv, eager=True)`` runs the eager loop
(no flag: the JAX script has none). In sim
mode --plots writes map.png (viz.plot_map_3d: instance 0's trajectory
beside the truth and its slots' first three values, as the JAX script
draws them); it needs matplotlib.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import tempfile
import time

import torch

from ekf_slam_tpu_torch.config import (CAM_DIM, EngineConfig, MapConfig,
                                       SimConfig)
from ekf_slam_tpu_torch.filter import engine, graph
from ekf_slam_tpu_torch.filter.state import FIELDS, init_state
from ekf_slam_tpu_torch.io import ImageSequence
from ekf_slam_tpu_torch.ops import device as devices
from ekf_slam_tpu_torch.ops import kernels
from ekf_slam_tpu_torch.sim import scene as sim_scene
from ekf_slam_tpu_torch.utils import trajectory as tj
from ekf_slam_tpu_torch.utils.checkpoint import dump_trajectory
from ekf_slam_tpu_torch.utils.metrics import MetricsLogger
from ekf_slam_tpu_torch.vision import frontend


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", default="sim",
                    choices=["sim", "pixels", "sequence"],
                    help="sim: ground-truth association; pixels: rendered "
                         "frames through the image front-end; sequence: "
                         "PGM files via the native loader")
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--batch", type=int, default=1,
                    help="filter instances (in pixels and sequence mode "
                         "they share each frame)")
    ap.add_argument("--capacity", type=int, default=64)
    ap.add_argument("--min-features", type=int, default=20)
    ap.add_argument("--landmarks", type=int, default=96)
    ap.add_argument("--pattern", default=None, help="printf PGM pattern")
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "ekf_slam_out"))
    ap.add_argument("--plots", action="store_true",
                    help="sim mode: write map.png (needs matplotlib)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (plain versions, no kernels)")
    return ap.parse_args(argv)


def slam_config(args) -> EngineConfig:
    """The JAX script's filter configuration."""
    return EngineConfig(
        map=MapConfig(capacity=args.capacity,
                      min_features_in_image=args.min_features,
                      max_new_per_step=args.min_features),
        sim=SimConfig(num_landmarks=args.landmarks))


def frame_draws(cfg: EngineConfig, batch: int, t: int, device) -> torch.Tensor:
    """RANSAC's uniforms (B, NHYP) of image frame t: a generator on
    `device` seeded 100 + t."""
    gen = torch.Generator(device=device).manual_seed(100 + t)
    return torch.rand(batch, cfg.ransac.num_hypotheses, generator=gen,
                      device=device, dtype=cfg.torch_dtype)


def traj_report(traj: torch.Tensor, xs: torch.Tensor) -> dict:
    """Print and return the trajectory metrics (utils/trajectory.py):
    gauge-aligned ATE (SE3 and Sim3, the monocular-scale variant) and
    one-frame RPE."""
    e, g = traj.double().cpu(), xs.double().cpu()
    out = {"ate": float(tj.ate_rmse(e[:, 0:3], g[:, 0:3])),
           "ate_sim3": float(tj.ate_rmse(e[:, 0:3], g[:, 0:3],
                                         with_scale=True))}
    rpe_t, rpe_r = tj.rpe(e[:, 0:3], e[:, 3:7], g[:, 0:3], g[:, 3:7])
    out.update(rpe_trans=float(rpe_t), rpe_rot=float(rpe_r))
    print(f"ATE (SE3-aligned) {out['ate']:.4f} | ATE (Sim3) "
          f"{out['ate_sim3']:.4f} | RPE/frame {out['rpe_trans']:.4f} m, "
          f"{out['rpe_rot']:.4f} rad")
    return out


def run_frames(frame, T: int, cfg: EngineConfig, batch: int, dev,
               capture=True):
    """step_image over the frames frame(t) -> (H, W), t < T, each loaded
    at its turn (frontend._image_frame, the frame run_images replays, kept
    under the same key): replayed from a captured CUDA graph
    (capture=True), the same frame over static buffers without a graph
    (capture=False, how the CPU tests see what replay runs) or the eager
    loop (capture=None). Returns (camera trajectory (B, T, 13), StepInfo
    with (B, T) fields)."""
    st = init_state(cfg, batch, dev)
    app = frontend.init_appearance(cfg, batch, dev)
    _, (traj, *info) = graph.run(
        functools.partial(frontend._image_frame, cfg=cfg),
        (*(getattr(st, f) for f in FIELDS),
         *(getattr(app, f) for f in frontend.APPEARANCE_FIELDS)),
        lambda t: (frame(t).to(dev, cfg.torch_dtype),
                   frame_draws(cfg, batch, t, dev)),
        T, ("image", cfg, engine.route(cfg, dev, fused=False)), capture)
    return traj, engine.StepInfo(*info)


def log_frames(metrics, traj0: torch.Tensor, infos, xs=None) -> None:
    """metrics.jsonl's rows of an image run, read from its stacked
    outputs: the instances' mean n_ic and n_li and, with a ground truth
    xs, instance 0's position error."""
    for t in range(traj0.shape[0]):
        row = dict(n_ic=float(infos.n_ic[:, t].float().mean()),
                   n_li=float(infos.n_li[:, t].float().mean()))
        if xs is not None:
            row["pos_err"] = float(torch.linalg.vector_norm(
                traj0[t, 0:3] - xs[t, 0:3]))
        metrics.log(t, **row)


def main(argv=None, eager: bool | None = None) -> dict:
    """Run the driver; returns {mode, frames, batch, seconds, steps_per_s,
    launches, native (sequence mode), and the ATE / RPE report where there
    is a ground truth}. On a CUDA device each mode replays one frame
    captured as a CUDA graph (run); eager=True runs the eager loop, and
    eager=False without a card raises."""
    args = parse_args(argv)
    if args.mode == "sequence" and not args.pattern:
        raise ValueError("--pattern is required in sequence mode")
    dev = devices.resolve("cpu" if args.cpu else None)
    return run(args, dev, True if graph.replays(dev, eager) else None)


def run(args, dev, capture=True) -> dict:
    """The driver on parsed arguments, on `dev`: each frame replayed from
    a captured CUDA graph (capture=True; sim mode through
    engine.frame_driver, the others through run_frames), run over static
    buffers without a graph (capture=False, how the CPU tests see what
    replay runs) or the eager loop (capture=None). Returns what main
    returns."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(args.out, exist_ok=True)
    cfg = slam_config(args)
    T, B = args.frames, args.batch
    metrics = MetricsLogger()
    summary = {"mode": args.mode, "frames": T, "batch": B}
    kernels.reset_launches()
    t0 = time.perf_counter()

    if args.mode == "sim":
        _, xs, obs = sim_scene.simulate(torch.Generator().manual_seed(0),
                                        cfg, T, dev)
        st = engine.bootstrap(init_state(cfg, B, dev), obs.frame(0), cfg)
        u = torch.rand(T, B, cfg.ransac.num_hypotheses, device=dev,
                       dtype=cfg.torch_dtype,
                       generator=torch.Generator(device=dev).manual_seed(1))
        final, traj, infos = (
            engine.run_sequence(st, obs, u, cfg, eager=True)
            if capture is None else
            engine.frame_driver(st, obs, u, cfg, capture))
        traj0 = traj[0]
        err = torch.linalg.vector_norm(traj0[:, 0:3] - xs[:, 0:3], dim=-1)
        for t in range(T):
            metrics.log(t, pos_err=float(err[t]),
                        n_ic=float(infos.n_ic[:, t].float().mean()),
                        n_li=float(infos.n_li[:, t].float().mean()))
    elif args.mode == "pixels":
        scn, xs, _ = sim_scene.simulate(torch.Generator().manual_seed(0),
                                        cfg, T, dev)
        traj, infos = run_frames(
            lambda t: frontend.render_scene_image(scn, xs[t], cfg, dev), T,
            cfg, B, dev, capture)
        traj0 = traj[0]
        log_frames(metrics, traj0, infos, xs)
    else:
        seq = ImageSequence(args.pattern, args.start, T)
        summary["native"] = seq.native
        print(f"{args.pattern}: {seq.height}x{seq.width} frames by the "
              f"{'native loader' if seq.native else 'NumPy reader'}")
        xs = None
        traj, infos = run_frames(
            lambda t: torch.from_numpy(seq.load(t, 1)[0]), T, cfg, B, dev,
            capture)
        seq.close()
        traj0 = traj[0]
        log_frames(metrics, traj0, infos)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0

    dump_trajectory(os.path.join(args.out, "trajectory.npz"), traj0,
                    truth=xs)
    if xs is not None:
        summary.update(traj_report(traj0, xs))
    if args.plots and args.mode == "sim":
        from ekf_slam_tpu_torch.viz import plot_map_3d
        lm = final.x[0, CAM_DIM:].reshape(cfg.map.capacity, 6)[:, 0:3]
        plot_map_3d(os.path.join(args.out, "map.png"),
                    traj0[:, 0:3].cpu().numpy(), lm.cpu().numpy(),
                    active=final.active[0].cpu().numpy(),
                    truth_traj=xs.cpu().numpy())
    metrics.dump_jsonl(os.path.join(args.out, "metrics.jsonl"))
    print(metrics.table(last_n=3))
    summary.update(seconds=dt, steps_per_s=T * B / dt,
                   launches={k: v for k, v in kernels.LAUNCHES.items() if v})
    print(f"kernel launches {json.dumps(summary['launches'])}")
    print(f"\n{T} frames in {dt:.2f}s -> {T * B / dt:.1f} steps/s")
    print(f"outputs in {args.out}")
    return summary


if __name__ == "__main__":
    main()
