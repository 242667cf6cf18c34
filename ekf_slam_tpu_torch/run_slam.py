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
JAX script has no flag for it. Runs on the card unless --cpu. Not ported:
--plots (the viz package).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch

from ekf_slam_tpu_torch.config import EngineConfig, MapConfig, SimConfig
from ekf_slam_tpu_torch.filter import engine
from ekf_slam_tpu_torch.filter.state import init_state
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
                    help="not ported (the viz package; raises)")
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


def _run_images(frame, T: int, cfg: EngineConfig, batch: int, dev,
                metrics, xs=None):
    """step_image over frames frame(t) -> (H, W), t < T; metrics per
    frame. Returns instance 0's trajectory (T, 13)."""
    st = init_state(cfg, batch, dev)
    app = frontend.init_appearance(cfg, batch, dev)
    traj = []
    for t in range(T):
        img = frame(t).to(dev, cfg.torch_dtype)
        st, app, info = frontend.step_image(
            st, app, img, frame_draws(cfg, batch, t, dev), cfg)
        traj.append(st.x[0, :13])
        row = dict(n_ic=float(info.n_ic.float().mean()),
                   n_li=float(info.n_li.float().mean()))
        if xs is not None:
            row["pos_err"] = float(torch.linalg.vector_norm(
                st.x[0, 0:3] - xs[t, 0:3]))
        metrics.log(t, **row)
    return torch.stack(traj)


def main(argv=None) -> dict:
    """Run the driver; returns {mode, frames, batch, seconds, steps_per_s,
    launches, native (sequence mode), and the ATE / RPE report where there
    is a ground truth}."""
    args = parse_args(argv)
    if args.plots:
        raise ValueError("--plots (the viz package) is not ported")
    if args.mode == "sequence" and not args.pattern:
        raise ValueError("--pattern is required in sequence mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = devices.resolve("cpu" if args.cpu else None)
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
        _, traj, infos = engine.run_sequence(st, obs, u, cfg)
        traj0 = traj[0]
        err = torch.linalg.vector_norm(traj0[:, 0:3] - xs[:, 0:3], dim=-1)
        for t in range(T):
            metrics.log(t, pos_err=float(err[t]),
                        n_ic=float(infos.n_ic[:, t].float().mean()),
                        n_li=float(infos.n_li[:, t].float().mean()))
    elif args.mode == "pixels":
        scn, xs, _ = sim_scene.simulate(torch.Generator().manual_seed(0),
                                        cfg, T, dev)
        traj0 = _run_images(
            lambda t: frontend.render_scene_image(scn, xs[t], cfg, dev), T,
            cfg, B, dev, metrics, xs)
    else:
        seq = ImageSequence(args.pattern, args.start, T)
        summary["native"] = seq.native
        print(f"{args.pattern}: {seq.height}x{seq.width} frames by the "
              f"{'native loader' if seq.native else 'NumPy reader'}")
        xs = None
        traj0 = _run_images(lambda t: torch.from_numpy(seq.load(t, 1)[0]),
                            T, cfg, B, dev, metrics)
        seq.close()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0

    dump_trajectory(os.path.join(args.out, "trajectory.npz"), traj0,
                    truth=xs)
    if xs is not None:
        summary.update(traj_report(traj0, xs))
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
