"""Online loop closure from files on disk, on the port: the
close_kitti_loops.py analog.

    python -m ekf_slam_tpu_torch.close_loops --poses seq/poses.txt \
        --pattern 'seq/%06d.pgm' --frames 20 --out loops

Port of ``examples/close_loops.py`` with its flags, defaults and
artifacts. It reads a KITTI-format pose file (io/poses.load_kitti_poses)
and a printf image pattern (io.ImageSequence: the native loader built
from native/imageio.cpp, else the NumPy reader), embeds each frame with
the CALC2 VSS (descriptor and keypoints; the JAX script's network, Flax's
initial draw from key 2 at --vss-width and --vss-hw, drawn without JAX by
models/flax_init.py, or with --ckpt a checkpoint of the port's trainer),
queries the ring database with geometric
verification and the temporal filter (models/loopclosure.query and
step_temporal), pushes the frame, and writes the reference's three
artifacts ("CALC 2.0"/close_kitti_loops.py:141-158):

  kitti_traj.txt    the poses, KITTI rows
  kitti_loops.txt   i j pose_i(7) pose_j(7) of each declared loop: both
                    full [r, q] poses, so a row can drive
                    filter/loop_fusion.apply_loop_constraint_pose
  kitti_q_times.txt frame, DB size, query seconds

RANSAC's draws at frame t come from a generator seeded 200 + t (the JAX
script's key(200 + t)), or from ``main``'s ``draws_fn`` hook. Runs on the
card unless --cpu. On the card a frame is two replays of pieces captured
as CUDA graphs (filter/graph.py; the JAX script jits embed): the embed
piece, then the query piece (query, temporal filter, push), with the
declared flag read back between frames; ``main(argv, eager=True)`` runs
them eagerly (no flag: the JAX script has none). --ckpt reads the port's own checkpoints
(models/train.save_checkpoint), not the JAX trainer's orbax ones. --plot
writes loops.png from the artifacts (viz.plot_loops, the plot_loops.m
analog); it needs matplotlib.
"""

from __future__ import annotations

import argparse
import functools
import os
import tempfile
import time

import numpy as np
import torch

from ekf_slam_tpu_torch.filter import graph
from ekf_slam_tpu_torch.io import ImageSequence
from ekf_slam_tpu_torch.io.poses import (load_kitti_poses, poses_to_rq,
                                         save_trajectory_kitti)
from ekf_slam_tpu_torch.models import loopclosure as lc
from ekf_slam_tpu_torch.models.vss import VSSConfig
from ekf_slam_tpu_torch.ops import device as devices
from ekf_slam_tpu_torch.run_loop_closure import (Query, check_ckpt,
                                                 embed_frame, load_vss)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--poses", required=True)
    ap.add_argument("--pattern", required=True)
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--frames", type=int, default=0,
                    help="0 = as many as the pose file has")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "loops"))
    ap.add_argument("--vss-width", type=int, default=8)
    ap.add_argument("--vss-hw", type=int, nargs=2, default=(48, 64))
    ap.add_argument("--ckpt", default="",
                    help="a checkpoint of the port's trainer (train_calc2's "
                         "ckpt_final) at --vss-width / --vss-hw; the JAX "
                         "trainer's orbax checkpoints cannot be read")
    ap.add_argument("--sim-threshold", type=float, default=0.85)
    ap.add_argument("--min-inliers", type=int, default=8)
    ap.add_argument("--consistency", type=int, nargs=2, default=(2, 3),
                    help="C hits within window W (reference: 7 9)")
    ap.add_argument("--exclude-recent", type=int, default=0,
                    help="0 = frames//4 (reference: 200)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (no kernels on this path)")
    ap.add_argument("--plot", action="store_true",
                    help="write loops.png from the artifacts (needs "
                         "matplotlib)")
    return ap.parse_args(argv)


def loop_config(args, T: int) -> lc.LoopConfig:
    """The JAX script's LoopConfig for a T-frame run."""
    excl = args.exclude_recent or max(T // 4, 2)
    return lc.LoopConfig(capacity=max(256, T), top_k=3,
                         exclude_recent=excl, min_db=excl,
                         sim_threshold=args.sim_threshold,
                         min_inliers=args.min_inliers,
                         ransac_hypotheses=16,
                         consistency_count=args.consistency[0],
                         consistency_window=args.consistency[1])


def main(argv=None, draws_fn=None, eager: bool | None = None) -> dict:
    """Run the script. draws_fn(t, LoopConfig, K) -> (top_k, NH, K)
    uniforms replaces frame t's generator draws (the parity tests hand in
    JAX's). On a CUDA device the embed and query pieces replay from
    captured CUDA graphs (run); eager=True runs them eagerly, and
    eager=False without a card raises. Returns {frames, loops [(i, j)],
    loop_inliers, native, seconds, frames_per_s, capture_s (the seconds
    of them spent capturing the pieces, 0 unless replayed)}."""
    args = parse_args(argv)
    if args.ckpt:
        check_ckpt(args.ckpt)
    dev = devices.resolve("cpu" if args.cpu else None)
    return run(args, dev, True if graph.replays(dev, eager) else None,
               draws_fn)


def run(args, dev, capture=True, draws_fn=None) -> dict:
    """The script on parsed arguments, on `dev`: each frame the embed
    piece (run_loop_closure.embed_frame on the loaded frame), then the
    query piece (run_loop_closure.Query), replayed from CUDA graphs
    (capture=True), over static buffers without a graph (capture=False,
    how the CPU tests see what replay runs) or eagerly (capture=None).
    kitti_q_times.txt's seconds are the query piece's, up to a
    synchronize. Returns what main returns."""
    # The cosine gate and the DB's top-k must see true-f32 descriptors.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    poses = load_kitti_poses(args.poses)
    T = args.frames or poses.shape[0]
    if poses.shape[0] < T:
        raise ValueError(f"the pose file has {poses.shape[0]} rows < "
                         f"--frames {T}")
    poses_rq = poses_to_rq(poses[:T])
    seq = ImageSequence(args.pattern, args.start, T)

    hw = tuple(args.vss_hw)
    model = load_vss(VSSConfig(width=args.vss_width), hw, args.ckpt).to(dev)
    lcfg = loop_config(args, T)
    embed, query = None, Query(lcfg, dev, capture)

    os.makedirs(args.out, exist_ok=True)
    loops = []       # (i, j, pose_i(7), pose_j(7), inliers)
    q_times = []     # (frame, db_count, seconds)
    t_start = time.perf_counter()
    for t in range(T):
        inputs = (torch.from_numpy(seq.load(t, 1)[0]).to(dev),)
        if embed is None:
            embed = graph.piece(functools.partial(embed_frame, model=model,
                                                  hw=hw),
                                (), inputs, None, capture)
        descr, *kp = embed.step(inputs)
        if draws_fn is None:
            draws = lc.ransac_draws(lcfg, 1, kp[0].shape[1],
                                    torch.Generator().manual_seed(200 + t),
                                    kp[0].dtype, dev)
        else:
            draws = torch.as_tensor(np.asarray(draws_fn(
                t, lcfg, model.num_kp)))[None].to(dev)
        pose = torch.as_tensor(poses_rq[t][None], dtype=torch.float32,
                               device=dev)          # lc.init_db's dtype
        t0 = time.perf_counter()
        res, declared, _, match_frame, _ = query.step(
            descr, kp, pose, draws, t >= lcfg.min_db, lcfg.sim_threshold)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        q_times.append((t, t, time.perf_counter() - t0))  # t frames pushed
        if bool(declared[0]):
            j = int(match_frame[0])
            loops.append((t, j, poses_rq[t], poses_rq[j],
                          int(res.best_inliers[0])))
            print(f"LOOP frame {t} -> {j} (inliers {loops[-1][4]})",
                  flush=True)
    seconds = time.perf_counter() - t_start
    # what capturing the two pieces took (warm-up frames included)
    capture_s = sum(getattr(p, "capture_s", None) or 0.0
                    for p in (embed, query.piece))
    native = seq.native
    seq.close()

    save_trajectory_kitti(os.path.join(args.out, "kitti_traj.txt"),
                          poses_rq)
    with open(os.path.join(args.out, "kitti_loops.txt"), "w") as f:
        for i, j, pi, pj, _ in loops:
            row = [i, j] + [float(v) for v in pi] + [float(v) for v in pj]
            f.write(" ".join(str(v) for v in row) + "\n")
    with open(os.path.join(args.out, "kitti_q_times.txt"), "w") as f:
        for t, n, dt in q_times:
            f.write(f"{t} {n} {dt:.6f}\n")
    print(f"{args.pattern}: frames by the "
          f"{'native loader' if native else 'NumPy reader'}")
    print(f"{T} frames in {seconds:.2f}s -> {T / seconds:.1f} frames/s"
          + (f" ({capture_s:.3f} s of it capturing the embed and query "
             f"pieces)" if capture_s else ""))
    print(f"{len(loops)} loops over {T} frames; artifacts in {args.out}")
    if args.plot:
        from ekf_slam_tpu_torch.viz import plot_loops
        plot_loops(os.path.join(args.out, "loops.png"),
                   os.path.join(args.out, "kitti_traj.txt"),
                   os.path.join(args.out, "kitti_loops.txt"))
        print(f"wrote {os.path.join(args.out, 'loops.png')}")
    return {"frames": T, "loops": [(i, j) for i, j, _, _, _ in loops],
            "loop_inliers": [n for _, _, _, _, n in loops],
            "native": native, "seconds": seconds,
            "frames_per_s": T / seconds, "capture_s": capture_s}


if __name__ == "__main__":
    main()
