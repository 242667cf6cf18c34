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
models/flax_init.py), queries the ring database with geometric
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
card unless --cpu. Not ported: --ckpt (an orbax checkpoint of the JAX
trainer) and --plot (the viz package).
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from ekf_slam_tpu_torch.io import ImageSequence
from ekf_slam_tpu_torch.io.poses import (load_kitti_poses, poses_to_rq,
                                         save_trajectory_kitti)
from ekf_slam_tpu_torch.models import keypoints as kp_mod
from ekf_slam_tpu_torch.models import loopclosure as lc
from ekf_slam_tpu_torch.models.flax_init import flax_variables
from ekf_slam_tpu_torch.models.vss import VSS, VSSConfig, from_flax
from ekf_slam_tpu_torch.ops import device as devices
from ekf_slam_tpu_torch.run_loop_closure import to_vss


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
                    help="an orbax checkpoint: not ported (raises)")
    ap.add_argument("--sim-threshold", type=float, default=0.85)
    ap.add_argument("--min-inliers", type=int, default=8)
    ap.add_argument("--consistency", type=int, nargs=2, default=(2, 3),
                    help="C hits within window W (reference: 7 9)")
    ap.add_argument("--exclude-recent", type=int, default=0,
                    help="0 = frames//4 (reference: 200)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (no kernels on this path)")
    ap.add_argument("--plot", action="store_true",
                    help="not ported (the viz package; raises)")
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


def main(argv=None, draws_fn=None) -> dict:
    """Run the script. draws_fn(t, LoopConfig, K) -> (top_k, NH, K)
    uniforms replaces frame t's generator draws (the parity tests hand in
    JAX's). Returns {frames, loops [(i, j)], loop_inliers, native,
    seconds, frames_per_s}."""
    args = parse_args(argv)
    if args.ckpt:
        raise ValueError("--ckpt (an orbax checkpoint of the JAX trainer) "
                         "is not ported")
    if args.plot:
        raise ValueError("--plot (the viz package) is not ported")
    # The cosine gate and the DB's top-k must see true-f32 descriptors.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = devices.resolve("cpu" if args.cpu else None)

    poses = load_kitti_poses(args.poses)
    T = args.frames or poses.shape[0]
    if poses.shape[0] < T:
        raise ValueError(f"the pose file has {poses.shape[0]} rows < "
                         f"--frames {T}")
    poses_rq = poses_to_rq(poses[:T])
    seq = ImageSequence(args.pattern, args.start, T)

    vcfg, hw = VSSConfig(width=args.vss_width), tuple(args.vss_hw)
    model = VSS(vcfg, hw)
    model.load_state_dict(from_flax(flax_variables(vcfg, hw, 2)))
    model = model.to(dev)
    lcfg = loop_config(args, T)

    @torch.no_grad()
    def embed(img):
        outs = model(to_vss(img, hw), descriptor_only=True)
        return outs["descriptor"], kp_mod.kp_descriptor(outs["c5"])

    os.makedirs(args.out, exist_ok=True)
    db = None
    loops = []       # (i, j, pose_i(7), pose_j(7), inliers)
    q_times = []     # (frame, db_count, seconds)
    t_start = time.perf_counter()
    for t in range(T):
        img = torch.from_numpy(seq.load(t, 1)[0]).to(dev)
        descr, kps = embed(img)
        if db is None:
            db = lc.init_db(lcfg, 1, descr.shape[1], kps.yx.shape[1],
                            kps.descr.shape[2], device=dev)
        t0 = time.perf_counter()
        warm = int(db.count[0]) >= lcfg.min_db
        if draws_fn is None:
            res = lc.query(db, descr, kps, lcfg,
                           generator=torch.Generator().manual_seed(200 + t))
        else:
            draws = torch.as_tensor(np.asarray(draws_fn(t, lcfg,
                                                        model.num_kp)))
            res = lc.query(db, descr, kps, lcfg,
                           draws[None].to(dev))
        res = res._replace(is_hypothesis=res.is_hypothesis & warm)
        db, declared, _, match_frame = lc.step_temporal(db, res, lcfg)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        q_times.append((t, int(db.count[0]), time.perf_counter() - t0))
        if bool(declared[0]):
            j = int(match_frame[0])
            loops.append((t, j, poses_rq[t], poses_rq[j],
                          int(res.best_inliers[0])))
            print(f"LOOP frame {t} -> {j} (inliers {loops[-1][4]})",
                  flush=True)
        db = lc.push(db, descr, kps, torch.as_tensor(
            poses_rq[t][None], dtype=db.pose.dtype, device=dev))
    seconds = time.perf_counter() - t_start
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
    print(f"{T} frames in {seconds:.2f}s -> {T / seconds:.1f} frames/s")
    print(f"{len(loops)} loops over {T} frames; artifacts in {args.out}")
    return {"frames": T, "loops": [(i, j) for i, j, _, _, _ in loops],
            "loop_inliers": [n for _, _, _, _, n in loops],
            "native": native, "seconds": seconds,
            "frames_per_s": T / seconds}


if __name__ == "__main__":
    main()
