"""SLAM + CALC2 loop closure end to end, on the port.

    python -m ekf_slam_tpu_torch.run_loop_closure --frontend pixels \
        --traj pan --frames 150 --ensemble 4 --json runs/loop_e2e.json

Port of ``examples/run_loop_closure.py`` with its flags, defaults,
LoopConfig, auto-calibration and JSON summary keys. The camera flies a
revisit trajectory over a synthetic landmark field; the filter tracks it
(drifting) while every frame also runs the CALC2 stack (VSS descriptor ->
ring DB -> retrieval -> geometric verification -> temporal consistency).
When a loop is declared, the matched frame's stored pose is fused as a
6-DoF constraint (filter/loop_fusion.py). Unlike
``models/loop_runner.make_frame_fn``, which applies the masked
constraint every frame, this harness applies it only on a declared frame
(a host-side test, as in the JAX example).

Front-ends (--frontend): ``sim`` (engine.step on noisy ground-truth
observations; CALC2 sees a ground-truth render) and ``pixels``
(frontend.step_image on rendered, noisy frames; CALC2 sees the camera
frame). Trajectories (--traj): ``outback`` (out and back) and ``pan``
(a 450° yaw over a surround scene: the last fifth revisits the first
views). Per seed it reports the Umeyama-aligned ATE and the final
position error with fusion off and on.

``--sim-threshold 0`` calibrates the retrieval gate per run from the
best similarities seen during a window after warm-up (``AutoThreshold``).
As in the JAX example, when that window samples no finite similarity the
gate is never set: the run goes on at threshold 0 with declarations
unmasked. The port keeps that behaviour (a known defect of the
reference, not corrected here).

The VSS is the JAX example's network: Flax's initial weights from key 2
at the --vss-width / --vss-hw given, drawn without JAX by
models/flax_init.py. The filter's and the retrieval's
randomness comes from torch generators seeded as the JAX example seeds
its keys (observations 1000 + seed, RANSAC 100 + seed, image noise
7000 + seed, retrieval 200 + t), so a run matches the JAX one in
distribution, not draw for draw. Runs on the card unless --cpu. Not
ported: --ckpt (orbax checkpoints) and --lc-severity (the training
side's ``augment.seasonal_change``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from ekf_slam_tpu_torch.config import EngineConfig, MapConfig, SimConfig
from ekf_slam_tpu_torch.filter import engine, loop_fusion, motion
from ekf_slam_tpu_torch.filter.state import init_state
from ekf_slam_tpu_torch.models import keypoints as kp_mod
from ekf_slam_tpu_torch.models import loopclosure as lc
from ekf_slam_tpu_torch.models.flax_init import flax_variables
from ekf_slam_tpu_torch.models.vss import VSS, VSSConfig, from_flax
from ekf_slam_tpu_torch.ops import device as devices
from ekf_slam_tpu_torch.ops.quaternion import q2r
from ekf_slam_tpu_torch.sim import scene as sim_scene
from ekf_slam_tpu_torch.utils import trajectory as traj_mod
from ekf_slam_tpu_torch.utils.checkpoint import dump_trajectory
from ekf_slam_tpu_torch.vision import frontend


def harness_config() -> EngineConfig:
    """The example's filter: CAP 48, 64 landmarks at depth 2-6."""
    return EngineConfig(
        map=MapConfig(capacity=48, min_features_in_image=16,
                      max_new_per_step=16),
        sim=SimConfig(num_landmarks=64, depth_min=2.0, depth_max=6.0,
                      pixel_noise_std=1.5))


def _camera_start(cfg: EngineConfig) -> torch.Tensor:
    x = torch.zeros(13, dtype=cfg.torch_dtype)
    x[3] = 1.0
    return x


def outback_trajectory(cfg: EngineConfig, frames: int) -> torch.Tensor:
    """Out-and-back constant-speed trajectory (T, 13): drift accumulates on
    the way out, the way back revisits the outbound viewpoints."""
    half = frames // 2
    x = _camera_start(cfg)
    v_out = torch.tensor([0.004, 0.0, 0.006], dtype=x.dtype)
    xs = []
    for t in range(frames):
        x = x.clone()
        x[7:10] = v_out if t < half else -v_out
        x = motion.fv(x, cfg.filter)
        xs.append(x)
    return torch.stack(xs)


def pan_trajectory(cfg: EngineConfig, frames: int,
                   total_deg: float = 450.0) -> torch.Tensor:
    """Constant-rate yaw of `total_deg` about the camera y axis (T, 13):
    450° is a full turn and a quarter, so the last ~20% of frames re-see
    the first quarter's views with a turn of drift between them."""
    x = _camera_start(cfg)
    x[11] = math.radians(total_deg) / frames
    xs = []
    for _ in range(frames):
        x = motion.fv(x, cfg.filter)
        xs.append(x)
    return torch.stack(xs)


def make_surround_scene(gen: torch.Generator, cfg: EngineConfig,
                        n_anchors: int = 12) -> sim_scene.Scene:
    """Landmarks covering a full yaw turn: the frustum sampler run from
    `n_anchors` yaw anchors, each batch rotated into place."""
    parts = []
    for i in range(n_anchors):
        theta = 2.0 * math.pi * i / n_anchors
        q = torch.tensor([math.cos(theta / 2), 0.0, math.sin(theta / 2),
                          0.0], dtype=cfg.torch_dtype)
        parts.append(sim_scene.make_scene(gen, cfg).landmarks
                     @ q2r(q).T)
    return sim_scene.Scene(landmarks=torch.cat(parts, dim=0))


def build_lc_stack(args, T: int):
    """The CALC2 model and LoopConfig. The VSS's weights are the JAX
    example's: Flax's initial draw from key 2 at the VSS input size
    (models/flax_init.py). Untrained descriptors are still deterministic
    functions of the image, so revisits retrieve."""
    if args.ckpt:
        raise ValueError("--ckpt (an orbax checkpoint of the JAX trainer) "
                         "is not ported")
    vcfg, hw = VSSConfig(width=args.vss_width), tuple(args.vss_hw)
    model = VSS(vcfg, hw)
    model.load_state_dict(from_flax(flax_variables(vcfg, hw, 2)))
    lcfg = lc.LoopConfig(capacity=max(256, T), top_k=3,
                         exclude_recent=T // 4, min_db=T // 4,
                         sim_threshold=args.sim_threshold,
                         min_inliers=args.min_inliers,
                         ransac_hypotheses=16, consistency_count=3,
                         consistency_window=3)
    return model, lcfg


def to_vss(img: torch.Tensor, hw) -> torch.Tensor:
    """(H, W) grayscale -> (1, h, w, 3): antialiased bilinear resize (what
    jax.image.resize "linear" does when it shrinks), gray to RGB."""
    g = F.interpolate(img[None, None], size=tuple(hw), mode="bilinear",
                      align_corners=False, antialias=True)[0, 0]
    return g[None, :, :, None].expand(1, *g.shape, 3)


class AutoThreshold:
    """--sim-threshold 0: the gate calibrated per run. Right after warm-up
    (db.count ≥ min_db) and before a genuine revisit can occur
    (db.count < calib_end = min_db + max(min_db // 2, 8)), every query's
    best similarity is an impostor; once the window closes the gate is set
    halfway from the largest of them to 1, and declarations stay masked
    until then. If the window sampled no finite similarity, the gate is
    never set and the run goes on at threshold 0, unmasked — the JAX
    example's behaviour, kept."""

    def __init__(self, lcfg: lc.LoopConfig, tag: str = ""):
        self.tag = tag
        self.base = lcfg
        self.lcfg = lcfg
        self.imp_max = -1.0
        self.calib_end = lcfg.min_db + max(lcfg.min_db // 2, 8)

    def config(self, n_db: int) -> lc.LoopConfig:
        """The LoopConfig of the query at DB size n_db."""
        if (n_db >= self.calib_end and self.imp_max > -1.0
                and self.lcfg.sim_threshold == self.base.sim_threshold):
            thr = self.imp_max + (1.0 - self.imp_max) * 0.5
            self.lcfg = dataclasses.replace(self.base, sim_threshold=thr)
            print(f"  {self.tag}: auto sim_threshold {thr:.5f} (impostor max "
                  f"{self.imp_max:.5f})", flush=True)
        return self.lcfg

    def observe(self, n_db: int, best_sim: float) -> bool:
        """Record a query's best similarity; whether declarations are
        allowed at DB size n_db."""
        warm = n_db >= self.base.min_db
        if warm and n_db < self.calib_end and np.isfinite(best_sim):
            self.imp_max = max(self.imp_max, best_sim)
        return warm and n_db >= self.calib_end


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--frontend", choices=["sim", "pixels"], default="sim")
    ap.add_argument("--traj", choices=["outback", "pan"], default="outback")
    ap.add_argument("--ensemble", type=int, default=1)
    ap.add_argument("--img-noise", type=float, default=0.02,
                    help="per-frame Gaussian pixel noise (pixels frontend)")
    ap.add_argument("--vss-width", type=int, default=8)
    ap.add_argument("--vss-hw", type=int, nargs=2, default=(48, 64))
    ap.add_argument("--ckpt", default="",
                    help="an orbax checkpoint: not ported (raises)")
    ap.add_argument("--min-inliers", type=int, default=10,
                    help="geometric-verification inlier gate; the keypoint "
                         "budget grows with the input resolution")
    ap.add_argument("--sim-threshold", type=float, default=0.9,
                    help="retrieval cosine gate; 0 = calibrate per run "
                         "(AutoThreshold)")
    ap.add_argument("--lc-severity", type=float, default=0.0,
                    help="cross-season corruption of the retrieval input: "
                         "not ported (raises unless 0)")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "loop_demo"))
    ap.add_argument("--json", default="")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (plain versions, no kernels)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the experiment; returns the JSON summary."""
    args = parse_args(argv)
    if args.lc_severity > 0.0:
        raise ValueError("--lc-severity (augment.seasonal_change, the "
                         "training side) is not ported")
    # The cosine gate and the DB's top-k must see true-f32 descriptors.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = devices.resolve("cpu" if args.cpu else None)
    os.makedirs(args.out, exist_ok=True)
    cfg = harness_config()
    T = args.frames

    if args.traj == "pan":
        scn_cpu = make_surround_scene(torch.Generator().manual_seed(0), cfg)
        xs = pan_trajectory(cfg, T)
    else:
        scn_cpu = sim_scene.make_scene(torch.Generator().manual_seed(0), cfg)
        xs = outback_trajectory(cfg, T)
    scn = sim_scene.Scene(scn_cpu.landmarks.to(dev))
    xs_dev = xs.to(dev)

    model, lcfg = build_lc_stack(args, T)
    model = model.to(dev)
    vss_hw = tuple(args.vss_hw)

    @torch.no_grad()
    def embed(img):
        outs = model(to_vss(img, vss_hw), descriptor_only=True)
        return outs["descriptor"], kp_mod.kp_descriptor(outs["c5"])

    def render(t):
        return frontend.render_scene_image(scn, xs_dev[t], cfg, dev)

    if args.frontend == "pixels":
        imgs = torch.stack([render(t) for t in range(T)])
    nhyp = cfg.ransac.num_hypotheses

    def run(seed: int, with_lc: bool):
        """One tracked sequence: (traj (T, 13), loops, lc seconds)."""
        db = None
        loops, traj = [], []
        lc_time = 0.0
        auto = (AutoThreshold(lcfg, f"seed {seed}")
                if args.sim_threshold == 0.0 else None)
        g_u = torch.Generator().manual_seed(100 + seed)
        if args.frontend == "sim":
            g_obs = torch.Generator().manual_seed(1000 + seed)
            frames = [sim_scene.observe(g_obs, scn_cpu, xs[t], cfg)
                      for t in range(T)]
            obs = sim_scene.FrameObs(
                torch.stack([o.pixels for o in frames]),
                torch.stack([o.visible for o in frames])).to(dev)
            st = engine.bootstrap(init_state(cfg, 1, dev), obs.frame(0), cfg)
        else:
            g_noise = torch.Generator().manual_seed(7000 + seed)
            st = init_state(cfg, 1, dev)
            app = frontend.init_appearance(cfg, 1, dev)
        for t in range(T):
            u = torch.rand(1, nhyp, generator=g_u,
                           dtype=cfg.torch_dtype).to(dev)
            if args.frontend == "sim":
                st, _ = engine.step(st, obs.frame(t), u, cfg)
                img_t = None
            else:
                img_t = imgs[t]
                if args.img_noise > 0:
                    noise = torch.randn(img_t.shape, generator=g_noise,
                                        dtype=img_t.dtype).to(dev)
                    img_t = torch.clamp(img_t + args.img_noise * noise,
                                        0.0, 1.0)
                st, app, _ = frontend.step_image(st, app, img_t, u, cfg)
            if with_lc:
                t0 = time.time()
                # CALC2's input: the camera frame in pixels mode, a
                # ground-truth render in sim mode (no pixels exist there).
                descr, kps = embed(img_t if img_t is not None
                                   else render(t))
                if db is None:
                    db = lc.init_db(lcfg, 1, descr.shape[1],
                                    kps.yx.shape[1], kps.descr.shape[2],
                                    device=dev)
                pose = torch.cat([st.x[:, 0:3], st.x[:, 3:7]], dim=1)
                n_db = int(db.count[0])
                lcfg_run = auto.config(n_db) if auto else lcfg
                res = lc.query(db, descr, kps, lcfg_run,
                               generator=torch.Generator().manual_seed(
                                   200 + t))
                warm = (auto.observe(n_db, float(res.similarities[0, 0]))
                        if auto else n_db >= lcfg.min_db)
                res = res._replace(is_hypothesis=res.is_hypothesis & warm)
                db, declared, match_slot, match_frame = lc.step_temporal(
                    db, res, lcfg_run)
                if bool(declared[0]):
                    # The 6-DoF constraint against the matched frame's
                    # stored pose, noise scaled by verification quality.
                    pose_j = db.pose[:, int(match_slot[0])]
                    sp, sr = loop_fusion.loop_noise_sigmas(res.best_inliers)
                    x_new, P_new = loop_fusion.apply_loop_constraint_pose(
                        st.x, st.P, pose_j, sp, sr, True)
                    st = st.replace(x=x_new, P=P_new)
                    loops.append((t, int(match_frame[0])))
                db = lc.push(db, descr, kps, pose)
                lc_time += time.time() - t0
            traj.append(st.x[0, :13])
        return torch.stack(traj).cpu().double().numpy(), loops, lc_time

    xs_np = xs.double().numpy()
    gt = torch.from_numpy(xs_np[:, 0:3])
    rows = []
    for seed in range(args.ensemble):
        t0 = time.time()
        traj_off, _, _ = run(seed, with_lc=False)
        traj_on, loops, lc_s = run(seed, with_lc=True)
        ate_off = float(traj_mod.ate_rmse(
            torch.from_numpy(traj_off[:, 0:3]), gt))
        ate_on = float(traj_mod.ate_rmse(torch.from_numpy(traj_on[:, 0:3]),
                                         gt))
        fin_off = float(np.linalg.norm(traj_off[-1, 0:3] - xs_np[-1, 0:3]))
        fin_on = float(np.linalg.norm(traj_on[-1, 0:3] - xs_np[-1, 0:3]))
        rows.append({"seed": seed, "ate_off": ate_off, "ate_on": ate_on,
                     "final_off": fin_off, "final_on": fin_on,
                     "loops": loops, "n_loops": len(loops),
                     "wall_s": round(time.time() - t0, 1),
                     "lc_s": round(lc_s, 1)})
        print(f"seed {seed}: ATE off {ate_off:.4f} -> on {ate_on:.4f} "
              f"| final err off {fin_off:.4f} -> on {fin_on:.4f} "
              f"| {len(loops)} loops {loops[:6]}"
              f"{'...' if len(loops) > 6 else ''} "
              f"({rows[-1]['wall_s']}s)", flush=True)
        if seed == 0:
            dump_trajectory(os.path.join(args.out, "trajectory.npz"),
                            traj_on, truth=xs_np)
            dump_trajectory(os.path.join(args.out, "trajectory_nolc.npz"),
                            traj_off, truth=xs_np)

    summary = {
        "frontend": args.frontend, "traj": args.traj, "frames": T,
        "ensemble": args.ensemble, "ckpt": args.ckpt,
        "vss_width": args.vss_width, "img_noise": args.img_noise,
        "lc_severity": args.lc_severity,
        "sim_threshold": args.sim_threshold,
        "ate_off_p50": float(np.median([r["ate_off"] for r in rows])),
        "ate_on_p50": float(np.median([r["ate_on"] for r in rows])),
        "final_off_p50": float(np.median([r["final_off"] for r in rows])),
        "final_on_p50": float(np.median([r["final_on"] for r in rows])),
        "n_loops_total": int(sum(r["n_loops"] for r in rows)),
        "rows": rows,
    }
    print(f"ATE p50: {summary['ate_off_p50']:.4f} without fusion -> "
          f"{summary['ate_on_p50']:.4f} with fusion "
          f"({summary['n_loops_total']} loops over {args.ensemble} seeds)")
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=1)
        print(f"wrote {args.json}")
    print(f"outputs in {args.out}")
    return summary


if __name__ == "__main__":
    main()
