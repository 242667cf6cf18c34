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
models/flax_init.py, or with --ckpt a checkpoint of the port's trainer
(models/train.save_checkpoint, e.g. train_calc2's ckpt_final; the JAX
trainer's orbax checkpoints cannot be read). --lc-severity corrupts each
CALC2 input frame by ``augment.seasonal_change`` with draws of its own
(a generator seeded 9000 + seed, drawn frame after frame on the CPU); the
filter's input stays clean. The filter's and the retrieval's
randomness comes from torch generators seeded as the JAX example seeds
its keys (observations 1000 + seed, RANSAC 100 + seed, image noise
7000 + seed, retrieval 200 + t), so a run matches the JAX one in
distribution, not draw for draw. Runs on the card unless --cpu; prints
the card's kernel launches (ops/kernels.LAUNCHES) and frames/s. On the
card a frame is up to three replays of pieces captured as CUDA graphs
(``run``; the JAX example jits step_sim / step_pix, render, corrupt,
to_vss and embed), with the example's host reads between them;
``main(argv, eager=True)`` runs the pieces eagerly (no flag: the JAX
example has none).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import tempfile
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ekf_slam_tpu_torch.config import EngineConfig, MapConfig, SimConfig
from ekf_slam_tpu_torch.filter import engine, graph, loop_fusion, motion
from ekf_slam_tpu_torch.filter.state import FIELDS, init_state
from ekf_slam_tpu_torch.models import augment, train
from ekf_slam_tpu_torch.models import keypoints as kp_mod
from ekf_slam_tpu_torch.models import loop_runner
from ekf_slam_tpu_torch.models import loopclosure as lc
from ekf_slam_tpu_torch.models.flax_init import flax_variables
from ekf_slam_tpu_torch.models.vss import VSS, VSSConfig, from_flax
from ekf_slam_tpu_torch.ops import device as devices
from ekf_slam_tpu_torch.ops import kernels
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
    example's, Flax's initial draw from key 2 at the VSS input size
    (models/flax_init.py; untrained descriptors are still deterministic
    functions of the image, so revisits retrieve), or --ckpt's."""
    vcfg, hw = VSSConfig(width=args.vss_width), tuple(args.vss_hw)
    model = load_vss(vcfg, hw, args.ckpt)
    lcfg = lc.LoopConfig(capacity=max(256, T), top_k=3,
                         exclude_recent=T // 4, min_db=T // 4,
                         sim_threshold=args.sim_threshold,
                         min_inliers=args.min_inliers,
                         ransac_hypotheses=16, consistency_count=3,
                         consistency_window=3)
    return model, lcfg


def check_ckpt(path: str) -> None:
    """Raise unless `path` is a file, as the port's trainer writes them:
    the JAX trainer's orbax checkpoints are directories and cannot be
    read."""
    if os.path.isdir(path):
        raise ValueError(f"--ckpt {path} is a directory, as the JAX "
                         f"trainer's orbax checkpoints are: reading them is "
                         f"not ported (models/train.save_checkpoint writes "
                         f"the port's)")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"--ckpt {path}: no such file")


def load_vss(vcfg: VSSConfig, hw, ckpt: str = "") -> VSS:
    """The VSS in eval mode: the weights of `ckpt`, a checkpoint of the
    port's trainer (models/train.save_checkpoint), or Flax's initial draw
    from key 2. Raises if the checkpoint's shapes are not vcfg's at hw."""
    model = VSS(vcfg, hw)
    if ckpt:
        check_ckpt(ckpt)
        state = train.init_state(model, train.TrainConfig(image_hw=hw))
        train.restore_checkpoint(ckpt, state)
    else:
        model.load_state_dict(from_flax(flax_variables(vcfg, hw, 2)))
    return model.eval()


def corrupt_draws(shape, dtype, severity: float,
                  generator: torch.Generator, device) -> augment.SeasonalDraws:
    """corrupt's draws for a grey frame of `shape` (H, W): from
    `generator` on the CPU (the same on every device), moved to
    `device`."""
    d = augment.seasonal_draws(torch.empty((1, *shape, 1), dtype=dtype),
                               severity, generator=generator)
    return augment.SeasonalDraws(*(f.to(device) for f in d))


def corrupt(img: torch.Tensor, severity: float,
            generator: Optional[torch.Generator] = None,
            draws: Optional[augment.SeasonalDraws] = None) -> torch.Tensor:
    """augment.seasonal_change of a grey frame (H, W) with `draws`, or
    with corrupt_draws' from `generator`."""
    if draws is None:
        draws = corrupt_draws(img.shape, img.dtype, severity, generator,
                              img.device)
    return augment.seasonal_change(img[None, :, :, None], severity,
                                   draws=draws)[0, :, :, 0]


def to_vss(img: torch.Tensor, hw) -> torch.Tensor:
    """(H, W) grayscale -> (1, h, w, 3): antialiased bilinear resize (what
    jax.image.resize "linear" does when it shrinks), gray to RGB."""
    g = F.interpolate(img[None, None], size=tuple(hw), mode="bilinear",
                      align_corners=False, antialias=True)[0, 0]
    return g[None, :, :, None].expand(1, *g.shape, 3)


@torch.no_grad()
def embed_frame(carry, inputs, model: VSS, hw, severity: float = 0.0,
                scene: Optional[sim_scene.Scene] = None,
                cfg: Optional[EngineConfig] = None):
    """The embed piece as graph.py's frame function (the JAX example's
    jitted render, corrupt, to_vss and embed): no carry; inputs the frame
    (H, W), or with a `scene` the camera state (13,) the frame is rendered
    from, then at severity > 0 corrupt's five draws. Outputs the VSS's
    descriptor (1, Dd) and its Keypoints' fields (1, K, ...)."""
    src, *draws = inputs
    if scene is not None:
        src = frontend.render_scene_image(scene, src, cfg, src.device)
    if severity > 0.0:
        src = corrupt(src, severity, draws=augment.SeasonalDraws(*draws))
    outs = model(to_vss(src, hw), descriptor_only=True)
    return (), (outs["descriptor"], *kp_mod.kp_descriptor(outs["c5"]))


def query_frame(carry, inputs, lcfg: lc.LoopConfig):
    """The query piece as graph.py's frame function (models/loop_runner's
    frame without the network and the fusion): carry the database's
    fields; inputs the frame's descriptor (1, Dd), its Keypoints' fields,
    its pose (1, 7), RANSAC's draws, `warm` (1,) bool (hypotheses masked
    where False) and the retrieval gate sim_threshold as a 0-d tensor.
    lc.query, lc.step_temporal, then lc.push. Outputs the QueryResult's
    fields, then declared, the matched slot and frame, and the matched
    slot's stored pose (1, 7), gathered before the push."""
    descr, yx, response, orientation, kdescr, pose, draws, warm, thr = inputs
    kps = kp_mod.Keypoints(yx, response, orientation, kdescr)
    cfg = dataclasses.replace(lcfg, sim_threshold=thr)
    db = lc.LoopDatabase(*carry)
    res = lc.query(db, descr, kps, cfg, draws)
    res = res._replace(is_hypothesis=res.is_hypothesis & warm)
    db, declared, slot, frame = lc.step_temporal(db, res, cfg)
    pose_j = torch.gather(db.pose, 1, slot[:, None, None].expand(-1, 1, 7))
    db = lc.push(db, descr, kps, pose)
    return (tuple(getattr(db, f) for f in lc.DB_FIELDS),
            (*res, declared, slot, frame, pose_j[:, 0]))


class Query:
    """A run's query piece (query_frame) at B = 1, built at its first
    step over an empty database whose ring the piece writes in place (so,
    replayed, it is captured for the run). `capture` as graph.piece takes
    it; the gate and `warm` go in as tensors."""

    def __init__(self, lcfg: lc.LoopConfig, device, capture):
        self.lcfg, self.device, self.capture = lcfg, device, capture
        self.piece = None
        self.warm = {w: torch.tensor([w], device=device)
                     for w in (False, True)}
        self.gate = (None, None)

    def step(self, descr, kp, pose, draws, warm: bool, threshold: float):
        """One frame: (QueryResult, declared, slot, frame, pose_j), the
        piece's outputs (a replayed piece's next step overwrites them)."""
        if self.gate[0] != threshold:
            self.gate = (threshold, torch.tensor(    # lc.init_db's dtype
                threshold, dtype=torch.float32, device=self.device))
        inputs = (descr, *kp, pose, draws, self.warm[warm], self.gate[1])
        if self.piece is None:
            db = lc.init_db(self.lcfg, 1, descr.shape[1], kp[0].shape[1],
                            kp[3].shape[2], device=self.device)
            self.piece = graph.piece(
                functools.partial(query_frame, lcfg=self.lcfg),
                tuple(getattr(db, f) for f in lc.DB_FIELDS), inputs, None,
                self.capture, [lc.DB_FIELDS.index(f)
                               for f in loop_runner.RING])
        out = self.piece.step(inputs)
        return (lc.QueryResult(*out[:6]), *out[6:])


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

    def samples(self, n_db: int) -> bool:
        """Whether the query at DB size n_db is in the calibration window
        (its best similarity is then read back and observed)."""
        return self.base.min_db <= n_db < self.calib_end

    def allows(self, n_db: int) -> bool:
        """Whether declarations are allowed at DB size n_db."""
        return n_db >= self.base.min_db and n_db >= self.calib_end

    def observe(self, n_db: int, best_sim: float) -> bool:
        """Record a query's best similarity; whether declarations are
        allowed at DB size n_db."""
        if self.samples(n_db) and np.isfinite(best_sim):
            self.imp_max = max(self.imp_max, best_sim)
        return self.allows(n_db)


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
                    help="a checkpoint of the port's trainer (train_calc2's "
                         "ckpt_final) at --vss-width / --vss-hw; the JAX "
                         "trainer's orbax checkpoints cannot be read")
    ap.add_argument("--min-inliers", type=int, default=10,
                    help="geometric-verification inlier gate; the keypoint "
                         "budget grows with the input resolution")
    ap.add_argument("--sim-threshold", type=float, default=0.9,
                    help="retrieval cosine gate; 0 = calibrate per run "
                         "(AutoThreshold)")
    ap.add_argument("--lc-severity", type=float, default=0.0,
                    help="augment.seasonal_change severity applied to "
                         "the CALC2 input of every frame with its own "
                         "draws; the filter's input stays clean")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "loop_demo"))
    ap.add_argument("--json", default="")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (plain versions, no kernels)")
    return ap.parse_args(argv)


@dataclasses.dataclass
class Harness:
    """What every run of one `main` shares: the arguments, the filter's
    config, the device, the scene (on the CPU, as observe samples it, and
    on the device), the ground truth xs (T, 13), the pixels front-end's
    clean frames (T, H, W), the VSS and LoopConfig, and the embed piece of
    each route (built at its first frame, kept for the runs after)."""
    args: argparse.Namespace
    cfg: EngineConfig
    dev: torch.device
    scn_cpu: sim_scene.Scene
    scn: sim_scene.Scene
    xs: torch.Tensor
    imgs: Optional[torch.Tensor]
    model: VSS
    lcfg: lc.LoopConfig
    embeds: dict = dataclasses.field(default_factory=dict)

    def embed(self, inputs, capture):
        """The embed piece of route `capture` (graph.piece's), ready."""
        if capture not in self.embeds:
            sim = self.args.frontend == "sim"
            self.embeds[capture] = graph.piece(functools.partial(
                embed_frame, model=self.model, hw=tuple(self.args.vss_hw),
                severity=self.args.lc_severity,
                scene=self.scn if sim else None, cfg=self.cfg), (), inputs,
                None, capture)
        return self.embeds[capture]


def build_harness(args, dev) -> Harness:
    """The harness of parsed arguments on `dev`: the scene and trajectory
    (--traj), the pixels front-end's frames rendered up front (as the JAX
    example renders them), the VSS and LoopConfig."""
    cfg = harness_config()
    T = args.frames
    if args.traj == "pan":
        scn_cpu = make_surround_scene(torch.Generator().manual_seed(0), cfg)
        xs = pan_trajectory(cfg, T)
    else:
        scn_cpu = sim_scene.make_scene(torch.Generator().manual_seed(0), cfg)
        xs = outback_trajectory(cfg, T)
    scn = sim_scene.Scene(scn_cpu.landmarks.to(dev))
    imgs = None
    if args.frontend == "pixels":
        xs_dev = xs.to(dev)
        imgs = torch.stack([frontend.render_scene_image(scn, xs_dev[t], cfg,
                                                        dev)
                            for t in range(T)])
    model, lcfg = build_lc_stack(args, T)
    return Harness(args, cfg, dev, scn_cpu, scn, xs, imgs, model.to(dev),
                   lcfg)


def run(h: Harness, seed: int, with_lc: bool, capture=None):
    """One tracked sequence of `seed`: (trajectory (T, 13) f64, loops
    [(i, j)], seconds of the loop-closure work). A frame runs up to three
    pieces (graph.piece), with the JAX example's host code between them:
    the filter's frame (engine._sim_frame or frontend._image_frame, kept
    under run_sequence's / run_images' key), the embed piece (embed_frame)
    and the query piece (Query); on a declared frame the pose constraint
    is fused eagerly and loaded back into the filter's carry. capture=None
    runs each piece eagerly, True replays each from a CUDA graph, False
    runs them over static buffers without a graph (how the CPU tests see
    what replay runs)."""
    args, cfg, dev, lcfg = h.args, h.cfg, h.dev, h.lcfg
    T, nhyp = h.xs.shape[0], cfg.ransac.num_hypotheses
    shape = (cfg.camera.n_rows, cfg.camera.n_cols)
    auto = (AutoThreshold(lcfg, f"seed {seed}")
            if args.sim_threshold == 0.0 else None)
    g_u = torch.Generator().manual_seed(100 + seed)
    if args.frontend == "sim":
        g_obs = torch.Generator().manual_seed(1000 + seed)
        frames = [sim_scene.observe(g_obs, h.scn_cpu, h.xs[t], cfg)
                  for t in range(T)]
        obs = sim_scene.FrameObs(
            torch.stack([o.pixels for o in frames]),
            torch.stack([o.visible for o in frames])).to(dev)
        st = engine.bootstrap(init_state(cfg, 1, dev), obs.frame(0), cfg)
        carry = tuple(getattr(st, f) for f in FIELDS)
        fn, key = (functools.partial(engine._sim_frame, cfg=cfg),
                   ("sim", cfg, engine.route(cfg, dev)))
        xs_dev = h.xs.to(dev)
    else:
        g_noise = torch.Generator().manual_seed(7000 + seed)
        st = init_state(cfg, 1, dev)
        app = frontend.init_appearance(cfg, 1, dev)
        carry = (*(getattr(st, f) for f in FIELDS),
                 *(getattr(app, f) for f in frontend.APPEARANCE_FIELDS))
        fn, key = (functools.partial(frontend._image_frame, cfg=cfg),
                   ("image", cfg, engine.route(cfg, dev, fused=False)))
    g_sev = torch.Generator().manual_seed(9000 + seed)
    filt, query = None, Query(lcfg, dev, capture)
    loops, traj = [], []
    lc_time = 0.0
    for t in range(T):
        u = torch.rand(1, nhyp, generator=g_u,
                       dtype=cfg.torch_dtype).to(dev)
        if args.frontend == "sim":
            inputs = (obs.pixels[t], obs.visible[t], u)
            # CALC2 sees a ground-truth render (no pixels exist here)
            src = xs_dev[t]
        else:
            src = h.imgs[t]
            if args.img_noise > 0:
                noise = torch.randn(src.shape, generator=g_noise,
                                    dtype=src.dtype).to(dev)
                src = torch.clamp(src + args.img_noise * noise, 0.0, 1.0)
            inputs = (src, u)
        if filt is None:
            filt = graph.piece(fn, carry, inputs, key, capture)
        filt.step(inputs)
        if with_lc:
            t0 = time.time()
            x, P = filt.carry[0], filt.carry[1]
            inputs = (src,)
            if args.lc_severity > 0.0:
                inputs += tuple(corrupt_draws(shape, cfg.torch_dtype,
                                              args.lc_severity, g_sev, dev))
            descr, *kp = h.embed(inputs, capture).step(inputs)
            n_db = t                # one push a frame
            lcfg_run = auto.config(n_db) if auto else lcfg
            res, declared, _, match_frame, pose_j = query.step(
                descr, kp, torch.cat([x[:, 0:3], x[:, 3:7]], dim=1),
                lc.ransac_draws(lcfg, 1, h.model.num_kp,
                                torch.Generator().manual_seed(200 + t),
                                kp[0].dtype, dev),
                auto.allows(n_db) if auto else n_db >= lcfg.min_db,
                lcfg_run.sim_threshold)
            if auto and auto.samples(n_db):
                auto.observe(n_db, float(res.similarities[0, 0]))
            if bool(declared[0]):
                # The 6-DoF constraint against the matched frame's
                # stored pose, noise scaled by verification quality.
                sp, sr = loop_fusion.loop_noise_sigmas(res.best_inliers)
                x_new, P_new = loop_fusion.apply_loop_constraint_pose(
                    x, P, pose_j, sp, sr, True)
                filt.load((x_new, P_new, *filt.carry[2:]))
                loops.append((t, int(match_frame[0])))
            lc_time += time.time() - t0
        traj.append(filt.carry[0][0, :13].clone())
    return torch.stack(traj).cpu().double().numpy(), loops, lc_time


def main(argv=None, eager: bool | None = None) -> dict:
    """Run the experiment; returns the JSON summary. On a CUDA device
    every piece of a frame replays from a captured CUDA graph (run);
    eager=True runs them eagerly, and eager=False without a card
    raises."""
    args = parse_args(argv)
    if args.ckpt:
        check_ckpt(args.ckpt)
    # The cosine gate and the DB's top-k must see true-f32 descriptors.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = devices.resolve("cpu" if args.cpu else None)
    capture = True if graph.replays(dev, eager) else None
    os.makedirs(args.out, exist_ok=True)
    h = build_harness(args, dev)
    T = args.frames

    xs_np = h.xs.double().numpy()
    gt = torch.from_numpy(xs_np[:, 0:3])
    rows = []
    launches0 = dict(kernels.LAUNCHES)
    t_run = time.perf_counter()
    for seed in range(args.ensemble):
        t0 = time.time()
        traj_off, _, _ = run(h, seed, False, capture)
        traj_on, loops, lc_s = run(h, seed, True, capture)
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

    seconds = time.perf_counter() - t_run
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
    launches = {k: v - launches0[k] for k, v in kernels.LAUNCHES.items()
                if v > launches0[k]}
    print(f"ATE p50: {summary['ate_off_p50']:.4f} without fusion -> "
          f"{summary['ate_on_p50']:.4f} with fusion "
          f"({summary['n_loops_total']} loops over {args.ensemble} seeds)")
    # both runs of every seed, fusion off and on
    print(f"{2 * args.ensemble} runs of {T} frames in {seconds:.2f} s -> "
          f"{2 * T * args.ensemble / seconds:.2f} frames/s")
    print(f"kernel launches {json.dumps(launches)}")
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=1)
        print(f"wrote {args.json}")
    print(f"outputs in {args.out}")
    return summary


if __name__ == "__main__":
    main()
