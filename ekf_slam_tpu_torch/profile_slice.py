"""Time and profile the port's slice on one CUDA card.

    python -m ekf_slam_tpu_torch.profile_slice \
        [fused|unfused|unfused_pallas|fast|fast_rows|image|image_exact|
         image_none|image_descriptor]

A sim path is the bench workload at full width (see ``slice_config``),
B = 128 instances, 16 frames, through one of the engine's paths (default
``fused``). With the f32 parity settings (max_update_obs 64):

  fused           step_fused: K1, K2, K3
  unfused         step_core: K6 for the products on P, K4 for the tails
  unfused_pallas  step_core with pallas_update="on": K6, and K5 for the
                  tails
  iekf            step_core with the iterated LI update (3 iterations):
                  K6 for RANSAC's P·G and each P·Hᵀ (6 a frame), K4 for
                  the tails

and in bench.py's production fast mode (P stored in bf16,
max_update_obs 24):

  fast            step_core, column form: K6 and K4 on the bf16 P
  fast_rows       step_core, row form (EKF_UPDATE=rows, EKF_TAIL_SYM=expr):
                  K8 for the tails, no K6

The image path is the JAX pixels bench's workload with the NCC matcher
(see ``image_config``), B = 32 instances, 16 rendered 240x320 frames,
through vision/frontend.run_images: K7's norms form for the NCC
numerator and patch norms, K6 and K4 as on the unfused path.
``image_exact`` and ``image_none`` warp the templates with the per-pixel
distortion round trip and with none (VisionConfig.warp_distortion; the
bench's "affine" in ``image``). ``image_descriptor`` is the same workload
with the binary-descriptor matcher (the JAX default): K6 and K4, no K7.

Two measurements, each of three routes:

  kernels  the eager loop (eager=True) with the hand-written CUDA kernels
           (the wrappers in ops/kernels.py)
  replay   the same kernels, one frame captured as a CUDA graph and
           replayed (filter/graph.py; the drivers' default on the card)
  plain    the eager loop with the wrappers swapped for their plain torch
           versions

A/B       the path's driver over the 16 frames, legs in the order kernels,
          replay, plain, plain, replay, kernels; each leg RUNS timed runs
          (replay's first warm-up run captures the frame). Prints
          every run's seconds and the leg's median steps/s (B·16 / s).
profile   the first PROFILE_FRAMES frames: their wall time
          unprofiled, then under torch.profiler the device time (sum of
          the CUDA kernel events), the device ops (kernels, copies,
          fills), the host time in cudaLaunchKernel, the host's launches a frame (kernel launches,
          cudaGraphLaunch, async copies and sets), the device time and calls of each of the
          port's own kernels (csrc/: k1p_kernel, K1's pass; k3_kernel,
          K2's pass (r = 0) and K3's; k3v_kernel, K1's and K3's prologue;
          k4_kernel … k8_kernel, k4, k6 and k8 by P's type and k6 by
          column blocking, k7 by its template width and form (true: the
          norms); k6_kernel<float, 128> also forms K1's and K2's P·Hᵀ) and the ten ops with the most device time.

The last line is one JSON object with every number printed.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import re
import statistics
import time
from unittest import mock

import torch
from torch.autograd import DeviceType

from ekf_slam_tpu_torch.config import (EngineConfig, FilterConfig, MapConfig,
                                       RansacConfig, SimConfig, VisionConfig)
from ekf_slam_tpu_torch.filter import ekf, engine
from ekf_slam_tpu_torch.filter.state import init_state
from ekf_slam_tpu_torch.ops import kernels
from ekf_slam_tpu_torch.sim import simulate
from ekf_slam_tpu_torch.vision import frontend

BATCH = 128
# image path -> (matcher, warp_distortion) of image_config
IMAGE_PATHS = {"image": ("ncc", "affine"), "image_exact": ("ncc", "exact"),
               "image_none": ("ncc", "none"),
               "image_descriptor": ("descriptor", "affine")}
IMAGE_BATCH = 32     # bench.py's BENCH_PIXB default for the NCC matcher
FRAMES = 16
RUNS = 3
PROFILE_FRAMES = 4


PATHS = {"fused": ("on", "off"), "unfused": ("off", "off"),
         "unfused_pallas": ("off", "on"), "fast": ("off", "off"),
         "fast_rows": ("off", "off"),
         "iekf": ("off", "off")}         # (fused_step, pallas_update)
# The fast mode's paths and their update form (ekf._UPDATE).
FAST_PATHS = {"fast": "cols", "fast_rows": "rows"}
# The fast mode's scene seed (the f32 paths take scene 0). The bf16 P goes
# non-finite on scene 0 in both packages alike (tests/test_torch_bf16.py,
# the scene-0 test); on the CPU, B = 128 (python -m
# ekf_slam_tpu_torch.scene_gates): scene 0 keeps 66 (cols) and 27 (rows)
# of 128 instances finite, scene 1 hits the update cap (33 > 24), scene 2
# passes every gate within 0.023 of the tracking limit, scene 3 with 0.057
# to spare.
FAST_SCENE = 3


def slice_config(path: str = "fused") -> EngineConfig:
    """The bench workload at full width (bench.py:289-317): CAP 100, 128
    landmarks, min_features 25, max_new_per_step 10, NHYP 64, Newton gain;
    the engine path one of PATHS. The f32 parity settings (max_update_obs
    64, f32 P), or on FAST_PATHS bench.py's default production fast mode
    (bench.py:282-306: max_update_obs 24, P stored in bf16); "iekf" is
    the unfused path with the iterated LI update (3 iterations; the HI
    update keeps the Newton gain, the IEKF inverts by Cholesky)."""
    fused_step, pallas_update = PATHS[path]
    fast = path in FAST_PATHS
    return EngineConfig(
        filter=FilterConfig(gain_solver="newton", fused_step=fused_step,
                            pallas_update=pallas_update,
                            p_storage="bf16" if fast else "f32",
                            use_iterated_update=path == "iekf",
                            iekf_iterations=3),
        map=MapConfig(capacity=100, min_features_in_image=25,
                      max_new_per_step=10,
                      max_update_obs=24 if fast else 64),
        ransac=RansacConfig(num_hypotheses=64),
        sim=SimConfig(num_landmarks=128),
        dtype="float32")


@contextlib.contextmanager
def update_form(path: str):
    """The path's update layout for the block: ekf._UPDATE "rows" and
    ekf._TAIL_SYM "expr" on fast_rows, "cols" elsewhere; both restored
    after."""
    old = ekf._UPDATE, ekf._TAIL_SYM
    ekf._UPDATE = FAST_PATHS.get(path, "cols")
    ekf._TAIL_SYM = "expr"
    try:
        yield
    finally:
        ekf._UPDATE, ekf._TAIL_SYM = old


def slice_inputs(cfg: EngineConfig, dev, batch: int = BATCH,
                 frames: int = FRAMES, scene: int = 0):
    """(bootstrapped state, true states (T,13), observations, RANSAC draws
    (T,B,NHYP)): the scene from seed `scene`, the draws from seed 1."""
    _, xs, obs = simulate(torch.Generator().manual_seed(scene), cfg, frames,
                          dev)
    st0 = engine.bootstrap(init_state(cfg, batch, dev), obs.frame(0), cfg)
    u = torch.rand(frames, batch, cfg.ransac.num_hypotheses, device=dev,
                   dtype=cfg.torch_dtype,
                   generator=torch.Generator(device=dev).manual_seed(1))
    return st0, xs, obs, u


def image_config(matcher: str = "ncc",
                 warp_distortion: str = "affine") -> EngineConfig:
    """The JAX pixels bench's workload (bench.py:107-135): CAP 100, 128
    landmarks, min_features 25, max_new_per_step 10, max_update_obs 64,
    Newton gain, search radius 12, 8 corners a window, the affine warp
    (BENCH_WARPDIST's default; bench.py:133), 240x320 frames, f32."""
    return EngineConfig(
        filter=FilterConfig(gain_solver="newton"),
        map=MapConfig(capacity=100, min_features_in_image=25,
                      max_new_per_step=10, max_update_obs=64),
        vision=VisionConfig(matcher=matcher, search_radius=12,
                            corners_per_window=8,
                            warp_distortion=warp_distortion),
        sim=SimConfig(num_landmarks=128),
        dtype="float32")


def image_inputs(cfg: EngineConfig, dev, batch: int = IMAGE_BATCH,
                 frames: int = FRAMES):
    """(empty states, empty appearance stores, true states (T,13), frames
    (T,H,W) rendered on `dev`, RANSAC draws (T,B,NHYP)): the scene from
    seed 0, the draws from seed 1. No bootstrap: frame 0 initializes from
    FAST, as bench.py's pixels mode does."""
    scn, xs, _ = simulate(torch.Generator().manual_seed(0), cfg, frames, dev)
    imgs = torch.stack([frontend.render_scene_image(scn, xs[t], cfg, dev)
                        for t in range(frames)])
    u = torch.rand(frames, batch, cfg.ransac.num_hypotheses, device=dev,
                   dtype=cfg.torch_dtype,
                   generator=torch.Generator(device=dev).manual_seed(1))
    return (init_state(cfg, batch, dev),
            frontend.init_appearance(cfg, batch, dev), xs, imgs, u)


def timed(fn) -> float:
    """Seconds of fn() by the host clock, the card idle before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


ROUTES = ("kernels", "replay", "plain")
HOST_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                 "cudaMemsetAsync")


def route(name: str):
    """Context in which the step takes the named route's kernels (the
    plain versions for "plain")."""
    if name in ("kernels", "replay"):
        return contextlib.nullcontext()
    return mock.patch.multiple(kernels, **kernels.PLAIN)


def device_profile(fn, frames: int) -> dict:
    """fn() once unprofiled for its wall, once under torch.profiler."""
    wall = timed(fn)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = collections.defaultdict(lambda: [0.0, 0])
    launch_host_us = 0.0
    host_launches = collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name][0] += e.device_time
            by_name[e.name][1] += 1
            continue
        if e.name == "cudaLaunchKernel":
            launch_host_us += e.cpu_time_total
        if e.name in HOST_LAUNCHES:
            host_launches[e.name] += 1
    device_ms = sum(t for t, _ in by_name.values()) / 1e3
    ops = sum(c for _, c in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    own = {m.group(1): {"ms": t / 1e3, "calls": c}
           for n, (t, c) in by_name.items()
           if (m := re.search(r"::(k[0-9][vp]?_kernel(?:<[^>]*>)?)\(", n))}
    return {"frames": frames, "wall_ms": wall * 1e3, "device_ms": device_ms,
            "device_ops": ops,
            "device_ops_per_frame": ops / frames,
            "launch_host_ms": launch_host_us / 1e3,
            "host_launches_per_frame": sum(host_launches.values()) / frames,
            "host_launches": dict(sorted(host_launches.items())),
            "port_kernels": dict(sorted(own.items())),
            "top": [{"name": n[:90], "ms": t / 1e3, "calls": c}
                    for n, (t, c) in top]}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("path", nargs="?", default="fused",
                        choices=sorted(PATHS) + list(IMAGE_PATHS))
    path = parser.parse_args(argv).path
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    if path in IMAGE_PATHS:
        cfg = image_config(*IMAGE_PATHS[path])
        st0, app0, _, imgs, u = image_inputs(cfg, dev)
        batch = IMAGE_BATCH

        def run(nf, eager):
            frontend.run_images(st0, app0, imgs[:nf], u[:nf], cfg,
                                eager=eager)
    else:
        cfg = slice_config(path)
        st0, _, obs, u = slice_inputs(
            cfg, dev, scene=FAST_SCENE if path in FAST_PATHS else 0)
        batch = BATCH

        def run(nf, eager):
            engine.run_sequence(st0, obs.window(0, nf), u[:nf], cfg,
                                eager=eager)
    result = {"card": torch.cuda.get_device_name(0), "path": path,
              "batch": batch, "frames": FRAMES, "ab": [], "profile": {}}
    print(f"[slice] path={path} card={result['card']!r}", flush=True)
    with update_form(path):
        _measure(run, batch, result)
    print(json.dumps(result))


def _measure(run, batch: int, result: dict) -> None:
    """The A/B and the profile of run(frames, eager) into result."""
    def run_all(name):
        return lambda: run(FRAMES, name != "replay")

    for name in ROUTES:
        with route(name):
            run_all(name)()                             # warm-up
    for name in ("kernels", "replay", "plain", "plain", "replay", "kernels"):
        with route(name):
            secs = [timed(run_all(name)) for _ in range(RUNS)]
        med = batch * FRAMES / statistics.median(secs)
        print(f"[ab] route={name} seconds="
              f"{','.join(f'{s:.4f}' for s in secs)} "
              f"median_steps_per_s={med:.1f}", flush=True)
        result["ab"].append({"route": name, "seconds": secs,
                             "median_steps_per_s": med})

    nf = PROFILE_FRAMES
    for name in ROUTES:
        with route(name):
            p = device_profile(lambda: run(nf, name != "replay"), nf)
        result["profile"][name] = p
        print(f"[profile] route={name} frames={nf} "
              f"wall_ms={p['wall_ms']:.2f} device_ms={p['device_ms']:.2f} "
              f"device_ops={p['device_ops']} "
              f"launch_host_ms={p['launch_host_ms']:.2f} "
              f"host_launches_per_frame={p['host_launches_per_frame']:.2f} "
              f"port_kernels="
              f"{json.dumps(p['port_kernels'], separators=(',', ':'))}",
              flush=True)
        for k in p["top"]:
            print(f"  {k['ms']:9.3f} ms x {k['calls']:5d}  {k['name']}",
                  flush=True)


if __name__ == "__main__":
    main()
