#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ekf_slam_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one line each, any failure raises (exit code != 0):
  1. card      nvidia-smi name and power limit, torch / CUDA versions
  2. build     nvcc builds csrc/*.cu into build/kernels/ (seconds printed)
  3. kernels   K1-K3 against their plain PyTorch versions at the slice's
               shapes, on inputs captured from one real frame of the slice,
               each entry's error scaled to its own bound; then a planted
               fault (K1 without process noise) must fail that check
  4. slice     the bench workload (CAP 100, 128 landmarks, f32) at
               B = 128 instances for 16 frames through run_sequence:
               finite state, update cap never hit, tracking error < 0.2,
               each kernel launched once per frame; steps/s of the
               median of three timed runs
  5. crosscheck one frame with CUDA tensors vs the same frame on the CPU
               (plain path): equal gate counts, x and P within tolerance
Then one JSON line with the kernels' numbers, and as the last line
{"ok": true, "device": {...}}. Without a CUDA device it fails.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import torch

from ekf_slam_tpu_torch.filter import engine
from ekf_slam_tpu_torch.ops import _build, kernels
from ekf_slam_tpu_torch.profile_slice import (BATCH, FRAMES, slice_config,
                                              slice_inputs)

SOURCE = "ekf_slam_tpu_torch/csrc/fused_cov.cu"
# name -> line of the TPU kernel's wrapper it replaces
REPLACES = {
    "fused_manage_predict_pht": "ekf_slam_tpu/ops/pallas_kernels.py:374",
    "fused_update_tail_pht": "ekf_slam_tpu/ops/pallas_kernels.py:492",
    "fused_update_tail_add": "ekf_slam_tpu/ops/pallas_kernels.py:544",
}
# One frame, CUDA vs CPU, both f32: the same math in another summation
# order; the gain solve and the two updates amplify rounding. x within this
# share of max|x|, P entrywise within this many Cauchy-Schwarz bounds.
X_RTOL = 1e-3
P_TOL = 1e-2


def phase(tag: str, **fields) -> None:
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def cuda_ms(fn, n: int = 20) -> float:
    """Mean time of fn() over n calls, by CUDA events, after 2 warm calls."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def max_asym(P: torch.Tensor) -> float:
    return float((P - P.transpose(1, 2)).abs().max())


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. card --------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    phase("card", torch=torch.__version__, cuda=torch.version.cuda,
          device=repr(torch.cuda.get_device_name(0)),
          count=torch.cuda.device_count())

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    lib_path, log = _build.build()
    _build.load()
    phase("build", seconds=f"{time.perf_counter() - t0:.2f}",
          lib=lib_path.relative_to(_build.BUILD_DIR.parent.parent))
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  ptxas:", line.strip(), flush=True)

    # -- 3. kernels vs plain on one real frame --------------------------------
    cfg = slice_config()
    st0, xs, obs, u = slice_inputs(cfg, dev)
    st2, _, _ = engine.run_sequence(st0, obs.window(0, 2), u[:2], cfg)
    with kernels.capture_operands() as inputs:
        engine.step(st2, obs.frame(2), u[2], cfg)
    report = []
    for name, plain in kernels.PLAIN.items():
        args = inputs[name]
        Ht = args[-1] if name != "fused_update_tail_add" else None
        wrapper = getattr(kernels, name)
        out = wrapper(*args)
        torch.cuda.synchronize()
        ref = plain(*(a.double() for a in args))
        # f32 kernel vs f64 plain on the same inputs, each entry in units
        # of its own bound (the limit's reason: kernels.SCALED_TOL)
        err = kernels.scaled_error(out, ref, Ht)
        abs_err = max(float((o.double() - r).abs().max()) for o, r in zip(
            out if isinstance(out, tuple) else (out,),
            ref if isinstance(ref, tuple) else (ref,)))
        ms = cuda_ms(lambda: wrapper(*args))
        plain_ms = cuda_ms(lambda: plain(*args))
        P_out = out[0] if isinstance(out, tuple) else out
        phase("kernel", name=name, shapes="x".join(
            str(s) for s in args[0].shape), max_abs_err=f"{abs_err:.3e}",
            scaled_err=f"{err:.3e}", ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.4f}", asym=f"{max_asym(P_out):.3e}")
        if not err <= kernels.SCALED_TOL:
            raise AssertionError(f"{name}: kernel vs plain {err:.3e} "
                                 f"> {kernels.SCALED_TOL}")
        report.append({"name": name, "route": "cuda", "source": SOURCE,
                       "replaces": REPLACES[name], "max_abs_err": abs_err,
                       "scaled_err": err, "ms": ms, "plain_ms": plain_ms})
    # The check sees a fault of the camera block: K1 launched without its
    # process noise must read far above the limit.
    args = inputs["fused_manage_predict_pht"]
    no_q = kernels.fused_manage_predict_pht(
        *args[:6], torch.zeros_like(args[6]), args[7])
    fault = kernels.scaled_error(no_q, kernels.manage_predict_pht_plain(
        *(a.double() for a in args)), args[7])
    phase("fault", planted="K1_without_Q", scaled_err=f"{fault:.3e}",
          limit=kernels.SCALED_TOL)
    if not fault > 100 * kernels.SCALED_TOL:
        raise AssertionError(f"the check misses K1 without Q: {fault:.3e}")

    # -- 4. the slice: 16 frames at B = 128 through the kernels ---------------
    # Three timed runs of the same sequence (host-clock spread is wide on a
    # shared host); the counts are reset before and read after each.
    engine.run_sequence(st0, obs, u, cfg)                # warm-up
    seconds = []
    for _ in range(3):
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        final, traj, infos = engine.run_sequence(st0, obs, u, cfg)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        launches = dict(kernels.LAUNCHES)
        if not all(n == FRAMES for n in launches.values()):
            raise AssertionError(f"kernel launches {launches}, expected "
                                 f"{FRAMES} each")
    for k in report:
        k["launches"] = launches[k["name"]]
    if not (torch.isfinite(traj).all() and torch.isfinite(final.P).all()):
        raise AssertionError("non-finite trajectory or covariance")
    max_obs = int(torch.maximum(infos.n_li.max(), infos.n_hi.max()))
    if max_obs > cfg.map.max_update_obs:
        raise AssertionError(f"update cap hit: {max_obs} > "
                             f"{cfg.map.max_update_obs}")
    err = float(torch.linalg.vector_norm(
        traj[..., 0:3] - xs[None, :, 0:3], dim=-1).mean())
    if not err < 0.2:
        raise AssertionError(f"tracking error {err:.4f} >= 0.2")
    rate = BATCH * FRAMES / statistics.median(seconds)
    phase("slice", batch=BATCH, frames=FRAMES,
          seconds=",".join(f"{s:.4f}" for s in seconds),
          median_steps_per_s=f"{rate:.1f}",
          track_err=f"{err:.4f}", largest_update=max_obs,
          update_cap=cfg.map.max_update_obs,
          launches=json.dumps(launches, separators=(",", ":")),
          card=repr(smi.splitlines()[0]))

    # -- 5. one frame on the card vs the same frame on the CPU ---------------
    st8, _, _ = engine.run_sequence(st0, obs.window(0, 8), u[:8], cfg)
    s_gpu, i_gpu = engine.step(st8, obs.frame(8), u[8], cfg)
    s_cpu, i_cpu = engine.step(st8.to("cpu"), obs.frame(8).to("cpu"),
                               u[8].cpu(), cfg)
    for f in ("n_ic", "n_li", "n_hi"):
        a, b = getattr(i_gpu, f).cpu(), getattr(i_cpu, f)
        if not torch.equal(a, b):
            raise AssertionError(f"{f} differs CUDA vs CPU on "
                                 f"{int((a != b).sum())} instances")
    dx = float((s_gpu.x.cpu() - s_cpu.x).abs().max())
    scale = float(s_cpu.x.abs().max())
    if not dx <= X_RTOL * scale:
        raise AssertionError(f"x differs CUDA vs CPU by {dx:.3e} "
                             f"> {X_RTOL} * {scale:.3e}")
    dP = kernels.scaled_error(s_gpu.P.cpu().double(), s_cpu.P.double())
    if not dP <= P_TOL:
        raise AssertionError(f"P differs CUDA vs CPU by {dP:.3e} bounds "
                             f"> {P_TOL}")
    phase("crosscheck", counts="equal", max_dx=f"{dx:.3e}",
          max_abs_x=f"{scale:.3e}", P_scaled_err=f"{dP:.3e}")

    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
