#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ekf_slam_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one line each, any failure raises (exit code != 0):
  1. card      nvidia-smi name and power limit, torch / CUDA versions
  2. build     nvcc builds csrc/*.cu into build/kernels/ (seconds printed)
  3. kernels   each kernel against its plain PyTorch version at the
               slice's shapes, on operands captured from one real frame:
               K1-K3 from the fused path, K4 and K6 from the unfused path
               (i), K5 and K6 from path (ii), K6 at both of its call sites
               (RANSAC's P·G and the update's P·Hᵀ), K7 from the image
               path (all B·CAP windows and templates of the frame); from
               the bf16-P fast mode, K8 from a fast_rows frame in its three
               modes with P as stored (bf16) and upcast, and K4 and K6 on
               a fast frame's bf16 P. Each entry's error is scaled to its
               own bound (a bf16 output may also stray one bf16 ulp); K4's
               and K8 "full"'s outputs must be bitwise symmetric, K8
               "expr"'s on a symmetric P. Then planted faults (K1 without
               process noise, K5 with the renorm Jacobian replaced by I,
               K7 with the template transposed, K8 without its renorm
               rows) must fail that check; the f32 patch variance of the
               NCC norms must stray less than ncc.FLAT_EPS roundoff units
               from its f64 value.
               Times: kernel, plain version, one library call where one
               computes the same function (K6 torch.bmm, K7 a grouped
               F.conv2d with cuDNN's TF32 off, K8 "expr" torch.baddbmm, on
               f32 operands), and the card's bound
  4. slice     the sim bench workload (CAP 100, 128 landmarks, f32) at
               B = 128 instances for 16 frames through run_sequence, on
               each engine path:
                 fused  (step_fused)                 K1-K3 once a frame
                 (i)    unfused, pallas_update off   K4 2x, K6 3x a frame
                 (ii)   unfused, pallas_update on    K5 2x, K6 3x a frame
               and in bench.py's production fast mode (P stored in bf16,
               max_update_obs 24; scene FAST_SCENE, see profile_slice):
                 fast       column-form update       K4 2x, K6 3x a frame
                 fast_rows  row-form update          K8 2x a frame
               finite state, update cap never hit, tracking error < 0.2,
               P still bf16 in the fast mode;
               then the pixels bench workload (the same map, 240x320
               rendered frames, R = 12) at B = 32 for 16 frames through
               frontend.run_images:
                 image  NCC matcher          K7 1x, K4 2x, K6 3x a frame
                 image  descriptor matcher   K4 2x, K6 3x a frame
               finite state, update cap never hit, tracking error < 0.5,
               the search radius the χ² gate needed beside R. Every other
               kernel launched 0 times; steps/s of the median of three
               timed runs (fused, (i), image NCC) or of one
  5. crosscheck one frame of each path with CUDA tensors vs the same frame
               on the CPU (plain path), and the same frame through the
               fused and the unfused step, and through the fast mode's row
               and column forms, on the card: equal gate counts, x and P
               within tolerance
Then the card's name and power limit, one JSON line with the kernels'
numbers, and as the last line {"ok": true, "device": {...}}. Without a
CUDA device it fails.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import torch
import torch.nn.functional as F

from ekf_slam_tpu_torch.filter import engine
from ekf_slam_tpu_torch.ops import _build, kernels
from ekf_slam_tpu_torch.profile_slice import (BATCH, FAST_PATHS, FAST_SCENE,
                                              FRAMES, IMAGE_BATCH,
                                              image_config, image_inputs,
                                              slice_config, slice_inputs,
                                              update_form)
from ekf_slam_tpu_torch.vision import frontend, ncc

FUSED_SRC = "ekf_slam_tpu_torch/csrc/fused_cov.cu"
UNFUSED_SRC = "ekf_slam_tpu_torch/csrc/unfused_cov.cu"
NCC_SRC = "ekf_slam_tpu_torch/csrc/ncc.cu"
PK = "ekf_slam_tpu/ops/pallas_kernels.py"
# name -> (source, line of the TPU kernel's wrapper it replaces)
KERNELS = {
    "fused_manage_predict_pht": (FUSED_SRC, f"{PK}:374"),
    "fused_update_tail_pht": (FUSED_SRC, f"{PK}:492"),
    "fused_update_tail_add": (FUSED_SRC, f"{PK}:544"),
    "corr_apply_cols": (UNFUSED_SRC, f"{PK}:731"),
    "fused_update_tail": (FUSED_SRC, f"{PK}:135"),
    "f32_matmul_big": (UNFUSED_SRC, f"{PK}:192"),
    "ncc_corr": (NCC_SRC, f"{PK}:802"),
    "corr_apply": (UNFUSED_SRC, f"{PK}:741"),
}
# Launches a frame of each path (the rest launch 0 times). The image step
# is branchless: frame 0, with no features yet, launches as many.
PER_FRAME = {
    "fused": {"fused_manage_predict_pht": 1, "fused_update_tail_pht": 1,
              "fused_update_tail_add": 1},
    "unfused": {"corr_apply_cols": 2, "f32_matmul_big": 3},
    "unfused_pallas": {"fused_update_tail": 2, "f32_matmul_big": 3},
    "image": {"ncc_corr": 1, "corr_apply_cols": 2, "f32_matmul_big": 3},
    "image_descriptor": {"corr_apply_cols": 2, "f32_matmul_big": 3},
    "fast": {"corr_apply_cols": 2, "f32_matmul_big": 3},
    "fast_rows": {"corr_apply": 2},
}
SIM_PATHS = ("fused", "unfused", "unfused_pallas")
# The H100's peaks (NVIDIA's data sheet, SXM, at 700 W): f32 outside the
# tensor cores, and device memory.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def _sym(D: int) -> int:
    """Entries of a symmetric D x D output that must be computed."""
    return D * (D + 1) // 2


# Floating-point operations of one call, from its operands: the plain
# version's multiply-adds, each entry of a symmetric output counted once
# (the downdate ½(K·PHtᵀ + PHt·Kᵀ): 4R an entry; the low-rank EᵀU + UᵀE +
# EᵀCE: 6r an entry after EᵀC; K4's ½(A·Bᵀ + B·Aᵀ) and K8's ½(AtᵀBt +
# BtᵀAt) in "expr" / "full": 4R; K8's AtᵀBt in "none", not symmetric: 2R
# an entry over all D² entries), the low-rank terms dense, as the kernels
# compute them.
FLOPS = {
    "fused_manage_predict_pht": lambda P, keep, E6, U6, C66, F13, Q13, Ht:
        P.shape[0] * (2 * P.shape[1] ** 2 * Ht.shape[2]
                      + 6 * _sym(P.shape[1]) * E6.shape[1]
                      + 2 * E6.shape[1] ** 2 * P.shape[1]
                      + 4 * 13 * 13 * P.shape[1]),
    "fused_update_tail_pht": lambda P, K, PHt, Jq4, Ht:
        P.shape[0] * (4 * _sym(P.shape[1]) * K.shape[2]
                      + 2 * P.shape[1] ** 2 * Ht.shape[2]
                      + 4 * 4 * 4 * P.shape[1]),
    "fused_update_tail_add": lambda P, K, PHt, Jq4, keepN, EN, UN, CN:
        P.shape[0] * (4 * _sym(P.shape[1]) * K.shape[2]
                      + 6 * _sym(P.shape[1]) * EN.shape[1]
                      + 2 * EN.shape[1] ** 2 * P.shape[1]
                      + 4 * 4 * 4 * P.shape[1]),
    "corr_apply_cols": lambda P, A, B:
        P.shape[0] * 4 * _sym(P.shape[1]) * A.shape[2],
    "fused_update_tail": lambda P, K, PHt, Jq4:
        P.shape[0] * (4 * _sym(P.shape[1]) * K.shape[2]
                      + 4 * 4 * 4 * P.shape[1]),
    "f32_matmul_big": lambda A, B:
        2 * A.shape[0] * A.shape[1] * A.shape[2] * B.shape[2],
    "ncc_corr": lambda win, tm:
        2 * win.shape[0] * (win.shape[-1] - tm.shape[-1] + 1) ** 2
        * tm.shape[-1] ** 2,
    "corr_apply": lambda P, At, Bt, mode:
        P.shape[0] * (2 * P.shape[1] ** 2 * At.shape[1] if mode == "none"
                      else 4 * _sym(P.shape[1]) * At.shape[1]),
}
# One PyTorch call that computes the kernel's function, where there is
# one: timed beside the kernel, never called by the port. Its bf16
# operands are upcast to f32 first, outside the timing (no library call
# takes a bf16 P with f32 products). K8's is its "expr" mode, the JAX XLA
# form P + ½[At;Bt]ᵀ[Bt;At] (ekf.py:579-582).
LIBRARY = {
    "f32_matmul_big": torch.bmm,
    "ncc_corr": lambda win, tm: F.conv2d(win[None], tm[:, None],
                                         groups=win.shape[0])[0],
    "corr_apply": lambda P, At, Bt, mode: torch.baddbmm(
        P, torch.cat([At, Bt], 1).transpose(1, 2), torch.cat([Bt, At], 1),
        alpha=0.5),
}
# One frame, CUDA vs CPU, both f32: the same math in another summation
# order; the gain solve and the two updates amplify rounding. x within this
# share of max|x|, P entrywise within this many Cauchy-Schwarz bounds (a
# bf16 P beyond one bf16 ulp: two roundings of f32 values that differ in
# their last bits land one bf16 ulp apart, up to 2^-7 of an entry).
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


def kernel_error(name, out, ref, args) -> float:
    """kernels.scaled_error of a kernel's output against its f64 plain
    version; for K6 the product bound sqrt(P_ii·(Hᵀ·P·H)_kk), for K7 the
    bound ‖window patch‖·‖template‖ (kernels.ncc_error)."""
    if name == "ncc_corr":
        return kernels.ncc_error(out, ref, *args)
    if name == "f32_matmul_big":
        A = args[0].double()
        return kernels.product_error(out, ref, torch.diagonal(
            A, dim1=1, dim2=2), args[1])
    Ht = args[-1] if name in ("fused_manage_predict_pht",
                              "fused_update_tail_pht") else None
    return kernels.scaled_error(out, ref, Ht)


def check_kernel(name, args, site="") -> dict:
    """One kernel against its plain version on the card: errors (kernel
    vs f64 plain on the same inputs, limit kernels.SCALED_TOL), CUDA-event
    times of kernel, plain and library call, max|P−Pᵀ| of the P output."""
    wrapper, plain = getattr(kernels, name), kernels.PLAIN[name]
    out = wrapper(*args)
    torch.cuda.synchronize()
    ref = plain(*(a.double() if isinstance(a, torch.Tensor) else a
                  for a in args))
    err = kernel_error(name, out, ref, args)
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    abs_err = max(float((o.double() - r).abs().max())
                  for o, r in zip(outs, refs))
    ms = cuda_ms(lambda: wrapper(*args))
    plain_ms = cuda_ms(lambda: plain(*args))
    library = LIBRARY.get(name)
    if name == "corr_apply" and args[3] != "expr":
        library = None
    library_ms = None
    if library is not None:
        lib_args = tuple(a.float() if isinstance(a, torch.Tensor)
                         and a.dtype == torch.bfloat16 else a for a in args)
        lib_err = float((library(*lib_args).double() - refs[0]).abs().max())
        library_ms = cuda_ms(lambda: library(*lib_args))
    flops = FLOPS[name](*args)
    nbytes = sum(t.numel() * t.element_size() for t in args + outs
                 if isinstance(t, torch.Tensor))
    bound_ms = max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES) * 1e3
    bound_by = ("operations" if flops / PEAK_F32_FLOPS
                >= nbytes / PEAK_BYTES else "bytes")
    fields = dict(name=name, site=site or "-", shapes=",".join(
        "x".join(str(s) for s in a.shape) for a in args[:2]),
        dtype=str(args[0].dtype).removeprefix("torch."),
        max_abs_err=f"{abs_err:.3e}", scaled_err=f"{err:.3e}",
        ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
        library_ms="none" if library_ms is None else f"{library_ms:.4f}",
        bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
        gflop=f"{flops / 1e9:.4f}", mbytes=f"{nbytes / 1e6:.2f}")
    if library_ms is not None:
        fields["library_abs_err"] = f"{lib_err:.3e}"
    if name not in ("f32_matmul_big", "ncc_corr"):
        fields["asym"] = f"{max_asym(outs[0]):.3e}"
    phase("kernel", **fields)
    if not err <= kernels.SCALED_TOL:
        raise AssertionError(f"{name} {site}: kernel vs plain {err:.3e} > "
                             f"{kernels.SCALED_TOL}")
    symmetric = name == "corr_apply_cols" or (name == "corr_apply"
                                              and args[3] == "full")
    if symmetric and not torch.equal(outs[0], outs[0].transpose(1, 2)):
        raise AssertionError(f"{name} {site}: output not bitwise "
                             f"symmetric, max|P−Pᵀ| {max_asym(outs[0])}")
    source, replaces = KERNELS[name]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": abs_err,
            "scaled_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def planted_fault(tag, got, ref, err_fn) -> None:
    """A kernel launched with a planted fault must read > 100x the limit."""
    fault = err_fn(got, ref)
    phase("fault", planted=tag, scaled_err=f"{fault:.3e}",
          limit=kernels.SCALED_TOL)
    if not fault > 100 * kernels.SCALED_TOL:
        raise AssertionError(f"the check misses {tag}: {fault:.3e}")


def flat_stray(win, t) -> None:
    """The largest stray of the f32 patch variance (ncc.patch_variance, on
    the card) from its f64 value over the frame's windows, in units of
    eps·Σwc²: it must stay below ncc.FLAT_EPS, the floor under which
    ncc_scores_all scores a patch as flat."""
    var32, _ = ncc.patch_variance(win, t)
    var64, energy = ncc.patch_variance(win.double(), t)
    stray = float(((var32.double() - var64).abs()
                   / (torch.finfo(torch.float32).eps
                      * energy[:, None, None])).max())
    phase("flat", flat_stray=f"{stray:.4f}", limit=ncc.FLAT_EPS,
          windows=win.shape[0])
    if not stray < ncc.FLAT_EPS:
        raise AssertionError(f"f32 patch variance strays {stray:.4f} units "
                             f">= FLAT_EPS {ncc.FLAT_EPS}")


def capture_frame(cfg, st0, obs, u, t=2):
    """{name: [operands of each call]} of frame t of the sequence."""
    st, _, _ = engine.run_sequence(st0, obs.window(0, t), u[:t], cfg)
    with kernels.capture_operands() as inputs:
        engine.step(st, obs.frame(t), u[t], cfg)
    return inputs


def capture_image_frame(cfg, st0, app0, imgs, u, dev, t=2):
    """{name: [operands of each call]} of image frame t of the sequence."""
    st, app, _, _ = frontend.run_images(st0, app0, imgs[:t], u[:t], cfg, dev)
    with kernels.capture_operands() as inputs:
        frontend.step_image(st, app, imgs[t], u[t], cfg)
    return inputs


def run_slice(path, cfg, run, batch, xs, runs, track_limit, card) -> dict:
    """Phase 4 for one path: a warm-up, then `runs` timed runs of the
    path's driver `run()` -> (final state, traj, infos), each with the
    counts set to 0 just before and read just after; the gates. Returns
    the launch counts of the last run."""
    run()                                                # warm-up
    want = {k: PER_FRAME[path].get(k, 0) * FRAMES for k in kernels.LAUNCHES}
    seconds = []
    for _ in range(runs):
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        final, traj, infos = run()
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        launches = dict(kernels.LAUNCHES)
        if launches != want:
            raise AssertionError(f"{path}: kernel launches {launches}, "
                                 f"expected {want}")
    if not (torch.isfinite(traj).all()
            and torch.isfinite(final.P.float()).all()):
        raise AssertionError(f"{path}: non-finite trajectory or covariance")
    if cfg.filter.p_storage == "bf16" and final.P.dtype != torch.bfloat16:
        raise AssertionError(f"{path}: P left bf16 storage: {final.P.dtype}")
    max_obs = int(torch.maximum(infos.n_li.max(), infos.n_hi.max()))
    if max_obs > cfg.map.max_update_obs:
        raise AssertionError(f"{path}: update cap hit: {max_obs} > "
                             f"{cfg.map.max_update_obs}")
    err = float(torch.linalg.vector_norm(
        traj[..., 0:3] - xs[None, :, 0:3], dim=-1).mean())
    if not err < track_limit:
        raise AssertionError(f"{path}: tracking error {err:.4f} >= "
                             f"{track_limit}")
    rate = batch * FRAMES / statistics.median(seconds)
    fields = dict(path=path, batch=batch, frames=FRAMES,
                  P=str(final.P.dtype).removeprefix("torch."),
                  seconds=",".join(f"{s:.4f}" for s in seconds),
                  median_steps_per_s=f"{rate:.1f}",
                  track_err=f"{err:.4f}", largest_update=max_obs,
                  update_cap=cfg.map.max_update_obs)
    if path.startswith("image"):
        fields.update(
            search_r_needed=f"{float(infos.search_r_needed.max()):.2f}",
            search_radius=cfg.vision.search_radius,
            n_ic_last=f"{float(infos.n_ic[:, -1].float().mean()):.2f}")
    phase("slice", **fields, launches=json.dumps(
        {k: v for k, v in launches.items() if v}, separators=(",", ":")),
        card=repr(card))
    return launches


def same_frame(tag, a, b) -> None:
    """Two results of one frame: equal gate counts, x within X_RTOL of
    max|x|, P entrywise within P_TOL of its bounds (and one bf16 ulp for
    a bf16 P, kernels.scaled_error)."""
    (s_a, i_a), (s_b, i_b) = a, b
    for f in ("n_ic", "n_li", "n_hi"):
        x, y = getattr(i_a, f).cpu(), getattr(i_b, f).cpu()
        if not torch.equal(x, y):
            raise AssertionError(f"{tag}: {f} differs on "
                                 f"{int((x != y).sum())} instances")
    xa, xb = s_a.x.cpu(), s_b.x.cpu()
    dx = float((xa - xb).abs().max())
    scale = float(xb.abs().max())
    if not dx <= X_RTOL * scale:
        raise AssertionError(f"{tag}: x differs by {dx:.3e} > {X_RTOL} * "
                             f"{scale:.3e}")
    dP = kernels.scaled_error(s_a.P.cpu(), s_b.P.cpu().double())
    if not dP <= P_TOL:
        raise AssertionError(f"{tag}: P differs by {dP:.3e} bounds > "
                             f"{P_TOL}")
    fields = dict(max_abs_x=f"{scale:.3e}", P_scaled_err=f"{dP:.3e}")
    if s_a.P.dtype == torch.bfloat16:
        fields["without_ulp"] = "{:.3e}".format(kernels.scaled_error(
            s_a.P.cpu().double(), s_b.P.cpu().double()))
    phase("crosscheck", pair=tag, counts="equal", max_dx=f"{dx:.3e}",
          **fields)


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
    card = smi.splitlines()[0]
    print(card, flush=True)
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
        if ("registers" in line or "spill" in line or "Compiling" in line
                or line.startswith("==")):
            print("  ptxas:", line.strip(), flush=True)

    report = check_paths(dev, card)
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def check_paths(dev, card: str) -> list:
    """Phases 3-5 on device `dev`. Returns the kernels' JSON entries."""
    # -- 3. kernels vs plain on one real frame of each path -------------------
    cfgs = {p: slice_config(p) for p in SIM_PATHS}
    st0, xs, obs, u = slice_inputs(cfgs["fused"], dev)
    icfgs = {"image": image_config("ncc"),
             "image_descriptor": image_config("descriptor")}
    ist0, iapp0, ixs, imgs, iu = image_inputs(icfgs["image"], dev)
    report = {}
    inputs = capture_frame(cfgs["fused"], st0, obs, u)
    for name in PER_FRAME["fused"]:
        report[name] = check_kernel(name, inputs[name][-1])
    args = inputs["fused_manage_predict_pht"][-1]
    planted_fault(
        "K1_without_Q",
        kernels.fused_manage_predict_pht(*args[:6], torch.zeros_like(args[6]),
                                         args[7]),
        kernels.manage_predict_pht_plain(*(a.double() for a in args)),
        lambda g, r: kernels.scaled_error(g, r, args[7]))

    # The unfused frame calls K6 for RANSAC's P·G first, then for each
    # update's P·Hᵀ (LI, HI).
    inputs = capture_frame(cfgs["unfused"], st0, obs, u)
    report["corr_apply_cols"] = check_kernel("corr_apply_cols",
                                             inputs["corr_apply_cols"][0],
                                             "LI")
    check_kernel("f32_matmul_big", inputs["f32_matmul_big"][0], "ransac_PG")
    report["f32_matmul_big"] = check_kernel(
        "f32_matmul_big", inputs["f32_matmul_big"][1], "update_PHt")
    inputs = capture_frame(cfgs["unfused_pallas"], st0, obs, u)
    args = inputs["fused_update_tail"][0]
    report["fused_update_tail"] = check_kernel("fused_update_tail", args,
                                               "LI")
    eye4 = torch.eye(4, device=dev).expand_as(args[3]).contiguous()
    planted_fault(
        "K5_with_Jq4_eq_I", kernels.fused_update_tail(*args[:3], eye4),
        kernels.update_tail_plain(*(a.double() for a in args)),
        kernels.scaled_error)

    # The image frame's numerator: all B·CAP windows and templates at once.
    inputs = capture_image_frame(icfgs["image"], ist0, iapp0, imgs, iu, dev)
    args = inputs["ncc_corr"][0]
    report["ncc_corr"] = check_kernel("ncc_corr", args, "image")
    win, tm = args
    planted_fault(
        "K7_template_transposed",
        kernels.ncc_corr(win, tm.transpose(1, 2).contiguous()),
        kernels.ncc_corr_plain(win.double(), tm.double()),
        lambda g, r: kernels.ncc_error(g, r, win, tm))
    flat_stray(win, tm.shape[-1])

    # The fast mode (bf16 P, M = 24, scene FAST_SCENE): K8 on a row-form
    # frame's tails, in each mode with P as stored and upcast; then K4 and
    # K6 on a column-form frame's bf16 P.
    fcfgs = {p: slice_config(p) for p in FAST_PATHS}
    fst0, fxs, fobs, fu = slice_inputs(fcfgs["fast"], dev, scene=FAST_SCENE)
    with update_form("fast_rows"):
        inputs = capture_frame(fcfgs["fast_rows"], fst0, fobs, fu)
    P, At, Bt, mode = inputs["corr_apply"][0]
    if P.dtype != torch.bfloat16 or mode != "expr":
        raise AssertionError(f"fast_rows: K8 took P {P.dtype}, mode {mode}")
    k8 = {}
    for m in kernels.CORR_MODES:
        for Pm in (P, P.float()):
            k8[m, Pm.dtype] = check_kernel(
                "corr_apply", (Pm, At, Bt, m),
                f"LI_{m}_{str(Pm.dtype).removeprefix('torch.')}")
    report["corr_apply"] = k8["expr", torch.bfloat16]
    for Pm in (P, P.float()):
        sym = (0.5 * (Pm.float() + Pm.float().transpose(1, 2))).to(Pm.dtype)
        out = kernels.corr_apply(sym, At, Bt, "expr")
        if not torch.equal(out, out.transpose(1, 2)):
            raise AssertionError(f"corr_apply expr on a symmetric {Pm.dtype} "
                                 f"P: max|P−Pᵀ| {max_asym(out)}")
    no_renorm = At.clone()
    no_renorm[:, -4:] = 0
    planted_fault(
        "K8_without_renorm_rows", kernels.corr_apply(P, no_renorm, Bt, mode),
        kernels.corr_apply_plain(P.double(), At.double(), Bt.double(), mode),
        kernels.scaled_error)
    with update_form("fast"):
        inputs = capture_frame(fcfgs["fast"], fst0, fobs, fu)
    check_kernel("f32_matmul_big", inputs["f32_matmul_big"][0],
                 "ransac_PG_bf16")
    for name, site, args in (
            ("corr_apply_cols", "LI_bf16", inputs["corr_apply_cols"][0]),
            ("f32_matmul_big", "update_PHt_bf16",
             inputs["f32_matmul_big"][1])):
        if args[0].dtype != torch.bfloat16:
            raise AssertionError(f"fast: {name} took {args[0].dtype}")
        e = check_kernel(name, args, site)
        report[name]["bf16_p"] = {k: e[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err", "scaled_err")}

    # -- 4. the slices: 16 frames through each path ---------------------------
    def sim_run(path):
        if path in FAST_PATHS:
            return lambda: engine.run_sequence(fst0, fobs, fu, fcfgs[path])
        return lambda: engine.run_sequence(st0, obs, u, cfgs[path])

    def image_run(path):
        def run():
            final, _, traj, infos = frontend.run_images(
                ist0, iapp0, imgs, iu, icfgs[path], dev)
            return final, traj, infos
        return run

    launches = {}
    for path, runs in (("fused", 3), ("unfused", 3), ("unfused_pallas", 1),
                       ("fast", 3), ("fast_rows", 3), ("image", 3),
                       ("image_descriptor", 1)):
        if path in SIM_PATHS:
            counts = run_slice(path, cfgs[path], sim_run(path), BATCH, xs,
                               runs, 0.2, card)
        elif path in FAST_PATHS:
            with update_form(path):
                counts = run_slice(path, fcfgs[path], sim_run(path), BATCH,
                                   fxs, runs, 0.2, card)
        else:
            counts = run_slice(path, icfgs[path], image_run(path),
                               IMAGE_BATCH, ixs, runs, 0.5, card)
        for name in PER_FRAME[path]:
            launches.setdefault(name, counts[name])
    for name, k in report.items():
        k["launches"] = launches[name]

    # -- 5. one frame: CUDA vs CPU on each path, fused vs unfused on the card
    st8, _, _ = engine.run_sequence(st0, obs.window(0, 8), u[:8],
                                    cfgs["fused"])
    on_card = {}
    for path, cfg in cfgs.items():
        on_card[path] = engine.step(st8, obs.frame(8), u[8], cfg)
        on_cpu = engine.step(st8.to("cpu"), obs.frame(8).to("cpu"),
                             u[8].cpu(), cfg)
        same_frame(f"{path}:cuda_vs_cpu", on_card[path], on_cpu)
    same_frame("fused_vs_unfused:cuda", on_card["fused"], on_card["unfused"])
    with update_form("fast"):
        fst8, _, _ = engine.run_sequence(fst0, fobs.window(0, 8), fu[:8],
                                         fcfgs["fast"])
    for path, cfg in fcfgs.items():
        with update_form(path):
            on_card[path] = engine.step(fst8, fobs.frame(8), fu[8], cfg)
            on_cpu = engine.step(fst8.to("cpu"), fobs.frame(8).to("cpu"),
                                 fu[8].cpu(), cfg)
        same_frame(f"{path}:cuda_vs_cpu", on_card[path], on_cpu)
    same_frame("fast_rows_vs_fast:cuda", on_card["fast_rows"],
               on_card["fast"])
    ist8, iapp8, _, _ = frontend.run_images(ist0, iapp0, imgs[:8], iu[:8],
                                            icfgs["image"], dev)
    card_step = frontend.step_image(ist8, iapp8, imgs[8], iu[8],
                                    icfgs["image"])
    cpu_step = frontend.step_image(ist8.to("cpu"), iapp8.to("cpu"),
                                   imgs[8].cpu(), iu[8].cpu(), icfgs["image"])
    same_frame("image:cuda_vs_cpu", (card_step[0], card_step[2]),
               (cpu_step[0], cpu_step[2]))
    return list(report.values())


if __name__ == "__main__":
    main()
