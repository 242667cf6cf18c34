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
               (RANSAC's P·G and the update's P·Hᵀ), K7 in both forms
               (ncc_corr, ncc_corr_norms) on the image path's operands
               of ncc_corr_norms (all B·CAP windows and templates of the
               frame); from
               the bf16-P fast mode, K8 from a fast_rows frame in its three
               modes with P as stored (bf16) and upcast, and K4 and K6 on
               a fast frame's bf16 P, and K6 and K4 from an IEKF frame
               (sites iekf_PHt, the last iterate's P·Hᵀ, and iekf_tail,
               the iterated update's covariance tail). Each entry's error
               is scaled to its own bound (a bf16 output may also stray one bf16 ulp); K4's
               and K8 "full"'s outputs must be bitwise symmetric, K8
               "expr"'s and K3's on a symmetric P. Then planted faults (K1
               without process noise, K2 with its P·Hᵀ taken from the P
               before the tail, K3 with keepN all ones on P with stale
               values in the new slots, K5 with the renorm Jacobian
               replaced by I, K7 with the template transposed, K8 without
               its renorm rows) must fail that check. The norms form's
               patch variance must stray less than ncc.FLAT_EPS units of
               eps·Σwc² from its f64 value and its energies agree to
               1e-5, and its windows rolled up one row (box sums one row
               down) must read > 100x FLAT_EPS; the plain version's f32
               variance (the CPU path's) must stray less than FLAT_EPS
               too.
               Times: kernel, plain version, one library call where one
               computes the same function (K6 torch.bmm, K7 a grouped
               F.conv2d with cuDNN's TF32 off, K8 "expr" and K4
               torch.baddbmm, on f32 operands), and the card's bound;
               x_bound and x_library are the kernel's time over each
  4. slice     the sim bench workload (CAP 100, 128 landmarks, f32) at
               B = 128 instances for 16 frames through run_sequence, on
               each engine path:
                 fused  (step_fused)                 K1-K3 once a frame
                 (i)    unfused, pallas_update off   K4 2x, K6 3x a frame
                 (ii)   unfused, pallas_update on    K5 2x, K6 3x a frame
                 iekf   unfused, the iterated LI update (3 iterations),
                        pallas_update off            K4 2x, K6 6x a frame
               and in bench.py's production fast mode (P stored in bf16,
               max_update_obs 24; scene FAST_SCENE, see profile_slice):
                 fast       column-form update       K4 2x, K6 3x a frame
                 fast_rows  row-form update          K8 2x a frame
               finite state, update cap never hit, tracking error < 0.2,
               P still bf16 in the fast mode;
               then the pixels bench workload (the same map, 240x320
               rendered frames, R = 12) at B = 32 for 16 frames through
               frontend.run_images:
                 image  NCC matcher          K7 norms 1x, K4 2x, K6 3x
                 image  descriptor matcher   K4 2x, K6 3x a frame
               finite state, update cap never hit, tracking error < 0.5,
               the search radius the χ² gate needed beside R. Every other
               kernel launched 0 times; steps/s of the median of three
               timed runs (fused, (i), iekf, image NCC) or of one
  5. crosscheck one frame of each path (the IEKF's too) with CUDA tensors
               vs the same frame
               on the CPU (plain path), and the same frame through the
               fused and the unfused step, and through the fast mode's row
               and column forms, on the card: equal gate counts, x and P
               within tolerance
  6. loop      the CALC2 loop-closure path (models/loop_runner.run_online)
               at full width: VSS(VSSConfig()), width 32 at 192x256, with
               the port's own seeded weights, over a 128-frame rendered pan
               at B = 4 with LoopConfig's defaults (capacity 4096, top_k 7,
               64 hypotheses, ratio 0.7, consistency 7 / 9) except min_db
               and exclude_recent, cut to T // 4 (printed as `reduced`):
               x and P finite, the DB holding frames 0..T-1, K4 and K6 once
               a frame (the pose constraint's masked ekf.update) and no
               other kernel; frames/s of the median of three runs, device
               ms a frame of the VSS, the query and the fusion and the
               card's busy share (torch.profiler, 8 frames). The first 3
               frames and one query against the warm DB on the card vs
               the CPU: descriptor cosine >= 1 - 1e-5, keypoints, candidates
               and gate decisions equal. K4 and K6 on the constraint's
               operands against their plain versions. Then bench.py's
               BENCH_MODE=loop protocol through the port's harness
               (python -m ekf_slam_tpu_torch.run_loop_closure: pixels
               front-end, pan, 150 frames, 4 seeds, width 8 at 48x64,
               sim_threshold 0.9, min_inliers 10) and its three gates:
               loops declared, ATE with fusion <= 1.05x without, final
               position error with fusion <= 0.5x without.
  7. drivers   a 32-frame KITTI-layout sequence rendered by the port (the
               pan of run_loop_closure, %06d.pgm frames and poses.txt)
               into a temporary directory, then, each a process of its
               own on the card: python -m ekf_slam_tpu_torch.run_slam
               --mode sequence and --mode sim at --batch 128 --capacity
               100, and python -m ekf_slam_tpu_torch.close_loops on it.
               Exit 0, the artifacts present and finite, the native
               loader in use, and the sequence run's trajectory equal
               (within phase 5's x tolerance) to frontend.run_images run
               here on the same decoded frames with the driver's draws;
               run_slam's kernel launches (it prints ops/kernels.LAUNCHES)
               those of its path: the descriptor image step (K4 2x, K6
               3x a frame) and the fused step (K1-K3 once a frame) at
               this config; steps/s (frames/s) and seconds of each.
Then the card's name and power limit, one JSON line with the kernels'
numbers, and as the last line {"ok": true, "device": {...}}. Without a
CUDA device it fails.
"""

from __future__ import annotations

import collections
import json
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy
import torch
import torch.nn.functional as F

from ekf_slam_tpu_torch import run_loop_closure, run_slam
from ekf_slam_tpu_torch.filter import engine, loop_fusion
from ekf_slam_tpu_torch.filter.state import init_state
from ekf_slam_tpu_torch.io import ImageSequence, write_pgm
from ekf_slam_tpu_torch.io.poses import save_trajectory_kitti
from ekf_slam_tpu_torch.models import keypoints, loop_runner
from ekf_slam_tpu_torch.models import loopclosure as lc
from ekf_slam_tpu_torch.models.vss import VSS, VSSConfig
from ekf_slam_tpu_torch.ops import _build, kernels
from ekf_slam_tpu_torch.sim.scene import Scene
from ekf_slam_tpu_torch.profile_slice import (BATCH, FAST_PATHS, FAST_SCENE,
                                              FRAMES, IMAGE_BATCH,
                                              image_config, image_inputs,
                                              slice_config, slice_inputs,
                                              update_form)
from ekf_slam_tpu_torch.vision import frontend, ncc

ROOT = pathlib.Path(__file__).resolve().parent
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
    "ncc_corr_norms": (NCC_SRC, f"{PK}:802"),
    "corr_apply": (UNFUSED_SRC, f"{PK}:741"),
}
# Launches a frame of each path (the rest launch 0 times). The image step
# is branchless: frame 0, with no features yet, launches as many.
PER_FRAME = {
    "fused": {"fused_manage_predict_pht": 1, "fused_update_tail_pht": 1,
              "fused_update_tail_add": 1},
    "unfused": {"corr_apply_cols": 2, "f32_matmul_big": 3},
    "unfused_pallas": {"fused_update_tail": 2, "f32_matmul_big": 3},
    # RANSAC's P·G, the IEKF's 3 + 1 P·Hᵀ, the HI update's; two tails.
    "iekf": {"corr_apply_cols": 2, "f32_matmul_big": 6},
    "image": {"ncc_corr_norms": 1, "corr_apply_cols": 2,
              "f32_matmul_big": 3},
    "image_descriptor": {"corr_apply_cols": 2, "f32_matmul_big": 3},
    "fast": {"corr_apply_cols": 2, "f32_matmul_big": 3},
    "fast_rows": {"corr_apply": 2},
}
SIM_PATHS = ("fused", "unfused", "unfused_pallas", "iekf")
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
# EᵀCE as [E; V]ᵀ[V; E] with V = U + ½·C·E: 4r an entry and 2r²D for V;
# K4's ½(A·Bᵀ + B·Aᵀ) and K8's ½(AtᵀBt + BtᵀAt) in "expr" / "full": 4R;
# K8's AtᵀBt in "none", not symmetric: 2R an entry over all D² entries),
# the low-rank factors dense, as the kernels compute them. K7's norms, a
# pair, the least that direct sums need (no running sums): W2² each for
# the mean, the centring, the squares and Σwc²; t − 1 adds for each row
# sum of wc and of wc² (W2·R2 of each) and for each column sum of those
# (R2² of each); 4 an offset for the variance.
def _ncc_flops(win, tm, norms: bool) -> int:
    N, W2, t = win.shape[0], win.shape[-1], tm.shape[-1]
    R2 = W2 - t + 1
    corr = 2 * N * R2 ** 2 * t ** 2
    if not norms:
        return corr
    return corr + N * (4 * W2 ** 2 + 2 * (t - 1) * (W2 * R2 + R2 ** 2)
                       + 4 * R2 ** 2)


FLOPS = {
    "fused_manage_predict_pht": lambda P, keep, E6, U6, C66, F13, Q13, Ht:
        P.shape[0] * (2 * P.shape[1] ** 2 * Ht.shape[2]
                      + 4 * _sym(P.shape[1]) * E6.shape[1]
                      + 2 * E6.shape[1] ** 2 * P.shape[1]
                      + 4 * 13 * 13 * P.shape[1]),
    "fused_update_tail_pht": lambda P, K, PHt, Jq4, Ht:
        P.shape[0] * (4 * _sym(P.shape[1]) * K.shape[2]
                      + 2 * P.shape[1] ** 2 * Ht.shape[2]
                      + 4 * 4 * 4 * P.shape[1]),
    "fused_update_tail_add": lambda P, K, PHt, Jq4, keepN, EN, UN, CN:
        P.shape[0] * (4 * _sym(P.shape[1]) * K.shape[2]
                      + 4 * _sym(P.shape[1]) * EN.shape[1]
                      + 2 * EN.shape[1] ** 2 * P.shape[1]
                      + 4 * 4 * 4 * P.shape[1]),
    "corr_apply_cols": lambda P, A, B:
        P.shape[0] * 4 * _sym(P.shape[1]) * A.shape[2],
    "fused_update_tail": lambda P, K, PHt, Jq4:
        P.shape[0] * (4 * _sym(P.shape[1]) * K.shape[2]
                      + 4 * 4 * 4 * P.shape[1]),
    "f32_matmul_big": lambda A, B:
        2 * A.shape[0] * A.shape[1] * A.shape[2] * B.shape[2],
    "ncc_corr": lambda win, tm: _ncc_flops(win, tm, False),
    "ncc_corr_norms": lambda win, tm: _ncc_flops(win, tm, True),
    "corr_apply": lambda P, At, Bt, mode:
        P.shape[0] * (2 * P.shape[1] ** 2 * At.shape[1] if mode == "none"
                      else 4 * _sym(P.shape[1]) * At.shape[1]),
}
# One PyTorch call that computes the kernel's function, where there is
# one: timed beside the kernel, never called by the port. Its bf16
# operands are upcast to f32 first, outside the timing (no library call
# takes a bf16 P with f32 products). K8's is its "expr" mode, the JAX XLA
# form P + ½[At;Bt]ᵀ[Bt;At] (ekf.py:579-582); K4's the same form on its
# column factors, P + ½[A B][B A]ᵀ: K4's function on a symmetric P, which
# the path's P is.
LIBRARY = {
    "corr_apply_cols": lambda P, A, B: torch.baddbmm(
        P, torch.cat([A, B], 2), torch.cat([B, A], 2).transpose(1, 2),
        alpha=0.5),
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
# K7's norms form, f32 against its f64 plain version: each window's Σwc²
# (a sum of W2² squares) within this share.
ENERGY_RTOL = 1e-5


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
    bound ‖window patch‖·‖template‖ (kernels.ncc_error; for the norms
    form, of its correlation)."""
    if name == "ncc_corr":
        return kernels.ncc_error(out, ref, *args)
    if name == "ncc_corr_norms":
        return kernels.ncc_error(out[0], ref[0], *args)
    if name == "f32_matmul_big":
        A = args[0].double()
        return kernels.product_error(out, ref, torch.diagonal(
            A, dim1=1, dim2=2), args[1])
    Ht = args[-1] if name in ("fused_manage_predict_pht",
                              "fused_update_tail_pht") else None
    return kernels.scaled_error(out, ref, Ht)


def check_kernel(name, args, site="") -> dict:
    """One kernel against its plain version on the card: errors (kernel
    vs f64 plain on the same inputs, limit kernels.SCALED_TOL; K7's norms
    form also its variance stray, limit ncc.FLAT_EPS, and its energies'
    error, limit ENERGY_RTOL), CUDA-event times of kernel, plain and
    library call, max|P−Pᵀ| of the P output."""
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
        x_bound=f"{ms / bound_ms:.2f}",
        x_library="none" if library_ms is None else f"{ms / library_ms:.2f}",
        gflop=f"{flops / 1e9:.4f}", mbytes=f"{nbytes / 1e6:.2f}")
    if library_ms is not None:
        fields["library_abs_err"] = f"{lib_err:.3e}"
    if name not in ("f32_matmul_big", "ncc_corr", "ncc_corr_norms"):
        fields["asym"] = f"{max_asym(outs[0]):.3e}"
    norms = {}
    if name == "ncc_corr_norms":
        norms = {"var_stray": kernels.var_stray(outs[1], refs[1], refs[2]),
                 "energy_rel_err": kernels.energy_error(outs[2], refs[2])}
        fields.update(var_stray=f"{norms['var_stray']:.4f}",
                      var_limit=ncc.FLAT_EPS,
                      energy_rel_err=f"{norms['energy_rel_err']:.3e}")
    phase("kernel", **fields)
    if not err <= kernels.SCALED_TOL:
        raise AssertionError(f"{name} {site}: kernel vs plain {err:.3e} > "
                             f"{kernels.SCALED_TOL}")
    if norms and not (norms["var_stray"] < ncc.FLAT_EPS
                      and norms["energy_rel_err"] <= ENERGY_RTOL):
        raise AssertionError(f"{name} {site}: norms off their limits: "
                             f"{norms}")
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
            "library_ms": library_ms, **norms}


def planted_fault(tag, got, ref, err_fn, limit=kernels.SCALED_TOL) -> None:
    """A kernel launched with a planted fault must read > 100x the limit."""
    fault = err_fn(got, ref)
    phase("fault", planted=tag, scaled_err=f"{fault:.3e}", limit=limit)
    if not fault > 100 * limit:
        raise AssertionError(f"the check misses {tag}: {fault:.3e}")


def flat_stray(win, t) -> None:
    """The largest stray of the plain version's f32 patch variance
    (ncc.patch_variance, integral images, on the card: the CPU path's
    norms) from its f64 value over the frame's windows, in units of
    eps·Σwc² (kernels.var_stray): it must stay below ncc.FLAT_EPS, the
    floor under which ncc_scores_all scores a patch as flat."""
    var32, _ = ncc.patch_variance(win, t)
    var64, energy = ncc.patch_variance(win.double(), t)
    stray = kernels.var_stray(var32, var64, energy)
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
    check_loop(dev, card, {k["name"]: k for k in report})
    check_drivers(dev, card)
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
    # K2 composed of its pass and K6's product: the product reading the P
    # before the tail instead of the P it wrote
    args = inputs["fused_update_tail_pht"][-1]
    P_li, _ = kernels.fused_update_tail_pht(*args)
    planted_fault(
        "K2_product_of_P_before_tail",
        (P_li, kernels.f32_matmul_big(args[0], args[4])),
        kernels.update_tail_pht_plain(*(a.double() for a in args)),
        lambda g, r: kernels.scaled_error(g, r, args[4]))
    args = inputs["fused_update_tail_add"][-1]
    P, keepN = args[0], args[4]
    if not bool((keepN == 0).any()):
        raise AssertionError("the fused frame adds no feature: K3's keep "
                             "fault needs one")
    stale = kernels.stale_slots(P, keepN)
    planted_fault(
        "K3_with_keep_all_ones",
        kernels.fused_update_tail_add(stale, *args[1:4],
                                      torch.ones_like(keepN), *args[5:]),
        kernels.update_tail_add_plain(*(a.double() for a in (stale,)
                                        + args[1:])),
        kernels.scaled_error)
    out = kernels.fused_update_tail_add(0.5 * (P + P.transpose(1, 2)),
                                        *args[1:])
    if not torch.equal(out, out.transpose(1, 2)):
        raise AssertionError(f"fused_update_tail_add on a symmetric P: "
                             f"max|P−Pᵀ| {max_asym(out)}")

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

    # The IEKF frame: K6 for RANSAC's P·G, then for each of the 3 + 1
    # iterates' P·Hᵀ, then for the HI update's; K4 for the iterated
    # update's tail, then the HI one's.
    inputs = capture_frame(cfgs["iekf"], st0, obs, u)
    calls = {k: len(v) for k, v in inputs.items()}
    if calls != PER_FRAME["iekf"]:
        raise AssertionError(f"iekf frame: kernel calls {calls}, expected "
                             f"{PER_FRAME['iekf']}")
    for name, site, args in (
            ("f32_matmul_big", "iekf_PHt", inputs["f32_matmul_big"][4]),
            ("corr_apply_cols", "iekf_tail", inputs["corr_apply_cols"][0])):
        e = check_kernel(name, args, site)
        report[name]["iekf"] = {k: e[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err", "scaled_err")}

    # The image frame's numerator and norms: all B·CAP windows and
    # templates at once, through both forms of K7.
    inputs = capture_image_frame(icfgs["image"], ist0, iapp0, imgs, iu, dev)
    args = inputs["ncc_corr_norms"][0]
    for name in ("ncc_corr", "ncc_corr_norms"):
        report[name] = check_kernel(name, args, "image")
    win, tm = args
    planted_fault(
        "K7_template_transposed",
        kernels.ncc_corr(win, tm.transpose(1, 2).contiguous()),
        kernels.ncc_corr_plain(win.double(), tm.double()),
        lambda g, r: kernels.ncc_error(g, r, win, tm))
    planted_fault(
        "K7_box_sums_one_row_down",
        kernels.ncc_corr_norms(torch.roll(win, -1, 1).contiguous(), tm)[1],
        kernels.ncc_corr_norms_plain(win.double(), tm.double()),
        lambda g, r: kernels.var_stray(g, r[1], r[2]), limit=ncc.FLAT_EPS)
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

    launches, image_counts = {}, {}
    for path, runs in (("fused", 3), ("unfused", 3), ("unfused_pallas", 1),
                       ("iekf", 3), ("fast", 3), ("fast_rows", 3),
                       ("image", 3), ("image_descriptor", 1)):
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
            if path == "image":
                image_counts = counts
        for name in PER_FRAME[path]:
            launches.setdefault(name, counts[name])
            if path == "iekf":
                report[name]["iekf"]["launches"] = counts[name]
    for name, k in report.items():
        # ncc_corr, on no path since the matcher takes the norms form: its
        # count in the image run, which run_slice held to 0
        k["launches"] = launches.get(name, image_counts[name])

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


# The loop phase: the reference's input size, full width, B instances,
# T frames; the descriptor's cosine card vs CPU.
LOOP_BATCH = 4
LOOP_FRAMES = 128
LOOP_HW = (192, 256)
LOOP_CHECK_FRAMES = 3
LOOP_PROFILE_FRAMES = 8
DESCR_COS = 1 - 1e-5
LOOP_RANGES = ("loop.vss", "loop.query", "loop.fusion")
# bench.py's BENCH_MODE=loop run (bench.py:245-271) and its gates.
LOOP_GATE_ARGS = ["--frontend", "pixels", "--traj", "pan", "--frames", "150",
                  "--ensemble", "4", "--vss-width", "8", "--vss-hw", "48",
                  "64", "--sim-threshold", "0.9", "--min-inliers", "10"]


def loop_inputs(dev):
    """A 128-frame rendered pan (T, B, 192, 256, 3), each instance's frames
    with its own pixel noise; the filter state of the image workload (CAP
    100, D = 613); the model; the LoopConfig."""
    cfg = run_loop_closure.harness_config()
    T, B = LOOP_FRAMES, LOOP_BATCH
    scn = run_loop_closure.make_surround_scene(
        torch.Generator().manual_seed(0), cfg)
    scn = Scene(scn.landmarks.to(dev))
    xs = run_loop_closure.pan_trajectory(cfg, T).to(dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    frames = []
    for t in range(T):
        img = frontend.render_scene_image(scn, xs[t], cfg, dev)
        noisy = torch.clamp(img + 0.02 * torch.randn(
            (B,) + img.shape, generator=gen, device=dev), 0.0, 1.0)
        frames.append(torch.cat([run_loop_closure.to_vss(n, LOOP_HW)
                                 for n in noisy]))
    st = init_state(image_config("descriptor"), B, dev)
    model = VSS(VSSConfig(), LOOP_HW, torch.Generator().manual_seed(0))
    lcfg = lc.LoopConfig(min_db=T // 4, exclude_recent=T // 4)
    return torch.stack(frames), st.x, st.P, model.to(dev), lcfg


def range_device_ms(fn) -> dict:
    """fn() once unprofiled for its wall ms, once under torch.profiler:
    device ms of each LOOP_RANGES range (the kernels of the ops inside
    it) and of all kernels (the ranges' own device annotations left out,
    which span their kernels)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    out = {r: 0.0 for r in LOOP_RANGES}
    by_kernel = collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if e.name not in out:
                by_kernel[e.name[:60]] += e.device_time
        elif e.name in out:
            out[e.name] += e.device_time_total
    return {**{r: v / 1e3 for r, v in out.items()},
            "device": sum(by_kernel.values()) / 1e3, "wall": wall,
            "top": [(n, t / 1e3) for n, t in by_kernel.most_common(6)]}


def same_descriptors(tag, card_model, cpu_model, images) -> None:
    """One frame's descriptors (cosine) and keypoints, card vs CPU."""
    with torch.no_grad():
        a = card_model(images, descriptor_only=True)
        b = cpu_model(images.cpu(), descriptor_only=True)
    cos = torch.nn.functional.cosine_similarity(
        a["descriptor"].cpu().double(), b["descriptor"].double(), dim=1)
    ka = keypoints.kp_descriptor(a["c5"])
    kb = keypoints.kp_descriptor(b["c5"])
    if not (float(cos.min()) >= DESCR_COS
            and torch.equal(ka.yx.cpu(), kb.yx)):
        raise AssertionError(f"{tag}: descriptor cosine {float(cos.min())} "
                             f"or keypoints differ card vs CPU")
    kd = float((ka.descr.cpu() - kb.descr).abs().max())
    phase("loop_check", frame=tag, min_cosine=f"{float(cos.min()):.9f}",
          keypoints="equal", kp_descr_max_abs=f"{kd:.3e}")


def same_query(tag, r_card, r_cpu) -> None:
    """Gate decisions, candidates and best frame equal; similarities within
    1e-5; inlier counts printed (the 8-point solve's eigensolver differs)."""
    for f in ("candidate_ids", "best_id", "is_hypothesis"):
        if not torch.equal(getattr(r_card, f).cpu(), getattr(r_cpu, f)):
            raise AssertionError(f"{tag}: {f} differs card vs CPU")
    fin = torch.isfinite(r_cpu.similarities)
    dsim = float((r_card.similarities.cpu() - r_cpu.similarities)[fin].abs()
                 .max()) if bool(fin.any()) else 0.0
    if not dsim <= 1e-5:
        raise AssertionError(f"{tag}: similarities differ by {dsim}")
    phase("loop_check", frame=tag, gates="equal",
          hypotheses=int(r_cpu.is_hypothesis.sum()), max_dsim=f"{dsim:.3e}",
          inliers_card=r_card.best_inliers.tolist(),
          inliers_cpu=r_cpu.best_inliers.tolist())


def check_loop(dev, card: str, report: dict) -> None:
    """Phase 6: the loop-closure path at full width, its card-vs-CPU
    checks, K4 and K6 on its operands, and bench.py's loop gates."""
    images, x0, P0, model, lcfg = loop_inputs(dev)
    T, B = images.shape[:2]
    gen = torch.Generator(device=dev)

    def run(frames=T):
        return loop_runner.run_online(model, images[:frames], x0, P0, lcfg,
                                      generator=gen.manual_seed(3),
                                      device=dev)

    run(LOOP_CHECK_FRAMES)                               # warm-up
    want = {k: 0 for k in kernels.LAUNCHES}
    want.update(corr_apply_cols=T, f32_matmul_big=T)
    seconds = []
    for _ in range(3):
        db = x = P = out = None
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        db, x, P, out = run()
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        launches = dict(kernels.LAUNCHES)
        if launches != want:
            raise AssertionError(f"loop: kernel launches {launches}, "
                                 f"expected {want}")
    if not (torch.isfinite(x).all() and torch.isfinite(P).all()):
        raise AssertionError("loop: non-finite x or P")
    ids = torch.arange(T, dtype=torch.int32, device=dev)
    if not (bool((db.count == T).all())
            and torch.equal(db.frame_id[:, :T], ids.expand(B, T))
            and bool((db.frame_id[:, T:] == -1).all())):
        raise AssertionError("loop: the DB does not hold frames 0..T-1")
    db_gb = sum(getattr(db, f).numel() * getattr(db, f).element_size()
                for f in lc.DB_FIELDS) / 1e9
    med = statistics.median(seconds)
    prof = range_device_ms(lambda: run(LOOP_PROFILE_FRAMES))
    if not all(prof[r] > 0 for r in LOOP_RANGES):
        raise AssertionError(f"loop: the profiler shows no device time in "
                             f"a range: {prof}")
    split = {r.split(".")[1] + "_ms": f"{prof[r] / LOOP_PROFILE_FRAMES:.4f}"
             for r in LOOP_RANGES}
    phase("loop", batch=B, frames=T, hw="x".join(map(str, LOOP_HW)),
          width=model.cfg.width, capacity=lcfg.capacity, top_k=lcfg.top_k,
          hypotheses=lcfg.ransac_hypotheses,
          reduced=f"min_db={lcfg.min_db},exclude_recent={lcfg.exclude_recent}"
                  f" (T//4; LoopConfig 400/200)",
          db_gb=f"{db_gb:.3f}",
          seconds=",".join(f"{s:.4f}" for s in seconds),
          median_frames_per_s=f"{B * T / med:.2f}",
          spread_frames_per_s=f"{B * T / max(seconds):.2f}-"
                              f"{B * T / min(seconds):.2f}",
          **split,
          device_ms_per_frame=f"{prof['device'] / LOOP_PROFILE_FRAMES:.4f}",
          busy=f"{prof['device'] / prof['wall']:.3f}",
          declared=int(out.declared.sum()),
          launches=json.dumps({k: v for k, v in launches.items() if v},
                              separators=(",", ":")), card=repr(card))
    for name, ms in prof["top"]:
        phase("loop_top", ms_per_frame=f"{ms / LOOP_PROFILE_FRAMES:.4f}",
              kernel=repr(name))

    # The first frames, then one query against the warm DB: card vs CPU.
    cpu_model = VSS(VSSConfig(), LOOP_HW).to("cpu")
    cpu_model.load_state_dict(model.state_dict())
    for t in range(LOOP_CHECK_FRAMES):
        same_descriptors(str(t), model, cpu_model, images[t])
    K = model.num_kp
    draws = torch.rand(LOOP_CHECK_FRAMES, B, lcfg.top_k,
                       lcfg.ransac_hypotheses, K,
                       generator=torch.Generator().manual_seed(5))
    _, _, _, o_card = loop_runner.run_online(
        model, images[:LOOP_CHECK_FRAMES], x0, P0, lcfg, draws, device=dev)
    _, _, _, o_cpu = loop_runner.run_online(
        cpu_model, images[:LOOP_CHECK_FRAMES].cpu(), x0.cpu(), P0.cpu(),
        lcfg, draws, device="cpu")
    for f in ("declared", "match_id"):
        if not torch.equal(getattr(o_card, f).cpu(), getattr(o_cpu, f)):
            raise AssertionError(f"loop: {f} of the first frames differs "
                                 f"card vs CPU")
    phase("loop_check", frame=f"0-{LOOP_CHECK_FRAMES - 1}", declared="equal",
          match_id="equal")
    with torch.no_grad():
        q = model(images[-1], descriptor_only=True)
    kp = keypoints.kp_descriptor(q["c5"])
    qd = draws[0]
    r_card = lc.query(db, q["descriptor"], kp, lcfg, qd.to(dev))
    db_cpu = db.to("cpu")
    r_cpu = lc.query(db_cpu, q["descriptor"].cpu(),
                     keypoints.Keypoints(*(f.cpu() for f in kp)), lcfg, qd)
    same_query(f"{T - 1}_warm_db", r_card, r_cpu)
    del db_cpu

    # K4 and K6 on the pose constraint's operands (all instances enabled,
    # against the stored pose of frame 0).
    sp, sr = loop_fusion.loop_noise_sigmas(r_card.best_inliers)
    with kernels.capture_operands() as inputs:
        loop_fusion.apply_loop_constraint_pose(
            x, P, db.pose[:, 0].to(x.dtype), sp, sr,
            torch.ones(B, dtype=torch.bool, device=dev))
    for name, site in (("corr_apply_cols", "loop_pose"),
                       ("f32_matmul_big", "loop_PHt")):
        e = check_kernel(name, inputs[name][0], site)
        report[name]["loop"] = {k: e[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err", "scaled_err")}
        report[name]["loop"]["launches"] = launches[name]
    del db, images

    # bench.py's loop gate through the port's harness.
    t0 = time.perf_counter()
    s = run_loop_closure.main(LOOP_GATE_ARGS + [
        "--out", "build/loop_gate", "--json", "build/loop_gate/summary.json"])
    gates = {"loops_declared": s["n_loops_total"] > 0,
             "ate_on_le_1.05x_off": s["ate_on_p50"] <= 1.05 * s["ate_off_p50"],
             "final_on_le_0.5x_off":
                 s["final_on_p50"] <= 0.5 * s["final_off_p50"]}
    rescue = s["final_off_p50"] / max(s["final_on_p50"], 1e-9)
    phase("loop_gate", seconds=f"{time.perf_counter() - t0:.1f}",
          ate_off_p50=f"{s['ate_off_p50']:.4f}",
          ate_on_p50=f"{s['ate_on_p50']:.4f}",
          final_off_p50=f"{s['final_off_p50']:.4f}",
          final_on_p50=f"{s['final_on_p50']:.4f}",
          n_loops_total=s["n_loops_total"],
          improvement=f"{rescue:.2f}",
          gates=json.dumps(gates, separators=(",", ":")))
    if not all(gates.values()):
        raise AssertionError(f"loop gate failed: {gates}")


# The drivers phase: a rendered KITTI-layout sequence, and the drivers'
# arguments besides --pattern / --poses / --out.
DRIVER_FRAMES = 32
SEQUENCE_ARGS = ["--mode", "sequence", "--batch", "128", "--capacity",
                 "100"]
SIM_ARGS = ["--mode", "sim", "--batch", "128", "--capacity", "100"]


def write_kitti_sequence(d: pathlib.Path, frames: int, dev) -> None:
    """A 400° pan over run_loop_closure's surround scene in KITTI layout:
    %06d.pgm frames (8-bit) and poses.txt, rendered on `dev`."""
    cfg = run_loop_closure.harness_config()
    scn = run_loop_closure.make_surround_scene(
        torch.Generator().manual_seed(0), cfg)
    scn = Scene(scn.landmarks.to(dev))
    xs = run_loop_closure.pan_trajectory(cfg, frames, total_deg=400.0)
    for t in range(frames):
        img = frontend.render_scene_image(scn, xs[t].to(dev), cfg, dev)
        write_pgm(str(d / f"{t:06d}.pgm"),
                  (img.cpu().numpy() * 255).astype("uint8"))
    save_trajectory_kitti(str(d / "poses.txt"), xs[:, :7].double().numpy())


def run_driver(module: str, args: list) -> tuple:
    """python -m ekf_slam_tpu_torch.<module> args in a process of its own
    from the repository root; raises unless it exits 0. Returns (stdout,
    seconds)."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", f"ekf_slam_tpu_torch.{module}"]
                       + args, cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    seconds = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"{module} {' '.join(args)}: exit "
                             f"{r.returncode}\n{r.stderr[-3000:]}")
    return r.stdout, seconds


def driver_launches(stdout: str, path: str) -> dict:
    """The kernel launches run_slam printed; raises unless they are the
    path's per-frame counts (PER_FRAME) over DRIVER_FRAMES frames."""
    got = json.loads(re.findall(r"kernel launches (\{.*\})", stdout)[-1])
    want = {k: v * DRIVER_FRAMES for k, v in PER_FRAME[path].items()}
    if got != want:
        raise AssertionError(f"run_slam ({path}): kernel launches {got}, "
                             f"expected {want}")
    return got


def rate(stdout: str, unit: str) -> float:
    """The driver's last '-> N <unit>' figure."""
    return float(re.findall(rf"-> ([0-9.]+) {unit}", stdout)[-1])


def check_drivers(dev, card: str) -> None:
    """Phase 7: the drivers as a user starts them, on a rendered sequence
    in KITTI layout."""
    with tempfile.TemporaryDirectory() as tmp:
        d = pathlib.Path(tmp)
        write_kitti_sequence(d, DRIVER_FRAMES, dev)
        pattern = str(d / "%06d.pgm")
        seq_args = SEQUENCE_ARGS + ["--pattern", pattern, "--frames",
                                    str(DRIVER_FRAMES), "--out",
                                    str(d / "sequence")]
        out, secs = run_driver("run_slam", seq_args)
        if "by the native loader" not in out:
            raise AssertionError(f"run_slam --mode sequence did not load by "
                                 f"the native loader:\n{out[-2000:]}")
        traj = numpy.load(d / "sequence" / "trajectory.npz")["trajectory"]
        metrics = (d / "sequence" / "metrics.jsonl").read_text().splitlines()
        if not (traj.shape == (DRIVER_FRAMES, 13)
                and numpy.isfinite(traj).all()
                and len(metrics) == DRIVER_FRAMES):
            raise AssertionError(f"run_slam --mode sequence: trajectory "
                                 f"{traj.shape}, {len(metrics)} metrics rows")
        # The same frames decoded here, the driver's draws: frontend
        # .run_images in this process.
        args = run_slam.parse_args(seq_args)
        cfg = run_slam.slam_config(args)
        seq = ImageSequence(pattern, 0, DRIVER_FRAMES)
        imgs = torch.from_numpy(seq.load(0, DRIVER_FRAMES))
        seq.close()
        u = torch.stack([run_slam.frame_draws(cfg, args.batch, t, dev)
                         for t in range(DRIVER_FRAMES)])
        _, _, ref, _ = frontend.run_images(
            init_state(cfg, args.batch, dev),
            frontend.init_appearance(cfg, args.batch, dev), imgs, u, cfg, dev)
        ref = ref[0].double().cpu().numpy()
        dx = float(numpy.abs(traj - ref).max())
        scale = float(numpy.abs(ref).max())
        if not dx <= X_RTOL * scale:
            raise AssertionError(f"run_slam --mode sequence vs run_images: "
                                 f"x differs by {dx:.3e} > {X_RTOL} * "
                                 f"{scale:.3e}")
        launches = driver_launches(out, "image_descriptor")
        phase("drivers", driver="run_slam", mode="sequence",
              batch=args.batch, frames=DRIVER_FRAMES, loader="native",
              seconds=f"{secs:.2f}", steps_per_s=rate(out, "steps/s"),
              max_dx_vs_run_images=f"{dx:.3e}", max_abs_x=f"{scale:.3e}",
              route="unfused (step_image)", launches=json.dumps(
                  launches, separators=(",", ":")), card=repr(card))

        sim_args = SIM_ARGS + ["--frames", str(DRIVER_FRAMES), "--out",
                               str(d / "sim")]
        out, secs = run_driver("run_slam", sim_args)
        dat = numpy.load(d / "sim" / "trajectory.npz")
        if not (dat["trajectory"].shape == (DRIVER_FRAMES, 13)
                and numpy.isfinite(dat["trajectory"]).all()
                and (d / "sim" / "metrics.jsonl").exists()):
            raise AssertionError("run_slam --mode sim: artifacts")
        fused = engine._use_fused(run_slam.slam_config(
            run_slam.parse_args(sim_args)), dev)
        launches = driver_launches(out, "fused" if fused else "unfused")
        ate = re.findall(r"ATE \(SE3-aligned\) ([0-9.]+)", out)
        phase("drivers", driver="run_slam", mode="sim",
              batch=run_slam.parse_args(sim_args).batch,
              frames=DRIVER_FRAMES, seconds=f"{secs:.2f}",
              steps_per_s=rate(out, "steps/s"), ate=ate[-1],
              route="fused (K1-K3)" if fused else "unfused (K4, K6)",
              launches=json.dumps(launches, separators=(",", ":")),
              card=repr(card))

        out, secs = run_driver("close_loops", [
            "--poses", str(d / "poses.txt"), "--pattern", pattern,
            "--out", str(d / "loops")])
        if "by the native loader" not in out:
            raise AssertionError("close_loops did not load by the native "
                                 "loader")
        poses = numpy.loadtxt(d / "loops" / "kitti_traj.txt")
        q_times = numpy.loadtxt(d / "loops" / "kitti_q_times.txt")
        loops = (d / "loops" / "kitti_loops.txt").read_text().splitlines()
        if not (poses.shape == (DRIVER_FRAMES, 12)
                and q_times.shape == (DRIVER_FRAMES, 3)
                and numpy.isfinite(poses).all()
                and numpy.isfinite(q_times).all()
                and all(len(r.split()) == 16 for r in loops)):
            raise AssertionError("close_loops: artifacts")
        phase("drivers", driver="close_loops", frames=DRIVER_FRAMES,
              seconds=f"{secs:.2f}", frames_per_s=rate(out, "frames/s"),
              loops=len(loops), loader="native", card=repr(card))


if __name__ == "__main__":
    main()
