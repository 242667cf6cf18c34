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
               x_bound and x_library are the kernel's time over each.
               eight_point_fit, whose operands exist only in phase 6, is
               checked there (below)
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
                 image_exact, image_none     the same, with the template
                        warp's per-pixel distortion round trip and with
                        none (VisionConfig.warp_distortion; "affine" above)
                 image  descriptor matcher   K4 2x, K6 3x a frame
               finite state, update cap never hit, tracking error < 0.5,
               the search radius the χ² gate needed beside R. Every other
               kernel launched 0 times; steps/s of the median of three
               timed runs (fused, (i), iekf, image NCC in its three warp
               forms, each form's beside "affine"'s: `[warp]`) or of one.
               Each path runs eager (eager=True: `[slice]`) and then
               replayed from the same inputs (the drivers' default on the
               card: one frame captured as a CUDA graph, filter/graph.py):
               capture_s (warm-up frames and capture) apart from the timed
               runs, the same launch counts, the same gates, the final
               state, trajectory and every StepInfo field of the last
               replayed run equal to the last eager run's bit for bit, one
               replayed frame under torch.profiler with one
               cudaGraphLaunch, no kernel launched from the host and the
               path's kernels (k1p_kernel ... k8_kernel) among its device
               events; one eager frame under
               torch.cuda.set_sync_debug_mode("error"): `[graph]`, eager
               and replayed steps/s and their ratio
  5. crosscheck one frame of each path (the IEKF's and the image path's
               with the "exact" warp too) with CUDA tensors vs the same frame
               on the CPU (plain path), and the same frame through the
               fused and the unfused step, and through the fast mode's row
               and column forms, on the card: equal gate counts, x and P
               within tolerance; then ekf._spd_inverse on batches mixing
               SPD and indefinite S (2 x 2 and 128 x 128): all NaN
               exactly on the indefinite entries, the CPU's inverse on
               the others (SPD_RTOL)
  6. loop      the CALC2 loop-closure path (models/loop_runner.run_online)
               at full width: VSS(VSSConfig()), width 32 at 192x256, with
               the port's own seeded weights, over a 128-frame rendered pan
               at B = 4 with LoopConfig's defaults (capacity 4096, top_k 7,
               64 hypotheses, ratio 0.7, consistency 7 / 9) except min_db
               and exclude_recent, cut to T // 4 (printed as `reduced`):
               x and P finite, the DB holding frames 0..T-1, K4 and K6
               (the pose constraint's masked ekf.update) and
               eight_point_fit (RANSAC's 8-point solve) once a frame and
               no other kernel; eager (eager=True, `[loop]`): frames/s of
               the median of three runs, device ms a frame of the VSS, the
               query and the fusion (torch.profiler, 8 frames); one
               eager frame under torch.cuda.set_sync_debug_mode("error");
               then replayed
               (run_online's default on the card: one frame captured as
               a CUDA graph, the ring's store used in place; `[loop_graph]`):
               three runs from the same generator state, the last equal to
               the last eager run bit for bit (every LoopStepOut field, x,
               P and every database field), frames/s beside eager's,
               capture_s (captured for each call: the ring is the
               caller's), device ms a frame of a profiled 128-frame
               call, the peak device memory each route's run adds. The
               first 3 frames and one query against the warm DB on the card vs
               the CPU: descriptor cosine >= 1 - 1e-5, keypoints, candidates
               and gate decisions equal (the kernel against LAPACK; inlier
               counts printed). eight_point_fit on that query's 1,792
               8-point systems against its f64 plain version: F₂ within
               kernels.EIGHT_POINT_TOL of each system's eigengap bound
               (kernels.eight_point_error), its eigenvector's Rayleigh
               quotient within EIGHT_POINT_RAYLEIGH_TOL of λ₁ (in ε·‖S‖₂),
               the f32 cuSOLVER pair's (its plain version and library
               call) errors beside, its time also over 20 launches
               replayed from one CUDA graph (graph_ms: no host cost); the
               same on instance 0's 448 systems, the loop gate's size
               (site loop_gate_size); at both sites the eigenvector of
               the largest eigenvalue (the kernel on −M) must read > 100x
               both limits. K4 and K6 on the constraint's
               operands against their plain versions. Then bench.py's
               BENCH_MODE=loop protocol through the port's harness
               (run_loop_closure.main: pixels front-end, pan, 150 frames,
               4 seeds, width 8 at 48x64, sim_threshold 0.9, min_inliers
               10), replayed (its default on the card: each frame the
               filter's, the embed and the query piece replayed from CUDA
               graphs, the fusion eager on a declared frame), and its
               three gates: loops declared, ATE with fusion <= 1.05x
               without, final position error with fusion <= 0.5x without;
               then seed 0 again in the eager loop (eager=True), whose
               loops, ATE and final errors must equal the replayed seed's
               bit for bit; frames/s of both, the last capture's seconds.
  7. drivers   a 32-frame KITTI-layout sequence rendered by the port (the
               pan of run_loop_closure, %06d.pgm frames and poses.txt)
               into a temporary directory, then, each a process of its
               own on the card: python -m ekf_slam_tpu_torch.run_slam
               --mode sequence and --mode sim at --batch 128 --capacity
               100, and python -m ekf_slam_tpu_torch.close_loops on it.
               Exit 0, the artifacts present and finite, the native
               loader in use, and the sequence run's trajectory equal bit
               for bit to frontend.run_images run here on the same
               decoded frames with the driver's draws (both replay one
               captured frame); run_slam's kernel launches (it prints
               ops/kernels.LAUNCHES) those of its path: the descriptor
               image step (K4 2x, K6 3x a frame) and the fused step
               (K1-K3 once a frame) at this config; steps/s (frames/s)
               and seconds of each. Then run_slam --mode sequence and
               close_loops each twice in this process, eager
               (main(..., eager=True)) and replayed: the same trajectory,
               metrics.jsonl and launches (run_slam), the same loops and
               artifacts but the query seconds (close_loops), as the
               process's; steps/s (frames/s) of each route; close_loops'
               declared loops (query frame, matched frame) and their
               inlier counts (the 8-point solve decides them on a pure
               rotation).
  8. train     CALC2 training at full width: VSS(VSSConfig()) (width 32)
               and TrainConfig()'s defaults (batch 12, 192x256, triplet)
               on synthetic_batch scenes drawn on the card at 320x320
               (every step crops): 3 warm-up steps, then three timed
               windows of 7 steps (steps/s and images/s, median and
               spread), one profiled step (device ms of augment, forward,
               optimizer, the backward the rest), the peak of
               max_memory_allocated; every metric finite, the last five
               steps' mean loss below the first five's, every weight and
               running statistic moved. One step at width 8, 48x64,
               batch 4 on the card vs the CPU with the same weights and
               draws (metrics to TRAIN_METRIC_RTOL, Adam's first moment
               to TRAIN_MU_TOL). evaluate_pairs on 32 eval_view pairs at
               severity 0 and 1 before and after training, a G-CALC2
               re-rank (top 5) on 16: PR-AUCs in [0, 1]. Then, as
               processes, train_calc2 --steps 20 (width 8, 48x64) into a
               temporary directory, its ckpt_final restored here (the
               same descriptors by both loaders, the PR-AUC it printed),
               and run_loop_closure --ckpt at phase 6's gate protocol with
               --lc-severity 0.5: exit 0, finite artifacts, K4 and K6
               launched (their counts go into the JSON line as
               "ckpt_loop"). Then the bf16 VSS (`[train_bf16]`): the
               full-width train step at compute_dtype "bfloat16" beside
               f32 from the same weights and batches (steps/s, images/s,
               device ms a step, peak memory), and the f32-vs-bf16
               descriptor cosine on phase 6's first 16 pan frames.
  9. parallel  the multi-process layer (ekf_slam_tpu_torch.parallel): two
               gloo ranks sharing the card (one spawn; gloo's collectives
               on CUDA tensors probed first), each leg against its
               single-process run here: (a) run_ensemble of the fused
               slice, data 2; (b) the row-sharded step (K6 on the slab,
               K8's row-slab form for the tails), data 1 x model 2, with
               frames/s beside the unfused (i) run and the largest
               collective against its bound; (c) run_online on the
               capacity-sharded loop DB (phase 6's run, data 2); (d) the
               data-parallel train step at full width, batch 12 as 2 x 6.
               Then leg (a) on one NCCL rank. (K8's row-slab form and K6
               at the slab shape are checked in phase 3 on the unfused
               (i) frame's operands split as leg (b) holds them, with a
               planted fault; their launches in the JSON line are leg
               (b)'s rank 0's.)
 10. golden    the port's unfused step at f32 on the card against the
               float64 oracle on the host (oracle/golden.py: the golden
               config of tests/test_golden_pipeline.py, CAP 20, full-width
               updates, NHYP 16; the port's own scene, B = 4, 10 frames,
               one forced conversion at frame 5; seeds 0-3), both sides on
               the same observations and RANSAC draws: K4 2x and K6 3x a
               frame; n_ic, n_li, n_hi and support equal to the oracle's
               and the RMSE over the camera and the live features within
               golden.GOLDEN_F32_TOL, on the frames before the same seed's
               f32 run on the CPU parts from the oracle (seeds 2, 3: frame
               6, ROADMAP §3); K6 and K4 on a golden frame's operands
               against their plain versions.
Then the card's name and power limit, one JSON line with the kernels'
numbers (K4, K6 and K7's norms form also carry their launches on the
image_exact, image_none and golden runs), and as the last line
{"ok": true, "device": {...}}. Without a CUDA device it fails.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import functools
import io
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
from torch.autograd import DeviceType

from ekf_slam_tpu_torch import (close_loops, run_loop_closure, run_slam,
                                train_calc2)
from ekf_slam_tpu_torch.data import synthetic
from ekf_slam_tpu_torch.filter import ekf, engine, graph, loop_fusion
from ekf_slam_tpu_torch.filter.state import init_state
from ekf_slam_tpu_torch.io import ImageSequence, write_pgm
from ekf_slam_tpu_torch.io.poses import save_trajectory_kitti
from ekf_slam_tpu_torch.kernel_variants import graph_ms
from ekf_slam_tpu_torch.models import (augment, evaluate, keypoints,
                                       loop_runner, train)
from ekf_slam_tpu_torch.models import loopclosure as lc
from ekf_slam_tpu_torch.models.vss import VSS, VSSConfig
from ekf_slam_tpu_torch.ops import _build, kernels
from ekf_slam_tpu_torch.oracle import golden
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
EIGHT_POINT_SRC = "ekf_slam_tpu_torch/csrc/eight_point.cu"
PK = "ekf_slam_tpu/ops/pallas_kernels.py"
# name -> (source, line of the TPU kernel's wrapper it replaces;
# eight_point_fit: of XLA's eigh + svd in the JAX 8-point solve)
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
    "corr_apply_rows": (UNFUSED_SRC, f"{PK}:741"),
    "eight_point_fit": (EIGHT_POINT_SRC,
                        "ekf_slam_tpu/models/loopclosure.py:181"),
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
    "image_exact": {"ncc_corr_norms": 1, "corr_apply_cols": 2,
                    "f32_matmul_big": 3},
    "image_none": {"ncc_corr_norms": 1, "corr_apply_cols": 2,
                   "f32_matmul_big": 3},
    "image_descriptor": {"corr_apply_cols": 2, "f32_matmul_big": 3},
    "fast": {"corr_apply_cols": 2, "f32_matmul_big": 3},
    "fast_rows": {"corr_apply": 2},
}
SIM_PATHS = ("fused", "unfused", "unfused_pallas", "iekf")
# The image path's three template-warp forms (VisionConfig.warp_distortion)
WARP_PATHS = {"image": "affine", "image_exact": "exact",
              "image_none": "none"}
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
    # K8's row-slab form: "none" on the slab's Dl x Dc entries
    "corr_apply_rows": lambda P, At, Bt, r0:
        2 * P.shape[0] * P.shape[1] * P.shape[2] * At.shape[1],
    # eight_point_fit, a matrix: the least its Jacobi needs, one sweep (its
    # convergence test ends the loop where the data allows): the symmetric
    # half (135), the off-diagonal sum (72), 36 rotations of 6 flops on
    # each of 7 (a_kp, a_kq) pairs and 9 rows of the rotations plus 12 for
    # t, c, s and the diagonal; the 3x3's sweep of 3 column pairs (18 for
    # the dot products, 36 for rotating G and W, 12 for the rotation) and
    # the projection (36)
    "eight_point_fit": lambda M: M.shape[0] * (
        135 + 72 + 36 * (6 * 7 + 6 * 9 + 12) + 3 * (18 + 36 + 12) + 36),
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
    "corr_apply_rows": lambda P, At, Bt, r0: torch.baddbmm(
        P, At[:, :, r0:r0 + P.shape[1]].transpose(1, 2), Bt),
    # the batched cuSOLVER pair (torch.linalg.eigh, torch.linalg.svd): the
    # plain version on the card
    "eight_point_fit": kernels.eight_point_fit_plain,
}
# One frame, CUDA vs CPU, both f32: the same math in another summation
# order; the gain solve and the two updates amplify rounding. x within this
# share of max|x|, P entrywise within this many Cauchy-Schwarz bounds (a
# bf16 P beyond one bf16 ulp: two roundings of f32 values that differ in
# their last bits land one bf16 ulp apart, up to 2^-7 of an entry).
X_RTOL = 1e-3
P_TOL = 1e-2
# _spd_inverse card vs CPU on SPD S (f32, condition number < ~10)
SPD_RTOL = 1e-4
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
    if name == "eight_point_fit":
        return kernels.eight_point_error(out, ref, args[0])
    if name == "f32_matmul_big":
        A = args[0].double()
        return kernels.product_error(out, ref, torch.diagonal(
            A, dim1=1, dim2=2), args[1])
    Ht = args[-1] if name in ("fused_manage_predict_pht",
                              "fused_update_tail_pht") else None
    return kernels.scaled_error(out, ref, Ht)


def check_kernel(name, args, site="", err_fn=None) -> dict:
    """One kernel against its plain version on the card: errors (kernel
    vs f64 plain on the same inputs, limit kernels.SCALED_TOL, for
    eight_point_fit kernels.EIGHT_POINT_TOL; K7's norms form also its
    variance stray, limit ncc.FLAT_EPS, and its energies' error, limit
    ENERGY_RTOL; eight_point_fit also its eigenvector's Rayleigh quotient,
    limit kernels.EIGHT_POINT_RAYLEIGH_TOL, and the f32 plain version's
    errors),
    CUDA-event times of kernel, plain and library call, max|P−Pᵀ| of the P
    output. err_fn(out, ref) replaces kernel_error where the bounds need
    more than the operands (a slab of P)."""
    wrapper, plain = getattr(kernels, name), kernels.PLAIN[name]
    limit = (kernels.EIGHT_POINT_TOL if name == "eight_point_fit"
             else kernels.SCALED_TOL)
    out = wrapper(*args)
    torch.cuda.synchronize()
    ref = plain(*(a.double() if isinstance(a, torch.Tensor) else a
                  for a in args))
    err = (kernel_error(name, out, ref, args) if err_fn is None
           else err_fn(out, ref))
    if name == "eight_point_fit":       # F₂'s sign is the solver's choice
        out = kernels.align_sign(out, ref)
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
        lib_out = library(*lib_args)
        if name == "eight_point_fit":
            lib_out = kernels.align_sign(lib_out, ref)
        lib_err = float((lib_out.double() - refs[0]).abs().max())
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
    if name not in ("f32_matmul_big", "ncc_corr", "ncc_corr_norms",
                    "corr_apply_rows", "eight_point_fit"):
        fields["asym"] = f"{max_asym(outs[0]):.3e}"
    norms = {}
    if name == "ncc_corr_norms":
        norms = {"var_stray": kernels.var_stray(outs[1], refs[1], refs[2]),
                 "energy_rel_err": kernels.energy_error(outs[2], refs[2])}
        fields.update(var_stray=f"{norms['var_stray']:.4f}",
                      var_limit=ncc.FLAT_EPS,
                      energy_rel_err=f"{norms['energy_rel_err']:.3e}")
    if name == "eight_point_fit":       # the f32 cuSOLVER pair's beside
        M = args[0]
        norms = {"graph_ms": graph_ms(lambda: wrapper(*args)),
                 "rayleigh_err": kernels.eight_point_rayleigh(
                     kernels.eight_point_fit(M, eigvec=True)[1], M),
                 "plain_f32_scaled_err": kernels.eight_point_error(
                     lib_out, ref, M),
                 "plain_f32_rayleigh_err": kernels.eight_point_rayleigh(
                     kernels.eight_point_fit_plain(M, eigvec=True)[1], M)}
        fields.update(err_limit=limit, **{k: f"{v:.3e}"
                                          for k, v in norms.items()},
                      rayleigh_limit=kernels.EIGHT_POINT_RAYLEIGH_TOL,
                      graph_x_bound=f"{norms['graph_ms'] / bound_ms:.2f}")
        fields["graph_ms"] = f"{norms['graph_ms']:.4f}"
    phase("kernel", **fields)
    if not err <= limit:
        raise AssertionError(f"{name} {site}: kernel vs plain {err:.3e} > "
                             f"{limit}")
    if name == "eight_point_fit" and not (
            norms["rayleigh_err"] <= kernels.EIGHT_POINT_RAYLEIGH_TOL):
        raise AssertionError(f"{name} {site}: Rayleigh quotient "
                             f"{norms['rayleigh_err']:.3e} > "
                             f"{kernels.EIGHT_POINT_RAYLEIGH_TOL}")
    if name == "ncc_corr_norms" and not (norms["var_stray"] < ncc.FLAT_EPS
                                         and norms["energy_rel_err"]
                                         <= ENERGY_RTOL):
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


# The row-sharded step's split in phase 3 and leg (b) of phase 9.
TP_MODEL = 2


def check_slab_kernels(inputs, report) -> None:
    """Phase 3, the row-sharded step's kernels on the unfused (i) frame's
    operands split as the step holds them at model = TP_MODEL (P padded to
    Dp, slabs of Dp / TP_MODEL rows): K8's row-slab form on the LI tail's
    folded factors (At = Āᵀ, Bt = B̄ᵀ, R = 264) for each slab — bit for bit
    the slab's rows of K8 "none" on the whole P, each entry in units of
    sqrt(P⁺_ii·P⁺_jj) of the whole updated P — and K6 on the first slab
    with the update's Hᵀ (its entries in units of sqrt(P_ii·(HᵀPH)_kk) of
    the whole P), beside torch.bmm; then K8's slab form without the
    renorm rows must fail the check."""
    P, A, Bf = inputs["corr_apply_cols"][0]
    Ht = inputs["f32_matmul_big"][1][1]
    D = P.shape[1]
    Dp = -(-D // TP_MODEL) * TP_MODEL
    Dl, ext = Dp // TP_MODEL, Dp - D
    Pp = F.pad(P, (0, ext, 0, ext))
    At = F.pad(A, (0, 0, 0, ext)).transpose(1, 2).contiguous()
    Bt = F.pad(Bf, (0, 0, 0, ext)).transpose(1, 2).contiguous()
    Htp = F.pad(Ht, (0, 0, 0, ext)).contiguous()
    whole = kernels.corr_apply(Pp, At, Bt, "none")
    diag = (torch.diagonal(Pp.double(), dim1=1, dim2=2)
            + (At.double() * Bt.double()).sum(dim=1)).clamp_min(0)
    for part in range(TP_MODEL):
        r0 = part * Dl
        slab = Pp[:, r0:r0 + Dl].contiguous()
        rows = slice(r0, r0 + Dl)
        e = check_kernel("corr_apply_rows", (slab, At, Bt, r0),
                         f"tp_slab{part}", err_fn=lambda g, r: kernels
                         .entry_error(g.double() - r, diag[:, rows], diag))
        if part == 0:
            report["corr_apply_rows"] = e
        if not torch.equal(kernels.corr_apply_rows(slab, At, Bt, r0),
                           whole[:, rows]):
            raise AssertionError(f"corr_apply_rows slab {part}: not the "
                                 f"rows of K8 none on the whole P")
    slab = Pp[:, :Dl].contiguous()
    Pd = Pp.double()
    hph = (Htp.double() * (Pd @ Htp.double())).sum(dim=1).clamp_min(0)
    pdiag = torch.diagonal(Pd, dim1=1, dim2=2).clamp_min(0)
    e = check_kernel("f32_matmul_big", (slab, Htp), "tp_slab_PHt",
                     err_fn=lambda g, r: kernels.entry_error(
                         g.double() - r, pdiag[:, :Dl], hph))
    report["f32_matmul_big"]["tp_slab"] = {k: e[k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "max_abs_err", "scaled_err")}
    no_renorm = At.clone()
    no_renorm[:, -8:] = 0
    planted_fault(
        "K8_slab_without_renorm_rows",
        kernels.corr_apply_rows(slab, no_renorm, Bt, 0),
        kernels.corr_apply_rows_plain(slab.double(), At.double(),
                                      Bt.double(), 0),
        lambda g, r: kernels.entry_error(g.double() - r, diag[:, :Dl],
                                          diag))


def capture_frame(cfg, st0, obs, u, t=2):
    """{name: [operands of each call]} of frame t of the sequence."""
    st, _, _ = engine.run_sequence(st0, obs.window(0, t), u[:t], cfg,
                                   eager=True)
    with kernels.capture_operands() as inputs:
        engine.step(st, obs.frame(t), u[t], cfg)
    return inputs


def capture_image_frame(cfg, st0, app0, imgs, u, dev, t=2):
    """{name: [operands of each call]} of image frame t of the sequence."""
    st, app, _, _ = frontend.run_images(st0, app0, imgs[:t], u[:t], cfg, dev,
                                        eager=True)
    with kernels.capture_operands() as inputs:
        frontend.step_image(st, app, imgs[t], u[t], cfg)
    return inputs


def slice_gates(path, cfg, result, xs, track_limit) -> tuple:
    """Phase 4's gates on one run's (final state, traj, infos): finite, P
    still bf16 in the fast mode, the update cap never hit, the tracking
    error under its limit. Returns (largest update, tracking error)."""
    final, traj, infos = result
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
    return max_obs, err


def timed_runs(path, run, runs) -> tuple:
    """`runs` timed runs of run(), each with the counts set to 0 just
    before and read just after and held to PER_FRAME x FRAMES. Returns
    (seconds of each, the counts, the last run's result)."""
    want = {k: PER_FRAME[path].get(k, 0) * FRAMES for k in kernels.LAUNCHES}
    seconds = []
    for _ in range(runs):
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        result = run()
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        launches = dict(kernels.LAUNCHES)
        if launches != want:
            raise AssertionError(f"{path}: kernel launches {launches}, "
                                 f"expected {want}")
    return seconds, launches, result


def _bits(t: torch.Tensor) -> torch.Tensor:
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
            torch.float64: torch.int64}
    return t.view(ints[t.dtype]) if t.dtype in ints else t


def same_bits(path, replayed, eager) -> None:
    """Replay against eager from the same inputs: every field of the final
    state, the trajectory and every StepInfo field bit for bit."""
    (fr, tr, ir), (fe, te, ie) = replayed, eager
    pairs = [(f"state.{f}", getattr(fr, f), getattr(fe, f)) for f in (
        "x", "P", "active", "cartesian", "times_predicted", "times_measured",
        "landmark_id")]
    pairs.append(("trajectory", tr, te))
    pairs += [(f"info.{f}", getattr(ir, f), getattr(ie, f))
              for f in engine.StepInfo.__dataclass_fields__]
    for what, a, b in pairs:
        if a.dtype != b.dtype or not torch.equal(_bits(a), _bits(b)):
            raise AssertionError(f"{path}: replay differs from eager in "
                                 f"{what}")


# The symbols of each wrapper's kernels, as the profiler names them.
KERNEL_SYMBOLS = {
    "fused_manage_predict_pht": ("k3v_kernel", "k1p_kernel", "k6_kernel"),
    "fused_update_tail_pht": ("k3_kernel", "k6_kernel"),
    "fused_update_tail_add": ("k3v_kernel", "k3_kernel"),
    "corr_apply_cols": ("k4_kernel",),
    "fused_update_tail": ("k3_kernel",),
    "f32_matmul_big": ("k6_kernel",),
    "ncc_corr_norms": ("k7_kernel",),
    "corr_apply": ("k8_kernel",),
}
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")


def replayed_frame_profile(path) -> dict:
    """One replayed frame (the inputs' copies into the static buffers and
    the graph's launch) of the last captured frame under torch.profiler:
    one cudaGraphLaunch, no kernel launched from the host, and the path's
    kernels among the device events. Raises otherwise."""
    frame = graph.last_captured()
    inputs = tuple(x.clone() for x in frame.inputs)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        frame.step(inputs)
        torch.cuda.synchronize()
    host = collections.Counter(e.name for e in prof.events()
                               if e.device_type != DeviceType.CUDA)
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    names = {e.name for e in device}
    want = sorted({s for k in PER_FRAME[path] for s in KERNEL_SYMBOLS[k]})
    missing = [s for s in want if not any(s + "<" in n or s + "(" in n
                                          for n in names)]
    launched = sum(host[c] for c in LAUNCH_CALLS)
    if host["cudaGraphLaunch"] != 1 or launched or missing:
        raise AssertionError(
            f"{path}: a replayed frame made {host['cudaGraphLaunch']} "
            f"cudaGraphLaunch and {launched} kernel launches from the host; "
            f"kernels missing from its device events: {missing}")
    return {"graph_launches": host["cudaGraphLaunch"],
            "host_kernel_launches": launched,
            "memcpy": host["cudaMemcpyAsync"],
            "device_ops": len(device),
            "device_ms": sum(e.device_time for e in device) / 1e3,
            "kernels": want}


def eager_frame_without_sync(path, one_frame) -> None:
    """One eager frame under torch.cuda.set_sync_debug_mode("error"): any
    call that synchronizes the host with the card raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        one_frame()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def run_slice(path, cfg, run, one_frame, batch, xs, runs, track_limit,
              card) -> dict:
    """Phase 4 for one path, eager and then replayed from the same inputs.
    run(eager) -> (final state, traj, infos) is the path's driver.
    Eager: a warm-up, `runs` timed runs (counts held to PER_FRAME x
    FRAMES), the gates, `[slice]`; one eager frame (one_frame()) under the
    sync debug mode. Replay: the first run captures the frame (capture_s:
    warm-up frames and capture, apart from the runs), then `runs` timed
    runs with the same counts, the gates, the last run equal to the last
    eager run bit for bit, one replayed frame under the profiler,
    `[graph]`. Returns the launch counts and the median eager steps/s."""
    run(True)                                            # warm-up
    seconds, launches, eager = timed_runs(path, lambda: run(True), runs)
    max_obs, err = slice_gates(path, cfg, eager, xs, track_limit)
    rate = batch * FRAMES / statistics.median(seconds)
    final, _, infos = eager
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
    phase("slice", **fields, route="eager", launches=json.dumps(
        {k: v for k, v in launches.items() if v}, separators=(",", ":")),
        card=repr(card))
    eager_frame_without_sync(path, one_frame)

    run(False)                                           # capture
    capture_s = graph.last_captured().capture_s
    r_seconds, r_launches, replayed = timed_runs(path, lambda: run(False),
                                                 runs)
    slice_gates(path, cfg, replayed, xs, track_limit)
    same_bits(path, replayed, eager)
    prof = replayed_frame_profile(path)
    r_rate = batch * FRAMES / statistics.median(r_seconds)
    phase("graph", path=path, batch=batch, frames=FRAMES,
          eager_steps_per_s=f"{rate:.1f}", replay_steps_per_s=f"{r_rate:.1f}",
          replay_vs_eager=f"{r_rate / rate:.3f}",
          capture_s=f"{capture_s:.3f}",
          replay_seconds=",".join(f"{s:.4f}" for s in r_seconds),
          bitwise="true", sync_free_eager_frame="true",
          launches=json.dumps({k: v for k, v in r_launches.items() if v},
                              separators=(",", ":")),
          frame_graph_launches=prof["graph_launches"],
          frame_host_kernel_launches=prof["host_kernel_launches"],
          frame_memcpy=prof["memcpy"], frame_device_ops=prof["device_ops"],
          frame_device_ms=f"{prof['device_ms']:.3f}",
          frame_kernels=",".join(prof["kernels"]), card=repr(card))
    return launches, rate


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
    by_name = {k["name"]: k for k in report}
    loop = check_loop(dev, card, by_name)
    check_drivers(dev, card)
    check_training(dev, card, by_name)
    check_bf16_training(dev, card, loop["frames"])
    check_parallel(dev, card, by_name, loop)
    check_golden(dev, card, by_name)
    print(card, flush=True)
    print(json.dumps({"kernels": list(by_name.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def check_paths(dev, card: str) -> list:
    """Phases 3-5 on device `dev`. Returns the kernels' JSON entries."""
    # -- 3. kernels vs plain on one real frame of each path -------------------
    cfgs = {p: slice_config(p) for p in SIM_PATHS}
    st0, xs, obs, u = slice_inputs(cfgs["fused"], dev)
    icfgs = {path: image_config("ncc", form)
             for path, form in WARP_PATHS.items()}
    icfgs["image_descriptor"] = image_config("descriptor")
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
    check_slab_kernels(inputs, report)
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
            return (lambda eager: engine.run_sequence(
                        fst0, fobs, fu, fcfgs[path], eager=eager),
                    lambda: engine.step(fst0, fobs.frame(0), fu[0],
                                        fcfgs[path]))
        return (lambda eager: engine.run_sequence(st0, obs, u, cfgs[path],
                                                  eager=eager),
                lambda: engine.step(st0, obs.frame(0), u[0], cfgs[path]))

    def image_run(path):
        def run(eager):
            final, _, traj, infos = frontend.run_images(
                ist0, iapp0, imgs, iu, icfgs[path], dev, eager=eager)
            return final, traj, infos
        return run, lambda: frontend.step_image(ist0, iapp0, imgs[0], iu[0],
                                                icfgs[path])

    launches, image_counts, warp_rates = {}, {}, {}
    for path, runs in (("fused", 3), ("unfused", 3), ("unfused_pallas", 1),
                       ("iekf", 3), ("fast", 3), ("fast_rows", 3),
                       ("image", 3), ("image_exact", 3), ("image_none", 3),
                       ("image_descriptor", 1)):
        if path in SIM_PATHS:
            counts, _ = run_slice(path, cfgs[path], *sim_run(path), BATCH,
                                  xs, runs, 0.2, card)
        elif path in FAST_PATHS:
            with update_form(path):
                counts, _ = run_slice(path, fcfgs[path], *sim_run(path),
                                      BATCH, fxs, runs, 0.2, card)
        else:
            counts, rate = run_slice(path, icfgs[path], *image_run(path),
                                     IMAGE_BATCH, ixs, runs, 0.5, card)
            if path == "image":
                image_counts = counts
            if path in WARP_PATHS:
                warp_rates[WARP_PATHS[path]] = rate
        for name in PER_FRAME[path]:
            launches.setdefault(name, counts[name])
            if path == "iekf":
                report[name]["iekf"]["launches"] = counts[name]
            elif path in ("image_exact", "image_none"):
                report[name][path] = {"launches": counts[name]}
    affine = warp_rates["affine"]
    phase("warp", **{f"{form}_steps_per_s": f"{r:.1f}"
                     for form, r in warp_rates.items()},
          **{f"{form}_vs_affine": f"{warp_rates[form] / affine:.3f}"
             for form in ("exact", "none")}, card=repr(card))
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
    card_step = frontend.step_image(ist8, iapp8, imgs[8], iu[8],
                                    icfgs["image_exact"])
    cpu_step = frontend.step_image(ist8.to("cpu"), iapp8.to("cpu"),
                                   imgs[8].cpu(), iu[8].cpu(),
                                   icfgs["image_exact"])
    same_frame("image_exact:cuda_vs_cpu", (card_step[0], card_step[2]),
               (cpu_step[0], cpu_step[2]))
    check_spd_inverse(dev)
    graph.clear()                       # the captured frames' memory pools
    torch.cuda.empty_cache()
    return list(report.values())


def check_spd_inverse(dev) -> None:
    """ekf._spd_inverse on the card of batches mixing SPD and indefinite S
    (a negative pivot at the first, a middle and the last position), 2 x 2
    and 128 x 128, f32: all NaN exactly on the indefinite entries (the
    factor's failure masked, whatever partial factor cuSOLVER leaves), the
    CPU's inverse elsewhere to SPD_RTOL of its largest entry."""
    gen = torch.Generator().manual_seed(8)
    for n in (2, 128):
        A = torch.randn(6, n, n, generator=gen)
        S = A @ A.transpose(1, 2) / n + torch.eye(n)
        bad = {1: 0, 3: n // 2, 5: n - 1}
        for b, k in bad.items():
            S[b, k, k] = -1.0
        on_card = ekf._spd_inverse(S.to(dev)).cpu()
        on_cpu = ekf._spd_inverse(S)
        nan = torch.isnan(on_card).flatten(1).all(1)
        finite = torch.isfinite(on_card).flatten(1).all(1)
        want = torch.zeros(6, dtype=torch.bool)
        want[list(bad)] = True
        if not (torch.equal(nan, want) and torch.equal(finite, ~want)
                and torch.equal(torch.isnan(on_cpu), torch.isnan(on_card))):
            raise AssertionError(f"spd_inverse n={n}: NaN entries "
                                 f"{nan.tolist()}, expected {want.tolist()}")
        good = ~want
        err = float((on_card[good] - on_cpu[good]).abs().max())
        scale = float(on_cpu[good].abs().max())
        if not err <= SPD_RTOL * scale:
            raise AssertionError(f"spd_inverse n={n}: card vs CPU "
                                 f"{err:.3e} > {SPD_RTOL} * {scale:.3e}")
        phase("crosscheck", pair=f"spd_inverse:n={n}",
              nan_entries=",".join(map(str, bad)), max_abs_diff=f"{err:.3e}",
              max_abs=f"{scale:.3e}")


# The loop phase: the reference's input size, full width, B instances,
# T frames; the descriptor's cosine card vs CPU.
LOOP_BATCH = 4
LOOP_FRAMES = 128
LOOP_HW = (192, 256)
LOOP_CHECK_FRAMES = 3
LOOP_PROFILE_FRAMES = 8
LOOP_COSINE_FRAMES = 16         # phase 8's f32-vs-bf16 descriptor cosine
DESCR_COS = 1 - 1e-5
LOOP_RANGES = ("loop.vss", "loop.query", "loop.fusion")
# bench.py's BENCH_MODE=loop run (bench.py:245-271) and its gates.
LOOP_GATE_ARGS = ["--frontend", "pixels", "--traj", "pan", "--frames", "150",
                  "--ensemble", "4", "--vss-width", "8", "--vss-hw", "48",
                  "64", "--sim-threshold", "0.9", "--min-inliers", "10"]


def gate_args(ensemble: int) -> list:
    """LOOP_GATE_ARGS with --ensemble `ensemble`."""
    args = list(LOOP_GATE_ARGS)
    args[args.index("--ensemble") + 1] = str(ensemble)
    return args


def harness_run(argv: list, eager=None) -> tuple:
    """run_loop_closure.main(argv, eager) in this process, its output
    printed as it ends. Returns (its summary, the frames/s it printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        s = run_loop_closure.main(argv, eager=eager)
    print(buf.getvalue(), end="", flush=True)
    return s, rate(buf.getvalue(), "frames/s")


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


def range_device_ms(fn, ranges=LOOP_RANGES) -> dict:
    """fn() once unprofiled for its wall ms, once under torch.profiler:
    device ms of each range in `ranges` (the kernels of the ops inside
    it) and of all device operations (a span's host range leaves no event
    on the device: utils/metrics.py)."""
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
    out = {r: 0.0 for r in ranges}
    by_kernel = collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
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


def timed_loop_runs(tag, run, runs, want) -> tuple:
    """`runs` runs of run() (the 128-frame pan), each with the counts set to
    0 just before and read just after and held to `want`, each the only
    loop run in memory. Returns (seconds of each, the counts, the peak
    device memory a run added (GB, max_memory_allocated over what was
    allocated before it), the last run's (db, x, P, out))."""
    seconds = []
    for _ in range(runs):
        result = None
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        result = run()
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        launches = dict(kernels.LAUNCHES)
        if launches != want:
            raise AssertionError(f"{tag}: kernel launches {launches}, "
                                 f"expected {want}")
    return seconds, launches, peak_gb, result


def loop_bits(replayed, eager) -> None:
    """Replay against eager from the same inputs: every LoopStepOut
    field, x, P and every database field bit for bit."""
    (db_r, x_r, P_r, o_r), (db_e, x_e, P_e, o_e) = replayed, eager
    pairs = [(f"db.{f}", getattr(db_r, f), getattr(db_e, f))
             for f in lc.DB_FIELDS]
    pairs += [("x", x_r, x_e), ("P", P_r, P_e)]
    pairs += [(f"out.{f}", getattr(o_r, f), getattr(o_e, f))
              for f in loop_runner.LoopStepOut._fields]
    for what, a, b in pairs:
        if a.dtype != b.dtype or not torch.equal(_bits(a), _bits(b)):
            raise AssertionError(f"loop: replay differs from eager in {what}")


def check_loop(dev, card: str, report: dict) -> dict:
    """Phase 6: the loop-closure path at full width, eager (`[loop]`) and
    replayed (`[loop_graph]`), its card-vs-CPU checks, eight_point_fit,
    K4 and K6 on its operands, and bench.py's loop gates. Returns the
    first LOOP_COSINE_FRAMES frames of the pan and the outputs of the last
    replayed run (its LoopStepOut, x and P on the CPU), which phases 8 and
    9 reuse."""
    images, x0, P0, model, lcfg = loop_inputs(dev)
    T, B = images.shape[:2]
    gen = torch.Generator(device=dev)

    def run(frames=T, eager=True):
        return loop_runner.run_online(model, images[:frames], x0, P0, lcfg,
                                      generator=gen.manual_seed(3),
                                      device=dev, eager=eager)

    run(LOOP_CHECK_FRAMES)                               # warm-up, each route
    run(LOOP_CHECK_FRAMES, eager=None)
    want = {k: 0 for k in kernels.LAUNCHES}
    want.update(corr_apply_cols=T, f32_matmul_big=T, eight_point_fit=T)
    seconds, launches, peak_e, eager = timed_loop_runs(
        "loop", run, 3, want)
    db, x, P, out = eager
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
          db_gb=f"{db_gb:.3f}", route="eager",
          seconds=",".join(f"{s:.4f}" for s in seconds),
          median_frames_per_s=f"{B * T / med:.2f}",
          spread_frames_per_s=f"{B * T / max(seconds):.2f}-"
                              f"{B * T / min(seconds):.2f}",
          **split,
          device_ms_per_frame=f"{prof['device'] / LOOP_PROFILE_FRAMES:.4f}",
          declared=int(out.declared.sum()),
          launches=json.dumps({k: v for k, v in launches.items() if v},
                              separators=(",", ":")), card=repr(card))
    for name, ms in prof["top"]:
        phase("loop_top", ms_per_frame=f"{ms / LOOP_PROFILE_FRAMES:.4f}",
              kernel=repr(name))

    # One eager frame without a sync, on an empty database of its own.
    frame_fn = loop_runner.make_frame_fn(model, lcfg)
    fresh = lc.init_db(lcfg, B, model.descr_dim, model.num_kp, model.kp_dim,
                       device=dev)
    d0 = lc.ransac_draws(lcfg, B, model.num_kp, gen.manual_seed(3),
                         torch.float32, dev)
    eager_frame_without_sync("loop", lambda: frame_fn(fresh, x0, P0,
                                                      images[0], d0))
    del fresh

    # The replayed route (run_online's default on the card): the same
    # runs from the same generator state, bit for bit.
    r_seconds, r_launches, peak_r, replayed = timed_loop_runs(
        "loop_graph", lambda: run(eager=None), 3, want)
    capture_s = graph.last_capture_s()
    loop_bits(replayed, eager)
    del eager, db
    r_prof = range_device_ms(lambda: run(eager=None), ranges=())
    r_med = statistics.median(r_seconds)
    phase("loop_graph", batch=B, frames=T,
          eager_frames_per_s=f"{B * T / med:.2f}",
          replay_frames_per_s=f"{B * T / r_med:.2f}",
          replay_vs_eager=f"{med / r_med:.3f}",
          replay_seconds=",".join(f"{s:.4f}" for s in r_seconds),
          capture_s=f"{capture_s:.3f}",
          replay_frames_per_s_after_capture=(
              f"{B * T / (r_med - capture_s):.2f}"),
          device_ms_per_frame=f"{r_prof['device'] / T:.4f}",
          peak_gb_eager=f"{peak_e:.3f}", peak_gb_replay=f"{peak_r:.3f}",
          bitwise="true", sync_free_eager_frame="true",
          launches=json.dumps({k: v for k, v in r_launches.items() if v},
                              separators=(",", ":")), card=repr(card))
    db, x, P, out = replayed

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
    with kernels.capture_operands() as inputs:
        r_card = lc.query(db, q["descriptor"], kp, lcfg, qd.to(dev))
    db_cpu = db.to("cpu")
    r_cpu = lc.query(db_cpu, q["descriptor"].cpu(),
                     keypoints.Keypoints(*(f.cpu() for f in kp)), lcfg, qd)
    same_query(f"{T - 1}_warm_db", r_card, r_cpu)
    del db_cpu

    # eight_point_fit on that query's 8-point systems (phase 3's check of
    # the loop path's kernel: its operands exist only here), B·top_k·NH =
    # 1,792 of them, and on instance 0's top_k·NH = 448, the loop gate's
    # size (B = 1); at each, its planted fault: the eigenvector of the
    # largest eigenvalue (−M).
    M_all = inputs["eight_point_fit"][0][0]
    gate_n = lcfg.top_k * lcfg.ransac_hypotheses
    for site, M in (("loop_query", M_all),
                    ("loop_gate_size", M_all[:gate_n].contiguous())):
        e = check_kernel("eight_point_fit", (M,), site)
        ref = kernels.eight_point_fit_plain(M.double())
        largest = kernels.eight_point_fit(-M, eigvec=True)
        planted_fault(f"eight_point_largest_eigenvector_{site}", largest[0],
                      ref, lambda g, r: kernels.eight_point_error(g, r, M),
                      limit=kernels.EIGHT_POINT_TOL)
        planted_fault(f"eight_point_largest_eigenvector_rayleigh_{site}",
                      largest[1], None,
                      lambda g, r: kernels.eight_point_rayleigh(g, M),
                      limit=kernels.EIGHT_POINT_RAYLEIGH_TOL)
        if site == "loop_query":
            e["launches"] = r_launches["eight_point_fit"]
            report["eight_point_fit"] = e
        else:
            report["eight_point_fit"]["gate_size"] = {k: e[k] for k in (
                "ms", "graph_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "max_abs_err", "scaled_err", "rayleigh_err")}

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
        report[name]["loop"]["launches"] = r_launches[name]
    kept = {"frames": images[:LOOP_COSINE_FRAMES].clone(),
            "out": loop_runner.LoopStepOut(*(f.cpu() for f in out)),
            "x": x.cpu(), "P": P.cpu()}
    del db, images

    # bench.py's loop gate through the port's harness, replayed (its
    # default on the card), then seed 0 again in the eager loop.
    s, fps = harness_run(LOOP_GATE_ARGS + [
        "--out", "build/loop_gate", "--json", "build/loop_gate/summary.json"])
    capture_s = graph.last_capture_s()
    gates = {"loops_declared": s["n_loops_total"] > 0,
             "ate_on_le_1.05x_off": s["ate_on_p50"] <= 1.05 * s["ate_off_p50"],
             "final_on_le_0.5x_off":
                 s["final_on_p50"] <= 0.5 * s["final_off_p50"]}
    rescue = s["final_off_p50"] / max(s["final_on_p50"], 1e-9)
    e, e_fps = harness_run(gate_args(ensemble=1) + [
        "--out", "build/loop_gate_eager"], eager=True)
    twin = {k: s["rows"][0][k] == e["rows"][0][k]
            for k in ("loops", "ate_off", "ate_on", "final_off", "final_on")}
    phase("loop_gate", route="replayed", frames_per_s=f"{fps:.2f}",
          eager_seed0_frames_per_s=f"{e_fps:.2f}",
          speedup=f"{fps / e_fps:.3f}",
          last_capture_s=f"{capture_s:.4f}",
          ate_off_p50=f"{s['ate_off_p50']:.4f}",
          ate_on_p50=f"{s['ate_on_p50']:.4f}",
          final_off_p50=f"{s['final_off_p50']:.4f}",
          final_on_p50=f"{s['final_on_p50']:.4f}",
          n_loops_total=s["n_loops_total"],
          improvement=f"{rescue:.2f}",
          gates=json.dumps(gates, separators=(",", ":")),
          eager_seed0_equal=json.dumps(twin, separators=(",", ":")),
          card=repr(card))
    if not all(twin.values()):
        raise AssertionError(f"loop gate: seed 0 eager vs replayed: {twin}")
    if not all(gates.values()):
        raise AssertionError(f"loop gate failed: {gates}")
    return kept


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
        # .run_images in this process (the same captured frame, replayed).
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
        if not numpy.array_equal(traj, ref):
            raise AssertionError(f"run_slam --mode sequence vs run_images: "
                                 f"x differs by "
                                 f"{float(numpy.abs(traj - ref).max()):.3e}")
        launches = driver_launches(out, "image_descriptor")
        # The eager loop and the replay in this process, the same files.
        pair = {}
        for route, eager in (("eager", True), ("replayed", None)):
            o = d / f"sequence_{route}"
            r = run_slam.main(seq_args[:-1] + [str(o)], eager=eager)
            pair[route] = (r, numpy.load(o / "trajectory.npz")["trajectory"],
                           (o / "metrics.jsonl").read_bytes())
            if r["launches"] != launches:
                raise AssertionError(f"run_slam ({route}): launches "
                                     f"{r['launches']} != {launches}")
        (re_, te, me), (rr, tr, mr) = pair["eager"], pair["replayed"]
        if not (numpy.array_equal(te, tr) and numpy.array_equal(tr, traj)
                and me == mr):
            raise AssertionError("run_slam --mode sequence: eager and "
                                 "replayed differ")
        phase("drivers", driver="run_slam", mode="sequence",
              batch=args.batch, frames=DRIVER_FRAMES, loader="native",
              seconds=f"{secs:.2f}", steps_per_s=rate(out, "steps/s"),
              vs_run_images="bitwise",
              eager_steps_per_s=f"{re_['steps_per_s']:.1f}",
              replayed_steps_per_s=f"{rr['steps_per_s']:.1f}",
              speedup=f"{rr['steps_per_s'] / re_['steps_per_s']:.3f}",
              eager_vs_replayed="bitwise (trajectory, metrics.jsonl)",
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

        cl_args = ["--poses", str(d / "poses.txt"), "--pattern", pattern]
        out, secs = run_driver("close_loops", cl_args + ["--out",
                                                         str(d / "loops")])
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
        # The eager pieces and the replayed ones in this process: the same
        # loops and artifacts as the process's (the query seconds apart).
        pair = {}
        for route, eager in (("eager", True), ("replayed", None)):
            o = d / f"loops_{route}"
            r = close_loops.main(cl_args + ["--out", str(o)], eager=eager)
            pair[route] = (r, [(o / n).read_bytes() for n in (
                "kitti_traj.txt", "kitti_loops.txt")], numpy.loadtxt(
                    o / "kitti_q_times.txt")[:, :2])
        want = [(d / "loops" / n).read_bytes() for n in (
            "kitti_traj.txt", "kitti_loops.txt")]
        for route, (r, files, q) in pair.items():
            if not (files == want and numpy.array_equal(q, q_times[:, :2])
                    and r["loops"] == pair["eager"][0]["loops"]):
                raise AssertionError(f"close_loops ({route}): loops or "
                                     f"artifacts differ")
        fe, fr = (pair[k][0]["frames_per_s"] for k in ("eager", "replayed"))
        cap = pair["replayed"][0]["capture_s"]
        phase("drivers", driver="close_loops", frames=DRIVER_FRAMES,
              seconds=f"{secs:.2f}", frames_per_s=rate(out, "frames/s"),
              eager_frames_per_s=f"{fe:.2f}",
              replayed_frames_per_s=f"{fr:.2f}", speedup=f"{fr / fe:.3f}",
              replayed_capture_s=f"{cap:.4f}",
              replayed_frames_per_s_after_capture=
                  f"{DRIVER_FRAMES / (DRIVER_FRAMES / fr - cap):.2f}",
              eager_vs_replayed="equal loops and artifacts",
              query_ms_median=f"{1e3 * numpy.median(q_times[:, 2]):.3f}",
              loops=len(loops), loop_frames=json.dumps(
                  pair["eager"][0]["loops"], separators=(",", ":")),
              loop_inliers=json.dumps(pair["eager"][0]["loop_inliers"],
                                      separators=(",", ":")),
              loader="native", card=repr(card))



# The training phase: TrainConfig's defaults (batch 12, 192x256, triplet)
# on VSS(VSSConfig()) (width 32), fed synthetic scenes drawn on the card
# at the reference's 320x320 shard size, so that every step crops.
TRAIN_DATA_HW = (320, 320)
TRAIN_POOL = 4                  # batches drawn before the timed steps
TRAIN_WARMUP = 3
TRAIN_WINDOWS = 3
TRAIN_WINDOW_STEPS = 7
TRAIN_RANGES = ("train.augment", "train.forward", "train.backward",
                "train.optimizer")
TRAIN_METRIC_RTOL = 1e-4        # card vs CPU step, width 8
TRAIN_MU_TOL = 2e-3             # Adam's first moment, of each tensor's max
EVAL_PAIRS = 32
RERANK_PAIRS = 16


def check_training(dev, card: str, report: dict) -> None:
    """Phase 8: CALC2 training and evaluation at full width, a train step
    card vs CPU, then train_calc2 and run_loop_closure --ckpt as
    processes."""
    tcfg = train.TrainConfig()
    model = VSS(VSSConfig(), tcfg.image_hw,
                torch.Generator().manual_seed(0)).to(dev)
    untrained = copy.deepcopy(model).eval()
    init = {k: v.clone() for k, v in model.state_dict().items()}
    gen = torch.Generator(device=dev).manual_seed(1)
    pool = [synthetic.synthetic_batch(tcfg.batch_size, TRAIN_DATA_HW,
                                      generator=gen)
            for _ in range(TRAIN_POOL)]
    state = train.init_state(model, tcfg)
    draws = torch.Generator(device=dev).manual_seed(2)
    history = []

    def step():
        nonlocal state
        imgs, labels = pool[len(history) % TRAIN_POOL]
        state, m = train.train_step(tcfg, state, imgs, labels,
                                    synthetic.class_weights(labels),
                                    generator=draws)
        history.append(m)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(TRAIN_WARMUP):
        step()
    seconds = []
    for _ in range(TRAIN_WINDOWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TRAIN_WINDOW_STEPS):
            step()
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    prof = range_device_ms(step, TRAIN_RANGES)
    if not all(prof[r] > 0 for r in ("device", "train.forward",
                                     "train.optimizer")):
        raise AssertionError(f"train: the profiler shows no device time: "
                             f"{prof}")
    keys = sorted(history[0])
    table = torch.stack([torch.stack([m[k] for k in keys])
                         for m in history]).cpu()
    if not bool(torch.isfinite(table).all()):
        raise AssertionError("train: a non-finite metric")
    loss = table[:, keys.index("loss")]
    first, last = float(loss[:5].mean()), float(loss[-5:].mean())
    if not last < first:
        raise AssertionError(f"train: the loss did not fall: first five "
                             f"{first:.4f}, last five {last:.4f}")
    sd = model.state_dict()
    stats = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    params = [n for n, _ in model.named_parameters()]
    moved_stats = sum(not torch.equal(sd[k], init[k]) for k in stats)
    moved_params = sum(not torch.equal(sd[k], init[k]) for k in params)
    if moved_stats != len(stats) or moved_params != len(params):
        raise AssertionError(f"train: {moved_stats} of {len(stats)} running "
                             f"statistics and {moved_params} of "
                             f"{len(params)} parameters moved")
    rates = [TRAIN_WINDOW_STEPS / s for s in seconds]
    med = statistics.median(rates)
    # the backward's kernels lie outside every range (autograd's thread)
    backward = prof["device"] - sum(prof[r] for r in TRAIN_RANGES
                                    if r != "train.backward")
    phase("train", width=model.cfg.width, batch=tcfg.batch_size,
          data_hw="x".join(map(str, TRAIN_DATA_HW)),
          hw="x".join(map(str, tcfg.image_hw)),
          objective=tcfg.sim_objective, steps=len(history),
          timed_steps=TRAIN_WINDOWS * TRAIN_WINDOW_STEPS,
          seconds=",".join(f"{x:.4f}" for x in seconds),
          median_steps_per_s=f"{med:.3f}",
          spread_steps_per_s=f"{min(rates):.3f}-{max(rates):.3f}",
          median_images_per_s=f"{med * tcfg.batch_size:.2f}",
          device_ms_per_step=f"{prof['device']:.2f}",
          augment_ms=f"{prof['train.augment']:.2f}",
          forward_ms=f"{prof['train.forward']:.2f}",
          backward_ms=f"{backward:.2f} (the rest: autograd's thread)",
          optimizer_ms=f"{prof['train.optimizer']:.2f}",
          wall_ms=f"{prof['wall']:.2f}",
          peak_gb=f"{peak / 1e9:.3f}",
          loss_first5=f"{first:.4f}", loss_last5=f"{last:.4f}",
          moved=f"{moved_params} params, {moved_stats} statistics",
          card=repr(card))
    for name, ms in prof["top"]:
        phase("train_top", ms_per_step=f"{ms:.4f}", kernel=repr(name))

    check_train_step_card_vs_cpu(dev)
    model.eval()
    mem, _ = synthetic.synthetic_batch(
        EVAL_PAIRS, tcfg.image_hw,
        generator=torch.Generator(device=dev).manual_seed(1234))
    for severity in (0.0, 1.0):
        live = augment.eval_view(
            mem, severity=severity,
            generator=torch.Generator(device=dev).manual_seed(5))
        aucs = [evaluate.evaluate_pairs(m, live, mem)["auc"]
                for m in (untrained, model)]
        if not all(0.0 <= a <= 1.0 for a in aucs):
            raise AssertionError(f"train_eval: PR-AUC {aucs}")
        phase("train_eval", pairs=EVAL_PAIRS, severity=severity,
              pr_auc_untrained=f"{aucs[0]:.4f}",
              pr_auc_trained=f"{aucs[1]:.4f}",
              trained_steps=len(history), trapezoid=evaluate.TRAPEZOID)
    live = augment.eval_view(
        mem[:RERANK_PAIRS], generator=torch.Generator(device=dev).manual_seed(5))
    d_l, kp_l = evaluate.embed(model, live, 8, with_keypoints=True)
    d_m, kp_m = evaluate.embed(model, mem[:RERANK_PAIRS], 8,
                               with_keypoints=True)
    labels, scores = evaluate.geometric_rerank(
        d_l, kp_l, d_m, kp_m, lc.LoopConfig(min_inliers=10,
                                            ransac_hypotheses=16),
        top_k=5, generator=torch.Generator(device=dev).manual_seed(9))
    g_auc = evaluate.pr_auc(labels, scores)
    if not 0.0 <= g_auc <= 1.0:
        raise AssertionError(f"train_eval: G-CALC2 PR-AUC {g_auc}")
    phase("train_eval", pairs=RERANK_PAIRS, rerank="top_k=5",
          pr_auc_gcalc2=f"{g_auc:.4f}", verified=int((scores > 0).sum()))
    del pool, state, model, untrained
    check_training_drivers(dev, card, report)


def check_train_step_card_vs_cpu(dev) -> None:
    """One train step at width 8, 48x64, batch 4 (crops from 56x72), the
    same weights and draws on both devices: the metrics equal to
    TRAIN_METRIC_RTOL relative, Adam's first moment (0.1 x the clipped
    gradient) to TRAIN_MU_TOL of each tensor's largest entry (f32 on
    both, TF32 off; cuDNN sums in another order)."""
    hw = (48, 64)
    tcfg = train.TrainConfig(batch_size=4, image_hw=hw, aug_severity=1.0)
    base = VSS(VSSConfig(width=8), hw, torch.Generator().manual_seed(3))
    imgs, labels = synthetic.synthetic_batch(
        4, (56, 72), generator=torch.Generator().manual_seed(4))
    w = synthetic.class_weights(labels)
    d = train.train_draws(tcfg, base, imgs.shape,
                          torch.Generator().manual_seed(5), "cpu")
    states, metrics = [], []
    for device, draws in (("cpu", d), (dev, d.to(dev))):
        st = train.init_state(copy.deepcopy(base).to(device), tcfg)
        st, m = train.train_step(tcfg, st, imgs.to(device),
                                 labels.to(device), w.to(device), draws)
        states.append(st)
        metrics.append({k: float(v) for k, v in m.items()})
    rel = max(abs(metrics[1][k] - v) / max(abs(v), 1e-30)
              for k, v in metrics[0].items())
    if not rel <= TRAIN_METRIC_RTOL:
        raise AssertionError(f"train step card vs CPU: metrics {metrics}")
    worst, worst_name = 0.0, ""
    cpu_params = dict(states[0].model.named_parameters())
    for name, p in states[1].model.named_parameters():
        a = states[1].optimizer.state[p]["exp_avg"].cpu()
        b = states[0].optimizer.state[cpu_params[name]]["exp_avg"]
        e = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        if e > worst:
            worst, worst_name = e, name
    if not worst <= TRAIN_MU_TOL:
        raise AssertionError(f"train step card vs CPU: exp_avg of "
                             f"{worst_name} differs by {worst:.3e} of its "
                             f"max > {TRAIN_MU_TOL}")
    phase("crosscheck", pair="train_step:cuda_vs_cpu", width=8,
          hw="48x64", batch=4, max_metric_rel=f"{rel:.3e}",
          exp_avg_max_rel=f"{worst:.3e} ({worst_name})",
          loss=f"{metrics[1]['loss']:.6f}")


def check_training_drivers(dev, card: str, report: dict) -> None:
    """train_calc2 (20 steps, width 8 at 48x64) into a temporary
    directory, its ckpt_final restored here to the trained model (the PR
    evaluation of the trainer's pairs equal to the PR-AUC it printed),
    then run_loop_closure --ckpt on it at the phase-6 gate protocol's
    size with --lc-severity 0.5: exit 0, finite artifacts, K4 and K6
    launched."""
    with tempfile.TemporaryDirectory() as tmp:
        d = pathlib.Path(tmp)
        out, secs = run_driver("train_calc2", [
            "--steps", "20", "--width", "8", "--hw", "48", "64",
            "--out", str(d / "calc2")])
        ckpt = d / "calc2" / "ckpt_final"
        rows = [json.loads(r) for r in (d / "calc2" / "train_metrics.jsonl")
                .read_text().splitlines()]
        if not (ckpt.is_file() and len(rows) == 20 and all(
                numpy.isfinite(list(r.values())).all() for r in rows)):
            raise AssertionError("train_calc2: artifacts")
        printed = re.findall(r"retrieval PR-AUC: ([0-9.]+)", out)[-1]
        hw = (48, 64)
        model = run_loop_closure.load_vss(VSSConfig(width=8), hw,
                                          str(ckpt)).to(dev)
        st = train.restore_checkpoint(str(ckpt), train.init_state(
            VSS(VSSConfig(width=8), hw).to(dev),
            train.TrainConfig(image_hw=hw)))
        live, mem = train_calc2.eval_pairs(hw, dev)
        da = evaluate.embed(model, live)
        db = evaluate.embed(st.model, live)
        auc = evaluate.evaluate_pairs(model, live, mem, batch=4)["auc"]
        if not (torch.equal(da, db) and f"{auc:.4f}" == printed
                and st.step == 20):
            raise AssertionError(f"train_calc2: ckpt_final restores to PR-AUC "
                                 f"{auc:.4f}, the trainer printed {printed}")
        phase("train_drivers", driver="train_calc2", steps=20, width=8,
              hw="48x64", batch=8, seconds=f"{secs:.2f}",
              steps_per_s=rate(out, "steps/s"), pr_auc=printed,
              restored="equal descriptors and PR-AUC", card=repr(card))
        out, secs = run_driver("run_loop_closure", LOOP_GATE_ARGS + [
            "--ckpt", str(ckpt), "--lc-severity", "0.5",
            "--out", str(d / "lc"), "--json", str(d / "lc.json")])
        s = json.loads((d / "lc.json").read_text())
        traj = numpy.load(d / "lc" / "trajectory.npz")["trajectory"]
        nums = [s[k] for k in ("ate_off_p50", "ate_on_p50",
                               "final_off_p50", "final_on_p50")]
        launches = json.loads(re.findall(r"kernel launches (\{.*\})",
                                         out)[-1])
        if not (numpy.isfinite(nums).all() and numpy.isfinite(traj).all()
                and launches.get("corr_apply_cols", 0) > 0
                and launches.get("f32_matmul_big", 0) > 0):
            raise AssertionError(f"run_loop_closure --ckpt: {nums}, "
                                 f"launches {launches}")
        for name in ("corr_apply_cols", "f32_matmul_big"):
            report[name]["ckpt_loop"] = {"launches": launches[name]}
        phase("train_drivers", driver="run_loop_closure", ckpt="ckpt_final",
              lc_severity=0.5, frames=s["frames"], seeds=s["ensemble"],
              seconds=f"{secs:.2f}", frames_per_s=rate(out, "frames/s"),
              ate_off_p50=f"{nums[0]:.4f}", ate_on_p50=f"{nums[1]:.4f}",
              final_off_p50=f"{nums[2]:.4f}", final_on_p50=f"{nums[3]:.4f}",
              n_loops_total=s["n_loops_total"],
              launches=json.dumps(launches, separators=(",", ":")),
              card=repr(card))


# -- 8b. the VSS at bf16 beside f32 -------------------------------------------

def check_bf16_training(dev, card: str, frames) -> None:
    """Phase 8, the bf16 VSS: the full-width train step
    (VSS(VSSConfig(compute_dtype="bfloat16")), TrainConfig()'s defaults)
    beside the f32 one in this call, both from the same seeded weights on
    the same synthetic batches: steps/s and images/s (TRAIN_WARMUP steps,
    then TRAIN_WINDOWS windows of TRAIN_WINDOW_STEPS), device ms a step
    (one profiled step), the peak of max_memory_allocated; every metric
    finite. Then the f32 and bf16 models' descriptors of phase 6's first
    LOOP_COSINE_FRAMES pan frames (all instances): their cosine, which
    must be finite and above 0.9 (printed; the CPU tests hold bf16 to JAX
    at >= 0.999)."""
    tcfg = train.TrainConfig()
    gen = torch.Generator(device=dev).manual_seed(1)
    pool = [synthetic.synthetic_batch(tcfg.batch_size, TRAIN_DATA_HW,
                                      generator=gen)
            for _ in range(TRAIN_POOL)]
    rows = {}
    for dtype in ("float32", "bfloat16"):
        model = VSS(VSSConfig(compute_dtype=dtype), tcfg.image_hw,
                    torch.Generator().manual_seed(0)).to(dev)
        state = train.init_state(model, tcfg)
        draws = torch.Generator(device=dev).manual_seed(2)
        history = []

        def step():
            nonlocal state
            imgs, labels = pool[len(history) % TRAIN_POOL]
            state, m = train.train_step(tcfg, state, imgs, labels,
                                        synthetic.class_weights(labels),
                                        generator=draws)
            history.append(m)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(TRAIN_WARMUP):
            step()
        seconds = []
        for _ in range(TRAIN_WINDOWS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(TRAIN_WINDOW_STEPS):
                step()
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        prof = range_device_ms(step, TRAIN_RANGES)
        table = torch.stack([torch.stack([m[k] for k in sorted(m)])
                             for m in history])
        if not bool(torch.isfinite(table).all()):
            raise AssertionError(f"bf16 train ({dtype}): a non-finite "
                                 f"metric")
        rates = [TRAIN_WINDOW_STEPS / x for x in seconds]
        med = statistics.median(rates)
        rows[dtype] = med
        phase("train_bf16", compute_dtype=dtype, width=model.cfg.width,
              batch=tcfg.batch_size, hw="x".join(map(str, tcfg.image_hw)),
              seconds=",".join(f"{x:.4f}" for x in seconds),
              median_steps_per_s=f"{med:.3f}",
              spread_steps_per_s=f"{min(rates):.3f}-{max(rates):.3f}",
              median_images_per_s=f"{med * tcfg.batch_size:.2f}",
              device_ms_per_step=f"{prof['device']:.2f}",
              peak_gb=f"{peak / 1e9:.3f}",
              loss_last=f"{float(history[-1]['loss']):.4f}",
              card=repr(card))
        for name, ms in prof["top"][:3]:
            phase("train_bf16_top", compute_dtype=dtype,
                  ms_per_step=f"{ms:.4f}", kernel=repr(name))
        del state, model
    models = {d: VSS(VSSConfig(compute_dtype=d), LOOP_HW,
                     torch.Generator().manual_seed(0)).to(dev).eval()
              for d in ("float32", "bfloat16")}
    with torch.no_grad():
        d = {k: torch.cat([m(f, descriptor_only=True)["descriptor"]
                           for f in frames]) for k, m in models.items()}
    cos = F.cosine_similarity(d["float32"].double(), d["bfloat16"].double())
    phase("train_bf16", descriptor_cosine_min=f"{float(cos.min()):.9f}",
          descriptor_cosine_mean=f"{float(cos.mean()):.9f}",
          images=cos.shape[0], hw="x".join(map(str, LOOP_HW)),
          bf16_over_f32_steps=f"{rows['bfloat16'] / rows['float32']:.3f}")
    if not (bool(torch.isfinite(cos).all()) and float(cos.min()) > 0.9):
        raise AssertionError(f"bf16 descriptors: cosine to f32 "
                             f"{float(cos.min())}")
    del models, pool


# -- 9. the multi-process layer -----------------------------------------------

PAR_WORLD = 2
PAR_TRAIN_SEEDS = (0, 1, 5)     # weights, batch, draws of leg (d)


def _numpy(t):
    return t.detach().cpu().numpy()


def parallel_rank() -> dict:
    """One rank of phase 9 (a gloo rank sharing the card): a probe of
    gloo's collectives on CUDA tensors, then legs (a)-(d), each from the
    same seeded inputs as the parent's single-process references. Returns
    what the parent holds against them (rank 0: the gathered state of
    leg (b) too)."""
    from ekf_slam_tpu_torch.parallel import mesh as pmesh
    from ekf_slam_tpu_torch.parallel import sharded_filter as sf

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = torch.distributed.get_rank()
    out = {"rank": rank}
    mesh = pmesh.make_mesh(PAR_WORLD)
    dev = mesh.device

    # the probe: gloo's tensor collectives on CUDA tensors
    t = torch.full((3,), float(rank + 1), device=dev)
    g = pmesh.all_gather(t, mesh, "data")
    r = pmesh.all_reduce(t, mesh, "data")
    out["probe"] = {"all_gather_into_tensor": g.tolist(),
                    "all_reduce": r.tolist(), "device": str(g.device)}

    # (a) run_ensemble, data = PAR_WORLD, the fused step
    cfg = slice_config("fused")
    st0, _, obs, u = slice_inputs(cfg, dev)
    kernels.reset_launches()
    final, traj, mean, cov = pmesh.run_ensemble(st0, obs, u, cfg, mesh)
    torch.cuda.synchronize()
    out["a"] = {"traj": _numpy(traj), "mean": _numpy(mean),
                "cov": _numpy(cov), "x": _numpy(final.x),
                "P": _numpy(final.P), "launches": dict(kernels.LAUNCHES)}
    del final

    # (b) the row-sharded step, data 1 x model PAR_WORLD, unfused
    cfg = slice_config("unfused")
    tp = pmesh.make_mesh(1, PAR_WORLD)
    step = sf.make_sharded_step(cfg, tp)
    _, Dp = sf.padded_dim(cfg, PAR_WORLD)
    counts, traj, payload = [], [], 0

    def run_tp():
        nonlocal payload
        sp = sf.shard_state_batch(st0, tp, cfg)
        for f in range(u.shape[0]):
            pmesh.reset_collectives()
            sp, info = step(sp, obs.frame(f), u[f])
            payload = max([payload] + [n for _, _, n in pmesh.COLLECTIVES])
            counts.append({k: _numpy(getattr(info, k)) for k in
                           ("n_visible", "n_ic", "n_li", "n_hi")})
            traj.append(sp.x[:, 0:3])
        return sp

    run_tp()                                            # warm-up
    counts.clear()
    traj.clear()
    torch.distributed.barrier()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    sp = run_tp()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    full = sf.gather_state(sp, tp, cfg)
    out["b"] = {"counts": counts, "payload": payload, "seconds": seconds,
                "bound": sf.payload_bound(cfg, st0.batch, Dp),
                "slab": list(sp.P.shape), "launches": launches,
                "full_P": st0.batch * Dp * cfg.map.state_dim,
                "traj": _numpy(torch.stack(traj, dim=1))}
    if rank == 0:
        out["b"].update(x=_numpy(full.x), P=_numpy(full.P))
    del sp, full
    # every frame from the same state: the sharded frame from the state the
    # sharded run reached, against the single-device unfused frame from the
    # same state (rank 0; phase 5's tolerances)
    frames, sp = [], sf.shard_state_batch(st0, tp, cfg)
    for f in range(u.shape[0]):
        prev = sf.gather_state(sp, tp, cfg)
        sp, info = step(sp, obs.frame(f), u[f])
        got = sf.gather_state(sp, tp, cfg)
        if rank == 0:
            ref, rinfo = engine.step(prev, obs.frame(f), u[f], cfg)
            frames.append({
                "counts": all(torch.equal(getattr(info, k), getattr(
                    rinfo, k)) for k in ("n_visible", "n_ic", "n_li",
                                         "n_hi")),
                "dx": float((got.x - ref.x).abs().max()),
                "max_x": float(ref.x.abs().max()),
                "P_err": kernels.scaled_error(got.P.double(),
                                              ref.P.double())})
        del prev, got
    out["b"]["frames"] = frames
    del sp

    # (c) run_online on the sharded DB, data = PAR_WORLD
    images, x0, P0, model, lcfg = loop_inputs(dev)
    kernels.reset_launches()
    db, x, P, lo = loop_runner.run_online(
        model, images, x0, P0, lcfg,
        generator=torch.Generator(device=dev).manual_seed(3), mesh=mesh)
    torch.cuda.synchronize()
    out["c"] = {**{f: _numpy(getattr(lo, f)) for f in lo._fields},
                "x": _numpy(x), "P": _numpy(P),
                "db_gb": sum(getattr(db, f).numel()
                             * getattr(db, f).element_size()
                             for f in lc.DB_FIELDS) / 1e9,
                "launches": dict(kernels.LAUNCHES)}
    del db, images, model

    # (d) the data-parallel train step, full width, the global batch
    legs = train_leg(dev, lambda model, tcfg: train.make_sharded_train_step(
        model, tcfg, mesh))
    out["d"] = {k: (m, {n: _numpy(t) for n, t in mu.items()}
                    if rank == 0 else None) for k, (m, mu) in legs.items()}
    return out


def _cast_draws(d: "train.TrainDraws", dtype) -> "train.TrainDraws":
    """The draws with their floating tensors in `dtype` (f32 → f64 is
    exact)."""
    def cast(t):
        if t is None:
            return None
        items = [x.to(dtype) if x.is_floating_point() else x for x in t]
        return type(t)(*items) if hasattr(t, "_fields") else tuple(items)
    return train.TrainDraws(cast(d.crop), cast(d.positive),
                            cast(d.seasonal), d.eps.to(dtype))


def train_leg(dev, step_of) -> dict:
    """Leg (d)'s step at full width on the global batch, f32 and its f64
    twin (the same weights, batch and draws, upcast exactly): {dtype name:
    (metrics, Adam's first moments on the CPU)}. step_of(model, tcfg)
    gives the step: train_step, or the data-parallel one."""
    tcfg = train.TrainConfig()
    w0, b0, d0 = PAR_TRAIN_SEEDS
    imgs, labels = synthetic.synthetic_batch(
        tcfg.batch_size, TRAIN_DATA_HW,
        generator=torch.Generator(device=dev).manual_seed(b0))
    out = {}
    for dtype in (torch.float32, torch.float64):
        model = VSS(VSSConfig(), tcfg.image_hw,
                    torch.Generator().manual_seed(w0)).to(dev, dtype)
        draws = _cast_draws(train.train_draws(
            tcfg, model, imgs.shape,
            torch.Generator(device=dev).manual_seed(d0), dev), dtype)
        state, m = step_of(model, tcfg)(
            train.init_state(model, tcfg), imgs.to(dtype),
            labels.to(dtype), synthetic.class_weights(labels).to(dtype),
            draws)
        out[str(dtype).removeprefix("torch.")] = (
            {k: float(v) for k, v in m.items()},
            {n: state.optimizer.state[p]["exp_avg"].cpu()
             for n, p in model.named_parameters()})
        del state, model, draws
        torch.cuda.empty_cache()
    return out


def ensemble_rank_nccl() -> dict:
    """Leg (a) on one NCCL rank (data = 1): run_ensemble's trajectories and
    its mean and covariance."""
    from ekf_slam_tpu_torch.parallel import mesh as pmesh
    mesh = pmesh.make_mesh(1)
    cfg = slice_config("fused")
    st0, _, obs, u = slice_inputs(cfg, mesh.device)
    _, traj, mean, cov = pmesh.run_ensemble(st0, obs, u, cfg, mesh)
    return {"traj": _numpy(traj), "mean": _numpy(mean), "cov": _numpy(cov),
            "backend": mesh.backend}


def _rel(a, b) -> float:
    a, b = numpy.asarray(a, numpy.float64), numpy.asarray(b, numpy.float64)
    return float(numpy.abs(a - b).max() / max(numpy.abs(b).max(), 1e-30))


def check_parallel(dev, card: str, report: dict, loop: dict) -> None:
    """Phase 9: the multi-process layer with PAR_WORLD gloo ranks sharing
    the card (parallel_rank, one spawn for the four legs), each leg held
    against its single-process run here in this call:
      (a) run_ensemble, the sim f32 parity config (CAP 100, B = 128, 16
          frames, scene 0; the fused step), data = PAR_WORLD: each
          instance's trajectory and final x bitwise or the difference
          printed, within phase 5's tolerances; the ensemble mean and
          position covariance to 1e-6 relative of those of the gathered
          trajectories, and of the single-process run's when the
          instances are bitwise its;
      (b) make_sharded_step, the same config unfused, data 1 x model
          PAR_WORLD: every frame from the state the sharded run reached,
          the sharded frame against the single-device unfused frame from
          that state (phase 5's crosscheck: gate counts equal, x within
          X_RTOL of max|x|, P within P_TOL of its bounds); the 16-frame
          runs side by side (the instances whose counts part, the last
          frame's differences: printed; the tail P + Ā·B̄ᵀ is not
          symmetrized, K4's is, so near-threshold gates may part), and
          the sharded run's tracking error < 0.2 (phase 4's gate);
          frames/s beside the unfused (i) run_sequence's here; the
          largest collective against its bound; K6 3 and K8's slab form
          2 launches a frame;
      (c) run_online on the sharded DB (LoopConfig's defaults as phase 6
          runs them, capacity 4096, B = 4, the 128-frame pan), data =
          PAR_WORLD, against phase 6's last timed run: declared, match
          ids and inliers equal, similarities to 1e-5, x and P to 1e-4;
      (d) the data-parallel train step at full width, batch 12 as
          PAR_WORLD x 6, against train_step on the whole batch here, in
          f32 and in an f64 twin (the same weights, batch and draws
          upcast): metrics to TRAIN_METRIC_RTOL; in f64 Adam's first
          moment to 1e-9 of each tensor's largest entry (the arithmetic);
          in f32 each tensor's to twice the f32 step's own error against
          its f64 twin, and at least TRAIN_MU_TOL (f32 rounding: the
          deep convolutions' weight gradients cancel heavily).
    Then leg (a) again on one NCCL rank (data = 1), within (a)'s
    tolerances of the single-process run (bitwise printed)."""
    from ekf_slam_tpu_torch.parallel import mesh as pmesh
    from ekf_slam_tpu_torch.parallel import sharded_filter as sf

    # single-process references
    cfgs = {p: slice_config(p) for p in ("fused", "unfused")}
    st0, xs, obs, u = slice_inputs(cfgs["fused"], dev)
    fin_f, traj_f, _ = engine.run_sequence(st0, obs, u, cfgs["fused"])
    mean_f = traj_f.mean(dim=0)
    dv = traj_f[..., 0:3] - mean_f[None, :, 0:3]
    cov_f = torch.einsum("bti,btj->tij", dv, dv) / traj_f.shape[0]
    engine.run_sequence(st0, obs, u, cfgs["unfused"])          # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fin_u, _, info_u = engine.run_sequence(st0, obs, u, cfgs["unfused"])
    torch.cuda.synchronize()
    unfused_s = time.perf_counter() - t0
    ref = {"traj": traj_f.cpu(), "x_f": fin_f.x.cpu(), "P_f": fin_f.P.cpu(),
           "mean": mean_f.cpu(), "cov": cov_f.cpu(), "x_u": fin_u.x.cpu(),
           "P_u": fin_u.P.cpu(),
           "counts_u": {k: getattr(info_u, k).cpu() for k in
                        ("n_visible", "n_ic", "n_li", "n_hi")},
           "xs": xs[:, 0:3].cpu().numpy()}
    ref["train"] = train_leg(dev, lambda model, tcfg: functools.partial(
        train.train_step, tcfg))
    del fin_f, traj_f, fin_u, st0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ranks = pmesh.spawn(parallel_rank, PAR_WORLD, "gloo")
    phase("parallel", world=PAR_WORLD, backend="gloo",
          seconds=f"{time.perf_counter() - t0:.1f}",
          probe=json.dumps(ranks[0]["probe"], separators=(",", ":")),
          card=repr(card))
    want = [float(PAR_WORLD * (PAR_WORLD + 1) // 2)] * 3
    for rk in ranks:
        pr = rk["probe"]
        if not (pr["all_reduce"] == want
                and pr["device"].startswith(dev.type)
                and pr["all_gather_into_tensor"] == [
                    float(r + 1) for r in range(PAR_WORLD) for _ in
                    range(3)]):
            raise AssertionError(f"gloo on CUDA tensors: {pr}")

    # (a)
    traj = numpy.concatenate([rk["a"]["traj"] for rk in ranks])
    x = numpy.concatenate([rk["a"]["x"] for rk in ranks])
    P = torch.tensor(numpy.concatenate([rk["a"]["P"] for rk in ranks]))
    dtraj = float(numpy.abs(traj - ref["traj"].numpy()).max())
    dx = float(numpy.abs(x - ref["x_f"].numpy()).max())
    p_err = kernels.scaled_error(P.double(), ref["P_f"].double())
    mean_rel = max(_rel(rk["a"]["mean"], ref["mean"]) for rk in ranks)
    cov_rel = max(_rel(rk["a"]["cov"], ref["cov"]) for rk in ranks)
    # the ranks' reduced statistics against those of their own gathered
    # trajectories, formed in one place
    t64 = torch.tensor(traj, dtype=torch.float64)
    m64 = t64.mean(dim=0)
    d64 = t64[..., 0:3] - m64[None, :, 0:3]
    c64 = torch.einsum("bti,btj->tij", d64, d64) / t64.shape[0]
    own = max(max(_rel(rk["a"]["mean"], m64), _rel(rk["a"]["cov"], c64))
              for rk in ranks)
    bitwise = dtraj == 0 and dx == 0
    max_x = float(ref["x_f"].abs().max())
    phase("parallel_ensemble", leg="a", data=PAR_WORLD, batch=traj.shape[0],
          frames=traj.shape[1], bitwise=bitwise, max_dtraj=f"{dtraj:.3e}",
          max_dx=f"{dx:.3e}", max_abs_x=f"{max_x:.3e}",
          P_scaled_err=f"{p_err:.3e}", mean_rel=f"{mean_rel:.3e}",
          cov_rel=f"{cov_rel:.3e}", stats_vs_gathered_rel=f"{own:.3e}",
          launches_rank0=json.dumps(
              {k: v for k, v in ranks[0]["a"]["launches"].items() if v}))
    # per instance within phase 5's tolerances; the statistics to 1e-6 of
    # the gathered trajectories', and of the single process's when the
    # instances are bitwise its
    if not (dx <= X_RTOL * max_x and p_err <= P_TOL and own <= 1e-6
            and (not bitwise or max(mean_rel, cov_rel) <= 1e-6)):
        raise AssertionError("leg (a): run_ensemble differs from the "
                             "single-process run")
    for rk in ranks:
        got = {k: v for k, v in rk["a"]["launches"].items() if v}
        if got != {k: n * FRAMES for k, n in PER_FRAME["fused"].items()}:
            raise AssertionError(f"leg (a): launches {got}")

    # (b)
    b0r = ranks[0]["b"]
    frames = len(b0r["counts"])
    per = b0r["frames"]
    f_dx = max(r["dx"] / r["max_x"] for r in per)
    f_p = max(r["P_err"] for r in per)
    # the 16-frame runs side by side: the instances whose gate counts
    # differ in some frame, the first such frame, where the runs end
    diff = numpy.zeros(ref["counts_u"]["n_li"].shape, dtype=bool)
    for f in range(frames):
        for k, v in b0r["counts"][f].items():
            diff[:, f] |= v != ref["counts_u"][k][:, f].numpy()
    differ = int(diff.any(axis=1).sum())
    first = int(numpy.argmax(diff.any(axis=0))) if diff.any() else -1
    dx = float(numpy.abs(b0r["x"] - ref["x_u"].numpy()).max())
    p_err = kernels.scaled_error(torch.tensor(b0r["P"]).double(),
                                 ref["P_u"].double())
    track = float(numpy.linalg.norm(b0r["traj"] - ref["xs"][None],
                                    axis=-1).mean())
    tp_rate = frames / max(rk["b"]["seconds"] for rk in ranks)
    phase("parallel_tp", leg="b", mesh=f"1x{PAR_WORLD}",
          slab="x".join(map(str, b0r["slab"])), frames=frames,
          per_frame_counts="equal" if all(r["counts"] for r in per)
          else "DIFFER", per_frame_dx_rel=f"{f_dx:.3e}",
          per_frame_P_scaled_err=f"{f_p:.3e}",
          run_instances_differing=differ, run_first_frame_differing=first,
          run_max_dx=f"{dx:.3e}",
          max_abs_x=f"{float(ref['x_u'].abs().max()):.3e}",
          run_P_scaled_err=f"{p_err:.3e}", track_err=f"{track:.4f}",
          largest_payload=b0r["payload"], payload_bound=b0r["bound"],
          full_P=b0r["full_P"],
          steps_per_s=f"{tp_rate * BATCH:.1f}",
          unfused_steps_per_s=f"{frames * BATCH / unfused_s:.1f}",
          seconds=f"{max(rk['b']['seconds'] for rk in ranks):.4f}",
          unfused_seconds=f"{unfused_s:.4f}",
          launches_rank0=json.dumps({k: v for k, v in
                                     b0r["launches"].items() if v}),
          card=repr(card))
    if not (all(r["counts"] for r in per) and f_dx <= X_RTOL
            and f_p <= P_TOL and numpy.isfinite(b0r["P"]).all()
            and track < 0.2
            and 0 < b0r["payload"] <= b0r["bound"] < b0r["full_P"]):
        raise AssertionError("leg (b): the sharded step differs or moves "
                             "too much")
    for rk in ranks:
        got = {k: v for k, v in rk["b"]["launches"].items() if v}
        if got != {"f32_matmul_big": 3 * frames,
                   "corr_apply_rows": 2 * frames}:
            raise AssertionError(f"leg (b): launches {got}")
    report["corr_apply_rows"]["launches"] = b0r["launches"]["corr_apply_rows"]
    report["f32_matmul_big"]["tp_slab"]["launches"] = \
        b0r["launches"]["f32_matmul_big"]

    # (c)
    lo = loop["out"]
    for rk in ranks:
        c = rk["c"]
        for f in ("declared", "match_id", "inliers"):
            if not numpy.array_equal(c[f], getattr(lo, f).numpy()):
                raise AssertionError(f"leg (c): {f} differs from the "
                                     f"unsharded run")
        sim = getattr(lo, "similarity").numpy()
        fin = numpy.isfinite(sim)
        if not (numpy.array_equal(numpy.isfinite(c["similarity"]), fin)
                and numpy.abs(c["similarity"][fin] - sim[fin]).max()
                <= 1e-5 and _rel(c["x"], loop["x"]) <= 1e-4
                and _rel(c["P"], loop["P"]) <= 1e-4):
            raise AssertionError("leg (c): similarities, x or P differ")
    c = ranks[0]["c"]
    phase("parallel_loop", leg="c", data=PAR_WORLD, batch=c["x"].shape[0],
          frames=c["declared"].shape[0], declared=int(c["declared"].sum()),
          gates="equal", db_gb_a_rank=f"{c['db_gb']:.3f}",
          max_dsim=f"{float(numpy.abs(c['similarity'][fin] - sim[fin]).max()):.3e}",
          launches_rank0=json.dumps({k: v for k, v in
                                     c["launches"].items() if v}))

    # (d): f64 shows the data-parallel step's arithmetic; in f32 each
    # tensor's difference is held against the f32 step's own error (its
    # distance from the f64 step), at least TRAIN_MU_TOL
    m32, mu32 = ref["train"]["float32"]
    m64, mu64 = ref["train"]["float64"]
    rel = max(abs(rk["d"][d][0][k] - v) / max(abs(v), 1e-30)
              for rk in ranks for d, mm in (("float32", m32),
                                           ("float64", m64))
              for k, v in mm.items())
    e64, worst, worst_name, floor = 0.0, 0.0, "", {}
    for n, b in mu32.items():
        own = _rel(b, mu64[n])
        e = _rel(ranks[0]["d"]["float32"][1][n], b)
        e64 = max(e64, _rel(ranks[0]["d"]["float64"][1][n], mu64[n]))
        floor[n] = own
        if e / max(2 * own, TRAIN_MU_TOL) > worst:
            worst, worst_name = e / max(2 * own, TRAIN_MU_TOL), n
    phase("parallel_train", leg="d", width=VSSConfig().width,
          batch=f"{PAR_WORLD}x"
          f"{train.TrainConfig().batch_size // PAR_WORLD}",
          max_metric_rel=f"{rel:.3e}", f64_exp_avg_max_rel=f"{e64:.3e}",
          f32_exp_avg_rel_of_limit=f"{worst:.3f} ({worst_name}: "
          f"{_rel(ranks[0]['d']['float32'][1][worst_name], mu32[worst_name]):.3e}"
          f" against the f32 step's own {floor[worst_name]:.3e})",
          f32_step_own_max=f"{max(floor.values()):.3e}",
          loss=f"{ranks[0]['d']['float32'][0]['loss']:.6f}")
    if not (rel <= TRAIN_METRIC_RTOL and e64 <= 1e-9 and worst <= 1.0):
        raise AssertionError("leg (d): the data-parallel step differs from "
                             "the global batch's")

    # leg (a) on one NCCL rank
    one = pmesh.spawn(ensemble_rank_nccl, 1, "nccl")[0]
    d1 = float(numpy.abs(one["traj"] - ref["traj"].numpy()).max())
    phase("parallel_ensemble", leg="a", data=1, backend=one["backend"],
          bitwise=d1 == 0, max_dtraj=f"{d1:.3e}",
          mean_rel=f"{_rel(one['mean'], ref['mean']):.3e}",
          cov_rel=f"{_rel(one['cov'], ref['cov']):.3e}")
    if not (d1 <= X_RTOL * max_x and _rel(one["cov"], ref["cov"]) <= 1e-6):
        raise AssertionError("leg (a) on one NCCL rank differs from the "
                             "single-process run")


# Phase 10: the unfused step at f32 on the card against the f64 oracle on
# the host (oracle/golden.py: the golden config, B = 4, T = 10, one forced
# conversion at T // 2). Each seed runs first at f32 on the CPU; the card
# is held to the frames before that run's counts part from the oracle's
# (seeds 2 and 3 part at frame 6: the f32 step goes non-finite after the
# forced conversion, in the JAX package as in the port; ROADMAP §3).
GOLDEN_SEEDS = (0, 1, 2, 3)
GOLDEN_FRAMES = 10
GOLDEN_BATCH = 4


def check_golden(dev, card: str, report: dict) -> None:
    t_start = time.perf_counter()
    want = {k: PER_FRAME["unfused"].get(k, 0) * (GOLDEN_FRAMES - 1)
            for k in kernels.LAUNCHES}
    for seed in GOLDEN_SEEDS:
        cpu = golden.run("float32", GOLDEN_FRAMES, GOLDEN_BATCH, seed, "cpu")
        part = cpu.first_parting()
        held = part or GOLDEN_FRAMES
        torch.cuda.synchronize()
        kernels.reset_launches()
        with kernels.capture_operands() as ops:
            run = golden.run("float32", GOLDEN_FRAMES, GOLDEN_BATCH, seed,
                             dev)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        if launches != want:
            raise AssertionError(f"golden seed {seed}: kernel launches "
                                 f"{launches}, expected {want}")
        for k in golden.COUNTS:
            got, ref = run.port[k][:held - 1], run.oracle[k][:held - 1]
            if not numpy.array_equal(got, ref):
                raise AssertionError(f"golden seed {seed}: {k} differs from "
                                     f"the oracle's: {got.T} vs {ref.T}")
        err = run.rmse[:held]
        if not (numpy.isfinite(err).all()
                and err.max() <= golden.GOLDEN_F32_TOL):
            raise AssertionError(f"golden seed {seed}: RMSE {err.max()} > "
                                 f"{golden.GOLDEN_F32_TOL}")
        phase("golden", seed=seed, batch=GOLDEN_BATCH, frames=GOLDEN_FRAMES,
              frames_held=held - 1, cpu_parting=part,
              card_parting=run.first_parting(),
              rmse_max=f"{err.max():.3e}", rmse_last=f"{err[-1].max():.3e}",
              cpu_rmse_max=f"{cpu.rmse[:held].max():.3e}",
              tol=golden.GOLDEN_F32_TOL,
              converted=int(run.converted.sum()), launches=json.dumps(
                  {k: v for k, v in launches.items() if v},
                  separators=(",", ":")), card=repr(card))
        if seed == GOLDEN_SEEDS[0]:
            frame_ops = ops
            for name in want:
                if want[name]:
                    report[name]["golden"] = {"launches": launches[name]}
    # K6 (the update's P·Hᵀ) and K4 (the LI tail) at the golden shapes, on
    # frame 2's operands (K6: RANSAC's P·G, then each update's P·Hᵀ)
    per_frame = PER_FRAME["unfused"]
    for name, site, i in (("f32_matmul_big", "golden_PHt", 1),
                          ("corr_apply_cols", "golden_tail", 0)):
        args = frame_ops[name][per_frame[name] + i]
        e = check_kernel(name, args, site)
        report[name]["golden"].update({k: e[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err", "scaled_err")})
    phase("golden_done", seconds=f"{time.perf_counter() - t_start:.1f}")


if __name__ == "__main__":
    main()
