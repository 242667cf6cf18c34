"""Time the panel-product kernels (K1, K2, K3 / K5, K4, K6, K8) and K7 as
built, and as built with one design choice changed, on one CUDA card: the
evidence behind the choices in csrc/fused_cov.cu, csrc/unfused_cov.cu,
csrc/common.cuh and csrc/ncc.cu, and the tool for the next one.

    python -m ekf_slam_tpu_torch.kernel_variants [variant ...] [--sass]
                                                  [--widths]

A variant is a list of text substitutions on the sources. Each is built
into its own library under build/variants/<name>/ (one nvcc a source, in
parallel, a few seconds), bound by ctypes and timed at the bench shapes
(B = 128, D = 613) on random operands: K6 at its four call sites (A in f32
with N = 128 and 64, A in bf16 with N = 48 and 64) beside ``torch.bmm``;
K8 in its three modes on a bf16 and an f32 P (R = 56) and K4 on an f32 P
(R = 136) and a bf16 P (R = 56), the folded tail's M'+8, beside
``torch.baddbmm``; K3 (M2 = 128, r = 60) and K5 (M2 = 128); K1 (r = 6)
and K2 (M2 = 128) at R = 2·CAP = 200, and their product alone, K6 on an
f32 P at N = 200, beside ``torch.bmm``; K7 at the pixels bench
(N = 3,200 pairs, W2 = 37, t = 13), the correlation beside a grouped
``F.conv2d`` (TF32 off) and the norms form; eight_point_fit
(csrc/eight_point.cu) on the 8-point systems of one fundamental_ransac at
the loop path's width (N = 1,792) and on the first 448 (the loop gate's
B = 1), over 20 launches replayed from one CUDA graph (the launcher's host
cost would hide the kernel's). CUDA events, the mean of 20 launches after
3 warm ones.
Variants whose name says ``timing_only`` skip part of the work and give
wrong outputs: they split a kernel's time into its phases. ``--sass`` also
prints, for every K1 / K3 / K4 / K6 / K7 / K8 kernel of the first
variant, the instruction mix of its multiply loop from ``cuobjdump -sass``
(the share of FFMA among the instructions of the loop with the most
FFMAs; K3's two products and K1's pass run the same loop; K7's loop over
window rows at t = 13, compiled unrolled), and of eight_point_fit's sweep
(its longest loop: nine rounds). ``--widths`` also times K5 and K4
(f32 P, as built) at contraction widths around 128 and 264 (K4's 136 and
its former 264): time against width splits a kernel's cost per 8-deep
contraction tile from its fixed cost a call, and shows whether a
power-of-two row stride of the column-form factors costs.

Prints the card's name and power limit, ptxas' registers and spills of
those kernels in each variant, one line of times (ms) a variant, and as
the last line one JSON object with every number.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import subprocess

import torch

from ekf_slam_tpu_torch.ops import _build, kernels

OUT = _build.BUILD_DIR.parent / "variants"
B, D = 128, 613
K8_R, K4_R = 56, {"f32": 136, "bf16": 56}
K3_M2, K3_R = 128, 60
K1_R, K1_r = 200, 6                   # 2·CAP gain columns, the rank-6 add
WIDTHS = (120, 124, 128, 132, 136, 256, 264)
K6_SITES = (("f32_N128", torch.float32, 128), ("f32_N64", torch.float32, 64),
            ("bf16_N48", torch.bfloat16, 48), ("bf16_N64", torch.bfloat16, 64))
K7_N, K7_W2, K7_T = 3200, 37, 13      # B 32 · CAP 100 pairs, R = 12
EP_N = (1792, 448)                     # B·top_k·NH at B = 4 and B = 1
SOURCES = ("unfused_cov.cu", "fused_cov.cu", "ncc.cu", "eight_point.cu",
           "common.cuh")
PANEL = ("k1p_kernel", "k3_kernel", "k3v_kernel", "k4_kernel", "k6_kernel",
         "k7_kernel", "k8_kernel")            # each with a multiply loop
TIMED = PANEL + ("ep_kernel",)
# A kernel's name in a mangled symbol: k3_kernel, k1p_kernel, k8_kernelIf, ...
NAME = r"(k\d[vp]?_kernel(?:I\w*?(?=EEv))?|ep_kernel)"
G8 = "using G8 = Blocking<PT_TILE, PT_TILE, 8, 8>;"
G6 = "using G6 = Blocking<64, BN, 8, 8, BN == 64 ? 255 : 128>;"
G3 = "using G3 = Blocking<PT_TILE, PT_TILE, 8, 8>;"
# K4 / K8 (corr_pair in unfused_cov.cu)
FETCH = """  unsigned bytes = PTile<PT>::template fetch<G8::THREADS>(raw_ij, P, D, i0,
                                                          j0, mbar);
  if (twin)
    bytes += PTile<PT>::template fetch<G8::THREADS>(raw_ji, P, D, j0, i0,
                                                    mbar);
"""
EPILOGUE = "  store_tile_pair<PT, G8::THREADS>(Pout,"
NO_EPILOGUE = (EPILOGUE, "  if (D < 0) store_tile_pair<PT, G8::THREADS>(Pout,")
NO_PRODUCT = (("mode == 0 ? tiles : 2 * tiles, lx, ly", "0, lx, ly"),
              ("2, 2 * tiles, lx, ly", "2, 0, lx, ly"))
# K3 / K5 (fused_cov.cu)
FETCH3 = """  sJ[threadIdx.x] = J8[threadIdx.x];
  __syncthreads();
  unsigned bytes = PTile<float>::fetch<G3::THREADS>(raw_ij, P, D, i0, j0,
                                                     mbar);
  if (twin)
    bytes += PTile<float>::fetch<G3::THREADS>(raw_ji, P, D, j0, i0, mbar);
"""
K3_STORE = """  store_tile_pair<float, G3::THREADS>(Pout, D, i0, j0, sC, tij, tji, 1.f,"""
K3_NO_PASSES = (
    ("  add_pair(tij, tji, sC, -0.5f, twin);",
     "  if (D < 0) add_pair(tij, tji, sC, -0.5f, twin);"),
    ("  if (i == 0) stripe_pair<8>(", "  if (D < 0 && i == 0) stripe_pair<8>("),
    ("    keep_pair(", "    if (D < 0) keep_pair("),
    (K3_STORE, "  if (D < 0)\n" + K3_STORE))
# K1 and K2 (fused_cov.cu): their tile-pair pass (with K1's V prologue)
# and their product, K6's launcher
K1_PRODUCT = "  return ekf_k6_matmul_big(Pout, Ht, PHt, B, D, D, R, 0, stream);"
K2_PRODUCT = "  return ekf_k6_matmul_big(Pout, Ht, PHt2, B, D, D, R, 0, stream);"
K1_PASS = "  cudaError_t err = v_launch(E, U, C, V, B, D, r, s);"
K2_PASS = """  const cudaError_t err =
      k3_launch(P, K, PHt, J8, nullptr, nullptr, nullptr, Pout, B, D, M2, 0,"""
PAIR_BLOCKS = "constexpr int PAIR_BLOCKS = 4;"
# eight_point_fit (eight_point.cu)
EP_SWEEPS = "constexpr int EP_SWEEPS = 16;"
EP_TEST = "    done = done || off2 <= tol2;"
# K7 (ncc.cu)
K7_UNROLLED = "constexpr int K7_T = 13;"
# name -> {source: ((old, new) substitutions)}
VARIANTS = {
    "base": {},
    # K8's micro-tile (and K4's, which shares its blocking): 4 x 8 on 128
    # threads, 8 x 4 on 128 threads
    "k8_micro_4x8": {"unfused_cov.cu": ((G8, G8.replace("8, 8>", "4, 8>")),)},
    "k8_micro_8x4": {"unfused_cov.cu": ((G8, G8.replace("8, 8>", "8, 4>")),)},
    # K4 and K8's register budget: 255 (four blocks an SM, what an f32
    # P's shared memory allows), 168 (six, a bf16 P's)
    "pair_regs_255": {"unfused_cov.cu": ((G8, G8.replace("8, 8>", "8, 8, 255>")),)},
    "pair_regs_168": {"unfused_cov.cu": ((G8, G8.replace("8, 8>", "8, 8, 168>")),)},
    # K3 / K5 and K1's pass with 128 registers (eight blocks an SM; their
    # shared memory allows four)
    "fused_pair_regs_128": {"fused_cov.cu": (
        (PAIR_BLOCKS, PAIR_BLOCKS.replace("4", "8")),)},
    # K6's row stripe: 128 rows a block
    "k6_rows_128": {"unfused_cov.cu": ((G6, G6.replace("<64,", "<128,")),)},
    # register budgets: 128 everywhere; none (ptxas may use 255)
    "registers_128": {"unfused_cov.cu": (
        (G6, G6.replace("BN == 64 ? 255 : 128", "128")),)},
    "no_register_cap": {"common.cuh": (
        ("MIN_BLOCKS = 65536 / (REGS * THREADS)", "MIN_BLOCKS = 1"),)},
    # K4 and K8 without their epilogue: the fetch of P and the product
    "corr_timing_only_no_epilogue": {"unfused_cov.cu": (NO_EPILOGUE,)},
    # ... and without the fetch either: the product alone
    "corr_timing_only_product": {"unfused_cov.cu": (
        NO_EPILOGUE, (FETCH, "  unsigned bytes = 0;\n"))},
    # K4 and K8 without their product: the fetch and the epilogue
    "corr_timing_only_no_product": {"unfused_cov.cu": NO_PRODUCT},
    # K3 / K5: the two products alone (and K3's V prologue), no fetch of
    # P, no pass over its tiles, no store
    "k3_timing_only_product": {"fused_cov.cu": (
        (FETCH3, "  unsigned bytes = 0;\n"), *K3_NO_PASSES)},
    # K3's prologue alone: V = UN + ½·CN·EN, no k3_kernel
    "k3_timing_only_prologue": {"fused_cov.cu": (
        ("  return k3_launch(P, K, PHt, J8, keep, E, V, Pout, B, D, M2, r, s);",
         "  return D < 0 ? k3_launch(P, K, PHt, J8, keep, E, V, Pout, B, D, "
         "M2, r, s) : cudaSuccess;"),)},
    # ColPanel (K3 / K5's and K4's factors, K6's A) with every warp's loads
    # on one row instead of four: one cache line a load, as RowPanel's
    "colpanel_timing_only_one_line": {"common.cuh": ((
        """        r0(((static_cast<int>(threadIdx.x) >> 5) << 2) |
           (static_cast<int>(threadIdx.x) & 3)),""",
        """        r0((static_cast<int>(threadIdx.x) >> 5) << 2),"""),)},
    # ... and without the products: the fetch, the passes, the store
    "k3_timing_only_no_product": {"fused_cov.cu": (
        ("panel_product<G3>(acc, sm, 2 * tiles, lx, ly);",
         "panel_product<G3>(acc, sm, 0, lx, ly);"),
        ("panel_product<G3>(acc, sm, 2 * tiles2, ex, ey);",
         "panel_product<G3>(acc, sm, 0, ex, ey);"))},
    # K7 split: the norms form without its passes for the mean and Σwc²,
    # without its tiles' variances; either form without its global
    # stores, or without the copies that stage its operands
    "k7_timing_only_no_stats": {"ncc.cu": ((
        "    if constexpr (NORMS) {      // each pair's mean, then its Σwc²",
        "    if constexpr (NORMS) if (G.N < 0) {"),)},
    "k7_timing_only_no_var_tile": {"ncc.cu": ((
        "        var_tile<T, TY, TX>(", "        if (G.N < 0) var_tile<T, TY, TX>("),)},
    "k7_timing_only_no_stores": {"ncc.cu": ((
        "      if (oy0 + ty < R2 && ox0 + c < R2)",
        "      if (oy0 + ty < R2 && ox0 + c < R2 && v[ty][c] == 1e30f)"),)},
    "k7_timing_only_no_staging": {"ncc.cu": ((
        "    cp_async4(dst + w.p * bstride", "    if (count < 0) cp_async4(dst + w.p * bstride"),)},
    # K7 at t = 13 through the run-time-t loop (nothing compiled unrolled)
    "k7_runtime_t": {"ncc.cu": ((K7_UNROLLED,
                                 K7_UNROLLED.replace("13", "0")),)},
    # K1 and K2 without their product: the tile-pair pass (K1's with its
    # V prologue) alone
    "k12_timing_only_pass": {"fused_cov.cu": (
        (K1_PRODUCT, "  return cudaSuccess;"),
        (K2_PRODUCT, "  return cudaSuccess;"))},
    # eight_point_fit split by sweeps: none (the staging, the scaling, the
    # pick of f and the 3 x 3 solve, the stores, the launch), one, and
    # exactly six for every matrix (the most these systems need)
    "ep_timing_only_sweeps_0": {"eight_point.cu": (
        (EP_SWEEPS, EP_SWEEPS.replace("16", "0")),)},
    "ep_timing_only_sweeps_1": {"eight_point.cu": (
        (EP_SWEEPS, EP_SWEEPS.replace("16", "1")),)},
    "ep_timing_only_sweeps_6": {"eight_point.cu": (
        (EP_TEST, "    done = done || sweep == 6;"),)},
    # ... the rotation from IEEE divides and square roots (τ = d/h, then
    # sym.schur2 as written: four divides and two square roots in a chain)
    # in place of the special-function unit's approximations
    "ep_ieee_rotation": {"eight_point.cu": ((
        """  const int e = (__float_as_int(fmaxf(fabsf(d), fabsf(h))) >> 23) & 0xff;
  const float sc = __int_as_float((254 - e) << 23);
  const float d1 = d * sc, h1 = h * sc;
  const float x = fmaf(d1, d1, h1 * h1);
  t = copysignf(1.f, d) * h1 * ep_rcp(fmaf(x, ep_rsqrt(x), fabsf(d1)));
  const float y = fmaf(t, t, 1.f), c0 = ep_rsqrt(y);
  c = c0 * fmaf(-0.5f * y * c0, c0, 1.5f);""",
        """  const float tau = d / h;
  t = copysignf(1.f, tau) / (fabsf(tau) + sqrtf(1.f + tau * tau));
  c = 1.f / sqrtf(1.f + t * t);"""),)},
    # ... a round without its rotations (J = I): the exchanges and the
    # rows' update alone
    "ep_timing_only_no_rotation": {"eight_point.cu": ((
        "  if (ip == i || apq == 0.f) {", "  if (true) {"),)},
    # ... and the product alone, on the P the timing harness left in Pout
    "k12_timing_only_product": {"fused_cov.cu": (
        (K1_PASS, K1_PRODUCT.replace("return", "if (D > 0) return") + "\n"
         + K1_PASS),
        (K2_PASS, K2_PRODUCT.replace("return", "if (D > 0) return") + "\n"
         + K2_PASS))},
}


def build(name: str) -> ctypes.CDLL:
    """Build variant `name`; prints ptxas' lines for the timed kernels."""
    out = OUT / name
    out.mkdir(parents=True, exist_ok=True)
    for file in SOURCES:
        text = (_build.CSRC / file).read_text()
        for old, new in VARIANTS[name].get(file, ()):
            if old not in text:
                raise ValueError(f"{name}: {old!r} not in {file}")
            text = text.replace(old, new)
        (out / file).write_text(text)
    nvcc = _build._nvcc()
    cu = [out / f for f in SOURCES if f.endswith(".cu")]
    procs = [subprocess.Popen([nvcc, *_build.FLAGS, "-c", "-o",
                               str(p.with_suffix(".o")), str(p)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for p in cu]
    log = "".join(proc.communicate()[0] for proc in procs)
    if any(proc.returncode for proc in procs):
        raise RuntimeError(f"{name}: nvcc failed:\n{log}")
    link = subprocess.run([nvcc, *_build.LINK_FLAGS, "-o", str(out / "lib.so"),
                           *(str(p.with_suffix(".o")) for p in cu)],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"{name}: link failed:\n{link.stdout}"
                           f"{link.stderr}")
    kernel = None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '\w*?" + NAME, line)
        if entry:
            kernel = entry.group(1)
        elif kernel and kernel.startswith(TIMED) and (
                "registers" in line or "spill" in line):
            print(f"  [{name}] {kernel}: "
                  + line.replace("ptxas info    :", "").strip(), flush=True)
    lib = ctypes.CDLL(str(out / "lib.so"))
    for fn in ("ekf_k1_manage_predict_pht", "ekf_k2_update_tail_pht",
               "ekf_k3_update_tail_add", "ekf_k4_corr_apply_cols",
               "ekf_k5_update_tail", "ekf_k6_matmul_big",
               "ekf_k7_ncc_corr", "ekf_k7_ncc_corr_norms",
               "ekf_k8_corr_apply", "ekf_eight_point_fit"):
        getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def cuda_ms(fn, n: int = 20) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def graph_ms(fn, n: int = 20) -> float:
    """Mean time of fn() over n calls captured in one CUDA graph and
    replayed, by CUDA events: the kernels' device time without the
    launches' host cost, which cuda_ms reads too where a call is shorter."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    return cuda_ms(g.replay, 5) / n


def launcher(fn, *args):
    def run():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: cudaError_t {err}")
    return run


def loop_mix(lib_path, wanted=PANEL) -> dict:
    """{kernel: (instructions, {opcode: count})} of the multiply loop of
    each wanted kernel: of the loops (a backward branch and its target)
    with at least 256 FFMAs, the one with the largest FFMA share (a longer
    range that also spans other code has more FFMAs and a smaller
    share)."""
    sass = subprocess.run(["cuobjdump", "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    mixes = {}
    for body in sass.split("Function :")[1:]:
        name = re.search(NAME, body)
        if not name or not name.group(1).startswith(wanted):
            continue
        ops = [(int(m.group(1), 16), m.group(2), m.group(0))
               for m in re.finditer(
                   r"/\*([0-9a-f]{4})\*/\s+(?:@!?U?P\d\s+)?([A-Z0-9_.]+)[^\n]*",
                   body)]
        best, share = [], 0.0
        for addr, op, text in ops:
            target = re.search(r"BRA\s+(?:\w+,\s*)?0x([0-9a-f]+)", text)
            if op.startswith("BRA") and target and int(target.group(1),
                                                       16) < addr:
                loop = [o.split(".")[0] for a, o, _ in ops
                        if int(target.group(1), 16) <= a <= addr]
                ffma = loop.count("FFMA")
                if ffma >= 256 and ffma / len(loop) > share:
                    best, share = loop, ffma / len(loop)
        mixes[name.group(1)] = (len(best), dict(
            collections.Counter(best).most_common(8)))
    return mixes


def ep_systems(dev, seed: int = 0) -> torch.Tensor:
    """The 8-point systems (N, 9, 9) of one fundamental_ransac at the loop
    path's width: B·top_k = 28 candidates of 512 keypoints, 30% valid, 64
    hypotheses (N = 1,792); correspondences a shift plus 0.5 px of noise,
    near-degenerate as a pan's are. The card tests use them too."""
    from ekf_slam_tpu_torch.models import loopclosure as lc
    g = torch.Generator().manual_seed(seed)
    pts1 = torch.rand(28, 512, 2, generator=g) * torch.tensor([192.0, 256.0])
    pts2 = (pts1 + torch.tensor([3.0, 1.0])
            + 0.5 * torch.randn(28, 512, 2, generator=g))
    valid = torch.rand(28, 512, generator=g) < 0.3
    draws = torch.rand(28, 64, 512, generator=g)
    with kernels.capture_operands() as ops:
        lc.fundamental_ransac(pts1, pts2, valid, lc.LoopConfig(), draws)
    return ops["eight_point_fit"][0][0].to(dev)


def sweep_mix(lib_path) -> tuple:
    """(instructions, {opcode: count}) of eight_point_fit's longest loop,
    its sweep of nine rounds, from cuobjdump -sass."""
    sass = subprocess.run(["cuobjdump", "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    body = next(b for b in sass.split("Function :")[1:] if "ep_kernel" in
                b.split("\n", 1)[0])
    ops = [(int(m.group(1), 16), m.group(2)) for m in re.finditer(
        r"/\*([0-9a-f]{4})\*/\s+(?:@!?U?P\d\s+)?([A-Z0-9_.]+)([^\n]*)",
        body)]
    best = []
    for m in re.finditer(r"/\*([0-9a-f]{4})\*/\s+(?:@!?U?P\d\s+)?BRA\s+"
                         r"(?:\w+,\s*)?0x([0-9a-f]+)", body):
        addr, target = int(m.group(1), 16), int(m.group(2), 16)
        loop = [o.split(".")[0] for a, o in ops if target <= a <= addr]
        if target < addr and len(loop) > len(best):
            best = loop
    return len(best), dict(collections.Counter(best).most_common(14))


def operands(dev) -> dict:
    """Random operands at the bench shapes, P symmetric."""
    g = torch.Generator(dev).manual_seed(0)
    n = lambda *shape: torch.randn(*shape, device=dev, generator=g)
    P = n(B, D, D)
    P = 0.5 * (P + P.transpose(1, 2))
    ops = {"P": {torch.float32: P, torch.bfloat16: P.to(torch.bfloat16)},
           "H": {k: n(B, D, k) for k in sorted({k for _, _, k in K6_SITES})},
           "At": n(B, K8_R, D), "Bt": n(B, K8_R, D),
           "A4": {t: n(B, D, r) for t, r in K4_R.items()},
           "B4": {t: n(B, D, r) for t, r in K4_R.items()},
           "K": n(B, D, K3_M2), "PHt": n(B, D, K3_M2),
           "J8": torch.eye(8, device=dev).repeat(B, 1, 1),
           "keep": torch.ones(B, D, device=dev),
           "E": n(B, K3_R, D), "U": n(B, K3_R, D), "V": n(B, K3_R, D),
           "Ht": n(B, D, K1_R), "E6": n(B, K1_r, D), "U6": n(B, K1_r, D),
           "V6": n(B, K1_r, D), "F16": torch.eye(16, device=dev).repeat(B, 1, 1),
           "Q16": torch.zeros(B, 16, 16, device=dev)}
    ops["win"] = torch.rand(K7_N, K7_W2, K7_W2, device=dev, generator=g)
    tm = n(K7_N, K7_T, K7_T)
    ops["tm"] = tm - tm.mean(dim=(1, 2), keepdim=True)
    C = n(B, K3_R, K3_R)
    ops["C"] = 0.5 * (C + C.transpose(1, 2))
    C = n(B, K1_r, K1_r)
    ops["C66"] = 0.5 * (C + C.transpose(1, 2))
    ops["M9"] = ep_systems(dev)
    return ops


def library_times(o) -> dict:
    P32 = o["P"][torch.float32]
    lib = {site: cuda_ms(lambda n=n: torch.bmm(P32, o["H"][n]))
           for site, _, n in K6_SITES}
    lib[f"f32_N{K1_R}"] = cuda_ms(lambda: torch.bmm(P32, o["Ht"]))
    XY = torch.cat([o["At"], o["Bt"]], 1).transpose(1, 2), torch.cat(
        [o["Bt"], o["At"]], 1)
    lib["k8_expr"] = cuda_ms(lambda: torch.baddbmm(P32, *XY, alpha=0.5))
    for t in K4_R:
        A, Bf = o["A4"][t], o["B4"][t]
        XY4 = torch.cat([A, Bf], 2), torch.cat([Bf, A], 2).transpose(1, 2)
        lib[f"k4_{t}"] = cuda_ms(lambda XY4=XY4: torch.baddbmm(P32, *XY4,
                                                               alpha=0.5))
    lib["k7_conv"] = cuda_ms(lambda: torch.nn.functional.conv2d(
        o["win"][None], o["tm"][:, None], groups=K7_N))
    return lib


def time_variant(lib, o, dev) -> dict:
    times = {}
    ptr = lambda t: t.data_ptr()
    for site, dtype, n in K6_SITES:
        out = torch.empty(B, D, n, device=dev)
        times["k6_" + site] = cuda_ms(launcher(
            lib.ekf_k6_matmul_big, ptr(o["P"][dtype]), ptr(o["H"][n]),
            ptr(out), B, D, D, n, int(dtype == torch.bfloat16)))
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        P = o["P"][dtype]
        out = torch.empty_like(P)
        for mode, mode_name in enumerate(("none", "expr", "full")):
            times[f"k8_{mode_name}_{tag}"] = cuda_ms(launcher(
                lib.ekf_k8_corr_apply, ptr(P), ptr(o["At"]), ptr(o["Bt"]),
                ptr(out), B, D, K8_R, mode, int(dtype == torch.bfloat16)))
        times[f"k4_{tag}"] = cuda_ms(launcher(
            lib.ekf_k4_corr_apply_cols, ptr(P), ptr(o["A4"][tag]),
            ptr(o["B4"][tag]), ptr(out), B, D, K4_R[tag],
            int(dtype == torch.bfloat16)))
    P = o["P"][torch.float32]
    out = torch.empty_like(P)
    times["k3"] = cuda_ms(launcher(
        lib.ekf_k3_update_tail_add, *map(ptr, (
            P, o["K"], o["PHt"], o["J8"], o["keep"], o["E"], o["U"], o["C"],
            o["V"], out)), B, D, K3_M2, K3_R))
    times["k5"] = cuda_ms(launcher(
        lib.ekf_k5_update_tail, *map(ptr, (P, o["K"], o["PHt"], o["J8"],
                                           out)), B, D, K3_M2))
    # K1 and K2 write P_new to `out` and read it back for the product; it
    # starts as P, so the product-only variants multiply real values
    out.copy_(P)
    pht = torch.empty(B, D, K1_R, device=dev)
    times[f"k6_f32_N{K1_R}"] = cuda_ms(launcher(
        lib.ekf_k6_matmul_big, ptr(P), ptr(o["Ht"]), ptr(pht), B, D, D, K1_R,
        0))
    times["k1"] = cuda_ms(launcher(
        lib.ekf_k1_manage_predict_pht, *map(ptr, (
            P, o["keep"], o["E6"], o["U6"], o["C66"], o["F16"], o["Q16"],
            o["Ht"], o["V6"], out, pht)), B, D, K1_R, K1_r))
    R2 = K7_W2 - K7_T + 1
    corr = torch.empty(K7_N, R2, R2, device=dev)
    var, energy = torch.empty_like(corr), torch.empty(K7_N, device=dev)
    times["k7_corr"] = cuda_ms(launcher(
        lib.ekf_k7_ncc_corr, ptr(o["win"]), ptr(o["tm"]), ptr(corr), K7_N,
        K7_W2, K7_T))
    times["k7_norms"] = cuda_ms(launcher(
        lib.ekf_k7_ncc_corr_norms, *map(ptr, (o["win"], o["tm"], corr, var,
                                              energy)), K7_N, K7_W2, K7_T))
    times["k2"] = cuda_ms(launcher(
        lib.ekf_k2_update_tail_pht, *map(ptr, (
            P, o["K"], o["PHt"], o["J8"], o["Ht"], out, pht)), B, D, K3_M2,
        K1_R))
    for n in EP_N:
        M9 = o["M9"][:n].contiguous()
        F2 = torch.empty(n, 3, 3, device=dev)
        times[f"ep_N{n}"] = graph_ms(launcher(
            lib.ekf_eight_point_fit, ptr(M9), ptr(F2), 0, n))
    return times


def width_sweep(dev) -> dict:
    """{width: {"k5": ms, "k4": ms}}: K5 and K4 through the port's
    wrappers on a symmetric f32 P with (B, D, width) factors."""
    g = torch.Generator(dev).manual_seed(0)
    P = torch.randn(B, D, D, device=dev, generator=g)
    P = 0.5 * (P + P.transpose(1, 2))
    J = torch.eye(4, device=dev).repeat(B, 1, 1)
    out = {}
    for w in WIDTHS:
        K = torch.randn(B, D, w, device=dev, generator=g)
        H = torch.randn(B, D, w, device=dev, generator=g)
        out[w] = {"k5": cuda_ms(lambda: kernels.fused_update_tail(P, K, H, J)),
                  "k4": cuda_ms(lambda: kernels.corr_apply_cols(P, K, H))}
        tiles = 2 * ((w + 7) // 8)          # 8-deep stages of [K | PHt]
        print(f"[width] M2=R={w} row_bytes={4 * w} " + " ".join(
            f"{k}_ms={v:.4f} {k}_per_tile={v / tiles:.5f}"
            for k, v in out[w].items()), flush=True)
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("variants", nargs="*", default=["base"],
                        help=f"of {', '.join(VARIANTS)} (default: base)")
    parser.add_argument("--sass", action="store_true")
    parser.add_argument("--widths", action="store_true")
    args = parser.parse_args()
    unknown = [v for v in args.variants if v not in VARIANTS]
    if unknown:
        parser.error(f"unknown variant(s) {unknown}")
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)

    dev = torch.device("cuda")
    o = operands(dev)
    result = {"card": card, "library_ms": library_times(o), "variants": {}}
    print("[library] " + " ".join(f"{k}={v:.4f}" for k, v in
                                  result["library_ms"].items()), flush=True)
    for name in args.variants:
        times = time_variant(build(name), o, dev)
        result["variants"][name] = times
        print(f"[variant] name={name} " + " ".join(
            f"{k}={v:.4f}" for k, v in times.items()), flush=True)
    if args.widths:
        result["widths"] = width_sweep(dev)
    if args.sass:
        result["loop_mix"] = loop_mix(OUT / args.variants[0] / "lib.so")
        for kernel, (count, mix) in result["loop_mix"].items():
            print(f"[sass] {kernel} loop={count} ffma_share="
                  f"{mix.get('FFMA', 0) / max(count, 1):.3f} {mix}", flush=True)
        result["ep_sweep_mix"] = sweep_mix(OUT / args.variants[0] / "lib.so")
        print(f"[sass] ep_kernel sweep={result['ep_sweep_mix'][0]} "
              f"{result['ep_sweep_mix'][1]}", flush=True)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
