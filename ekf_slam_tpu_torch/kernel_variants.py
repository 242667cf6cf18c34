"""Time K6 and K8 as built, and as built with one design choice changed,
on one CUDA card: the evidence behind the choices in csrc/unfused_cov.cu
and csrc/common.cuh, and the tool for the next one.

    python -m ekf_slam_tpu_torch.kernel_variants [variant ...] [--sass]

A variant is a list of text substitutions on the two sources. Each is
built into its own library under build/variants/<name>/ (one nvcc, a few
seconds), bound by ctypes and timed at the bench shapes (B = 128,
D = 613) on random operands: K6 at its four call sites (A in f32 with
N = 128 and 64, A in bf16 with N = 48 and 64) beside ``torch.bmm``, K8 in
its three modes on a bf16 and an f32 P (R = 56) beside ``torch.baddbmm``;
CUDA events, the mean of 20 launches after 3 warm ones. Variants whose
name says ``timing_only`` skip part of the work and give wrong outputs:
they split a kernel's time into its phases. ``--sass`` also prints, for
every K6 / K8 kernel of the first variant, the instruction mix of its
multiply loop from ``cuobjdump -sass`` (the share of FFMA among the
instructions of the multiply loop).

Prints the card's name and power limit, ptxas' registers and spills of the
K6 / K8 kernels of each variant, one line of times (ms) a variant, and as
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

from ekf_slam_tpu_torch.ops import _build

OUT = _build.BUILD_DIR.parent / "variants"
B, D, R = 128, 613, 56
K6_SITES = (("f32_N128", torch.float32, 128), ("f32_N64", torch.float32, 64),
            ("bf16_N48", torch.bfloat16, 48), ("bf16_N64", torch.bfloat16, 64))
G8 = "using G8 = Blocking<PT_TILE, PT_TILE, 8, 8>;"
G6 = "using G6 = Blocking<64, BN, 8, 8, BN == 64 ? 255 : 128>;"
FETCH = """  unsigned bytes = PTile<PT>::template fetch<G8::THREADS>(raw_ij, P, D, i0,
                                                          j0, mbar);
  if (twin)
    bytes += PTile<PT>::template fetch<G8::THREADS>(raw_ji, P, D, j0, i0,
                                                    mbar);
"""
EPILOGUE = "  store_tile_pair<PT, G8::THREADS>(Pout,"
NO_EPILOGUE = (EPILOGUE, "  if (D < 0) store_tile_pair<PT, G8::THREADS>(Pout,")
# name -> ((old, new) substitutions on unfused_cov.cu, on common.cuh)
VARIANTS = {
    "base": ((), ()),
    # K8's micro-tile: 4 x 8 on 128 threads, 8 x 4 on 128 threads
    "k8_micro_4x8": (((G8, G8.replace("8, 8>", "4, 8>")),), ()),
    "k8_micro_8x4": (((G8, G8.replace("8, 8>", "8, 4>")),), ()),
    # K6's row stripe: 128 rows a block
    "k6_rows_128": (((G6, G6.replace("<64,", "<128,")),), ()),
    # register budgets: 128 everywhere; none (ptxas may use 255)
    "registers_128": (((G6, G6.replace("BN == 64 ? 255 : 128", "128")),), ()),
    "no_register_cap": ((), (("MIN_BLOCKS = 65536 / (REGS * THREADS)",
                              "MIN_BLOCKS = 1"),)),
    # K8 without its epilogue: the fetch of P and the product
    "k8_timing_only_no_epilogue": ((NO_EPILOGUE,), ()),
    # ... and without the fetch either: the product alone
    "k8_timing_only_product": ((NO_EPILOGUE, (FETCH, "  unsigned bytes = 0;\n")),
                               ()),
    # K8 without its product: the fetch and the epilogue
    "k8_timing_only_no_product": (
        (("mode == 0 ? tiles : 2 * tiles, lx, ly", "0, lx, ly"),), ()),
}


def build(name: str) -> ctypes.CDLL:
    """Build variant `name`; prints ptxas' lines for the K6 / K8 kernels."""
    subs, common_subs = VARIANTS[name]
    out = OUT / name
    out.mkdir(parents=True, exist_ok=True)
    for file, edits in (("unfused_cov.cu", subs), ("common.cuh", common_subs)):
        text = (_build.CSRC / file).read_text()
        for old, new in edits:
            if old not in text:
                raise ValueError(f"{name}: {old!r} not in {file}")
            text = text.replace(old, new)
        (out / file).write_text(text)
    proc = subprocess.run(
        [_build._nvcc(), *_build.FLAGS, *_build.LINK_FLAGS, "-o",
         str(out / "lib.so"), str(out / "unfused_cov.cu")],
        capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed:\n{log}")
    kernel = None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '\w*?(k\d_kernelI\w*?)"
                          r"EEv", line)
        if entry:
            kernel = entry.group(1)
        elif kernel and kernel[:2] in ("k6", "k8") and (
                "registers" in line or "spill" in line):
            print(f"  [{name}] {kernel}: "
                  + line.replace("ptxas info    :", "").strip(), flush=True)
    lib = ctypes.CDLL(str(out / "lib.so"))
    for fn, argtypes in _build.SIGNATURES.items():
        if fn in ("ekf_k6_matmul_big", "ekf_k8_corr_apply"):
            getattr(lib, fn).argtypes = argtypes
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


def launcher(fn, *args):
    def run():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: cudaError_t {err}")
    return run


def loop_mix(lib_path, wanted=("k6_kernel", "k8_kernel")) -> dict:
    """{kernel: (instructions, {opcode: count})} of the loop (a backward
    branch and its target) with the most FFMAs of each wanted kernel."""
    sass = subprocess.run(["cuobjdump", "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    mixes = {}
    for body in sass.split("Function :")[1:]:
        name = re.search(r"(k\d_kernelI\w*?)EEv", body)
        if not name or not name.group(1).startswith(wanted):
            continue
        ops = [(int(m.group(1), 16), m.group(2), m.group(0))
               for m in re.finditer(
                   r"/\*([0-9a-f]{4})\*/\s+(?:@!?U?P\d\s+)?([A-Z0-9_.]+)[^\n]*",
                   body)]
        best = []
        for addr, op, text in ops:
            target = re.search(r"BRA\s+(?:\w+,\s*)?0x([0-9a-f]+)", text)
            if op.startswith("BRA") and target and int(target.group(1),
                                                       16) < addr:
                loop = [o.split(".")[0] for a, o, _ in ops
                        if int(target.group(1), 16) <= a <= addr]
                if loop.count("FFMA") > best.count("FFMA"):
                    best = loop
        mixes[name.group(1)] = (len(best), dict(
            collections.Counter(best).most_common(8)))
    return mixes


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("variants", nargs="*", default=["base"],
                        help=f"of {', '.join(VARIANTS)} (default: base)")
    parser.add_argument("--sass", action="store_true")
    args = parser.parse_args()
    unknown = [v for v in args.variants if v not in VARIANTS]
    if unknown:
        parser.error(f"unknown variant(s) {unknown}")
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)

    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)
    P = torch.randn(B, D, D, device=dev, generator=g)
    P = {torch.float32: P, torch.bfloat16: P.to(torch.bfloat16)}
    H = {n: torch.randn(B, D, n, device=dev, generator=g)
         for n in sorted({n for _, _, n in K6_SITES})}
    At = torch.randn(B, R, D, device=dev, generator=g)
    Bt = torch.randn(B, R, D, device=dev, generator=g)
    XY = torch.cat([At, Bt], 1).transpose(1, 2), torch.cat([Bt, At], 1)
    result = {"card": card, "library_ms": {
        **{site: cuda_ms(lambda: torch.bmm(P[torch.float32], H[n]))
           for site, _, n in K6_SITES},
        "k8_expr": cuda_ms(lambda: torch.baddbmm(P[torch.float32], *XY,
                                                 alpha=0.5))}, "variants": {}}
    print("[library] " + " ".join(f"{k}={v:.4f}" for k, v in
                                  result["library_ms"].items()), flush=True)
    for name in args.variants:
        lib = build(name)
        times = {}
        for site, dtype, n in K6_SITES:
            out = torch.empty(B, D, n, device=dev)
            times["k6_" + site] = cuda_ms(launcher(
                lib.ekf_k6_matmul_big, P[dtype].data_ptr(), H[n].data_ptr(),
                out.data_ptr(), B, D, D, n, int(dtype == torch.bfloat16)))
        for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            out = torch.empty_like(P[dtype])
            for mode, mode_name in enumerate(("none", "expr", "full")):
                times[f"k8_{mode_name}_{tag}"] = cuda_ms(launcher(
                    lib.ekf_k8_corr_apply, P[dtype].data_ptr(), At.data_ptr(),
                    Bt.data_ptr(), out.data_ptr(), B, D, R, mode,
                    int(dtype == torch.bfloat16)))
        result["variants"][name] = times
        print(f"[variant] name={name} " + " ".join(
            f"{k}={v:.4f}" for k, v in times.items()), flush=True)
    if args.sass:
        result["loop_mix"] = loop_mix(OUT / args.variants[0] / "lib.so")
        for kernel, (count, mix) in result["loop_mix"].items():
            print(f"[sass] {kernel} loop={count} ffma_share="
                  f"{mix.get('FFMA', 0) / max(count, 1):.3f} {mix}", flush=True)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
