"""Measure this checkout beside another tree of the repo on one CUDA card,
in one command, so that the two are compared on the same card and clock:

1. ``chip_smoke.py`` four times, in the order other, this, this, other;
2. ``python -m ekf_slam_tpu_torch.profile_slice <path>`` on each of the
   seven paths, the other tree first, then this one;
3. ``python -m ekf_slam_tpu_torch.kernel_variants`` with the variants
   given (``--sass`` passed on), on this tree.

The other tree is typically the parent commit, unpacked beside the
checkout in a directory that .gitignore lists:

    mkdir -p build/parent && git archive HEAD | tar -x -C build/parent
    python -m ekf_slam_tpu_torch.compare_trees --parent build/parent \\
        --out build/compare base k12_timing_only_pass --sass

Each run's whole output goes to its own file under --out (smoke_<tag>.txt,
prof_<tree>_<path>.txt, variants.txt), and one line a run to stdout: its
exit code, then some of the lines the records read (the card, the
profiles' summaries, the variants' times, registers and FFMA shares, the
kernels' and planted faults' lines of the first smoke of this tree).
Exits non-zero if any run failed.
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PATHS = ("fused", "unfused", "unfused_pallas", "fast", "fast_rows", "image",
         "image_descriptor")
SMOKES = (("other1", "other"), ("this1", "this"), ("this2", "this"),
          ("other2", "other"))


def run(cmd: list, cwd: pathlib.Path, out: pathlib.Path, timeout: int) -> int:
    """Run `cmd` in `cwd`, its output to `out`; its exit code (124 past
    the time limit)."""
    with out.open("w") as f:
        try:
            return subprocess.run(cmd, cwd=cwd, stdout=f,
                                  stderr=subprocess.STDOUT,
                                  timeout=timeout).returncode
        except subprocess.TimeoutExpired:
            return 124


def lines(path: pathlib.Path, *starts: str) -> list:
    return [line for line in path.read_text(errors="replace").splitlines()
            if line.startswith(starts)]


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("variants", nargs="*", default=["base"],
                        help="kernel_variants' variants (default: base)")
    parser.add_argument("--parent", type=pathlib.Path, required=True,
                        help="the other tree's root")
    parser.add_argument("--out", type=pathlib.Path,
                        default=ROOT / "build" / "compare")
    parser.add_argument("--sass", action="store_true")
    args = parser.parse_args(argv)
    trees = {"other": args.parent.resolve(), "this": ROOT}
    if not (trees["other"] / "chip_smoke.py").exists():
        parser.error(f"{args.parent} holds no chip_smoke.py")
    args.out.mkdir(parents=True, exist_ok=True)
    py = sys.executable
    failed = 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for tag, tree in SMOKES:
        rc = run([py, "chip_smoke.py"], trees[tree],
                 args.out / f"smoke_{tag}.txt", 1200)
        failed += rc != 0
        print(f"[smoke] tree={tag} rc={rc}", flush=True)
    for path in PATHS:
        for tree in ("other", "this"):
            out = args.out / f"prof_{tree}_{path}.txt"
            rc = run([py, "-m", "ekf_slam_tpu_torch.profile_slice", path],
                     trees[tree], out, 600)
            failed += rc != 0
            print(f"[prof] tree={tree} path={path} rc={rc}", flush=True)
            for line in lines(out, "[profile] route=kernels"):
                print("  " + line[:300], flush=True)
    out = args.out / "variants.txt"
    rc = run([py, "-m", "ekf_slam_tpu_torch.kernel_variants", *args.variants,
              *(["--sass"] if args.sass else [])], ROOT, out, 1800)
    failed += rc != 0
    print(f"[variants] rc={rc}", flush=True)
    for line in lines(out, "[library]", "[variant]", "[sass]", "  ["):
        print(line[:700], flush=True)
    smoke = args.out / "smoke_this1.txt"
    for line in lines(smoke, "[kernel]", "[fault]"):
        print(line[:500], flush=True)
    raise SystemExit(1 if failed else 0)


if __name__ == "__main__":
    main()
