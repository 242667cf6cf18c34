"""One run of one cell: set-up, the measured window, the traced slice, the
comparison with the reference, and the result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                            --trace <0|1>

Set-up (counted in ``setup_s``, from the process's start to the first
timed call): the imports, the inputs made from the seed and the
program's initial state (``Session``), then warm-up calls, one pass over
the sequence and one call more, the first of which builds the kernels
(or finds them built in ``build/kernels/``) and captures the frame. The
window then calls the timed entry back to back, each call ending when its
camera block is on the host, until ``--seconds`` have passed; the last
call runs to its end, and the window is every call's time. With
``--trace 1`` a fixed slice of ``traced_calls`` calls follows the window
under torch.profiler; the per-layer metrics read it.

The result is the last line of standard output, one JSON object:
``correct``, ``attempted`` (instance-frames of the window) and ``failed``
(those whose camera block is not finite), ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, then ``notes`` (the
set-up's parts, the card's power limit, how many instances' trajectories
differ, the parted reference frames) and
last ``checks``, each number compared beside its limit; the checks are
also the last lines of standard error.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from benchmark.harness import guard, spec, trace, verdict
from benchmark.roofline import arith
from ekf_slam_tpu_torch.filter import graph
from ekf_slam_tpu_torch.ops import kernels

# --control tf32: the program with TF32 matrix products switched on, the
# precision just below the configurations' float32 with TF32 off. It must
# come out not correct; the benchmark's own runs never take it.
CONTROLS = ("tf32",)


def window(session, seconds: float) -> dict:
    """Calls back to back until `seconds` have passed since the first."""
    calls, cams, frames_of = [], [], []
    t_first = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        if calls and t0 - t_first >= seconds:
            break
        returned, cam, frames = session.call()
        calls.append((t0, returned, time.perf_counter()))
        cams.append(cam)
        frames_of.append(frames)
    return dict(calls=calls, cams=cams, frames_of=frames_of)


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unread ({e})"
    return out.stdout.strip() or f"unread ({out.stderr.strip()})"


def run_cell(c: dict, seed: int, seconds: float, traced: bool, device,
             t_start: float, control: str | None = None) -> dict:
    """Run cell `c` (spec.cell) on `device`; returns the result line's
    object."""
    traffic, conf = c["traffic"], c["config"]
    torch.backends.cuda.matmul.allow_tf32 = control == "tf32"
    torch.backends.cudnn.allow_tf32 = control == "tf32"
    on_card = torch.device(device).type == "cuda"
    notes = {"import_s": time.perf_counter() - t_start}
    recorded = None
    if traced:
        recorded = trace.record_kernel_calls(kernels)

    t = time.perf_counter()
    session = c["driver"].Session(conf["engine"], traffic, seed, device)
    notes["inputs_s"] = time.perf_counter() - t
    t = time.perf_counter()
    per_pass = traffic["sequence_frames"] // traffic["frames_per_call"]
    for _ in range(per_pass + 1):
        session.call()
    session.restart()
    if on_card:
        torch.cuda.synchronize(device)
    notes["warm_s"] = time.perf_counter() - t
    notes["capture_s"] = graph.last_capture_s()
    setup_s = time.perf_counter() - t_start

    w = window(session, seconds)
    memory = (torch.cuda.max_memory_allocated(device) if on_card else None)
    rec = dict(calls=w["calls"], instances=session.instances,
               frames_per_call=session.frames_per_call, setup_s=setup_s,
               memory_peak_bytes=memory, capture_s=notes["capture_s"])
    result_device = {"platform": "gpu" if on_card else "cpu",
                     "kind": (torch.cuda.get_device_name(device)
                              if on_card else "cpu"),
                     "count": c["workload"]["chips"],
                     "memory_peak_bytes": memory}
    breakdown = None
    if traced:
        def traced_call():
            _, cam, frames = session.call()
            w["cams"].append(cam)
            w["frames_of"].append(frames)

        prof = trace.profile(traced_call, traffic["traced_calls"])
        rec.update(trace.collect(prof))
        del prof
        rec["frames"] = traffic["traced_calls"] * session.frames_per_call
        rec["symbols"] = spec.load_json(spec.HERE / "roofline"
                                        / "kernel_symbols.json")
        try:
            launches = graph.last_captured().launches
        except StopIteration:           # no frame captured: nothing counted
            launches = {}
        rec["kernel_calls"] = trace.kernel_calls(recorded, launches, arith,
                                                 rec["symbols"])
        busy_us, window_us = trace.busy(rec)
        result_device.update(busy_s=busy_us / 1e6, window_s=window_us / 1e6)
        breakdown = trace.breakdown(rec)
        notes["power"] = power_limit()

    traj = verdict.first_pass(w)
    rows = verdict.sample_rows(seed, traj, traffic["sampled_instances"])
    notes["distinct"] = verdict.distinct(traj)
    t = time.perf_counter()
    values, parted = verdict.numbers(session, w, rows, c["limits"],
                                     min(8, os.cpu_count() or 1))
    checks, ok = verdict.judge(values, c["limits"])
    notes["verdict_s"] = time.perf_counter() - t
    notes["parted"] = parted[:20]

    metrics = {}
    for m in (c["per_layer"] if traced else c["end_to_end"]):
        value = spec.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    steps = len(w["calls"]) * session.instances * session.frames_per_call
    out = {"correct": ok, "attempted": steps,
           "failed": checks["nonfinite"]["value"], "metrics": metrics,
           "device": result_device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["notes"] = notes
    out["checks"] = checks
    return out


def parse(argv):
    p = argparse.ArgumentParser(description="One run of one benchmark cell.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=CONTROLS, default=None)
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    c = spec.cell(spec.benchmark(), args.workload)
    chips = c["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell needs {chips} CUDA device(s); torch "
              f"sees {seen}", file=sys.stderr)
        return 3
    out = run_cell(c, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), t_start, args.control)
    found = guard.forbidden(sys.modules)
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 4
    print(json.dumps(out, default=_plain), flush=True)
    for p in out["notes"].get("parted", []):
        print(f"parted {json.dumps(p, default=_plain)}", file=sys.stderr)
    for name, chk in out["checks"].items():
        print(f"check {name} {chk['value']!r} limit {chk['limit']!r}",
              file=sys.stderr, flush=True)
    return 0


def _plain(v):
    if isinstance(v, np.generic):
        return v.item()
    raise TypeError(f"{type(v)} is not JSON")
