"""What decides ``correct``: the timed path's outputs against the reference.

The filters are chaotic in their discrete decisions (χ² gates, RANSAC's
inlier tests, NCC's argmax): float32 and float64 runs of one sequence part
at a decision that lies within rounding of its threshold, in some tenth of
the instances over 16 frames, and then follow different, equally right
branches. So the reference follows the program frame by frame: once the
window has closed, the sequence is run again through the same entry and
its captured frame, one frame a call (``Session.rerun``), and each frame
of a sample of instances is held against one float64 reference frame from
the program's own state before it. Two checks tie that re-run to the
window and to the start: every call of the window must have put on the
host exactly, bit for bit, what the re-run gives for its frames, for every
instance; and the program's first state must be the reference's own (the
bootstrap from frame 0, or the empty map).

Even one frame can part where a decision lies within rounding of its
threshold (an NCC score tie of 1.7e-7 between two pixels was seen on the
card). The reference notes each decision within NEAR of its threshold;
where a frame parts from the program, or passes a limit, the decisions
within their turn limit are turned one at a time, and the frame is
judged on the first branch that agrees with the program. The parted frames, their
near decisions and the one turned are reported beside the checks.

The filters of a cell share one sequence of observations (or frames) and
differ only in their RANSAC draws, so many of them take the same
decisions and run alike bit for bit. The sample is one instance from each
of ``sampled_instances`` equal blocks of the batch, so that a fault in a
part of the batch is drawn, each drawn from the seed among the instances
of its block whose camera trajectory over the window's first pass (the
outcome of their RANSAC draws) no instance drawn before shares, where the
block has one: a fault that mixes instances then shows where they
differ. How many trajectories differ in the batch is reported beside the
checks (``distinct``). The numbers compared, each with the cell's limit
(``limits/<cell>.json``):

* ``rerun_gap``: the largest gap between a window call's camera blocks
  and the re-run's (every instance; infinite where a value is not a
  number in one and not the other);
* ``cam_err``: the largest absolute gap of the camera block [r q v w]
  after a frame;
* ``state_err``: the largest absolute gap of the state after a frame over
  the camera block and every live feature, and of the appearance store's
  new entries (patch, pose, pixel) where the cell has one;
* ``cov_err``: the largest gap of the covariance after a frame over the
  same entries, each in units of its Cauchy-Schwarz bound
  sqrt(P_ii·P_jj) (the reference's), a variance below VAR_FLOOR of the
  largest held at that floor: the reference skips an update without
  measurements (update.m) where the program still applies the
  quaternion's renormalization, which moves only the initial pose
  variance of 2.2e-16, and moves it to 0;
* ``count_parts``: the sampled instance-frames in which the gate counts
  (individually compatible, low- and high-innovation inliers), the live
  slots, their parametrization, counters or landmark ids differ;
* ``nonfinite``: the window's instance-frames whose camera block is not
  finite, over the whole batch.

A number that is not a number fails its limit.
"""

from __future__ import annotations

import math
import os
import pickle
import subprocess
import sys

import numpy as np

from benchmark.harness import spec
from benchmark.reference.frontend import STORE_FIELDS
from benchmark.reference.slam import turn_limit

NUMBERS = ("rerun_gap", "cam_err", "state_err", "cov_err", "count_parts",
           "nonfinite")
VAR_FLOOR = 1e-9
SLOT_FIELDS = ("times_predicted", "times_measured", "landmark_id")


def first_pass(window: dict) -> np.ndarray:
    """(B, frames, 13): each instance's camera blocks over the first call
    of each sequence frame that the window ran."""
    first = {}
    for cam, frames in zip(window["cams"], window["frames_of"]):
        for k, f in enumerate(frames):
            first.setdefault(f, cam[:, k])
    return np.stack([first[f] for f in sorted(first)], axis=1)


def distinct(traj: np.ndarray) -> int:
    """How many instances' trajectories differ from each other."""
    return len({t.tobytes() for t in traj})


def sample_rows(seed: int, traj: np.ndarray, count: int) -> list:
    """One instance drawn from each of `count` equal blocks of the batch,
    among those whose trajectory `traj` (first_pass) no instance drawn
    before shares, where the block has one."""
    rng = np.random.default_rng([seed, 1])
    rows, seen = [], set()
    for block in np.array_split(np.arange(len(traj)), min(count, len(traj))):
        order = [int(i) for i in rng.permutation(block)]
        row = next((i for i in order if traj[i].tobytes() not in seen),
                   order[0])
        seen.add(traj[row].tobytes())
        rows.append(row)
    return rows


def window_gap(cams: list, frames_of: list, rerun_cams: list) -> float:
    gap = 0.0
    for cam, frames in zip(cams, frames_of):
        want = np.stack([rerun_cams[f] for f in frames], axis=1)
        if not np.array_equal(cam, want, equal_nan=True):
            gap = max(gap, _gap(cam.astype(np.float64), want))
    return gap


def _gap(a, b) -> float:
    """The largest absolute gap, infinite where either is not a number."""
    return float(np.nan_to_num(np.abs(a - b), nan=np.inf).max())


def compare(prog: dict, ref: dict, counts=None) -> dict:
    """One program state against the reference's after the same frame:
    {part: bool, cam, state, cov}."""
    live = ref["active"]
    part = bool((prog["active"] != live).any()
                or (prog["cartesian"] != ref["cartesian"]).any()
                or any((prog[f][live] != ref[f][live]).any()
                       for f in SLOT_FIELDS)
                or (counts is not None
                    and tuple(int(c) for c in counts) != ref["counts"]))
    x = np.asarray(prog["x"], np.float64)
    cam = _gap(x[:13], ref["x"][:13])
    if part:
        return dict(part=True, cam=cam, state=0.0, cov=0.0)
    dst = ref["dst"]
    state = _gap(x[dst], ref["x"][dst])
    for slot, (patch, pose, px) in ref.get("added", {}).items():
        for f, want in zip(STORE_FIELDS, (patch, pose, px)):
            state = max(state, _gap(np.asarray(prog[f][slot], np.float64),
                                    want))
    P = np.asarray(prog["P"], np.float64)[np.ix_(dst, dst)]
    var = np.abs(np.diag(ref["P"]))
    bound = np.sqrt(np.maximum(var, VAR_FLOOR * var.max()))
    with np.errstate(divide="ignore", invalid="ignore"):
        cov = _gap(P / np.outer(bound, bound),
                   ref["P"] / np.outer(bound, bound))
    return dict(part=False, cam=cam, state=state, cov=cov)


def reference_steps(tasks: list, workers: int) -> list:
    """Each (function, arguments) of the reference, their results in
    order: over `workers` processes of ``benchmark.reference.worker``
    (which import only NumPy and the reference), each sent its share
    through a pipe and waited for."""
    workers = min(workers, len(tasks))
    if workers <= 1:
        return [fn(*args) for fn, args in tasks]
    env = dict(os.environ, PYTHONPATH=str(spec.ROOT), OMP_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-m",
                               "benchmark.reference.worker"],
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                              cwd=spec.ROOT, env=env) for _ in range(workers)]
    out = [None] * len(tasks)
    try:
        for i, proc in enumerate(procs):
            pickle.dump(tasks[i::workers], proc.stdin)
            proc.stdin.close()
        for i, proc in enumerate(procs):
            out[i::workers] = pickle.load(proc.stdout)
    finally:
        for proc in procs:
            if proc.poll() is None and any(r is None for r in out):
                proc.kill()
            proc.wait()
    if any(proc.returncode for proc in procs):
        raise RuntimeError("a reference worker failed")
    return out


def numbers(session, window: dict, rows: list, limits: dict, workers: int):
    """Re-run the sequence, run the reference and compare (see above).
    Returns the numbers and the reference frames that parted from the
    program or passed a limit, each with the decisions the reference
    found near their thresholds and the one turned to follow the program,
    if one was."""
    rr = session.rerun(rows)
    gap = window_gap(window["cams"], window["frames_of"], rr["cams"])
    session.release()
    tasks, want, where = [], [], []
    for j, row in enumerate(rows):
        want.append((rr["states"][0][j], None))
        tasks.append(session.reference_start(row))
        where.append((row, -1))
        for t in range(session.frames):
            prev = rr["states"][t][j]
            tasks.append(session.reference_step(prev, t, row))
            want.append((rr["states"][t + 1][j], rr["counts"][t][j]))
            where.append((row, t))
    refs = reference_steps(tasks, workers)
    results = [compare(prog, ref, counts)
               for (prog, counts), ref in zip(want, refs)]

    def off(c):
        return (c["part"] or c["cam"] > limits["cam_err"]
                or c["state"] > limits["state_err"]
                or c["cov"] > limits["cov_err"])

    # Where a frame parts, follow the program's branch: turn, one at a
    # time, each decision the reference found within its turn_limit.
    retry = [(k, (kind, slot), margin) for k, c in enumerate(results)
             if off(c) and where[k][1] >= 0
             for margin, kind, slot in refs[k].get("near", [])
             if margin < turn_limit(kind)]
    turned = reference_steps([tasks[k][:1] + (tasks[k][1] + (turn,),)
                              for k, turn, _ in retry], workers)
    report = {k: dict(row=where[k][0], frame=where[k][1],
                      cam=results[k]["cam"],
                      counts=None if want[k][1] is None else
                      [int(v) for v in want[k][1]],
                      reference=refs[k].get("counts"),
                      near=refs[k].get("near", []), turned=None)
              for k, c in enumerate(results) if off(c)}
    for (k, turn, margin), ref in zip(retry, turned):
        c = compare(want[k][0], ref, want[k][1])
        if report[k]["turned"] is None and not off(c):
            results[k] = c
            report[k]["turned"] = [turn[0], turn[1], margin]
    out = dict(rerun_gap=gap, cam_err=0.0, state_err=0.0, cov_err=0.0,
               count_parts=0)
    for c in results:
        out["count_parts"] += int(c["part"])
        out["cam_err"] = max(out["cam_err"], c["cam"])
        out["state_err"] = max(out["state_err"], c["state"])
        out["cov_err"] = max(out["cov_err"], c["cov"])
    out["nonfinite"] = sum(int((~np.isfinite(c)).any(axis=-1).sum())
                           for c in window["cams"])
    return out, list(report.values())


def judge(values: dict, limits: dict) -> tuple:
    """({name: {value, limit}} for every number, whether all hold)."""
    checks = {k: {"value": values[k], "limit": limits[k]} for k in NUMBERS}
    ok = all(not math.isnan(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return checks, ok
