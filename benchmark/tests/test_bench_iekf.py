"""The cell sim_f32_iekf.offline_b1024 and its reference frame
(reference/iekf.py): the frozen iterated update against the repository's
float64 oracle, against the plain update at one iteration, the tiny cell
on the CPU, the faults of test_bench_faults.py and, on the card, the TF32
control of test_bench_control.py in this cell."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.harness import inputs, spec
from benchmark.reference import iekf, oracle, slam
from benchmark.tests import test_bench_control as control
from benchmark.tests import test_bench_faults as faults
from benchmark.tests.test_bench_control import card  # noqa: F401 (fixture)
from benchmark.tests.tiny import run_tiny, tiny_cell
from ekf_slam_tpu_torch.config import EngineConfig
from ekf_slam_tpu_torch.filter import engine
from ekf_slam_tpu_torch.filter.state import init_state
from ekf_slam_tpu_torch.oracle.pipeline import OracleSLAM
from ekf_slam_tpu_torch.sim.scene import FrameObs

CELL = "sim_f32_iekf.offline_b1024"
FIELDS = ("x", "P", "active", "cartesian", "times_predicted",
          "times_measured", "landmark_id")
FRAMES = 6


def _f64_run(iters: int = 3):
    """(settings, engine config, sequence, the engine's padded states of
    instances 0 and 1 after each frame, from the bootstrap) at the tiny
    cell's size in float64."""
    eng = dict(tiny_cell(CELL)["config"]["engine"], dtype="float64")
    eng["filter"] = dict(eng["filter"], iekf_iterations=iters)
    s, cfg = slam.settings(eng), EngineConfig.from_dict(eng)
    seq = inputs.sequence(13, s, FRAMES, 2, rendered=False)
    obs = FrameObs(torch.from_numpy(seq.pixels).double(),
                   torch.from_numpy(seq.visible))
    st = engine.bootstrap(init_state(cfg, 2, "cpu"), obs.frame(0), cfg)
    states = []
    for t in range(FRAMES):
        states.append([{f: getattr(st, f)[b].double().numpy() if f in
                        ("x", "P") else getattr(st, f)[b].numpy()
                        for f in FIELDS} for b in range(2)])
        st, _ = engine.step(st, obs.frame(t), torch.from_numpy(
            seq.u[t]).double(), cfg)
    return s, cfg, seq, states


def test_reference_is_the_oracles_iterated_update_frame_for_frame():
    """From each of the program's f64 states, one reference frame
    (iekf.iekf_step) and one frame of the repository's oracle with
    use_iterated_update (oracle/pipeline.py), on the same observations
    and RANSAC picks: the same records, counts, x and P to 1e-12."""
    s, cfg, seq, states = _f64_run()
    updated = 0
    for t in range(FRAMES):
        for b in range(2):
            prev = states[t][b]
            ref = iekf.iekf_step(s, prev, seq.pixels[t], seq.visible[t],
                                 seq.u[t, b])
            orc = OracleSLAM.from_padded(cfg, *(prev[f] for f in FIELDS))
            z_by = {r.slot: seq.pixels[t, r.lm_id] for r in orc.recs}
            zv_by = {r.slot: bool(seq.visible[t, r.lm_id])
                     for r in orc.recs}
            masks = orc.step(z_by, zv_by, lambda ic: slam.sample_ic_indices(
                seq.u[t, b], ic), seq.visible[t], seq.pixels[t])
            assert ref["counts"] == tuple(int(masks[k].sum())
                                          for k in ("ic", "li", "hi"))
            dst = list(range(13))
            for r in orc.recs:
                base = 13 + 6 * r.slot
                dst += range(base, base + (6 if r.kind == "id" else 3))
            assert dst == list(ref["dst"])
            assert np.abs(ref["x"][ref["dst"]] - orc.x).max() <= 1e-12
            assert np.abs(ref["P"] - orc.P).max() <= 1e-12
            updated += ref["counts"][1] > 1
    assert updated >= 4


def test_one_iteration_moves_x_as_the_plain_li_update():
    """The LI update alone from one predicted state: with one iteration x
    is slam.py's plain update's (to rounding); P is not, since its gain is
    re-linearized at x_1."""
    s, cfg, seq, states = _f64_run(iters=1)
    t, prev = 3, states[3][0]
    plain, it = (slam.RefSLAM.from_padded(s, prev),
                 iekf.IEKFSLAM.from_padded(s, prev))
    for sl in (plain, it):
        sl.x, sl.P = oracle.predict(sl.x, sl.P, s.filter)
    lin = plain.linearize()
    z = np.array([seq.pixels[t, r.lm_id] for r in plain.recs])
    mask = np.array([lin[i][1] and seq.visible[t, r.lm_id]
                     for i, r in enumerate(plain.recs)])
    assert mask.sum() >= 3
    plain._update(lin, z, mask)
    it._iterate_next = True
    it._update(lin, z, mask)
    assert np.abs(it.x - plain.x).max() <= 1e-12
    assert np.abs(it.P - plain.P).max() > 1e-12


def test_tiny_run_is_correct():
    out = run_tiny(CELL)
    assert out["correct"], out["checks"]
    checks = {k: v["value"] for k, v in out["checks"].items()}
    assert checks["rerun_gap"] == 0 and checks["count_parts"] == 0
    assert checks["cam_err"] < 1e-5 and checks["cov_err"] < 1e-3
    assert list(out)[-1] == "checks"


def test_cell_runs_the_iterated_update():
    c = spec.cell(spec.benchmark(), CELL)
    f = c["config"]["engine"]["filter"]
    assert f["use_iterated_update"] and f["iekf_iterations"] == 3
    base = spec.load_json(spec.HERE / "configs" / "mono_sim_f32.json")
    eng = c["config"]["engine"]
    assert {k: v for k, v in eng.items() if k != "filter"} == {
        k: v for k, v in base["engine"].items() if k != "filter"}
    assert {k: v for k, v in f.items()
            if k not in ("use_iterated_update", "iekf_iterations")} == {
        k: v for k, v in base["engine"]["filter"].items()
        if k not in ("use_iterated_update", "iekf_iterations")}
    assert c["limits"] == spec.load_json(
        spec.HERE / "limits" / "sim_f32.offline_b1024.json")


@pytest.mark.parametrize("fault", [faults.unchanged, faults.half_left_out,
                                   faults.altered], ids=lambda f: f.__name__)
def test_fault_is_not_correct(monkeypatch, fault):
    faults.test_fault_is_not_correct(monkeypatch, CELL, fault)


def test_instances_mixed_is_not_correct(monkeypatch):
    faults.test_instances_mixed_is_not_correct(monkeypatch, CELL)


def test_one_call_altered_is_not_correct(monkeypatch):
    faults.test_one_call_altered_is_not_correct(monkeypatch, CELL)


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import benchmark.reference.iekf; "
            "tops = {m.split('.')[0] for m in sys.modules}; "
            "bad = tops & {'ekf_slam_tpu_torch', 'ekf_slam_tpu', 'jax', "
            "'torch'}; print(sorted(bad)); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [101, 202, 303])
def test_tf32_control_is_not_correct(card, seed):  # noqa: F811
    control.test_tf32_control_is_not_correct(card, CELL, seed)
