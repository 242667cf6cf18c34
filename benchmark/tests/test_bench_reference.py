"""The reference against the program on the CPU at a tiny size, and the
reference's own independence from the program."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.harness import spec
from benchmark.reference import slam
from benchmark.tests.tiny import CELLS, run_tiny, tiny_cell
from ekf_slam_tpu_torch.config import EngineConfig
from ekf_slam_tpu_torch.filter import engine
from ekf_slam_tpu_torch.filter.state import init_state
from ekf_slam_tpu_torch.sim.scene import FrameObs
from benchmark.harness import inputs


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_is_correct(cell):
    out = run_tiny(cell)
    assert out["correct"], out["checks"]
    checks = {k: v["value"] for k, v in out["checks"].items()}
    assert checks["rerun_gap"] == 0 and checks["count_parts"] == 0
    assert checks["cam_err"] < 1e-5 and checks["cov_err"] < 1e-3
    assert list(out)[-1] == "checks"


def test_whole_sequence_agrees_at_f64():
    """The reference followed over a whole sequence from its own
    bootstrap agrees with the program run in float64 (where rounding
    cannot part their decisions): every frame's state to 1e-9."""
    c = tiny_cell(CELLS[0])
    eng = dict(c["config"]["engine"], dtype="float64")
    s = slam.settings(eng)
    cfg = EngineConfig.from_dict(eng)
    seq = inputs.sequence(11, s, 4, 2, rendered=False)
    obs = FrameObs(torch.from_numpy(seq.pixels).double(),
                   torch.from_numpy(seq.visible))
    st = engine.bootstrap(init_state(cfg, 2, "cpu"), obs.frame(0), cfg)
    ref = [slam.sim_bootstrap(s, seq.pixels[0], seq.visible[0])] * 2
    for t in range(4):
        st, info = engine.step(st, obs.frame(t), torch.from_numpy(
            seq.u[t]).double(), cfg)
        for b in range(2):
            ref[b] = slam.sim_step(s, ref[b], seq.pixels[t], seq.visible[t],
                                   seq.u[t, b])
            x = st.x[b].numpy()
            assert (st.active[b].numpy() == ref[b]["active"]).all()
            assert np.abs(x[ref[b]["dst"]] - ref[b]["x"][ref[b]["dst"]]
                          ).max() < 1e-9
            assert (int(info.n_ic[b]), int(info.n_li[b]),
                    int(info.n_hi[b])) == ref[b]["counts"]


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import benchmark.reference.slam, "
            "benchmark.reference.frontend, benchmark.harness.inputs, "
            "benchmark.harness.guard, benchmark.roofline.arith; "
            "tops = {m.split('.')[0] for m in sys.modules}; "
            "bad = tops & {'ekf_slam_tpu_torch', 'ekf_slam_tpu', 'jax', "
            "'torch'}; print(sorted(bad)); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr


def test_ncc_tie_is_noted_and_turned():
    """Two identical blobs 10 pixels apart score alike: the first maximum
    wins, the tie's margin (0) is noted, and turning it takes the other."""
    from benchmark.reference import frontend
    blob = np.outer(np.hanning(7), np.hanning(7))
    two = np.full((60, 60), 0.2)
    two[27:34, 22:29] += blob
    two[27:34, 32:39] += blob
    tmpl = two[24:37, 19:32].copy()          # one blob, centred at (25, 30)
    S = np.eye(2) * 400.0
    z, found, margins = frontend.ncc_match(two, tmpl, (30.0, 30.0), S,
                                           5.9915, 8, 0.5)
    assert found and margins["ncc_tie"] < 1e-12
    z2, found2, _ = frontend.ncc_match(two, tmpl, (30.0, 30.0), S, 5.9915,
                                       8, 0.5, turn="ncc_tie")
    assert found2 and sorted([z[0], z2[0]]) == [25.0, 35.0]
    assert z[1] == z2[1] == 30.0
