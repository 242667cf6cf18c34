"""A run with the timed path broken underneath comes out not correct: a
step that returns its state unchanged, half of the batch left out, an
answer altered where it is produced (every step's, or one call's), two
instances' covariances exchanged. The
cells run on one card, so no exchange between cards can be left out.
Each fault is planted in the program on the CPU and the rest of a run is
driven as on the card, without the look for one."""

import pytest
import torch

from benchmark.tests.tiny import CELLS, run_tiny
from ekf_slam_tpu_torch.filter import engine
from ekf_slam_tpu_torch.vision import frontend


def _patch_step(monkeypatch, cell, change):
    """Wrap the cell's per-frame step; change(old_state, new_state) gives
    the state it returns."""
    if cell.startswith("sim"):
        orig = engine.step

        def step(state, obs, u, cfg):
            new, info = orig(state, obs, u, cfg)
            return change(state, new), info
        monkeypatch.setattr(engine, "step", step)
    else:
        orig = frontend.step_image

        def step_image(state, app, img, u, cfg):
            new, new_app, info = orig(state, app, img, u, cfg)
            return change(state, new), new_app, info
        monkeypatch.setattr(frontend, "step_image", step_image)


def unchanged(old, new):
    return old


def half_left_out(old, new):
    half = old.x.shape[0] // 2
    return new.replace(**{f: torch.cat([getattr(new, f)[:half],
                                        getattr(old, f)[half:]])
                          for f in ("x", "P", "active", "cartesian",
                                    "times_predicted", "times_measured",
                                    "landmark_id")})


def altered(old, new):
    x = new.x.clone()
    x[:, 0] += 1e-3
    return new.replace(x=x)


def neighbours_swapped(old, new):
    """Each instance gets its neighbour's covariance (0 and 1, 2 and 3,
    ...): a stride that reads the wrong instance."""
    idx = torch.arange(new.P.shape[0]).view(-1, 2).flip(1).reshape(-1)
    return new.replace(P=new.P[idx.to(new.P.device)])


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [unchanged, half_left_out, altered],
                         ids=lambda f: f.__name__)
def test_fault_is_not_correct(monkeypatch, cell, fault):
    _patch_step(monkeypatch, cell, fault)
    out = run_tiny(cell, instances=4, sampled=2)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_instances_mixed_is_not_correct(monkeypatch, cell):
    """A mix of instances shows only where they differ: the filters share
    one sequence and part by their RANSAC draws alone, and the tiny image
    cell's four take the same decisions under 64 hypotheses, so there
    they draw 2, which parts them."""
    _patch_step(monkeypatch, cell, neighbours_swapped)
    out = run_tiny(cell, instances=4, sampled=2,
                   hypotheses=2 if cell.startswith("image") else None)
    assert out["notes"]["distinct"] > 1
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_one_call_altered_is_not_correct(monkeypatch, cell):
    """One call of the window returns a camera block that the program's
    frame did not produce: the re-run catches it in any instance."""
    from benchmark.harness import main
    orig = main.window

    def window(session, seconds):
        entry, calls = session.entry, []

        def altered_entry(carry, t0, t1):
            new, cam, info = entry(carry, t0, t1)
            calls.append(t0)
            if len(calls) == 1:
                cam = cam.clone()
                cam[-1, 0, 5] += 1e-6
            return new, cam, info
        session.entry = altered_entry
        try:
            return orig(session, max(seconds, 0.5))
        finally:
            session.entry = entry
    monkeypatch.setattr(main, "window", window)
    out = run_tiny(cell, instances=4, sampled=2)
    assert not out["correct"]
    assert out["checks"]["rerun_gap"]["value"] > 0
