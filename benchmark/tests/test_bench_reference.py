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


# ncc_match as it scored before the flat-template rule, frozen: every
# template that is not flat must give its scores, margins and decisions.
def _ncc_match_before(img, template, h, S, chi2, radius, min_ncc):
    from benchmark.reference.frontend import FLAT_EPS, patch_anchor
    t = template.shape[0]
    H, W = img.shape
    half = radius + t // 2
    u0, v0 = patch_anchor(h, half, H, W)
    size = 2 * half + 1
    win = img[v0:v0 + size, u0:u0 + size]
    R2 = size - t + 1
    tm = template - template.mean()
    tnorm = np.sqrt((tm * tm).sum() + 1e-12)
    patches = np.lib.stride_tricks.sliding_window_view(win, (t, t))
    corr = np.einsum("yxij,ij->yx", patches, tm)
    var = np.maximum(((patches - patches.mean(axis=(2, 3), keepdims=True))
                      ** 2).sum(axis=(2, 3)), 0.0)
    energy = ((win - win.mean()) ** 2).sum()
    scores = corr / (np.sqrt(var + 1e-12) * tnorm)
    scores = np.where(var > FLAT_EPS * np.finfo(np.float32).eps * energy,
                      scores, 0.0)
    k = np.arange(R2, dtype=np.float64)
    cu, cv = u0 + t // 2 + k, v0 + t // 2 + k
    du = (cu - h[0])[None, :]
    dv = (cv - h[1])[:, None]
    det = S[0, 0] * S[1, 1] - S[0, 1] * S[1, 0]
    det = 1.0 if det == 0 else det
    m2 = (du * (S[1, 1] * du - S[0, 1] * dv)
          + dv * (-S[1, 0] * du + S[0, 0] * dv)) / det
    masked = np.where(m2 < chi2, scores, -np.inf)
    best = int(np.argmax(masked))
    rest = np.delete(masked.ravel(), best)
    by, bx = divmod(best, R2)
    score = masked[by, bx]
    frac = np.abs(np.asarray(h) % 1.0 - 0.5)
    margins = {"ncc_tie": float(score - rest.max()) if np.isfinite(
                   rest.max()) else np.inf,
               "ncc_min": abs(float(score) - min_ncc),
               "ncc_gate": abs(float(m2[by, bx]) - chi2) / chi2,
               "anchor": float(frac.min())}
    found = bool(np.isfinite(score) and score > min_ncc)
    return np.array([cu[bx], cv[by]]), found, margins, scores


def _bump(size, cy, cx, sigma):
    y, x = np.mgrid[:size, :size]
    return np.exp(-((y - cy) ** 2 + (x - cx) ** 2) / (2 * sigma ** 2))


def _scene(tail_scale: float):
    """A 60x60 frame, 0.2 grey with one Gaussian bump, and the 13x13
    template cut 7 pixels off the bump's centre, from the same bump at
    `tail_scale` of its height, in float32 as the program's templates
    are: ((60, 60), (13, 13)), the template's centre at pixel (30, 30)."""
    img = 0.2 + 0.5 * _bump(60, 30, 37, 3.0)
    tmpl = (0.2 + tail_scale * 0.5 * _bump(60, 30, 37, 3.0))[24:37, 24:37]
    return img, tmpl.astype(np.float32).astype(np.float64)


S_WIDE = np.eye(2) * 400.0


def test_recorded_flat_template_scores_zero_everywhere():
    """A template built like the one the program mis-scored (169 values
    within ~2.5e-5 of 0.2: a bump's far tail, flat within float32
    rounding) is flat: 0 at every offset and not found, where the rule
    before it matched the tail at a real score."""
    from benchmark.reference import frontend
    img, tmpl = _scene(5e-5)
    assert 0.19999 < tmpl.min() and tmpl.max() - tmpl.min() < 2.6e-5
    flat, margin = frontend.template_flat(tmpl)
    assert flat and margin > 0.5
    _, found_before, _, _ = _ncc_match_before(img, tmpl, (30.0, 30.0),
                                              S_WIDE, 5.9915, 8, 0.5)
    assert found_before
    win = img[30 - 14:30 + 15, 30 - 14:30 + 15]
    assert (frontend.ncc_scores(win, tmpl, flat) == 0).all()
    z, found, margins = frontend.ncc_match(img, tmpl, (30.0, 30.0), S_WIDE,
                                           5.9915, 8, 0.5)
    assert not found and margins["ncc_min"] == 0.5
    assert margins["ncc_tie"] == np.inf and margins["ncc_flat"] > 0.5


@pytest.mark.parametrize("case", ["fast_corner", "blob", "texture"])
def test_templates_that_are_not_flat_score_as_before(case):
    """A template with the contrast of the FAST threshold (0.08 on 0.2),
    a blob and a random texture: the scores, the match, the margins and
    the decision bit for bit those of the rule before, and the flat
    margin far from its threshold."""
    from benchmark.reference import frontend
    rng = np.random.default_rng(5)
    img = 0.2 + 0.02 * rng.standard_normal((60, 60))
    if case == "fast_corner":
        img[30:, 30:] += 0.08
        tmpl = img[24:37, 24:37].copy()
    elif case == "blob":
        img += 0.5 * _bump(60, 31, 28, 2.5)
        tmpl = img[24:37, 21:34].copy()
    else:
        tmpl = img[25:38, 22:35].copy()
    h, S = (30.4, 29.7), np.array([[30.0, 4.0], [4.0, 20.0]])
    z0, found0, margins0, scores0 = _ncc_match_before(
        img, tmpl, h, S, 5.9915, 10, 0.5)
    z, found, margins = frontend.ncc_match(img, tmpl, h, S, 5.9915, 10, 0.5)
    flat, margin = frontend.template_flat(tmpl)
    assert not flat and margin > 100
    u0, v0 = frontend.patch_anchor(h, 16, 60, 60)
    win = img[v0:v0 + 33, u0:u0 + 33]
    assert (frontend.ncc_scores(win, tmpl, False) == scores0).all()
    assert (z == z0).all() and found == found0
    assert {k: margins[k] for k in margins0} == margins0
    assert margins["ncc_flat"] == margin


@pytest.mark.parametrize("side", [-1, 1])
def test_flat_threshold_is_noted_and_turned(side):
    """A template whose Σtm² / Σt² lies 1e-6 (relative) below or above
    FLAT_EPS · eps_f32 is flat or not by the rule, its margin is noted
    (under NEAR), and turning `ncc_flat` flips the decision and so the
    match: a flat template is not found, the same template taken as not
    flat matches the bump it was cut from."""
    from benchmark.reference import frontend
    img, shape = _scene(1.0)
    shape = shape - shape.mean()
    n, c = shape.size, 0.2
    ratio = frontend.FLAT_EPS * np.finfo(np.float32).eps * (1 + side * 1e-6)
    alpha = np.sqrt(ratio * n * c * c / ((shape * shape).sum()
                                         * (1 - ratio)))
    tmpl = c + alpha * shape
    flat, margin = frontend.template_flat(tmpl)
    assert flat == (side < 0) and margin < 1e-5 < slam.NEAR
    assert margin < slam.turn_limit("ncc_flat")
    _, found, margins = frontend.ncc_match(img, tmpl, (30.0, 30.0), S_WIDE,
                                           5.9915, 8, 0.5)
    _, found_t, margins_t = frontend.ncc_match(
        img, tmpl, (30.0, 30.0), S_WIDE, 5.9915, 8, 0.5, turn="ncc_flat")
    assert margins["ncc_flat"] == margins_t["ncc_flat"] == margin
    assert found == (not flat) and found_t == flat
