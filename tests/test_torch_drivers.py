"""The port's drivers (ekf_slam_tpu_torch/run_slam.py and close_loops.py)
against the JAX package's examples (examples/run_slam.py and
examples/close_loops.py), on the CPU.

A KITTI-layout fixture — %06d.pgm frames and a poses.txt of 12-float rows
— is rendered by the port: tests/test_kitti_fixture.py's 400-degree pan
over the port's surround scene (run_loop_closure.make_surround_scene,
pan_trajectory), 20 frames at 240x320.

(a) close_loops --cpu with JAX's RANSAC draws handed in through its
draws_fn hook (key(200 + t), split as lc.query splits it) against the JAX
script run in this process on the same files: kitti_traj.txt equal to its
10 printed digits, the same DB sizes in kitti_q_times.txt, the revisits
declared by both with the same poses, and any loop declared by one only
accepted at the inlier gate (see the test).
(b) run_slam --cpu in all three modes writes trajectory.npz and
metrics.jsonl; sim and pixels mode track the ground truth; sequence mode
tracks the fixture from disk (test_kitti_fixture.py's claim) by the
native loader and equals frontend.run_images on the decoded frames with
the driver's draws (what chip_smoke's drivers phase holds on the card).
(c) Both parsers take the JAX scripts' flags with their defaults; the
drivers default to the card; the unported flags raise."""

import ast
import importlib.util
import json
import pathlib
import re
import sys

import jax
import numpy as np
import pytest
import torch

from ekf_slam_tpu_torch import close_loops, run_loop_closure, run_slam
from ekf_slam_tpu_torch.filter.state import init_state
from ekf_slam_tpu_torch.io import ImageSequence
from ekf_slam_tpu_torch.io.poses import save_trajectory_kitti
from ekf_slam_tpu_torch.io.sequence import write_pgm
from ekf_slam_tpu_torch.sim.scene import Scene
from ekf_slam_tpu_torch.vision import frontend

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
FRAMES = 20


@pytest.fixture(scope="module")
def kitti_seq(tmp_path_factory):
    d = tmp_path_factory.mktemp("kitti_port")
    cfg = run_loop_closure.harness_config()
    scn = run_loop_closure.make_surround_scene(
        torch.Generator().manual_seed(0), cfg)
    xs = run_loop_closure.pan_trajectory(cfg, FRAMES, total_deg=400.0)
    for t in range(FRAMES):
        img = frontend.render_scene_image(Scene(scn.landmarks), xs[t], cfg,
                                          "cpu")
        write_pgm(str(d / f"{t:06d}.pgm"),
                  (img.numpy() * 255).astype(np.uint8))
    save_trajectory_kitti(str(d / "poses.txt"), xs[:, :7].double().numpy())
    return d


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_example", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _query_draws(t, cfg, K):
    """lc.query's draws from key(200 + t): split over top_k, then over the
    hypotheses, uniform(k, (K,)) each — (top_k, NH, K)."""
    def hyp(key):
        return jax.vmap(lambda k: jax.random.uniform(k, (K,)))(
            jax.random.split(key, cfg.ransac_hypotheses))
    return np.stack([np.asarray(hyp(k)) for k in
                     jax.random.split(jax.random.key(200 + t), cfg.top_k)])


def test_close_loops_matches_the_jax_script(kitti_seq, tmp_path,
                                            monkeypatch, capsys):
    """The JAX script runs with its Flax init and its loop-closure calls
    compiled once (jax.jit; eager dispatch costs ~50 s here), the same
    computation. A loop that only one package declares must have been
    accepted at the inlier gate (inliers <= min_inliers + 1 = 9): on a
    pure-rotation pan the fundamental matrix is undetermined, and an
    8-point fit from 8-9 matches is decided by each package's eigensolver
    (ROADMAP §3: frame 12's candidate, 9 matches, 8 inliers in the port
    and 6 in JAX)."""
    from ekf_slam_tpu.models import loopclosure as jlc
    from ekf_slam_tpu.models import train
    args = ["--poses", str(kitti_seq / "poses.txt"),
            "--pattern", str(kitti_seq / "%06d.pgm"),
            "--frames", str(FRAMES), "--cpu"]
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    got = close_loops.main(args + ["--out", str(ours)],
                           draws_fn=_query_draws)
    capsys.readouterr()
    monkeypatch.setattr(train, "init_state", jax.jit(
        train.init_state, static_argnums=(0, 1)))
    for name in ("query", "step_temporal"):
        monkeypatch.setattr(jlc, name, jax.jit(getattr(jlc, name),
                                               static_argnames="cfg"))
    monkeypatch.setattr(jlc, "push", jax.jit(jlc.push))
    monkeypatch.setattr(sys, "argv", ["close_loops.py"] + args
                        + ["--out", str(theirs)])
    _example("close_loops").main()
    jax_loops = {(int(i), int(j)): int(k) for i, j, k in re.findall(
        r"LOOP frame (\d+) -> (\d+) \(inliers (\d+)\)",
        capsys.readouterr().out)}
    assert got["native"] and got["frames"] == FRAMES
    np.testing.assert_allclose(np.loadtxt(ours / "kitti_traj.txt"),
                               np.loadtxt(theirs / "kitti_traj.txt"),
                               rtol=1e-9, atol=1e-12)
    port_loops = dict(zip(got["loops"], got["loop_inliers"]))
    rows = {}
    for path in (ours, theirs):
        for r in np.loadtxt(path / "kitti_loops.txt", ndmin=2):
            rows.setdefault((int(r[0]), int(r[1])), []).append(r[2:])
    assert set(rows) == set(port_loops) | set(jax_loops)
    both = set(port_loops) & set(jax_loops)
    assert len(both) >= 2 and all(i - j >= FRAMES // 4 for i, j in both)
    for pair in both:
        np.testing.assert_allclose(*rows[pair], rtol=0, atol=1e-12)
    for pair in set(port_loops) ^ set(jax_loops):
        assert {**jax_loops, **port_loops}[pair] <= 8 + 1, pair
    qa, qb = (np.loadtxt(p / "kitti_q_times.txt") for p in (ours, theirs))
    assert qa.shape == qb.shape == (FRAMES, 3)
    np.testing.assert_array_equal(qa[:, :2], qb[:, :2])


def _artifacts(out, frames):
    dat = np.load(out / "trajectory.npz")
    lines = (out / "metrics.jsonl").read_text().splitlines()
    assert dat["trajectory"].shape == (frames, 13)
    assert np.isfinite(dat["trajectory"]).all()
    assert [json.loads(x)["step"] for x in lines] == list(range(frames))
    return dat, [json.loads(x) for x in lines]


@pytest.mark.parametrize("mode", ["sim", "pixels"])
def test_run_slam_modes_track_and_write_artifacts(mode, tmp_path):
    out = tmp_path / mode
    s = run_slam.main(["--cpu", "--mode", mode, "--frames", "8", "--batch",
                       "2", "--out", str(out)])
    dat, rows = _artifacts(out, 8)
    assert dat["truth"].shape == (8, 13)
    assert s["steps_per_s"] > 0 and np.isfinite(s["ate"])
    assert max(r["pos_err"] for r in rows) < 0.2
    assert all({"n_ic", "n_li"} <= set(r) for r in rows)


def test_run_slam_sequence_tracks_the_fixture_from_disk(kitti_seq,
                                                        tmp_path):
    """Sequence mode from the files, by the native loader: the artifacts,
    and the trajectory of frontend.run_images on the decoded frames with
    the driver's draws, to rounding."""
    out = tmp_path / "seq"
    frames, B = 6, 2
    s = run_slam.main(["--cpu", "--mode", "sequence", "--pattern",
                       str(kitti_seq / "%06d.pgm"), "--start", "0",
                       "--frames", str(frames), "--batch", str(B),
                       "--out", str(out)])
    dat, rows = _artifacts(out, frames)
    assert s["native"] and "truth" not in dat
    assert rows[-1]["n_li"] > 0
    cfg = run_slam.slam_config(run_slam.parse_args(
        ["--frames", str(frames)]))
    seq = ImageSequence(str(kitti_seq / "%06d.pgm"), 0, frames)
    imgs = torch.from_numpy(seq.load(0, frames))
    u = torch.stack([run_slam.frame_draws(cfg, B, t, "cpu")
                     for t in range(frames)])
    _, _, traj, _ = frontend.run_images(
        init_state(cfg, B, "cpu"), frontend.init_appearance(cfg, B, "cpu"),
        imgs, u, cfg, "cpu")
    np.testing.assert_allclose(dat["trajectory"], traj[0].numpy(), rtol=0,
                               atol=1e-6)


def _example_flags(name):
    tree = ast.parse((ROOT / "examples" / f"{name}.py").read_text())
    flags = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", None) == "add_argument"):
            kw = {k.arg: k.value for k in node.keywords}
            flags[node.args[0].value] = (
                ast.literal_eval(kw["default"]) if "default" in kw else None)
    return flags


@pytest.mark.parametrize("name,parse,required", [
    ("run_slam", run_slam.parse_args, []),
    ("close_loops", close_loops.parse_args,
     ["--poses", "p", "--pattern", "q"])])
def test_parsers_take_the_examples_flags(name, parse, required):
    want = _example_flags(name)
    got = {f"--{k.replace('_', '-')}": v
           for k, v in vars(parse(required)).items()}
    assert set(got) == set(want)
    for flag, default in want.items():
        if flag != "--out" and default is not None:
            assert np.all(np.asarray(got[flag]) == np.asarray(default)), flag


def test_drivers_default_to_the_card(kitti_seq, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults resolve")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_slam.main(["--frames", "2", "--out", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        close_loops.main(["--poses", str(kitti_seq / "poses.txt"),
                          "--pattern", str(kitti_seq / "%06d.pgm"),
                          "--out", str(tmp_path)])


@pytest.mark.parametrize("main,argv", [
    (run_slam.main, ["--cpu", "--plots"]),
    (close_loops.main, ["--cpu", "--poses", "p", "--pattern", "q",
                        "--ckpt", "x"]),
    (close_loops.main, ["--cpu", "--poses", "p", "--pattern", "q",
                        "--plot"])], ids=["plots", "ckpt", "plot"])
def test_unported_flags_raise(main, argv, tmp_path):
    with pytest.raises(ValueError, match="not ported"):
        main(argv + ["--out", str(tmp_path)])
