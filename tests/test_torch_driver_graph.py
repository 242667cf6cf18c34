"""The drivers' per-frame pieces as the card replays them, on the CPU.

On a CUDA device run_slam's pixels and sequence modes, run_loop_closure,
close_loops and models/evaluate.embed replay their per-frame pieces from
CUDA graphs (filter/graph.py). Capture needs the card; what it records is
graph.py's static-buffer frame, which runs here without a graph: each
driver's run with capture=False. At small sizes (CAP 24, at most 8 frames
but for the gate's calibration run, the width-8 VSS at 48x64,
test_torch_drivers.py's KITTI-layout fixture):

(a) every driver's static-buffer route equals its eager loop
    (capture=None) bit for bit: run_slam pixels and sequence
    (trajectory.npz, metrics.jsonl), run_loop_closure sim / outback and
    pixels / pan each with a declared loop, and sim with the gate
    calibrated during the run (trajectories with and without fusion,
    loops), close_loops (loops, kitti_traj.txt, kitti_loops.txt and
    kitti_q_times.txt but its seconds), evaluate.embed with a partial
    last batch at f32 and f64;
(b) the second frame of each new piece (embed_frame rendering and
    corrupting its frame, query_frame, evaluate's forward) reads nothing
    back to the host (NoHostReads); evaluate keeps one capture a batch
    shape and captures again for replaced weights;
(c) run_slam's image route against the JAX package's jitted step_image
    loop at f64, on the fixture's frames with JAX's RANSAC uniforms: x
    within 1e-9 of max|x| and the counts equal every frame (the same f64
    math in another order; tests/test_torch_image.py's tolerance);
(d) no fallback: eager=False without a card raises in every driver and
    in evaluate.embed.
"""

import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_slam_tpu.filter.state import init_state as j_init_state
from ekf_slam_tpu.vision import frontend as jfront
from ekf_slam_tpu_torch import close_loops, run_loop_closure, run_slam
from ekf_slam_tpu_torch.filter import graph
from ekf_slam_tpu_torch.io import ImageSequence
from ekf_slam_tpu_torch.models import evaluate, flax_init
from ekf_slam_tpu_torch.models import loopclosure as lc
from ekf_slam_tpu_torch.models import vss
from test_torch_drivers import kitti_seq  # noqa: F401 (a fixture)
from test_torch_graph import NoHostReads
from torch_parity import configs, ransac_u

torch.set_num_threads(1)

CPU = torch.device("cpu")
SMALL_MAP = ["--capacity", "24", "--min-features", "10"]
X_TOL = 1e-9


def _bits(a: np.ndarray) -> bytes:
    return np.ascontiguousarray(a).tobytes()


# --- (a) run_slam ------------------------------------------------------------

@pytest.mark.parametrize("mode", ["pixels", "sequence"])
def test_run_slam_static_route_equals_eager(mode, kitti_seq, tmp_path):
    """run_slam.run with capture=False against the eager loop: the same
    trajectory.npz and metrics.jsonl, byte for byte."""
    out = {}
    for capture in (None, False):
        d = tmp_path / str(capture)
        args = run_slam.parse_args(
            ["--mode", mode, "--frames", "6", "--batch", "2", "--out",
             str(d), "--pattern", str(kitti_seq / "%06d.pgm")] + SMALL_MAP)
        run_slam.run(args, CPU, capture)
        dat = np.load(d / "trajectory.npz")
        out[capture] = ({k: _bits(dat[k]) for k in dat.files},
                        (d / "metrics.jsonl").read_bytes())
    assert out[None] == out[False]
    assert b"n_li" in out[None][1]


# --- (a) run_loop_closure ----------------------------------------------------

def _harness(argv, **lcfg):
    """run_loop_closure's harness at CAP 24, its LoopConfig changed by
    `lcfg`."""
    args = run_loop_closure.parse_args(["--cpu"] + argv)
    h = run_loop_closure.build_harness(args, CPU)
    cfg = dataclasses.replace(h.cfg, map=dataclasses.replace(
        h.cfg.map, capacity=24, min_features_in_image=10,
        max_new_per_step=10))
    return dataclasses.replace(h, cfg=cfg,
                               lcfg=dataclasses.replace(h.lcfg, **lcfg))


@pytest.mark.parametrize("argv,lcfg,loops", [
    (["--frontend", "sim", "--traj", "outback", "--frames", "8",
      "--sim-threshold", "0.5", "--min-inliers", "8"], {}, True),
    (["--frontend", "pixels", "--traj", "pan", "--frames", "8",
      "--sim-threshold", "0.5", "--min-inliers", "8", "--lc-severity",
      "0.3"], {"consistency_count": 1}, True),
    # the gate calibrated from frame 2 to 10, set at frame 10
    (["--frontend", "sim", "--traj", "outback", "--frames", "12",
      "--sim-threshold", "0", "--lc-severity", "0.3"],
     {"min_db": 2, "exclude_recent": 2}, False)],
    ids=["sim_outback", "pixels_pan", "sim_auto_gate"])
def test_loop_harness_static_route_equals_eager(argv, lcfg, loops, capsys):
    """run_loop_closure.run with capture=False against the eager pieces:
    the trajectory with fusion and its loops, and (sim) the run without
    it, bit for bit."""
    h = _harness(argv, **lcfg)
    want = run_loop_closure.run(h, 0, True, None)
    got = run_loop_closure.run(h, 0, True, False)
    assert got[1] == want[1]
    assert _bits(got[0]) == _bits(want[0])
    assert (len(want[1]) > 0) == loops
    if h.args.sim_threshold == 0.0:
        assert capsys.readouterr().out.count("auto sim_threshold") == 2
    if h.args.frontend == "sim":    # run_slam's tests cover image frames
        off = run_loop_closure.run(h, 1, False, None)
        assert _bits(run_loop_closure.run(h, 1, False, False)[0]) == \
            _bits(off[0])
        assert _bits(off[0]) != _bits(want[0])


# --- (a) close_loops ---------------------------------------------------------

def test_close_loops_static_route_equals_eager(kitti_seq, tmp_path):
    """close_loops.run with capture=False against the eager pieces over
    the fixture's 20 frames: the same loops and artifacts (the query
    seconds apart)."""
    got = {}
    for capture in (None, False):
        d = tmp_path / str(capture)
        args = close_loops.parse_args(
            ["--poses", str(kitti_seq / "poses.txt"), "--pattern",
             str(kitti_seq / "%06d.pgm"), "--cpu", "--out", str(d)])
        r = close_loops.run(args, CPU, capture)
        got[capture] = (r["loops"], r["loop_inliers"],
                        (d / "kitti_traj.txt").read_bytes(),
                        (d / "kitti_loops.txt").read_bytes(),
                        np.loadtxt(d / "kitti_q_times.txt")[:, :2].tolist())
    assert got[None] == got[False]
    assert len(got[None][0]) >= 2


# --- (a) evaluate.embed ------------------------------------------------------

@pytest.fixture(scope="module")
def vss_model():
    model = vss.VSS(vss.VSSConfig(width=8), (48, 64))
    model.load_state_dict(vss.from_flax(flax_init.flax_variables(
        vss.VSSConfig(width=8), (48, 64), 2)))
    return model


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_embed_static_route_equals_eager(vss_model, dtype):
    """5 images in batches of 2 (the last one partial), with keypoints:
    descriptors and every Keypoints field bit for bit; the model's
    training mode is restored."""
    model = copy.deepcopy(vss_model).to(dtype).train()
    imgs = torch.rand(5, 48, 64, 3, generator=torch.Generator().manual_seed(1))
    want = evaluate.embed(model, imgs, 2, with_keypoints=True, eager=True)
    got = evaluate.embed_batches(model, imgs, 2, True, capture=False)
    assert model.training
    assert got[0].dtype == dtype and got[0].shape[0] == 5
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1], want[1]):
        assert torch.equal(g, w)
    assert torch.equal(evaluate.embed_batches(model, imgs, 2, capture=False),
                       want[0])


def test_embed_keeps_one_capture_a_shape(vss_model, monkeypatch):
    """With capture emulated (StaticFrame.capture records, the frame runs
    without a graph): two captures for a full and a partial batch, none
    for the same model again or weights updated in place, two more once a
    weight is replaced."""
    calls = []
    monkeypatch.setattr(graph.StaticFrame, "capture",
                        lambda self, warmup=graph.WARMUP: calls.append(
                            self.inputs[0].shape[0]))
    monkeypatch.setattr(graph, "_CAPTURED", graph._CAPTURED.__class__())
    model = copy.deepcopy(vss_model).eval()
    imgs = torch.rand(5, 48, 64, 3, generator=torch.Generator().manual_seed(2))
    want = evaluate.embed(model, imgs, 2, eager=True)
    assert torch.equal(evaluate.embed_batches(model, imgs, 2), want)
    assert calls == [2, 1]
    with torch.no_grad():
        w = model.mu.weight
        w.mul_(1.0)
    assert torch.equal(evaluate.embed_batches(model, imgs, 2), want)
    assert calls == [2, 1]
    model.mu.weight = torch.nn.Parameter(w.detach().clone())
    assert torch.equal(evaluate.embed_batches(model, imgs, 2), want)
    assert calls == [2, 1, 2, 1]


# --- (b) the new pieces' second frame ----------------------------------------

def test_new_pieces_read_nothing_back(vss_model):
    """The second frame of embed_frame (render from the camera state,
    corrupt, resize, VSS, keypoints), of query_frame (the gate a tensor,
    the ring in place) and of evaluate's forward under NoHostReads."""
    cfg = run_loop_closure.harness_config()
    scn = run_loop_closure.make_surround_scene(
        torch.Generator().manual_seed(0), cfg, n_anchors=2)
    xs = run_loop_closure.pan_trajectory(cfg, 2)
    shape = (cfg.camera.n_rows, cfg.camera.n_cols)
    g = torch.Generator().manual_seed(3)
    model = vss_model.eval()

    def e_in(t):
        return (xs[t], *run_loop_closure.corrupt_draws(shape, xs.dtype, 0.3,
                                                       g, CPU))
    embed = graph.StaticFrame(functools.partial(
        run_loop_closure.embed_frame, model=model, hw=(48, 64),
        severity=0.3, scene=scn, cfg=cfg), (), e_in(0))
    embed()
    out0 = [o.clone() for o in embed.outputs]
    inputs1 = e_in(1)
    with NoHostReads():
        out1 = embed.step(inputs1)
    assert not torch.equal(out1[0], out0[0])

    lcfg = lc.LoopConfig(capacity=8, top_k=2, exclude_recent=0, min_db=0,
                         ransac_hypotheses=4)
    db = lc.init_db(lcfg, 1, out0[0].shape[1], out0[1].shape[1],
                    out0[4].shape[2], device=CPU)

    def q_in(out, t):
        return (*out, torch.zeros(1, 7), lc.ransac_draws(
            lcfg, 1, out[1].shape[1], torch.Generator().manual_seed(t),
            out[1].dtype, CPU), torch.ones(1, dtype=torch.bool),
            torch.tensor(0.5))
    query = graph.StaticFrame(
        functools.partial(run_loop_closure.query_frame, lcfg=lcfg),
        tuple(getattr(db, f) for f in lc.DB_FIELDS), q_in(out0, 0),
        [lc.DB_FIELDS.index(f) for f in ("descr", "kp_yx", "kp_descr",
                                         "pose")])
    query()
    q1 = q_in(out1, 1)
    with NoHostReads():
        query.step(q1)
    assert query.carry[lc.DB_FIELDS.index("count")].tolist() == [2]

    imgs = torch.rand(2, 2, 48, 64, 3, generator=g)
    fwd = graph.StaticFrame(functools.partial(
        evaluate._forward, model=model, with_keypoints=True), (), (imgs[0],))
    fwd()
    with NoHostReads():
        fwd.step((imgs[1],))


# --- (c) against JAX ---------------------------------------------------------

def test_run_slam_image_route_matches_jax(kitti_seq, monkeypatch):
    """run_slam's static image route at f64 on 4 of the fixture's frames,
    B = 1, against jit(step_image) on the same frames and JAX's RANSAC
    uniforms (fed to the port through frame_draws)."""
    frames = 4
    jc, tc = configs({"map": {"capacity": 24, "min_features_in_image": 10,
                              "max_new_per_step": 10},
                      "sim": {"num_landmarks": 96}, "dtype": "float64"})
    seq = ImageSequence(str(kitti_seq / "%06d.pgm"), 0, frames)
    imgs = seq.load(0, frames).astype(np.float64)
    seq.close()
    keys = [jax.random.key(10 + t) for t in range(frames)]
    u = [torch.tensor(ransac_u(k[None], jc.ransac.num_hypotheses))
         for k in keys]
    monkeypatch.setattr(run_slam, "frame_draws",
                        lambda cfg, batch, t, dev: u[t])
    traj, info = run_slam.run_frames(lambda t: torch.tensor(imgs[t]), frames,
                                     tc, 1, CPU, capture=False)
    step = jax.jit(lambda s, a, im, k: jfront.step_image(s, a, im, k, jc))
    jst, japp = j_init_state(jc), jfront.init_appearance(jc)
    for t in range(frames):
        jst, japp, jinfo = step(jst, japp, jnp.asarray(imgs[t]), keys[t])
        jx = np.asarray(jst.x[:13])
        np.testing.assert_allclose(traj[0, t].numpy(), jx, rtol=0,
                                   atol=X_TOL * np.abs(jx).max())
        for f in ("n_ic", "n_li", "n_hi"):
            assert int(getattr(info, f)[0, t]) == int(getattr(jinfo, f)), \
                (t, f)
    assert int(info.n_ic.sum()) > 0 and int(info.n_li.sum()) > 0


# --- (d) no fallback ---------------------------------------------------------

@pytest.mark.parametrize("entry", ["run_slam", "run_loop_closure",
                                   "close_loops", "embed"])
def test_replay_without_a_card_raises(entry, kitti_seq, vss_model, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: replay runs")
    calls = {
        "run_slam": lambda: run_slam.main(
            ["--cpu", "--frames", "2", "--out", str(tmp_path)], eager=False),
        "run_loop_closure": lambda: run_loop_closure.main(
            ["--cpu", "--frames", "4", "--out", str(tmp_path)], eager=False),
        "close_loops": lambda: close_loops.main(
            ["--cpu", "--poses", str(kitti_seq / "poses.txt"), "--pattern",
             str(kitti_seq / "%06d.pgm"), "--out", str(tmp_path)],
            eager=False),
        "embed": lambda: evaluate.embed(vss_model, torch.rand(2, 48, 64, 3),
                                        eager=False)}
    with pytest.raises(ValueError, match="needs a CUDA device"):
        calls[entry]()
