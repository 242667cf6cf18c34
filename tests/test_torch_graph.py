"""The port's frame driver (ekf_slam_tpu_torch/filter/graph.py) on the CPU.

On a CUDA device run_sequence and run_images replay one frame captured as
a CUDA graph. Capture needs the card; what it records is graph.py's
static-buffer frame (StaticFrame.__call__), which runs here without a
graph. So, at a small size (CAP 24, B = 2, 3-4 frames), on every route the
card replays (fused, unfused (i) and (ii), the row form, the IEKF, bf16 P;
step_image with the NCC matcher in its three warp forms and with the
descriptor matcher):

(a) the second frame of the static-buffer driver reads nothing back to
    the host: no .item(), bool(tensor), nonzero, masked_select, unique,
    boolean-mask index, no tensor from host data and no Python scalar
    copied into one element (any of them breaks capture);
(b) the static-buffer driver equals the eager loop (run_sequence /
    run_images with eager=True) bit for bit, at f64 and at f32: final
    state (and appearance), trajectory and every StepInfo field;
(c) the static-buffer driver against the JAX package's run_sequence (its
    lax.scan, jitted and vmapped) at f64 on the fused and unfused routes:
    x and P to 1e-10, counts equal every frame;
(d) no silent fallback: asking for replay on the CPU raises, the CPU
    default is the eager loop, and the carry copy survives aliased
    buffers.
"""

from unittest import mock

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ekf_slam_tpu.filter import engine as jengine
from ekf_slam_tpu_torch.config import EngineConfig
from ekf_slam_tpu_torch.filter import engine, graph
from ekf_slam_tpu_torch.filter.state import FIELDS, init_state
from ekf_slam_tpu_torch.sim import simulate
from ekf_slam_tpu_torch.vision import frontend
from torch_parity import (FUSED, configs, interpret_mode, n, port_obs,
                          port_state, ransac_u, sim_and_bootstrap)

torch.set_num_threads(1)

B = 2
SIM_FRAMES = 4
IMAGE_FRAMES = 3
SIM = {"map": {"capacity": 24, "min_features_in_image": 12,
               "max_new_per_step": 8, "max_update_obs": 16},
       "sim": {"num_landmarks": 40}}
# route -> (filter settings, engine.UPDATE)
SIM_ROUTES = {
    "fused": ({"fused_step": "on"}, "cols"),
    "unfused_i": ({"fused_step": "off", "pallas_update": "off"}, "cols"),
    "unfused_ii": ({"fused_step": "off", "pallas_update": "on"}, "cols"),
    "rows": ({"fused_step": "off", "pallas_update": "off"}, "rows"),
    "iekf": ({"fused_step": "off", "use_iterated_update": True}, "cols"),
    "bf16": ({"fused_step": "off", "gain_solver": "newton",
              "p_storage": "bf16"}, "cols"),
    "bf16_rows": ({"fused_step": "off", "gain_solver": "newton",
                   "p_storage": "bf16"}, "rows"),
}
# tests/test_torch_image.py's pixels config; route -> vision settings
IMAGE = {"map": {"capacity": 24, "min_features_in_image": 10,
                 "max_new_per_step": 10},
         "sim": {"num_landmarks": 40, "depth_min": 2.0, "depth_max": 6.0,
                 "v_init": (0.002, 0.0, 0.004), "w_init": (0.0, 0.001, 0.0),
                 "traj_accel_std": 2e-4, "traj_alpha_std": 2e-4}}
IMAGE_ROUTES = {
    "ncc_affine": {"matcher": "ncc", "warp_distortion": "affine"},
    "ncc_exact": {"matcher": "ncc", "warp_distortion": "exact"},
    "ncc_none": {"matcher": "ncc", "warp_distortion": "none"},
    "descriptor": {"matcher": "descriptor"},
}
VISION = {"search_radius": 10, "min_ncc": 0.4, "max_hamming": 80.0}
DTYPES = ("float64", "float32")
# (c): x and P to 1e-10 at f64 (test_torch_engine.py's parity tolerances
# are 1e-9 / 1e-8 relative over 7 frames; these runs are 4 frames)
X_TOL = dict(rtol=1e-10, atol=1e-10)
P_TOL = dict(rtol=1e-10, atol=1e-10)

HOST_READS = ("_local_scalar_dense", "is_nonzero", "nonzero",
              "masked_select")
FROM_HOST = ("tensor", "as_tensor", "from_numpy")


class NoHostReads(TorchDispatchMode):
    """Raises on every op that reads a device value back to the host or
    builds a tensor from host data: each of them breaks CUDA graph capture
    (or syncs the host every frame). A tensor from host data is caught
    twice: torch.tensor / as_tensor / from_numpy raise inside the block,
    and so does aten.lift_fresh of a tensor with dimensions. A 0-dim
    lift_fresh is let through: under a dispatch mode, index assignment of
    a Python scalar (``J[..., 5, 2] = 1.0``) lifts the scalar as a 0-dim
    CPU tensor, which the assignment turns into a fill of the slice, a
    kernel with the value as its argument, on the card too. Assigned to a
    single element (``q[0] = 1.0``) the lifted scalar is copied instead,
    a synchronous copy from the host on the card: that copy raises."""

    def __enter__(self):
        self._patches = [mock.patch.object(torch, name, _from_host(name))
                         for name in FROM_HOST]
        for p in self._patches:
            p.start()
        self._lifted = []
        return super().__enter__()

    def __exit__(self, *exc):
        for p in self._patches:
            p.stop()
        self._lifted = []
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if (name in HOST_READS or name.lstrip("_").startswith("unique")
                or (name == "lift_fresh" and args[0].dim() > 0)
                or (name in ("index", "index_put", "index_put_")
                    and _bool_index(args))
                or (name == "copy_"
                    and any(args[1] is t for t in self._lifted))):
            raise AssertionError(f"host read inside the frame: aten.{name}")
        out = func(*args, **(kwargs or {}))
        if name == "lift_fresh":
            self._lifted.append(out)
        return out


def _from_host(name):
    def raises(*args, **kwargs):
        raise AssertionError(f"host read inside the frame: torch.{name}")
    return raises


def _bool_index(args) -> bool:
    idx = args[1] if len(args) > 1 else ()
    return any(isinstance(i, torch.Tensor)
               and i.dtype in (torch.bool, torch.uint8) for i in idx)


def _sim_cfg(route, dtype):
    filt, _ = SIM_ROUTES[route]
    return EngineConfig.from_dict({**SIM, "filter": filt, "dtype": dtype})


def _image_cfg(route, dtype):
    return EngineConfig.from_dict({**IMAGE, "vision": {
        **VISION, **IMAGE_ROUTES[route]}, "dtype": dtype})


def _update_form(route):
    return mock.patch.object(engine, "UPDATE", SIM_ROUTES[route][1])


def _sim_inputs(cfg):
    _, _, obs = simulate(torch.Generator().manual_seed(0), cfg,
                         SIM_FRAMES + 1, "cpu")
    st0 = engine.bootstrap(init_state(cfg, B, "cpu"), obs.frame(0), cfg)
    u = torch.rand(SIM_FRAMES, B, cfg.ransac.num_hypotheses,
                   dtype=cfg.torch_dtype,
                   generator=torch.Generator().manual_seed(1))
    return st0, obs.window(1, SIM_FRAMES + 1), u


def _image_inputs(cfg):
    scn, xs, _ = simulate(torch.Generator().manual_seed(0), cfg,
                          IMAGE_FRAMES, "cpu")
    imgs = torch.stack([frontend.render_scene_image(scn, xs[t], cfg, "cpu")
                        for t in range(IMAGE_FRAMES)])
    u = torch.rand(IMAGE_FRAMES, B, cfg.ransac.num_hypotheses,
                   dtype=cfg.torch_dtype,
                   generator=torch.Generator().manual_seed(1))
    return (init_state(cfg, B, "cpu"), frontend.init_appearance(cfg, B, "cpu"),
            imgs, u)


def _bits(t: torch.Tensor) -> torch.Tensor:
    ints = {torch.float64: torch.int64, torch.float32: torch.int32,
            torch.bfloat16: torch.int16}
    return t.view(ints[t.dtype]) if t.dtype in ints else t


def _assert_bitwise(got, want, what):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert torch.equal(_bits(got), _bits(want)), what


def _assert_infos_bitwise(got, want):
    for f in engine.StepInfo.__dataclass_fields__:
        _assert_bitwise(getattr(got, f), getattr(want, f), f)


# --- (a) no host read in a frame --------------------------------------------

@pytest.mark.parametrize("route", sorted(SIM_ROUTES))
def test_sim_frame_reads_nothing_back(route):
    """The second frame of the static-buffer driver under NoHostReads."""
    cfg = _sim_cfg(route, "float32")
    st0, obs, u = _sim_inputs(cfg)
    carry = tuple(getattr(st0, f) for f in FIELDS)
    with _update_form(route):
        frame = graph.StaticFrame(lambda c, i: engine._sim_frame(c, i, cfg),
                                  carry, (obs.pixels[0], obs.visible[0], u[0]))
        frame()
        with NoHostReads():
            frame.step((obs.pixels[1], obs.visible[1], u[1]))
    assert torch.isfinite(frame.carry[0]).all()


@pytest.mark.parametrize("route", sorted(IMAGE_ROUTES))
def test_image_frame_reads_nothing_back(route):
    cfg = _image_cfg(route, "float32")
    st0, app0, imgs, u = _image_inputs(cfg)
    carry = (*(getattr(st0, f) for f in FIELDS),
             *(getattr(app0, f) for f in frontend.APPEARANCE_FIELDS))
    frame = graph.StaticFrame(lambda c, i: frontend._image_frame(c, i, cfg),
                              carry, (imgs[0], u[0]))
    frame()
    with NoHostReads():
        frame.step((imgs[1], u[1]))
    assert torch.isfinite(frame.carry[0]).all()


def test_no_host_reads_catches_a_host_read():
    """The mode itself: .item(), bool(), a mask index, torch.tensor and a
    Python scalar assigned to one element raise inside it; the same
    scalar assigned to a slice (a fill) does not."""
    x = torch.arange(4.0)
    for read in (lambda: x.sum().item(), lambda: bool(x[0] > 1),
                 lambda: x[x > 1], lambda: torch.tensor(1.0),
                 lambda: torch.nonzero(x), lambda: torch.unique(x),
                 lambda: torch.masked_select(x, x > 1),
                 lambda: x.__setitem__(0, 1.0)):
        with pytest.raises(AssertionError, match="host read"):
            with NoHostReads():
                read()
    with NoHostReads():
        x[1:3] = 5.0
    assert x.tolist() == [0.0, 5.0, 5.0, 3.0]


# --- (b) the static-buffer driver equals the eager loop, bit for bit ----------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("route", sorted(SIM_ROUTES))
def test_sim_static_driver_equals_eager(route, dtype):
    cfg = _sim_cfg(route, dtype)
    st0, obs, u = _sim_inputs(cfg)
    with _update_form(route):
        want = engine.run_sequence(st0, obs, u, cfg, eager=True)
        got = engine.frame_driver(st0, obs, u, cfg, capture=False)
    for f in FIELDS:
        _assert_bitwise(getattr(got[0], f), getattr(want[0], f), f)
    _assert_bitwise(got[1], want[1], "trajectory")
    _assert_infos_bitwise(got[2], want[2])
    assert int(want[2].n_li.sum()) > 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("route", sorted(IMAGE_ROUTES))
def test_image_static_driver_equals_eager(route, dtype):
    cfg = _image_cfg(route, dtype)
    st0, app0, imgs, u = _image_inputs(cfg)
    want = frontend.run_images(st0, app0, imgs, u, cfg, "cpu", eager=True)
    got = frontend.frame_driver(st0, app0, imgs, u, cfg, capture=False)
    for f in FIELDS:
        _assert_bitwise(getattr(got[0], f), getattr(want[0], f), f)
    for f in frontend.APPEARANCE_FIELDS:
        _assert_bitwise(getattr(got[1], f), getattr(want[1], f), f)
    _assert_bitwise(got[2], want[2], "trajectory")
    _assert_infos_bitwise(got[3], want[3])
    assert int(want[3].n_ic[:, -1].sum()) > 0


# --- (c) the static-buffer driver against JAX's scan ------------------------

@pytest.mark.parametrize("fused_step", ["on", "off"])
def test_static_driver_matches_jax_scan(fused_step):
    """JAX's run_sequence (lax.scan of step, its keys split over the
    frames) vmapped over B instances; the port's static-buffer driver on
    the same observations with the draws JAX's RANSAC makes from those
    keys."""
    jc, tc = configs({**FUSED, "filter": {"fused_step": fused_step}})
    T = SIM_FRAMES
    nh = jc.ransac.num_hypotheses
    keys = jax.random.split(jax.random.key(7), B)
    with interpret_mode():
        _, obs, jst = sim_and_bootstrap(jc, 0, T + 1, B)
        seq = jax.tree.map(lambda a: a[1:], obs)
        jfinal, jtraj, jinfos = jax.jit(jax.vmap(
            lambda s, k: jengine.run_sequence(s, seq, k, jc)))(jst, keys)
    u = np.stack([ransac_u(jax.random.split(k, T), nh) for k in keys],
                 axis=1)                                    # (T, B, NHYP)
    final, traj, infos = engine.frame_driver(
        port_state(jst), port_obs(seq), torch.tensor(u), tc, capture=False)
    np.testing.assert_allclose(n(final.x), np.asarray(jfinal.x), **X_TOL)
    np.testing.assert_allclose(n(final.P), np.asarray(jfinal.P), **P_TOL)
    np.testing.assert_allclose(n(traj), np.asarray(jtraj), **X_TOL)
    for f in ("active", "cartesian", "landmark_id", "times_predicted",
              "times_measured"):
        np.testing.assert_array_equal(n(getattr(final, f)),
                                      np.asarray(getattr(jfinal, f)), f)
    for f in ("n_visible", "n_ic", "n_li", "n_hi", "ransac_support"):
        np.testing.assert_array_equal(n(getattr(infos, f)),
                                      np.asarray(getattr(jinfos, f)), f)
    assert int(np.asarray(jinfos.n_li).sum()) > 0


# --- (d) no silent fallback --------------------------------------------------

def test_replay_on_the_cpu_raises():
    cfg = _sim_cfg("unfused_i", "float64")
    st0, obs, u = _sim_inputs(cfg)
    with pytest.raises(ValueError, match="CUDA graph"):
        engine.run_sequence(st0, obs, u, cfg, eager=False)
    icfg = _image_cfg("ncc_affine", "float64")
    ist0, iapp0, imgs, iu = _image_inputs(icfg)
    with pytest.raises(ValueError, match="CUDA graph"):
        frontend.run_images(ist0, iapp0, imgs, iu, icfg, "cpu", eager=False)
    frame = graph.StaticFrame(lambda c, i: engine._sim_frame(c, i, cfg),
                              tuple(getattr(st0, f) for f in FIELDS),
                              (obs.pixels[0], obs.visible[0], u[0]))
    with pytest.raises(ValueError, match="CUDA graph"):
        frame.capture()


def test_cpu_default_is_the_eager_loop():
    """eager=None on CPU tensors never reaches graph.py; the result is
    the eager loop's."""
    cfg = _sim_cfg("unfused_i", "float64")
    st0, obs, u = _sim_inputs(cfg)
    with mock.patch.object(graph, "run", side_effect=AssertionError):
        final, _, _ = engine.run_sequence(st0, obs, u, cfg)
        frontend.run_images(*_image_inputs(_image_cfg("descriptor",
                                                      "float64")),
                            _image_cfg("descriptor", "float64"), "cpu")
    _assert_bitwise(final.P, engine.run_sequence(st0, obs, u, cfg,
                                                 eager=True)[0].P, "P")
    assert graph.replays(torch.device("cpu"), None) is False
    assert graph.replays(torch.device("cpu"), True) is False


def test_carry_copy_survives_aliased_buffers():
    """A frame whose new carry is its old carry swapped (each new tensor
    a static buffer of another field) and a view of its own buffer: the
    copy clones first, as the eager loop would see it."""
    def fn(carry, inputs):
        a, b, c = carry
        return (b, a, c.flip(0) + inputs[0]), (a + b,)

    carry = (torch.tensor([1.0, 2.0]), torch.tensor([3.0, 4.0]),
             torch.tensor([5.0, 6.0]))
    final, (sums,) = graph.run(fn, carry,
                               lambda t: (torch.full((2,), t),), 3, None,
                               capture=False)
    want, outs = carry, []
    for t in range(3):
        want, (out,) = fn(want, (torch.full((2,), t),))
        outs.append(out)
    for got, ref in zip(final, want):
        _assert_bitwise(got, ref, "carry")
    _assert_bitwise(sums, torch.stack(outs, dim=1), "outputs")
