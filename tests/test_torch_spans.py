"""The port's spans (ekf_slam_tpu_torch/utils/metrics.py) on the CPU.

A span is a host range while a torch.profiler session collects, and on a
CUDA device a pair of device marks (csrc/spans.cu's span_mark<id, end>)
that a captured frame keeps at replay. Here, at a small size (CAP 8, B =
2, 2 frames of the fused step's plain versions) through the static-buffer
frame that capture records (engine.frame_driver(..., capture=False)):

(a) under a CPU profiler each frame shows its spans in the table's
    order, the seven stages and frame.carry nested in frame;
(b) the outputs are bit for bit the same with and without a profiler;
(c) without a profiler no host range is entered;
(d) the marks a CUDA device would get (the launcher stubbed): 18 a frame,
    the table's ids, nested, in order;
(e) the table's names are unique, also with dots as underscores;
(f) csrc/spans.cu compiled against tests/cuda_emulation's headers accepts
    every (id, end) of the table and refuses an id past its instances;
(g) the unfused frame (step_core, step_core_from_prior, initialize_features)
    and the IEKF's show the same stages, the IEKF's with iekf.iterate and
    iekf.tail nested in sim.li_update and no other frame with them, both
    under a CPU profiler and as the marks a card would get (18 a frame,
    22 with the IEKF's);
(h) the Cholesky gains a frame: 4 on the IEKF's (its 3 iterates and the
    last gain), none on the fused frame's, which solves by Newton; on CPU
    tensors kernels.COUNTS["cholesky_gain"] stays 0 (it counts the
    card's).
"""

import types

import pytest
import torch

from ekf_slam_tpu_torch.config import EngineConfig
from ekf_slam_tpu_torch.filter import ekf, engine
from ekf_slam_tpu_torch.filter.state import FIELDS, init_state
from ekf_slam_tpu_torch.ops import kernels
from ekf_slam_tpu_torch.sim import simulate
from ekf_slam_tpu_torch.utils import metrics
from test_torch_cuda_emulation import emulate  # noqa: F401 (fixture)

torch.set_num_threads(1)

B = 2
FRAMES = 2
CFG = {"filter": {"fused_step": "on"},
       "map": {"capacity": 8, "min_features_in_image": 6,
               "max_new_per_step": 4, "max_update_obs": 6},
       "sim": {"num_landmarks": 24}}
STAGES = ("sim.manage_predict", "sim.linearize_ic", "sim.ransac",
          "sim.li_update", "sim.hi_rescue", "sim.hi_update", "sim.init")
# A frame's spans in the order they begin: frame, the stages, frame.carry
FRAME_SPANS = ("frame", *STAGES, "frame.carry")
IEKF_SPANS = ("iekf.iterate", "iekf.tail")
# the other routes of the frame: their filter settings
ROUTES = {"fused": {"fused_step": "on", "gain_solver": "newton"},
          "unfused": {"fused_step": "off"},
          "iekf": {"fused_step": "off", "gain_solver": "newton",
                   "use_iterated_update": True, "iekf_iterations": 3}}


@pytest.fixture(scope="module")
def sequence():
    cfg = EngineConfig.from_dict(CFG)
    _, _, obs = simulate(torch.Generator().manual_seed(0), cfg, FRAMES, "cpu")
    st = engine.bootstrap(init_state(cfg, B, "cpu"), obs.frame(0), cfg)
    u = torch.rand(FRAMES, B, cfg.ransac.num_hypotheses,
                   generator=torch.Generator().manual_seed(1))
    return cfg, obs, st, u


@pytest.fixture(scope="module", params=["unfused", "iekf"])
def route_sequence(request):
    """(route, the module sequence's observations, start and draws run
    under the route's filter settings)."""
    cfg = EngineConfig.from_dict({**CFG, "filter": ROUTES[request.param]})
    _, _, obs = simulate(torch.Generator().manual_seed(0), cfg, FRAMES, "cpu")
    st = engine.bootstrap(init_state(cfg, B, "cpu"), obs.frame(0), cfg)
    u = torch.rand(FRAMES, B, cfg.ransac.num_hypotheses,
                   generator=torch.Generator().manual_seed(1))
    return request.param, (cfg, obs, st, u)


def _run(sequence):
    cfg, obs, st, u = sequence
    final, traj, info = engine.frame_driver(st, obs, u, cfg, capture=False)
    return ([getattr(final, f) for f in FIELDS] + [traj]
            + [getattr(info, f) for f in info.__dataclass_fields__])


def _profiled(sequence):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        out = _run(sequence)
    return out, [e for e in prof.events() if e.name in metrics.SPANS]


def test_frame_spans_in_table_order_and_nested(sequence):
    _, events = _profiled(sequence)
    frames = sorted((e for e in events if e.name == "frame"),
                    key=lambda e: e.time_range.start)
    assert len(frames) == FRAMES
    for f in frames:
        inside = sorted((e for e in events if e.cpu_parent is f),
                        key=lambda e: e.time_range.start)
        assert [e.name for e in inside] == list(FRAME_SPANS[1:])
        for e in inside:
            assert (f.time_range.start <= e.time_range.start
                    <= e.time_range.end <= f.time_range.end)
        ids = [metrics.SPANS.index(e.name) for e in inside]
        assert ids == sorted(ids)
    # nothing else: every span event is a frame or a child of one
    assert len(events) == FRAMES * len(FRAME_SPANS)


def test_outputs_bitwise_with_and_without_profiler(sequence):
    plain = _run(sequence)
    traced, _ = _profiled(sequence)
    for a, b in zip(plain, traced):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_no_host_range_without_profiler(sequence, monkeypatch):
    entered = []

    class Counting:
        def __init__(self, name, *args, **kw):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", Counting)
    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counting)
    _run(sequence)
    assert entered == []
    # the same frames under a profiler enter one range a span
    _profiled(sequence)
    assert entered.count("frame") == FRAMES
    assert sorted(set(entered)) == sorted(FRAME_SPANS)


def test_marks_of_the_frame(sequence, monkeypatch):
    """With the device taken for a card and the launcher recording, the
    marks the captured frame would hold."""
    marks = []
    monkeypatch.setattr(metrics, "_stream",
                        lambda device: None if device is None else 5)
    monkeypatch.setattr(metrics, "_mark",
                        lambda span, end, stream: marks.append(
                            (span, end, stream)))
    _run(sequence)
    ids = [metrics.SPANS.index(n) for n in FRAME_SPANS]
    one = ([(ids[0], 0)] + [m for i in ids[1:] for m in ((i, 0), (i, 1))]
           + [(ids[0], 1)])
    assert len(one) == 18
    assert [(s, e) for s, e, _ in marks] == one * FRAMES
    assert {st for _, _, st in marks} == {5}


def test_unfused_frame_spans_in_table_order_and_nested(route_sequence):
    route, sequence = route_sequence
    _, events = _profiled(sequence)
    frames = [e for e in events if e.name == "frame"]
    assert len(frames) == FRAMES
    li_children = list(IEKF_SPANS) if route == "iekf" else []
    for f in frames:
        inside = sorted((e for e in events if e.cpu_parent is f),
                        key=lambda e: e.time_range.start)
        assert [e.name for e in inside] == list(FRAME_SPANS[1:])
        li = inside[STAGES.index("sim.li_update")]
        nested = sorted((e for e in events if e.cpu_parent is li),
                        key=lambda e: e.time_range.start)
        assert [e.name for e in nested] == li_children
        for e in nested:
            assert (li.time_range.start <= e.time_range.start
                    <= e.time_range.end <= li.time_range.end)
        begun = inside[:STAGES.index("sim.li_update") + 1] + nested + \
            inside[STAGES.index("sim.li_update") + 1:]
        ids = [metrics.SPANS.index(e.name) for e in begun]
        assert ids == sorted(ids)
    assert len(events) == FRAMES * (len(FRAME_SPANS) + len(li_children))


def test_marks_of_the_unfused_frame(route_sequence, monkeypatch):
    """The marks a card would get on the unfused and the IEKF frame: the
    stages' of the fused frame, and on the IEKF's the two iekf spans'
    inside sim.li_update's; begins in id order, each span once, nested."""
    route, sequence = route_sequence
    marks = []
    monkeypatch.setattr(metrics, "_stream",
                        lambda device: None if device is None else 5)
    monkeypatch.setattr(metrics, "_mark",
                        lambda span, end, stream: marks.append((span, end)))
    _run(sequence)
    li = metrics.SPANS.index("sim.li_update")
    one = []
    for name in FRAME_SPANS[1:]:
        i = metrics.SPANS.index(name)
        inner = ([m for n in IEKF_SPANS
                  for m in ((metrics.SPANS.index(n), 0),
                            (metrics.SPANS.index(n), 1))]
                 if i == li and route == "iekf" else [])
        one += [(i, 0), *inner, (i, 1)]
    frame_id = metrics.SPANS.index("frame")
    one = [(frame_id, 0), *one, (frame_id, 1)]
    assert len(one) == (22 if route == "iekf" else 18)
    assert marks == one * FRAMES
    begins = [i for i, end in one if end == 0]
    assert begins == sorted(begins)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_cholesky_gains_a_frame(route, monkeypatch):
    """ekf._spd_inverse's calls a frame of the static-buffer frame: the
    IEKF's 3 iterates and last gain (its HI gain by Newton, as the
    benchmark's IEKF cell runs it), none on the fused route's Newton
    gains, the plain update's two on the unfused route's (gain_solver
    "cholesky"); the counter of the card's gains unmoved by CPU
    tensors."""
    cfg = EngineConfig.from_dict({**CFG, "filter": ROUTES[route]})
    _, _, obs = simulate(torch.Generator().manual_seed(0), cfg, FRAMES, "cpu")
    st = engine.bootstrap(init_state(cfg, B, "cpu"), obs.frame(0), cfg)
    u = torch.rand(FRAMES, B, cfg.ransac.num_hypotheses,
                   generator=torch.Generator().manual_seed(1))
    calls = []
    real = ekf._spd_inverse
    monkeypatch.setattr(ekf, "_spd_inverse",
                        lambda S: calls.append(S.shape) or real(S))
    monkeypatch.setitem(kernels.COUNTS, "cholesky_gain", 0)
    engine.frame_driver(st, obs, u, cfg, capture=False)
    want = {"fused": 0, "unfused": 2, "iekf": 4}[route]
    assert len(calls) == want * FRAMES
    assert kernels.COUNTS["cholesky_gain"] == 0


def test_mark_pair_around_the_block(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=7))
    monkeypatch.setattr(metrics, "_mark",
                        lambda *a: calls.append(a))
    with metrics.trace_annotation("sim.ransac", torch.device("cuda")):
        calls.append("block")
    i = metrics.SPANS.index("sim.ransac")
    assert calls == [(i, 0, 7), "block", (i, 1, 7)]
    with metrics.trace_annotation("sim.ransac", "cpu"), \
            metrics.trace_annotation("sim.run_sequence"):
        pass
    assert len(calls) == 3
    with pytest.raises(ValueError, match="SPANS"):
        with metrics.trace_annotation("sim.no_such_stage"):
            pass


def test_span_table_names_unique():
    names = metrics.SPANS
    assert len(set(names)) == len(names)
    assert len({n.replace(".", "_") for n in names}) == len(names)
    assert set(FRAME_SPANS) <= set(names)
    assert set(IEKF_SPANS) <= set(names)


@pytest.mark.parametrize("end", [0, 1])
@pytest.mark.parametrize("span", metrics.SPANS)
def test_emulated_span_mark_accepts_the_table(emulate, span, end):  # noqa: F811
    done = emulate("span", "f32", metrics.SPANS.index(span), end)
    assert done.returncode == 0, done.stdout + done.stderr[-3000:]


@pytest.mark.parametrize("span,end", [(32, 0), (32, 1), (-1, 0), (0, 2)])
def test_emulated_span_mark_refuses_past_its_instances(emulate, span,  # noqa: F811
                                                       end):
    done = emulate("span", "f32", span, end)
    assert done.returncode == 0, done.stdout + done.stderr[-3000:]
    assert "rc=1 ran=-1" in done.stdout
