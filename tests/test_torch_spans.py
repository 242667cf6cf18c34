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
    every (id, end) of the table and refuses an id past its instances.
"""

import types

import pytest
import torch

from ekf_slam_tpu_torch.config import EngineConfig
from ekf_slam_tpu_torch.filter import engine
from ekf_slam_tpu_torch.filter.state import FIELDS, init_state
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


@pytest.fixture(scope="module")
def sequence():
    cfg = EngineConfig.from_dict(CFG)
    _, _, obs = simulate(torch.Generator().manual_seed(0), cfg, FRAMES, "cpu")
    st = engine.bootstrap(init_state(cfg, B, "cpu"), obs.frame(0), cfg)
    u = torch.rand(FRAMES, B, cfg.ransac.num_hypotheses,
                   generator=torch.Generator().manual_seed(1))
    return cfg, obs, st, u


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
