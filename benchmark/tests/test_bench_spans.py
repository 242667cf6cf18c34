"""The span readers (metrics/span.py, driver_device_ms_per_frame,
program_idle_ms_per_call) on synthetic records: their arithmetic, nothing
for a missing or misplaced mark or a program without the span table, and
the mark parser on the name the card printed."""

import sys
import types

import pytest

from benchmark.harness import spec
from benchmark.metrics import span
from ekf_slam_tpu_torch.utils.metrics import SPANS

# The name torch.profiler gave a mark's device operation on the card
# (NVIDIA H100 80GB HBM3): the span sim.ransac's end.
CARD_NAME = "void span_mark<3, 1>()"

INNER = ("sim.manage_predict", "sim.linearize_ic", "sim.ransac",
         "sim.li_update", "sim.hi_rescue", "sim.hi_update", "sim.init",
         "frame.carry")
METRICS = [n.replace(".", "_") + "_span" for n in INNER]


def mark(name, end, t):
    return (f"void span_mark<{SPANS.index(name)}, {end}>()", t, t + 1)


def frame_ops(base, order=INNER):
    """One frame at `base` µs: a 10-µs copy in, the frame's marks, in each
    inner span two operations whose union is 18 µs, a 40-µs copy out."""
    ops = [("Memcpy DtoD (Device -> Device)", base, base + 10),
           mark("frame", 0, base + 20)]
    for k, name in enumerate(order):
        s = base + 30 + 60 * k
        ops += [mark(name, 0, s), ("elementwise", s + 2, s + 12),
                ("sgemm", s + 8, s + 20), mark(name, 1, s + 30)]
    ops += [mark("frame", 1, base + 490),
            ("Memcpy DtoH (Device -> Pageable)", base + 500, base + 540)]
    return ops


def record(frames=2):
    """`frames` calls of one frame each, 1,000 µs apart; the program's
    host range sim.run_sequence over the first 600 µs of each call, the
    benchmark's host code over the rest."""
    device, host = [], []
    for f in range(frames):
        device += frame_ops(1000 * f)
        host += [("sim.run_sequence", 1000 * f, 1000 * f + 600),
                 ("aten::to", 1000 * f + 600, 1000 * f + 1000)]
    return dict(device=device, window=(0, 1000 * frames), host=host,
                frames=frames, frames_per_call=1)


def read(name, rec):
    return spec.reader(name)(rec)


def test_mark_parser_reads_the_card_name():
    assert span.parse_mark(CARD_NAME) == (SPANS.index("sim.ransac"), 1)
    assert span.parse_mark("void (anonymous namespace)::k3_kernel<float>("
                           "float const*)") is None


@pytest.mark.parametrize("metric", METRICS)
def test_span_is_the_union_between_its_marks(metric):
    assert read(metric, record()) == pytest.approx(0.018)


def test_driver_device_time_outside_the_frames():
    # the copy in (10 µs) and the copy out (40 µs) of each frame
    assert read("driver_device_ms_per_frame", record()) == pytest.approx(
        0.050)


def test_program_idle_counts_gaps_under_its_host_ranges():
    # idle in [0, 540] of each call (540 less 212 µs of device work); the
    # gap after the copy out, under the benchmark's host code, is not
    assert read("program_idle_ms_per_call", record()) == pytest.approx(
        0.328)
    rec = record()
    rec["host"] = [h for h in rec["host"] if h[0] != "sim.run_sequence"]
    assert read("program_idle_ms_per_call", rec) is None


def test_spans_and_driver_cover_the_device_work():
    rec = record()
    total = sum(read(m, rec) for m in METRICS) + read(
        "driver_device_ms_per_frame", rec)
    assert total == pytest.approx((8 * 18 + 50) / 1e3)


def test_nothing_for_a_missing_mark():
    rec = record()
    gone = mark("sim.ransac", 1, 1000 + 30 + 60 * 2 + 30)
    rec["device"].remove(gone)
    for m in METRICS + ["driver_device_ms_per_frame"]:
        assert read(m, rec) is None


def test_nothing_for_marks_out_of_order():
    rec = record()
    swapped = list(INNER)
    swapped[1], swapped[2] = swapped[2], swapped[1]
    rec["device"] = frame_ops(0) + frame_ops(1000, swapped)
    for m in METRICS + ["driver_device_ms_per_frame"]:
        assert read(m, rec) is None


def test_nothing_where_frames_are_missing():
    rec = record()
    rec["frames"] = 3
    assert read(METRICS[0], rec) is None
    rec = record()
    rec["device"] = [d for d in rec["device"] if "span_mark" not in d[0]]
    assert read(METRICS[0], rec) is None
    assert read("driver_device_ms_per_frame", rec) is None


def test_nothing_from_a_program_without_the_table(monkeypatch):
    monkeypatch.setitem(sys.modules, "ekf_slam_tpu_torch.utils.metrics",
                        types.ModuleType("ekf_slam_tpu_torch.utils.metrics"))
    rec = record()
    for m in METRICS + ["driver_device_ms_per_frame",
                        "program_idle_ms_per_call"]:
        assert read(m, rec) is None
