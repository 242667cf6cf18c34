"""Each metric's arithmetic on a synthetic record: the union of device
intervals, an idle share within 0-100%, the glue / kernel split, the
roofline, the window's rates and tail."""

import numpy as np
import pytest

from benchmark.harness import spec, trace, verdict
from benchmark.roofline import arith

SYMBOLS = spec.load_json(spec.HERE / "roofline" / "kernel_symbols.json")


def read(name, rec):
    return spec.reader(name)(rec)


def record():
    """Two frames of one K4 call (1 kernel) and one K1 call (3 kernels),
    with glue around them; times in µs, the window 0-100."""
    k1 = dict(name="fused_manage_predict_pht",
              kernels=SYMBOLS["fused_manage_predict_pht"],
              flops=67e12 * 2e-6, bytes=3.35e12 * 1e-6)       # bound 2 µs
    k4 = dict(name="corr_apply_cols", kernels=SYMBOLS["corr_apply_cols"],
              flops=67e12 * 1e-6, bytes=3.35e12 * 4e-6)       # bound 4 µs
    device = []
    for f in range(2):
        t = 50 * f
        device += [("void k4_kernel<float>(float const*)", t + 5, t + 13),
                   ("aten::copy_ glue", t + 10, t + 20),          # overlaps
                   ("k3v_kernel(float const*)", t + 22, t + 24),
                   ("k1p_kernel(float const*)", t + 24, t + 30),
                   ("void k6_kernel<float, 128>(float const*)", t + 30,
                    t + 32),
                   ("elementwise glue", t + 40, t + 45)]
    host = [("graph.replay", 0, 60), ("aten::cpu", 60, 100)]
    return dict(device=device, window=(0, 100), host=host, frames=2,
                kernel_calls=[k4, k1], symbols=SYMBOLS)


def test_union_of_intervals():
    assert trace.merged([(5, 13), (10, 20), (22, 24), (24, 30)]) == [
        [5, 20], [22, 30]]
    busy, window = trace.busy(record())
    # per frame: [5, 20] + [22, 32] + [40, 45] = 30 µs, two frames
    assert (busy, window) == (60, 100)


def test_idle_share_within_bounds():
    assert read("device_idle_share", record()) == pytest.approx(40.0)
    rec = record()
    rec["device"] += [("x", -50, 150)]          # beyond the window: clipped
    assert read("device_idle_share", rec) == pytest.approx(0.0)
    rec["device"] = []
    assert read("device_idle_share", rec) == pytest.approx(100.0)


def test_idle_gaps_named_by_host():
    rec = record()
    gaps = trace.idle_gaps(rec)
    assert gaps[0] == (0, 5) and gaps[-1] == (95, 100)
    b = trace.breakdown(rec)
    names = dict(b["idle_gaps"])
    assert names["graph.replay"] == pytest.approx(25e-6)   # 5+2+8+5+2+3
    assert names["aten::cpu"] == pytest.approx(15e-6)      # 60-95 gaps: 5+5+5
    assert len(b["device_ops"]) <= 10


def test_glue_and_kernels_split():
    rec = record()
    assert read("glue_ops_per_frame", rec) == pytest.approx(2.0)
    assert read("glue_ms_per_frame", rec) == pytest.approx(0.015)
    assert read("kernel_ms_per_frame", rec) == pytest.approx(0.018)
    # a variant reads the same quantity for the cells of another metric
    assert read("glue_ms_per_frame.online", rec) == pytest.approx(0.015)


def test_roofline_shares():
    rec = record()
    # K4: bound 4 µs over 8 µs a frame; K1: 2 µs over 10 µs
    assert read("corr_apply_cols_roofline", rec) == pytest.approx(50.0)
    assert read("fused_manage_predict_pht_roofline", rec) == pytest.approx(
        20.0)
    assert read("kernels_roofline", rec) == pytest.approx(100 * 6 / 18)
    assert read("kernels_roofline.online", rec) == pytest.approx(
        100 * 6 / 18)
    assert read("fused_update_tail_pht_roofline", rec) is None
    assert read("no_such_kernel_roofline", rec) is None


def test_roofline_silent_when_kernels_do_not_follow_calls():
    rec = record()
    rec["device"] = [d for d in rec["device"] if "k1p" not in d[0]]
    assert read("kernels_roofline", rec) is None


def test_bound_picks_the_binding_side():
    assert arith.bound_s(67e12, 0) == pytest.approx(1.0)
    assert arith.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert arith.bound_s(67e12, 2 * 3.35e12) == pytest.approx(2.0)


def window():
    # three calls of two frames, B = 4: t0, returned, end (s)
    calls = [(0.0, 0.001, 0.010), (0.010, 0.012, 0.030), (0.030, 0.031,
                                                          0.040)]
    return dict(calls=calls, instances=4, frames_per_call=2, setup_s=3.5,
                memory_peak_bytes=4 * 2**20 * 10, capture_s=0.25)


def test_end_to_end_readers():
    rec = window()
    assert read("steps_per_s", rec) == pytest.approx(3 * 4 * 2 / 0.040)
    assert read("device_mib_per_instance", rec) == pytest.approx(10.0)
    assert read("setup_s", rec) == 3.5
    assert read("capture_s", rec) == 0.25
    assert read("driver_host_ms", rec) == pytest.approx(4 / 3)
    # latencies 10, 20, 10 ms, each of two frames
    assert read("frame_ms_p95", rec) == pytest.approx(20.0)
    rec["memory_peak_bytes"] = None
    assert read("device_mib_per_instance", rec) is None


def test_sample_rows_prefers_instances_that_differ():
    # instances 0-2 run alike, 3 differs: the second block draws 3
    traj = np.zeros((4, 2, 13), np.float32)
    traj[3, 1, 0] = 1.0
    assert verdict.distinct(traj) == 2
    for seed in range(8):
        rows = verdict.sample_rows(seed, traj, 2)
        assert rows[0] in (0, 1) and rows[1] == 3
    # all alike: one from each block all the same
    rows = verdict.sample_rows(5, np.zeros((8, 2, 13)), 4)
    assert [r // 2 for r in rows] == [0, 1, 2, 3]


def test_first_pass_takes_each_frame_once():
    cams = [np.full((2, 1, 13), t, np.float32) for t in (0, 1, 2, 0, 1)]
    frames_of = [[0], [1], [2], [0], [1]]
    traj = verdict.first_pass(dict(cams=cams, frames_of=frames_of))
    assert traj.shape == (2, 3, 13)
    assert (traj[:, :, 0] == [[0, 1, 2], [0, 1, 2]]).all()
