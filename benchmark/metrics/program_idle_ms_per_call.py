"""program_idle_ms_per_call (ms, program span; layer: frame driver): idle
device time a call of the traced slice that the program's own host code
causes: the window's idle stretches (harness/trace.py idle_gaps) whose
midpoint lies under a host range of one of the program's spans
(ekf_slam_tpu_torch/utils/metrics.py SPANS, such as sim.run_sequence),
over the slice's calls. What is left of device_idle_share lies under the
benchmark's own host code. Nothing from a program without the table or
without a host range of it in the window."""

from benchmark.harness import trace
from benchmark.metrics import span


def read(rec):
    spans = span.table()
    if spans is None:
        return None
    names = set(spans)
    ranges = [(s, e) for name, s, e in rec["host"] if name in names]
    if not ranges:
        return None
    idle = sum(g1 - g0 for g0, g1 in trace.idle_gaps(rec)
               if any(s <= 0.5 * (g0 + g1) < e for s, e in ranges))
    calls = rec["frames"] / rec["frames_per_call"]
    return idle / 1e3 / calls
