"""device_idle_share (%, device trace; layer: device): the share of the
traced slice's window (its calls on the host clock) in which no device
operation ran, from the union of the device operations' intervals."""

from benchmark.harness import trace


def read(rec):
    busy, window = trace.busy(rec)
    return 100.0 * (1.0 - busy / window) if window > 0 else None
