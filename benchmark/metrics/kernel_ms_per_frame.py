"""kernel_ms_per_frame (ms, device trace; layer: kernels): device time a
frame of the port's own kernels (roofline/kernel_symbols.json)."""

from benchmark.harness import trace


def read(rec):
    own = trace.split_ops(rec)[0]
    return trace.per_frame(rec, own)[1] if own else None
