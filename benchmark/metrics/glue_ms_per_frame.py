"""glue_ms_per_frame (ms, device trace; layer: glue): device time a frame
of the operations glue_ops_per_frame counts."""

from benchmark.harness import trace


def read(rec):
    return trace.per_frame(rec, trace.split_ops(rec)[1])[1]
