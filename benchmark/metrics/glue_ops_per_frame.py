"""glue_ops_per_frame (ops, device trace; layer: glue): device operations
(kernels, copies, sets) a frame in the traced slice, other than the
port's own kernels; the calls' copies of the carry and of the camera
block amortised over their frames."""

from benchmark.harness import trace


def read(rec):
    return trace.per_frame(rec, trace.split_ops(rec)[1])[0]
