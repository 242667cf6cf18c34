"""<kernel>_roofline (%, device trace; layer: kernels): the least time the
card could take for the traced slice's calls of logical kernel <kernel>
(a key of roofline/kernel_symbols.json), from each call's operand shapes
(roofline/arith.py), over the device time its kernels took;
kernels_roofline: the same over every call of the port's kernels. Nothing
where the slice ran no such call (harness/trace.py's roofline_share)."""

from benchmark.harness import trace

SUFFIX = "_roofline"


def read(rec, name):
    kernel = name[:-len(SUFFIX)]
    return trace.roofline_share(rec, None if kernel == "kernels" else kernel)
