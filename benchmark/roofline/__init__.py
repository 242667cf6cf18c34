"""The roofline's frozen arithmetic (``arith``) and the device symbols of
each of the port's kernels (``kernel_symbols.json``)."""
