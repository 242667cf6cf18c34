"""The harness: the window, the traced slice, the verdict and the parts
found by name (``spec``)."""
