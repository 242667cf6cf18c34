"""The import check: no JAX, and nothing of the JAX package, in a run.

Compared by whole top-level names (the part of a module's name before the
first dot), so the port ``ekf_slam_tpu_torch`` passes where the JAX
package ``ekf_slam_tpu`` does not.
"""

from __future__ import annotations

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ekf_slam_tpu")


def forbidden(modules) -> list:
    """The forbidden top-level names among the names of `modules`."""
    tops = {name.split(".", 1)[0] for name in modules}
    return sorted(tops.intersection(FORBIDDEN))
