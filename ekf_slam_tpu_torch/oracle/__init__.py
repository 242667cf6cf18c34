"""NumPy float64 oracle of the reference MonoSLAM equations (test golden):
the port's own copy of ``ekf_slam_tpu/oracle``, which imports no JAX."""

from ekf_slam_tpu_torch.oracle import oracle  # noqa: F401
