"""EKF-SLAM filter core, batched over filter instances: state, motion and
measurement models, association, gain, map management, RANSAC, engine."""

from ekf_slam_tpu_torch.filter.state import (  # noqa: F401
    FilterState, init_state)
