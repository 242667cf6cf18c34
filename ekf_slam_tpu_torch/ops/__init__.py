"""Low-level math ops: quaternion/rotation algebra, camera model, kernels."""
