"""ekf_slam_tpu_torch — the PyTorch / CUDA port of ekf_slam_tpu.

The batched sim-path SLAM frame (bootstrap, then the fused or the
unfused step under run_sequence) over a leading axis of independent
filter instances, with the full-covariance work in hand-written CUDA
kernels for Hopper (ops/kernels.py, csrc/) and their plain PyTorch
versions on CPU tensors; the image front-end (vision/); the CALC2
loop-closure path (models/, filter/loop_fusion.py, run_loop_closure.py)
and the trajectory metrics (utils/). Imports torch, never jax; the JAX
package ekf_slam_tpu is the reference the port is tested against.
"""

__version__ = "0.1.0"

import torch

# Covariance algebra runs in IEEE f32 on the card: no TF32 in matmuls or
# convolutions (TF32 keeps ~3 decimal digits; the filter's S loses SPD-ness).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from ekf_slam_tpu_torch import config  # noqa: F401
