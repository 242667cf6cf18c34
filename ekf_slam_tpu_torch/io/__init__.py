"""Files on disk: image sequences (sequence.py) and KITTI-format poses
(poses.py). Port of ``ekf_slam_tpu/io``."""

from ekf_slam_tpu_torch.io.sequence import (ImageSequence, build_native,
                                            load_pgm, native_available,
                                            write_pgm, write_ppm)

__all__ = ["ImageSequence", "load_pgm", "write_pgm", "write_ppm",
           "build_native", "native_available"]
