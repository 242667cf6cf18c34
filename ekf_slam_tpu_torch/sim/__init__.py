from ekf_slam_tpu_torch.sim.scene import (Scene, FrameObs, make_scene,
                                          simulate_trajectory, observe,
                                          simulate)

__all__ = ["Scene", "FrameObs", "make_scene", "simulate_trajectory",
           "observe", "simulate"]
