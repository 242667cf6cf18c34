"""Driver ``sim_sequence``: batched filters on synthetic observations.

The timed entry is ``ekf_slam_tpu_torch.filter.engine.run_sequence``: B
filters that share one sequence of landmark observations and differ in
their RANSAC draws, on the card by replaying one captured frame. A call
runs the traffic's ``frames_per_call`` frames of the sequence from the
state the previous call returned; when the sequence ends, the next call
starts again from its first state, the filters bootstrapped on frame 0
at set-up (``engine.bootstrap``, map management before the first
prediction). A call ends when the camera block of every frame it ran,
(B, frames, 13), is on the host.
"""

from __future__ import annotations

import torch

from benchmark.harness import inputs
from benchmark.harness.session import Session as Base
from benchmark.reference import slam
from ekf_slam_tpu_torch.config import EngineConfig
from ekf_slam_tpu_torch.filter import engine
from ekf_slam_tpu_torch.filter.state import init_state
from ekf_slam_tpu_torch.sim.scene import FrameObs


class Session(Base):
    def __init__(self, engine_cfg: dict, traffic: dict, seed: int, device):
        super().__init__(traffic, device)
        self.settings = slam.settings(engine_cfg)
        self.cfg = EngineConfig.from_dict(engine_cfg)
        self.seq = inputs.sequence(seed, self.settings, self.frames,
                                   self.instances, rendered=False)
        self.inputs = (FrameObs(torch.from_numpy(self.seq.pixels).to(device),
                                torch.from_numpy(self.seq.visible).to(device)),
                       torch.from_numpy(self.seq.u).to(device))
        self.start = engine.bootstrap(
            init_state(self.cfg, self.instances, device),
            self.inputs[0].frame(0), self.cfg)

    def entry(self, state, t0: int, t1: int):
        obs, u = self.inputs
        final, traj, info = engine.run_sequence(
            state, obs.window(t0, t1), u[t0:t1], self.cfg)
        return final, traj, info

    def reference_start(self, row: int):
        return slam.sim_bootstrap, (self.settings, self.seq.pixels[0],
                                    self.seq.visible[0])

    def reference_step(self, prev: dict, t: int, row: int):
        return slam.sim_step, (self.settings, prev, self.seq.pixels[t],
                               self.seq.visible[t], self.seq.u[t, row])
