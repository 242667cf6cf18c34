"""Driver ``image_sequence``: batched filters fed rendered frames.

The timed entry is ``ekf_slam_tpu_torch.vision.frontend.run_images``: B
filters that share one sequence of 240x320 frames and differ in their
RANSAC draws, each frame through the image front-end (template warp, NCC
search, FAST init) and the filter, on the card by replaying one captured
frame. A call runs the traffic's ``frames_per_call`` frames from the state
and appearance store the previous call returned; when the sequence ends,
the next call starts again from its first state, an empty map and store
made at set-up. A call ends when the camera block of every frame it ran,
(B, frames, 13), is on the host.
"""

from __future__ import annotations

import torch

from benchmark.harness import inputs
from benchmark.harness.session import Session as Base
from benchmark.harness.session import state_rows
from benchmark.reference import frontend, slam
from benchmark.reference.frontend import STORE_FIELDS
from ekf_slam_tpu_torch.config import EngineConfig
from ekf_slam_tpu_torch.filter.state import init_state
from ekf_slam_tpu_torch.vision import frontend as program_frontend

class Session(Base):
    def __init__(self, engine_cfg: dict, traffic: dict, seed: int, device):
        super().__init__(traffic, device)
        self.settings = slam.settings(engine_cfg)
        self.cfg = EngineConfig.from_dict(engine_cfg)
        self.seq = inputs.sequence(seed, self.settings, self.frames,
                                   self.instances, rendered=True)
        self.inputs = (torch.from_numpy(self.seq.frames).to(device),
                       torch.from_numpy(self.seq.u).to(device))
        self.start = (init_state(self.cfg, self.instances, device),
                      program_frontend.init_appearance(
                          self.cfg, self.instances, device))
        self._corners = None

    def entry(self, carry, t0: int, t1: int):
        imgs, u = self.inputs
        state, app, traj, info = program_frontend.run_images(
            *carry, imgs[t0:t1], u[t0:t1], self.cfg, device=self.device)
        return (state, app), traj, info

    def rows(self, carry, idx) -> list:
        state, app = carry
        out = state_rows(state, idx)
        for f in STORE_FIELDS:
            col = getattr(app, f)[idx].cpu().numpy()
            for j, row in enumerate(out):
                row[f] = col[j]
        return out

    def reference_start(self, row: int):
        return slam.empty_state, (self.settings,)

    def reference_step(self, prev: dict, t: int, row: int):
        s = self.settings
        if self._corners is None:
            self._corners = [frontend.corners(img, s, s.map.max_new_per_step
                                              + s.map.capacity)
                             for img in self.seq.frames.astype("float64")]
        return frontend.image_step, (s, prev, self.seq.frames[t],
                                     self._corners[t], self.seq.u[t, row])
