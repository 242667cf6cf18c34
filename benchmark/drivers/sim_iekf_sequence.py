"""Driver ``sim_iekf_sequence``: batched filters on synthetic observations
with the iterated EKF update.

The timed entry and its calls are ``sim_sequence``'s
(``ekf_slam_tpu_torch.filter.engine.run_sequence`` over B filters that
share one sequence of landmark observations, on the card by replaying one
captured frame); the configuration's ``filter.use_iterated_update`` takes
the unfused step with the iterated LI update. The reference frame is
``benchmark.reference.iekf.iekf_step``, the plain one with the iterated LI
update; the reference's first state is ``sim_sequence``'s.
"""

from __future__ import annotations

from benchmark.harness import spec
from benchmark.reference import iekf

sim_sequence = spec.module("drivers", "sim_sequence")


class Session(sim_sequence.Session):
    def reference_step(self, prev: dict, t: int, row: int):
        return iekf.iekf_step, (self.settings, prev, self.seq.pixels[t],
                                self.seq.visible[t], self.seq.u[t, row])
