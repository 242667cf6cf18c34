"""What every driver's session shares: the calls of the timed entry over a
sequence that restarts, and the re-run that the verdict reads.

A driver subclasses ``Session``. It sets ``inputs`` (the sequence's device
tensors) and ``start`` (the carry a sequence starts from, made at
set-up), and defines ``entry(carry, t0, t1)``: the timed entry over
frames t0..t1-1, returning (the new carry, the camera block (B, t1-t0, 13)
on the device, the program's StepInfo). It may override ``rows(carry,
idx)``, the carry's instances `idx` on the host, one dict each. Its
``reference_start(row)`` and ``reference_step(prev, t, row)`` each return
a function of ``benchmark.reference`` and its arguments: the reference's
own first state of instance `row`, and one reference frame of it from
the program's state `prev`; they run in processes that import nothing
else.
"""

from __future__ import annotations

import time

import torch

from ekf_slam_tpu_torch.filter import graph

STATE_FIELDS = ("x", "P", "active", "cartesian", "times_predicted",
                "times_measured", "landmark_id")


def state_rows(state, idx) -> list:
    """A FilterState's instances `idx` as host dicts of numpy arrays."""
    cols = {f: getattr(state, f)[idx].cpu().numpy() for f in STATE_FIELDS}
    return [{f: cols[f][j] for f in STATE_FIELDS} for j in range(len(idx))]


class Session:
    def __init__(self, traffic: dict, device):
        self.instances = traffic["instances"]
        self.frames_per_call = traffic["frames_per_call"]
        self.frames = traffic["sequence_frames"]
        if self.frames % self.frames_per_call:
            raise ValueError("frames_per_call must divide sequence_frames")
        self.device = device
        self.carry = None
        self.next_frame = 0

    def call(self):
        """One call of the timed entry. Returns (host clock when the entry
        returned, the camera block (B, frames, 13) on the host, the
        sequence frames it ran)."""
        t0 = self.next_frame
        t1 = t0 + self.frames_per_call
        carry = self.start if t0 == 0 else self.carry
        self.carry = None
        self.carry, cam, _ = self.entry(carry, t0, t1)
        returned = time.perf_counter()
        cam = cam.cpu().numpy()
        self.next_frame = t1 % self.frames
        return returned, cam, list(range(t0, t1))

    def rows(self, carry, idx) -> list:
        return state_rows(carry, idx)

    def restart(self) -> None:
        """The next call starts the sequence again."""
        self.carry = None
        self.next_frame = 0

    def rerun(self, rows) -> dict:
        """One pass over the sequence through the same entry, one frame a
        call: the start's and every frame's carry of instances `rows`, each
        frame's camera block of every instance (B, 13) and gate counts of
        `rows`."""
        self.restart()
        idx = torch.as_tensor(rows, device=self.device)
        states, cams, counts = [self.rows(self.start, idx)], [], []
        carry = self.start
        for t in range(self.frames):
            carry, cam, info = self.entry(carry, t, t + 1)
            cams.append(cam[:, 0].cpu().numpy())
            counts.append(counts_of(info)[idx, 0].cpu().numpy())
            states.append(self.rows(carry, idx))
        return dict(states=states, cams=cams, counts=counts)

    def release(self) -> None:
        """Drop every device tensor of the program."""
        self.start = self.carry = self.inputs = None
        graph.clear()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()


def counts_of(info) -> torch.Tensor:
    """(B, frames, 3) gate counts of a StepInfo with (B, frames) fields:
    individually compatible, low- and high-innovation inliers."""
    return torch.stack([info.n_ic, info.n_li, info.n_hi], dim=-1)
