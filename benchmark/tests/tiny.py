"""A cell of the benchmark cut to a size the CPU runs in seconds: CAP 8,
24 landmarks, 4 frames, B = 4, the fused step's plain versions on the sim
path (fused_step "on": on the CPU "auto" takes the unfused step)."""

from __future__ import annotations

import time

import torch

from benchmark.harness import main, spec

# A cell whose files stay while BENCHMARK.json leaves it out, because the
# program fails it (PERF.md, Open questions): the tests still drive them,
# so that a later benchmark can name the cell again as it stands.
DORMANT = [{"name": "image_ncc.online_b32", "config": "mono_image_ncc",
            "traffic": "online_b32", "chips": 1}]


def bench() -> dict:
    """BENCHMARK.json with the dormant cells among its workloads."""
    b = spec.benchmark()
    return dict(b, workloads=b["workloads"] + DORMANT)


def tiny_cell(name: str, instances: int = 4, sampled: int = 2,
              hypotheses: int | None = None) -> dict:
    c = spec.cell(bench(), name)
    eng = c["config"]["engine"]
    if hypotheses is not None:
        eng["ransac"]["num_hypotheses"] = hypotheses
    eng["map"].update(capacity=8, min_features_in_image=6,
                      max_new_per_step=4, max_update_obs=6)
    eng["sim"]["num_landmarks"] = 24
    if c["config"]["driver"] == "sim_sequence":
        eng["filter"]["fused_step"] = "on"
    t = c["traffic"]
    t.update(instances=instances, sequence_frames=4,
             sampled_instances=sampled, traced_calls=2,
             frames_per_call=min(t["frames_per_call"], 4))
    return c


def run_tiny(name: str, seed: int = 7, traced: bool = False, **kw) -> dict:
    """One run of the tiny cell on the CPU (no look for a card), its window
    at least one pass over the sequence however busy the CPU is."""
    orig = main.window

    def window(session, seconds):
        w = orig(session, seconds)
        while len(w["calls"]) * session.frames_per_call < session.frames:
            for k, v in orig(session, 0.0).items():
                w[k] += v
        return w

    main.window = window
    try:
        return main.run_cell(tiny_cell(name, **kw), seed, 0.2, traced,
                             torch.device("cpu"), time.perf_counter())
    finally:
        main.window = orig


CELLS = ("sim_f32.offline_b1024", "image_ncc.online_b32")
