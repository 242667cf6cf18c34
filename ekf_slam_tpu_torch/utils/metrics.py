"""Metrics, tracing and numerics guards.

Port of ``ekf_slam_tpu/utils/metrics.py``:

* ``MetricsLogger`` — in-memory scalar series, a console table and a JSONL
  dump;
* ``check_finite`` — the finite guard: returns the value and a bool
  tensor, and with debug=True prints a diagnostic when tripped (a host
  sync, so off by default);
* ``trace_annotation`` — the port's one span facility (the counterpart of
  ``jax.profiler.TraceAnnotation``), over the span names of ``SPANS``.
  With a CUDA ``device`` it launches an empty kernel at the span's begin
  and another at its end on the current stream (``csrc/spans.cu``,
  ``span_mark<id, end>``, id the name's place in ``SPANS``): inside a
  capture the marks become nodes of the CUDA graph, so a replayed frame
  still shows its stages on the device timeline, where no host range is
  entered. The marks are launched whether or not a profiler runs (a graph
  is captured before any profiler starts); a mark in a replayed graph
  costs ~0.8 µs on an H100. While a torch.profiler session collects, the
  span is also a host range; without one no range is entered, and the
  cost on the host is one flag check. The host range is a function-scope
  record (``torch._C._profiler._RecordFunctionFast``), not a user
  annotation (``torch.profiler.record_function``): the profiler mirrors
  a user annotation on the device as one event over every kernel it
  launched, which a reader of device operations would count as device
  work;
* ``step_timer`` — wall-clock timing of a block, the card synchronized
  before and after when CUDA is in use.

Who reads the spans: the benchmark's ``<span>_span``,
``driver_device_ms_per_frame`` and ``program_idle_ms_per_call`` (the sim
frame's and ``sim.run_sequence``), chip_smoke's ``[loop]`` and
``[train]`` lines (the ``loop.*`` and ``train.*`` host ranges).
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Dict, List

import torch

from ekf_slam_tpu_torch.ops import _build

# The program's spans. A span's id is its place in this table (below
# csrc/spans.cu's SPAN_IDS, 32); each name is unique, also with its dots
# written as underscores (the benchmark's metric <name>_span). Spans of
# one frame are in the order they begin.
SPANS = (
    "frame",               # graph.StaticFrame: one frame over the buffers
    "sim.manage_predict",  # engine.step_fused 1+2: map management, prior
    "sim.linearize_ic",    # 3: linearization, K1, S, IC gates
    "sim.ransac",          # 4: 1-point RANSAC
    "sim.li_update",       # 5: the LI gain
    "sim.hi_rescue",       # 6: linearization at the posterior, K2, rescue
    "sim.hi_update",       # 7: the HI gain
    "sim.init",            # 8: counters, the camera stripe, feature init, K3
    "frame.carry",         # graph._assign: the new carry into its buffers
    "sim.run_sequence",    # engine.run_sequence (host only)
    "loop.vss",            # loop_runner's frame: the VSS forward
    "loop.query",          # the database query and temporal filter
    "loop.fusion",         # the loop constraint
    "train.augment",       # train.train_step (host only: run eagerly)
    "train.forward",
    "train.backward",
    "train.optimizer",
)
_ID = {name: i for i, name in enumerate(SPANS)}


def check_finite(x: torch.Tensor, name: str = "", debug: bool = False):
    """(x, ok) with ok = all(isfinite(x)), a bool tensor on x's device.
    debug=True prints min / max when ok is False."""
    ok = torch.isfinite(x).all()
    if debug and not bool(ok):
        print(f"NaN/Inf detected in {name} (min={float(x.min())}, "
              f"max={float(x.max())})", flush=True)
    return x, ok


def _stream(device):
    """The current stream's handle on a CUDA `device`; None elsewhere (no
    marks)."""
    if device is None or torch.device(device).type != "cuda":
        return None
    return torch.cuda.current_stream(device).cuda_stream


def _mark(span: int, end: int, stream: int) -> None:
    err = _build.load().ekf_span_mark(span, end, stream)
    if err != 0:
        raise RuntimeError(f"span mark {SPANS[span]!r}: CUDA launch failed "
                           f"with cudaError_t {err}")


@contextlib.contextmanager
def trace_annotation(name: str, device=None):
    """Span `name` (an entry of SPANS) around the block: on a CUDA
    `device`, a device mark on the current stream at entry and at exit;
    a host range while a profiler collects."""
    span = _ID.get(name)
    if span is None:
        raise ValueError(f"span {name!r} is not in utils.metrics.SPANS")
    stream = _stream(device)
    host = (torch._C._profiler._RecordFunctionFast(name)
            if torch._C._autograd._profiler_enabled()
            else contextlib.nullcontext())
    with host:
        if stream is not None:
            _mark(span, 0, stream)
        yield
        if stream is not None:
            _mark(span, 1, stream)


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def step_timer(results: Dict[str, float], name: str):
    """results[name] = seconds the block took, the card idle at both
    ends."""
    _sync()
    t0 = time.perf_counter()
    yield
    _sync()
    results[name] = time.perf_counter() - t0


class MetricsLogger:
    """Scalar series with a console table and a JSONL dump."""

    def __init__(self):
        self._series: Dict[str, List[float]] = {}
        self._steps: List[int] = []

    def log(self, step: int, **scalars):
        self._steps.append(step)
        for k, v in scalars.items():
            self._series.setdefault(k, []).append(float(v))

    def table(self, last_n: int = 1) -> str:
        keys = sorted(self._series)
        lines = ["step  " + "  ".join(f"{k:>12s}" for k in keys)]
        for i in range(max(0, len(self._steps) - last_n), len(self._steps)):
            lines.append(f"{self._steps[i]:>4d}  " + "  ".join(
                f"{self._series[k][i]:12.5g}" for k in keys))
        return "\n".join(lines)

    def dump_jsonl(self, path: str):
        with open(path, "w") as f:
            for i, s in enumerate(self._steps):
                rec = {"step": s}
                rec.update({k: v[i] for k, v in self._series.items()})
                f.write(json.dumps(rec) + "\n")

    def series(self, key: str) -> List[float]:
        return list(self._series[key])
