"""Metrics, tracing and numerics guards.

Port of ``ekf_slam_tpu/utils/metrics.py``:

* ``MetricsLogger`` — in-memory scalar series, a console table and a JSONL
  dump;
* ``check_finite`` — the finite guard: returns the value and a bool
  tensor, and with debug=True prints a diagnostic when tripped (a host
  sync, so off by default);
* ``trace_annotation`` — a named range in torch.profiler traces
  (``torch.profiler.record_function``, the counterpart of
  ``jax.profiler.TraceAnnotation``);
* ``step_timer`` — wall-clock timing of a block, the card synchronized
  before and after when CUDA is in use.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Dict, List

import torch


def check_finite(x: torch.Tensor, name: str = "", debug: bool = False):
    """(x, ok) with ok = all(isfinite(x)), a bool tensor on x's device.
    debug=True prints min / max when ok is False."""
    ok = torch.isfinite(x).all()
    if debug and not bool(ok):
        print(f"NaN/Inf detected in {name} (min={float(x.min())}, "
              f"max={float(x.max())})", flush=True)
    return x, ok


@contextlib.contextmanager
def trace_annotation(name: str):
    """Named profiler range (shows in torch.profiler traces)."""
    with torch.profiler.record_function(name):
        yield


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
