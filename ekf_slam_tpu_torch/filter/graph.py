"""One frame of a sequence, captured as a CUDA graph and replayed.

The port's counterpart of the JAX package's ``lax.scan`` of the step under
``jit`` (``ekf_slam_tpu/filter/engine.py`` run_sequence; bench.py jits the
scan of ``step`` and of ``step_image``): XLA dispatches a whole frame at
once, where eager PyTorch launches every op of every frame from Python. The
frame's shapes are static and it has no data-dependent branch, so one
frame captured by ``torch.cuda.graph`` and replayed T times runs the same
kernels, in the same order, on the same data as T eager frames.

``StaticFrame`` holds the static device buffers of one frame function
``fn(carry, inputs) -> (new_carry, outputs)`` (tuples of tensors): the
carried state, the per-frame inputs, and the outputs of the last frame.
Calling it runs one frame over those buffers and copies the new carry
into the carry buffers, so that one call (or one replay of its graph)
advances one frame. That call is the exact callable capture records; on
the CPU the tests run it without capture (``run(..., capture=False)``).

``StaticFrame.capture`` runs WARMUP frames on a side stream (they create
the cuBLAS / cuSOLVER handles, load the kernel library, fill
``ops/consts.py``'s cache and set each kernel's shared-memory limit), then
captures one frame in the graph's own memory pool. The carry is copied at
the end of the frame rather than ping-ponged between two graphs on two
state sets: the copy of P is 2·B·D²·4 bytes (385 MB at B = 128, D = 613,
~0.12 ms at 3.35 TB/s against the fused frame's ~10 device ms), and one
graph keeps one memory pool and one set of buffers.

Captured frames are kept by (kind, config, the update layout, the kernel
wrappers in place, shapes, dtypes, device), as ``jit`` keeps its
programs, so a second sequence of the same shapes replays without
capturing again; MAX_CAPTURED are kept, the least recently used dropped
first (``clear`` drops them all and frees their pools). A frame whose
carry holds buffers used in place (``in_place``: the loop database's
ring, 9.36 GB at LoopConfig's capacity, which a copy would double) is
not kept: those buffers are the caller's and are returned as the final
carry, so the frame is captured for one sequence (``last_capture_s``
reads what the capture took).

A driver that runs several functions a frame with host code between them
(run_loop_closure: the filter's frame, the embed piece, the query piece,
with `declared` read back and a declared loop fused eagerly) takes each
as a ``piece`` and steps it itself, ``load``-ing a carry that host code
changed; ``EagerFrame`` is the same interface without static buffers, so
one host loop serves the eager route too.

Launch counts: a replay calls no wrapper, so ``kernels.LAUNCHES`` is
credited at each replay with the counts the captured frame made; the
warm-up frames and the capture are set-up and leave the counts as they
were. There is no fallback: a capture or replay that fails raises, and
asking for capture without a CUDA device raises.

Spans (utils/metrics.py): a frame runs in the span ``frame`` and its
carry's copy in ``frame.carry``; on a CUDA device their device marks are
captured with the frame and run at every replay.
"""

from __future__ import annotations

import collections
import time

import torch

from ekf_slam_tpu_torch.filter import ekf
from ekf_slam_tpu_torch.ops import kernels
from ekf_slam_tpu_torch.utils.metrics import trace_annotation

WARMUP = 2
MAX_CAPTURED = 8

_CAPTURED: collections.OrderedDict = collections.OrderedDict()
_last_capture_s = None


def replays(device: torch.device, eager) -> bool:
    """Whether a sequence driver replays a captured frame: `eager` None
    replays on a CUDA device and runs eagerly elsewhere, True runs
    eagerly, False replays and raises without a CUDA device."""
    if eager is None:
        return device.type == "cuda"
    if not eager and device.type != "cuda":
        raise ValueError(f"CUDA graph replay needs a CUDA device, got "
                         f"{device}; pass eager=True (or eager=None) for "
                         f"the eager loop")
    return not eager


def _assign(static, new) -> None:
    """Copy each new carry tensor into its static buffer. A new tensor
    that shares storage with a carry buffer other than its own (or is a
    view of its own) is cloned first, so no copy reads a buffer an
    earlier copy has overwritten."""
    ptrs = {s.untyped_storage().data_ptr() for s in static}
    staged = [n if n is s or n.untyped_storage().data_ptr() not in ptrs
              else n.clone() for s, n in zip(static, new)]
    for s, n in zip(static, staged):
        if n is not s:
            s.copy_(n)


class StaticFrame:
    """Static buffers of one frame function and the frame over them.
    `in_place`: indices of carry tensors that start all zero and are used
    as static buffers themselves, not copied (the frame writes them in
    place); the warm-up frames write into them, and capture zeroes them
    again."""

    def __init__(self, fn, carry, inputs, in_place=()):
        self.fn = fn
        self.in_place = frozenset(in_place)
        self.carry = tuple(t if i in self.in_place else t.clone()
                           for i, t in enumerate(carry))
        self.inputs = tuple(t.clone() for t in inputs)
        self.device = (*self.carry, *self.inputs)[0].device
        self.outputs = ()
        self.graph = None
        self.launches = {}
        self.capture_s = None

    def __call__(self) -> None:
        """One frame over the static buffers (what capture records), in
        the span ``frame``, the carry's copy in ``frame.carry``."""
        with trace_annotation("frame", self.device):
            new, self.outputs = self.fn(self.carry, self.inputs)
            with trace_annotation("frame.carry", self.device):
                _assign(self.carry, new)

    def load(self, carry) -> None:
        """`carry` into the carry buffers (as a frame's new carry is
        copied: a tensor that aliases a carry buffer other than its own is
        cloned first)."""
        _assign(self.carry, carry)

    def step(self, inputs):
        """The frame's inputs into their buffers, then one frame: the
        graph's replay once captured. Returns the static outputs (the
        next step overwrites them)."""
        for s, x in zip(self.inputs, inputs):
            s.copy_(x)
        if self.graph is None:
            self()
        else:
            self.graph.replay()
            for name, n in self.launches.items():
                kernels.LAUNCHES[name] += n
        return self.outputs

    def capture(self, warmup: int = WARMUP) -> None:
        """Warm-up frames on a side stream, then one frame captured there
        into a CUDA graph. Leaves the carry buffers advanced (load resets
        them; the in-place ones are zeroed here) and the launch counts as
        they were."""
        dev = self.device
        if dev.type != "cuda":
            raise ValueError(f"CUDA graph capture needs a CUDA device, "
                             f"got {dev}")
        t0 = time.perf_counter()
        before = dict(kernels.LAUNCHES)
        try:
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for _ in range(warmup):
                    self()
            warm = dict(kernels.LAUNCHES)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side):
                self()
            torch.cuda.current_stream(dev).wait_stream(side)
            self.launches = {k: v - warm[k]
                             for k, v in kernels.LAUNCHES.items()
                             if v != warm[k]}
        finally:
            kernels.LAUNCHES.update(before)
        self.graph = graph
        for i in self.in_place:
            self.carry[i].zero_()
        torch.cuda.synchronize(dev)
        global _last_capture_s
        self.capture_s = _last_capture_s = time.perf_counter() - t0


def _route() -> tuple:
    """What the frame function reads besides its arguments: the update
    layout (ekf._UPDATE, ekf._TAIL_SYM) and the kernel wrappers in place
    (a test or profile_slice may swap them for their plain versions)."""
    return (ekf._UPDATE, ekf._TAIL_SYM,
            tuple(getattr(kernels, name) for name in kernels.PLAIN))


def captured(key, fn, carry, inputs) -> StaticFrame:
    """The captured frame for `key` and the tensors' shapes, dtypes and
    device: from the cache, else built and captured now."""
    full = (key, _route(), tuple((tuple(t.shape), t.dtype, t.device)
                                 for t in (*carry, *inputs)))
    frame = _CAPTURED.get(full)
    if frame is None:
        frame = StaticFrame(fn, carry, inputs)
        frame.capture()
        _CAPTURED[full] = frame
        while len(_CAPTURED) > MAX_CAPTURED:
            _CAPTURED.popitem(last=False)
    _CAPTURED.move_to_end(full)
    return frame


def last_captured() -> StaticFrame:
    """The most recently used captured frame."""
    return next(reversed(_CAPTURED.values()))


def last_capture_s():
    """Seconds the last capture took (warm-up frames, capture, the
    in-place buffers' zeroing, synchronize), kept or not; None before
    the first."""
    return _last_capture_s


def clear() -> None:
    """Drop every captured frame (and with it its graph's memory pool)."""
    _CAPTURED.clear()


class EagerFrame:
    """The eager loop's frame: fn called on the carry it returned last, no
    static buffers and no graph; `step` and `load` as StaticFrame's."""

    def __init__(self, fn, carry):
        self.fn = fn
        self.carry = tuple(carry)
        self.in_place = frozenset()

    def load(self, carry) -> None:
        self.carry = tuple(carry)

    def step(self, inputs):
        self.carry, outputs = self.fn(self.carry, tuple(inputs))
        return outputs


def piece(fn, carry, inputs, key=None, capture=True, in_place=()):
    """The frame of fn ready to step from `carry` (`inputs`: the first
    frame's, for the static buffers' shapes): capture=True the captured
    frame for `key` (kept; with `in_place`, or no key, captured for this
    caller only), False the same frame callable over static buffers
    without a graph, None an EagerFrame. A driver that advances several
    pieces a frame, with host code between them, steps each itself and
    `load`s a carry that host code changed. A kept frame is shared by
    every caller of its key and shapes: one driver steps it at a time (a
    frame dropped from the cache stays valid for the caller holding
    it)."""
    if capture is None:
        return EagerFrame(fn, carry)
    if capture and key is not None and not in_place:
        frame = captured(key, fn, carry, inputs)
    else:
        frame = StaticFrame(fn, carry, inputs, in_place)
        if capture:
            frame.capture()
    frame.load(carry)
    return frame


def run(fn, carry, inputs_at, frames: int, key, capture: bool = True,
        in_place=()):
    """`frames` frames of fn from `carry`, frame t's inputs inputs_at(t)
    (called once a frame, in order): replayed from the captured frame for
    `key` (capture=True), the same frame callable over fresh static
    buffers without a graph (capture=False), or the eager loop
    (capture=None). With `in_place` (indices of carry tensors, all zero,
    that the frame writes in place) those tensors are the static buffers
    themselves and the frame is captured for this call, not kept. Returns
    (the final carry: copies of the static buffers, the in-place ones
    themselves; the outputs, each stacked over the frames on axis 1,
    after the batch axis)."""
    first = inputs_at(0)
    frame = piece(fn, carry, first, key, capture, in_place)
    rows = [tuple(o.clone() for o in frame.step(first if t == 0
                                                 else inputs_at(t)))
            for t in range(frames)]
    return (tuple(c if i in frame.in_place else c.clone()
                  for i, c in enumerate(frame.carry)),
            tuple(torch.stack(out, dim=1) for out in zip(*rows)))
