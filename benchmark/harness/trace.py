"""The traced slice: torch.profiler's events reduced to a record, and the
arithmetic the per-layer readers share.

The record of a traced run (``collect``) holds plain numbers only:

* ``device``: every device operation of the slice (kernels, copies,
  sets) as (name, start µs, end µs), in start order;
* ``window``: (start µs, end µs) of the profiled calls on the host, from
  the benchmark's own ``bench.call`` ranges around each call;
* ``host``: the host operations inside the window as (name, start µs,
  end µs), for naming what the host did while the device idled;
* ``frames``: the frames the slice ran;
* ``kernel_calls``: the port's kernel calls of one frame in call order,
  each {name, kernels, flops, bytes} (``roofline.arith``);
* ``symbols``: each logical kernel's device symbols (the data file
  ``roofline/kernel_symbols.json``).
"""

from __future__ import annotations

import collections

import torch
from torch.autograd import DeviceType

from benchmark.roofline import arith

CALL_RANGE = "bench.call"


def collect(prof) -> dict:
    device, host, calls = [], [], []
    for e in prof.events():
        span = (e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            if e.name != CALL_RANGE:     # the range's mirror on the device
                device.append((e.name, *span))
        elif e.name == CALL_RANGE:
            calls.append(span)
        else:
            host.append((e.name, *span))
    if not calls:
        raise RuntimeError("the traced slice recorded no call")
    window = (min(s for s, _ in calls), max(e for _, e in calls))
    device.sort(key=lambda d: d[1])
    host = [h for h in host if h[2] > window[0] and h[1] < window[1]]
    return dict(device=device, window=window, host=host)


def merged(intervals) -> list:
    """The union of (start, end) intervals as disjoint sorted ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy(rec) -> tuple:
    """(µs in which some device operation ran inside the window, the
    window's µs)."""
    w0, w1 = rec["window"]
    spans = [(max(s, w0), min(e, w1)) for _, s, e in rec["device"]
             if e > w0 and s < w1]
    return sum(e - s for s, e in merged(spans)), w1 - w0


def idle_gaps(rec) -> list:
    """The window's idle stretches, (start, end) µs."""
    w0, w1 = rec["window"]
    gaps, t = [], w0
    spans = [(s, e) for _, s, e in rec["device"] if e > w0 and s < w1]
    for s, e in merged(spans):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    return gaps


def is_port_kernel(name: str, symbols) -> bool:
    return any(s + "<" in name or s + "(" in name for s in symbols)


def port_symbols(rec) -> set:
    return {s for syms in rec["symbols"].values() for s in syms}


def split_ops(rec) -> tuple:
    """(the port's kernel operations, every other device operation)."""
    syms = port_symbols(rec)
    own, glue = [], []
    for d in rec["device"]:
        (own if is_port_kernel(d[0], syms) else glue).append(d)
    return own, glue


def _symbol(name: str, symbols):
    """The symbol among `symbols` that device operation `name` runs."""
    return next((s for s in symbols if is_port_kernel(name, [s])), None)


def kernel_segments(rec):
    """The port's kernel operations of the slice grouped by the logical
    call that launched them, [(call, [op, ...])] in order; None where the
    device's kernels do not follow the frame's calls."""
    own, _ = split_ops(rec)
    calls = rec["kernel_calls"] * rec["frames"]
    if not calls or len(own) != sum(len(c["kernels"]) for c in calls):
        return None
    out, i = [], 0
    for c in calls:
        ops = own[i:i + len(c["kernels"])]
        i += len(ops)
        if (sorted(_symbol(op[0], c["kernels"]) or "" for op in ops)
                != sorted(c["kernels"])):
            return None
        out.append((c, ops))
    return out


def kernel_calls(recorded: list, launches: dict, arith, symbols) -> list:
    """The captured frame's kernel calls, [{name, kernels, flops, bytes}]
    in call order: the last calls `recorded` (name, operand and output
    (shape, dtype), see ``record_kernel_calls``), as many of each name as
    the program counted in the frame (``launches``); [] where they do not
    agree."""
    n = sum(launches.values())
    last = recorded[len(recorded) - n:] if n else []
    if collections.Counter(name for name, _, _ in last) != launches:
        return []
    out = []
    for name, args, outs in last:
        metas = [torch.empty(a[0], dtype=a[1], device="meta")
                 if isinstance(a, tuple) else a for a in args]
        nbytes = sum(torch.Size(shape).numel() * dtype.itemsize
                     for shape, dtype in [a for a in args
                                          if isinstance(a, tuple)] + outs)
        out.append(dict(name=name, kernels=list(symbols[name]),
                        flops=arith.FLOPS[name](*metas), bytes=nbytes))
    return out


def record_kernel_calls(kernels) -> list:
    """Wrap each kernel wrapper of the module `kernels` (those it counts
    in LAUNCHES) so that every call appends (name, operands, outputs) to
    the returned list, each tensor as (shape, dtype). The wrappers stay
    in place for the life of the process (a captured frame is kept by the
    wrappers it was captured with)."""
    recorded = []

    def meta(a):
        return (tuple(a.shape), a.dtype) if isinstance(a, torch.Tensor) else a

    for name in kernels.LAUNCHES:
        fn = getattr(kernels, name)

        def wrapped(*args, _fn=fn, _name=name, **kw):
            out = _fn(*args, **kw)
            outs = out if isinstance(out, tuple) else (out,)
            recorded.append((_name, [meta(a) for a in (*args, *kw.values())],
                             [meta(o) for o in outs]))
            return out
        setattr(kernels, name, wrapped)
    return recorded


def breakdown(rec) -> dict:
    """The ten device operations with the most time, and the ten host
    activities under which the device idled longest, in seconds."""
    ops = collections.Counter()
    for name, s, e in rec["device"]:
        ops[name[:160]] += (e - s) / 1e6
    gaps = collections.Counter()
    for g0, g1 in idle_gaps(rec):
        mid = 0.5 * (g0 + g1)
        under = [h for h in rec["host"] if h[1] <= mid < h[2]]
        name = max(under, key=lambda h: h[1])[0] if under else "(no host op)"
        gaps[name[:160]] += (g1 - g0) / 1e6
    return {"device_ops": [[n, t] for n, t in ops.most_common(10)],
            "idle_gaps": [[n, t] for n, t in gaps.most_common(10)]}


def profile(step, calls: int):
    """`calls` calls of step() under torch.profiler, each inside a
    ``bench.call`` range (a call ends in a synchronize); returns the
    profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            with torch.profiler.record_function(CALL_RANGE):
                step()
    return prof


def roofline_share(rec, name: str | None = None):
    """Percent of the least time the card could take (arith.bound_s of
    each call's operations and bytes) over the device time its kernels
    took, summed over the slice's calls of logical kernel `name` (all of
    them for None); None where no such call ran or the kernels could not
    be told apart."""
    segments = kernel_segments(rec)
    bound = took = 0.0
    for c, ops in segments or ():
        if name is None or c["name"] == name:
            bound += arith.bound_s(c["flops"], c["bytes"])
            took += sum(e - s for _, s, e in ops) / 1e6
    return 100.0 * bound / took if took > 0 else None


def per_frame(rec, ops) -> tuple:
    """(operations a frame, device ms a frame) of `ops`."""
    return (len(ops) / rec["frames"],
            sum(e - s for _, s, e in ops) / 1e3 / rec["frames"])
