"""<span>_span (ms, program span; layer: frame): device time a frame of
the program's span <span> (a name of ekf_slam_tpu_torch/utils/metrics.py's
SPANS, its dots written as underscores): the union of the device
operations between the span's begin and end marks, the marks left out,
summed over the traced slice's frames. The marks are the empty kernels
``span_mark<id, end>`` (csrc/spans.cu) that the program launches, and
captures into its replayed frame, at each span's begin (end 0) and end
(end 1); id is the name's place in SPANS. A frame is a ``frame`` span.

Nothing unless the slice shows as many frames as it ran, each frame's
spans once each, in the table's order and nested, and the span in every
frame; nothing from a program without the table."""

from __future__ import annotations

import re

from benchmark.harness import trace

SUFFIX = "_span"
MARK = re.compile(r"\bspan_mark<(\d+), (\d+)>")


def parse_mark(name: str):
    """(id, end) of a device operation that is a span mark, else None."""
    m = MARK.search(name)
    return None if m is None else (int(m.group(1)), int(m.group(2)))


def table():
    """The program's span names in id order; None where it has none."""
    try:
        from ekf_slam_tpu_torch.utils.metrics import SPANS
    except ImportError:
        return None
    return SPANS


def _well_formed(marks) -> bool:
    """The marks of one frame, [(id, end)], nest, each span once, begins in
    id order."""
    stack, begun = [], []
    for sid, end in marks:
        if end == 0:
            if begun and sid <= begun[-1]:
                return False
            begun.append(sid)
            stack.append(sid)
        elif not stack or stack.pop() != sid:
            return False
    return not stack


def frames(rec, spans):
    """The slice's frames, each {span id: (index of its begin mark, index
    of its end mark)} into rec["device"], in trace order; None where the
    marks do not make rec["frames"] well-formed frames."""
    frame_id = spans.index("frame")
    out, cur, marks = [], None, []
    for i, (name, _, _) in enumerate(rec["device"]):
        mark = parse_mark(name)
        if mark is None:
            continue
        sid, end = mark
        if cur is None:
            if (sid, end) != (frame_id, 0):
                continue                    # a mark outside every frame
            cur, marks = {}, []
        marks.append(mark)
        if end == 0:
            cur[sid] = (i, None)
        elif sid in cur:
            cur[sid] = (cur[sid][0], i)
        if (sid, end) == (frame_id, 1):
            if not _well_formed(marks):
                return None
            out.append(cur)
            cur = None
    if cur is not None or len(out) != rec["frames"]:
        return None
    return out


def between_us(rec, begin: int, end: int) -> float:
    """µs of the union of the device operations between indices begin and
    end of rec["device"], marks left out."""
    ops = rec["device"][begin + 1:end]
    return sum(e - s for s, e in trace.merged(
        (s, e) for name, s, e in ops if parse_mark(name) is None))


def read(rec, name):
    spans = table()
    if spans is None:
        return None
    wanted = name[:-len(SUFFIX)]
    sid = next((i for i, s in enumerate(spans)
                if s.replace(".", "_") == wanted), None)
    found = None if sid is None else frames(rec, spans)
    if not found or any(sid not in f for f in found):
        return None
    return sum(between_us(rec, *f[sid]) for f in found) / 1e3 / len(found)
