"""driver_device_ms_per_frame (ms, program span; layer: frame driver):
device time a frame of the operations outside every ``frame`` span of the
program (metrics/span.py): each frame's copies of its inputs into the
static buffers and its outputs' clones, each call's load of the carry,
the stacking of the outputs and the final carry's clones, and the
benchmark's copy of the camera block to the host; the union of their
intervals, the marks left out, over the traced slice's frames. Nothing
where metrics/span.py finds no frames."""

from benchmark.harness import trace
from benchmark.metrics import span


def read(rec):
    spans = span.table()
    found = None if spans is None else span.frames(rec, spans)
    if not found:
        return None
    frame_id = spans.index("frame")
    inside = set()
    for f in found:
        b, e = f[frame_id]
        inside.update(range(b, e + 1))
    outside = [(s, e) for i, (name, s, e) in enumerate(rec["device"])
               if i not in inside and span.parse_mark(name) is None]
    busy = sum(e - s for s, e in trace.merged(outside))
    return busy / 1e3 / len(found)
