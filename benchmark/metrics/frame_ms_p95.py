"""frame_ms_p95 (ms, host clock): the 95th percentile over the window's
frames of a frame's latency, from its call to its pose on the host (the
call's end: a synchronize and the camera block's copy to the host)."""

import numpy as np


def read(rec):
    lat = [(end - t0) * 1e3 for t0, _, end in rec["calls"]]
    return float(np.percentile(np.repeat(lat, rec["frames_per_call"]), 95))
