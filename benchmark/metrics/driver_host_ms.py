"""driver_host_ms (ms, host clock; layer: frame driver): the mean over the
window's calls of the host time from a call to the timed entry's return,
before the synchronize: the driver's Python, the carry's load and clone,
the replay's launch."""


def read(rec):
    calls = rec["calls"]
    return sum(ret - t0 for t0, ret, _ in calls) * 1e3 / len(calls)
