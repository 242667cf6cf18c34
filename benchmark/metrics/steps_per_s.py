"""steps_per_s (steps/s, host clock): instance-frames completed in the
window over the window's seconds, every call of it counted whole."""


def read(rec):
    calls = rec["calls"]
    seconds = calls[-1][2] - calls[0][0]
    steps = len(calls) * rec["instances"] * rec["frames_per_call"]
    return steps / seconds
