"""capture_s (s, program counter; layer: frame driver): what the program's
last frame capture took (filter/graph.py's last_capture_s: the warm-up
frames, the capture, the synchronize), a part of setup_s."""


def read(rec):
    return rec["capture_s"]
