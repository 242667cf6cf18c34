"""A worker process of the reference: reads a pickled list of
(function, arguments) from standard input, calls each, and writes the
pickled list of results to standard output. It imports NumPy and the
reference only; the harness starts one a CPU core, hands each its share of
the frames, and waits for each to end (``harness/verdict.py``)."""

import pickle
import sys

if __name__ == "__main__":
    tasks = pickle.load(sys.stdin.buffer)
    pickle.dump([fn(*args) for fn, args in tasks], sys.stdout.buffer)
