"""setup_s (s, host clock): from the process's start to the first timed
call: imports, the inputs, the program's initial state, the kernels'
build or load, the capture and the warm-up calls."""


def read(rec):
    return rec["setup_s"]
