"""Build the CUDA kernels in ``csrc/`` at first use and bind them by ctypes.

Each source is compiled by its own nvcc, all started together, and the
objects are linked into one shared library with a plain C interface (no
PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas -v -c -o <name>.o csrc/<name>.cu   (each)
    nvcc -shared -o build/kernels/<hash>/libekf_kernels.so *.o

The output directory is keyed by a hash of the sources (headers included)
and of the commands, under ``build/kernels/`` at the repository root
(git-ignored). Build errors propagate to the caller. nvcc is taken from
``$CUDA_HOME/bin`` (default ``/usr/local/cuda``) or the PATH.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LINK_FLAGS = ["-shared"]
LIB_NAME = "libekf_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
SIGNATURES = {
    "ekf_k1_manage_predict_pht": [_P] * 11 + [_I] * 4 + [_P],
    "ekf_k2_update_tail_pht": [_P] * 7 + [_I] * 4 + [_P],
    "ekf_k3_update_tail_add": [_P] * 10 + [_I] * 4 + [_P],
    "ekf_k4_corr_apply_cols": [_P] * 4 + [_I] * 4 + [_P],
    "ekf_k5_update_tail": [_P] * 5 + [_I] * 3 + [_P],
    "ekf_k6_matmul_big": [_P] * 3 + [_I] * 5 + [_P],
    "ekf_k7_ncc_corr": [_P] * 3 + [_I] * 3 + [_P],
    "ekf_k7_ncc_corr_norms": [_P] * 5 + [_I] * 3 + [_P],
    "ekf_k8_corr_apply": [_P] * 4 + [_I] * 5 + [_P],
    "ekf_k8_corr_apply_rows": [_P] * 4 + [_I] * 6 + [_P],
    "ekf_eight_point_fit": [_P] * 3 + [_I] + [_P],
    "ekf_span_mark": [_I, _I, _P],
}


def _nvcc() -> str:
    home = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    cand = home / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(f"nvcc not found in {home / 'bin'} or on PATH")
    return found


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def library_path() -> pathlib.Path:
    """Where the library for the current sources lives."""
    h = hashlib.sha256(" ".join(FLAGS + LINK_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / LIB_NAME


def build() -> tuple[pathlib.Path, str]:
    """Compile the sources unless the library for them exists: one nvcc
    per source, run in parallel, then one link. Returns (library path,
    the compiler's output; empty when it was cached)."""
    lib = library_path()
    if lib.exists():
        return lib, ""
    lib.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"tmp{os.getpid()}"
    cu = [p for p in _sources() if p.suffix == ".cu"]
    objs = [lib.parent / f"{p.stem}.{tag}.o" for p in cu]
    procs = [subprocess.Popen([nvcc, *FLAGS, "-c", "-o", str(o), str(p)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for p, o in zip(cu, objs)]
    logs = [proc.communicate()[0] for proc in procs]
    log = "".join(f"== {p.name}\n{out}" for p, out in zip(cu, logs))
    failed = [p.name for p, proc in zip(cu, procs) if proc.returncode != 0]
    if failed:
        raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{log}")
    tmp = lib.with_suffix(f".{tag}")
    proc = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(tmp),
                           *map(str, objs)], capture_output=True, text=True)
    log += proc.stdout + proc.stderr
    for o in objs:
        o.unlink()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{log}")
    os.replace(tmp, lib)
    (lib.parent / "nvcc.log").write_text(log)
    return lib, log


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed, load the library and declare every signature."""
    lib = ctypes.CDLL(str(build()[0]))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
