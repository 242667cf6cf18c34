"""Build the CUDA kernels in ``csrc/`` at first use and bind them by ctypes.

The sources are compiled by nvcc into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/kernels/<hash>/libekf_kernels.so csrc/*.cu

The output directory is keyed by a hash of the sources and of the command,
under ``build/kernels/`` at the repository root (git-ignored). Build
errors propagate to the caller. nvcc is taken from ``$CUDA_HOME/bin``
(default ``/usr/local/cuda``) or the PATH.
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
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LIB_NAME = "libekf_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
SIGNATURES = {
    "ekf_k1_manage_predict_pht": [_P] * 10 + [_I] * 4 + [_P],
    "ekf_k2_update_tail_pht": [_P] * 7 + [_I] * 4 + [_P],
    "ekf_k3_update_tail_add": [_P] * 9 + [_I] * 4 + [_P],
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
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / LIB_NAME


def build() -> tuple[pathlib.Path, str]:
    """Compile the sources unless the library for them exists. Returns
    (library path, the compiler's output; empty when it was cached)."""
    lib = library_path()
    if lib.exists():
        return lib, ""
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".tmp{os.getpid()}")
    cu = [str(p) for p in _sources() if p.suffix == ".cu"]
    proc = subprocess.run([_nvcc(), *FLAGS, "-o", str(tmp), *cu],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    (lib.parent / "nvcc.log").write_text(proc.stdout + proc.stderr)
    return lib, proc.stdout + proc.stderr


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed, load the library and declare every signature."""
    lib = ctypes.CDLL(str(build()[0]))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
