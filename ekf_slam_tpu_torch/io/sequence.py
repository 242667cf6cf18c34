"""Image-sequence IO: the native C++ loader with a NumPy fallback.

Port of ``ekf_slam_tpu/io/sequence.py`` (without ``VideoSequence``, which
needs ffmpeg). The reference reads its monocular sequence with imread in
takeImage.m ('%s%04d.pgm', first channel). The runtime path is native:
``native/imageio.cpp`` (a threaded PGM/PPM batch loader with a C ABI,
bound by ctypes), compiled with g++ into
``build/native/<hash>/libimageio.so`` at the repository root (git-ignored;
the hash is of the source and the command). Where g++ or the build fails,
the pure-NumPy reader takes over; ``ImageSequence.native`` says which
loader a sequence uses. Frames come back as numpy float32 in [0, 1].
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import subprocess
import tempfile
from typing import Optional

import numpy as np

_ROOT = pathlib.Path(__file__).resolve().parents[2]
SRC_PATH = _ROOT / "native" / "imageio.cpp"
BUILD_DIR = _ROOT / "build" / "native"
_CMD = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]


def _so_path() -> pathlib.Path:
    key = hashlib.sha256(SRC_PATH.read_bytes() + " ".join(_CMD).encode())
    return BUILD_DIR / key.hexdigest()[:16] / "libimageio.so"


def build_native(force: bool = False) -> bool:
    """Compile native/imageio.cpp into build/native/ with g++ (written to a
    temporary name, then moved into place, so concurrent builds do not
    race). True on success or when already built."""
    so = _so_path()
    if so.exists() and not force:
        return True
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
    os.close(fd)
    try:
        subprocess.run(_CMD + [str(SRC_PATH), "-o", tmp], check=True,
                       capture_output=True)
        os.replace(tmp, so)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


@functools.cache
def _load_lib() -> Optional[ctypes.CDLL]:
    if not build_native():
        return None
    lib = ctypes.CDLL(str(_so_path()))
    lib.seq_open.restype = ctypes.c_void_p
    lib.seq_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                             ctypes.POINTER(ctypes.c_int),
                             ctypes.POINTER(ctypes.c_int)]
    lib.seq_len.restype = ctypes.c_int
    lib.seq_len.argtypes = [ctypes.c_void_p]
    lib.seq_load_batch.restype = ctypes.c_int
    lib.seq_load_batch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_int,
                                   ctypes.POINTER(ctypes.c_float)]
    lib.seq_close.argtypes = [ctypes.c_void_p]
    lib.load_pnm_gray.restype = ctypes.c_int
    lib.load_pnm_gray.argtypes = [ctypes.c_char_p,
                                  ctypes.POINTER(ctypes.c_float),
                                  ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_int),
                                  ctypes.POINTER(ctypes.c_int)]
    return lib


def native_available() -> bool:
    return _load_lib() is not None


def write_pgm(path: str, arr: np.ndarray, binary: bool = True,
              maxval: int = 255) -> None:
    """Write a grayscale uint8 (H, W) array as P5 (binary) or P2 (ASCII)
    PGM — the inverse of takeImage.m's imread."""
    h, w = arr.shape
    if binary:
        with open(path, "wb") as f:
            f.write(f"P5\n{w} {h}\n{maxval}\n".encode())
            f.write(arr.astype(np.uint8).tobytes())
    else:
        with open(path, "w") as f:
            f.write(f"P2\n{w} {h}\n{maxval}\n")
            f.write(" ".join(str(int(v)) for v in arr.ravel()))


def write_ppm(path: str, arr_rgb: np.ndarray) -> None:
    """Write an RGB uint8 (H, W, 3) array as binary P6 PPM."""
    h, w, _ = arr_rgb.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(arr_rgb.astype(np.uint8).tobytes())


def load_pgm_numpy(path: str) -> np.ndarray:
    """The NumPy reader: P2 / P5 PGM and P3 / P6 PPM with '#' comments in
    the header, first channel, float32 in [0, 1]."""
    with open(path, "rb") as f:
        data = f.read()
    tokens = []
    i = 0
    while len(tokens) < 4:
        while i < len(data) and data[i:i + 1].isspace():
            i += 1
        if data[i:i + 1] == b"#":
            while i < len(data) and data[i] != 0x0A:
                i += 1
            continue
        j = i
        while j < len(data) and not data[j:j + 1].isspace():
            j += 1
        tokens.append(data[i:j])
        i = j
    magic = tokens[0].decode()
    w, h, maxv = int(tokens[1]), int(tokens[2]), int(tokens[3])
    ch = 3 if magic in ("P3", "P6") else 1
    if magic in ("P5", "P6"):
        i += 1                     # the single whitespace after maxval
        dt = np.uint8 if maxv < 256 else ">u2"
        arr = np.frombuffer(data, dt, count=w * h * ch, offset=i)
    elif magic in ("P2", "P3"):
        arr = np.array(data[i:].split()[: w * h * ch], dtype=np.int32)
    else:
        raise ValueError(f"unsupported PNM magic {magic!r} in {path}")
    return arr.reshape(h, w, ch)[:, :, 0].astype(np.float32) / maxv


def load_pgm(path: str) -> np.ndarray:
    """One grayscale image in [0, 1] (takeImage.m), by the native loader
    where it builds, else by the NumPy reader."""
    lib = _load_lib()
    if lib is None:
        return load_pgm_numpy(path)
    max_elems = 16_000_000
    out = np.empty(max_elems, np.float32)
    h, w = ctypes.c_int(), ctypes.c_int()
    ok = lib.load_pnm_gray(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_elems, ctypes.byref(h), ctypes.byref(w))
    if not ok:
        raise IOError(f"failed to load {path}")
    return out[: h.value * w.value].reshape(h.value, w.value).copy()


class ImageSequence:
    """printf-pattern frame sequence, loaded in batches by the native
    threaded loader (``native`` True) or frame by frame by the NumPy
    reader (``native`` False).

    >>> seq = ImageSequence("/data/seq/%06d.pgm", start=0, count=100)
    >>> batch = seq.load(0, 8)   # (8, H, W) float32 in [0, 1]
    """

    def __init__(self, pattern: str, start: int, count: int):
        self.pattern = pattern
        self.start = start
        self.count = count
        self._handle = None
        lib = _load_lib()
        if lib is not None:
            h, w = ctypes.c_int(), ctypes.c_int()
            handle = lib.seq_open(pattern.encode(), start, count,
                                  ctypes.byref(h), ctypes.byref(w))
            if handle:
                self._handle = handle
                self.height, self.width = h.value, w.value
                return
        first = load_pgm_numpy(pattern % start)
        self.height, self.width = first.shape

    @property
    def native(self) -> bool:
        return self._handle is not None

    def __len__(self):
        return self.count

    def load(self, first: int, n: int) -> np.ndarray:
        """Frames [first, first + n) as (n, H, W) float32."""
        if self._handle is not None:
            out = np.empty((n, self.height, self.width), np.float32)
            got = _load_lib().seq_load_batch(
                self._handle, first, n,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            if got != n:
                raise IOError(f"loaded {got}/{n} frames from {self.pattern}")
            return out
        return np.stack([load_pgm_numpy(self.pattern % (self.start + first
                                                        + i))
                         for i in range(n)])

    def close(self):
        if self._handle is not None:
            _load_lib().seq_close(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
