"""Video-file frame input — the `takeImageFromAvi.m` analog.

Port of ``ekf_slam_tpu/io/video.py`` (numpy and subprocess only). The
reference's AVI path (takeImageFromAvi.m:1-5) reads a frame, converts to
grayscale and half-sizes it. Decoding containers needs a codec stack; like
the MP4 export (viz/animation.py:save_video) this rides ffmpeg / ffprobe
when they are on PATH and raises RuntimeError, with the JAX package's
message, when not. The decode and stream logic is tested through command
shims (tests/test_torch_io.py).
"""

from __future__ import annotations

import json
import shutil
import subprocess
from typing import Optional, Tuple

import numpy as np


def ffmpeg_available() -> bool:
    return (shutil.which("ffmpeg") is not None
            and shutil.which("ffprobe") is not None)


def probe_video(path: str) -> Tuple[int, int, int]:
    """(width, height, n_frames) of the first video stream via ffprobe."""
    out = subprocess.run(
        ["ffprobe", "-v", "error", "-select_streams", "v:0",
         "-show_entries", "stream=width,height,nb_frames",
         "-of", "json", path],
        check=True, capture_output=True, text=True).stdout
    st = json.loads(out)["streams"][0]
    return int(st["width"]), int(st["height"]), int(st.get("nb_frames", 0))


class VideoSequence:
    """Frame reader over a video file (AVI/MP4/...), mirroring
    takeImageFromAvi.m: grayscale + optional half-size.

    Decodes the whole stream once through an ffmpeg rawvideo pipe and
    indexes frames from memory (the reference's aviread loads the AVI
    up-front too). Raises RuntimeError when ffmpeg is absent.
    """

    def __init__(self, path: str, half_size: bool = True):
        if not ffmpeg_available():
            raise RuntimeError(
                "VideoSequence needs ffmpeg+ffprobe on PATH (none baked "
                "into this environment); use ImageSequence over PGM/PPM "
                "frames instead")
        w, h, _ = probe_video(path)
        self.width = w // 2 if half_size else w
        self.height = h // 2 if half_size else h
        vf = ["-vf", f"scale={self.width}:{self.height}"] \
            if half_size else []
        raw = subprocess.run(
            ["ffmpeg", "-v", "error", "-i", path, *vf,
             "-f", "rawvideo", "-pix_fmt", "gray", "-"],
            check=True, capture_output=True).stdout
        n = len(raw) // (self.width * self.height)
        self.frames = np.frombuffer(
            raw[:n * self.width * self.height],
            dtype=np.uint8).reshape(n, self.height, self.width)

    def __len__(self) -> int:
        return self.frames.shape[0]

    def __getitem__(self, i: int) -> np.ndarray:
        """Grayscale frame (H, W) float32 in [0, 1] (takeImage contract)."""
        return self.frames[i].astype(np.float32) / 255.0


def load_video_frames(path: str, half_size: bool = True,
                      count: Optional[int] = None) -> np.ndarray:
    """(N, H, W) float32 stack of the first `count` frames."""
    seq = VideoSequence(path, half_size=half_size)
    n = len(seq) if count is None else min(count, len(seq))
    return np.stack([seq[i] for i in range(n)])
