"""Sequence animation export — the fig2avi.m analog (frames -> results video).

The reference stitches saved MATLAB .fig frames into results.avi
(fig2avi.m:1-17). Here frames render to arrays and export as animated GIF
via PIL, or as MP4/AVI through ffmpeg when it is installed (save_video —
raw RGB piped to the encoder, no Python codec dependency).

The PyTorch port's copy of ``ekf_slam_tpu/viz/animation.py`` (numpy, PIL
and matplotlib, imported where they draw).
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import numpy as np


def _to_pil(frame: np.ndarray):
    from PIL import Image
    a = np.asarray(frame)
    if a.dtype != np.uint8:
        a = (np.clip(a, 0.0, 1.0) * 255).astype(np.uint8)
    if a.ndim == 2:
        a = np.stack([a] * 3, axis=-1)
    return Image.fromarray(a)


def save_animation(path: str, frames: Iterable[np.ndarray],
                   fps: float = 10.0) -> int:
    """Write frames ((H,W) gray or (H,W,3) RGB, [0,1] float or uint8) to an
    animated GIF. Returns the frame count."""
    imgs = [_to_pil(f) for f in frames]
    assert imgs, "no frames"
    imgs[0].save(path, save_all=True, append_images=imgs[1:],
                 duration=int(1000 / fps), loop=0)
    return len(imgs)


def _to_rgb_u8(frame: np.ndarray) -> np.ndarray:
    a = np.asarray(frame)
    if a.dtype != np.uint8:
        a = (np.clip(a, 0.0, 1.0) * 255).astype(np.uint8)
    if a.ndim == 2:
        a = np.stack([a] * 3, axis=-1)
    return a


def save_video(path: str, frames: Iterable[np.ndarray],
               fps: float = 10.0) -> int:
    """Write frames to MP4/AVI via ffmpeg (fig2avi.m:1-17 analog): raw RGB
    piped to `ffmpeg -f rawvideo`. Falls back to save_animation on a .gif
    sibling path when ffmpeg is absent; returns the frame count."""
    import shutil
    import subprocess

    if shutil.which("ffmpeg") is None:
        gif = path.rsplit(".", 1)[0] + ".gif"
        return save_animation(gif, frames)
    frames = [_to_rgb_u8(f) for f in frames]
    assert frames, "no frames"
    h, w = frames[0].shape[:2]
    # yuv420p (the broadly-playable pixel format) needs even dimensions.
    h2, w2 = h - h % 2, w - w % 2
    proc = subprocess.Popen(
        ["ffmpeg", "-y", "-loglevel", "error", "-f", "rawvideo",
         "-pix_fmt", "rgb24", "-s", f"{w2}x{h2}", "-r", str(fps), "-i", "-",
         "-pix_fmt", "yuv420p", path],
        stdin=subprocess.PIPE)
    for f in frames:
        proc.stdin.write(f[:h2, :w2].tobytes())
    proc.stdin.close()
    assert proc.wait() == 0, "ffmpeg failed"
    return len(frames)


def render_overlay_frames(images, h_pred, S, visible, ic, li, hi,
                          render_fn: Optional[Callable] = None):
    """Yield plots.m-style overlay frames as RGB arrays (for
    save_animation). Inputs carry a leading time axis."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ekf_slam_tpu_torch.viz.plots import plot_frame

    T = len(images)
    for t in range(T):
        fig, ax = plt.subplots(figsize=(5, 4))
        plot_frame(ax, images[t], h_pred[t], S[t], visible[t], ic[t],
                   li[t], hi[t])
        fig.canvas.draw()
        buf = np.asarray(fig.canvas.buffer_rgba())[:, :, :3]
        plt.close(fig)
        yield buf
