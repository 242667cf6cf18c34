"""The port's file IO (ekf_slam_tpu_torch/io) against the JAX package's
(ekf_slam_tpu/io), as tests/test_io.py exercises it.

(a) PGM / PPM readers on the same files — binary P5, ASCII P2, a P5 with a
header comment, binary P6 (first channel), maxval 255 and 1023 — read bit
for bit as JAX reads them: the port's NumPy reader as JAX's NumPy reader,
the port's native loader as JAX's native loader (JAX's built from the same
native/imageio.cpp into a temporary directory, so nothing is written to
native/). Both are also held to the file's values v / maxval (the native
loader multiplies by 1/maxval: within one f32 ulp).
(b) The port builds its native loader into build/native/, never into
native/; ImageSequence says which loader it took.
(c) KITTI poses: load, poses_to_rq and save_trajectory_kitti against JAX's
to 1e-12 (the saved files' values to their 10 printed digits), and
load_loops on the same file.
(d) Video input through shell shims of ffmpeg / ffprobe: io.video's
VideoSequence and load_video_frames, io.sequence's VideoSequence, the
same frames as JAX's readers; without ffmpeg each raises RuntimeError
with the JAX package's message."""

import pathlib

import numpy as np
import pytest

from ekf_slam_tpu.io import poses as jposes
from ekf_slam_tpu.io import sequence as jseq

from ekf_slam_tpu_torch.io import poses, sequence
from ekf_slam_tpu_torch.io import ImageSequence


def _write_commented(path, arr, maxval=255):
    h, w = arr.shape
    with open(path, "wb") as f:
        f.write(f"P5\n# a comment\n{w} {h}\n{maxval}\n".encode())
        f.write(arr.astype(np.uint8).tobytes())


def _write_p5_16bit(path, arr, maxval=1023):
    h, w = arr.shape
    with open(path, "wb") as f:
        f.write(f"P5\n{w} {h}\n{maxval}\n".encode())
        f.write(arr.astype(">u2").tobytes())


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """{name: (path, expected float64 image)} over every format."""
    d = tmp_path_factory.mktemp("pnm")
    rng = np.random.default_rng(0)
    g = rng.integers(0, 256, (24, 32), dtype=np.uint8)
    rgb = rng.integers(0, 256, (6, 8, 3), dtype=np.uint8)
    wide = rng.integers(0, 1024, (5, 7)).astype(np.uint16)
    out = {}
    sequence.write_pgm(str(d / "p5.pgm"), g)
    out["p5"] = (d / "p5.pgm", g / 255.0)
    sequence.write_pgm(str(d / "p2.pgm"), g[:6, :9], binary=False)
    out["p2"] = (d / "p2.pgm", g[:6, :9] / 255.0)
    _write_commented(str(d / "comment.pgm"), g)
    out["comment"] = (d / "comment.pgm", g / 255.0)
    sequence.write_ppm(str(d / "p6.ppm"), rgb)
    out["p6"] = (d / "p6.ppm", rgb[:, :, 0] / 255.0)
    _write_p5_16bit(str(d / "p5_16.pgm"), wide)
    out["p5_16bit"] = (d / "p5_16.pgm", wide / 1023.0)
    return out


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """JAX's native loader, built by its own build_native from the same
    source into a temporary directory; restored after."""
    so = tmp_path_factory.mktemp("jax_native") / "libimageio.so"
    old = jseq._SO_PATH, jseq._lib
    jseq._SO_PATH, jseq._lib = str(so), None
    if not jseq.build_native():
        jseq._SO_PATH, jseq._lib = old
        pytest.skip("g++ unavailable")
    yield jseq.load_pgm
    jseq._SO_PATH, jseq._lib = old


FORMATS = ["p5", "p2", "comment", "p6", "p5_16bit"]


@pytest.mark.parametrize("fmt", FORMATS)
def test_numpy_reader_is_jaxs(files, fmt):
    path, want = files[fmt]
    got = sequence.load_pgm_numpy(str(path))
    ref = jseq._load_pgm_numpy(str(path))
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, want.astype(np.float32))


@pytest.mark.parametrize("fmt", FORMATS)
def test_native_loader_is_jaxs(files, jax_native, fmt):
    path, want = files[fmt]
    assert sequence.native_available()
    got = sequence.load_pgm(str(path))
    np.testing.assert_array_equal(got, jax_native(str(path)))
    np.testing.assert_allclose(got, want, rtol=2 ** -23, atol=0)


def test_native_build_lands_in_build_not_native(monkeypatch, tmp_path):
    """build_native compiles native/imageio.cpp into build/native/<hash>/,
    and a forced rebuild writes nothing under native/."""
    so = sequence._so_path()
    assert so.parent.parent == sequence.BUILD_DIR
    assert sequence.BUILD_DIR.parts[-2:] == ("build", "native")
    assert sequence.SRC_PATH.parent.name == "native"
    commands = []
    run = sequence.subprocess.run
    monkeypatch.setattr(sequence.subprocess, "run",
                        lambda cmd, **kw: (commands.append(cmd),
                                           run(cmd, **kw))[1])
    assert sequence.build_native(force=True)
    (cmd,) = commands
    target = cmd[cmd.index("-o") + 1]
    assert sequence.SRC_PATH.parent not in pathlib.Path(target).parents
    assert so.exists()


def test_image_sequence_both_loaders(files, tmp_path, monkeypatch):
    """ImageSequence on a %04d pattern: the native batch loader, and the
    NumPy reader where the native one does not build; both report which
    they took and read the same frames."""
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 256, (5, 24, 32), dtype=np.uint8)
    for i, fr in enumerate(frames):
        sequence.write_pgm(str(tmp_path / f"{i:04d}.pgm"), fr)
    pattern = str(tmp_path / "%04d.pgm")
    seq = ImageSequence(pattern, start=0, count=5)
    assert seq.native and (seq.height, seq.width) == (24, 32)
    native = seq.load(1, 3)
    seq.close()
    monkeypatch.setattr(sequence, "_load_lib", lambda: None)
    seq = ImageSequence(pattern, start=0, count=5)
    assert not seq.native
    plain = seq.load(1, 3)
    assert native.shape == plain.shape == (3, 24, 32)
    np.testing.assert_allclose(native, plain, rtol=2 ** -23, atol=0)
    np.testing.assert_array_equal(
        plain, np.stack([jseq._load_pgm_numpy(pattern % i)
                         for i in (1, 2, 3)]))


def _random_poses(T, seed):
    rng = np.random.default_rng(seed)
    qs, _ = np.linalg.qr(rng.normal(size=(T, 3, 3)))
    qs = qs * np.linalg.det(qs)[:, None, None]
    return np.concatenate([qs, rng.normal(size=(T, 3, 1))], axis=2)


def test_kitti_poses_match_jax(tmp_path):
    poses_in = _random_poses(16, 2)
    p = str(tmp_path / "poses.txt")
    np.savetxt(p, poses_in.reshape(-1, 12))
    back = poses.load_kitti_poses(p)
    np.testing.assert_array_equal(back, jposes.load_kitti_poses(p))
    rq = poses.poses_to_rq(back)
    np.testing.assert_allclose(rq, jposes.poses_to_rq(back), rtol=0,
                               atol=1e-12)
    assert (rq[:, 3] >= 0).all()
    ours, theirs = str(tmp_path / "ours.txt"), str(tmp_path / "jax.txt")
    poses.save_trajectory_kitti(ours, rq)
    jposes.save_trajectory_kitti(theirs, rq)
    np.testing.assert_allclose(np.loadtxt(ours), np.loadtxt(theirs),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(poses.load_kitti_poses(ours), poses_in,
                               rtol=0, atol=1e-8)
    one = str(tmp_path / "one.txt")
    np.savetxt(one, poses_in[:1].reshape(1, 12))
    assert poses.load_kitti_poses(one).shape == (1, 3, 4)


def test_poses_to_rq_every_branch():
    """r2q's four branches (the largest of w², x², y², z²), against JAX."""
    angles = [(0.1, (0, 0, 1)), (3.0, (1, 0, 0)), (3.0, (0, 1, 0)),
              (3.0, (0, 0, 1)), (np.pi, (1, 1, 0))]
    Rs = []
    for a, axis in angles:
        k = np.asarray(axis, float) / np.linalg.norm(axis)
        K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        Rs.append(np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K @ K)
    p = np.concatenate([np.stack(Rs), np.zeros((len(Rs), 3, 1))], axis=2)
    np.testing.assert_allclose(poses.poses_to_rq(p), jposes.poses_to_rq(p),
                               rtol=0, atol=1e-12)


def test_load_loops_matches_jax(tmp_path):
    rows = np.random.default_rng(3).normal(size=(3, 16))
    rows[:, :2] = [[9, 1], [12, 2], [15, 3]]
    p = str(tmp_path / "loops.txt")
    np.savetxt(p, rows)
    for a, b in zip(poses.load_loops(p), jposes.load_loops(p)):
        np.testing.assert_array_equal(a, b)
    empty = str(tmp_path / "empty.txt")
    open(empty, "w").close()
    i, j, pi, pj = poses.load_loops(empty)
    assert i.size == j.size == 0 and pi.shape == pj.shape == (0, 7)


def _video_shims(tmp_path, monkeypatch):
    """Fake ffmpeg / ffprobe on PATH (no codec stack is assumed): ffmpeg
    pipes 3 gray 8x6 frames as rawvideo; ffprobe reports a 16x12 stream,
    as JSON (io.video) or as csv (io.sequence)."""
    import os
    import stat
    frames = np.stack([np.full((6, 8), v, np.uint8) for v in (0, 128, 255)])
    raw = tmp_path / "raw.bin"
    raw.write_bytes(frames.tobytes())
    ffprobe = tmp_path / "ffprobe"
    ffprobe.write_text(
        "#!/bin/sh\n"
        'case "$*" in\n'
        "  *csv*) echo '8,6' ;;\n"
        "  *) echo '{\"streams\": [{\"width\": 16, \"height\": 12, "
        "\"nb_frames\": 3}]}' ;;\n"
        "esac\n")
    ffmpeg = tmp_path / "ffmpeg"
    ffmpeg.write_text(f"#!/bin/sh\ncat {raw}\n")
    for f in (ffprobe, ffmpeg):
        os.chmod(f, os.stat(f).st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{tmp_path}:{os.environ['PATH']}")


def test_video_sequence_via_ffmpeg_shims(tmp_path, monkeypatch):
    """tests/test_io.py:102-132 on the port's io.video: the frames come
    back half-sized, scaled to [0, 1] and in order, as JAX's do."""
    from ekf_slam_tpu.io import video as jvideo
    from ekf_slam_tpu_torch.io import video
    _video_shims(tmp_path, monkeypatch)
    assert video.ffmpeg_available()
    assert video.probe_video("fake.avi") == (16, 12, 3)
    seq = video.VideoSequence("fake.avi", half_size=True)
    assert (seq.width, seq.height) == (8, 6)
    assert len(seq) == 3
    np.testing.assert_allclose(seq[1], np.full((6, 8), 128 / 255.0),
                               atol=1e-6)
    stack = video.load_video_frames("fake.avi", count=2)
    assert stack.shape == (2, 6, 8) and stack.dtype == np.float32
    np.testing.assert_array_equal(
        stack, jvideo.load_video_frames("fake.avi", count=2))
    assert stack[0].max() == 0.0 and abs(stack[1].max() - 128 / 255) < 1e-6


def test_sequence_video_sequence_via_ffmpeg_shims(tmp_path, monkeypatch):
    """io.sequence.VideoSequence (tests/test_utils_viz.py:140-170's
    reader): load(first, n) as JAX's, out-of-range windows raise."""
    _video_shims(tmp_path, monkeypatch)
    seq = sequence.VideoSequence("fake.mp4")
    want = jseq.VideoSequence("fake.mp4")
    assert (seq.height, seq.width, len(seq)) == (6, 8, 3)
    np.testing.assert_array_equal(seq.load(1, 2), want.load(1, 2))
    assert seq.load(0, 3).shape == (3, 6, 8)
    assert abs(float(seq.load(2, 1).max()) - 1.0) < 1e-6
    with pytest.raises(IndexError):
        seq.load(2, 2)


@pytest.mark.parametrize("which", ["video", "sequence"])
def test_video_sequence_clear_error_without_ffmpeg(monkeypatch, which):
    """Without ffmpeg / ffprobe each reader raises RuntimeError with the
    JAX package's message."""
    from ekf_slam_tpu.io import video as jvideo
    from ekf_slam_tpu_torch.io import video
    monkeypatch.setenv("PATH", "/nonexistent")
    port, jax_ = {"video": (video.VideoSequence, jvideo.VideoSequence),
                  "sequence": (sequence.VideoSequence,
                               jseq.VideoSequence)}[which]
    with pytest.raises(RuntimeError, match="ffmpeg") as got:
        port("x.avi")
    with pytest.raises(RuntimeError) as want:
        jax_("x.avi")
    assert str(got.value) == str(want.value)
    assert not video.ffmpeg_available()
