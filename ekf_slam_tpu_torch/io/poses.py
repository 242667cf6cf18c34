"""Pose-file IO (KITTI odometry format).

Port of ``ekf_slam_tpu/io/poses.py``. The reference's online loop runner
reads visual-odometry poses from a text file of 12-float rows (row-major
3x4 [R|t]) and uses them for its constraints
("CALC 2.0"/close_kitti_loops.py:78-86):

* ``load_kitti_poses(path)`` -> (T, 3, 4) float64
* ``poses_to_rq(poses)``     -> (T, 7) [r(3), q(4)] for the loop database
* ``load_loops(path)``       -> the rows of a close_loops ``kitti_loops.txt``
* ``save_trajectory_kitti(path, traj)`` — the kitti_traj.txt analog.

Arrays are numpy float64; the rotations go through the port's quaternion
ops at f64 on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ekf_slam_tpu_torch.ops import quaternion as quat


def load_kitti_poses(path: str) -> np.ndarray:
    data = np.loadtxt(path, dtype=np.float64)
    if data.ndim == 1:
        data = data[None]
    if data.shape[1] != 12:
        raise ValueError(f"{path}: expected 12 columns, got {data.shape[1]}")
    return data.reshape(-1, 3, 4)


def poses_to_rq(poses: np.ndarray) -> np.ndarray:
    """(T, 3, 4) [R|t] -> (T, 7) [t, q], q = [w, x, y, z] with w >= 0."""
    q = quat.r2q(torch.from_numpy(np.ascontiguousarray(
        poses[:, :, 0:3], dtype=np.float64))).numpy()
    return np.concatenate([poses[:, :, 3], q], axis=1)


def load_loops(path: str):
    """Parse a close_loops ``kitti_loops.txt`` into ((L,) i, (L,) j,
    (L, 7) pose_i, (L, 7) pose_j). Both full [r, q] poses are stored, so
    each row can drive ``filter/loop_fusion.apply_loop_constraint_pose``.
    An empty file gives empty arrays."""
    if not np.fromfile(path, dtype=np.uint8).size:
        z = np.zeros(0)
        return (z.astype(int), z.astype(int), z.reshape(0, 7),
                z.reshape(0, 7))
    rows = np.loadtxt(path, dtype=np.float64)
    if rows.ndim == 1:
        rows = rows[None]
    if rows.shape[1] != 16:
        raise ValueError(f"{path}: expected 16 columns, got {rows.shape[1]}")
    return (rows[:, 0].astype(int), rows[:, 1].astype(int),
            rows[:, 2:9], rows[:, 9:16])


def save_trajectory_kitti(path: str, traj_rq: np.ndarray) -> None:
    """(T, >=7) [r(3) q(4) ...] -> KITTI 12-float rows."""
    traj_rq = np.asarray(traj_rq, dtype=np.float64)
    R = quat.q2r(torch.from_numpy(np.ascontiguousarray(traj_rq[:, 3:7])))
    rows = np.concatenate([R.numpy().reshape(-1, 3, 3),
                           traj_rq[:, 0:3, None]], axis=2)
    np.savetxt(path, rows.reshape(-1, 12), fmt="%.9e")
