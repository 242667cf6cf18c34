"""Trajectory dumps and state checkpoints.

Port of ``ekf_slam_tpu/utils/checkpoint.py``: ``dump_trajectory`` /
``load_trajectory`` write and read the same numpy ``.npz`` files, and the
JAX package's orbax ``save_pytree`` / ``restore_pytree`` become
``torch.save`` / ``torch.load`` of a state dict — a mapping of names to
tensors, or a dataclass of tensors (FilterState, Appearance,
LoopDatabase), stored as its fields.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

INFO_FIELDS = ("n_visible", "n_ic", "n_li", "n_hi", "ransac_support")


def _numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def save_pytree(path: str, tree: Any) -> None:
    """torch.save of a mapping of tensors, or of a dataclass's fields."""
    if dataclasses.is_dataclass(tree):
        tree = {f.name: getattr(tree, f.name)
                for f in dataclasses.fields(tree)}
    torch.save(dict(tree), path)


def restore_pytree(path: str, template: Any = None, map_location=None):
    """What save_pytree wrote: the dict of tensors, or, given a dataclass
    `template`, that dataclass with the stored fields."""
    tree = torch.load(path, map_location=map_location, weights_only=True)
    if template is not None and dataclasses.is_dataclass(template):
        return dataclasses.replace(template, **tree)
    return tree


def dump_trajectory(path: str, traj, truth=None, infos=None) -> None:
    """npz dump of a trajectory, its ground truth and the step infos
    (a dataclass such as engine.StepInfo, a NamedTuple, or any object with
    the INFO_FIELDS attributes), each field as ``info_<name>``."""
    data = {"trajectory": _numpy(traj)}
    if truth is not None:
        data["truth"] = _numpy(truth)
    if infos is not None:
        if dataclasses.is_dataclass(infos):
            items = {f.name: getattr(infos, f.name)
                     for f in dataclasses.fields(infos)}
        elif hasattr(infos, "_asdict"):
            items = infos._asdict()
        else:
            items = {k: getattr(infos, k) for k in INFO_FIELDS}
        data.update({f"info_{k}": _numpy(v) for k, v in items.items()})
    np.savez(path, **data)


def load_trajectory(path: str) -> dict:
    return dict(np.load(path))
