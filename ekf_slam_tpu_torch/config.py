"""Typed configuration tree of the PyTorch port.

A JAX-free mirror of ``ekf_slam_tpu/config.py``: the same frozen
dataclasses, field names and defaults, so one nested dict builds both
trees (``EngineConfig.from_dict``). ``jnp_dtype`` becomes ``torch_dtype``.
The constants' sources (MonoSLAM's MATLAB files) are listed in the JAX
module's docstring.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

# Motion model identifiers (matlab_code/fv.m:8-47).
CONSTANT_VELOCITY = 0
CONSTANT_ORIENTATION = 1
CONSTANT_POSITION = 2
CONSTANT_POSITION_AND_ORIENTATION = 3

# State-vector layout: camera block [r(3) q(4) v(3) w(3)] then CAP 6-wide
# landmark slots (inverse-depth: [x y z theta phi rho]; cartesian:
# [x y z 0 0 0]).
CAM_DIM = 13


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Pinhole + 2-parameter radial distortion (initialize_cam.m:3-11)."""

    n_rows: int = 240
    n_cols: int = 320
    d: float = 0.0112
    cx: float = 1.7945 / 0.0112
    cy: float = 1.4433 / 0.0112
    k1: float = 6.333e-2
    k2: float = 1.390e-2
    f: float = 2.1735
    distort_newton_iters: int = 10

    @property
    def fku(self) -> float:
        return self.f / self.d

    @property
    def fkv(self) -> float:
        return self.f / self.d


@dataclasses.dataclass(frozen=True)
class FilterConfig:
    """EKF noise / motion-model settings (mono_slam.m:29-32).

    The port runs both steps (``fused_step``, ``pallas_update``) with
    storage in the state's dtype and the non-iterated update: the unfused
    step raises for ``use_iterated_update``, ``p_storage="bf16"`` and
    ``share_pht``, which are kept so both configuration trees stay
    field-for-field equal."""

    sigma_a: float = 0.007
    sigma_alpha: float = 0.007
    sigma_z: float = 1.0
    motion_model: int = CONSTANT_VELOCITY
    delta_t: float = 1.0
    v_0: float = 0.0
    std_v_0: float = 0.025
    w_0: float = 1e-15
    std_w_0: float = 0.025
    eps_pose: float = 2.220446049250313e-16
    use_iterated_update: bool = False
    iekf_iterations: int = 3
    pallas_update: str = "off"
    gain_solver: str = "cholesky"      # "cholesky" | "newton"
    share_pht: bool = False
    fused_step: str = "auto"
    p_storage: str = "f32"


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Fixed-capacity map + management policy."""

    capacity: int = 100
    min_features_in_image: int = 25
    initial_rho: float = 1.0
    std_rho: float = 1.0
    linearity_threshold: float = 0.1
    max_init_attempts: int = 50
    max_new_per_step: int = 25
    max_update_obs: int = 64
    delete_min_predictions: int = 5
    delete_measured_ratio: float = 0.5
    half_patch_init: int = 20
    half_patch_match: int = 6
    init_box_w: int = 60
    init_box_h: int = 40

    @property
    def state_dim(self) -> int:
        return CAM_DIM + 6 * self.capacity


@dataclasses.dataclass(frozen=True)
class MatchingConfig:
    """Individual-compatibility gating (matching.m)."""

    chi2_inv_2_95: float = 5.9915
    max_innovation_eig: float = 100.0
    sigma_search: float = 2.0
    fov_limit_deg: float = 60.0


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    """1-point RANSAC, a fixed batch of hypotheses (ransac_hypotheses.m)."""

    p_at_least_one_spurious_free: float = 0.99
    num_hypotheses: int = 64


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    """Image front-end parameters (vision/, the image path)."""

    search_radius: int = 12
    min_ncc: float = 0.5
    fast_threshold: float = 0.08
    fast_arc: int = 9
    exclusion_radius: float = 10.0
    matcher: str = "descriptor"
    corners_per_window: int = 8
    max_hamming: float = 64.0
    warp_distortion: str = "affine"


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Synthetic scene generator."""

    num_landmarks: int = 72
    world_radius: float = 4.0
    depth_min: float = 0.8
    depth_max: float = 6.0
    pixel_noise_std: float = 1.0
    outlier_fraction: float = 0.05
    outlier_shift_px: float = 30.0
    v_init: Tuple[float, float, float] = (0.02, 0.0, 0.005)
    w_init: Tuple[float, float, float] = (0.0, 0.004, 0.0)
    traj_accel_std: float | None = None
    traj_alpha_std: float | None = None


_SECTIONS = {
    "camera": CameraConfig, "filter": FilterConfig, "map": MapConfig,
    "matching": MatchingConfig, "ransac": RansacConfig,
    "vision": VisionConfig, "sim": SimConfig,
}


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Top-level config tree."""

    camera: CameraConfig = CameraConfig()
    filter: FilterConfig = FilterConfig()
    map: MapConfig = MapConfig()
    matching: MatchingConfig = MatchingConfig()
    ransac: RansacConfig = RansacConfig()
    vision: VisionConfig = VisionConfig()
    sim: SimConfig = SimConfig()
    dtype: str = "float32"
    debug_nan_checks: bool = False

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def replace(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_dict(cls, d: dict) -> "EngineConfig":
        """Build the tree from a nested dict: section names map to dicts
        of that section's fields, top-level fields to values. Lists become
        tuples (SimConfig.v_init / w_init)."""
        kw = {}
        for key, val in d.items():
            if key in _SECTIONS:
                kw[key] = _SECTIONS[key](**{
                    k: tuple(v) if isinstance(v, list) else v
                    for k, v in val.items()})
            else:
                kw[key] = val
        return cls(**kw)


DEFAULT = EngineConfig()
