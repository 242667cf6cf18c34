"""The port's config tree mirrors the JAX one field for field."""

import dataclasses

import pytest
import torch

from ekf_slam_tpu import config as jcfg
from ekf_slam_tpu_torch import config as tcfg

torch.set_num_threads(1)

SECTIONS = ("camera", "filter", "map", "matching", "ransac", "vision", "sim")

NON_DEFAULT = {
    "camera": {"n_rows": 480, "k1": 0.05},
    "filter": {"sigma_a": 0.01, "motion_model": tcfg.CONSTANT_POSITION,
               "gain_solver": "newton", "fused_step": "on"},
    "map": {"capacity": 24, "min_features_in_image": 12,
            "max_new_per_step": 8, "max_update_obs": 16},
    "matching": {"chi2_inv_2_95": 9.21},
    "ransac": {"num_hypotheses": 32},
    "sim": {"num_landmarks": 40, "v_init": [0.01, 0.0, 0.0],
            "traj_accel_std": 0.0},
    "dtype": "float64",
}


def _jax_from_dict(d):
    kw = {}
    for k, v in d.items():
        if k in SECTIONS:
            cls = type(getattr(jcfg.DEFAULT, k))
            kw[k] = cls(**{f: tuple(x) if isinstance(x, list) else x
                           for f, x in v.items()})
        else:
            kw[k] = v
    return jcfg.EngineConfig(**kw)


@pytest.mark.parametrize("d", [{}, NON_DEFAULT], ids=["default", "custom"])
def test_asdict_equal(d):
    t = tcfg.EngineConfig.from_dict(d)
    j = _jax_from_dict(d)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.mark.parametrize("section", SECTIONS)
def test_section_fields_and_defaults(section):
    t, j = getattr(tcfg.DEFAULT, section), getattr(jcfg.DEFAULT, section)
    assert [f.name for f in dataclasses.fields(t)] == [
        f.name for f in dataclasses.fields(j)]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_constants_and_properties():
    assert tcfg.CAM_DIM == jcfg.CAM_DIM
    assert (tcfg.CONSTANT_VELOCITY, tcfg.CONSTANT_ORIENTATION,
            tcfg.CONSTANT_POSITION,
            tcfg.CONSTANT_POSITION_AND_ORIENTATION) == (
        jcfg.CONSTANT_VELOCITY, jcfg.CONSTANT_ORIENTATION,
        jcfg.CONSTANT_POSITION, jcfg.CONSTANT_POSITION_AND_ORIENTATION)
    assert tcfg.DEFAULT.map.state_dim == jcfg.DEFAULT.map.state_dim == 613
    assert tcfg.DEFAULT.camera.fku == jcfg.DEFAULT.camera.fku
    assert tcfg.DEFAULT.torch_dtype is torch.float32
    assert tcfg.EngineConfig(dtype="float64").torch_dtype is torch.float64


def test_from_dict_rejects_unknown_field():
    with pytest.raises(TypeError):
        tcfg.EngineConfig.from_dict({"map": {"capacity_typo": 3}})
