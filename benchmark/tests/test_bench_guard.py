"""The import check compares whole top-level module names."""

from benchmark.harness import guard


def test_planted_jax_package_is_caught():
    mods = {"numpy": 1, "ekf_slam_tpu.filter.engine": 1, "ekf_slam_tpu": 1}
    assert guard.forbidden(mods) == ["ekf_slam_tpu"]


def test_port_passes():
    mods = {"ekf_slam_tpu_torch": 1, "ekf_slam_tpu_torch.filter": 1,
            "torch": 1, "jaxtyping_like": 1}
    assert guard.forbidden(mods) == []


def test_each_forbidden_name():
    for name in guard.FORBIDDEN:
        assert guard.forbidden({f"{name}.sub": 1}) == [name]
