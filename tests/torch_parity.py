"""Shared helpers of the port's parity tests (tests/test_torch_*.py): one
config dict builds both trees, the JAX engine runs jitted and vmapped over
a batch (its Pallas kernels in interpret mode), and states, observations
and RANSAC draws cross over as numpy arrays."""

import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ekf_slam_tpu import config as jcfg
from ekf_slam_tpu.filter import ekf as jekf
from ekf_slam_tpu.filter import engine as jengine
from ekf_slam_tpu.filter.state import init_state as j_init_state
from ekf_slam_tpu.ops import pallas_kernels as pk
from ekf_slam_tpu.sim import simulate as j_simulate
from ekf_slam_tpu_torch import config as tcfg
from ekf_slam_tpu_torch.filter.state import state_from_numpy
from ekf_slam_tpu_torch.sim.scene import FrameObs

SECTIONS = ("camera", "filter", "map", "matching", "ransac", "vision", "sim")

# tests/test_fused_step.py's config, with the fused step on.
FUSED = {
    "filter": {"fused_step": "on"},
    "map": {"capacity": 24, "min_features_in_image": 12,
            "max_new_per_step": 8, "max_update_obs": 16},
    "sim": {"num_landmarks": 40},
    "dtype": "float64",
}

# The bench workload (bench.py:289-317) in its f32 parity form.
SLICE = {
    "filter": {"fused_step": "on", "gain_solver": "newton"},
    "map": {"capacity": 100, "min_features_in_image": 25,
            "max_new_per_step": 10, "max_update_obs": 64},
    "ransac": {"num_hypotheses": 64},
    "sim": {"num_landmarks": 128},
    "dtype": "float32",
}


def configs(d):
    """(JAX EngineConfig, port EngineConfig) from one nested dict."""
    kw = {}
    for k, v in d.items():
        if k in SECTIONS:
            cls = type(getattr(jcfg.DEFAULT, k))
            kw[k] = cls(**v)
        else:
            kw[k] = v
    return jcfg.EngineConfig(**kw), tcfg.EngineConfig.from_dict(d)


class interpret_mode:
    """Run the JAX package's Pallas kernels in interpret mode (CPU)."""

    def __enter__(self):
        self.old = pk._INTERPRET[0]
        pk._INTERPRET[0] = True

    def __exit__(self, *exc):
        pk._INTERPRET[0] = self.old


def frame(obs, t):
    return jax.tree.map(lambda a: a[t], obs)


def batch(tree, B):
    return jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), tree)


@functools.cache
def step_fn(cfg):
    """jit(vmap(engine.step)) over (state, key), observations shared; one
    compiled program per config and shape."""
    return jax.jit(jax.vmap(lambda s, o, k: jengine.step(s, o, k, cfg),
                            in_axes=(0, None, 0)))


def rows_step_fn(cfg):
    """A fresh jit(vmap(engine.step)) that traces with EKF_UPDATE=rows. The
    JAX engine reads ekf._UPDATE while tracing, so step_fn's cached
    column-form program cannot serve. Returns (step, traced): traced[0]
    counts the ekf.update_rows calls made while tracing (two a trace when
    the row form was taken)."""
    traced = [0]
    update_rows = jekf.update_rows

    def spy(*args, **kw):
        traced[0] += 1
        return update_rows(*args, **kw)

    fn = jax.jit(jax.vmap(lambda s, o, k: jengine.step(s, o, k, cfg),
                          in_axes=(0, None, 0)))

    def step(*args):
        with mock.patch.object(jekf, "_UPDATE", "rows"), \
                mock.patch.object(jekf, "update_rows", spy):
            return fn(*args)

    return step, traced


def frame_keys(t, B):
    return jax.random.split(jax.random.key(100 + t), B)


def ransac_u(keys, num):
    """The uniform draws JAX's RANSAC makes from each key (f64 under the
    suite's x64 mode), as numpy (B, num)."""
    return np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (num,)))(keys))


@functools.cache
def _bootstrap_fn(jc):
    return jax.jit(lambda o: jengine.bootstrap(j_init_state(jc), o, jc))


def sim_and_bootstrap(jc, seed, frames, B):
    """JAX-simulated sequence and a bootstrapped state broadcast to B."""
    _, xs, obs = j_simulate(jax.random.key(seed), jc, frames)
    return xs, obs, batch(_bootstrap_fn(jc)(frame(obs, 0)), B)


def port_state(jstate, dtype=torch.float64):
    return state_from_numpy(
        {f.name: np.asarray(getattr(jstate, f.name))
         for f in dataclasses.fields(jstate)}, "cpu", dtype)


def port_obs(jobs, dtype=torch.float64):
    return FrameObs(torch.tensor(np.asarray(jobs.pixels), dtype=dtype),
                    torch.tensor(np.asarray(jobs.visible)))


def t(a, dtype=torch.float64):
    """numpy / JAX array -> torch tensor (floats in `dtype`)."""
    a = np.asarray(a)
    if a.dtype.kind == "f":
        return torch.tensor(a, dtype=dtype)
    return torch.tensor(a)


def n(a):
    """torch tensor -> numpy."""
    return a.detach().cpu().numpy()
