"""Two faults of the port against the JAX package, repaired, and the f32
drift they were suspected of.

1. ``filter/ekf._spd_inverse`` of a non-SPD S: JAX's Cholesky returns an
   all-NaN factor, and so its inverse is all NaN; the port's
   ``cholesky_ex`` kept LAPACK's partial factor and returned a finite,
   wrong inverse for some matrices (S = [[1, 2], [2, 1]]). The port now
   sets a failed entry's factor to NaN (``ekf.cholesky``).
2. JAX's ``cholesky`` and ``eigh`` factor ½(A + Aᵀ); torch's read the
   lower triangle. The port now symmetrizes first (``ekf.cholesky``,
   ``kernels.smallest_eigvec``, the 8-point solve's plain version).

Tolerances: at f64 the port's factor, inverse and eigenvector equal
JAX's to 1e-10 (rounding ~1e-15); the lower-triangle-only factor of the
same input differs by more than 1e-5, so the tests see the fault.

``python tests/test_torch_faults.py`` prints the f32 drift of ROADMAP §3
(test_fused_step.py's config, CAP 24, B = 2, seed 0): after each of two
frames, max |x_f32 − x_f64| of the port (fused and unfused step) and of
JAX (fused step)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_slam_tpu.filter import ekf as jekf
from ekf_slam_tpu.models import loopclosure as jlc
from torch_parity import (FUSED, configs, frame, frame_keys, interpret_mode,
                          n, port_obs, port_state, ransac_u,
                          sim_and_bootstrap, step_fn)

from ekf_slam_tpu_torch.filter import ekf, engine
from ekf_slam_tpu_torch.models import loopclosure as lc
from ekf_slam_tpu_torch.ops import kernels

torch.set_num_threads(1)

TOL = 1e-10


def _spd(rng, n_):
    a = rng.normal(size=(n_, n_))
    return a @ a.T + n_ * np.eye(n_)


def _matrices(n_):
    """Two indefinite and two SPD n x n matrices (f64)."""
    rng = np.random.default_rng(n_)
    if n_ == 2:
        bad = [np.array([[1.0, 2.0], [2.0, 1.0]]),
               np.array([[4.0, 0.0], [0.0, -1.0]])]
    else:
        bad = [np.array([[2.0, 3.0, 0.0], [3.0, 2.0, 1.0], [0.0, 1.0, 5.0]]),
               np.diag([1.0, -2.0, 3.0])]
    return np.stack(bad + [_spd(rng, n_), _spd(rng, n_)])


@pytest.mark.parametrize("n_", [2, 3])
def test_spd_inverse_is_nan_where_jax_is(n_):
    """Batched: all NaN exactly on the indefinite entries, as JAX's
    _spd_inverse of each; equal to JAX's on the SPD ones."""
    S = _matrices(n_)
    ref = np.stack([np.asarray(jax.jit(jekf._spd_inverse)(jnp.asarray(s)))
                    for s in S])
    got = n(ekf._spd_inverse(torch.tensor(S)))
    assert np.isnan(ref[:2]).all() and np.isfinite(ref[2:]).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_allclose(got[2:], ref[2:], rtol=0,
                               atol=TOL * np.abs(ref[2:]).max())


def test_the_first_fault_returned_a_finite_inverse():
    """What the port's factor was: cholesky_ex's partial factor of
    [[1, 2], [2, 1]] is finite, so the unmasked inverse was finite."""
    S = torch.tensor([[1.0, 2.0], [2.0, 1.0]], dtype=torch.float64)
    L, info = torch.linalg.cholesky_ex(S)
    assert int(info) != 0 and torch.isfinite(L).all()
    assert torch.isnan(ekf.cholesky(S)).all()


def test_cholesky_factors_the_symmetric_part_like_jax():
    """An 8 x 8 SPD S with one lower entry moved by 1e-3 relative: the
    port's factor equals JAX's (which factors ½(S + Sᵀ)); the factor of
    the lower triangle alone differs by > 1e-5."""
    S = _spd(np.random.default_rng(5), 8)
    S[5, 2] *= 1 + 1e-3
    ref = np.asarray(jax.jit(jax.lax.linalg.cholesky)(jnp.asarray(S)))
    got = n(ekf.cholesky(torch.tensor(S)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    lower_only = n(torch.linalg.cholesky(torch.tensor(S)))
    assert np.abs(lower_only - ref).max() > 1e-5
    inv = np.asarray(jax.jit(jekf._spd_inverse)(jnp.asarray(S)))
    np.testing.assert_allclose(n(ekf._spd_inverse(torch.tensor(S))), inv,
                               rtol=0, atol=TOL * np.abs(inv).max())


def _unit_sign(v):
    """v with its largest-magnitude entry positive (an eigenvector's sign
    is the solver's choice)."""
    v = np.asarray(v)
    return v * np.sign(v[np.argmax(np.abs(v))])


def test_smallest_eigvec_symmetrizes_like_jax():
    """A 9 x 9 AᵀWA-like M with its upper triangle moved by 1e-3 relative:
    the port's eigenvector equals jnp.linalg.eigh's (up to sign); torch's
    eigh of M as given differs by > 1e-5."""
    rng = np.random.default_rng(6)
    A = rng.normal(size=(12, 9))
    M = A.T @ A
    M[np.triu_indices(9, 1)] *= 1 + 1e-3 * rng.uniform(-1, 1, 36)
    ref = _unit_sign(np.asarray(jax.jit(jnp.linalg.eigh)(
        jnp.asarray(M))[1])[:, 0])
    got = _unit_sign(n(kernels.smallest_eigvec(torch.tensor(M))))
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    lower_only = _unit_sign(n(torch.linalg.eigh(torch.tensor(M))
                              .eigenvectors[:, 0]))
    assert np.abs(lower_only - ref).max() > 1e-5


def test_eight_point_matches_jax():
    """The port's hypothesis solve on one sample of 8 weighted points
    against JAX's _eight_point at f64: F equal up to sign."""
    rng = np.random.default_rng(7)
    p1 = np.concatenate([rng.uniform(-1, 1, (8, 2)), np.ones((8, 1))], 1)
    p2 = np.concatenate([rng.uniform(-1, 1, (8, 2)), np.ones((8, 1))], 1)
    w = rng.uniform(0.5, 1.5, 8)
    ref = np.asarray(jax.jit(jlc._eight_point)(
        jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(w)))
    got = n(lc._eight_point(torch.tensor(p1)[None], torch.tensor(p2)[None],
                            torch.arange(8)[None, None],
                            torch.tensor(w)[None, None]))[0, 0]
    ref = ref / np.linalg.norm(ref)
    got = got / np.linalg.norm(got)
    np.testing.assert_allclose(_unit_sign(got.ravel()),
                               _unit_sign(ref.ravel()), rtol=0, atol=1e-8)


def f32_drift(frames: int = 3, batch: int = 2, seed: int = 0) -> dict:
    """After each of frames - 1 steps from JAX's f64 bootstrap state,
    max |x_f32 − x_f64| of the port's fused and unfused steps (each
    against the port's f64 fused step) and of JAX's fused step (against
    JAX's f64), on test_fused_step.py's config."""
    d32 = {**FUSED, "dtype": "float32"}
    jc64, tc64 = configs(FUSED)
    jc32, tc32 = configs(d32)
    _, tc32u = configs({**d32, "filter": {"fused_step": "off"}})
    _, obs, j64 = sim_and_bootstrap(jc64, seed, frames, batch)
    j32 = jax.tree.map(lambda a: a.astype(jnp.float32)
                       if a.dtype == jnp.float64 else a, j64)
    p64 = port_state(j64)
    p32 = p32u = port_state(j64, torch.float32)
    nh = jc64.ransac.num_hypotheses
    out = {"port_fused": [], "port_unfused": [], "jax_fused": []}
    with interpret_mode():
        for t in range(1, frames):
            keys = frame_keys(t, batch)
            o = frame(obs, t)
            o32 = jax.tree.map(lambda a: a.astype(jnp.float32)
                               if a.dtype == jnp.float64 else a, o)
            j64, _ = step_fn(jc64)(j64, o, keys)
            j32, _ = step_fn(jc32)(j32, o32, keys)
            u = torch.tensor(ransac_u(keys, nh))
            p64, _ = engine.step(p64, port_obs(o), u, tc64)
            p32, _ = engine.step(p32, port_obs(o, torch.float32),
                                 u.float(), tc32)
            p32u, _ = engine.step(p32u, port_obs(o, torch.float32),
                                  u.float(), tc32u)
            x64 = n(p64.x)
            out["port_fused"].append(float(np.abs(n(p32.x) - x64).max()))
            out["port_unfused"].append(float(np.abs(n(p32u.x) - x64)
                                             .max()))
            out["jax_fused"].append(float(np.abs(
                np.asarray(j32.x, np.float64) - np.asarray(j64.x)).max()))
    out["max_abs_x"] = float(np.abs(x64).max())
    return out


def test_f32_drift_stays_inside_the_f32_routes_bound():
    """The drift of both packages stays inside the 1e-3 of max|x| that
    test_torch_unfused.py (d) allows its f32 route."""
    d = f32_drift()
    for k in ("port_fused", "port_unfused", "jax_fused"):
        assert max(d[k]) <= 1e-3 * d["max_abs_x"], (k, d)


if __name__ == "__main__":
    import json

    import conftest  # noqa: F401  (the suite's JAX settings: CPU, x64)
    print(json.dumps(f32_drift()))
