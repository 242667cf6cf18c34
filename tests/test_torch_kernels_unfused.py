"""K4 corr_apply_cols, K5 fused_update_tail and K6 f32_matmul_big of the
port against the JAX Pallas kernels, and against their f64 formulas.

Inputs are the kernels' real operands in one unfused frame: a JAX engine
state at test_fused_step.py's config (CAP 24, D = 157 — not a multiple of
any tile —, 2M = 32, so the folded factors are R = 32 + 8 = 40 wide)
stepped by the port, whose wrappers are recorded: K4 and K6 on the
default route at f64, K5 on the pallas_update="on" route at f32 (the only
dtype that route runs at). K6 is called once a frame, for RANSAC's P·G
(N = NHYP = 64); the LI and the HI update's P·Hᵀ (N = 2M = 32) come from
pht_blocks, and their dense form, P with the dense compact Hᵀ (the
products K6 still takes for a dense H), joins K6's operands here.

On CPU tensors the wrappers run the plain versions. The Pallas kernels
accumulate in f32 even on f64 inputs (preferred_element_type), so they are
held against the plain versions at f32, in interpret mode with
pk._CORR_PREC = "highest" pinned as tests/test_pallas_kernels.py does,
to that file's rtol 1e-5 / atol 1e-6 (f32 sums in other orders). The plain
versions are held to the f64 formulas written out here to rtol 1e-12 /
atol 1e-14 (the same math in another order at f64)."""

import jax
import numpy as np
import pytest
import torch

from ekf_slam_tpu.ops import pallas_kernels as pk
from torch_parity import (FUSED, configs, frame, frame_keys, interpret_mode,
                          n, port_obs, port_state, ransac_u,
                          sim_and_bootstrap, step_fn)

from ekf_slam_tpu_torch.filter import engine, measurement
from ekf_slam_tpu_torch.ops import kernels

torch.set_num_threads(1)

B = 3
NAMES = ["corr_apply_cols", "fused_update_tail", "f32_matmul_big"]
F32_TOL = dict(rtol=1e-5, atol=1e-6)
F64_TOL = dict(rtol=1e-12, atol=1e-14)


@pytest.fixture(scope="module")
def operands():
    """{kernel name: [its (B, ...) operands at each call]} from the port's
    unfused step on frame 2 of a JAX-stepped state."""
    jc, _ = configs(FUSED)
    with interpret_mode():
        _, obs, jst = sim_and_bootstrap(jc, 2, 3, B)
        jst, _ = step_fn(jc)(jst, frame(obs, 1), frame_keys(1, B))
    u = torch.tensor(ransac_u(frame_keys(2, B), jc.ransac.num_hypotheses))
    captured = {}
    for pallas, dtype in (("off", torch.float64), ("on", torch.float32)):
        d = {**FUSED, "filter": {"fused_step": "off",
                                 "pallas_update": pallas},
             "dtype": str(dtype).removeprefix("torch.")}
        _, tc = configs(d)
        with kernels.capture_operands() as calls:
            engine.step(port_state(jst, dtype), port_obs(frame(obs, 2), dtype),
                        u.to(dtype), tc)
        captured.update({k: v for k, v in calls.items() if k in NAMES})
        captured["pht_blocks"] = calls["pht_blocks"]
        captured["f32_matmul_big"] += [
            (P, measurement.compact_dense_H(
                H_xv, H_y, sel, torch.ones_like(sel, dtype=torch.bool),
                tc.map.capacity).transpose(1, 2).contiguous())
            for P, H_xv, H_y, sel, _ in calls["pht_blocks"]]
    return captured


def _f32(args, batch=B):
    return tuple(a[:batch].float() for a in args)


def _pallas(name, args):
    """The JAX Pallas kernel in interpret mode at full-f32 precision."""
    prec = pk._CORR_PREC
    pk._CORR_PREC = "highest"
    try:
        with interpret_mode():
            fn = jax.jit(getattr(pk, name))
            return fn(*(jax.numpy.asarray(n(a)) for a in args))
    finally:
        pk._CORR_PREC = prec


def test_operands_are_realistic(operands):
    """Two update tails, RANSAC's product and the two updates' pht_blocks
    a frame (their dense form the other two products) at the config's
    shapes, with inliers in the factors and a non-identity renorm
    Jacobian."""
    assert [len(operands[k]) for k in NAMES] == [2, 2, 3]
    assert len(operands["pht_blocks"]) == 2
    P, A, Bf = operands["corr_apply_cols"][0]
    assert P.shape == (B, 157, 157) and A.shape == (B, 157, 40)
    assert P.dtype == torch.float64 and bool((A[:, :, :32] != 0).any())
    P, K, PHt, Jq4 = operands["fused_update_tail"][0]
    assert K.shape == (B, 157, 32) and P.dtype == torch.float32
    assert bool((K != 0).any())
    assert float((Jq4 - torch.eye(4)).abs().max()) > 0.1
    widths = [c[1].shape[2] for c in operands["f32_matmul_big"]]
    assert widths == [64, 32, 32]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("batch", [1, B], ids=["single", "batch3"])
def test_plain_matches_pallas_interpret_f32(operands, name, batch):
    for call in operands[name]:
        args = _f32(call, batch)
        got = getattr(kernels, name)(*args)          # CPU -> plain version
        assert got.dtype == torch.float32
        np.testing.assert_allclose(n(got), np.asarray(_pallas(name, args)),
                                   **F32_TOL)


def _corr_formula(P, A, Bf):
    return 0.5 * (P + P.transpose(1, 2)) + 0.5 * (
        A @ Bf.transpose(1, 2) + Bf @ A.transpose(1, 2))


def _tail_formula(P, K, PHt, Jq4):
    """T·sym(P − K·PHtᵀ)·Tᵀ with T = I ⊕ Jq4 as a dense matrix."""
    T = torch.eye(P.shape[1], dtype=P.dtype).repeat(P.shape[0], 1, 1)
    T[:, 3:7, 3:7] = Jq4
    M = P - K @ PHt.transpose(1, 2)
    return T @ (0.5 * (M + M.transpose(1, 2))) @ T.transpose(1, 2)


FORMULAS = {"corr_apply_cols": _corr_formula,
            "fused_update_tail": _tail_formula,
            "f32_matmul_big": lambda A, Bm: torch.einsum("bik,bkj->bij",
                                                         A, Bm)}


@pytest.mark.parametrize("name", NAMES)
def test_plain_matches_f64_formula(operands, name):
    """The plain versions against the formulas at f64 (K5's operands, from
    the f32 route, promoted). The tail formula symmetrizes P − K·PHtᵀ
    explicitly, which the plain version's ½(K·PHtᵀ + PHt·Kᵀ) equals for a
    symmetric P."""
    for call in operands[name]:
        args = tuple(a.double() for a in call)
        if name == "fused_update_tail":
            args = (0.5 * (args[0] + args[0].transpose(1, 2)),) + args[1:]
        np.testing.assert_allclose(n(kernels.PLAIN[name](*args)),
                                   n(FORMULAS[name](*args)), **F64_TOL)


def test_corr_apply_cols_plain_is_bitwise_symmetric(operands):
    for call in operands["corr_apply_cols"]:
        for args in (call, _f32(call)):
            out = kernels.corr_apply_cols(*args)
            assert torch.equal(out, out.transpose(1, 2))


@pytest.mark.parametrize("name", NAMES)
def test_cpu_tensors_take_the_plain_version(operands, name):
    before = dict(kernels.LAUNCHES)
    for call in operands[name]:
        torch.testing.assert_close(getattr(kernels, name)(*call),
                                   kernels.PLAIN[name](*call), rtol=0, atol=0)
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("name", NAMES)
def test_wrapper_rejects_bad_operands(operands, name):
    args = list(operands[name][0])
    fn = getattr(kernels, name)
    with pytest.raises(ValueError, match="shape"):
        fn(*args[:1], args[1][..., :-1, :].contiguous(), *args[2:])
    with pytest.raises(ValueError, match="contiguous"):
        fn(args[0].transpose(1, 2), *args[1:])


def _k4_without_renorm(P, A, Bf):
    """K4 with the factors' last 8 columns (the quaternion-renorm fold)
    left out of the sums."""
    return kernels.corr_apply_cols_plain(P, A[..., :-8], Bf[..., :-8])


def _k5_identity_renorm(P, K, PHt, Jq4):
    """K5 with Jq4 = I: no renorm transform."""
    return kernels.update_tail_plain(P, K, PHt, torch.eye(
        4, dtype=P.dtype).expand_as(Jq4))


def _k6_first_tile_skipped(A, Bm):
    """K6 that skips its first 32-wide contraction tile: the camera block
    and the first three slots drop out of every product."""
    return A[..., 32:] @ Bm[:, 32:]


@pytest.mark.parametrize("name,fault", [
    ("corr_apply_cols", _k4_without_renorm),
    ("fused_update_tail", _k5_identity_renorm),
    ("f32_matmul_big", _k6_first_tile_skipped),
], ids=["k4_without_renorm", "k5_identity_renorm", "k6_first_tile"])
def test_scaled_error_sees_planted_faults(operands, name, fault):
    """The kernel check of chip_smoke and the card tests reads each
    planted fault above 100x kernels.SCALED_TOL, while the plain version
    in f32 passes it. For K6 the bound is the product's,
    sqrt(P_ii·(Gᵀ·P·G)_kk)."""
    for call in operands[name]:
        args = tuple(a.double() for a in call)
        ref = kernels.PLAIN[name](*args)
        if name == "f32_matmul_big":
            d = torch.diagonal(args[0], dim1=1, dim2=2)

            def err(out):
                return kernels.product_error(out, ref, d, args[1])
        else:
            def err(out):
                return kernels.scaled_error(out, ref)
        assert err(fault(*args)) > 100 * kernels.SCALED_TOL
        assert err(kernels.PLAIN[name](*_f32(args))) <= kernels.SCALED_TOL


def test_tail_operands_enter_symmetric(operands):
    """The kernels' precondition: P enters K4 and K5 symmetric (K4 then
    keeps it bitwise symmetric)."""
    for name in ("corr_apply_cols", "fused_update_tail"):
        for call in operands[name]:
            P = call[0]
            tol = 1e-12 if P.dtype == torch.float64 else 1e-6
            torch.testing.assert_close(P, P.transpose(1, 2), rtol=0,
                                       atol=tol)
