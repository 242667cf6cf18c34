"""The port's row-form update (EKF_UPDATE=rows) against the JAX package's:
K8 corr_apply's plain version, the row-form measurement helpers,
ekf.update_rows, and the unfused step in row form.

(a) kernels.corr_apply_plain against the Pallas corr_apply in interpret
mode (pk._CORR_PREC = "highest", as tests/test_layout_forms.py:310-345
runs it), every symmetrize mode with P stored f32 and bf16, D = 37 and
R = 13 (neither a multiple of a tile): f32 within 1e-6 (f32 sums of 13
products in other orders), bf16 within one bf16 ulp (both round once from
f32 values that differ by f32 rounding). The correction of "expr" and
"full" is bitwise symmetric: "full"'s output always, "expr"'s for a
symmetric P.
(b) measurement.pht_rows_split, innovation_covariances_from_hp and
compact_dense_H_block against JAX at f64 within 1e-12.
(c) ekf.update_rows against JAX's at f64 with masked rows within 1e-10
(test_layout_forms.py's update_rows test), and against the port's own
column-form ekf.update.
(d) the unfused step with EKF_UPDATE=rows over 7 frames, B = 3, at f64
against JAX's rows step (torch_parity.rows_step_fn): x rtol 1e-9, P rtol
1e-8 (tests/test_torch_unfused.py's tolerances), masks, counters and gate
counts exactly equal; and 3 frames at max_update_obs > CAP and = 0, where
the row form updates every slot (M = CAP). The port's tails run K8's
plain version here; JAX's its XLA form P + ½[At;Bt]ᵀ[Bt;At], the same
math as K8's "expr" mode."""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_slam_tpu.filter import ekf as jekf
from ekf_slam_tpu.filter import measurement as jmeas
from ekf_slam_tpu.ops import pallas_kernels as pk
from torch_parity import (FUSED, configs, frame, frame_keys, interpret_mode,
                          n, port_obs, port_state, ransac_u, rows_step_fn,
                          sim_and_bootstrap)

from ekf_slam_tpu_torch.filter import ekf, engine, measurement
from ekf_slam_tpu_torch.ops import kernels

torch.set_num_threads(1)

B = 3
FRAMES = 8           # bootstrap on frame 0, then 7 steps
X_TOL = dict(rtol=1e-9, atol=1e-11)
P_TOL = dict(rtol=1e-8, atol=1e-10)
COUNTS = ("n_visible", "n_ic", "n_li", "n_hi", "ransac_support")
MASKS = ("active", "cartesian", "landmark_id", "times_predicted",
         "times_measured")
UNFUSED = {**FUSED, "filter": {"fused_step": "off"}}
CAM = 13


def _spd(rng, D, batch):
    X = rng.standard_normal((batch, D, D))
    return X @ X.transpose(0, 2, 1) / D + np.eye(D)


# --- (a) K8's plain version against the Pallas kernel ----------------------

def _corr_operands(seed=0, D=37, R=13, batch=2):
    rng = np.random.default_rng(seed)
    P = _spd(rng, D, batch).astype(np.float32)
    At = (rng.standard_normal((batch, R, D)) / np.sqrt(R)).astype(np.float32)
    Bt = (rng.standard_normal((batch, R, D)) / np.sqrt(R)).astype(np.float32)
    return P, At, Bt


def _jax_corr_apply(P, At, Bt, mode):
    prec = pk._CORR_PREC
    pk._CORR_PREC = "highest"
    try:
        with interpret_mode():
            return jax.jit(lambda p, a, b: pk.corr_apply(p, a, b, mode))(
                P, jnp.asarray(At), jnp.asarray(Bt))
    finally:
        pk._CORR_PREC = prec


@pytest.mark.parametrize("store", ["f32", "bf16"])
@pytest.mark.parametrize("mode", kernels.CORR_MODES)
def test_corr_apply_plain_matches_pallas_interpret(mode, store):
    P, At, Bt = _corr_operands()
    if store == "bf16":
        jP = jnp.asarray(P, jnp.bfloat16)
        tP = torch.tensor(np.asarray(jP, np.float32)).to(torch.bfloat16)
    else:
        jP, tP = jnp.asarray(P), torch.tensor(P)
    want = _jax_corr_apply(jP, At, Bt, mode)
    got = kernels.corr_apply(tP, torch.tensor(At), torch.tensor(Bt), mode)
    assert got.dtype == tP.dtype and str(want.dtype) == (
        "bfloat16" if store == "bf16" else "float32")
    want32 = torch.tensor(np.asarray(want, np.float32))
    if store == "f32":
        np.testing.assert_allclose(n(got), n(want32), rtol=1e-6, atol=1e-6)
    else:
        diff = (got.float() - want32).abs()
        assert bool((diff <= kernels.bf16_ulp(want32)).all()), float(
            diff.max())


@pytest.mark.parametrize("store", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_corr_apply_plain_symmetry(store):
    """"full" is bitwise symmetric from an asymmetric P; "expr" from a
    symmetric one; "none" is not symmetric."""
    P, At, Bt = (torch.tensor(a) for a in _corr_operands(1))
    asym = (P + 1e-2 * torch.rand(P.shape, generator=torch.Generator()
                                  .manual_seed(0))).to(store)
    sym = (0.5 * (P + P.transpose(1, 2))).to(store)
    out = kernels.corr_apply(asym, At, Bt, "full")
    assert torch.equal(out, out.transpose(1, 2))
    out = kernels.corr_apply(sym, At, Bt, "expr")
    assert torch.equal(out, out.transpose(1, 2))
    out = kernels.corr_apply(sym, At, Bt, "none")
    assert not torch.equal(out, out.transpose(1, 2))


def test_corr_apply_rejects_an_unknown_mode():
    P, At, Bt = (torch.tensor(a) for a in _corr_operands())
    with pytest.raises(ValueError, match="symmetrize"):
        kernels.corr_apply(P, At, Bt, "both")


# --- (b) the row-form measurement helpers ----------------------------------

def _blocks(seed, cap, batch=2):
    rng = np.random.default_rng(seed)
    D = CAM + 6 * cap
    return (_spd(rng, D, batch), rng.standard_normal((batch, cap, 2, CAM)),
            rng.standard_normal((batch, cap, 2, 6)))


def test_pht_rows_split_matches_jax():
    P, H_xv, H_y = _blocks(2, 6)
    want = jax.vmap(jmeas.pht_rows_split)(P, H_xv, H_y)
    got = measurement.pht_rows_split(*map(torch.tensor, (P, H_xv, H_y)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(n(g), np.asarray(w), rtol=1e-12,
                                   atol=1e-12)


def test_innovation_covariances_from_hp_matches_jax():
    P, H_xv, H_y = _blocks(3, 5)
    hp = jax.vmap(jmeas.pht_rows_split)(P, H_xv, H_y)
    want = jax.vmap(lambda u, v, a, b: jmeas.innovation_covariances_from_hp(
        u, v, a, b, 1.3))(*hp, H_xv, H_y)
    got = measurement.innovation_covariances_from_hp(
        *(torch.tensor(np.asarray(a)) for a in (*hp, H_xv, H_y)), 1.3)
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-12,
                               atol=1e-12)


def test_compact_dense_H_block_matches_jax():
    cap = 7
    _, H_xv, H_y = _blocks(4, cap)
    slots = np.array([[3, 0, 6, 2], [1, 5, 4, 0]])
    mask = np.array([[True, True, False, True], [True, False, True, True]])
    take = np.take_along_axis
    Hx = take(H_xv, slots[:, :, None, None], 1)
    Hy = take(H_y, slots[:, :, None, None], 1)
    want = jax.vmap(lambda a, b, s, m: jmeas.compact_dense_H_block(
        a, b, s, m, cap))(Hx, Hy, slots, mask)
    got = measurement.compact_dense_H_block(
        torch.tensor(Hx), torch.tensor(Hy), torch.tensor(slots),
        torch.tensor(mask), cap)
    assert got.shape == (2, 8, CAM + 6 * cap)
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-12,
                               atol=1e-12)


# --- (c) the row-form update ------------------------------------------------

def _update_operands(seed=50, cap=4, M=6, batch=2):
    """test_layout_forms.py's update_rows operands, batched: P SPD, H
    (M, D), a quaternion of norm 1.02, rows 5: masked."""
    rng = np.random.default_rng(seed)
    D = CAM + 6 * cap
    P = _spd(rng, D, batch)
    H = rng.standard_normal((batch, M, D)) * 0.3
    z = rng.standard_normal((batch, M)) * 0.05
    h = np.zeros((batch, M))
    x = rng.standard_normal((batch, D))
    x[:, 3:7] *= 1.02 / np.linalg.norm(x[:, 3:7], axis=1, keepdims=True)
    mask = np.broadcast_to(np.arange(M) < 5, (batch, M)).copy()
    r = np.ones((batch, M))
    HP = (H * mask[..., None]) @ P
    return x, P, H, HP, z, h, mask, r


@pytest.mark.parametrize("solver", ["cholesky", "newton"])
@pytest.mark.parametrize("mode", kernels.CORR_MODES)
def test_update_rows_matches_jax(monkeypatch, mode, solver):
    """Each K8 mode: with P symmetric all three are the JAX update's math
    (its XLA tail, which is "expr")."""
    ops = _update_operands()
    want = jax.vmap(lambda *a: jekf.update_rows(*a, gain_solver=solver))(
        *ops)
    monkeypatch.setattr(ekf, "_TAIL_SYM", mode)
    with kernels.capture_operands() as calls:
        got = ekf.update_rows(*map(torch.tensor, ops), gain_solver=solver)
    assert [c[3] for c in calls["corr_apply"]] == [mode]
    assert calls["corr_apply"][0][1].shape == (2, 2 * 3 + 8, CAM + 24)
    np.testing.assert_allclose(n(got[0]), np.asarray(want[0]), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(n(got[1]), np.asarray(want[1]), rtol=1e-10,
                               atol=1e-10)


def test_update_rows_equals_update():
    """The port's row form equals its column form (ekf.update, K4 tail) on
    the same measurement set at f64: test_layout_forms.py:228-254."""
    x, P, H, HP, z, h, mask, r = map(torch.tensor, _update_operands(51))
    x_ref, P_ref = ekf.update(x, P, H, z, h, mask, r)
    x_row, P_row = ekf.update_rows(x, P, H, HP, z, h, mask, r)
    torch.testing.assert_close(x_row, x_ref, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(P_row, P_ref, rtol=1e-10, atol=1e-10)
    assert float((P_row - P_row.transpose(1, 2)).abs().max()) < 1e-10


# --- (d) the unfused step in row form ---------------------------------------

def _run_rows(d, frames, batch, seed=0):
    """`frames - 1` row-form steps of JAX and of the port from JAX's
    bootstrap state; per frame (JAX state, JAX info, port state, port
    info, the port's kernel calls). Returns (frames, JAX traced count)."""
    jc, tc = configs(d)
    nh = jc.ransac.num_hypotheses
    _, obs, jst = sim_and_bootstrap(jc, seed, frames, batch)
    step, traced = rows_step_fn(jc)
    st = port_state(jst)
    out = []
    with mock.patch.object(ekf, "_UPDATE", "rows"):
        for t in range(1, frames):
            keys = frame_keys(t, batch)
            jst, jinfo = step(jst, frame(obs, t), keys)
            with kernels.capture_operands() as calls:
                st, info = engine.step(st, port_obs(frame(obs, t)),
                                       torch.tensor(ransac_u(keys, nh)), tc)
            out.append((jst, jinfo, st, info, calls))
    return out, traced[0]


@pytest.fixture(scope="module")
def rows_run():
    return _run_rows(UNFUSED, FRAMES, B)


def _assert_states(st, jst):
    np.testing.assert_allclose(n(st.x), np.asarray(jst.x), **X_TOL)
    np.testing.assert_allclose(n(st.P), np.asarray(jst.P), **P_TOL)
    for f in MASKS:
        np.testing.assert_array_equal(n(getattr(st, f)),
                                      np.asarray(getattr(jst, f)), err_msg=f)


def test_rows_step_matches_jax_multiframe(rows_run):
    for jst, _, st, _, _ in rows_run[0]:
        _assert_states(st, jst)


@pytest.mark.parametrize("field", COUNTS)
def test_rows_step_counts_match_jax(rows_run, field):
    for t, (_, jinfo, _, info, _) in enumerate(rows_run[0], start=1):
        np.testing.assert_array_equal(
            n(getattr(info, field)), np.asarray(getattr(jinfo, field)),
            err_msg=f"frame {t}")


def test_both_packages_took_the_row_form(rows_run):
    """JAX traced update_rows for both updates; the port's frames ran K8
    twice and neither K4 nor K6 (RANSAC moves and S come from the H·P
    rows). The window updates: LI and HI inliers in the 7 frames."""
    frames, traced = rows_run
    assert traced == 2
    for *_, calls in frames:
        assert sorted(calls) == ["corr_apply"]
        assert [c[3] for c in calls["corr_apply"]] == ["expr", "expr"]
        assert calls["corr_apply"][0][1].shape == (B, 2 * 16 + 8, 157)
    assert sum(int(n(f[3].n_li).sum()) for f in frames) > 0
    assert sum(int(n(f[3].n_hi).sum()) for f in frames) > 0


def test_rows_form_equals_cols_form(rows_run):
    """The port's row and column forms agree over the same 7 frames."""
    jc, tc = configs(UNFUSED)
    nh = jc.ransac.num_hypotheses
    _, obs, jst = sim_and_bootstrap(jc, 0, FRAMES, B)
    st = port_state(jst)
    for t in range(1, FRAMES):
        st, _ = engine.step(st, port_obs(frame(obs, t)), torch.tensor(
            ransac_u(frame_keys(t, B), nh)), tc)
    rows_st = rows_run[0][-1][2]
    np.testing.assert_allclose(n(rows_st.x), n(st.x), **X_TOL)
    np.testing.assert_allclose(n(rows_st.P), n(st.P), **P_TOL)


@pytest.mark.parametrize("M", [30, 0], ids=["M_gt_cap", "M_zero"])
def test_rows_step_every_slot_matches_jax(M):
    """max_update_obs outside (0, CAP]: the row form updates all CAP slots
    (engine.py:588-589), 3 frames."""
    d = {**UNFUSED, "map": {**UNFUSED["map"], "max_update_obs": M}}
    frames, traced = _run_rows(d, 4, B)
    assert traced == 2
    for t, (jst, jinfo, st, info, calls) in enumerate(frames, start=1):
        _assert_states(st, jst)
        for f in COUNTS:
            np.testing.assert_array_equal(
                n(getattr(info, f)), np.asarray(getattr(jinfo, f)),
                err_msg=f"{f} frame {t}")
        assert calls["corr_apply"][0][1].shape == (B, 2 * 24 + 8, 157)
