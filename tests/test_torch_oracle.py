"""The port's float64 oracle (ekf_slam_tpu_torch/oracle) against the JAX
package's copy, and the port's unfused step against it
(ekf_slam_tpu_torch/oracle/golden.py).

(a) Bit for bit: OracleSLAM of both packages over the golden config's 10
frames (observations JAX simulates from key(4), one forced conversion at
t = 5, the RANSAC picks of one seeded numpy stream): x, P, the records and
every stage mask equal every frame; and each `onp` helper the golden
check calls, on the same f64 inputs, returns the same array.

(b) golden.run at f64 on the CPU, seeds 0-3, B = 4, T = 10: the golden
gates of tests/test_golden_pipeline.py (counts equal every frame, RMSE
<= 1e-6 every frame, a conversion exercised).

(c) golden.run at f32 on the CPU, the reading behind
golden.GOLDEN_F32_TOL, the card's gate (chip_smoke.py phase 10): the
largest RMSE over the frames before the counts part from the oracle's,
times golden.F32_MARGIN, stays within it. Seeds 2 and 3 part at frame 6:
the forced conversion leaves P indefinite at f32 and the step goes
non-finite, in the JAX package's f32 step as in the port's (ROADMAP §3;
the last test runs both on the same observations and draws)."""

import jax
import numpy as np
import pytest
import torch

import ekf_slam_tpu.oracle.oracle as jonp
from ekf_slam_tpu.oracle.pipeline import OracleSLAM as JOracle
from ekf_slam_tpu.oracle.pipeline import Rec as JRec
from ekf_slam_tpu.sim import simulate as jsimulate
from torch_parity import configs

from ekf_slam_tpu_torch.oracle import golden
from ekf_slam_tpu_torch.oracle import oracle as onp
from ekf_slam_tpu_torch.oracle.pipeline import OracleSLAM, Rec

torch.set_num_threads(1)

T, B = 10, 4


def _bootstrap(cls, rec, mod, cfg, pixels0, visible0):
    orc = cls(cfg)
    m = cfg.map
    order = np.argsort(~visible0, kind="stable")
    for k, j in enumerate(order[:m.max_new_per_step]):
        if not visible0[j]:
            continue
        orc.P = mod.add_feature_covariance_inverse_depth(
            orc.P, pixels0[j], orc.x[0:13], cfg.filter.sigma_z, m.std_rho,
            cfg.camera)
        orc.x = np.concatenate([orc.x, mod.hinv(
            pixels0[j], orc.x[0:13], cfg.camera, m.initial_rho)])
        orc.recs.append(rec(k, int(j)))
    return orc


def test_oracle_slam_is_jaxs_bit_for_bit():
    jc, tc = configs({**golden.GOLDEN, "dtype": "float64"})
    _, _, obs = jsimulate(jax.random.key(4), jc, T)
    pixels = np.asarray(obs.pixels, np.float64)
    visible = np.asarray(obs.visible)
    j = _bootstrap(JOracle, JRec, jonp, jc, pixels[0], visible[0])
    p = _bootstrap(OracleSLAM, Rec, onp, tc, pixels[0], visible[0])
    rng = np.random.default_rng(7)
    for t in range(1, T):
        if t == T // 2:
            slot = min(r.slot for r in p.recs if r.kind == "id")
            for orc in (j, p):
                off = orc.offset(orc.by_slot()[slot]) + 5
                orc.P[off, off] = 1e-6
        picks = rng.integers(0, jc.map.capacity, jc.ransac.num_hypotheses)
        out = []
        for orc in (j, p):
            z_by = {r.slot: pixels[t, r.lm_id] for r in orc.recs}
            zv_by = {r.slot: bool(visible[t, r.lm_id]) for r in orc.recs}
            out.append(orc.step(z_by, zv_by, lambda ic: picks, visible[t],
                                pixels[t]))
        for k in out[0]:
            np.testing.assert_array_equal(out[1][k], out[0][k],
                                          err_msg=f"{k}, frame {t}")
        assert np.array_equal(p.x, j.x) and np.array_equal(p.P, j.P), t
        assert ([(r.slot, r.lm_id, r.kind, r.times_predicted,
                  r.times_measured) for r in p.recs]
                == [(r.slot, r.lm_id, r.kind, r.times_predicted,
                     r.times_measured) for r in j.recs]), t
    assert any(r.kind == "c" for r in p.recs), "conversion never exercised"


def _helper_cases():
    rng = np.random.default_rng(3)
    _, tc = configs({**golden.GOLDEN, "dtype": "float64"})
    cam, f = tc.camera, tc.filter
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    xv = np.concatenate([rng.normal(size=3), q, rng.normal(size=6) * 0.01])
    y = np.array([0.1, -0.2, 0.3, 0.4, -0.1, 0.5])
    uv = np.array([100.0, 80.0])
    P = np.eye(13 + 6) * 0.01
    return {
        "qprod": (q, q[::-1].copy()), "q2r": (q,), "v2q": (xv[10:13],),
        "norm_jac": (q,), "dqomegadt_by_domega": (xv[10:13], 1.0),
        "dRq_times_a_by_dq": (q, y[:3]), "undistort": (uv, cam),
        "distort": (uv, cam), "jacob_undistort": (uv, cam),
        "hinv": (uv, xv, cam, 1.0), "fv": (xv, 1.0, f),
        "dfv_by_dxv": (xv, 1.0), "func_Q": (xv, 1.0, f),
        "predict": (np.concatenate([xv, y]), P, f),
        "hi_inverse_depth": (y, xv[:3], onp.q2r(q), cam),
        "Hi_inverse_depth": (xv, y, uv, cam),
        "Hi_cartesian": (xv, y[:3] + [0, 0, 3], uv, cam),
        "add_feature_covariance_inverse_depth": (P, uv, xv, 1.0, 1.0, cam),
        "inversedepth_to_cartesian_point": (y,),
        "id2cartesian_jacobian": (y,), "initialize_x_and_p": (f,),
    }


@pytest.mark.parametrize("name", sorted(_helper_cases()))
def test_oracle_helper_is_jaxs_bit_for_bit(name):
    args = _helper_cases()[name]
    jc, _ = configs({**golden.GOLDEN, "dtype": "float64"})
    jargs = tuple(jc.camera if type(a).__name__ == "CameraConfig" else
                  jc.filter if type(a).__name__ == "FilterConfig" else a
                  for a in args)
    got, want = getattr(onp, name)(*args), getattr(jonp, name)(*jargs)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", range(4))
def test_unfused_step_f64_meets_the_golden_gates(seed):
    r = golden.run("float64", T, B, seed, "cpu")
    assert r.first_parting() is None
    for k in golden.COUNTS:
        np.testing.assert_array_equal(r.port[k], r.oracle[k], err_msg=k)
    assert np.all(r.rmse <= golden.GOLDEN_F64_TOL), r.rmse
    assert r.rmse[0].max() < 1e-9
    assert r.converted.any(), "conversion never exercised"


# The frame at which the f32 counts part from the oracle's, by seed (the
# f32 step goes non-finite after the forced conversion; ROADMAP §3).
F32_PARTING = {0: None, 1: None, 2: 6, 3: 6}


def test_f32_reading_sets_the_card_tolerance():
    readings = {}
    for seed, part in F32_PARTING.items():
        r = golden.run("float32", T, B, seed, "cpu")
        assert r.first_parting() == part, seed
        held = r.rmse[:part or T]
        assert np.isfinite(held).all(), seed
        readings[seed] = float(held.max())
        if part:
            print(f"seed {seed}, frame {part}: port", {
                k: r.port[k][part - 1].tolist() for k in golden.COUNTS},
                "oracle", {k: r.oracle[k][part - 1].tolist()
                           for k in golden.COUNTS})
    worst = max(readings.values())
    print("f32 golden RMSE before parting, by seed:", readings)
    assert (worst * golden.F32_MARGIN <= golden.GOLDEN_F32_TOL
            <= 2 * worst * golden.F32_MARGIN)


def test_f32_parting_is_the_jax_packages_too():
    """Seeds 2 and 3 at f32, the RANSAC draws of JAX keys key(300 + t):
    after the forced conversion the JAX package's f32 unfused step goes
    non-finite in the same instances at the same frames as the port's,
    with the same n_li on every frame before (ROADMAP §3)."""
    from ekf_slam_tpu.filter import engine as jengine
    from ekf_slam_tpu.filter.state import init_state as j_init_state
    from ekf_slam_tpu.sim.scene import FrameObs as JObs
    from torch_parity import batch, ransac_u

    from ekf_slam_tpu_torch.config import CAM_DIM
    from ekf_slam_tpu_torch.filter import engine
    from ekf_slam_tpu_torch.filter.state import init_state
    from ekf_slam_tpu_torch.sim import simulate

    jc, tc = configs({**golden.GOLDEN, "dtype": "float32"})
    jstep = jax.jit(jax.vmap(lambda s, o, k: jengine.step(s, o, k, jc),
                             in_axes=(0, None, 0)))
    jboot = jax.jit(lambda o: jengine.bootstrap(j_init_state(jc), o, jc))
    first = {}
    for seed in (2, 3):
        _, _, obs = simulate(torch.Generator().manual_seed(seed), tc, T,
                             "cpu")
        px, vis = obs.pixels.numpy(), obs.visible.numpy()
        jst = batch(jboot(JObs(px[0], vis[0])), B)
        st = engine.bootstrap(init_state(tc, B, "cpu"), obs.frame(0), tc)
        for t_ in range(1, T):
            if t_ == T // 2:
                live = st.active & ~st.cartesian
                P = np.asarray(jst.P).copy()
                for b in range(B):
                    rd = CAM_DIM + 6 * int(torch.nonzero(live[b])[0, 0]) + 5
                    st.P[b, rd, rd] = 1e-6
                    P[b, rd, rd] = 1e-6
                jst = jst.replace(P=P)
            keys = jax.random.split(jax.random.key(300 + t_), B)
            u = torch.tensor(ransac_u(keys, jc.ransac.num_hypotheses),
                             dtype=torch.float32)
            jst, jinfo = jstep(jst, JObs(px[t_], vis[t_]), keys)
            st, info = engine.step(st, obs.frame(t_), u, tc)
            jfin = np.isfinite(np.asarray(jst.x)).all(axis=1)
            fin = torch.isfinite(st.x).all(dim=1).numpy()
            np.testing.assert_array_equal(fin, jfin, err_msg=f"{seed} {t_}")
            if jfin.all():
                np.testing.assert_array_equal(info.n_li.numpy(),
                                              np.asarray(jinfo.n_li))
            elif seed not in first:
                first[seed] = (t_, np.flatnonzero(~jfin).tolist())
    assert first == {2: (6, [1, 3]), 3: (6, [0, 1, 2, 3])}
