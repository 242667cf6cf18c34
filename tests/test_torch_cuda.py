"""The hand-written CUDA kernels K1-K8 and eight_point_fit on the card,
against their plain versions, and one frame of each engine path and of the
image path on the card against the same frame on the CPU; also the
Cholesky inverse on indefinite S, one CALC2 train step, card vs CPU, and
the replayed frames (engine, image path, run_online) against eager.
Every test needs a CUDA device and skips without one.

This file imports neither JAX nor the JAX package (the machine with the
card has no JAX); run it there without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Operands are the kernels' real operands in one frame of the port at a
small config (CAP 24: D = 157, 2·CAP = 48, 2M = 32, rank 6K = 48): K1-K3
from the fused step, K4 and K6 from the unfused step, K5 from the unfused
step with pallas_update="on"; K7 (both forms) on the operands of the
image step's ncc_corr_norms at tests/test_vision.py's pixels config (CAP
24, R = 10: N = B·24 pairs of 33x33 windows and 13x13 templates); K8, and K4 / K6 on a bf16 P, from the
bf16-P fast mode's unfused step at f32 (row form for K8, 2M + 8 = 40
factor rows); K3 again from a fused frame that adds ten features an
instance (rank r = 60)."""

from unittest import mock

import pytest
import torch

from ekf_slam_tpu_torch.config import EngineConfig
from ekf_slam_tpu_torch.filter import ekf, engine
from ekf_slam_tpu_torch.filter.state import init_state
from ekf_slam_tpu_torch.kernel_variants import ep_systems
from ekf_slam_tpu_torch.ops import kernels
from ekf_slam_tpu_torch.sim import simulate
from ekf_slam_tpu_torch.vision import frontend, ncc
from torch_scales import k1_scale, k3_scale, within

torch.set_num_threads(1)

B = 3
CFG = {
    "filter": {"fused_step": "on"},
    "map": {"capacity": 24, "min_features_in_image": 12,
            "max_new_per_step": 8, "max_update_obs": 16},
    "sim": {"num_landmarks": 40},
}
PLAIN = kernels.PLAIN
NAMES = ["fused_manage_predict_pht", "fused_update_tail_add",
         "fused_update_tail_pht"]
# The unfused step's kernels and the filter settings of the frame their
# operands come from (K5 runs only at f32, as in the JAX package).
UNFUSED = {"corr_apply_cols": ("off", "float64"),
           "fused_update_tail": ("on", "float32"),
           "f32_matmul_big": ("off", "float64")}
# Each entry's error in units of its Cauchy-Schwarz bound
# (kernels.scaled_error); the limit's reason is at kernels.SCALED_TOL.
TOL = kernels.SCALED_TOL
IMAGE = {
    "map": {"capacity": 24, "min_features_in_image": 10,
            "max_new_per_step": 10},
    "vision": {"search_radius": 10, "min_ncc": 0.4, "matcher": "ncc"},
    "sim": {"num_landmarks": 40, "depth_min": 2.0, "depth_max": 6.0,
            "v_init": [0.002, 0.0, 0.004], "w_init": [0.0, 0.001, 0.0],
            "traj_accel_std": 2e-4, "traj_alpha_std": 2e-4},
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _sequence(dtype_name, **filter_kw):
    cfg = EngineConfig.from_dict({
        **CFG, "filter": {**CFG["filter"], **filter_kw},
        "dtype": dtype_name})
    _, _, obs = simulate(torch.Generator().manual_seed(0), cfg, 3, "cpu")
    st = engine.bootstrap(init_state(cfg, B, "cpu"), obs.frame(0), cfg)
    u = torch.rand(3, B, cfg.ransac.num_hypotheses, dtype=torch.float64,
                   generator=torch.Generator().manual_seed(1))
    return cfg, obs, st, u


@pytest.fixture(scope="module")
def operands():
    """{kernel name: its f64 operands} in frame 2 of the port on the CPU."""
    cfg, obs, st, u = _sequence("float64")
    st, _ = engine.step(st, obs.frame(1), u[1], cfg)
    with kernels.capture_operands() as captured:
        engine.step(st, obs.frame(2), u[2], cfg)
    return {name: calls[-1] for name, calls in captured.items()}


@pytest.fixture(scope="module")
def unfused_operands():
    """{kernel name: [its operands at each call]} in frame 2 of the port's
    unfused step on the CPU. K6 is called for RANSAC's P·G, then for the
    LI and the HI update's P·Hᵀ."""
    captured = {}
    for pallas, dtype_name in sorted(set(UNFUSED.values())):
        cfg, obs, st, u = _sequence(dtype_name, fused_step="off",
                                    pallas_update=pallas)
        st, _ = engine.step(st, obs.frame(1), u[1], cfg)
        with kernels.capture_operands() as calls:
            engine.step(st, obs.frame(2), u[2], cfg)
        captured.update(calls)
    return captured


def _ht(name, args):
    return args[-1] if name != "fused_update_tail_add" else None


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_cuda_kernel_matches_plain(card, operands, name):
    """f32 kernel vs the f64 plain version on the same f32-rounded
    operands, each entry within TOL of its own bound."""
    args = tuple(a.to(card, torch.float32) for a in operands[name])
    before = kernels.LAUNCHES[name]
    got = getattr(kernels, name)(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    for g in (got if isinstance(got, tuple) else (got,)):
        assert g.dtype == torch.float32 and g.is_cuda
    ref = PLAIN[name](*(a.double() for a in args))
    err = kernels.scaled_error(got, ref, _ht(name, args))
    assert err <= TOL, err


@pytest.mark.cuda
def test_cuda_check_fails_k1_without_process_noise(card, operands):
    """A planted fault of the camera block: K1 launched with Q13 zeroed,
    held against the plain version with Q13, reads far above TOL."""
    args = tuple(a.to(card, torch.float32)
                 for a in operands["fused_manage_predict_pht"])
    got = kernels.fused_manage_predict_pht(*args[:6],
                                           torch.zeros_like(args[6]), args[7])
    ref = kernels.manage_predict_pht_plain(*(a.double() for a in args))
    assert kernels.scaled_error(got, ref, args[7]) > 1e-2


@pytest.mark.cuda
def test_cuda_downdate_is_symmetric(card, operands):
    """(i,j) and (j,i) tiles of K2's symmetric downdate are float-exact
    mirrors: K2's pass (K5's kernel) writes each tile pair once to both
    triangles and takes the 8x8 renorm corner's lower entries from its
    upper ones, so the whole output is bitwise symmetric."""
    args = tuple(a.to(card, torch.float32)
                 for a in operands["fused_update_tail_pht"])
    P = args[0]
    args = (0.5 * (P + P.transpose(1, 2)),) + args[1:]
    out, _ = kernels.fused_update_tail_pht(*args)
    asym = (out - out.transpose(1, 2))[:, 8:, 8:]
    assert float(asym.abs().max()) == 0.0
    assert torch.equal(out, out.transpose(1, 2))


@pytest.mark.cuda
def test_cuda_check_fails_k2_product_of_p_before_tail(card, operands):
    """A planted fault: K2's P·Ht2 taken from the P before the tail (what
    the composed K2 gives if its product reads the wrong buffer), held
    against the plain version, reads far above TOL."""
    args = tuple(a.to(card, torch.float32)
                 for a in operands["fused_update_tail_pht"])
    P_li, _ = kernels.fused_update_tail_pht(*args)
    got = (P_li, kernels.f32_matmul_big(args[0], args[4]))
    ref = kernels.update_tail_pht_plain(*(a.double() for a in args))
    assert kernels.scaled_error(got, ref, args[4]) > 100 * TOL


@pytest.mark.cuda
def test_cuda_wrapper_rejects_f64_and_mixed_devices(card, operands):
    args = tuple(a.to(card) for a in operands["fused_update_tail_pht"])
    with pytest.raises(TypeError, match="float32"):
        kernels.fused_update_tail_pht(*args)
    args = tuple(a.float() for a in args)
    with pytest.raises(ValueError, match="on cpu"):
        kernels.fused_update_tail_pht(*args[:-1], args[-1].cpu())


@pytest.mark.cuda
def test_cuda_launcher_rejects_sizes_past_its_limits(card, operands):
    """Rank > 128 for K3: the launcher returns cudaErrorInvalidValue and
    the wrapper raises. (K1's and K2's R has no limit:
    test_cuda_manage_predict_pht_takes_any_width.)"""
    args = [a.to(card, torch.float32)
            for a in operands["fused_update_tail_add"]]
    B, r, D = args[5].shape
    wide = torch.zeros(B, 130, D, device=card)
    with pytest.raises(RuntimeError, match="cudaError_t 1"):
        kernels.fused_update_tail_add(*args[:5], wide, wide,
                                      torch.zeros(B, 130, 130, device=card))


@pytest.mark.cuda
def test_cuda_step_matches_cpu_step(card):
    """One fused f32 frame with CUDA tensors (kernels) against the same
    frame on the CPU (plain versions): equal gate counts; x within 1e-4 of
    the state's scale and P entrywise within 1e-2 of its bounds (f32
    rounding in other orders, amplified by the gain); each kernel
    launched once."""
    cfg, obs, st, u = _sequence("float32")
    kernels.reset_launches()
    s_gpu, i_gpu = engine.step(st.to(card), obs.frame(1).to(card),
                               u[1].to(card), cfg)
    s_cpu, i_cpu = engine.step(st, obs.frame(1), u[1], cfg)
    assert kernels.LAUNCHES == {k: int(k in NAMES) for k in kernels.LAUNCHES}
    for f in ("n_ic", "n_li", "n_hi"):
        assert torch.equal(getattr(i_gpu, f).cpu(), getattr(i_cpu, f)), f
    scale = float(s_cpu.x.abs().max())
    assert float((s_gpu.x.cpu() - s_cpu.x).abs().max()) <= 1e-4 * scale
    assert kernels.scaled_error(s_gpu.P.cpu().double(),
                                s_cpu.P.double()) <= 1e-2
    assert bool(torch.isfinite(s_gpu.P).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(UNFUSED))
def test_cuda_unfused_kernel_matches_plain(card, unfused_operands, name):
    """K4, K5, K6 (f32) vs the f64 plain version on the same f32-rounded
    operands at every call of the frame, each entry within TOL of its own
    bound (for K6 the product bound sqrt(P_ii·(Gᵀ·P·G)_kk))."""
    calls = unfused_operands[name]
    assert len(calls) == (3 if name == "f32_matmul_big" else 2)
    for operands in calls:
        args = tuple(a.to(card, torch.float32) for a in operands)
        before = kernels.LAUNCHES[name]
        got = getattr(kernels, name)(*args)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES[name] == before + 1
        assert got.dtype == torch.float32 and got.is_cuda
        ref = PLAIN[name](*(a.double() for a in args))
        if name == "f32_matmul_big":
            P = args[0].double()
            err = kernels.product_error(
                got, ref, torch.diagonal(P, dim1=1, dim2=2), args[1])
        else:
            err = kernels.scaled_error(got, ref)
        assert err <= TOL, err


@pytest.mark.cuda
def test_cuda_corr_apply_cols_is_bitwise_symmetric(card, unfused_operands):
    """K4's output is bitwise symmetric, even from an asymmetric P."""
    P, A, B_ = (a.to(card, torch.float32)
                for a in unfused_operands["corr_apply_cols"][0])
    P = P + 1e-3 * torch.rand(P.shape, device=card,
                              generator=torch.Generator(card).manual_seed(0))
    out = kernels.corr_apply_cols(P, A, B_)
    assert torch.equal(out, out.transpose(1, 2))


@pytest.mark.cuda
def test_cuda_check_fails_k5_with_identity_renorm(card, unfused_operands):
    """A planted fault: K5 launched with Jq4 = I (no quaternion renorm
    transform), held against the plain version with Jq4, reads far above
    TOL."""
    args = tuple(a.to(card, torch.float32)
                 for a in unfused_operands["fused_update_tail"][0])
    eye = torch.eye(4, device=card).expand_as(args[3]).contiguous()
    got = kernels.fused_update_tail(*args[:3], eye)
    ref = kernels.update_tail_plain(*(a.double() for a in args))
    assert kernels.scaled_error(got, ref) > 100 * TOL


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 31, 300])
def test_cuda_unfused_kernels_take_any_width(card, R):
    """K4's rank R and K6's width N have no limit: a width past one
    256-column chunk (K6), and R / N below one 32-wide chunk."""
    g = torch.Generator(card).manual_seed(R)
    B, D = 2, 157
    X = torch.randn(B, D, D, device=card, generator=g)
    P = X @ X.transpose(1, 2) / D + torch.eye(D, device=card)
    A = torch.randn(B, D, R, device=card, generator=g)
    Bf = torch.randn(B, D, R, device=card, generator=g)
    out = kernels.corr_apply_cols(P, A, Bf)
    ref = kernels.corr_apply_cols_plain(*(t.double() for t in (P, A, Bf)))
    assert torch.equal(out, out.transpose(1, 2))
    assert float((out.double() - ref).abs().max()) <= 1e-5 * (1 + R)
    got = kernels.f32_matmul_big(P, A)
    want = P.double() @ A.double()
    assert float((got.double() - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("pallas", ["off", "on"])
def test_cuda_unfused_step_matches_cpu_step(card, pallas):
    """One unfused f32 frame with CUDA tensors (K4 or K5, and K6) against
    the same frame on the CPU (plain versions), at the tolerances of
    test_cuda_step_matches_cpu_step; each kernel launched as often as the
    frame calls it."""
    cfg, obs, st, u = _sequence("float32", fused_step="off",
                                pallas_update=pallas)
    kernels.reset_launches()
    s_gpu, i_gpu = engine.step(st.to(card), obs.frame(1).to(card),
                               u[1].to(card), cfg)
    s_cpu, i_cpu = engine.step(st, obs.frame(1), u[1], cfg)
    tail = "fused_update_tail" if pallas == "on" else "corr_apply_cols"
    assert kernels.LAUNCHES == {k: {tail: 2, "f32_matmul_big": 3}.get(k, 0)
                                for k in kernels.LAUNCHES}
    for f in ("n_ic", "n_li", "n_hi"):
        assert torch.equal(getattr(i_gpu, f).cpu(), getattr(i_cpu, f)), f
    scale = float(s_cpu.x.abs().max())
    assert float((s_gpu.x.cpu() - s_cpu.x).abs().max()) <= 1e-4 * scale
    assert kernels.scaled_error(s_gpu.P.cpu().double(),
                                s_cpu.P.double()) <= 1e-2
    assert bool(torch.isfinite(s_gpu.P).all())


def _image_sequence(dtype_name):
    """The image path's inputs on the CPU: cfg, empty states and stores,
    3 rendered frames, RANSAC draws."""
    cfg = EngineConfig.from_dict({**IMAGE, "dtype": dtype_name})
    scn, xs, _ = simulate(torch.Generator().manual_seed(0), cfg, 3, "cpu")
    imgs = torch.stack([frontend.render_scene_image(scn, xs[i], cfg, "cpu")
                        for i in range(3)])
    u = torch.rand(3, B, cfg.ransac.num_hypotheses,
                   dtype=cfg.torch_dtype,
                   generator=torch.Generator().manual_seed(1))
    return (cfg, init_state(cfg, B, "cpu"),
            frontend.init_appearance(cfg, B, "cpu"), imgs, u)


@pytest.fixture(scope="module")
def ncc_operands():
    """K7's f64 operands (windows, zero-mean templates) in frame 2 of the
    image path on the CPU, where the matcher calls ncc_corr_norms."""
    cfg, st, app, imgs, u = _image_sequence("float64")
    st, app, _, _ = frontend.run_images(st, app, imgs[:2], u[:2], cfg, "cpu")
    with kernels.capture_operands() as captured:
        frontend.step_image(st, app, imgs[2], u[2], cfg)
    return captured["ncc_corr_norms"][0]


@pytest.mark.cuda
def test_cuda_ncc_corr_matches_plain(card, ncc_operands):
    """K7 (f32) vs the f64 plain version on the same f32-rounded operands,
    each entry within TOL of its bound ‖window patch‖·‖template‖."""
    win, tm = (a.to(card, torch.float32) for a in ncc_operands)
    assert win.shape == (B * 24, 33, 33) and tm.shape == (B * 24, 13, 13)
    before = kernels.LAUNCHES["ncc_corr"]
    got = kernels.ncc_corr(win, tm)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ncc_corr"] == before + 1
    assert got.dtype == torch.float32 and got.shape == (B * 24, 21, 21)
    ref = kernels.ncc_corr_plain(win.double(), tm.double())
    assert kernels.ncc_error(got, ref, win, tm) <= TOL


@pytest.mark.cuda
def test_cuda_ncc_check_fails_transposed_template(card, ncc_operands):
    win, tm = (a.to(card, torch.float32) for a in ncc_operands)
    got = kernels.ncc_corr(win, tm.transpose(1, 2).contiguous())
    ref = kernels.ncc_corr_plain(win.double(), tm.double())
    assert kernels.ncc_error(got, ref, win, tm) > 100 * TOL


@pytest.mark.cuda
@pytest.mark.parametrize("N,W2,t", [(1, 37, 13), (130, 23, 7), (5, 13, 13)])
def test_cuda_ncc_corr_takes_other_shapes(card, N, W2, t):
    """One pair, a pair count past one 128-lane TPU group with a smaller
    window, and t = W2 (one offset)."""
    g = torch.Generator(card).manual_seed(N)
    win = torch.rand(N, W2, W2, device=card, generator=g)
    tm = torch.rand(N, t, t, device=card, generator=g) - 0.5
    got = kernels.ncc_corr(win, tm)
    ref = kernels.ncc_corr_plain(win.double(), tm.double())
    assert kernels.ncc_error(got, ref, win, tm) <= TOL
    with pytest.raises(TypeError, match="float32"):
        kernels.ncc_corr(win.double(), tm.double())


def _norms_within_limits(got, ref):
    """K7's norms form (f32) against its f64 plain version: the
    correlation within TOL of its bounds, the variance within
    ncc.FLAT_EPS units of eps·Σwc², the energy to 1e-5."""
    return (kernels.var_stray(got[1], ref[1], ref[2]) < ncc.FLAT_EPS
            and kernels.energy_error(got[2], ref[2]) <= 1e-5)


@pytest.mark.cuda
def test_cuda_ncc_corr_norms_matches_plain(card, ncc_operands):
    """K7's norms form on the image frame's pairs: one launch, the three
    outputs of their shapes, each within its limit."""
    win, tm = (a.to(card, torch.float32) for a in ncc_operands)
    before = kernels.LAUNCHES["ncc_corr_norms"]
    got = kernels.ncc_corr_norms(win, tm)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ncc_corr_norms"] == before + 1
    assert [tuple(g.shape) for g in got] == [(B * 24, 21, 21)] * 2 + [
        (B * 24,)]
    assert all(g.dtype == torch.float32 for g in got)
    ref = kernels.ncc_corr_norms_plain(win.double(), tm.double())
    assert kernels.ncc_error(got[0], ref[0], win, tm) <= TOL
    assert _norms_within_limits(got, ref)


@pytest.mark.cuda
def test_cuda_ncc_norms_check_fails_box_sums_one_row_down(card,
                                                          ncc_operands):
    """The windows rolled up one row (each offset's box sums taken one
    row down) read > 100x ncc.FLAT_EPS against the true windows' norms."""
    win, tm = (a.to(card, torch.float32) for a in ncc_operands)
    _, var, _ = kernels.ncc_corr_norms(torch.roll(win, -1, 1).contiguous(),
                                       tm)
    ref = kernels.ncc_corr_norms_plain(win.double(), tm.double())
    assert kernels.var_stray(var, ref[1], ref[2]) > 100 * ncc.FLAT_EPS


@pytest.mark.cuda
@pytest.mark.parametrize("N,W2,t", [(1, 37, 13), (130, 23, 7), (5, 13, 13),
                                    (7, 9, 1), (3200, 37, 13)])
def test_cuda_ncc_corr_norms_takes_other_shapes(card, N, W2, t):
    """One pair, a run-time t on 130 pairs, t = W2 (one offset), t = 1
    and the bench's 3,200 pairs; both forms' correlations equal bit for
    bit (one kernel template, one sum order)."""
    g = torch.Generator(card).manual_seed(N)
    win = torch.rand(N, W2, W2, device=card, generator=g)
    tm = torch.rand(N, t, t, device=card, generator=g) - 0.5
    got = kernels.ncc_corr_norms(win, tm)
    ref = kernels.ncc_corr_norms_plain(win.double(), tm.double())
    assert kernels.ncc_error(got[0], ref[0], win, tm) <= TOL
    assert _norms_within_limits(got, ref)
    assert torch.equal(got[0], kernels.ncc_corr(win, tm))
    with pytest.raises(TypeError, match="float32"):
        kernels.ncc_corr_norms(win.double(), tm.double())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ncc_corr", "ncc_corr_norms"])
def test_cuda_ncc_launcher_rejects_a_window_past_shared_memory(card, name):
    """One pair's staging past a block's shared memory: the launcher
    returns cudaErrorInvalidValue and the wrapper raises."""
    win = torch.zeros(1, 400, 400, device=card)
    tm = torch.zeros(1, 3, 3, device=card)
    with pytest.raises(RuntimeError, match="cudaError_t 1"):
        getattr(kernels, name)(win, tm)


@pytest.mark.cuda
def test_cuda_image_step_matches_cpu_step(card):
    """One f32 image frame (NCC matcher) with CUDA tensors against the same
    frame on the CPU, at the tolerances of test_cuda_step_matches_cpu_step;
    K7's norms form launched once, K4 twice, K6 three times."""
    cfg, st, app, imgs, u = _image_sequence("float32")
    st, app, _, _ = frontend.run_images(st, app, imgs[:2], u[:2], cfg, "cpu")
    kernels.reset_launches()
    s_gpu, _, i_gpu = frontend.step_image(st.to(card), app.to(card),
                                          imgs[2].to(card), u[2].to(card),
                                          cfg)
    s_cpu, _, i_cpu = frontend.step_image(st, app, imgs[2], u[2], cfg)
    assert kernels.LAUNCHES == {
        k: {"ncc_corr_norms": 1, "corr_apply_cols": 2,
            "f32_matmul_big": 3}.get(k, 0) for k in kernels.LAUNCHES}
    for f in ("n_ic", "n_li", "n_hi"):
        assert torch.equal(getattr(i_gpu, f).cpu(), getattr(i_cpu, f)), f
    scale = float(s_cpu.x.abs().max())
    assert float((s_gpu.x.cpu() - s_cpu.x).abs().max()) <= 1e-4 * scale
    assert bool(torch.isfinite(s_gpu.P).all())


def _fast_operands(form):
    """{kernel name: [operands of each call]} in frame 2 of the bf16-P fast
    mode (f32, Newton gain, unfused) on the CPU, update form `form`."""
    cfg, obs, st, u = _sequence("float32", fused_step="off",
                                gain_solver="newton", p_storage="bf16")
    u = u.float()
    with mock.patch.object(ekf, "_UPDATE", form):
        st, _ = engine.step(st, obs.frame(1), u[1], cfg)
        with kernels.capture_operands() as calls:
            engine.step(st, obs.frame(2), u[2], cfg)
    return calls


@pytest.fixture(scope="module")
def fast_operands():
    return {form: _fast_operands(form) for form in ("cols", "rows")}


@pytest.mark.cuda
@pytest.mark.parametrize("store", ["bf16", "f32"])
@pytest.mark.parametrize("mode", kernels.CORR_MODES)
def test_cuda_corr_apply_matches_plain(card, fast_operands, mode, store):
    """K8 vs the f64 plain version on a real row-form tail's operands, P
    as stored (bf16) and upcast: each entry within TOL of its bound (plus
    one bf16 ulp for a bf16 output); "full" bitwise symmetric."""
    calls = fast_operands["rows"]["corr_apply"]
    assert len(calls) == 2 and calls[0][0].dtype == torch.bfloat16
    for P, At, Bt, _ in calls:
        P, At, Bt = (a.to(card) for a in (P, At, Bt))
        P = P if store == "bf16" else P.float()
        before = kernels.LAUNCHES["corr_apply"]
        got = kernels.corr_apply(P, At, Bt, mode)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["corr_apply"] == before + 1
        assert got.dtype == P.dtype and got.is_cuda
        ref = kernels.corr_apply_plain(P.double(), At.double(), Bt.double(),
                                       mode)
        assert kernels.scaled_error(got, ref) <= TOL
        if mode == "full":
            assert torch.equal(got, got.transpose(1, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("store", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_cuda_corr_apply_expr_is_symmetric_on_symmetric_p(
        card, fast_operands, store):
    P, At, Bt, _ = (a.to(card) if isinstance(a, torch.Tensor) else a
                    for a in fast_operands["rows"]["corr_apply"][0])
    Pf = P.float()
    sym = (0.5 * (Pf + Pf.transpose(1, 2))).to(store)
    got = kernels.corr_apply(sym, At, Bt, "expr")
    assert torch.equal(got, got.transpose(1, 2))


@pytest.mark.cuda
def test_cuda_check_fails_k8_without_renorm(card, fast_operands):
    """A planted fault: K8 with At's last four rows (the quaternion-renorm
    block) zeroed, against the plain version with them, reads far above
    TOL."""
    P, At, Bt, mode = fast_operands["rows"]["corr_apply"][0]
    P, At, Bt = (a.to(card) for a in (P, At, Bt))
    bad = At.clone()
    bad[:, -4:] = 0
    got = kernels.corr_apply(P, bad, Bt, mode)
    ref = kernels.corr_apply_plain(P.double(), At.double(), Bt.double(),
                                   mode)
    assert kernels.scaled_error(got, ref) > 100 * TOL


@pytest.mark.cuda
def test_cuda_k4_k6_on_bf16_p_match_plain(card, fast_operands):
    """K4 and K6 read the fast mode's bf16 P as stored: K4's bf16 output
    and K6's f32 product against the f64 plain versions."""
    calls = fast_operands["cols"]
    assert len(calls["corr_apply_cols"]) == 2
    assert len(calls["f32_matmul_big"]) == 3
    for P, A, Bf in calls["corr_apply_cols"]:
        P, A, Bf = (a.to(card) for a in (P, A, Bf))
        assert P.dtype == torch.bfloat16
        got = kernels.corr_apply_cols(P, A, Bf)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, got.transpose(1, 2))
        ref = kernels.corr_apply_cols_plain(P.double(), A.double(),
                                            Bf.double())
        assert kernels.scaled_error(got, ref) <= TOL
    for P, G in calls["f32_matmul_big"]:
        P, G = P.to(card), G.to(card)
        assert P.dtype == torch.bfloat16
        got = kernels.f32_matmul_big(P, G)
        assert got.dtype == torch.float32
        ref = P.double() @ G.double()
        err = kernels.product_error(got, ref, torch.diagonal(
            P.double(), dim1=1, dim2=2), G)
        assert err <= TOL


@pytest.mark.cuda
def test_cuda_check_rejects_bf16_factors_and_f64_p(card, fast_operands):
    P, At, Bt, mode = fast_operands["rows"]["corr_apply"][0]
    P, At, Bt = (a.to(card) for a in (P, At, Bt))
    with pytest.raises(TypeError, match="float32"):
        kernels.corr_apply(P, At.to(torch.bfloat16), Bt, mode)
    with pytest.raises(TypeError, match="float32"):
        kernels.corr_apply(P.double(), At, Bt, mode)
    P, A, Bf = (a.to(card) for a in fast_operands["cols"]["corr_apply_cols"][0])
    with pytest.raises(TypeError, match="float32"):
        kernels.corr_apply_cols(P, A.to(torch.bfloat16), Bf)
    with pytest.raises(TypeError, match="float32"):
        kernels.f32_matmul_big(P.double(), A.double())


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["cols", "rows"])
def test_cuda_fast_step_matches_cpu_step(card, form):
    """One bf16-P fast-mode frame with CUDA tensors against the same frame
    on the CPU: equal gate counts, x within 1e-4 of the state's scale and
    P within 1e-2 of its bounds; K4 2x and K6 3x (cols) or K8 2x (rows)."""
    cfg, obs, st, u = _sequence("float32", fused_step="off",
                                gain_solver="newton", p_storage="bf16")
    u = u.float()
    with mock.patch.object(ekf, "_UPDATE", form):
        kernels.reset_launches()
        s_gpu, i_gpu = engine.step(st.to(card), obs.frame(1).to(card),
                                   u[1].to(card), cfg)
        s_cpu, i_cpu = engine.step(st, obs.frame(1), u[1], cfg)
    want = ({"corr_apply_cols": 2, "f32_matmul_big": 3} if form == "cols"
            else {"corr_apply": 2})
    assert kernels.LAUNCHES == {k: want.get(k, 0) for k in kernels.LAUNCHES}
    assert s_gpu.P.dtype == torch.bfloat16
    for f in ("n_ic", "n_li", "n_hi"):
        assert torch.equal(getattr(i_gpu, f).cpu(), getattr(i_cpu, f)), f
    scale = float(s_cpu.x.abs().max())
    assert float((s_gpu.x.cpu() - s_cpu.x).abs().max()) <= 1e-4 * scale
    assert kernels.scaled_error(s_gpu.P.cpu().double(),
                                s_cpu.P.double()) <= 1e-2


# --- K6 and K8 on the register-blocked panel product ------------------------

# f32 fmaf chains against f64 on the same operands: each entry within this
# share of Σ_k |a_k|·|b_k|, its own worst-case scale (a chain of K products
# strays at most K·2^-24 of it: 3.7e-5 at K = 613, typically its root).
CHAIN_TOL = 1e-5
F32_BF16 = pytest.mark.parametrize("store", [torch.float32, torch.bfloat16],
                                   ids=["f32", "bf16"])


def _randn(card, seed, *shape):
    return torch.randn(*shape, device=card,
                       generator=torch.Generator(card).manual_seed(seed))


def _check_matmul_big(card, M, K, N, store, seed):
    A = _randn(card, seed, 2, M, K).to(store)
    Bm = _randn(card, seed + 1, 2, K, N)
    got = kernels.f32_matmul_big(A, Bm)
    again = kernels.f32_matmul_big(A, Bm)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (2, M, N)
    assert torch.equal(got, again)
    want = A.double() @ Bm.double()
    scale = A.double().abs() @ Bm.double().abs()
    assert bool(((got.double() - want).abs() <= CHAIN_TOL * scale).all())


@pytest.mark.cuda
@F32_BF16
@pytest.mark.parametrize("N", [1, 31, 48, 64, 128, 200, 300])
def test_cuda_matmul_big_takes_any_width(card, N, store):
    """K6 at the bench's D = 613 on both column blockings (64, 128), widths
    that are no multiple of 4 (stores by element) and widths past one
    128-column chunk; two launches agree bit for bit."""
    _check_matmul_big(card, 613, 613, N, store, N)


@pytest.mark.cuda
@F32_BF16
@pytest.mark.parametrize("M,K,N", [(50, 613, 48), (613, 50, 128),
                                   (19, 19, 64), (19, 19, 31)])
def test_cuda_matmul_big_takes_other_shapes(card, M, K, N, store):
    """K6 with M != K and with A smaller than one row stripe and one
    contraction tile."""
    _check_matmul_big(card, M, K, N, store, M + N)


def _corr_operands(card, D, R, store, seed, symmetric=False):
    P = _randn(card, seed, 2, D, D)
    if symmetric:
        P = 0.5 * (P + P.transpose(1, 2))
    return (P.to(store), _randn(card, seed + 1, 2, R, D),
            _randn(card, seed + 2, 2, R, D))


@pytest.mark.cuda
@F32_BF16
@pytest.mark.parametrize("D", [19, 613])
@pytest.mark.parametrize("R", [1, 31, 56, 300])
@pytest.mark.parametrize("mode", kernels.CORR_MODES)
def test_cuda_corr_apply_takes_any_rank(card, mode, R, D, store):
    """K8 in every mode on random operands: D below one 64-wide tile and
    the bench's 613 (10 tiles a side, the last ragged), R below one
    contraction tile, the fast mode's 56 and a tall 300. Each entry within
    CHAIN_TOL of its scale |P| + |At|ᵀ|Bt| + |Bt|ᵀ|At| (one bf16 ulp more on
    a bf16 output); "full" bitwise symmetric; two launches agree bit for
    bit."""
    P, At, Bt = _corr_operands(card, D, R, store, 7 * R + D)
    got = kernels.corr_apply(P, At, Bt, mode)
    again = kernels.corr_apply(P, At, Bt, mode)
    torch.cuda.synchronize()
    assert got.dtype == store and torch.equal(got, again)
    Pd, Ad, Bd = P.double(), At.double(), Bt.double()
    ref = kernels.corr_apply_plain(Pd, Ad, Bd, mode)
    C = Ad.abs().transpose(1, 2) @ Bd.abs()
    limit = CHAIN_TOL * (Pd.abs() + Pd.abs().transpose(1, 2) + C
                         + C.transpose(1, 2))
    if store == torch.bfloat16:
        limit = limit + kernels.bf16_ulp(ref)
    assert bool(((got.double() - ref).abs() <= limit).all())
    if mode == "full":
        assert torch.equal(got, got.transpose(1, 2))


@pytest.mark.cuda
@F32_BF16
@pytest.mark.parametrize("D", [19, 613])
@pytest.mark.parametrize("R", [1, 31, 56, 300])
def test_cuda_corr_apply_expr_mirrors_its_tiles(card, R, D, store):
    """K8 "expr" on a symmetric P is bitwise symmetric: off the diagonal
    because tile (j, i) is written from tile (i, j)'s accumulator, and on
    each 64 x 64 diagonal tile by itself, whose lower entries are taken
    from its upper ones."""
    P, At, Bt = _corr_operands(card, D, R, store, 11 * R + D, symmetric=True)
    assert torch.equal(P, P.transpose(1, 2))
    got = kernels.corr_apply(P, At, Bt, "expr")
    for i0 in range(0, D, 64):
        blk = got[:, i0:i0 + 64, i0:i0 + 64]
        assert torch.equal(blk, blk.transpose(1, 2)), i0
    assert torch.equal(got, got.transpose(1, 2))


# --- K4 and K3 / K5 on the tile-pair panel product --------------------------

# A fused frame that adds features: up to 10 an instance (r = 60), frame 2
# adds 12 over the 3 instances.
ADD_CFG = {**CFG, "map": {**CFG["map"], "min_features_in_image": 24,
                          "max_new_per_step": 10}}


@pytest.fixture(scope="module")
def add_operands():
    """K3's f64 operands in frame 2 of ADD_CFG's fused step on the CPU."""
    cfg = EngineConfig.from_dict({**ADD_CFG, "dtype": "float64"})
    _, _, obs = simulate(torch.Generator().manual_seed(0), cfg, 3, "cpu")
    st = engine.bootstrap(init_state(cfg, B, "cpu"), obs.frame(0), cfg)
    u = torch.rand(3, B, cfg.ransac.num_hypotheses, dtype=torch.float64,
                   generator=torch.Generator().manual_seed(1))
    st, _ = engine.step(st, obs.frame(1), u[1], cfg)
    with kernels.capture_operands() as captured:
        engine.step(st, obs.frame(2), u[2], cfg)
    args = captured["fused_update_tail_add"][-1]
    assert args[5].shape[1] == 60 and bool((args[4] == 0).any())
    return args


@pytest.mark.cuda
def test_cuda_k3_is_bitwise_symmetric_on_a_symmetric_p(card, add_operands):
    """K3 on a frame with r = 60 and P symmetrized first: the output is
    bitwise symmetric — the downdate and the add mirrored a tile pair at a
    time, the renorm stripe's rows and columns summed in one order, the
    8 x 8 corner's lower entries from its upper ones — and within TOL of
    the plain version."""
    args = tuple(a.to(card, torch.float32) for a in add_operands)
    P = 0.5 * (args[0] + args[0].transpose(1, 2))
    assert torch.equal(P, P.transpose(1, 2))
    got = kernels.fused_update_tail_add(P, *args[1:])
    assert torch.equal(got, got.transpose(1, 2))
    ref = kernels.update_tail_add_plain(P.double(),
                                        *(a.double() for a in args[1:]))
    assert kernels.scaled_error(got, ref) <= TOL


@pytest.mark.cuda
def test_cuda_check_fails_k3_with_keep_all_ones(card, add_operands):
    """A planted fault: K3 launched with keepN all ones on a frame that
    adds features, P holding stale values in the new slots
    (kernels.stale_slots),
    against the plain version with the frame's keepN, reads far above
    TOL."""
    args = [a.to(card, torch.float32) for a in add_operands]
    args[0] = kernels.stale_slots(args[0], args[4])
    got = kernels.fused_update_tail_add(*args[:4], torch.ones_like(args[4]),
                                        *args[5:])
    ref = kernels.update_tail_add_plain(*(a.double() for a in args))
    assert kernels.scaled_error(got, ref) > 100 * TOL


@pytest.mark.cuda
@F32_BF16
@pytest.mark.parametrize("R", [1, 31, 264, 408])
def test_cuda_corr_apply_cols_takes_any_rank(card, R, store):
    """K4 at the bench's D = 613 from an asymmetric P: R below one
    contraction tile, odd, the bench's 264 and the full width's 408. Each
    entry within CHAIN_TOL of its scale |P| + |Pᵀ| + |A||B|ᵀ + |B||A|ᵀ
    (one bf16 ulp more on a bf16 output), bitwise symmetric, two launches
    bit for bit."""
    P = _randn(card, R, 2, 613, 613).to(store)
    A, Bf = _randn(card, R + 1, 2, 613, R), _randn(card, R + 2, 2, 613, R)
    got = kernels.corr_apply_cols(P, A, Bf)
    again = kernels.corr_apply_cols(P, A, Bf)
    torch.cuda.synchronize()
    assert got.dtype == store and torch.equal(got, again)
    assert torch.equal(got, got.transpose(1, 2))
    Pd, Ad, Bd = P.double(), A.double(), Bf.double()
    ref = kernels.corr_apply_cols_plain(Pd, Ad, Bd)
    C = Ad.abs() @ Bd.abs().transpose(1, 2)
    limit = CHAIN_TOL * (Pd.abs() + Pd.abs().transpose(1, 2) + C
                         + C.transpose(1, 2))
    if store == torch.bfloat16:
        limit = limit + kernels.bf16_ulp(ref)
    assert bool(((got.double() - ref).abs() <= limit).all())


@pytest.mark.cuda
@pytest.mark.parametrize("M2", [1, 128, 200])
@pytest.mark.parametrize("r", [0, 6, 60, 128])
def test_cuda_update_tail_takes_any_width(card, r, M2):
    """K5 (r = 0) and K3 at the bench's D = 613 on random operands (P and
    CN symmetric, the kernels' precondition; Jq4 near I; keepN mostly 1):
    M2 below one contraction tile, the bench's 128 and 200; r = 6K up to
    the limit 128. Each entry within CHAIN_TOL of its scale, bitwise
    symmetric, two launches bit for bit."""
    n = lambda seed, *shape: _randn(card, 97 * r + M2 + seed, *shape)
    P = n(0, 2, 613, 613)
    P = 0.5 * (P + P.transpose(1, 2))
    ops = [P, n(1, 2, 613, M2), n(2, 2, 613, M2),
           torch.eye(4, device=card) + 0.3 * n(3, 2, 4, 4)]
    if r:
        C = n(4, 2, r, r)
        ops += [(n(5, 2, 613) > -1).float(), n(6, 2, r, 613),
                n(7, 2, r, 613), 0.5 * (C + C.transpose(1, 2))]
    fn = kernels.fused_update_tail_add if r else kernels.fused_update_tail
    got = fn(*ops)
    again = fn(*ops)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got, got.transpose(1, 2))
    dops = [o.double() for o in ops]
    ref = (kernels.update_tail_add_plain if r
           else kernels.update_tail_plain)(*dops)
    limit = CHAIN_TOL * k3_scale(*dops)
    assert bool(((got.double() - ref).abs() <= limit).all())


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 200, 260])
def test_cuda_manage_predict_pht_takes_any_width(card, R):
    """K1 at the bench's D = 613, r = 6, on random operands (P, C66 and
    Q13 symmetric; F13 near I; keep mostly 1): R below one column group,
    the bench's 2·CAP = 200 (two 128-column chunks of the product) and 260
    (past the old stripe kernel's 256-column limit: three chunks).
    Both outputs within CHAIN_TOL of their scale, P⁻ bitwise symmetric,
    two launches bit for bit."""
    n = lambda seed, *shape: _randn(card, 31 * R + seed, *shape)
    P, C, Q = n(0, 2, 613, 613), n(1, 2, 6, 6), n(2, 2, 13, 13)
    ops = [0.5 * (P + P.transpose(1, 2)), (n(3, 2, 613) > -1).float(),
           n(4, 2, 6, 613), n(5, 2, 6, 613), 0.5 * (C + C.transpose(1, 2)),
           torch.eye(13, device=card) + 0.3 * n(6, 2, 13, 13),
           0.5 * (Q + Q.transpose(1, 2)), n(7, 2, 613, R)]
    got = kernels.fused_manage_predict_pht(*ops)
    again = kernels.fused_manage_predict_pht(*ops)
    torch.cuda.synchronize()
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    assert got[1].shape == (2, 613, R)
    assert torch.equal(got[0], got[0].transpose(1, 2))
    dops = [o.double() for o in ops]
    ref = kernels.manage_predict_pht_plain(*dops)
    assert within(got, ref, k1_scale(*dops), CHAIN_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("M2", [1, 128])
@pytest.mark.parametrize("R", [1, 200, 260])
def test_cuda_update_tail_pht_takes_any_width(card, R, M2):
    """K2 at the bench's D = 613 on random operands (P symmetric, Jq4 near
    I): M2 below one contraction tile and the bench's 128, R as for K1.
    Both outputs within CHAIN_TOL of their scale, P_li bitwise symmetric,
    two launches bit for bit."""
    n = lambda seed, *shape: _randn(card, 97 * R + M2 + seed, *shape)
    P = n(0, 2, 613, 613)
    ops = [0.5 * (P + P.transpose(1, 2)), n(1, 2, 613, M2), n(2, 2, 613, M2),
           torch.eye(4, device=card) + 0.3 * n(3, 2, 4, 4), n(4, 2, 613, R)]
    got = kernels.fused_update_tail_pht(*ops)
    again = kernels.fused_update_tail_pht(*ops)
    torch.cuda.synchronize()
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    assert torch.equal(got[0], got[0].transpose(1, 2))
    dops = [o.double() for o in ops]
    ref = kernels.update_tail_pht_plain(*dops)
    scale = k3_scale(*dops[:4])
    assert within(got, ref, (scale, scale @ dops[4].abs()), CHAIN_TOL)


# --- the loop-closure path (models/, filter/loop_fusion.py) ------------------

def _loop_inputs(B=2, T=3, H=48, W=64):
    from ekf_slam_tpu_torch.models import vss
    gen = torch.Generator().manual_seed(11)
    imgs = torch.rand(T, B, H, W, 3, generator=gen)
    model = vss.VSS(vss.VSSConfig(width=8), (H, W),
                    torch.Generator().manual_seed(0))
    cfg = EngineConfig.from_dict(CFG)
    st = init_state(cfg, B, "cpu")
    return model, imgs, st.x, st.P


@pytest.mark.cuda
def test_cuda_vss_matches_cpu(card):
    """The VSS forward (every output) on the card against the CPU, f32:
    within 1e-4 of each output's largest magnitude (cuDNN's summation
    order; TF32 off), keypoints equal."""
    from ekf_slam_tpu_torch.models import keypoints
    torch.backends.cudnn.allow_tf32 = False
    model, imgs, _, _ = _loop_inputs()
    eps = torch.randn(2, 3, 4, 56, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref = model(imgs[0], eps=eps)
        got = model.to(card)(imgs[0].to(card), eps=eps.to(card))
    for k, r in ref.items():
        err = float((got[k].cpu() - r).abs().max())
        assert err <= 1e-4 * float(r.abs().max()), (k, err)
    assert torch.equal(keypoints.kp_descriptor(got["c5"]).yx.cpu(),
                       keypoints.kp_descriptor(ref["c5"]).yx)


@pytest.mark.cuda
def test_cuda_run_online_matches_cpu_and_counts_k4(card):
    """Three frames of run_online on the card (replayed) against the CPU
    with the same draws: equal declared / match_id, similarity within
    1e-5, x and P within 1e-5 of their scale; K4 and K6 (the masked pose
    constraint) and eight_point_fit (RANSAC's 8-point solve) launch once a
    frame and nothing else."""
    from ekf_slam_tpu_torch.models import loop_runner
    from ekf_slam_tpu_torch.models import loopclosure as lc
    model, imgs, x0, P0 = _loop_inputs()
    cfg = lc.LoopConfig(capacity=8, top_k=3, exclude_recent=1, min_db=1,
                        ransac_hypotheses=16, consistency_count=1)
    draws = torch.rand(3, 2, 3, 16, model.num_kp,
                       generator=torch.Generator().manual_seed(2))
    ref = loop_runner.run_online(model, imgs, x0, P0, cfg, draws,
                                 device="cpu")
    kernels.reset_launches()
    got = loop_runner.run_online(model, imgs, x0, P0, cfg, draws,
                                 device=card)
    torch.cuda.synchronize()
    want = {k: 0 for k in kernels.LAUNCHES}
    want.update(corr_apply_cols=3, f32_matmul_big=3, eight_point_fit=3)
    assert kernels.LAUNCHES == want
    for f in ("declared", "match_id"):
        assert torch.equal(getattr(got[3], f).cpu(), getattr(ref[3], f))
    s_got, s_ref = got[3].similarity.cpu(), ref[3].similarity
    fin = torch.isfinite(s_ref)
    assert torch.equal(torch.isfinite(s_got), fin)
    assert float((s_got - s_ref)[fin].abs().max()) <= 1e-5
    for a, b in ((got[1], ref[1]), (got[2], ref[2])):
        assert float((a.cpu() - b).abs().max()) <= 1e-5 * float(
            b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("N, scale", [(1, 1.0), (448, 1.0), (1792, 1.0),
                                      (1792, 2.0 ** 40), (1792, 2.0 ** -40)])
def test_cuda_eight_point_fit_matches_plain(card, N, scale):
    """eight_point_fit on N systems (one; the loop gate's 448, B = 1; the
    loop path's 1,792, also scaled by 2^±40) against its plain version at
    f64: within kernels.EIGHT_POINT_TOL of each F₂'s perturbation bound,
    its eigenvectors within EIGHT_POINT_RAYLEIGH_TOL of λ₁ (and the launch
    without them writes the same F₂); one launch a call. A power-of-two
    scale is undone exactly by the kernel's own: the same bits as the
    unscaled systems'."""
    M0 = ep_systems("cpu")[:N].contiguous()
    M = M0 * scale
    ref = kernels.eight_point_fit_plain(M.double())
    before = kernels.LAUNCHES["eight_point_fit"]
    got = kernels.eight_point_fit(M.to(card)).cpu()
    assert kernels.LAUNCHES["eight_point_fit"] == before + 1
    assert kernels.eight_point_error(got, ref, M) <= kernels.EIGHT_POINT_TOL
    F2, f = kernels.eight_point_fit(M.to(card), eigvec=True)
    assert torch.equal(F2.cpu(), got)
    assert (kernels.eight_point_rayleigh(f.cpu(), M)
            <= kernels.EIGHT_POINT_RAYLEIGH_TOL)
    if scale != 1.0:
        assert torch.equal(kernels.eight_point_fit(M0.to(card)).cpu(), got)


@pytest.mark.cuda
def test_cuda_eight_point_fit_alone_equals_batch(card):
    """Each of 1,792 systems launched alone (N = 1) gives the bits of its
    slot in the batched launch, F₂ and f (the three matrices of a warp
    solve together, each frozen once it has converged), and a second
    batched launch the same bits again."""
    M = ep_systems("cpu").to(card)
    F2, f = kernels.eight_point_fit(M, eigvec=True)
    again = kernels.eight_point_fit(M, eigvec=True)
    alone = [kernels.eight_point_fit(M[n:n + 1], eigvec=True)
             for n in range(M.shape[0])]
    for got, want in ((torch.cat([a[0] for a in alone]), F2),
                      (torch.cat([a[1] for a in alone]), f),
                      (again[0], F2), (again[1], f)):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_cuda_eight_point_check_fails_largest_eigenvector(card):
    """The kernel on −M (the eigenvector of M's largest eigenvalue) must
    read > 100x the Rayleigh limit, and above the eigengap one (these
    near-degenerate systems let no O(1) fault read 100 eigengap bounds)."""
    M = ep_systems("cpu", 1)
    ref = kernels.eight_point_fit_plain(M.double())
    F2, f = kernels.eight_point_fit((-M).to(card), eigvec=True)
    assert (kernels.eight_point_rayleigh(f.cpu(), M)
            > 100 * kernels.EIGHT_POINT_RAYLEIGH_TOL)
    assert (kernels.eight_point_error(F2.cpu(), ref, M)
            > kernels.EIGHT_POINT_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 33, 1792])
def test_cuda_eight_point_fit_is_nan_where_not_finite(card, N):
    """NaN, +inf and −inf entries on every third system: those F₂ all NaN,
    the others bit for bit the kernel's on the finite systems alone (the
    launch's staging and ragged last block)."""
    M = ep_systems("cpu", 2)[:N].clone()
    bad = torch.arange(N) % 3 == 0
    for i in torch.nonzero(bad)[:, 0].tolist():
        M[i, i % 9, (2 * i) % 9] = (torch.nan, torch.inf, -torch.inf)[i % 3]
    got = kernels.eight_point_fit(M.to(card)).cpu()
    assert torch.isnan(got[bad]).all()
    if bool((~bad).any()):
        alone = kernels.eight_point_fit(M[~bad].to(card)).cpu()
        assert torch.equal(got[~bad].view(torch.int32),
                           alone.view(torch.int32))


@pytest.mark.cuda
def test_cuda_eight_point_wrapper_rejects(card):
    M = ep_systems("cpu")[:40].to(card)
    with pytest.raises(TypeError, match="float32"):
        kernels.eight_point_fit(M.double())
    with pytest.raises(ValueError, match="shape"):
        kernels.eight_point_fit(M[:, :8])
    with pytest.raises(ValueError, match="contiguous"):
        kernels.eight_point_fit(M.transpose(1, 2))
    with pytest.raises(RuntimeError, match="cudaError_t 1"):
        kernels.eight_point_fit(M[:0])


@pytest.mark.cuda
def test_replayed_run_online_equals_eager(card):
    """run_online's default on the card (one loop frame captured and
    replayed; the ring's store used in place) against eager=True from the
    same generator state, 6 frames at width 8: every LoopStepOut field, x,
    P and every database field bit for bit; the same launches."""
    from ekf_slam_tpu_torch.filter import graph
    from ekf_slam_tpu_torch.models import loop_runner
    from ekf_slam_tpu_torch.models import loopclosure as lc
    torch.backends.cudnn.allow_tf32 = False
    model, imgs, x0, P0 = _loop_inputs(T=6)
    cfg = lc.LoopConfig(capacity=8, top_k=3, exclude_recent=1, min_db=1,
                        ransac_hypotheses=16, consistency_count=1)
    gen = torch.Generator(device=card)
    runs = {}
    for eager in (True, None):
        kernels.reset_launches()
        runs[eager] = loop_runner.run_online(
            model, imgs, x0, P0, cfg, generator=gen.manual_seed(7),
            device=card, eager=eager)
        torch.cuda.synchronize()
        runs[eager, "launches"] = dict(kernels.LAUNCHES)
    assert runs[True, "launches"] == runs[None, "launches"]
    assert runs[None, "launches"]["eight_point_fit"] == 6
    assert graph.last_capture_s() > 0
    (db_e, x_e, P_e, o_e), (db_r, x_r, P_r, o_r) = runs[True], runs[None]
    _same_bits([getattr(db_r, f) for f in lc.DB_FIELDS] + [x_r, P_r]
               + list(o_r), [getattr(db_e, f) for f in lc.DB_FIELDS]
               + [x_e, P_e] + list(o_e))


@pytest.mark.cuda
def test_cuda_eager_loop_frame_syncs_nothing(card):
    """One eager loop frame on the card (after a warm frame) under
    torch.cuda.set_sync_debug_mode("error"): no call waits for the card."""
    from ekf_slam_tpu_torch.models import loop_runner
    from ekf_slam_tpu_torch.models import loopclosure as lc
    model, imgs, x0, P0 = _loop_inputs()
    cfg = lc.LoopConfig(capacity=8, top_k=3, exclude_recent=1, min_db=1,
                        ransac_hypotheses=16, consistency_count=1)
    _, x, P, frame, db = loop_runner._setup(model, x0, P0, cfg, 0.05, card,
                                            None)
    imgs = imgs.to(card)
    draws = torch.rand(2, 2, 3, 16, model.num_kp, device=card)
    db, x, P, _ = frame(db, x, P, imgs[0], draws[0])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        frame(db, x, P, imgs[1], draws[1])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 3, 128])
def test_cuda_spd_inverse_is_nan_where_indefinite(card, n):
    """ekf._spd_inverse of a batch mixing SPD and indefinite S on the
    card: all NaN exactly on the indefinite entries, whatever partial
    factor cuSOLVER leaves; the CPU's inverse elsewhere (1e-4 of its
    largest entry, f32)."""
    A = torch.randn(4, n, n, generator=torch.Generator().manual_seed(n))
    S = A @ A.transpose(1, 2) / n + torch.eye(n)
    S[1, 0, 0] = -1.0
    S[3, n - 1, n - 1] = -1.0
    got = ekf._spd_inverse(S.to(card)).cpu()
    ref = ekf._spd_inverse(S)
    nan = torch.isnan(got).flatten(1).all(1)
    assert nan.tolist() == [False, True, False, True]
    assert torch.isfinite(got[[0, 2]]).all()
    assert torch.equal(torch.isnan(ref), torch.isnan(got))
    assert float((got[[0, 2]] - ref[[0, 2]]).abs().max()) <= 1e-4 * float(
        ref[[0, 2]].abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("severity", [0.0, 1.0])
def test_cuda_train_step_matches_cpu(card, severity):
    """One CALC2 train step (width 8, 48x64, batch 4, cropped from 56x72)
    with the same weights and draws on the card and on the CPU, f32, TF32
    off: the metrics within 1e-4 relative, Adam's first moment within
    2e-3 of each tensor's largest entry, the running statistics within
    1e-4 of their scale."""
    import copy

    from ekf_slam_tpu_torch.data import synthetic
    from ekf_slam_tpu_torch.models import train
    from ekf_slam_tpu_torch.models.vss import VSS, VSSConfig
    torch.backends.cudnn.allow_tf32 = False
    tcfg = train.TrainConfig(batch_size=4, image_hw=(48, 64),
                             aug_severity=severity)
    base = VSS(VSSConfig(width=8), (48, 64), torch.Generator().manual_seed(3))
    imgs, labels = synthetic.synthetic_batch(
        4, (56, 72), generator=torch.Generator().manual_seed(4))
    w = synthetic.class_weights(labels)
    d = train.train_draws(tcfg, base, imgs.shape,
                          torch.Generator().manual_seed(5), "cpu")
    out = []
    for dev, draws in (("cpu", d), (card, d.to(card))):
        st = train.init_state(copy.deepcopy(base).to(dev), tcfg)
        st, m = train.train_step(tcfg, st, imgs.to(dev), labels.to(dev),
                                 w.to(dev), draws)
        out.append((st, m))
    (s_cpu, m_cpu), (s_card, m_card) = out
    for k, v in m_cpu.items():
        assert abs(float(m_card[k]) - float(v)) <= 1e-4 * abs(float(v)), k
    cpu_p = dict(s_cpu.model.named_parameters())
    for name, p in s_card.model.named_parameters():
        a = s_card.optimizer.state[p]["exp_avg"].cpu()
        b = s_cpu.optimizer.state[cpu_p[name]]["exp_avg"]
        assert float((a - b).abs().max()) <= 2e-3 * float(b.abs().max()), \
            name
    cpu_sd = s_cpu.model.state_dict()
    for k, v in s_card.model.state_dict().items():
        if "running" in k:
            assert float((v.cpu() - cpu_sd[k]).abs().max()) <= 1e-4 * max(
                float(cpu_sd[k].abs().max()), 1.0), k


@pytest.mark.cuda
@F32_BF16
@pytest.mark.parametrize("r0", [0, 307])
def test_cuda_corr_apply_rows_is_the_slab_of_k8_none(card, r0, store):
    """K8's row-slab form at the sim config's slab (B = 2 instances,
    D = 613 padded to 614 and split two ways: rows r0 .. r0+306, R = 264,
    the folded tail's factor rows): bit for bit the rows of K8 "none" on
    the whole P (the same fmaf chains), and each entry within CHAIN_TOL
    of its scale |P| + |At|ᵀ|Bt| against the f64 plain version (one bf16
    ulp more on a bf16 slab); one launch a call."""
    Dp, Dl, R = 614, 307, 264
    P = _randn(card, 3, 2, Dp, Dp).to(store)
    At, Bt = _randn(card, 4, 2, R, Dp), _randn(card, 5, 2, R, Dp)
    slab = P[:, r0:r0 + Dl].contiguous()
    before = kernels.LAUNCHES["corr_apply_rows"]
    got = kernels.corr_apply_rows(slab, At, Bt, r0)
    whole = kernels.corr_apply(P, At, Bt, "none")
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["corr_apply_rows"] == before + 1
    assert got.dtype == store and torch.equal(got, whole[:, r0:r0 + Dl])
    ref = kernels.corr_apply_rows_plain(slab.double(), At.double(),
                                        Bt.double(), r0)
    limit = CHAIN_TOL * (slab.double().abs() + At.double().abs()[
        :, :, r0:r0 + Dl].transpose(1, 2) @ Bt.double().abs())
    if store == torch.bfloat16:
        limit = limit + kernels.bf16_ulp(ref)
    assert bool(((got.double() - ref).abs() <= limit).all())


@pytest.mark.cuda
def test_cuda_sharded_step_frame_on_two_gloo_ranks(card):
    """Two frames of the row-sharded step on 2 gloo ranks sharing the
    card (data 1 x model 2, CUDA tensors through gloo) at this file's
    config with the unfused step, against the single-device unfused step
    on the card: gate counts equal, x within 1e-3 of max|x|, P entrywise
    within 1e-2 of its Cauchy-Schwarz bounds (phase 5's tolerances); K6
    three and K8's slab form two launches a frame on each rank."""
    import numpy as np

    from ekf_slam_tpu_torch.filter.state import state_to_numpy
    from ekf_slam_tpu_torch.parallel import mesh as pmesh
    from torch_parallel_ranks import tp_rank

    d = {**CFG, "filter": {"fused_step": "off"}, "dtype": "float32"}
    cfg = EngineConfig.from_dict(d)
    _, _, obs = simulate(torch.Generator().manual_seed(0), cfg, 3, "cpu")
    st = engine.bootstrap(init_state(cfg, B, "cpu"), obs.frame(0), cfg)
    u = torch.rand(3, B, cfg.ransac.num_hypotheses,
                   generator=torch.Generator().manual_seed(1))
    ranks = pmesh.spawn(tp_rank, 2, "gloo", d, state_to_numpy(st),
                        obs.pixels.numpy(), obs.visible.numpy(), u.numpy(),
                        1, 2, "cuda")
    ref, infos = st.to(card), []
    for t in (1, 2):
        ref, info = engine.step(ref, obs.frame(t).to(card), u[t].to(card),
                                cfg)
        infos.append(info)
    x, P = ref.x.cpu().numpy(), ref.P.cpu().double()
    for r in ranks:
        for t, info in enumerate(infos):
            for f in ("n_visible", "n_ic", "n_li", "n_hi"):
                np.testing.assert_array_equal(r["counts"][t][f],
                                              getattr(info, f).cpu().numpy())
        assert np.abs(r["state"]["x"] - x).max() <= 1e-3 * np.abs(x).max()
        assert kernels.scaled_error(torch.tensor(r["state"]["P"]).double(),
                                    P) <= 1e-2
        assert r["launches"]["f32_matmul_big"] == 3 * 2
        assert r["launches"]["corr_apply_rows"] == 2 * 2
        assert sum(r["launches"].values()) == 10


# --- the captured frame (filter/graph.py) against the eager loop ------------

def _bits(t):
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return t.view(ints[t.dtype]) if t.dtype in ints else t


def _same_bits(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


# route -> (filter settings, ekf._UPDATE); each at f32 on the card
GRAPH_ROUTES = {
    "fused": ({"fused_step": "on"}, "cols"),
    "unfused_i": ({"fused_step": "off", "pallas_update": "off"}, "cols"),
    "unfused_ii": ({"fused_step": "off", "pallas_update": "on"}, "cols"),
    "rows": ({"fused_step": "off", "pallas_update": "off"}, "rows"),
    "iekf": ({"fused_step": "off", "use_iterated_update": True}, "cols"),
    "bf16": ({"fused_step": "off", "gain_solver": "newton",
              "p_storage": "bf16"}, "cols"),
    "bf16_rows": ({"fused_step": "off", "gain_solver": "newton",
                   "p_storage": "bf16"}, "rows"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("route", sorted(GRAPH_ROUTES))
def test_replayed_sequence_equals_eager(card, route):
    """run_sequence's default on the card (one frame captured and
    replayed) against eager=True from the same inputs: final state,
    trajectory and StepInfo bit for bit, the same launch counts; a second
    call replays without capturing again."""
    from ekf_slam_tpu_torch.filter import graph
    filt, update = GRAPH_ROUTES[route]
    cfg, obs, st, u = _sequence("float32", **filt)
    st, obs, u = st.to(card), obs.to(card), u.to(card, torch.float32)
    with mock.patch.object(ekf, "_UPDATE", update):
        kernels.reset_launches()
        want = engine.run_sequence(st, obs, u, cfg, eager=True)
        eager_counts = dict(kernels.LAUNCHES)
        kernels.reset_launches()
        got = engine.run_sequence(st, obs, u, cfg)
        frame = graph.last_captured()
        again = engine.run_sequence(st, obs, u, cfg)
        assert graph.last_captured() is frame
    assert {k: 2 * v for k, v in eager_counts.items()} == kernels.LAUNCHES
    assert sum(eager_counts.values()) > 0
    for res in (got, again):
        _same_bits([getattr(res[0], f) for f in ("x", "P", "active",
                                                  "landmark_id")]
                   + [res[1]] + [getattr(res[2], f) for f in (
                       "n_ic", "n_li", "n_hi", "ransac_support")],
                   [getattr(want[0], f) for f in ("x", "P", "active",
                                                   "landmark_id")]
                   + [want[1]] + [getattr(want[2], f) for f in (
                       "n_ic", "n_li", "n_hi", "ransac_support")])


@pytest.mark.cuda
@pytest.mark.parametrize("matcher,warp", [("ncc", "affine"),
                                          ("ncc", "exact"),
                                          ("ncc", "none"),
                                          ("descriptor", "affine")])
def test_replayed_images_equal_eager(card, matcher, warp):
    """run_images' default on the card against eager=True from the same
    inputs, bit for bit, at the image tests' config."""
    cfg = EngineConfig.from_dict({**IMAGE, "vision": {
        **IMAGE["vision"], "matcher": matcher, "warp_distortion": warp},
        "dtype": "float32"})
    scn, xs, _ = simulate(torch.Generator().manual_seed(0), cfg, 3, "cpu")
    imgs = torch.stack([frontend.render_scene_image(scn, xs[t], cfg, "cpu")
                        for t in range(3)])
    u = torch.rand(3, B, cfg.ransac.num_hypotheses,
                   generator=torch.Generator().manual_seed(1))
    st = init_state(cfg, B, card)
    app = frontend.init_appearance(cfg, B, card)
    want = frontend.run_images(st, app, imgs, u, cfg, card, eager=True)
    got = frontend.run_images(st, app, imgs, u, cfg, card)
    _same_bits([got[0].x, got[0].P, got[1].patches, got[1].descr, got[2],
                got[3].n_ic, got[3].n_li, got[3].search_r_needed],
               [want[0].x, want[0].P, want[1].patches, want[1].descr,
                want[2], want[3].n_ic, want[3].n_li,
                want[3].search_r_needed])


@pytest.mark.cuda
@pytest.mark.parametrize("argv,lcfg", [
    (["--frontend", "sim", "--traj", "outback", "--sim-threshold", "0.5",
      "--min-inliers", "8"], {}),
    (["--frontend", "pixels", "--traj", "pan", "--sim-threshold", "0.5",
      "--min-inliers", "8", "--lc-severity", "0.3"],
     {"consistency_count": 1})], ids=["sim", "pixels"])
def test_replayed_loop_harness_equals_eager(card, argv, lcfg):
    """run_loop_closure.run with its three pieces replayed against the
    eager pieces, 8 frames at CAP 48: trajectory and loops bit for bit,
    a loop declared, the same launches."""
    import dataclasses

    from ekf_slam_tpu_torch import run_loop_closure
    h = run_loop_closure.build_harness(run_loop_closure.parse_args(
        argv + ["--frames", "8"]), card)
    h = dataclasses.replace(h, lcfg=dataclasses.replace(h.lcfg, **lcfg))
    runs = {}
    for capture in (None, True):
        kernels.reset_launches()
        runs[capture] = run_loop_closure.run(h, 0, True, capture)
        torch.cuda.synchronize()
        runs[capture, "launches"] = dict(kernels.LAUNCHES)
    assert runs[None, "launches"] == runs[True, "launches"]
    assert runs[True][1] == runs[None][1] and runs[True][1]
    assert runs[True][0].tobytes() == runs[None][0].tobytes()


@pytest.mark.cuda
def test_replayed_embed_equals_eager(card):
    """evaluate.embed's default on the card (one capture a batch shape)
    against eager=True: 5 images in batches of 2, with keypoints, bit for
    bit; a second call replays the kept captures."""
    from ekf_slam_tpu_torch.filter import graph
    from ekf_slam_tpu_torch.models import evaluate, vss
    torch.backends.cudnn.allow_tf32 = False
    model = vss.VSS(vss.VSSConfig(width=8), (48, 64)).to(card)
    imgs = torch.rand(5, 48, 64, 3, generator=torch.Generator().manual_seed(1))
    want = evaluate.embed(model, imgs, 2, with_keypoints=True, eager=True)
    got = evaluate.embed(model, imgs, 2, with_keypoints=True)
    capture_s = graph.last_capture_s()
    again = evaluate.embed(model, imgs, 2, with_keypoints=True)
    assert graph.last_capture_s() == capture_s
    _same_bits([got[0], *got[1], again[0]], [want[0], *want[1], want[0]])


@pytest.mark.cuda
def test_replayed_sim_frame_marks_its_spans(card):
    """The fused sim frame replayed under torch.profiler: each frame's 18
    device marks (csrc/spans.cu, captured with the frame) carry the span
    table's ids in the order the frame begins and ends them; the outputs
    equal an unprofiled replay bit for bit; the device time of the seven
    stage spans and frame.carry sums within 2% of the frame's; no span
    leaves an event of its own name on the device."""
    import re

    from torch.autograd import DeviceType

    from ekf_slam_tpu_torch.utils.metrics import SPANS
    inner = ("sim.manage_predict", "sim.linearize_ic", "sim.ransac",
             "sim.li_update", "sim.hi_rescue", "sim.hi_update", "sim.init",
             "frame.carry")
    ids = [SPANS.index(n) for n in inner]
    frame_id = SPANS.index("frame")
    one = ([(frame_id, 0)] + [m for i in ids for m in ((i, 0), (i, 1))]
           + [(frame_id, 1)])
    cfg, obs, st, u = _sequence("float32", fused_step="on")
    st, obs, u = st.to(card), obs.to(card), u.to(card, torch.float32)
    T = obs.pixels.shape[0]
    want = engine.run_sequence(st, obs, u, cfg)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        got = engine.run_sequence(st, obs, u, cfg)
        torch.cuda.synchronize()
    _same_bits([got[0].x, got[0].P, got[1], got[2].n_li],
               [want[0].x, want[0].P, want[1], want[2].n_li])
    device = sorted(((e.name, e.time_range.start, e.time_range.end)
                     for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda d: d[1])
    assert not {n for n, _, _ in device} & set(SPANS)
    pattern = re.compile(r"\bspan_mark<(\d+), (\d+)>")
    found = [(i, pattern.search(n)) for i, (n, _, _) in enumerate(device)]
    marks = [(i, (int(m.group(1)), int(m.group(2))))
             for i, m in found if m]
    assert [m for _, m in marks] == one * T

    def union_us(begin, end):
        total, reach = 0.0, float("-inf")
        for s, e in sorted((s, e) for n, s, e in device[begin + 1:end]
                           if not pattern.search(n)):
            total += max(0.0, e - max(s, reach))
            reach = max(reach, e)
        return total

    for f in range(T):
        at = {m: i for i, m in marks[f * 18:(f + 1) * 18]}
        frame_us = union_us(at[frame_id, 0], at[frame_id, 1])
        parts = sum(union_us(at[i, 0], at[i, 1]) for i in ids)
        assert frame_us > 0 and abs(parts - frame_us) <= 0.02 * frame_us
