"""The hand-written CUDA kernels K1-K8 on the card, against their plain
versions, and one frame of each engine path and of the image path on the
card against the same frame on the CPU. Every test needs a CUDA device and
skips without one.

This file imports neither JAX nor the JAX package (the machine with the
card has no JAX); run it there without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Operands are the kernels' real operands in one frame of the port at a
small config (CAP 24: D = 157, 2·CAP = 48, 2M = 32, rank 6K = 48): K1-K3
from the fused step, K4 and K6 from the unfused step, K5 from the unfused
step with pallas_update="on"; K7 from the image step at
tests/test_vision.py's pixels config (CAP 24, R = 10: N = B·24 pairs of
33x33 windows and 13x13 templates); K8, and K4 / K6 on a bf16 P, from the
bf16-P fast mode's unfused step at f32 (row form for K8, 2M + 8 = 40
factor rows)."""

from unittest import mock

import pytest
import torch

from ekf_slam_tpu_torch.config import EngineConfig
from ekf_slam_tpu_torch.filter import ekf, engine
from ekf_slam_tpu_torch.filter.state import init_state
from ekf_slam_tpu_torch.ops import kernels
from ekf_slam_tpu_torch.sim import simulate
from ekf_slam_tpu_torch.vision import frontend

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
    mirrors away from the 8x8 renorm corner."""
    args = tuple(a.to(card, torch.float32)
                 for a in operands["fused_update_tail_pht"])
    P = args[0]
    args = (0.5 * (P + P.transpose(1, 2)),) + args[1:]
    out, _ = kernels.fused_update_tail_pht(*args)
    asym = (out - out.transpose(1, 2))[:, 8:, 8:]
    assert float(asym.abs().max()) == 0.0


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
    """R = 2·CAP > 256 for K1, rank > 128 for K3: the launcher returns
    cudaErrorInvalidValue and the wrapper raises."""
    args = [a.to(card, torch.float32)
            for a in operands["fused_manage_predict_pht"]]
    args[7] = torch.zeros(*args[7].shape[:2], 260, device=card)
    with pytest.raises(RuntimeError, match="cudaError_t 1"):
        kernels.fused_manage_predict_pht(*args)
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
    image path on the CPU."""
    cfg, st, app, imgs, u = _image_sequence("float64")
    st, app, _, _ = frontend.run_images(st, app, imgs[:2], u[:2], cfg, "cpu")
    with kernels.capture_operands() as captured:
        frontend.step_image(st, app, imgs[2], u[2], cfg)
    return captured["ncc_corr"][0]


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


@pytest.mark.cuda
def test_cuda_image_step_matches_cpu_step(card):
    """One f32 image frame (NCC matcher) with CUDA tensors against the same
    frame on the CPU, at the tolerances of test_cuda_step_matches_cpu_step;
    K7 launched once, K4 twice, K6 three times."""
    cfg, st, app, imgs, u = _image_sequence("float32")
    st, app, _, _ = frontend.run_images(st, app, imgs[:2], u[:2], cfg, "cpu")
    kernels.reset_launches()
    s_gpu, _, i_gpu = frontend.step_image(st.to(card), app.to(card),
                                          imgs[2].to(card), u[2].to(card),
                                          cfg)
    s_cpu, _, i_cpu = frontend.step_image(st, app, imgs[2], u[2], cfg)
    assert kernels.LAUNCHES == {
        k: {"ncc_corr": 1, "corr_apply_cols": 2, "f32_matmul_big": 3}.get(
            k, 0) for k in kernels.LAUNCHES}
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
