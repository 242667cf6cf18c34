"""K7 of the port — the NCC matcher's correlation numerator, ncc_corr, and
its norms form, ncc_corr_norms, which also returns the patch variances and
window energies — against the JAX Pallas kernel, JAX's f64 norms and an
f64 formula.

Inputs are windows and zero-mean templates made from a seeded numpy
generator at the image path's shape (W2 = 37, t = 13: R = 12, the 13x13
matching patch) and at a second one (W2 = 23, t = 7). N = 7 stays inside
one of the Pallas kernel's 128-lane pair groups, N = 130 crosses into a
padded second one.

On CPU tensors the wrapper runs the plain version. The Pallas kernel
computes in f32, so the plain version is held to it at f32, in interpret
mode, each entry in units of its Cauchy-Schwarz bound (kernels.ncc_error)
within 1e-6: the same 169-term f32 sum, whose rounding reads ~1e-7 in
those units. The plain version is held to the f64 formula (numpy's
sliding windows and one einsum) to rtol 1e-12 / atol 1e-13: the same math
in another order at f64. The norms form's plain version is held to JAX's
f64 norms (integral images of the raw windows, ekf_slam_tpu/vision/ncc.py
_boxsum) within 1e-12 of each pair's Σwc²: the port centres the windows
first, the same variance in exact arithmetic. ncc_scores_all, which now
takes its numerator and norms from ncc_corr_norms, is held bit for bit to
the composition it replaced."""

import jax
import numpy as np
import pytest
import torch

from ekf_slam_tpu.ops import pallas_kernels as pk
from ekf_slam_tpu.vision import ncc as jncc
from torch_parity import interpret_mode

from ekf_slam_tpu_torch.ops import kernels
from ekf_slam_tpu_torch.vision import ncc

torch.set_num_threads(1)

SHAPES = [(7, 37, 13), (130, 37, 13), (7, 23, 7)]
IDS = ["N7_W37_t13", "N130_W37_t13", "N7_W23_t7"]


def _operands(N, W2, t, seed=0):
    """Windows in [0, 1] (image intensities) and zero-mean templates, f64
    numpy."""
    rng = np.random.default_rng(seed)
    win = rng.uniform(0.0, 1.0, (N, W2, W2))
    tm = rng.uniform(0.0, 1.0, (N, t, t))
    return win, tm - tm.mean(axis=(1, 2), keepdims=True)


def _formula(win, tm):
    """f64 out[n,oy,ox] = Σ win[n,oy+dy,ox+dx]·tm[n,dy,dx] (numpy)."""
    t = tm.shape[-1]
    patches = np.lib.stride_tricks.sliding_window_view(win, (t, t),
                                                       axis=(1, 2))
    return np.einsum("nyxab,nab->nyx", patches, tm)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_plain_matches_pallas_interpret_f32(shape):
    win, tm = _operands(*shape)
    w32, t32 = win.astype(np.float32), tm.astype(np.float32)
    with interpret_mode():
        want = np.asarray(jax.jit(pk.ncc_corr)(w32, t32))
    got = kernels.ncc_corr(torch.tensor(w32), torch.tensor(t32))
    N, W2, t = shape
    assert got.shape == want.shape == (N, W2 - t + 1, W2 - t + 1)
    assert got.dtype == torch.float32
    assert kernels.ncc_error(got, torch.tensor(want), torch.tensor(w32),
                             torch.tensor(t32)) <= 1e-6


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_plain_matches_f64_formula(shape):
    win, tm = _operands(*shape, seed=1)
    got = kernels.ncc_corr_plain(torch.tensor(win), torch.tensor(tm))
    np.testing.assert_allclose(got.numpy(), _formula(win, tm), rtol=1e-12,
                               atol=1e-13)


def test_error_sees_a_transposed_template():
    """The check of chip_smoke.py: f32 rounding reads far below the limit,
    the template transposed (the taps' dy and dx swapped) far above it."""
    win, tm = (torch.tensor(a) for a in _operands(64, 37, 13, seed=2))
    ref = kernels.ncc_corr_plain(win, tm)
    f32 = kernels.ncc_corr_plain(win.float(), tm.float())
    assert kernels.ncc_error(f32, ref, win, tm) <= kernels.SCALED_TOL / 100
    fault = kernels.ncc_corr_plain(win, tm.transpose(1, 2).contiguous())
    assert kernels.ncc_error(fault, ref, win, tm) > 100 * kernels.SCALED_TOL


def test_error_sees_a_single_wrong_tap():
    """One offset of one pair off by 1e-3 of its bound reads 1e-3."""
    win, tm = (torch.tensor(a) for a in _operands(8, 23, 7, seed=3))
    ref = kernels.ncc_corr_plain(win, tm)
    bad = ref.clone()
    bound = (float(torch.linalg.vector_norm(win[5, 2:9, 4:11]))
             * float(torch.linalg.vector_norm(tm[5])))
    bad[5, 2, 4] += 1e-3 * bound
    assert kernels.ncc_error(bad, ref, win, tm) == pytest.approx(1e-3)


def test_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    win, tm = (torch.tensor(a) for a in _operands(4, 23, 7, seed=4))
    before = kernels.LAUNCHES["ncc_corr"]
    torch.testing.assert_close(kernels.ncc_corr(win, tm),
                               kernels.ncc_corr_plain(win, tm), rtol=0,
                               atol=0)
    assert kernels.LAUNCHES["ncc_corr"] == before


@pytest.mark.parametrize("bad", ["pairs", "template_wider", "strided"])
def test_wrapper_rejects_bad_operands(bad):
    win, tm = (torch.tensor(a) for a in _operands(4, 23, 7, seed=5))
    if bad == "pairs":
        args, err = (win, tm[:3]), "shape"
    elif bad == "template_wider":
        args, err = (win[:, :5, :5].contiguous(), tm), "wider"
    else:
        args, err = (win.transpose(1, 2), tm), "contiguous"
    with pytest.raises(ValueError, match=err):
        kernels.ncc_corr(*args)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_norms_plain_matches_jax_f64_norms(shape):
    """var and energy of ncc_corr_norms_plain against JAX's f64 norms of
    the same windows (ncc_scores_all's integral images of the raw window,
    var = max(sq − box²/t², 0)) within 1e-12 of each pair's Σwc²; the
    energy against numpy's Σ(w − mean)² to 1e-12 of itself."""
    win, tm = _operands(*shape, seed=6)
    N, W2, t = shape
    R2 = W2 - t + 1
    box = np.asarray(jncc._boxsum(win, t, R2))
    sq = np.asarray(jncc._boxsum(win * win, t, R2))
    want_var = np.maximum(sq - box * box / (t * t), 0.0)
    wc = win - win.mean(axis=(1, 2), keepdims=True)
    want_energy = (wc * wc).sum(axis=(1, 2))
    corr, var, energy = kernels.ncc_corr_norms_plain(torch.tensor(win),
                                                     torch.tensor(tm))
    assert var.shape == corr.shape == (N, R2, R2) and energy.shape == (N,)
    assert var.dtype == energy.dtype == torch.float64
    err = np.abs(var.numpy() - want_var) / want_energy[:, None, None]
    assert err.max() <= 1e-12
    np.testing.assert_allclose(energy.numpy(), want_energy, rtol=1e-12,
                               atol=0)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_norms_plain_corr_matches_pallas_interpret_f32(shape):
    """The norms form's correlation is K7's: against the Pallas kernel in
    interpret mode as test_plain_matches_pallas_interpret_f32 holds it."""
    win, tm = _operands(*shape, seed=7)
    w32, t32 = win.astype(np.float32), tm.astype(np.float32)
    with interpret_mode():
        want = np.asarray(jax.jit(pk.ncc_corr)(w32, t32))
    corr, _, _ = kernels.ncc_corr_norms_plain(torch.tensor(w32),
                                              torch.tensor(t32))
    assert corr.dtype == torch.float32
    assert kernels.ncc_error(corr, torch.tensor(want), torch.tensor(w32),
                             torch.tensor(t32)) <= 1e-6


def _boxsum_integral(x, t, R2):
    """The integral-image box sums vision/ncc.py computed before the norms
    moved into K7, kept here as the fixed reference."""
    ii = torch.cumsum(torch.cumsum(x, dim=-2), dim=-1)
    ii = torch.nn.functional.pad(ii, (1, 0, 1, 0))
    return (ii[..., t:t + R2, t:t + R2] - ii[..., 0:R2, t:t + R2]
            - ii[..., t:t + R2, 0:R2] + ii[..., 0:R2, 0:R2])


def _scores_composed(windows, templates):
    """ncc_scores_all as the image path composed it before: ncc_corr_plain
    beside the integral-image patch variance of the centred windows."""
    t = templates.shape[-1]
    R2 = windows.shape[-1] - t + 1
    tm = templates - templates.mean(dim=(-2, -1), keepdim=True)
    tnorm = torch.sqrt((tm * tm).sum(dim=(-2, -1)) + 1e-12)
    corr = kernels.ncc_corr_plain(windows, tm)
    wc = windows - windows.mean(dim=(-2, -1), keepdim=True)
    box = _boxsum_integral(wc, t, R2)
    sq = _boxsum_integral(wc * wc, t, R2)
    var = torch.clamp(sq - box * box / (t * t), min=0.0)
    energy = (wc * wc).sum(dim=(-2, -1))
    floor = (ncc.FLAT_EPS * torch.finfo(windows.dtype).eps
             * energy)[:, None, None]
    scores = corr / (torch.sqrt(var + 1e-12) * tnorm[:, None, None])
    return torch.where(var > floor, scores, torch.zeros_like(scores))


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_scores_on_cpu_equal_the_previous_composition(shape, dtype):
    """On the CPU ncc_scores_all (through ncc_corr_norms' plain version)
    gives the previous composition's scores bit for bit, flat patches
    included: one window holds a constant block."""
    win, _ = _operands(*shape, seed=8)
    win[0, :15, :15] = 0.25
    tpl = np.random.default_rng(9).uniform(0, 1, (shape[0],) + shape[2:] * 2)
    w, tp = torch.tensor(win.astype(dtype)), torch.tensor(tpl.astype(dtype))
    got = ncc.ncc_scores_all(w, tp)
    want = _scores_composed(w, tp)
    assert got.dtype == want.dtype and bool((want == 0).any())
    assert torch.equal(got, want)


def test_var_stray_sees_box_sums_one_row_down():
    """The norms check of chip_smoke.py: the f32 variance strays far below
    ncc.FLAT_EPS units of eps·Σwc², box sums taken one row down read far
    above it; energies of f32 windows agree to ~1e-7."""
    win, tm = (torch.tensor(a) for a in _operands(64, 37, 13, seed=10))
    _, var, energy = kernels.ncc_corr_norms_plain(win, tm)
    _, v32, e32 = kernels.ncc_corr_norms_plain(win.float(), tm.float())
    assert kernels.var_stray(v32, var, energy) < ncc.FLAT_EPS / 4
    assert kernels.energy_error(e32, energy) <= 1e-6
    down = torch.roll(win, -1, dims=1)
    _, fault, _ = kernels.ncc_corr_norms_plain(down, tm)
    assert kernels.var_stray(fault, var, energy) > 100 * ncc.FLAT_EPS


def test_norms_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    win, tm = (torch.tensor(a) for a in _operands(4, 23, 7, seed=11))
    before = dict(kernels.LAUNCHES)
    got = kernels.ncc_corr_norms(win, tm)
    for g, w in zip(got, kernels.ncc_corr_norms_plain(win, tm)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("bad", ["pairs", "template_wider", "strided"])
def test_norms_wrapper_rejects_bad_operands(bad):
    win, tm = (torch.tensor(a) for a in _operands(4, 23, 7, seed=12))
    if bad == "pairs":
        args, err = (win, tm[:3]), "shape"
    elif bad == "template_wider":
        args, err = (win[:, :5, :5].contiguous(), tm), "wider"
    else:
        args, err = (win.transpose(1, 2), tm), "contiguous"
    with pytest.raises(ValueError, match=err):
        kernels.ncc_corr_norms(*args)
