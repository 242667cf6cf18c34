"""K7 ncc_corr of the port — the NCC matcher's correlation numerator —
against the JAX Pallas kernel and against an f64 formula.

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
in another order at f64."""

import jax
import numpy as np
import pytest
import torch

from ekf_slam_tpu.ops import pallas_kernels as pk
from torch_parity import interpret_mode

from ekf_slam_tpu_torch.ops import kernels

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
