"""The Newton gain's SPD inverse off the card: ops/kernels.py's
spd_inverse_newton_plain (the batched torch.matmul iteration, the CPU's
and the fallback's solver), the wrapper spd_inverse_newton and
filter/ekf._spd_inverse_newton on CPU tensors, its launch counter and the
routes that swap it. Torch only; the kernel's CUDA source runs on the CPU
in test_torch_cuda_emulation.py, and on the card in test_torch_cuda.py."""

import pytest
import torch

from ekf_slam_tpu_torch import profile_slice
from ekf_slam_tpu_torch.filter import ekf, graph
from ekf_slam_tpu_torch.ops import kernels

torch.set_num_threads(1)


def _spd(B, n, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    A = torch.randn(B, n, n, generator=g, dtype=torch.float64)
    D = torch.exp(0.5 * torch.randn(B, n, generator=g, dtype=torch.float64))
    S = A @ A.transpose(1, 2) / n + torch.eye(n, dtype=torch.float64)
    return (D[:, :, None] * S * D[:, None, :]).to(dtype)


def _before_the_kernel(S, iters=20):
    """ekf._spd_inverse_newton's body as it was before the kernel, which
    the plain version keeps bit for bit."""
    eye = torch.eye(S.shape[-1], dtype=S.dtype, device=S.device)
    d = torch.diagonal(S, dim1=-2, dim2=-1)
    d = torch.where(d > 0, d, torch.ones_like(d))
    rsd = torch.rsqrt(d)
    S_hat_rows = torch.sum(
        torch.abs(S) * rsd[..., :, None] * rsd[..., None, :], dim=-1)
    lam_up = torch.amax(S_hat_rows, dim=-1)
    X = (eye / d[..., None, :]) / lam_up[..., None, None]
    for _ in range(iters):
        X = X @ (2.0 * eye - S @ X)
    return X


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 12, 48, 128, 160])
def test_cpu_solver_is_the_plain_iteration_bit_for_bit(dtype, n):
    """On CPU tensors ekf._spd_inverse_newton and the wrapper return the
    plain version's bits, which are the solver's before the kernel; no
    launch is counted; the result inverts S."""
    S = _spd(3, n, dtype)
    kernels.reset_launches()
    want = _before_the_kernel(S)
    for got in (ekf._spd_inverse_newton(S), kernels.spd_inverse_newton(S),
                kernels.spd_inverse_newton_plain(S)):
        assert got.dtype == dtype and torch.equal(got, want)
    assert kernels.COUNTS["spd_inverse_newton"] == 0
    assert kernels.COUNTS["newton_plain"] == 0
    assert not any(kernels.LAUNCHES.values())
    resid = (want.double() @ S.double()
             - torch.eye(n, dtype=torch.float64)).abs().max()
    assert float(resid) <= (1e-3 if dtype == torch.float32 else 1e-9)


@pytest.mark.parametrize("bad", [float("nan"), float("inf"),
                                 float("-inf")])
@pytest.mark.parametrize("diagonal", [False, True])
def test_plain_is_nan_where_s_is_not_finite(bad, diagonal):
    """One non-finite entry, on or off the diagonal, makes the Gershgorin
    bound NaN or infinite and the whole inverse NaN; the other instances
    of the batch are untouched. The kernel is held to this NaN on the
    card and in the emulation."""
    S = _spd(3, 12, torch.float32, seed=2)
    S[1, 4, 4 if diagonal else 7] = bad
    got = kernels.spd_inverse_newton_plain(S)
    assert bool(torch.isnan(got[1]).all())
    assert bool(torch.isfinite(got[[0, 2]]).all())
    assert torch.equal(got[[0, 2]],
                       kernels.spd_inverse_newton_plain(S[[0, 2]]))


def test_plain_replaces_a_diagonal_that_is_not_positive():
    """d = 0 on a zeroed row and column is replaced by 1: that entry of X
    doubles each iteration from 1/λ̂, exactly, and the rest is the inverse
    of the rest."""
    S = _spd(1, 6, torch.float64, seed=3)
    S[0, 2, :] = 0
    S[0, :, 2] = 0
    X = kernels.spd_inverse_newton_plain(S)
    keep = [0, 1, 3, 4, 5]
    d = torch.diagonal(S[0]).clone()
    d[2] = 1
    rsd = torch.rsqrt(d)
    lam = float((S[0].abs() * rsd[:, None] * rsd[None, :]).sum(1).max())
    assert float(X[0, 2, 2]) == 2.0 ** 20 * (1.0 / lam)
    assert torch.allclose(X[0][keep][:, keep],
                          torch.linalg.inv(S[0][keep][:, keep]),
                          rtol=1e-9, atol=1e-12)


def test_wrapper_rejects_bad_operands():
    S = _spd(2, 8, torch.float32)
    with pytest.raises(ValueError, match="not contiguous"):
        kernels.spd_inverse_newton(S.transpose(1, 2))
    with pytest.raises(ValueError, match="shape"):
        kernels.spd_inverse_newton(S[:, :, :7])


def test_reset_launches_resets_the_newton_counts():
    """reset_launches clears every count of both tables, the Newton
    solves' and the Cholesky gains' among them."""
    kernels.COUNTS["spd_inverse_newton"] = 5
    kernels.COUNTS["newton_plain"] = 2
    kernels.COUNTS["cholesky_gain"] = 3
    kernels.LAUNCHES["corr_apply_cols"] = 4
    kernels.reset_launches()
    assert not any(kernels.COUNTS.values())
    assert not any(kernels.LAUNCHES.values())


def test_replay_credits_the_frames_newton_launches():
    """A replayed frame calls no wrapper: StaticFrame.step credits
    kernels.COUNTS with the captured frame's counts, name by name, as it
    credits LAUNCHES."""
    calls = []

    class Replayed:
        def replay(self):
            calls.append(1)

    x = torch.zeros(3)
    frame = graph.StaticFrame(lambda carry, inputs: (carry, ()), (x,), (x,))
    frame.graph = Replayed()
    frame.launches = {"fused_update_tail_add": 1}
    frame.counts = {"spd_inverse_newton": 2, "newton_plain": 1}
    kernels.reset_launches()
    for _ in range(3):
        frame.step((x,))
    assert calls == [1, 1, 1]
    assert kernels.COUNTS["spd_inverse_newton"] == 6
    assert kernels.COUNTS["newton_plain"] == 3
    assert kernels.LAUNCHES["fused_update_tail_add"] == 3
    kernels.reset_launches()


def test_plain_route_swaps_the_newton_wrapper():
    """The Newton gain's wrapper is one of PLAIN's: profile_slice's "plain"
    route takes its plain version too, and a captured frame is kept apart
    by it (graph._wrappers)."""
    assert kernels.PLAIN["spd_inverse_newton"] is \
        kernels.spd_inverse_newton_plain
    with profile_slice.route("kernels"):
        assert kernels.spd_inverse_newton is not \
            kernels.spd_inverse_newton_plain
        kept = graph._wrappers()
    with profile_slice.route("plain"):
        assert kernels.spd_inverse_newton is kernels.spd_inverse_newton_plain
        assert graph._wrappers() != kept
    assert graph._wrappers() == kept


def test_newton_error_reads_rounding_small_and_faults_large():
    """newton_error: the f32 plain version on the CPU within NEWTON_TOL
    of its f64 self; a transposed result of an unsymmetric S, or one entry
    off by a part in ten, far outside; NaN where the f64 loop is
    NaN passes, a finite value there reads inf."""
    S = _spd(4, 24, torch.float32, seed=4)
    S = S + 1e-2 * torch.randn(4, 24, 24,
                               generator=torch.Generator().manual_seed(5))
    W = kernels.spd_inverse_newton_plain(S)
    assert kernels.newton_error(W, S) <= kernels.NEWTON_TOL
    off = W.clone()
    off[2, 5, 7] *= 1 + 1e-1
    assert kernels.newton_error(off, S) > 100 * kernels.NEWTON_TOL
    assert kernels.newton_error(W.transpose(1, 2).contiguous(), S) \
        > 100 * kernels.NEWTON_TOL
    S[1, 3, 3] = float("nan")
    W = kernels.spd_inverse_newton_plain(S)
    assert kernels.newton_error(W, S) <= kernels.NEWTON_TOL
    W[1, 0, 0] = 1.0
    assert kernels.newton_error(W, S) == float("inf")


def test_capture_operands_records_the_newton_wrapper():
    """capture_operands records spd_inverse_newton's S as it records the
    other wrappers' operands, on the CPU too, where ekf._spd_inverse_newton
    calls the wrapper and the wrapper its plain version."""
    S = _spd(2, 8, torch.float32, seed=6)
    for module, solve in ((ekf, "_spd_inverse_newton"),
                          (kernels, "spd_inverse_newton")):
        with kernels.capture_operands() as seen:
            got = getattr(module, solve)(S)
        assert list(seen) == ["spd_inverse_newton"]
        assert len(seen["spd_inverse_newton"]) == 1
        assert torch.equal(seen["spd_inverse_newton"][0][0], S)
        assert torch.equal(got, kernels.spd_inverse_newton_plain(S))
