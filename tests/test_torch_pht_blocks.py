"""The measurement gain from the Jacobian's blocks (ops/kernels.py
pht_blocks, filter/ekf.py JacobianBlocks) against the dense form it
replaces, on the CPU (plain versions; the kernel's CUDA source runs in
tests/test_torch_cuda_emulation.py, on the card in
tests/test_torch_cuda.py).

(a) pht_blocks_plain's P·Hᵀ against K6's plain version on the dense
compact Jacobian (measurement.compact_dense_H), and its S against H·PHt +
diag(r), at f64, f32 and on a bf16-stored P, with M < CAP and M = CAP,
masked rows and unsorted slots; (b) update_gain, update and
update_iterated given the blocks against the same given the dense H, at
f64 within 1e-12; (c) the wrapper's routes and counters."""

import pytest
import torch

from ekf_slam_tpu_torch.filter import ekf, graph, measurement
from ekf_slam_tpu_torch.ops import kernels

CAP, B = 9, 3
D = 13 + 6 * CAP


def operands(M, dtype=torch.float64, seed=0):
    """An SPD P (B,D,D), blocks of M distinct unsorted slots with a
    quarter of the slots and one extra row masked, a row mask, noise."""
    g = torch.Generator().manual_seed(seed)
    A = torch.randn(B, D, D, generator=g, dtype=torch.float64)
    P = (A @ A.transpose(1, 2) / D + 0.1 * torch.eye(D, dtype=torch.float64))
    sel = torch.stack([torch.randperm(CAP, generator=g)[:M]
                       for _ in range(B)])
    H_xv = torch.randn(B, M, 2, 13, generator=g, dtype=torch.float64)
    H_y = torch.randn(B, M, 2, 6, generator=g, dtype=torch.float64)
    row_mask = (torch.rand(B, M, generator=g) > 0.25).repeat_interleave(
        2, dim=1)
    row_mask[0, 1] = False                    # one row of a kept slot
    r = torch.rand(B, 2 * M, generator=g, dtype=torch.float64) + 0.5
    return (P.to(dtype), H_xv.to(dtype), H_y.to(dtype), sel, row_mask,
            r.to(dtype))


def dense(H_xv, H_y, sel):
    return measurement.compact_dense_H(
        H_xv, H_y, sel, torch.ones(sel.shape, dtype=torch.bool), CAP)


def relative(diff, scale) -> float:
    """max |diff| / scale, an entry of scale 0 held to a diff of 0."""
    return float(torch.where(diff == 0, torch.zeros_like(diff),
                             diff.abs() / scale).max())


@pytest.mark.parametrize("M", [4, CAP], ids=["M_lt_cap", "M_eq_cap"])
@pytest.mark.parametrize("dtype", ["float64", "float32", "bf16_p"])
def test_plain_blocks_match_dense(M, dtype):
    """P·Hᵀ and S of the blocks against K6's plain version on the dense H
    and H·PHt + diag(r): f64 within 1e-12 relative to the entries' own
    scale, f32 and a bf16-stored P (both read as f32) within 1e-5;
    masked rows give zero columns and a unit-noise row of S."""
    cdt = torch.float64 if dtype == "float64" else torch.float32
    P, H_xv, H_y, sel, row_mask, r = operands(M, cdt)
    if dtype == "bf16_p":
        P = P.to(torch.bfloat16)
    blocks = ekf.JacobianBlocks(H_xv, H_y, sel).masked(row_mask.to(cdt))
    PHt, S = kernels.pht_blocks_plain(P, blocks.H_xv, blocks.H_y, sel, r)
    H = dense(blocks.H_xv, blocks.H_y, sel)
    want = kernels.matmul_big_plain(P, H.transpose(1, 2).contiguous())
    want_S = H @ want + torch.diag_embed(r)
    tol = 1e-12 if dtype == "float64" else 1e-5
    scale = kernels.matmul_big_plain(P.abs(), H.abs().transpose(1, 2))
    assert PHt.dtype == cdt and S.dtype == cdt
    assert relative(PHt - want, scale) < tol
    assert relative(S - want_S, H.abs() @ scale + torch.diag_embed(r)) < tol
    off = ~row_mask
    assert bool((PHt.transpose(1, 2)[off] == 0).all())
    assert bool((S[off] == torch.diag_embed(r)[off]).all())
    x = torch.randn(B, D, dtype=cdt)
    torch.testing.assert_close(blocks.times(x[..., None]), H @ x[..., None],
                               rtol=tol, atol=tol)


def gain_args(M, seed=1):
    P, H_xv, H_y, sel, row_mask, r = operands(M, seed=seed)
    g = torch.Generator().manual_seed(seed + 10)
    x = torch.randn(B, D, generator=g, dtype=torch.float64)
    x[:, 3:7] /= torch.linalg.vector_norm(x[:, 3:7], dim=1, keepdim=True)
    z = torch.randn(B, 2 * M, generator=g, dtype=torch.float64)
    h = torch.randn(B, 2 * M, generator=g, dtype=torch.float64)
    return x, P, ekf.JacobianBlocks(H_xv, H_y, sel), z, h, row_mask, r


def assert_close_12(got, want):
    for a, b in zip(got, want):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-12 * scale


@pytest.mark.parametrize("M", [4, CAP], ids=["M_lt_cap", "M_eq_cap"])
@pytest.mark.parametrize("solver", ["cholesky", "newton"])
@pytest.mark.parametrize("given_pht", [False, True],
                         ids=["pht_formed", "pht_given"])
def test_update_gain_blocks_match_dense(M, solver, given_pht):
    """update_gain given the blocks against the same given the dense H, at
    f64 within 1e-12: x, K and the masked P·Hᵀ; with the caller's gain
    columns (the fused step's) S from their rows the blocks read."""
    x, P, blocks, z, h, row_mask, r = gain_args(M)
    H = dense(blocks.H_xv, blocks.H_y, blocks.sel)
    PHt = P @ H.transpose(1, 2) if given_pht else None
    got = ekf.update_gain(x, P, blocks, z, h, row_mask, r, solver, PHt)
    want = ekf.update_gain(x, P, H, z, h, row_mask, r, solver, PHt)
    assert_close_12(got, want)


@pytest.mark.parametrize("M", [4, CAP], ids=["M_lt_cap", "M_eq_cap"])
def test_update_blocks_match_dense(M):
    """ekf.update (K4's folded tail) given the blocks against the same
    given the dense H, at f64 within 1e-12."""
    x, P, blocks, z, h, row_mask, r = gain_args(M, seed=2)
    H = dense(blocks.H_xv, blocks.H_y, blocks.sel)
    assert_close_12(ekf.update(x, P, blocks, z, h, row_mask, r),
                    ekf.update(x, P, H, z, h, row_mask, r))


@pytest.mark.parametrize("M", [4, CAP], ids=["M_lt_cap", "M_eq_cap"])
def test_update_iterated_blocks_match_dense(M):
    """update_iterated whose h_fn gives the blocks against the same whose
    h_fn gives the dense H, at f64 within 1e-12: a linear-in-x h with
    blocks that move with the iterate, so every iterate's gain and its
    H·(x − xᵢ) count."""
    x, P, blocks, z, h0, row_mask, r = gain_args(M, seed=3)

    def h_fn(as_dense):
        def fn(xi):
            s = 1 + 0.1 * torch.tanh(xi[:, :1, None, None])
            b = ekf.JacobianBlocks(blocks.H_xv * s, blocks.H_y * s,
                                   blocks.sel)
            Hd = dense(b.H_xv, b.H_y, b.sel)
            hx = h0 + (Hd @ xi[..., None])[..., 0]
            return hx, Hd if as_dense else b
        return fn
    assert_close_12(
        ekf.update_iterated(x, P, z, h_fn(False), row_mask, r, 3),
        ekf.update_iterated(x, P, z, h_fn(True), row_mask, r, 3))


def test_wrapper_routes_and_counts():
    """On the CPU pht_blocks is its plain version bit for bit and counts
    nothing; it checks its operands' shapes and sel's dtype; reset_launches
    zeroes its count."""
    P, H_xv, H_y, sel, _, r = operands(4)
    kernels.reset_launches()
    got = kernels.pht_blocks(P, H_xv, H_y, sel, r)
    want = kernels.pht_blocks_plain(P, H_xv, H_y, sel, r)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert kernels.COUNTS["pht_blocks"] == 0
    assert not any(kernels.LAUNCHES.values())
    with pytest.raises(ValueError, match="sel"):
        kernels.pht_blocks(P, H_xv, H_y, sel.int(), r)
    with pytest.raises(ValueError, match="H_y"):
        kernels.pht_blocks(P, H_xv, H_y[:, :3], sel, r)
    kernels.COUNTS["pht_blocks"] = 4
    kernels.reset_launches()
    assert kernels.COUNTS["pht_blocks"] == 0


def test_replay_credits_the_frames_pht_blocks_counts():
    """A replayed frame calls no wrapper: StaticFrame.step credits
    kernels.COUNTS with the captured frame's pht_blocks count, as it
    credits LAUNCHES, and leaves the table's other counts as they were."""
    class Replayed:
        def replay(self):
            pass

    x = torch.zeros(3)
    frame = graph.StaticFrame(lambda carry, inputs: (carry, ()), (x,), (x,))
    frame.graph = Replayed()
    frame.counts = {"pht_blocks": 5}
    kernels.reset_launches()
    for _ in range(3):
        frame.step((x,))
    assert kernels.COUNTS == {"spd_inverse_newton": 0, "pht_blocks": 15,
                              "newton_plain": 0, "cholesky_gain": 0}
    kernels.reset_launches()


def test_pht_blocks_error_reads_f32_rounding_and_a_fault():
    """kernels.pht_blocks_error, the card's check of the kernel: the f32
    plain version reads f32 rounding (< 1e-5 of the bounds); one slot's
    landmark columns read one slot off, or S's rows of two slots swapped,
    read O(1)."""
    P, H_xv, H_y, sel, _, r = operands(4, torch.float32)
    args = (P, H_xv, H_y, sel, r)
    out = kernels.pht_blocks_plain(*args)
    assert kernels.pht_blocks_error(out, *args) < 1e-5
    off = sel.clone()
    off[0, 0] = (off[0, 0] + 1) % CAP
    shifted = kernels.pht_blocks_plain(P, H_xv, H_y, off, r)
    assert kernels.pht_blocks_error(shifted, *args) > 0.1
    swapped = out[1][:, [2, 3, 0, 1, 4, 5, 6, 7]]
    assert kernels.pht_blocks_error((out[0], swapped), *args) > 0.1
