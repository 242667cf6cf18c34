"""The schedule of the card's K8 (corr_apply) modelled in torch, and
chip_smoke's yardsticks for K4, K6 and K8 (its operation counts and its
library calls), on CPU tensors against the plain versions.

The CUDA kernel runs only on a card (tests/test_torch_cuda.py). What it
does with its tiles is arithmetic that a CPU can check: `k8_schedule`
below walks the tile pairs i <= j of 64 x 64 tiles as the kernel does,
sums S = [At; Bt]ᵀ[Bt; At] over the concatenated contraction in k order
(one accumulator an entry), takes a diagonal tile's lower entries from its
upper ones, and writes tile (i, j) and, mirrored, tile (j, i). Held
against kernels.corr_apply_plain at f64 to 1e-12 of each entry's scale
(the same products in another order), and at f32 for what the kernel
promises bit for bit: "full" symmetric, "expr" symmetric on a symmetric P,
every diagonal block by itself too.

This file imports torch and the port only."""

import importlib.util
import pathlib

import pytest
import torch

from ekf_slam_tpu_torch.ops import kernels

torch.set_num_threads(1)

TILE = 64
# f64 sums of at most 2R = 112 products in another order than the plain
# version's matmul: a few 1e-16 of the entry's scale each.
F64_TOL = 1e-12


def _load_chip_smoke():
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


chip_smoke = _load_chip_smoke()


def _chain(X, Y):
    """Σ_k X[:, k, :, None]·Y[:, k, None, :], one term after the other."""
    S = torch.zeros(X.shape[0], X.shape[2], Y.shape[2], dtype=X.dtype)
    for k in range(X.shape[1]):
        S = S + X[:, k, :, None] * Y[:, k, None, :]
    return S


def k8_schedule(P, At, Bt, mode, diagonal_rule=True):
    """corr_apply as the card's kernel schedules it (see the module's
    docstring). P (B,D,D); At, Bt (B,R,D); computed in At's dtype,
    returned in P's."""
    D = P.shape[1]
    Pc = P.to(At.dtype)
    out = torch.full_like(Pc, float("nan"))
    tiles = [slice(i, min(i + TILE, D)) for i in range(0, D, TILE)]
    if mode == "none":                      # every tile, contraction R
        for ti in tiles:
            for tj in tiles:
                out[:, ti, tj] = Pc[:, ti, tj] + _chain(At[:, :, ti],
                                                        Bt[:, :, tj])
        return out.to(P.dtype)
    X, Y = torch.cat([At, Bt], 1), torch.cat([Bt, At], 1)
    for i, ti in enumerate(tiles):
        for tj in tiles[i:]:
            S = _chain(X[:, :, ti], Y[:, :, tj])
            if ti == tj and diagonal_rule:  # lower entries from the upper
                S = torch.triu(S) + torch.triu(S, 1).transpose(1, 2)
            if mode == "full":
                v = 0.5 * (Pc[:, ti, tj] + Pc[:, tj, ti].transpose(1, 2)) \
                    + 0.5 * S
                out[:, ti, tj] = v
                out[:, tj, ti] = v.transpose(1, 2)
            else:
                out[:, ti, tj] = Pc[:, ti, tj] + 0.5 * S
                out[:, tj, ti] = Pc[:, tj, ti] + 0.5 * S.transpose(1, 2)
    return out.to(P.dtype)


def _operands(B, D, R, seed, dtype=torch.float64, symmetric=False):
    g = torch.Generator().manual_seed(seed)
    P = torch.randn(B, D, D, generator=g, dtype=torch.float64)
    if symmetric:
        P = 0.5 * (P + P.transpose(1, 2))
    At = torch.randn(B, R, D, generator=g, dtype=torch.float64)
    Bt = torch.randn(B, R, D, generator=g, dtype=torch.float64)
    return P.to(dtype), At.to(dtype), Bt.to(dtype)


def _scale(P, At, Bt):
    C = At.abs().transpose(1, 2) @ Bt.abs()
    return P.abs() + P.abs().transpose(1, 2) + C + C.transpose(1, 2)


@pytest.mark.parametrize("D,B", [(19, 3), (70, 2), (613, 1)])
@pytest.mark.parametrize("R", [1, 56])
@pytest.mark.parametrize("mode", kernels.CORR_MODES)
def test_k8_schedule_matches_plain(mode, R, D, B):
    """Tile pairs, the concatenated contraction, the mirrored write and the
    diagonal rule give corr_apply_plain's function: at f64 within F64_TOL
    of each entry's scale, every entry written; at f32 "full" is bitwise
    symmetric."""
    P, At, Bt = _operands(B, D, R, 100 * D + R)
    got = k8_schedule(P, At, Bt, mode)
    want = kernels.corr_apply_plain(P, At, Bt, mode)
    assert bool(torch.isfinite(got).all())
    assert bool(((got - want).abs() <= F64_TOL * _scale(P, At, Bt)).all())
    got32 = k8_schedule(P.float(), At.float(), Bt.float(), mode)
    assert got32.dtype == torch.float32
    assert bool(((got32.double() - want).abs()
                 <= 1e-5 * _scale(P, At, Bt)).all())
    if mode == "full":
        assert torch.equal(got32, got32.transpose(1, 2))


@pytest.mark.parametrize("D,B", [(19, 3), (70, 2), (613, 1)])
@pytest.mark.parametrize("R", [1, 56])
@pytest.mark.parametrize("store", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_k8_schedule_expr_is_symmetric_on_symmetric_p(store, R, D, B):
    """ "expr" on a symmetric P, f32 sums: bitwise symmetric as a whole and
    on every diagonal block by itself, in f32 and rounded to a bf16 P."""
    P, At, Bt = _operands(B, D, R, 7 * D + R, torch.float32, symmetric=True)
    P = P.to(store)
    assert torch.equal(P, P.transpose(1, 2))
    got = k8_schedule(P, At, Bt, "expr")
    assert got.dtype == store
    for i0 in range(0, D, TILE):
        blk = got[:, i0:i0 + TILE, i0:i0 + TILE]
        assert torch.equal(blk, blk.transpose(1, 2)), i0
    assert torch.equal(got, got.transpose(1, 2))


def test_k8_single_chain_needs_the_diagonal_rule():
    """Without the rule a diagonal tile is not symmetric at f32: entry
    (r, c) sums At·Bt then Bt·At, entry (c, r) the same products in the
    other order. Off the diagonal the mirror alone suffices."""
    P, At, Bt = _operands(2, 70, 56, 5, torch.float32, symmetric=True)
    got = k8_schedule(P, At, Bt, "expr", diagonal_rule=False)
    blk = got[:, :TILE, :TILE]
    assert not torch.equal(blk, blk.transpose(1, 2))
    off = got[:, :TILE, TILE:]
    assert torch.equal(off, got[:, TILE:, :TILE].transpose(1, 2))


# --- chip_smoke's yardsticks --------------------------------------------------

def test_library_call_of_k6_is_the_plain_product():
    g = torch.Generator().manual_seed(0)
    A = torch.randn(2, 50, 70, generator=g, dtype=torch.float64)
    Bm = torch.randn(2, 70, 31, generator=g, dtype=torch.float64)
    got = chip_smoke.LIBRARY["f32_matmul_big"](A, Bm)
    want = kernels.matmul_big_plain(A, Bm)
    assert bool(((got - want).abs() <= F64_TOL * (A.abs() @ Bm.abs())).all())


def test_library_call_of_k8_is_expr():
    P, At, Bt = _operands(2, 70, 56, 1)
    got = chip_smoke.LIBRARY["corr_apply"](P, At, Bt, "expr")
    want = kernels.corr_apply_plain(P, At, Bt, "expr")
    assert bool(((got - want).abs() <= F64_TOL * _scale(P, At, Bt)).all())


def test_library_call_of_k4_is_k4_on_a_symmetric_p():
    """baddbmm(P, [A B], [B A]ᵀ, alpha=½) is K4's function where P is
    symmetric (the path's P), and not where it is not."""
    g = torch.Generator().manual_seed(2)
    P = torch.randn(2, 70, 70, generator=g, dtype=torch.float64)
    A = torch.randn(2, 70, 40, generator=g, dtype=torch.float64)
    Bf = torch.randn(2, 70, 40, generator=g, dtype=torch.float64)
    sym = 0.5 * (P + P.transpose(1, 2))
    scale = _scale(P, A.transpose(1, 2), Bf.transpose(1, 2))
    got = chip_smoke.LIBRARY["corr_apply_cols"](sym, A, Bf)
    want = kernels.corr_apply_cols_plain(sym, A, Bf)
    assert bool(((got - want).abs() <= F64_TOL * scale).all())
    skew = chip_smoke.LIBRARY["corr_apply_cols"](P, A, Bf)
    assert float((skew - kernels.corr_apply_cols_plain(P, A, Bf)).abs().max()
                 ) > 1e-3


def _meta(*shape):
    return torch.empty(*shape, device="meta")


@pytest.mark.parametrize("name,args,flops", [
    # 2·B·M·K·N
    ("f32_matmul_big", ((2, 5, 7), (2, 7, 3)), 2 * 2 * 5 * 7 * 3),
    ("f32_matmul_big", ((128, 613, 613), (128, 613, 128)),
     2 * 128 * 613 * 613 * 128),                         # 12.31 GFLOP
    ("f32_matmul_big", ((128, 613, 613), (128, 613, 48)),
     2 * 128 * 613 * 613 * 48),                          # 4.617 GFLOP
    # 4·R an entry of the triangle D(D+1)/2
    ("corr_apply_cols", ((2, 5, 5), (2, 5, 3), (2, 5, 3)), 2 * 4 * 15 * 3),
    ("corr_apply_cols", ((128, 613, 613), (128, 613, 264), (128, 613, 264)),
     128 * 4 * (613 * 614 // 2) * 264),                  # 25.44 GFLOP
])
def test_operation_counts(name, args, flops):
    """chip_smoke.FLOPS, the numerator of a kernel's operations bound, from
    shapes alone; the bench shapes give PERF.md's GFLOP."""
    assert chip_smoke.FLOPS[name](*(_meta(*s) for s in args)) == flops


@pytest.mark.parametrize("mode,flops", [
    ("expr", 128 * 4 * (613 * 614 // 2) * 56),      # 5.396 GFLOP
    ("full", 128 * 4 * (613 * 614 // 2) * 56),
    ("none", 128 * 2 * 613 * 613 * 56),             # every entry, 2R
])
def test_operation_count_of_k8_by_mode(mode, flops):
    args = (_meta(128, 613, 613), _meta(128, 56, 613), _meta(128, 56, 613))
    assert chip_smoke.FLOPS["corr_apply"](*args, mode) == flops
