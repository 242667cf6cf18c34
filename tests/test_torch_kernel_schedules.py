"""The schedules of the card's tile-pair kernels modelled in torch — K8
(corr_apply), K4 (corr_apply_cols), K3 / K5 (fused_update_tail_add,
fused_update_tail), K1 (fused_manage_predict_pht) and K2
(fused_update_tail_pht) — and chip_smoke's yardsticks (operation counts
and library calls), on CPU tensors against the plain versions.

The CUDA kernels run only on a card (tests/test_torch_cuda.py). What they
do with their tiles is arithmetic that a CPU can check. `k8_schedule`
below walks the tile pairs i <= j of 64 x 64 tiles as the kernel does,
sums S = [At; Bt]ᵀ[Bt; At] over the concatenated contraction in k order
(one accumulator an entry), takes a diagonal tile's lower entries from its
upper ones, and writes tile (i, j) and, mirrored, tile (j, i).
`k4_schedule` is the same on column factors, S = [A | B]·[B | A]ᵀ.
`k3_schedule` adds K3's steps: the downdate S1 = [K | PHt]·[PHt | K]ᵀ into
each entry's own P, the renorm stripe on the pairs of tile row 0 (rows,
then columns, then the 8 x 8 corner's lower entries from its upper ones),
the keep mask and the rank-2r add S2 = [EN; V]ᵀ[V; EN] with
V = UN + ½·CN·EN. `k1_schedule` is K1's pass: the keep mask, the add
S2 = [E6; V]ᵀ[V; E6], the 16-wide predict stripe on the pairs of tile row
0 (its 16 x 16 corner's lower entries from its upper ones), Q̃ on (0, 0);
then, as for K2 (K5's schedule), the product P_new·Ht as one chain over k
in order. Held against the plain versions at f64 to 1e-12 of each entry's
scale (the same products in another order), and at f32 for what the
kernels promise bit for bit: K8 "full" and K4 symmetric, K8 "expr", K3 /
K5, K2 and K1 symmetric on a symmetric P (K1: and a symmetric C66 and
Q13), every diagonal block by itself too. `k7_norms_schedule` is K7's
norms form: the window centred on its mean, direct t-term row sums of wc
and wc², then t of those down each column, var = max(sq − box²/t², 0);
held to the plain version's integral images at f64, and at f32 within
ncc.FLAT_EPS units of eps·Σwc² of the f64 variance.

This file imports torch and the port only."""

import importlib.util
import pathlib

import pytest
import torch

from ekf_slam_tpu_torch.ops import kernels
from torch_scales import k1_scale, k3_scale, within

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


# --- K4 and K3 / K5 -----------------------------------------------------------

def _pairs(D):
    """(i, row slice, column slice) of the tile pairs i <= j, in order."""
    tiles = [slice(i, min(i + TILE, D)) for i in range(0, D, TILE)]
    return [(i, ti, tj) for i, ti in enumerate(tiles) for tj in tiles[i:]]


def _diag(S, ti, tj, diagonal_rule=True):
    """A tile pair's accumulator; on a diagonal tile the lower entries
    from the upper ones."""
    s = S[:, ti, tj]
    if ti == tj and diagonal_rule:
        s = torch.triu(s) + torch.triu(s, 1).transpose(1, 2)
    return s


def k4_schedule(P, A, Bf, diagonal_rule=True):
    """corr_apply_cols as the card's kernel schedules it: S = X·Yᵀ, one
    chain over X = [A | B], Y = [B | A] (2R columns), then the mirrored
    "full" epilogue of each tile pair. P (B,D,D); A, B (B,D,R); computed in
    A's dtype, returned in P's."""
    Pc = P.to(A.dtype)
    S = _chain(torch.cat([A, Bf], 2).transpose(1, 2),
               torch.cat([Bf, A], 2).transpose(1, 2))
    out = torch.full_like(Pc, float("nan"))
    for _, ti, tj in _pairs(P.shape[1]):
        v = 0.5 * (Pc[:, ti, tj] + Pc[:, tj, ti].transpose(1, 2)) \
            + 0.5 * _diag(S, ti, tj, diagonal_rule)
        out[:, ti, tj] = v
        out[:, tj, ti] = v.transpose(1, 2)
    return out.to(P.dtype)


def _stripe_pairs(t, J):
    """In place: the stripe transform J (W x W) on dims 0:W of the pairs of
    tile row 0 — rows 0:W of tile (0, j) <- J·rows, columns 0:W of tile
    (j, 0) <- columns·Jᵀ, each an fmaf chain in k order — and on (0, 0)
    rows, then columns, then the W x W corner's lower entries from its
    upper ones."""
    W = J.shape[-1]
    for i, ti, tj in _pairs(t.shape[1]):
        if i != 0:
            continue
        rows = t[:, 0:W, tj]
        t[:, 0:W, tj] = _chain(J.transpose(1, 2), rows)
        cols = t[:, tj, 0:W]
        t[:, tj, 0:W] = _chain(cols.transpose(1, 2), J.transpose(1, 2))
        if ti == tj:
            c = t[:, 0:W, 0:W]
            t[:, 0:W, 0:W] = torch.triu(c) + torch.triu(c, 1).transpose(1, 2)


def k3_schedule(P, K, PHt, Jq4, keepN=None, EN=None, UN=None, CN=None):
    """fused_update_tail_add (K5's fused_update_tail without keepN … CN) as
    the card's kernel schedules it, a tile pair (i, j), i <= j, at a time:
    (a) t = P − ½·S1, S1 one chain over [K | PHt]·[PHt | K]ᵀ, tile (j, i)
    from S1ᵀ, each entry from its own entry of P; (b) on the pairs of tile
    row 0 rows 0:8 of tile (0, j) <- J8·rows and columns 0:8 of tile
    (j, 0) <- columns·J8ᵀ, in k order, and on (0, 0) rows, then columns,
    then the 8 x 8 corner's lower entries from its upper ones; (c) keep
    mask, then + S2, S2 one chain over [EN; V]ᵀ[V; EN], V = UN + ½·CN·EN.
    Computed and returned in P's dtype."""
    D = P.shape[1]
    J8 = kernels._j8(Jq4)
    S1 = _chain(torch.cat([K, PHt], 2).transpose(1, 2),
                torch.cat([PHt, K], 2).transpose(1, 2))
    t = torch.full_like(P, float("nan"))
    for _, ti, tj in _pairs(D):
        s = _diag(S1, ti, tj)
        t[:, ti, tj] = P[:, ti, tj] - 0.5 * s
        t[:, tj, ti] = P[:, tj, ti] - 0.5 * s.transpose(1, 2)
    _stripe_pairs(t, J8)
    if EN is None:
        return t
    t = kernels._keep_mask(t, keepN)
    return _add_v_form(t, EN, UN, CN)


def _product(P, Ht):
    """P·Ht as K6's panel product sums it: one fmaf chain over k in order."""
    return _chain(P.transpose(1, 2), Ht)


def _add_v_form(t, E, U, C):
    """t + Eᵀ·V + Vᵀ·E, V = U + ½·C·E, as one chain over [E; V]ᵀ[V; E] a
    tile pair (a diagonal tile's lower entries from its upper ones)."""
    V = U + 0.5 * _chain(C.transpose(1, 2), E)
    S = _chain(torch.cat([E, V], 1), torch.cat([V, E], 1))
    out = torch.full_like(t, float("nan"))
    for _, ti, tj in _pairs(t.shape[1]):
        s = _diag(S, ti, tj)
        out[:, ti, tj] = t[:, ti, tj] + s
        out[:, tj, ti] = t[:, tj, ti] + s.transpose(1, 2)
    return out


def k1_schedule(P, keep, E6, U6, C66, F13, Q13, Ht):
    """fused_manage_predict_pht as the card schedules it: k1p_kernel's tile
    pairs (the keep mask; + S2 = [E6; V]ᵀ[V; E6], V = U6 + ½·C66·E6; on the
    pairs of tile row 0 the predict stripe with F16 = F13 ⊕ I₃, and on
    (0, 0) its 16 x 16 corner's lower entries from its upper ones, then
    + Q̃), then K6's product P⁻·Ht. Returns (P⁻, PHt) in P's dtype."""
    B = P.shape[0]
    F16 = torch.eye(16, dtype=P.dtype).repeat(B, 1, 1)
    F16[:, :13, :13] = F13
    t = _add_v_form(kernels._keep_mask(P, keep), E6, U6, C66)
    _stripe_pairs(t, F16)
    t[:, :13, :13] = t[:, :13, :13] + Q13
    return t, _product(t, Ht)


def k2_schedule(P, K, PHt, Jq4, Ht):
    """fused_update_tail_pht as the card schedules it: K5's pass
    (k3_schedule), then K6's product P_li·Ht."""
    t = k3_schedule(P, K, PHt, Jq4)
    return t, _product(t, Ht)


def _k3_operands(B, D, M2, r, seed, dtype=torch.float64):
    """Random K3 operands: a symmetric P, Jq4 near I, keepN mostly 1, a
    symmetric CN (the precondition of the V form)."""
    g = torch.Generator().manual_seed(seed)
    n = lambda *shape: torch.randn(*shape, generator=g, dtype=torch.float64)
    P = n(B, D, D)
    P = 0.5 * (P + P.transpose(1, 2))
    Jq4 = torch.eye(4, dtype=torch.float64) + 0.3 * n(B, 4, 4)
    ops = [P, n(B, D, M2), n(B, D, M2), Jq4]
    if r:
        C = n(B, r, r)
        ops += [(torch.rand(B, D, generator=g) > 0.15).double(), n(B, r, D),
                n(B, r, D), 0.5 * (C + C.transpose(1, 2))]
    return [x.to(dtype) for x in ops]


def _k3_plain(*ops):
    return (kernels.update_tail_plain(*ops) if len(ops) == 4
            else kernels.update_tail_add_plain(*ops))


@pytest.mark.parametrize("D,B", [(19, 3), (70, 2), (613, 1)])
@pytest.mark.parametrize("R", [1, 56, 128])
def test_k4_schedule_matches_plain(R, D, B):
    """Tile pairs, the chain over [A | B]·[B | A]ᵀ, the mirrored write and
    the diagonal rule give corr_apply_cols_plain's function: at f64 within
    F64_TOL of each entry's scale, every entry written; at f32 bitwise
    symmetric from an asymmetric P."""
    P, At, Bt = _operands(B, D, R, 31 * D + R)
    A, Bf = At.transpose(1, 2), Bt.transpose(1, 2)
    got = k4_schedule(P, A, Bf)
    want = kernels.corr_apply_cols_plain(P, A, Bf)
    assert bool(torch.isfinite(got).all())
    assert bool(((got - want).abs() <= F64_TOL * _scale(P, At, Bt)).all())
    got32 = k4_schedule(P.float(), A.float(), Bf.float())
    assert got32.dtype == torch.float32
    assert torch.equal(got32, got32.transpose(1, 2))


def test_k4_single_chain_needs_the_diagonal_rule():
    """As for K8: without the rule a diagonal tile is not symmetric at
    f32; off the diagonal the mirror alone suffices."""
    P, At, Bt = _operands(2, 70, 56, 6, torch.float32)
    got = k4_schedule(P, At.transpose(1, 2), Bt.transpose(1, 2),
                      diagonal_rule=False)
    blk = got[:, :TILE, :TILE]
    assert not torch.equal(blk, blk.transpose(1, 2))
    assert torch.equal(got[:, :TILE, TILE:],
                       got[:, TILE:, :TILE].transpose(1, 2))


@pytest.mark.parametrize("D,B", [(19, 2), (70, 2), (613, 1)])
@pytest.mark.parametrize("M2", [1, 56, 128])
@pytest.mark.parametrize("r", [0, 6, 60])
def test_k3_schedule_matches_plain(r, M2, D, B):
    """The tile-pair schedule of K3 (r > 0) and K5 (r = 0) gives
    update_tail_add_plain's / update_tail_plain's function on a symmetric P
    and CN: at f64 within F64_TOL of each entry's scale, every entry
    written; at f32 bitwise symmetric, every diagonal block too."""
    ops = _k3_operands(B, D, M2, r, 1000 * D + 10 * M2 + r)
    got = k3_schedule(*ops)
    want = _k3_plain(*ops)
    assert bool(torch.isfinite(got).all())
    assert bool(((got - want).abs() <= F64_TOL * k3_scale(*ops)).all())
    got32 = k3_schedule(*(x.float() for x in ops))
    assert got32.dtype == torch.float32
    for i0 in range(0, D, TILE):
        blk = got32[:, i0:i0 + TILE, i0:i0 + TILE]
        assert torch.equal(blk, blk.transpose(1, 2)), i0
    assert torch.equal(got32, got32.transpose(1, 2))


def test_k3_v_form_adds_the_symmetric_part_of_cn():
    """ENᵀV + VᵀEN, V = UN + ½·CN·EN, is ENᵀUN + UNᵀEN + ENᵀ·sym(CN)·EN.
    At a symmetric CN it is the reference's add (f64, F64_TOL); at an
    asymmetric one it leaves out exactly −ENᵀ·skew(CN)·EN, skew(CN) =
    ½(CN − CNᵀ), and the f32 result stays bitwise symmetric."""
    ops = _k3_operands(2, 70, 20, 12, 77)
    scale = k3_scale(*ops)
    assert bool(((k3_schedule(*ops) - _k3_plain(*ops)).abs()
                 <= F64_TOL * scale).all())
    CN = ops[7]
    skew = 1e-3 * torch.randn(CN.shape, dtype=torch.float64,
                              generator=torch.Generator().manual_seed(3))
    skew = skew - skew.transpose(1, 2)
    ops[7] = CN + skew
    gap = k3_schedule(*ops) - _k3_plain(*ops)
    EN = ops[5]
    want = -EN.transpose(1, 2) @ (0.5 * (skew - skew.transpose(1, 2))) @ EN
    assert float(want.abs().max()) > 1e-3
    assert bool(((gap - want).abs() <= F64_TOL * scale).all())
    got32 = k3_schedule(*(x.float() for x in ops))
    assert torch.equal(got32, got32.transpose(1, 2))


def _fused_frame(dtype_name, max_new, frames, min_features=12,
                 name="fused_update_tail_add"):
    """Kernel `name`'s operands (K3's by default) in the last of `frames`
    frames of a small fused sequence (CAP 24, B = 3) on the CPU."""
    from ekf_slam_tpu_torch.config import EngineConfig
    from ekf_slam_tpu_torch.filter import engine
    from ekf_slam_tpu_torch.filter.state import init_state
    from ekf_slam_tpu_torch.sim import simulate
    cfg = EngineConfig.from_dict({
        "filter": {"fused_step": "on"}, "dtype": dtype_name,
        "map": {"capacity": 24, "min_features_in_image": min_features,
                "max_new_per_step": max_new, "max_update_obs": 16},
        "sim": {"num_landmarks": 40}})
    _, _, obs = simulate(torch.Generator().manual_seed(0), cfg, frames,
                         "cpu")
    st = engine.bootstrap(init_state(cfg, 3, "cpu"), obs.frame(0), cfg)
    u = torch.rand(frames, 3, cfg.ransac.num_hypotheses,
                   dtype=cfg.torch_dtype,
                   generator=torch.Generator().manual_seed(1))
    for t in range(1, frames - 1):
        st, _ = engine.step(st, obs.frame(t), u[t], cfg)
    with kernels.capture_operands() as captured:
        engine.step(st, obs.frame(frames - 1), u[frames - 1], cfg)
    return captured[name][0]


def test_k3_keep_fault_shows_only_on_stale_slots():
    """chip_smoke's planted K3 fault (keepN all ones): on a real frame that
    adds features the new slots' rows of P are zeros, so ignoring keepN
    changes nothing; on kernels.stale_slots(P) it reads far above the
    limit."""
    ops = list(_fused_frame("float64", 10, 3, min_features=24))
    keepN = ops[4]
    assert bool((keepN == 0).any())
    ones = torch.ones_like(keepN)
    want = kernels.update_tail_add_plain(*ops)
    blind = kernels.update_tail_add_plain(*ops[:4], ones, *ops[5:])
    assert kernels.scaled_error(blind, want) == 0.0
    ops[0] = kernels.stale_slots(ops[0], keepN)
    want = kernels.update_tail_add_plain(*ops)
    blind = kernels.update_tail_add_plain(*ops[:4], ones, *ops[5:])
    assert kernels.scaled_error(blind, want) > 100 * kernels.SCALED_TOL


def test_k3_cn_of_the_path_is_symmetric_to_rounding():
    """mapman.add_params builds CN by an einsum that does not sum entries
    (k, l) and (l, k) in the same order: on a real f32 frame of the fused
    step (CAP 24, r = 48) CN is symmetric to its last bits, not bitwise,
    and the part the V form leaves out, ENᵀ·skew(CN)·EN, reads 1.0e-7 of
    each entry's bound: under 1e-2 of the limit kernels.SCALED_TOL."""
    ops = _fused_frame("float32", 8, 2)
    EN, CN = ops[5].double(), ops[7].double()
    assert EN.shape[1] == 48
    skew = 0.5 * (CN - CN.transpose(1, 2))
    assert float(skew.abs().max()) > 0                 # not bitwise
    assert float(skew.abs().max()) <= 1e-6 * float(CN.abs().max())
    want = kernels.update_tail_add_plain(*(x.double() for x in ops))
    left_out = -EN.transpose(1, 2) @ skew @ EN
    assert kernels.scaled_error(want + left_out, want) \
        <= 1e-2 * kernels.SCALED_TOL


def _k1_operands(B, D, R, r, seed, dtype=torch.float64):
    """Random K1 operands: a symmetric P, keep mostly 1, a symmetric C66
    and Q13 (the path's Q13 is symmetric to rounding), F13 near I."""
    g = torch.Generator().manual_seed(seed)
    n = lambda *shape: torch.randn(*shape, generator=g, dtype=torch.float64)
    P, C, Q = n(B, D, D), n(B, r, r), n(B, 13, 13)
    ops = [0.5 * (P + P.transpose(1, 2)),
           (torch.rand(B, D, generator=g) > 0.15).double(), n(B, r, D),
           n(B, r, D), 0.5 * (C + C.transpose(1, 2)),
           torch.eye(13, dtype=torch.float64) + 0.3 * n(B, 13, 13),
           0.5 * (Q + Q.transpose(1, 2)), n(B, D, R)]
    return [x.to(dtype) for x in ops]


@pytest.mark.parametrize("D,B", [(19, 2), (70, 2), (613, 1)])
@pytest.mark.parametrize("R", [1, 200])
@pytest.mark.parametrize("r", [1, 6])
def test_k1_schedule_matches_plain(r, R, D, B):
    """K1's tile-pair pass and product give manage_predict_pht_plain's
    function: at f64 both outputs within F64_TOL of each entry's scale,
    every entry written; at f32 P⁻ bitwise symmetric (P, C66 and Q13
    symmetric), every diagonal block too."""
    ops = _k1_operands(B, D, R, r, 1000 * D + 10 * R + r)
    got = k1_schedule(*ops)
    want = kernels.manage_predict_pht_plain(*ops)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert within(got, want, k1_scale(*ops), F64_TOL)
    P32, pht32 = k1_schedule(*(x.float() for x in ops))
    assert P32.dtype == pht32.dtype == torch.float32
    for i0 in range(0, D, TILE):
        blk = P32[:, i0:i0 + TILE, i0:i0 + TILE]
        assert torch.equal(blk, blk.transpose(1, 2)), i0
    assert torch.equal(P32, P32.transpose(1, 2))


def test_k1_corner_follows_q13():
    """With a Q13 that is not symmetric (the path's, (G·Pn)·Gᵀ, is
    symmetric to rounding only) P⁻ is the same outside the 13 x 13 corner,
    bitwise symmetric there, and the corner is the symmetric stripe value
    plus Q13, one rounding an entry."""
    ops = _k1_operands(2, 70, 4, 6, 11, torch.float32)
    ops[6] = ops[6] + 1e-3 * torch.triu(torch.ones_like(ops[6]), 1)
    P32, _ = k1_schedule(*ops)
    bare, _ = k1_schedule(*ops[:6], torch.zeros_like(ops[6]), ops[7])
    corner = bare[:, :13, :13]
    assert torch.equal(corner, corner.transpose(1, 2))
    assert torch.equal(P32[:, :13, :13], corner + ops[6])
    assert not torch.equal(P32[:, :13, :13], P32[:, :13, :13].transpose(1, 2))
    P32[:, :13, :13] = corner
    assert torch.equal(P32, bare)
    assert torch.equal(P32, P32.transpose(1, 2))


@pytest.mark.parametrize("D,B", [(19, 2), (70, 2), (613, 1)])
@pytest.mark.parametrize("M2,R", [(1, 200), (128, 1), (128, 200)])
def test_k2_schedule_matches_plain(M2, R, D, B):
    """K2 as K5's tile-pair pass, then the product on the P it wrote:
    update_tail_pht_plain's function at f64 within F64_TOL of each entry's
    scale; at f32 P_li bitwise symmetric on a symmetric P."""
    ops = _k3_operands(B, D, M2, 0, 1000 * D + M2 + R)
    Ht = torch.randn(B, D, R, dtype=torch.float64,
                     generator=torch.Generator().manual_seed(R))
    got = k2_schedule(*ops, Ht)
    want = kernels.update_tail_pht_plain(*ops, Ht)
    scale = k3_scale(*ops)
    assert within(got, want, (scale, scale @ Ht.abs()), F64_TOL)
    P32, _ = k2_schedule(*(x.float() for x in ops), Ht.float())
    assert torch.equal(P32, P32.transpose(1, 2))


def test_k2_product_fault_reads_far_above_the_limit():
    """chip_smoke's planted K2 fault: P·Ht2 taken from the P before the
    tail, what a composed K2 gives if its product reads the wrong buffer.
    On a real f64 frame it reads far above the limit, in P·Ht2 alone."""
    ops = _fused_frame("float64", 8, 3, name="fused_update_tail_pht")
    P_li, pht = kernels.update_tail_pht_plain(*ops)
    fault = kernels.scaled_error((P_li, ops[0] @ ops[4]), (P_li, pht),
                                 ops[4])
    assert fault > 100 * kernels.SCALED_TOL


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


def test_library_call_of_k8_slab_is_its_function():
    """baddbmm(P_slab, At[:, :, r0:r0+Dl]ᵀ, Bt) is K8's row-slab form."""
    g = torch.Generator().manual_seed(3)
    P = torch.randn(2, 22, 88, generator=g, dtype=torch.float64)
    At = torch.randn(2, 40, 88, generator=g, dtype=torch.float64)
    Bt = torch.randn(2, 40, 88, generator=g, dtype=torch.float64)
    got = chip_smoke.LIBRARY["corr_apply_rows"](P, At, Bt, 44)
    want = kernels.corr_apply_rows_plain(P, At, Bt, 44)
    scale = P.abs() + At[:, :, 44:66].abs().transpose(1, 2) @ Bt.abs()
    assert bool(((got - want).abs() <= F64_TOL * scale).all())


def test_operation_count_of_k8_slab():
    """K8's row-slab form: 2R an entry of the slab's Dl x Dc (12.74 GFLOP
    at the sim config split two ways)."""
    args = (_meta(128, 307, 614), _meta(128, 264, 614), _meta(128, 264, 614))
    assert chip_smoke.FLOPS["corr_apply_rows"](*args, 307) == \
        2 * 128 * 307 * 614 * 264


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


def k7_norms_schedule(win, t):
    """K7's norms as the card forms them, in win's dtype: (var, energy)."""
    W2 = win.shape[-1]
    R2 = W2 - t + 1
    mean = win.sum(dim=2).sum(dim=1) / (W2 * W2)
    wc = win - mean[:, None, None]
    energy = (wc * wc).sum(dim=2).sum(dim=1)
    rs = sum(wc[:, :, dx:dx + R2] for dx in range(t))          # (N, W2, R2)
    rs2 = sum(wc[:, :, dx:dx + R2] ** 2 for dx in range(t))
    box = sum(rs[:, dy:dy + R2] for dy in range(t))             # (N, R2, R2)
    sq = sum(rs2[:, dy:dy + R2] for dy in range(t))
    return torch.clamp(sq - box * box / (t * t), min=0.0), energy


@pytest.mark.parametrize("N,W2,t", [(6, 37, 13), (5, 23, 7), (3, 9, 1),
                                    (2, 13, 13)])
def test_k7_norms_schedule_matches_plain(N, W2, t):
    """Direct box sums against the plain version's integral images: at f64
    within 1e-12 of each pair's Σwc²; at f32 (image-like windows, a
    constant block among them) within ncc.FLAT_EPS / 4 units of eps·Σwc²
    of the f64 variance, energies to 1e-6."""
    from ekf_slam_tpu_torch.vision import ncc
    g = torch.Generator().manual_seed(W2 + t)
    win = torch.rand(N, W2, W2, generator=g, dtype=torch.float64)
    win[0, :W2 // 2 + 1, :W2 // 2 + 1] = 0.3
    var, energy = kernels.patch_variance_plain(win, t)
    got, e = k7_norms_schedule(win, t)
    assert float(((got - var).abs() / energy[:, None, None]).max()) <= 1e-12
    torch.testing.assert_close(e, energy, rtol=1e-12, atol=0)
    v32, e32 = k7_norms_schedule(win.float(), t)
    assert kernels.var_stray(v32, var, energy) < ncc.FLAT_EPS / 4
    assert kernels.energy_error(e32, energy) <= 1e-6


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
    ("corr_apply_cols", ((128, 613, 613), (128, 613, 136), (128, 613, 136)),
     128 * 4 * (613 * 614 // 2) * 136),                  # 13.10 GFLOP
    # the downdate's 4·M2 and the add [EN; V]ᵀ[V; EN]'s 4·r an entry of the
    # triangle, V = UN + ½·CN·EN dense, the stripe's 4·4·4 an entry of the
    # 8-row stripe
    ("fused_update_tail", ((128, 613, 613), (128, 613, 128), (128, 613, 128),
                           (128, 4, 4)),
     128 * (4 * (613 * 614 // 2) * 128 + 64 * 613)),      # 12.34 GFLOP
    ("fused_update_tail_add", ((128, 613, 613), (128, 613, 128),
                               (128, 613, 128), (128, 4, 4), (128, 613),
                               (128, 60, 613), (128, 60, 613), (128, 60, 60)),
     128 * (4 * (613 * 614 // 2) * 128 + 4 * (613 * 614 // 2) * 60
            + 2 * 60 * 60 * 613 + 64 * 613)),            # 18.68 GFLOP
    # K1: the product 2·D²·R, the add 4r an entry of the triangle and
    # V = U6 + ½·C66·E6 dense, the predict stripe 4·13·13 an entry of its
    # rows
    ("fused_manage_predict_pht", ((128, 613, 613), (128, 613), (128, 6, 613),
                                  (128, 6, 613), (128, 6, 6), (128, 13, 13),
                                  (128, 13, 13), (128, 613, 200)),
     128 * (2 * 613 * 613 * 200 + 4 * (613 * 614 // 2) * 6 + 2 * 36 * 613
            + 4 * 13 * 13 * 613)),                       # 19.88 GFLOP
    # K2: K5's count and the product
    ("fused_update_tail_pht", ((128, 613, 613), (128, 613, 128),
                               (128, 613, 128), (128, 4, 4), (128, 613, 200)),
     128 * (4 * (613 * 614 // 2) * 128 + 2 * 613 * 613 * 200
            + 64 * 613)),                                # 31.58 GFLOP
    # K7: 2·N·R2²·t²; the norms form adds, a pair, 4·W2² (the mean, the
    # centring, the squares, Σwc²), t − 1 adds for each of 2·W2·R2 row sums
    # and 2·R2² column sums, 4 an offset for the variance
    ("ncc_corr", ((2, 5, 5), (2, 3, 3)), 2 * 2 * 9 * 9),
    ("ncc_corr", ((3200, 37, 37), (3200, 13, 13)),
     2 * 3200 * 25 * 25 * 13 * 13),                     # 0.676 GFLOP
    ("ncc_corr_norms", ((2, 5, 5), (2, 3, 3)),
     2 * 2 * 9 * 9 + 2 * (4 * 25 + 2 * 2 * (5 * 3 + 9) + 4 * 9)),
    ("ncc_corr_norms", ((3200, 37, 37), (3200, 13, 13)),
     2 * 3200 * 25 * 25 * 13 * 13 + 3200 * (
         4 * 37 * 37 + 2 * 12 * (37 * 25 + 25 * 25)
         + 4 * 25 * 25)),                                # 0.8206 GFLOP
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


def test_kernel_variants_edit_the_sources():
    """Every text substitution of kernel_variants finds its text exactly
    once in the source it edits (the tool raises on the card otherwise)."""
    from ekf_slam_tpu_torch import kernel_variants
    from ekf_slam_tpu_torch.ops import _build
    for name, edits in kernel_variants.VARIANTS.items():
        for file, subs in edits.items():
            text = (_build.CSRC / file).read_text()
            for old, _ in subs:
                assert text.count(old) == 1, (name, file, old)
