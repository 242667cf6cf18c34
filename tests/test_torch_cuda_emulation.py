"""K1, K2 and K3 / K5 of csrc/fused_cov.cu, K4, K6 and K8 (and K8's
row-slab form) of csrc/unfused_cov.cu, K7 of csrc/ncc.cu (both forms),
eight_point_fit of csrc/eight_point.cu, spd_inverse_newton of
csrc/newton_inverse.cu and pht_blocks of csrc/pht_blocks.cu — the CUDA
source itself — run on
the CPU: compiled by g++ against the
stand-in headers of tests/cuda_emulation (one host thread a CUDA thread,
__syncthreads a barrier, __syncwarp one of the warp's threads, shared
memory poisoned with NaN, the asynchronous copies done at once with their
alignment checked), under
AddressSanitizer, and held against a plain f64 loop by
tests/cuda_emulation/harness.cpp.

What it can show: a wrong index, mask, ragged edge, tile pair, mirror,
micro-tile, staging buffer or persistent block's group; a
read of a word nobody staged; a read or write outside an operand; a bulk
copy that is not 16-byte aligned; every entry written; bitwise symmetry
(K4; K8 "full" and "expr" on a symmetric P; K1, K2, K3 / K5 on a
symmetric P).
What it cannot:
races, asynchrony, anything about speed — those are the card's
(tests/test_torch_cuda.py). Tolerances are the harness's: 1e-5 of each
entry's own scale Σ|a||b| (f32 chains against f64), one bf16 ulp more on a
bf16 output; K7's variance 1e-5 of its pair's Σwc²; eight_point_fit's
eigenvector and F₂ 4 of their first-order f32 perturbation bounds against
an f64 Jacobi, and bit for bit against itself launched again and each
matrix alone (harness.cpp run_ep); spd_inverse_newton's inverse each
entry within 4·κ̂·ε·√(X_ii·X_jj) of an f64 loop of the same 20 iterations
(κ̂ the Jacobi-scaled condition: where f32 Newton–Schulz settles), NaN
where that loop is NaN, and bit for bit against each instance launched
alone (harness.cpp run_nsi); pht_blocks' outputs, written to a file,
against its plain version (kernels.pht_blocks_plain) in f64 on the same
operands, each entry in units of its Cauchy–Schwarz bound
(kernels.pht_blocks_error), limit kernels.SCALED_TOL.

Skips where no g++ with C++20's <barrier> is installed."""

import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from ekf_slam_tpu_torch.ops import kernels

ROOT = pathlib.Path(__file__).resolve().parent.parent
EMU = ROOT / "tests" / "cuda_emulation"
CSRC = ROOT / "ekf_slam_tpu_torch" / "csrc"
FLAGS = ["-std=c++20", "-O1", "-fsanitize=address", "-x", "c++"]

# kernel, P / A type, then B M K N misalign (K6) or B D R mode symP (K8)
K6_CASES = [(t, 2, 70, 70, n, 0) for t in ("f32", "bf16")
            for n in (1, 31, 48, 64, 128, 200)] + [
    ("f32", 1, 157, 157, 300, 0),                 # 3 chunks of 128
    ("f32", 1, 50, 140, 48, 0), ("bf16", 1, 140, 50, 64, 0),   # M != K
    ("f32", 2, 19, 19, 128, 1), ("bf16", 2, 19, 19, 31, 1),    # below a tile
    ("bf16", 1, 157, 157, 64, 1)]
K8_CASES = [(t, b, d, r, mode, sym)
            for t in ("f32", "bf16")
            for b, d, r in ((2, 70, 56), (2, 19, 1), (1, 157, 20))
            for mode, sym in ((0, 0), (1, 0), (1, 1), (2, 0))]
# P type, then B Dl Dc R r0 (K8's row-slab form): the sharded step's slabs
# at D = 85 split two and four ways (Dp = 86, 88) and a slab of three
# row tiles past one of Dc's column tiles, R below and past one
# contraction tile, the first and the last slab
K8S_CASES = [(t, b, dl, dc, r, r0)
             for t in ("f32", "bf16")
             for b, dl, dc, r, r0 in ((2, 43, 86, 32, 0), (2, 43, 86, 32, 43),
                                      (1, 22, 88, 1, 66),
                                      (1, 157, 200, 20, 43))]
# P type, then B D R
K4_CASES = [(t, b, d, r) for t in ("f32", "bf16")
            for b, d, r in ((2, 70, 56), (2, 19, 1), (1, 157, 20))]
# B D M2 r symP (r = 0: K5)
K3_CASES = [(2, 70, m2, r, 1) for r in (0, 6, 60) for m2 in (1, 20)] + [
    (2, 19, 20, 6, 1), (2, 19, 1, 0, 1),      # one ragged tile, D < 64
    (1, 157, 20, 60, 1),                      # the stripe on a twin pair
    (1, 70, 3, 128, 1),                       # r at its limit
    (1, 70, 20, 6, 0), (1, 70, 20, 0, 0)]     # P not symmetric: values
# B D R r symP (K1), B D M2 R symP (K2): one ragged tile (D = 19 < 64),
# two, and three (the stripe on twin pairs); R below one 4-column group,
# ragged, and the bench's 2·CAP = 200 (two of K6's 128-column chunks, at
# D = 70 on two instances: every operand's batch offset); r = 1 and the
# path's 6, M2 below one and past two contraction tiles; P asymmetric once
K1_CASES = [(1, 19, 1, 1, 1), (1, 19, 31, 1, 1), (1, 70, 1, 6, 1),
            (2, 70, 200, 6, 1), (1, 157, 31, 6, 1), (1, 70, 31, 6, 0)]
K2_CASES = [(1, 19, 1, 1, 1), (1, 19, 20, 31, 1), (1, 70, 20, 1, 1),
            (2, 70, 20, 200, 1), (1, 157, 20, 31, 1), (1, 70, 20, 31, 0)]
# N W2 t norms (K7). The stand-in card holds two blocks, so a launch of
# more groups than two walks each block over several (the persistent loop,
# its one staging buffer restaged for each group). At 5 x 5 micro-tiles and 128 threads: the bench
# shape (t = 13, compiled unrolled: 5 pairs a group, 11 = 5 + 5 + 1) in
# both forms; R2 = 21, ragged micro-tiles (13 = 5 + 5 + 3); t = 7 at run
# time (R2 = 17 ragged, 7 pairs in one group) in both forms; t = W2 (one
# offset); t = 1; t = 6 on 30 pairs (14 + 14 + 2 a group).
K7_CASES = [(11, 37, 13, 0), (11, 37, 13, 1), (13, 33, 13, 1), (7, 23, 7, 0),
            (7, 23, 7, 1), (3, 13, 13, 1), (3, 9, 1, 1), (30, 20, 6, 1)]

# case, N (eight_point_fit, three matrices a block): 8-point systems of 8
# to 12 rows, N one matrix, whole blocks (45, 33) and a last block of one
# (64) and of two (11); a repeated eigenvalue above a single smallest one
# and a repeated smallest one; zero-weight rows (a null space of 2 to 4
# dimensions); NaN and ±inf entries among finite systems; the identity and
# 4·I; systems scaled by 2^+40 and 2^-40
EP_CASES = [(0, 1), (0, 45), (0, 33), (0, 64), (1, 45), (2, 45), (3, 45),
            (4, 33), (5, 12), (0, 11)]

# B n case (spd_inverse_newton): both blocks (NP = 64 for n <= 64, 128
# above), n below one k chunk of 4 and ragged against it (1, 2, 3, 127),
# the fast mode's 48, each block full (64, 128); case 0 four SPD instances
# of condition 1e1 to 1e4, cases 1-3 an SPD instance and one with a NaN
# entry, an infinite entry, or a diagonal entry not > 0 (harness.cpp
# nsi_operand)
NSI_CASES = [(4 if case == 0 else 2, n, case)
             for n in (1, 2, 3, 12, 48, 64, 127, 128) for case in range(4)]

# P type, then B CAP M (pht_blocks): one block's column tile with M = 3
# of an odd CAP (its last chunk one slot) and M = CAP, the IEKF cell's
# 2M = 128 (M = 64 of CAP 70, D = 433), and two column tiles (M = 70);
# sel unsorted, a quarter of the slots masked (zero blocks) in each
PHT_CASES = [(t, b, cap, m) for t in ("f32", "bf16")
             for b, cap, m in ((2, 5, 3), (2, 5, 5), (1, 70, 64),
                               (1, 70, 70))]


@pytest.fixture(scope="module")
def emulate(tmp_path_factory):
    """The harness, built once: a function (args) -> CompletedProcess."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++: the CUDA sources are compiled for the host")
    out = tmp_path_factory.mktemp("cuda_emulation")
    probe = out / "probe.cpp"
    probe.write_text("#include <barrier>\nint main() { std::barrier<> b(1); "
                     "b.arrive_and_wait(); }\n")
    if subprocess.run([gxx, "-std=c++20", str(probe), "-o",
                       str(out / "probe"), "-lpthread"],
                      capture_output=True).returncode != 0:
        pytest.skip("needs a g++ with C++20's <barrier>")
    binary = out / "emulate"
    build = subprocess.run(
        [gxx, *FLAGS, "-I", str(EMU), "-I", str(CSRC),
         str(EMU / "harness.cpp"), "-o", str(binary), "-lpthread"],
        capture_output=True, text=True)
    assert build.returncode == 0, build.stderr[-4000:]

    def run(*args):
        return subprocess.run([str(binary), *map(str, args)],
                              capture_output=True, text=True, timeout=300)
    return run


@pytest.mark.parametrize("case", K6_CASES, ids=lambda c: "-".join(map(str, c)))
def test_emulated_matmul_big(emulate, case):
    """K6 at both column blockings (64, 128), widths that are no
    multiple of 4, a width past one 128-column chunk, M != K, A below one
    tile, C off a 16-byte boundary, f32 and bf16 A."""
    done = emulate("k6", *case)
    assert done.returncode == 0, done.stdout + done.stderr[-3000:]


@pytest.mark.parametrize("case", K8_CASES, ids=lambda c: "-".join(map(str, c)))
def test_emulated_corr_apply(emulate, case):
    """K8 in its three modes on an f32 and a bf16 P (whose matrices start
    on odd 2-byte offsets), D of one ragged tile, of two and of three
    tiles, R below and past one contraction tile; "full" and "expr" on a
    symmetric P bitwise symmetric."""
    done = emulate("k8", *case)
    assert done.returncode == 0, done.stdout + done.stderr[-3000:]


@pytest.mark.parametrize("case", K8S_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_emulated_corr_apply_rows(emulate, case):
    """K8's row-slab form (mode "none") on slabs of an f32 and a bf16 P at
    odd 2-byte offsets: the first and the last slab of a split, ragged
    row and column tiles, R below and past one contraction tile."""
    done = emulate("k8s", *case)
    assert done.returncode == 0, done.stdout + done.stderr[-3000:]


@pytest.mark.parametrize("case", K4_CASES, ids=lambda c: "-".join(map(str, c)))
def test_emulated_corr_apply_cols(emulate, case):
    """K4 on an f32 and a bf16 P (matrices on odd offsets) from an
    asymmetric P: D of one ragged tile, of two and of three tiles, R below
    and past one contraction tile; every entry written, the output bitwise
    symmetric."""
    done = emulate("k4", *case)
    assert done.returncode == 0, done.stdout + done.stderr[-3000:]


@pytest.mark.parametrize("case", K3_CASES, ids=lambda c: "-".join(map(str, c)))
def test_emulated_update_tail_add(emulate, case):
    """K3 at r = 6, 60 and 128 and K5 (r = 0) at M2 below one and past two
    contraction tiles: the downdate, the renorm stripe on the pairs of tile
    row 0 (diagonal and twin), the keep mask, the add through V (its
    prologue's zero padding at r = 6); one ragged tile (D = 19) and three
    tiles; bitwise symmetric on a symmetric P, and right on an asymmetric
    one."""
    done = emulate("k3", "f32", *case)
    assert done.returncode == 0, done.stdout + done.stderr[-3000:]


@pytest.mark.parametrize("case", K1_CASES, ids=lambda c: "-".join(map(str, c)))
def test_emulated_manage_predict_pht(emulate, case):
    """K1's three launches (V = U6 + ½·C66·E6, the tile-pair pass, K6's
    product): the keep mask, the rank-2r add through V, the 16-wide predict
    stripe on the pairs of tile row 0 (twin pairs at D = 157), the 16 x 16
    corner's lower entries from its upper ones, Q̃ on (0, 0), then P⁻·Ht at
    R below one column group, ragged, and 200 (two 128-column chunks);
    bitwise symmetric on a symmetric P, C66 and Q13, and right on an
    asymmetric P."""
    done = emulate("k1", "f32", *case)
    assert done.returncode == 0, done.stdout + done.stderr[-3000:]


@pytest.mark.parametrize("case", K2_CASES, ids=lambda c: "-".join(map(str, c)))
def test_emulated_update_tail_pht(emulate, case):
    """K2's two launches (K5's tail, then K6's product on the P it wrote):
    M2 below one and past two contraction tiles, R as for K1; bitwise
    symmetric on a symmetric P, right on an asymmetric one."""
    done = emulate("k2", "f32", *case)
    assert done.returncode == 0, done.stdout + done.stderr[-3000:]


@pytest.mark.parametrize("case", K7_CASES, ids=lambda c: "-".join(map(str, c)))
def test_emulated_ncc_corr(emulate, case):
    """K7, ncc_corr (norms 0) and ncc_corr_norms (1): the correlation of
    every offset, and the patch variances and energies from direct box
    sums of the staged window, with the template width compiled unrolled
    (13) and at run time, ragged micro-tiles and groups, several groups a
    block; every output written."""
    done = emulate("k7", "f32", *case)
    assert done.returncode == 0, done.stdout + done.stderr[-3000:]


@pytest.mark.parametrize("case", EP_CASES, ids=lambda c: "-".join(map(str, c)))
def test_emulated_eight_point_fit(emulate, case):
    """eight_point_fit through its launcher: every output of a ragged last
    block written; a second launch, and each matrix launched alone, equal
    bit for bit to the batched launch (the warp's three matrices solve
    together: a result depends on no neighbour, place or N); the
    eigenvector unit, in the smallest eigenspace (Rayleigh quotient) and,
    where that eigenvalue is single, the f64 one up to sign; F₂ the rank-2
    projection of it; all NaN for a non-finite system, e₀e₀ᵀ for the
    identity; the same on systems scaled by 2^±40."""
    done = emulate("ep", "f32", *case)
    assert done.returncode == 0, done.stdout + done.stderr[-3000:]


@pytest.mark.parametrize("case", NSI_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_emulated_spd_inverse_newton(emulate, case):
    """spd_inverse_newton through its launcher: the preconditioner (d not
    > 0 replaced by 1, the Gershgorin bound, NaN carried through its
    maximum) and the 20 iterations against an f64 loop of the same
    function, each entry within 4·κ̂·ε·√(X_ii·X_jj) (κ̂ the condition of
    the Jacobi-scaled S: f32 Newton–Schulz settles about κ·ε from the f64
    one, relative to X's own scale; the reason in full at harness.cpp
    run_nsi); NaN where the f64 loop is NaN and not finite where it is
    infinite; every entry written; each instance launched alone equal bit
    for bit to its place in the batch."""
    done = emulate("nsi", "f32", *case)
    assert done.returncode == 0, done.stdout + done.stderr[-3000:]


def pht_operands(ptype, B, cap, M, seed=0):
    """pht_blocks' operands: an SPD P (B,D,D) stored in `ptype`, random
    blocks of M distinct unsorted slots a quarter of them zeroed (masked),
    unit-scale noise r."""
    g = torch.Generator().manual_seed(seed)
    D = 13 + 6 * cap
    A = torch.randn(B, D, D, generator=g, dtype=torch.float64)
    P = (A @ A.transpose(1, 2) / D + 0.1 * torch.eye(D, dtype=torch.float64))
    P = P.to(torch.bfloat16 if ptype == "bf16" else torch.float32)
    sel = torch.stack([torch.randperm(cap, generator=g)[:M]
                       for _ in range(B)])
    keep = (torch.rand(B, M, 1, 1, generator=g) > 0.25).float()
    H_xv = torch.randn(B, M, 2, 13, generator=g) * keep
    H_y = torch.randn(B, M, 2, 6, generator=g) * keep
    r = torch.rand(B, 2 * M, generator=g) + 0.5
    return P, H_xv, H_y, sel, r


@pytest.mark.parametrize("case", PHT_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_emulated_pht_blocks(emulate, tmp_path, case):
    """pht_blocks through its launcher, P at an odd offset in a larger
    buffer and every output entry NaN until written, against its plain
    version in f64 on the same operands: P·Hᵀ each entry within
    SCALED_TOL of its bound sqrt(P_ii·(HPHᵀ)_kk), S within SCALED_TOL of
    sqrt(S_rr·S_ss); every entry written; the camera and landmark
    columns of every gathered slot, its rows of S, both column tiles."""
    ptype, B, cap, M = case
    P, H_xv, H_y, sel, r = pht_operands(ptype, B, cap, M)
    D = P.shape[1]
    src, dst = tmp_path / "in.bin", tmp_path / "out.bin"
    with open(src, "wb") as f:
        np.array([B, D, M], np.int32).tofile(f)
        (P.view(torch.int16) if ptype == "bf16" else P).numpy().tofile(f)
        for t in (H_xv, H_y, sel, r):
            t.numpy().tofile(f)
    done = emulate("pht", ptype, src, dst)
    assert done.returncode == 0, done.stdout + done.stderr[-3000:]
    out = np.fromfile(dst, np.float32, offset=4)
    PHt = torch.from_numpy(out[:B * D * 2 * M]).reshape(B, D, 2 * M)
    S = torch.from_numpy(out[B * D * 2 * M:]).reshape(B, 2 * M, 2 * M)
    assert torch.isfinite(PHt).all() and torch.isfinite(S).all()
    err = kernels.pht_blocks_error((PHt, S), P, H_xv, H_y, sel, r)
    assert err <= kernels.SCALED_TOL, err
