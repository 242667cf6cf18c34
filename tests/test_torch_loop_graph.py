"""The loop-closure frame as run_online replays it (models/loop_runner
.frame_driver through filter/graph.py) and the 8-point solve it calls
(ops/kernels.eight_point_fit), on the CPU.

On the card the frame is captured as a CUDA graph; capture needs the card,
and what it records is graph.py's static-buffer frame, which runs here
without a graph. So, at test_torch_loop.py's size (48x64, VSS width 8,
B = 2, its 12-frame revisit sequence):

(a) the static-buffer driver equals the eager loop bit for bit (every
    LoopStepOut field, x, P and every database field), with RANSAC's
    draws from a generator (the driver draws each frame's before it runs,
    in the eager loop's order) and as an input; its second frame reads
    nothing back to the host; the ring's store is the returned database
    itself, never a copy;
(b) eight_point_fit's plain version (the CPU path of the wrapper) against
    JAX's _eight_point at f64: F₂ up to sign to 1e-10 on full-rank
    systems; fundamental_ransac's inlier counts equal JAX's where at least
    8 points are valid, and in range where fewer are (the 8-point system
    is then rank-deficient and the two eigensolvers pick different
    vectors of its null space);
(c) the NaN fault, repaired: a system that carries a NaN gives an all-NaN
    F₂ and no inlier in both packages, where torch's eigh raised;
(d) no silent fallback: eager=False raises without a card and with a
    mesh, the CPU default is the eager loop, and the wrapper raises on
    operands it does not take.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from unittest import mock

from ekf_slam_tpu.models import loopclosure as jlc
from ekf_slam_tpu_torch.filter import graph
from ekf_slam_tpu_torch.models import flax_init, loop_runner
from ekf_slam_tpu_torch.models import loopclosure as lc
from ekf_slam_tpu_torch.models import vss
from ekf_slam_tpu_torch.ops import kernels
from test_torch_graph import NoHostReads
from test_torch_loop import D, H, W, _sequence, hypothesis_draws, j_ransac

torch.set_num_threads(1)

B = 2
LCFG = dict(capacity=16, top_k=3, exclude_recent=4, min_db=4,
            sim_threshold=0.9, min_inliers=10, ransac_hypotheses=16,
            consistency_count=2, consistency_window=3)
TOL = 1e-10


def _bits(t: torch.Tensor) -> torch.Tensor:
    ints = {torch.float64: torch.int64, torch.float32: torch.int32}
    return t.view(ints[t.dtype]) if t.dtype in ints else t


def _assert_bitwise(got, want, what):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert torch.equal(_bits(got), _bits(want)), what


@pytest.fixture(scope="module")
def loop_inputs():
    """The width-8 VSS with Flax's init, the revisit sequence of B = 2
    instances (T, B, H, W, 3), x0 and P0 at f64."""
    model = vss.VSS(vss.VSSConfig(width=8), (H, W))
    model.load_state_dict(vss.from_flax(flax_init.flax_variables(
        vss.VSSConfig(width=8), (H, W), 0)))
    imgs = torch.tensor(np.stack([_sequence(s) for s in range(B)], axis=1))
    rng = np.random.default_rng(6)
    x0 = np.zeros((B, D))
    x0[:, 3] = 1.0
    x0[:, 0:3] = rng.normal(size=(B, 3))
    return model, imgs, torch.tensor(x0), torch.tensor(
        np.stack([0.1 * np.eye(D)] * B))


def _assert_runs_equal(got, want):
    for f in lc.DB_FIELDS:
        _assert_bitwise(getattr(got[0], f), getattr(want[0], f), f"db.{f}")
    _assert_bitwise(got[1], want[1], "x")
    _assert_bitwise(got[2], want[2], "P")
    for f in loop_runner.LoopStepOut._fields:
        _assert_bitwise(getattr(got[3], f), getattr(want[3], f), f)


# --- (a) the static-buffer driver --------------------------------------------

@pytest.mark.parametrize("draws_from", ["generator", "input"])
def test_static_driver_equals_eager(loop_inputs, draws_from):
    """12 frames through frame_driver(capture=False) against the eager
    loop from the same inputs, bit for bit; loops are declared on the
    revisits and the constraint moves P."""
    model, imgs, x0, P0 = loop_inputs
    cfg = lc.LoopConfig(**LCFG)
    T = imgs.shape[0]
    if draws_from == "input":
        kw = dict(draws=torch.rand(T, B, cfg.top_k, cfg.ransac_hypotheses,
                                   model.num_kp,
                                   generator=torch.Generator().manual_seed(2)))
        kw2 = kw
    else:
        kw = dict(generator=torch.Generator().manual_seed(3))
        kw2 = dict(generator=torch.Generator().manual_seed(3))
    want = loop_runner.run_online(model, imgs, x0, P0, cfg, device="cpu",
                                  eager=True, **kw)
    got = loop_runner.frame_driver(model, imgs, x0, P0, cfg, device="cpu",
                                   capture=False, **kw2)
    _assert_runs_equal(got, want)
    assert int(want[3].declared.sum()) >= B
    assert float((want[2] - P0).abs().max()) > 1e-3
    assert want[0].count.tolist() == [T] * B


def test_static_frame_reads_nothing_back(loop_inputs):
    """The second frame of the static-buffer frame under NoHostReads (no
    .item(), bool(tensor), nonzero, boolean-mask index or tensor from host
    data: each breaks capture or syncs the card every frame)."""
    model, imgs, x0, P0 = loop_inputs
    cfg = lc.LoopConfig(**LCFG)
    _, x, P, frame, db = loop_runner._setup(model, x0, P0, cfg, 0.05, "cpu",
                                            None)
    draws = torch.rand(2, B, cfg.top_k, cfg.ransac_hypotheses, model.num_kp,
                       generator=torch.Generator().manual_seed(4))
    static = graph.StaticFrame(
        lambda c, i: loop_runner._graph_frame(c, i, frame),
        (*(getattr(db, f) for f in lc.DB_FIELDS), x, P), (imgs[0], draws[0]))
    static()
    with NoHostReads():
        static.step((imgs[1], draws[1]))
    assert static.carry[lc.DB_FIELDS.index("count")].tolist() == [2, 2]


def test_ring_is_used_in_place():
    """graph.run with in_place: those carry tensors are the static buffers
    and the final carry (the ring is never copied); the others are copies,
    and the caller's tensors keep their values."""
    def fn(carry, inputs):
        ring, n = carry
        ring[n] = inputs[0]                     # written in place, as push
        return (ring, n + 1), (n * 1,)

    ring, n0 = torch.zeros(3), torch.zeros(1, dtype=torch.int64)
    (r, n), (seen,) = graph.run(fn, (ring, n0),
                                lambda t: (torch.full((1,), t + 1.0),), 3,
                                None, capture=False, in_place=[0])
    assert r is ring and ring.tolist() == [1.0, 2.0, 3.0]
    assert n is not n0 and n.tolist() == [3] and n0.tolist() == [0]
    assert seen.tolist() == [[0, 1, 2]]


# --- (b) the 8-point solve against JAX ---------------------------------------

def test_eight_point_fit_matches_jax():
    """Six hypotheses of 12 weighted correspondences each (a full-rank
    9x9 system, its spectrum separated) through the port's _eight_point
    (eight_point_fit's plain version) and JAX's, f64: F₂ up to sign to
    1e-10."""
    rng = np.random.default_rng(8)
    K, NH = 12, 6
    p1 = np.concatenate([rng.uniform(-1.4, 1.4, (K, 2)), np.ones((K, 1))], 1)
    p2 = np.concatenate([rng.uniform(-1.4, 1.4, (K, 2)), np.ones((K, 1))], 1)
    w = rng.uniform(0.5, 1.5, (NH, K))
    j8 = jax.jit(jlc._eight_point)
    ref = np.stack([np.asarray(j8(jnp.asarray(p1), jnp.asarray(p2),
                                  jnp.asarray(w[h]))) for h in range(NH)])
    got = lc._eight_point(torch.tensor(p1), torch.tensor(p2),
                          torch.arange(K).expand(NH, K),
                          torch.tensor(w)).numpy()
    assert np.isfinite(ref).all()
    for h in range(NH):
        sign = np.sign(np.sum(got[h] * ref[h]))
        np.testing.assert_allclose(sign * got[h], ref[h], rtol=0, atol=TOL)


@pytest.mark.parametrize("n_valid", [5, 7, 8, 24])
def test_rank_deficient_inliers_match_jax(n_valid):
    """fundamental_ransac in both packages with n_valid of 64 points
    valid, JAX's draws: with fewer than 8 valid every hypothesis samples a
    zero-weight point (the system has a null space of 2 or more
    dimensions, the count is each solver's choice: in range, and no
    exception); with 8 or more the counts are equal."""
    cfg = lc.LoopConfig(ransac_hypotheses=16, ransac_threshold=1.0)
    jcfg = jlc.LoopConfig(ransac_hypotheses=16, ransac_threshold=1.0)
    rng = np.random.default_rng(n_valid)
    pts1 = rng.uniform(0, 100, (64, 2))
    pts2 = pts1 + np.array([3.0, 1.0]) + rng.normal(0, 0.3, (64, 2))
    valid = np.zeros(64, bool)
    valid[rng.choice(64, n_valid, replace=False)] = True
    key = jax.random.key(n_valid)
    ref = int(j_ransac(jnp.asarray(pts1), jnp.asarray(pts2),
                       jnp.asarray(valid), jcfg, key))
    got = int(lc.fundamental_ransac(
        torch.tensor(pts1), torch.tensor(pts2), torch.tensor(valid), cfg,
        torch.tensor(hypothesis_draws(key, 16, 64))))
    if n_valid >= 8:
        assert got == ref
    else:
        assert 0 <= got <= n_valid and 0 <= ref <= n_valid


# --- (c) the NaN fault -------------------------------------------------------

def test_eight_point_nan_matches_jax():
    """A hypothesis whose system carries a NaN: JAX's eigh and svd return
    NaN, and so does the port's solve (torch's eigh raised on it before).
    _eight_point: the hypothesis with a NaN point gives an all-NaN F₂ in
    both packages (the port's other hypotheses stay finite; JAX weighs
    every point, so a NaN anywhere reaches every hypothesis). The wrapper
    on a batch with NaN and ±inf systems: all NaN there, the finite
    systems' F₂ unchanged. fundamental_ransac with a NaN point: 0 inliers
    in both, no exception."""
    rng = np.random.default_rng(9)
    K = 12
    p1 = np.concatenate([rng.uniform(-1, 1, (K, 2)), np.ones((K, 1))], 1)
    p2 = np.concatenate([rng.uniform(-1, 1, (K, 2)), np.ones((K, 1))], 1)
    p1[3, 0] = np.nan
    w = np.ones(K)
    ref = np.asarray(jax.jit(jlc._eight_point)(jnp.asarray(p1),
                                               jnp.asarray(p2),
                                               jnp.asarray(w)))
    assert np.isnan(ref).all()
    sel = torch.tensor([[0, 1, 2, 3, 4, 5, 6, 7], [4, 5, 6, 7, 8, 9, 10, 11]])
    got = lc._eight_point(torch.tensor(p1), torch.tensor(p2), sel,
                          torch.ones(2, 8, dtype=torch.float64))
    assert torch.isnan(got[0]).all() and torch.isfinite(got[1]).all()

    A = torch.randn(6, 12, 9, generator=torch.Generator().manual_seed(1),
                    dtype=torch.float64)
    M = A.transpose(1, 2) @ A
    bad = M.clone()
    bad[1, 2, 5] = torch.nan
    bad[3, 0, 0] = torch.inf
    bad[4, 8, 1] = -torch.inf
    F2 = kernels.eight_point_fit(bad)
    finite = torch.tensor([True, False, True, False, False, True])
    assert torch.isnan(F2[~finite]).all()
    _assert_bitwise(F2[finite], kernels.eight_point_fit(M[finite]),
                    "finite systems")

    cfg, jcfg = lc.LoopConfig(ransac_hypotheses=16), jlc.LoopConfig(
        ransac_hypotheses=16)
    pts1 = rng.uniform(0, 100, (64, 2))
    pts2 = pts1 + 2.0
    pts1[10, 1] = np.nan
    valid = np.ones(64, bool)
    key = jax.random.key(5)
    assert int(j_ransac(jnp.asarray(pts1), jnp.asarray(pts2),
                        jnp.asarray(valid), jcfg, key)) == 0
    assert int(lc.fundamental_ransac(
        torch.tensor(pts1), torch.tensor(pts2), torch.tensor(valid), cfg,
        torch.tensor(hypothesis_draws(key, 16, 64)))) == 0


# --- (d) no silent fallback --------------------------------------------------

def test_replay_without_a_card_or_with_a_mesh_raises(loop_inputs):
    model, imgs, x0, P0 = loop_inputs
    cfg = lc.LoopConfig(**LCFG)
    with pytest.raises(ValueError, match="CUDA graph"):
        loop_runner.run_online(model, imgs[:2], x0, P0, cfg, device="cpu",
                               eager=False)
    with pytest.raises(ValueError, match="gloo"):
        loop_runner.run_online(model, imgs[:2], x0, P0, cfg,
                               mesh=mock.Mock(device=torch.device("cpu")),
                               eager=False)


def test_cpu_default_is_the_eager_loop(loop_inputs):
    """eager=None on the CPU never reaches graph.py."""
    model, imgs, x0, P0 = loop_inputs
    cfg = lc.LoopConfig(**LCFG)
    with mock.patch.object(graph, "run", side_effect=AssertionError):
        loop_runner.run_online(model, imgs[:3], x0, P0, cfg, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    assert graph.replays(torch.device("cpu"), None) is False


def test_eight_point_wrapper_rejects_what_it_does_not_take():
    M = torch.randn(4, 9, 9)
    with pytest.raises(ValueError, match="shape"):
        kernels.eight_point_fit(M[:, :8])
    with pytest.raises(ValueError, match="contiguous"):
        kernels.eight_point_fit(M.transpose(1, 2))
