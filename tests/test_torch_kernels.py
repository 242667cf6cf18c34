"""K1, K2, K3 of the port against the JAX Pallas kernels.

Inputs are the kernels' real operands in one fused frame: a JAX engine
state at test_fused_step.py's config (CAP 24, D = 157, 2·CAP = 48,
2M = 32, feature-add rank 6K = 48) stepped by the port, whose wrappers
are recorded. On CPU tensors the wrappers run the plain versions (f64);
the JAX side runs ops/pallas_kernels in interpret mode, f64. Tolerance
rtol 1e-10 / atol 1e-12: the same sums in another order.

The hand-written CUDA kernels against these plain versions: test_torch_cuda.py
(needs a card)."""

import jax
import numpy as np
import pytest
import torch

from ekf_slam_tpu.ops import pallas_kernels as pk
from torch_parity import (FUSED, configs, frame, frame_keys, interpret_mode,
                          n, port_obs, port_state, ransac_u,
                          sim_and_bootstrap, step_fn)

from ekf_slam_tpu_torch.filter import engine
from ekf_slam_tpu_torch.ops import _build, kernels

torch.set_num_threads(1)

B = 3
NAMES = ["fused_manage_predict_pht", "fused_update_tail_pht",
         "fused_update_tail_add"]
PLAIN = kernels.PLAIN
TOL = dict(rtol=1e-10, atol=1e-12)


@pytest.fixture(scope="module")
def operands():
    """{kernel name: its (B, ...) f64 operands} from the port's fused step
    on frame 2 of a JAX-stepped state (the map still grows there)."""
    jc, tc = configs(FUSED)
    with interpret_mode():
        _, obs, jst = sim_and_bootstrap(jc, 2, 3, B)
        jst, _ = step_fn(jc)(jst, frame(obs, 1), frame_keys(1, B))
    u = torch.tensor(ransac_u(frame_keys(2, B), jc.ransac.num_hypotheses))
    with kernels.capture_operands() as captured:
        engine.step(port_state(jst), port_obs(frame(obs, 2)), u, tc)
    return {name: calls[-1] for name, calls in captured.items()}


def _jax_kernel(name, args):
    with interpret_mode():
        fn = jax.jit(getattr(pk, name))
        return fn(*(jax.numpy.asarray(n(a)) for a in args))


def _pairs(out, ref):
    out = out if isinstance(out, tuple) else (out,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(out) == len(ref)
    return zip(out, ref)


def test_operands_are_realistic(operands):
    """The frame exercises every term: deleted or fresh dims in K1's keep
    mask, visible slots in Ht, inliers in K and new features in K3."""
    P, keep, E6, U6, C66, F13, Q13, Ht = operands["fused_manage_predict_pht"]
    assert P.shape == (B, 157, 157) and Ht.shape == (B, 157, 48)
    assert bool((Ht != 0).any(dim=1).any())
    K = operands["fused_update_tail_pht"][1]
    assert K.shape == (B, 157, 32) and bool((K != 0).any())
    keepN, EN = operands["fused_update_tail_add"][4:6]
    assert EN.shape == (B, 48, 157)
    assert bool((keepN == 0).any()) and bool((EN.sum(dim=2) > 0).any())


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("batch", [1, B], ids=["single", "batch3"])
def test_plain_matches_pallas_interpret(operands, name, batch):
    args = tuple(a[:batch] for a in operands[name])
    got = getattr(kernels, name)(*args)            # CPU -> plain version
    want = _jax_kernel(name, args)
    for g, w in _pairs(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(n(g), np.asarray(w), **TOL)


@pytest.mark.parametrize("name", NAMES)
def test_cpu_tensors_take_the_plain_version(operands, name):
    before = dict(kernels.LAUNCHES)
    got = getattr(kernels, name)(*operands[name])
    for g, w in _pairs(got, PLAIN[name](*operands[name])):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("name", NAMES)
def test_wrapper_rejects_bad_operands(operands, name):
    args = list(operands[name])
    fn = getattr(kernels, name)
    bad_shape = args[:1] + [args[1][..., :-1].contiguous()] + args[2:]
    with pytest.raises(ValueError, match="shape"):
        fn(*bad_shape)
    P = args[0]
    strided = torch.empty(P.shape[0], P.shape[2], P.shape[1],
                          dtype=P.dtype).transpose(1, 2)
    strided.copy_(P)
    with pytest.raises(ValueError, match="contiguous"):
        fn(strided, *args[1:])


def _no_q(P, keep, E6, U6, C66, F13, Q13, Ht):
    return kernels.manage_predict_pht_plain(P, keep, E6, U6, C66, F13,
                                            torch.zeros_like(Q13), Ht)


def _k1_rows_only(P, keep, E6, U6, C66, F13, Q13, Ht):
    """K1 with Lp applied to the rows of the camera stripe only."""
    Pm = kernels._lowrank(kernels._keep_mask(P, keep), E6, U6, C66)
    Pm = torch.cat([F13 @ Pm[:, :13], Pm[:, 13:]], dim=1)
    Pm[:, :13, :13] += Q13
    return Pm, Pm @ Ht


def _k2_rows_only(P, K, PHt, Jq4, Ht):
    """K2 with the quaternion renorm applied to the rows only."""
    out = P - 0.5 * (K @ PHt.transpose(1, 2) + PHt @ K.transpose(1, 2))
    out = torch.cat([out[:, :3], Jq4 @ out[:, 3:7], out[:, 7:]], dim=1)
    return out, out @ Ht


def _k3_one_sided_add(P, K, PHt, Jq4, keepN, EN, UN, CN):
    """K3 with the feature add's UNᵀEN term left out."""
    out = kernels._keep_mask(kernels._tail(P, K, PHt, Jq4), keepN)
    return out + EN.transpose(1, 2) @ (UN + CN @ EN)


@pytest.mark.parametrize("name,fault", [
    ("fused_manage_predict_pht", _no_q),
    ("fused_manage_predict_pht", _k1_rows_only),
    ("fused_update_tail_pht", _k2_rows_only),
    ("fused_update_tail_add", _k3_one_sided_add),
], ids=["k1_no_q", "k1_rows_only", "k2_rows_only", "k3_one_sided_add"])
def test_scaled_error_sees_planted_faults(operands, name, fault):
    """The kernel check (kernels.scaled_error under kernels.SCALED_TOL,
    used by chip_smoke and the card tests) reads each planted fault at
    1e-2 or more, while the same plain version in f32 passes it. K1
    without Q̃ is ~5e-5 of max|P| — a check scaled to the whole matrix
    would pass it."""
    args = operands[name]
    Ht = args[-1] if name != "fused_update_tail_add" else None
    ref = PLAIN[name](*args)
    assert kernels.scaled_error(fault(*args), ref, Ht) > 1e-2
    f32 = PLAIN[name](*(a.float() for a in args))
    assert kernels.scaled_error(f32, ref, Ht) <= kernels.SCALED_TOL


def test_k3_sees_the_stripe_k1_and_k2_leave_symmetric(operands):
    """The kernels' precondition: P enters K2 and K3 symmetric."""
    for name in ("fused_update_tail_pht", "fused_update_tail_add"):
        P = operands[name][0]
        torch.testing.assert_close(P, P.transpose(1, 2), rtol=0, atol=1e-12)


def test_build_needs_nvcc(monkeypatch, tmp_path):
    """Without nvcc the build raises; no fallback."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()


def test_build_compiles_each_source_then_links(monkeypatch, tmp_path):
    """build() starts one nvcc -c per .cu (headers are not compiled), then
    one -shared link of all the objects; it leaves the library and the
    log, not the objects. A stand-in nvcc records its arguments and
    writes its -o file."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    calls = tmp_path / "calls.txt"
    nvcc = bin_dir / "nvcc"
    nvcc.write_text("#!/bin/sh\n"
                    f'echo "$@" >> "{calls}"\n'
                    'while [ "$#" -gt 0 ]; do\n'
                    '  if [ "$1" = "-o" ]; then : > "$2"; fi; shift\n'
                    "done\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    lib, log = _build.build()
    assert lib.exists() and (lib.parent / "nvcc.log").exists()
    assert not list(lib.parent.glob("*.o"))
    lines = calls.read_text().splitlines()
    cu = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    compiles = sorted(line.split()[-1].rsplit("/", 1)[-1]
                      for line in lines if " -c " in line)
    assert compiles == cu and len(cu) >= 2
    links = [line for line in lines if " -c " not in line]
    assert len(links) == 1 and links[0].startswith("-shared")
    assert sum(a.endswith(".o") for a in links[0].split()) == len(cu)
    assert _build.build() == (lib, "")                  # cached


def test_library_path_keyed_by_sources():
    p = _build.library_path()
    assert p.name == _build.LIB_NAME
    assert p.parent.parent == _build.BUILD_DIR
    assert p == _build.library_path()
