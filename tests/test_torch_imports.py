"""The PyTorch port stands alone: no file of ekf_slam_tpu_torch, and not
chip_smoke.py or the card's tests (tests/test_torch_cuda.py and its
helper), imports JAX, its libraries or the JAX package — the machine with
the card has no JAX."""

import ast
import pathlib

import pytest
import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "ekf_slam_tpu")
FILES = sorted((ROOT / "ekf_slam_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_cuda.py",
    ROOT / "tests" / "torch_scales.py"]


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_has_files():
    assert len(FILES) >= 15
    assert (ROOT / "ekf_slam_tpu_torch" / "csrc" / "fused_cov.cu").exists()


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_catches_a_jax_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import os\nfrom ekf_slam_tpu.filter import engine\n"
                 "import jax.numpy as jnp\n")
    assert {"ekf_slam_tpu", "jax"} <= set(_imported_roots(f))


# The loop-closure slice's modules: each is scanned above, and imports in a
# fresh interpreter in which JAX, its libraries and the JAX package cannot
# be imported at all.
LOOP_MODULES = (
    "ekf_slam_tpu_torch.utils.trajectory", "ekf_slam_tpu_torch.utils.metrics",
    "ekf_slam_tpu_torch.utils.checkpoint",
    "ekf_slam_tpu_torch.filter.loop_fusion",
    "ekf_slam_tpu_torch.models.keypoints", "ekf_slam_tpu_torch.models.vss",
    "ekf_slam_tpu_torch.models.flax_init",
    "ekf_slam_tpu_torch.models.loopclosure",
    "ekf_slam_tpu_torch.models.loop_runner",
    "ekf_slam_tpu_torch.run_loop_closure")


def test_loop_modules_import_without_jax():
    import subprocess
    import sys
    paths = {str(p.relative_to(ROOT)) for p in FILES}
    for mod in LOOP_MODULES:
        assert mod.replace(".", "/") + ".py" in paths, mod
    code = ("import sys\n"
            + "".join(f"sys.modules[{m!r}] = None\n" for m in FORBIDDEN)
            + "".join(f"import {m}\n" for m in LOOP_MODULES)
            + "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# The IO and driver modules: each imports in a fresh interpreter in which
# JAX, its libraries and the JAX package cannot be imported at all.
DRIVER_MODULES = (
    "ekf_slam_tpu_torch.io", "ekf_slam_tpu_torch.io.sequence",
    "ekf_slam_tpu_torch.io.poses", "ekf_slam_tpu_torch.run_slam",
    "ekf_slam_tpu_torch.close_loops")


def test_driver_modules_import_without_jax():
    import subprocess
    import sys
    code = ("import sys\n"
            + "".join(f"sys.modules[{m!r}] = None\n" for m in FORBIDDEN)
            + "".join(f"import {m}\n" for m in DRIVER_MODULES)
            + "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
