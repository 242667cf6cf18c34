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
