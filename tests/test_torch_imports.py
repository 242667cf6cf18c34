"""The PyTorch port stands alone: no file of ekf_slam_tpu_torch, and not
chip_smoke.py, the card's tests (tests/test_torch_cuda.py and its
helper) or the ranks of the multi-process tests
(tests/torch_parallel_ranks.py), imports JAX, its libraries or the JAX
package — the machine with the card has no JAX."""

import ast
import pathlib

import pytest
import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "ekf_slam_tpu")
FILES = sorted((ROOT / "ekf_slam_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_cuda.py",
    ROOT / "tests" / "torch_scales.py",
    ROOT / "tests" / "torch_parallel_ranks.py"]


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


# The training and evaluation slice's modules: each imports in a fresh
# interpreter in which JAX, its libraries and the JAX package cannot be
# imported at all (PIL is imported only when coco.py reads a file).
TRAIN_MODULES = (
    "ekf_slam_tpu_torch.models.augment", "ekf_slam_tpu_torch.models.evaluate",
    "ekf_slam_tpu_torch.models.losses", "ekf_slam_tpu_torch.models.train",
    "ekf_slam_tpu_torch.data", "ekf_slam_tpu_torch.data.synthetic",
    "ekf_slam_tpu_torch.data.classes", "ekf_slam_tpu_torch.data.records",
    "ekf_slam_tpu_torch.data.coco", "ekf_slam_tpu_torch.data.coco_min",
    "ekf_slam_tpu_torch.train_calc2", "ekf_slam_tpu_torch.calc2_bundled_run")


def test_training_modules_import_without_jax():
    import subprocess
    import sys
    paths = {str(p.relative_to(ROOT)) for p in FILES}
    for mod in TRAIN_MODULES:
        stem = mod.replace(".", "/")
        assert stem + ".py" in paths or stem + "/__init__.py" in paths, mod
    code = ("import sys\n"
            + "".join(f"sys.modules[{m!r}] = None\n"
                      for m in FORBIDDEN + ("PIL",))
            + "".join(f"import {m}\n" for m in TRAIN_MODULES)
            + "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# The multi-process layer and its drivers: each imports in a fresh
# interpreter in which JAX, its libraries and the JAX package cannot be
# imported at all (the ranks of its tests import them so, too).
PARALLEL_MODULES = (
    "ekf_slam_tpu_torch.parallel", "ekf_slam_tpu_torch.parallel.mesh",
    "ekf_slam_tpu_torch.parallel.sharded_filter",
    "ekf_slam_tpu_torch.parallel.sharded_loopdb",
    "ekf_slam_tpu_torch.run_tp_filter", "ekf_slam_tpu_torch.dryrun_multichip")


def test_parallel_modules_import_without_jax():
    import subprocess
    import sys
    paths = {str(p.relative_to(ROOT)) for p in FILES}
    for mod in PARALLEL_MODULES:
        stem = mod.replace(".", "/")
        assert stem + ".py" in paths or stem + "/__init__.py" in paths, mod
    code = ("import sys\n"
            + "".join(f"sys.modules[{m!r}] = None\n" for m in FORBIDDEN)
            + "sys.path.insert(0, 'tests')\n"
            + "".join(f"import {m}\n" for m in PARALLEL_MODULES)
            + "import torch_parallel_ranks\n"
            + "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# The oracle, viz and video modules: each imports in a fresh interpreter
# in which JAX, its libraries, the JAX package, matplotlib and PIL cannot
# be imported at all (the card's machine has neither of the last two; viz
# imports them where it draws).
ORACLE_VIZ_MODULES = (
    "ekf_slam_tpu_torch.oracle", "ekf_slam_tpu_torch.oracle.oracle",
    "ekf_slam_tpu_torch.oracle.pipeline", "ekf_slam_tpu_torch.oracle.golden",
    "ekf_slam_tpu_torch.viz", "ekf_slam_tpu_torch.viz.plots",
    "ekf_slam_tpu_torch.viz.animation", "ekf_slam_tpu_torch.viz.descriptors",
    "ekf_slam_tpu_torch.io.video")


def test_oracle_viz_and_video_modules_import_without_jax():
    import subprocess
    import sys
    paths = {str(p.relative_to(ROOT)) for p in FILES}
    for mod in ORACLE_VIZ_MODULES:
        stem = mod.replace(".", "/")
        assert stem + ".py" in paths or stem + "/__init__.py" in paths, mod
    code = ("import sys\n"
            + "".join(f"sys.modules[{m!r}] = None\n"
                      for m in FORBIDDEN + ("matplotlib", "PIL"))
            + "".join(f"import {m}\n" for m in ORACLE_VIZ_MODULES)
            + "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
