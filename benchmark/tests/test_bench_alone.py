"""In a directory that holds only BENCHMARK.json and the benchmark's own
files, a run exits with another code than 0 and prints no result; so it
does here, where torch sees no card."""

import shutil
import subprocess
import sys

import pytest

from benchmark.harness import spec

ARGS = ["--workload", "sim_f32.offline_b1024", "--seed", "4294967311",
        "--seconds", "1", "--trace", "0"]


def _run(cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_without_the_program(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert "ModuleNotFoundError" in out.stderr
    assert not out.stdout.strip()


def test_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run(spec.ROOT)
    assert out.returncode != 0
    assert not out.stdout.strip()
