"""Every part BENCHMARK.json names loads by name, and the file keeps to
its format: its keys, names, units, bounds and sizes."""

import json
import math
import re

import pytest

from benchmark.harness import spec
from ekf_slam_tpu_torch.config import EngineConfig

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    c = spec.cell(BENCH, cell)
    EngineConfig.from_dict(c["config"]["engine"])
    assert hasattr(c["driver"], "Session")
    for key in ("instances", "frames_per_call", "sequence_frames",
                "traced_calls", "sampled_instances"):
        assert c["traffic"][key] > 0
    t = c["traffic"]
    assert t["sequence_frames"] % t["frames_per_call"] == 0
    assert set(c["limits"]) >= {"rerun_gap", "cam_err", "state_err",
                                "cov_err", "count_parts", "nonfinite"}
    reported = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in reported and len(reported) >= 2
    assert c["per_layer"]


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_loads_by_name(metric):
    assert callable(spec.reader(metric))


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(config):
    assert config["file"].startswith("benchmark/")
    with open(spec.ROOT / config["file"]) as f:
        conf = json.load(f)
    assert conf["name"] == config["name"]
    assert conf["reduced"] == config["reduced"]
    assert config["name"] in {w["config"] for w in BENCH["workloads"]}
    assert (spec.HERE / "drivers" / f"{conf['driver']}.py").exists()


def test_benchmark_file_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for x in BENCH["configs"] + BENCH["workloads"]
             + METRICS]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
               for m in METRICS)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        layers.setdefault(m["layer"], m["layer"])
        for w in m.get("workloads", CELLS):
            assert w in CELLS
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and 0 < len(w["why"]) <= 200
    # a full check with 24 cells fits its allowance
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert math.isfinite(BENCH["run_seconds"])
