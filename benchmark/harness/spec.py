"""The benchmark's parts, found by name.

``BENCHMARK.json`` at the checkout's root names the cells, metrics and
configurations; each part lives in a file of its own under the benchmark's
folder, so a later cell, configuration, driver or metric is a new file and
a new entry, never an edit:

* ``configs/<config>.json``: a deployment (``engine``: every setting of the
  program's ``EngineConfig``; ``driver``; ``source``, ``assumed``,
  ``reduced``);
* ``traffic/<traffic>.json``: a mix (``instances``, ``frames_per_call``,
  ``sequence_frames``, ``traced_calls``, ``sampled_instances``);
* ``limits/<cell>.json``: the limit of each number that decides
  ``correct`` in the cell;
* ``drivers/<driver>.py``: the timed entry (a ``Session`` class);
* ``metrics/<metric>.py``: the reader of one metric (``read(record)``);
  a metric named ``<metric>.<variant>`` (the same quantity in cells that
  report another end-to-end metric) has the reader of ``<metric>``, and
  one of a family, ``<part>_<family>`` with no file of its own, is read
  by ``metrics/<family>.py`` as ``read(record, "<part>_<family>")``: each
  ``<kernel>_roofline`` by ``metrics/roofline.py``, so that a kernel is an
  entry of ``roofline/kernel_symbols.json`` and of BENCHMARK.json alone.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: pathlib.Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def module(kind: str, name: str):
    """The module of file ``<kind>/<name>.py`` under the benchmark."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The function that reads `metric` from a run's record (see above)."""
    base = metric.split(".", 1)[0]
    if (HERE / "metrics" / f"{base}.py").exists():
        return module("metrics", base).read
    family = module("metrics", base.rsplit("_", 1)[-1])
    return lambda rec: family.read(rec, base)


def cell(bench: dict, name: str) -> dict:
    """Everything one cell runs with: its entry, configuration, traffic,
    limits, driver module and the metrics it reports, end to end
    (``end_to_end``) and per layer (``per_layer``)."""
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"unknown workload {name!r}; the benchmark has "
                         f"{', '.join(sorted(work))}")
    w = work[name]
    conf = load_json(HERE / "configs" / f"{w['config']}.json")

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return dict(workload=w, config=conf,
                traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(HERE / "limits" / f"{name}.json"),
                driver=module("drivers", conf["driver"]),
                end_to_end=mine(bench["end_to_end"]),
                per_layer=mine(bench["per_layer"]))
