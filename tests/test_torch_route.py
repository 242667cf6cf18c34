"""The frame's route (filter/engine.py route) and the keys of the frames
that graph.py captures, on the CPU.

(a) engine.route over config x device x update layout (engine.UPDATE):
    the fused step where fused_step and the device take it, else the
    unfused step's column or row form, the IEKF and the K5 tail; and its
    three raises: fused_step="on" for a config the fused step cannot run,
    share_pht on the unfused step, and the row-sharded step on the row
    form;
(b) filter/graph.py imports no filter module, and a change of layout
    changes the key under which the sim and the image frame drivers keep
    their captured frame (run_slam's image driver shares frontend's key).
"""

import ast
import pathlib

import pytest
import torch

from ekf_slam_tpu_torch import run_slam
from ekf_slam_tpu_torch.config import EngineConfig
from ekf_slam_tpu_torch.filter import engine, graph
from ekf_slam_tpu_torch.filter.state import init_state
from ekf_slam_tpu_torch.parallel import mesh as pmesh
from ekf_slam_tpu_torch.parallel import sharded_filter as sf
from ekf_slam_tpu_torch.sim import simulate
from ekf_slam_tpu_torch.vision import frontend

CPU, CUDA = torch.device("cpu"), torch.device("cuda")
# A map the fused step fits (6·max_new_per_step <= 128, 0 < M < CAP).
FITS = {"map": {"capacity": 24, "min_features_in_image": 12,
                "max_new_per_step": 8, "max_update_obs": 16},
        "sim": {"num_landmarks": 40}}
# One the fused step does not (its add's rank 6·25 > 128).
WIDE = {"map": {"capacity": 40, "min_features_in_image": 25,
                "max_new_per_step": 25, "max_update_obs": 16},
        "sim": {"num_landmarks": 60}}


def _cfg(filt, dtype="float32", base=FITS):
    return EngineConfig.from_dict({**base, "filter": filt, "dtype": dtype})


FUSED = engine.Route(fused=True, rows=False, iterated=False,
                     use_pallas=False)


def _unfused(rows=False, iterated=False, use_pallas=False):
    return engine.Route(fused=False, rows=rows, iterated=iterated,
                        use_pallas=use_pallas)


# (filter settings, dtype, base, device, layout, fused, expected route)
ROUTES = {
    "auto_cuda_f32": ({}, "float32", FITS, CUDA, "cols", True, FUSED),
    "auto_cuda_f32_rows": ({}, "float32", FITS, CUDA, "rows", True, FUSED),
    "auto_cpu": ({}, "float32", FITS, CPU, "cols", True, _unfused()),
    "auto_cpu_rows": ({}, "float32", FITS, CPU, "rows", True,
                      _unfused(rows=True)),
    "auto_cuda_f64": ({}, "float64", FITS, CUDA, "cols", True, _unfused()),
    "k5_auto_cuda_f64_rows": ({"pallas_update": "auto"}, "float64", FITS,
                              CUDA, "rows", True, _unfused(use_pallas=True)),
    "k5_auto_cpu_rows": ({"pallas_update": "auto"}, "float64", FITS, CPU,
                         "rows", True, _unfused(rows=True)),
    "auto_cuda_wide": ({}, "float32", WIDE, CUDA, "cols", True, _unfused()),
    "auto_cuda_bf16_rows": ({"p_storage": "bf16"}, "float32", FITS, CUDA,
                            "rows", True, _unfused(rows=True)),
    "on_cpu": ({"fused_step": "on"}, "float64", FITS, CPU, "cols", True,
               FUSED),
    "off_cuda": ({"fused_step": "off", "pallas_update": "off"}, "float32",
                 FITS, CUDA, "rows", True, _unfused(rows=True)),
    "off_pallas_on": ({"fused_step": "off", "pallas_update": "on"},
                      "float64", FITS, CPU, "rows", True,
                      _unfused(use_pallas=True)),
    "iekf_rows": ({"fused_step": "off", "use_iterated_update": True},
                  "float64", FITS, CPU, "rows", True,
                  _unfused(iterated=True)),
    "image_step": ({"fused_step": "on", "pallas_update": "auto"},
                   "float32", FITS, CUDA, "cols", False,
                   _unfused(use_pallas=True)),
    "image_step_wide_on": ({"fused_step": "on"}, "float32", WIDE, CPU,
                           "rows", False, _unfused(rows=True)),
    "on_wide": ({"fused_step": "on"}, "float32", WIDE, CUDA, "cols", True,
                "fused_step=on requires"),
    "on_iekf": ({"fused_step": "on", "use_iterated_update": True},
                "float64", FITS, CPU, "cols", True, "fused_step=on requires"),
    "share_pht": ({"fused_step": "off", "share_pht": True}, "float64", FITS,
                  CPU, "cols", True, "share_pht is not ported"),
    "share_pht_image": ({"share_pht": True}, "float32", FITS, CUDA, "cols",
                        False, "share_pht is not ported"),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_route(case, monkeypatch):
    filt, dtype, base, dev, layout, fused, want = ROUTES[case]
    monkeypatch.setattr(engine, "UPDATE", layout)
    cfg = _cfg(filt, dtype, base)
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want):
            engine.route(cfg, dev, fused)
        return
    assert engine.route(cfg, dev, fused) == want


@pytest.mark.parametrize("layout,raises", [("cols", False), ("rows", True)])
def test_sharded_step_takes_the_column_route(layout, raises, monkeypatch):
    """make_sharded_step builds on the column form and raises on the row
    form (the unfused step's route on the mesh's device)."""
    monkeypatch.setattr(engine, "UPDATE", layout)
    cfg = _cfg({"fused_step": "off"}, "float64")
    mesh = pmesh.Mesh(None, ("data", "model"), {"data": 1, "model": 2},
                      CPU, "gloo")
    if raises:
        with pytest.raises(ValueError, match="column-form"):
            sf.make_sharded_step(cfg, mesh)
    else:
        assert callable(sf.make_sharded_step(cfg, mesh))


def test_graph_imports_no_filter_module():
    tree = ast.parse(pathlib.Path(graph.__file__).read_text())
    names = [n.module for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom)]
    names += [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
              for a in n.names]
    assert not [m for m in names if m.startswith("ekf_slam_tpu_torch.filter")]


class _Keyed(Exception):
    pass


def _keys(monkeypatch, drive):
    """The key each frame driver in `drive` hands graph.run, under each
    layout (the frames themselves are not run)."""
    def run(fn, carry, inputs_at, frames, key, capture=True, in_place=()):
        raise _Keyed(key)

    monkeypatch.setattr(graph, "run", run)
    out = {}
    for layout in ("cols", "rows"):
        monkeypatch.setattr(engine, "UPDATE", layout)
        out[layout] = []
        for d in drive:
            with pytest.raises(_Keyed) as got:
                d()
            out[layout].append(got.value.args[0])
    return out


def test_a_change_of_layout_changes_the_frame_key(monkeypatch):
    cfg = _cfg({"fused_step": "off", "pallas_update": "off"}, "float64")
    _, _, obs = simulate(torch.Generator().manual_seed(0), cfg, 2, "cpu")
    st = init_state(cfg, 1, "cpu")
    u = torch.zeros(2, 1, cfg.ransac.num_hypotheses, dtype=torch.float64)
    imgs = torch.zeros(2, cfg.camera.n_rows, cfg.camera.n_cols,
                       dtype=torch.float64)
    app = frontend.init_appearance(cfg, 1, "cpu")
    keys = _keys(monkeypatch, [
        lambda: engine.frame_driver(st, obs, u, cfg, capture=False),
        lambda: frontend.frame_driver(st, app, imgs, u, cfg, capture=False),
        lambda: run_slam.run_frames(lambda t: imgs[t], 2, cfg, 1, "cpu",
                                    capture=False)])
    for layout, (sim, image, slam_image) in keys.items():
        assert sim[:2] == ("sim", cfg) and image[:2] == ("image", cfg)
        assert slam_image == image
        assert sim[2].rows == image[2].rows == (layout == "rows")
    assert keys["cols"][0] != keys["rows"][0]
    assert keys["cols"][1] != keys["rows"][1]
