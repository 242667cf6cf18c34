"""Synthetic segmentation data for CALC2 training, drawn on a
torch.Generator on its device.

Port of ``ekf_slam_tpu/data/synthetic.py``. COCO-Stuff is not bundled, so
the training scenes are random Voronoi cells, each of one of the 13 CALC
classes, coloured by a class palette plus pixel noise
(gen_tfrecords.py:41-167 makes 320x320 image / 13-class mask pairs from
COCO-Stuff). ``render_voronoi`` is one batched argmin over the seeds; its
draws (seeds, classes, palette, noise) are inputs, so a test can render
from JAX's.
"""

from __future__ import annotations

from typing import Optional

import torch

from ekf_slam_tpu_torch.models.vss import N_CLASSES


def render_voronoi(seeds: torch.Tensor, cell_cls: torch.Tensor,
                   palette: torch.Tensor, hw, noise: torch.Tensor):
    """(images (B, H, W, 3) in [0, 1], labels (B, H, W, 13) one-hot) of
    Voronoi seeds (B, N, 2) in pixels, a class per cell (B, N), a shared
    palette (13, 3) and unit pixel noise (B, H, W, 3) scaled by 0.05. A
    pixel belongs to its nearest seed, the lowest index among ties."""
    h, w = hw
    yy = torch.arange(h, dtype=seeds.dtype, device=seeds.device)
    xx = torch.arange(w, dtype=seeds.dtype, device=seeds.device)
    d2 = ((yy[None, :, None, None] - seeds[:, None, None, :, 0]) ** 2
          + (xx[None, None, :, None] - seeds[:, None, None, :, 1]) ** 2)
    cell = torch.argmin(d2, dim=-1)                          # (B, H, W)
    cls = torch.gather(cell_cls, 1, cell.reshape(cell.shape[0], -1)
                       ).reshape(cell.shape)
    img = palette[cls] + 0.05 * noise.to(palette.dtype)
    return (torch.clamp(img, 0.0, 1.0),
            torch.nn.functional.one_hot(cls, N_CLASSES).to(palette.dtype))


def _rand(shape, generator, device, dtype, lo=0.0, hi=1.0):
    return lo + (hi - lo) * torch.rand(shape, generator=generator,
                                       device=device, dtype=dtype)


def synthetic_batch(batch: int, hw=(192, 256), num_cells: int = 24,
                    generator: Optional[torch.Generator] = None,
                    device=None, dtype=torch.float32):
    """(images (B, H, W, 3) in [0, 1], labels (B, H, W, 13) one-hot) of
    `batch` independent scenes, drawn from `generator` on `device` (the
    generator's device when None)."""
    device = device or (generator.device if generator is not None
                        else "cpu")
    h, w = hw
    kw = dict(generator=generator, device=device)
    seeds = _rand((batch, num_cells, 2), dtype=dtype, **kw) * torch.tensor(
        [h, w], dtype=dtype, device=device)
    cell_cls = torch.randint(0, N_CLASSES, (batch, num_cells), **kw)
    palette = _rand((N_CLASSES, 3), dtype=dtype, lo=0.1, hi=0.9, **kw)
    noise = torch.randn((batch, h, w, 3), dtype=dtype, **kw)
    return render_voronoi(seeds, cell_cls, palette, hw, noise)


def alias_cells(base_seeds: torch.Tensor, base_cls: torch.Tensor,
                group: int, jitter: torch.Tensor, which: torch.Tensor,
                new_cls: torch.Tensor):
    """Each archetype's seeds (A, N, 2) and classes (A, N) repeated for
    its `group` places, the seeds moved by jitter (P, N, 2), and the
    cells which (P, d) of each place given the classes new_cls (P, d).
    Returns (seeds (P, N, 2), cell_cls (P, N))."""
    seeds = torch.repeat_interleave(base_seeds, group, dim=0) + jitter
    cell_cls = torch.repeat_interleave(base_cls, group, dim=0)
    cell_cls = cell_cls.scatter(1, which, new_cls)
    return seeds, cell_cls


def aliased_places(n_places: int, group: int = 4, hw=(192, 256),
                   num_cells: int = 48, jitter_px: float = 0.5,
                   distinct_cells: int = 2,
                   generator: Optional[torch.Generator] = None,
                   device=None, dtype=torch.float32):
    """A perceptually aliased place set: n_places scenes from
    n_places // group archetypes, `group` places each. The places of an
    archetype share its seed layout and classes up to a seed jitter of
    jitter_px (normal) and distinct_cells cells given new classes, a
    uniformly random subset of the cells a place (the first entries of a
    random permutation, JAX's choice without replacement).

    Returns (images (P, H, W, 3), labels one-hot, archetype id (P,) int32),
    archetype-major."""
    if n_places % group:
        raise ValueError(f"n_places {n_places} is not a multiple of group "
                         f"{group}")
    device = device or (generator.device if generator is not None
                        else "cpu")
    n_arch = n_places // group
    h, w = hw
    kw = dict(generator=generator, device=device)
    base_seeds = _rand((n_arch, num_cells, 2), dtype=dtype, **kw) \
        * torch.tensor([h, w], dtype=dtype, device=device)
    base_cls = torch.randint(0, N_CLASSES, (n_arch, num_cells), **kw)
    palette = _rand((N_CLASSES, 3), dtype=dtype, lo=0.1, hi=0.9, **kw)
    jitter = jitter_px * torch.randn((n_places, num_cells, 2), dtype=dtype,
                                     **kw)
    which = torch.argsort(_rand((n_places, num_cells), dtype=dtype, **kw),
                          dim=1)[:, :distinct_cells]
    new_cls = torch.randint(0, N_CLASSES, (n_places, distinct_cells), **kw)
    seeds, cell_cls = alias_cells(base_seeds, base_cls, group, jitter, which,
                                  new_cls)
    noise = torch.randn((n_places, h, w, 3), dtype=dtype, **kw)
    imgs, labels = render_voronoi(seeds, cell_cls, palette, hw, noise)
    arch_id = torch.repeat_interleave(
        torch.arange(n_arch, dtype=torch.int32, device=device), group)
    return imgs, labels, arch_id


def class_weights(labels_onehot: torch.Tensor) -> torch.Tensor:
    """Inverse-frequency class weights of one batch (the running-mean
    scheme of gen_tfrecords.py:104-105,162-167 collapsed to one batch)."""
    freq = torch.mean(labels_onehot, dim=(0, 1, 2))
    return 1.0 / torch.clamp(freq, min=1e-3)


def aliased_batches(batch: int, group: int = 4, hw=(192, 256),
                    generator: Optional[torch.Generator] = None,
                    device=None, **alias_kwargs):
    """Endless archetype-grouped training batches (images, labels): each
    is batch // group fresh archetypes x `group` places (aliased_places),
    so that in-batch hard-negative mining sees near-duplicate impostors."""
    if batch % group:
        raise ValueError(f"batch {batch} is not a multiple of group {group}")
    while True:
        imgs, labels, _ = aliased_places(batch, group, hw,
                                         generator=generator, device=device,
                                         **alias_kwargs)
        yield imgs, labels
