"""Local-descriptor direction visualization (test_net.py:383-478).

Port of ``ekf_slam_tpu/viz/descriptors.py``. The reference's
`show_local_descr` projects the per-class local latent descriptors of a
(database, positive, negative) image triplet onto the two principal
components of a training corpus — per semantic class and for the
appearance head — then quiver-plots the normalized directions: the
database and positive arrows should align, the negative diverge.

The latent layout comes from the port's `models.vss.VSS`, run in eval mode
(its running statistics) on the device the caller names: `mu` is
(B, H/16, W/16, 4·heads) with head 0 the appearance head and head 1+c
class c (the reference slices the same 4-channel groups from its reshaped
descriptor, test_net.py:414-425). The reference uses sklearn
`KernelPCA(2)` with its default LINEAR kernel, which is exactly centered
PCA — implemented here directly via SVD (no sklearn dependency).

Deviation (documented, as in the JAX module): the reference reshapes the
training matrix as (4·N, H·W/256·heads) — mixing channel groups across PCA
samples (test_net.py:416-418); here each training image contributes ONE
sample, the flattened (H·W/256·4) class-descriptor map, which is the
stated intent (principal directions of that class's local-descriptor
field).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ekf_slam_tpu_torch.data.classes import CALC_CLASSES
from ekf_slam_tpu_torch.ops import device as devices


class LinearPCA:
    """Centered linear PCA (== sklearn KernelPCA(kernel='linear') up to
    component sign): fit stores the mean and top-k right singular
    vectors; transform projects centered rows onto them."""

    def __init__(self, n_components: int = 2):
        self.n = n_components
        self.mean: Optional[np.ndarray] = None
        self.components: Optional[np.ndarray] = None  # (n, D)

    def fit(self, X: np.ndarray) -> "LinearPCA":
        X = np.asarray(X, np.float64)
        self.mean = X.mean(axis=0)
        _, _, Vt = np.linalg.svd(X - self.mean, full_matrices=False)
        self.components = Vt[: self.n]
        return self

    def transform(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, np.float64)
        return (X - self.mean) @ self.components.T


@torch.no_grad()
def _latent_mu(model, images: np.ndarray, device,
               batch: int = 8) -> np.ndarray:
    """The encoder's latent head of images (N, H, W, 3): (N, h, w,
    4*heads) mu maps, the VSS (moved to `device`) in eval mode. mu does
    not read the reparameterization draw, which comes from a generator
    seeded 0 (the JAX function's key(0))."""
    device = torch.device(device)
    model = model.to(device)
    was_training = model.training
    model.eval()
    try:
        gen = torch.Generator(device=device).manual_seed(0)
        outs = [model(torch.as_tensor(images[i:i + batch],
                                      dtype=torch.float32, device=device),
                      generator=gen)["mu"].float().cpu()
                for i in range(0, images.shape[0], batch)]
    finally:
        model.train(was_training)
    return torch.cat(outs).numpy()


def head_channels(mu: np.ndarray, head: int) -> np.ndarray:
    """Flatten one head's 4-channel local-descriptor field per image:
    (N, h, w, 4*heads) -> (N, h*w*4)."""
    grp = mu[..., 4 * head: 4 * head + 4]
    return grp.reshape(grp.shape[0], -1)


def local_descriptor_projections(
        model, images: np.ndarray, train_images: np.ndarray,
        class_names: Sequence[str] = ("building", "vegetation"),
        batch: int = 8, device=None):
    """PCA-project a (database, positive, negative) triplet's local
    descriptors (test_net.py:383-443).

    model: the port's VSS, with its weights; images: (3, H, W, 3)
    triplet; train_images: (N, H, W, 3) corpus the per-head PCA bases are
    fit on. The VSS runs on the card unless `device` names another.
    Returns {name: (3, 2) unit vectors} for each requested class plus
    'appearance'.
    """
    if images.shape[0] != 3:
        raise ValueError("expected a (database, positive, negative) "
                         f"triplet, got {images.shape[0]} images")
    device = devices.resolve(device)
    mu_train = _latent_mu(model, train_images, device, batch)
    mu = _latent_mu(model, images, device, batch)

    heads = {"appearance": 0}
    for name in class_names:
        heads[name] = 1 + CALC_CLASSES[name]

    out = {}
    for name, head in heads.items():
        pca = LinearPCA(2).fit(head_channels(mu_train, head))
        v = pca.transform(head_channels(mu, head))
        out[name] = v / (np.linalg.norm(v, axis=-1, keepdims=True) + 1e-12)
    return out


def plot_local_descriptors(projections: dict, path: str,
                           order: Optional[Sequence[str]] = None):
    """Three-panel quiver of the projected directions (test_net.py:448-478):
    blue=database, green=positive, red=negative, unit axes."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.patches as mpatches
    import matplotlib.pyplot as plt

    names = list(order) if order is not None else list(projections)
    fig, axes = plt.subplots(1, len(names), figsize=(8.0, 3.0))
    if len(names) == 1:
        axes = [axes]
    zeros = np.zeros(3)
    for ax, name in zip(axes, names):
        d = projections[name]
        ax.quiver(zeros, zeros, d[:, 0], d[:, 1], color=["b", "g", "r"],
                  scale=1, units="xy", width=0.02)
        ax.set_xticks([]); ax.set_yticks([])
        ax.set_xlim([-1.1, 1.1]); ax.set_ylim([-1.1, 1.1])
        ax.set_aspect("equal")
        ax.set_title(name)
    handles = [mpatches.Patch(color="b", label="database"),
               mpatches.Patch(color="g", label="positive"),
               mpatches.Patch(color="r", label="negative")]
    axes[-1].legend(handles=handles, framealpha=0.0, fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return path
