"""Padded fixed-capacity filter state, batched over filter instances.

Port of ``ekf_slam_tpu/filter/state.py``. Every field carries a leading
instance axis B:

* ``x`` (B, D), D = 13 + 6·CAP: camera block [r q v w] then CAP 6-wide
  landmark slots (inverse-depth [x y z θ φ ρ], cartesian [x y z 0 0 0]);
* ``P`` (B, D, D): joint covariance; dead slots carry zero rows/cols;
* ``active``, ``cartesian`` (B, CAP) bool; ``times_predicted``,
  ``times_measured``, ``landmark_id`` (B, CAP) int32.

P is stored in the state's dtype, or in bfloat16 when
``FilterConfig.p_storage == "bf16"`` at float32 (the fast mode; at float64
the setting is ignored, as in the JAX package). ``state_from_numpy`` /
``state_to_numpy`` carry a state across from the JAX package (as numpy
arrays) and back, a bf16 P bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ekf_slam_tpu_torch.config import EngineConfig
from ekf_slam_tpu_torch.ops import device as devices

FIELDS = ("x", "P", "active", "cartesian", "times_predicted",
          "times_measured", "landmark_id")


@dataclasses.dataclass(frozen=True)
class FilterState:
    x: torch.Tensor
    P: torch.Tensor
    active: torch.Tensor
    cartesian: torch.Tensor
    times_predicted: torch.Tensor
    times_measured: torch.Tensor
    landmark_id: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.active.shape[-1]

    @property
    def batch(self) -> int:
        return self.x.shape[0]

    def replace(self, **kw) -> "FilterState":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "FilterState":
        return FilterState(*(getattr(self, f).to(device) for f in FIELDS))


def init_state(cfg: EngineConfig, batch: int, device=None) -> FilterState:
    """Initial state (initialize_x_and_p.m:1-24) for `batch` instances:
    identity pose at the origin, v0, w0 = 1e-15, P diag = [eps(7),
    std_v², std_w²], P in bf16 when p_storage is "bf16" at float32. On the
    card unless `device` names another."""
    device = devices.resolve(device)
    f = cfg.filter
    cap = cfg.map.capacity
    d = cfg.map.state_dim
    dt = cfg.torch_dtype
    x = torch.zeros(batch, d, dtype=dt, device=device)
    x[:, 3] = 1.0
    x[:, 7:10] = f.v_0
    x[:, 10:13] = f.w_0
    diag = torch.zeros(batch, d, dtype=dt, device=device)
    diag[:, 0:7] = f.eps_pose
    diag[:, 7:10] = f.std_v_0 ** 2
    diag[:, 10:13] = f.std_w_0 ** 2
    z32 = torch.zeros(batch, cap, dtype=torch.int32, device=device)
    P = torch.diag_embed(diag)
    if f.p_storage == "bf16" and dt == torch.float32:
        P = P.to(torch.bfloat16)
    return FilterState(
        x=x, P=P,
        active=torch.zeros(batch, cap, dtype=torch.bool, device=device),
        cartesian=torch.zeros(batch, cap, dtype=torch.bool, device=device),
        times_predicted=z32, times_measured=z32.clone(),
        landmark_id=torch.full((batch, cap), -1, dtype=torch.int32,
                               device=device))


def state_from_numpy(d, device=None, dtype=torch.float64) -> FilterState:
    """FilterState from a mapping (or object with attributes) of numpy
    arrays with the JAX field names. An unbatched state (x of rank 1)
    gains a leading instance axis of 1. x and P come in `dtype`, except a
    bfloat16 P (numpy's ml_dtypes bfloat16, as a JAX bf16 array converts),
    which stays bfloat16: it passes through float32, which holds every
    bf16 value exactly. On the card unless `device` names another."""
    device = devices.resolve(device)
    get = d.__getitem__ if isinstance(d, dict) else lambda k: getattr(d, k)
    arrs = {k: np.asarray(get(k)) for k in FIELDS}
    if arrs["x"].ndim == 1:
        arrs = {k: v[None] for k, v in arrs.items()}
    out = {}
    for k, v in arrs.items():
        if k == "P" and v.dtype.name == "bfloat16":
            out[k] = torch.tensor(v.astype(np.float32),
                                  device=device).to(torch.bfloat16)
        elif k in ("x", "P"):
            out[k] = torch.tensor(v, dtype=dtype, device=device)
        elif k in ("active", "cartesian"):
            out[k] = torch.tensor(v.astype(bool), device=device)
        else:
            out[k] = torch.tensor(v.astype(np.int32), device=device)
    return FilterState(**out)


def state_to_numpy(s: FilterState) -> dict:
    """Dict of numpy arrays (batched) with the JAX field names. numpy has
    no bfloat16 of its own, so a bf16 P comes out as the float32 array of
    the same values (exact; ``jnp.asarray(P, jnp.bfloat16)`` restores it
    bit for bit)."""
    return {k: (t.float() if t.dtype == torch.bfloat16 else t)
            .detach().cpu().numpy()
            for k, t in ((k, getattr(s, k)) for k in FIELDS)}

