"""CALC2 training: the VSS, Adam with a global-norm clip, checkpoints.

Port of ``ekf_slam_tpu/models/train.py`` (the reference trains with
tf.estimator: Adam(1e-3), global-norm gradient clip 5, a checkpoint every
1024 steps, utils.py:526-588):

* ``TrainConfig`` — the JAX dataclass, field for field, same defaults.
* ``TrainState`` — the ``VSS`` module (weights and BatchNorm statistics),
  its ``torch.optim.Adam`` and the step count.
* ``train_step`` — in JAX's order: crop a batch larger than image_hw,
  build the positive view, add the seasonal change at aug_severity > 0,
  apply the model in train mode to the images and then, with
  descriptor_only, to the positive view (both normalize by their batch
  statistics; the running statistics keep the first apply's update only,
  as JAX's step returns the first apply's ``batch_stats``,
  train.py:111-124), ``losses.total_loss``, then optax's
  ``chain(clip_by_global_norm(grad_clip), adam(learning_rate))``: the
  gradients scaled by grad_clip / ‖g‖ only where ‖g‖ ≥ grad_clip (not
  ``clip_grad_norm_``, which divides by ‖g‖ + 1e-6), one
  ``torch._foreach_norm`` and no host sync; then Adam, which is optax's
  adam with eps_root = 0.
* Its randomness is a ``TrainDraws``: the crop offsets, the positive
  view's draws, the seasonal change's draws (only at aug_severity > 0,
  JAX's five-key layout; four keys at 0) and the reparameterization
  noise; ``train_draws`` draws them from a torch.Generator.
* ``fit``, ``find_best_checkpoint``, ``save_checkpoint`` /
  ``restore_checkpoint`` (``utils/checkpoint.save_pytree``: torch.save of
  the model's and the optimizer's state dicts and the step; orbax
  checkpoints of the JAX trainer cannot be read).
* ``from_flax_state`` — a JAX TrainState (params, batch_stats, optax's
  Adam state, step) as numpy arrays, carried across.
* ``make_sharded_train_step`` and ``fit(mesh=)`` — the data-parallel
  step over the "data" ranks of a mesh (parallel/mesh.py), equal to the
  step on the global batch as JAX's jit over a sharded batch is: every
  rank takes the global batch and its draws and keeps its block of them;
  BatchNorm normalizes by the global batch's moments
  (vss.synced_statistics) and the losses see its descriptors (the
  differentiable collectives of torch.distributed.nn); the gradients are
  averaged over the ranks before the clip, so Adam's state stays
  replicated.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import glob
import itertools
import os
import time
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ekf_slam_tpu_torch.models import augment, losses
from ekf_slam_tpu_torch.models.vss import (VSS, VSSConfig, from_flax,
                                          frozen_statistics, pooled,
                                          synced_statistics)
from ekf_slam_tpu_torch.utils.checkpoint import restore_pytree, save_pytree
from ekf_slam_tpu_torch.utils.metrics import trace_annotation


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-3     # utils.py:502 Adam
    grad_clip: float = 5.0          # utils.py:505 clip_gradients
    batch_size: int = 12            # calc2.py:43
    image_hw: tuple = (192, 256)    # calc2.py:19-20 (vh, vw)
    margin: float = 0.5             # calc2.py:278
    # "triplet" = the reference's; "infonce" = the temperature-scaled
    # contrastive objective for aliased places (losses.infonce_loss)
    sim_objective: str = "triplet"
    sim_tau: float = 0.01
    # augment.seasonal_change at this severity on the positive view
    # (0 = off)
    aug_severity: float = 0.0
    ckpt_every: int = 1024          # utils.py:563
    seed: int = 0


@dataclasses.dataclass
class TrainState:
    model: VSS
    optimizer: torch.optim.Adam
    step: int = 0


class TrainDraws(NamedTuple):
    crop: Optional[tuple]                        # (oy, ox) each (B,)
    positive: augment.PositiveDraws
    seasonal: Optional[augment.SeasonalDraws]    # at aug_severity > 0
    eps: torch.Tensor                            # (B, H/16, W/16, latent)

    def to(self, device) -> "TrainDraws":
        """The same draws on `device`."""
        def move(t):
            if t is None:
                return None
            items = [x.to(device) for x in t]
            return type(t)(*items) if hasattr(t, "_fields") else tuple(items)
        return TrainDraws(move(self.crop), move(self.positive),
                          move(self.seasonal), self.eps.to(device))


def create_model(cfg: Optional[VSSConfig] = None, image_hw=(192, 256),
                 generator: Optional[torch.Generator] = None) -> VSS:
    return VSS(cfg or VSSConfig(), image_hw, generator)


def make_optimizer(model: VSS, tcfg: TrainConfig) -> torch.optim.Adam:
    """optax.adam(learning_rate): β 0.9 / 0.999, eps 1e-8 outside the
    root. The global-norm clip is applied in train_step."""
    return torch.optim.Adam(model.parameters(), lr=tcfg.learning_rate,
                            betas=(0.9, 0.999), eps=1e-8)


def init_state(model: VSS, tcfg: TrainConfig) -> TrainState:
    """The model in train mode, a fresh optimizer, step 0."""
    return TrainState(model.train(), make_optimizer(model, tcfg), 0)


def train_draws(tcfg: TrainConfig, model: VSS, shape,
                generator: Optional[torch.Generator], device,
                dtype=torch.float32) -> TrainDraws:
    """One step's draws for images of `shape` (B, H, W, 3), from
    `generator` on `device`."""
    B = shape[0]
    vh, vw = tcfg.image_hw
    like = torch.empty((B, vh, vw, 3), dtype=dtype, device=device)
    crop = (augment.crop_offsets(torch.empty(shape, device=device),
                                 tcfg.image_hw, generator=generator)
            if tuple(shape[1:3]) != tuple(tcfg.image_hw) else None)
    positive = augment.positive_draws(like, generator=generator)
    seasonal = (augment.seasonal_draws(like, tcfg.aug_severity,
                                       generator=generator)
                if tcfg.aug_severity > 0.0 else None)
    eps = torch.randn((B, pooled(vh, 4), pooled(vw, 4), model.cfg.latent_ch),
                      generator=generator, dtype=dtype, device=device)
    return TrainDraws(crop, positive, seasonal, eps)


def global_norm(tensors) -> torch.Tensor:
    """optax.global_norm: the 2-norm of all entries, as a tensor."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: g / ‖g‖ · max_norm where
    ‖g‖ ≥ max_norm, else g unchanged; returns ‖g‖ before the clip. No
    host sync."""
    g_norm = global_norm(grads)
    keep = g_norm < max_norm
    one = torch.ones_like(g_norm)
    torch._foreach_div_(grads, torch.where(keep, one, g_norm))
    torch._foreach_mul_(grads, torch.where(keep, one, one * max_norm))
    return g_norm


def train_step(tcfg: TrainConfig, state: TrainState, images: torch.Tensor,
               labels_onehot: torch.Tensor, class_weights: torch.Tensor,
               draws: Optional[TrainDraws] = None,
               generator: Optional[torch.Generator] = None, group=None):
    """One optimization step on images (B, H, W, 3) in [0, 1],
    labels_onehot (B, H, W, 13), class_weights (13,); draws from
    `generator` when not given. A batch larger than image_hw is randomly
    cropped to it (calc2.py:254-258). Updates state in place and returns
    (state, metrics): 0-dim tensors on the model's device, grad_norm the
    norm before the clip. Its phases are profiler ranges train.augment,
    train.forward, train.backward (the autograd engine launches the
    backward's kernels from its own thread, outside the range) and
    train.optimizer. With a process `group` (make_sharded_train_step) the
    batch is this rank's block of the global one: the statistics and the
    losses are the global batch's, the gradients are averaged over the
    group before the clip, and the metrics are the global batch's."""
    model, opt = state.model, state.optimizer
    p0 = next(model.parameters())
    images = images.to(device=p0.device, dtype=p0.dtype)
    labels_onehot = labels_onehot.to(device=p0.device, dtype=p0.dtype)
    class_weights = class_weights.to(device=p0.device, dtype=p0.dtype)
    with trace_annotation("train.augment"):
        if draws is None:
            draws = train_draws(tcfg, model, images.shape, generator,
                                p0.device, p0.dtype)
        if tuple(images.shape[1:3]) != tuple(tcfg.image_hw):
            images, labels_onehot = augment.random_crop(
                images, labels_onehot, tcfg.image_hw, offsets=draws.crop)
        im_warp = augment.positive_view(images, draws=draws.positive)
        if tcfg.aug_severity > 0.0:
            im_warp = augment.seasonal_change(im_warp, tcfg.aug_severity,
                                              draws=draws.seasonal)
    model.train()
    opt.zero_grad(set_to_none=True)
    with trace_annotation("train.forward"), (
            synced_statistics(model, group) if group is not None
            else contextlib.nullcontext()):
        outs = model(images, eps=draws.eps)
        with frozen_statistics(model):
            outs_p = model(im_warp, descriptor_only=True)
        loss, metrics = losses.total_loss(
            outs, outs_p["descriptor"], images, labels_onehot,
            class_weights, tcfg.margin, sim_objective=tcfg.sim_objective,
            sim_tau=tcfg.sim_tau, group=group)
    with trace_annotation("train.backward"):
        loss.backward()
    with trace_annotation("train.optimizer"):
        params = [p for g in opt.param_groups for p in g["params"]]
        for p in params:         # optax updates every leaf, zeros included
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if group is not None:
            metrics = _group_mean(metrics, group)
            _group_mean_([p.grad for p in params], group)
        metrics["grad_norm"] = clip_by_global_norm_(
            [p.grad for p in params], tcfg.grad_clip)
        opt.step()
    state.step += 1
    return state, {k: v.detach() for k, v in metrics.items()}


def _group_mean_(tensors, group) -> None:
    """Each tensor replaced by its mean over the group's ranks (one
    all_reduce of them flattened)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    torch._foreach_copy_(tensors, [
        f.view_as(t) for f, t in zip(flat.split([t.numel() for t in tensors]),
                                     tensors)])


def _group_mean(metrics: dict, group) -> dict:
    """The 0-dim metrics detached and averaged over the group's ranks."""
    keys = sorted(metrics)
    vals = [metrics[k].detach().clone() for k in keys]
    _group_mean_(vals, group)
    return dict(zip(keys, vals))


def make_sharded_train_step(model: VSS, tcfg: TrainConfig, mesh,
                            axis: str = "data"):
    """The data-parallel train step over `axis` of `mesh`:
    ``step(state, images, labels_onehot, class_weights, draws=None,
    generator=None) -> (state, metrics)`` takes the GLOBAL batch (B, ...)
    and the global batch's draws (or a generator in the same state on
    every rank), keeps this rank's block of B/k, and returns what
    train_step on the global batch returns: the same update of the
    replicated weights, statistics and Adam state, the global metrics.
    B must divide by the axis size."""
    from ekf_slam_tpu_torch.parallel import mesh as pmesh

    k = mesh.size(axis)
    if tcfg.batch_size % k:
        raise ValueError(f"batch_size {tcfg.batch_size} does not split over "
                         f"{k} ranks of {axis!r}")
    group = mesh.group(axis)

    def step(state: TrainState, images, labels_onehot, class_weights,
             draws: Optional[TrainDraws] = None,
             generator: Optional[torch.Generator] = None):
        p0 = next(state.model.parameters())
        if draws is None:
            draws = train_draws(tcfg, model, images.shape, generator,
                                p0.device, p0.dtype)
        mine = pmesh.block(images.shape[0], mesh, axis)
        draws = pmesh.tree_map(lambda t: t[mine].to(p0.device), draws)
        return train_step(tcfg, state, images[mine], labels_onehot[mine],
                          class_weights, draws, group=group)

    return step


def fit(model: VSS, tcfg: TrainConfig, batches, num_steps: int,
        eval_fn=None, ckpt_dir: Optional[str] = None, logger=None,
        generator: Optional[torch.Generator] = None, class_weights=None,
        data_dir: Optional[str] = None, mesh=None):
    """The training loop (utils.train_and_eval, utils.py:526-588): trains
    `model` as it is for num_steps steps, a checkpoint ckpt_{step:07d}
    every ckpt_every steps (all kept) and eval_fn(state, step_i) at the
    same steps, each step's metrics to `logger` (utils/metrics
    .MetricsLogger). With a `mesh` the steps are data-parallel over its
    "data" ranks (make_sharded_train_step): every rank passes the same
    global batches, rank 0's weights are broadcast first, and rank 0
    alone writes the checkpoints.

    batches: an iterator of (images, labels_onehot), or a re-iterable
    (a list, a records.ShardReader) cycled epoch by epoch. class_weights
    (13,): records.load_weights(data_dir) when data_dir is given, else
    estimated per batch. The draws come from `generator` (default: one on
    the model's device seeded tcfg.seed)."""
    from ekf_slam_tpu_torch.data import records

    state = init_state(model, tcfg)
    p0 = next(model.parameters())
    step_fn = functools.partial(train_step, tcfg)
    main = True
    if mesh is not None:
        with torch.no_grad():
            for t in model.state_dict().values():
                dist.broadcast(t, src=0)
        step_fn = make_sharded_train_step(model, tcfg, mesh)
        main = dist.get_rank() == 0
    if generator is None:
        generator = torch.Generator(device=p0.device).manual_seed(tcfg.seed)
    if class_weights is None and data_dir is not None:
        class_weights = records.load_weights(data_dir)
    if class_weights is not None:
        class_weights = torch.as_tensor(np.asarray(class_weights),
                                        dtype=p0.dtype, device=p0.device)
    it = batches if hasattr(batches, "__next__") else \
        itertools.chain.from_iterable(itertools.repeat(batches))
    metrics = {}
    t_fit = time.time()
    for step_i in range(num_steps):
        images, labels = next(it)
        images = torch.as_tensor(images).to(p0.device, p0.dtype)
        labels = torch.as_tensor(labels).to(p0.device, p0.dtype)
        w = class_weights if class_weights is not None else \
            1.0 / torch.clamp(torch.mean(labels, dim=(0, 1, 2)), min=1e-3)
        state, metrics = step_fn(state, images, labels, w,
                                 generator=generator)
        if logger is not None:
            logger.log(step_i, **{k: float(v) for k, v in metrics.items()})
            if step_i == 0 or (step_i + 1) % 50 == 0 \
                    or step_i + 1 == num_steps:
                print(f"[fit] step {step_i + 1}/{num_steps} "
                      f"loss={float(metrics['loss']):.4f} "
                      f"{time.time() - t_fit:.0f}s elapsed", flush=True)
        if main and ckpt_dir and (step_i + 1) % tcfg.ckpt_every == 0:
            save_checkpoint(os.path.join(ckpt_dir,
                                         f"ckpt_{step_i + 1:07d}"), state)
        if eval_fn is not None and (step_i + 1) % tcfg.ckpt_every == 0:
            eval_fn(state, step_i)
    return state, metrics


def find_best_checkpoint(ckpt_dir: str, template: TrainState, eval_fn):
    """Sweep the checkpoints ckpt_* of ckpt_dir by eval_fn(state) -> score
    (higher is better; test_net.py:357-381), each restored into
    `template`. Returns (path, score)."""
    best = (None, -float("inf"))
    for path in sorted(glob.glob(os.path.join(ckpt_dir, "ckpt_*"))):
        score = float(eval_fn(restore_checkpoint(path, template)))
        if score > best[1]:
            best = (path, score)
    return best


def save_checkpoint(path: str, state: TrainState) -> None:
    """torch.save of the model's and the optimizer's state dicts and the
    step (utils/checkpoint.save_pytree)."""
    save_pytree(path, {"model": state.model.state_dict(),
                       "optimizer": state.optimizer.state_dict(),
                       "step": state.step})


def restore_checkpoint(path: str, template: TrainState) -> TrainState:
    """What save_checkpoint wrote, loaded into template's model and
    optimizer (on their device); raises if the shapes differ."""
    dev = next(template.model.parameters()).device
    tree = restore_pytree(path, map_location=dev)
    template.model.load_state_dict(tree["model"])
    template.optimizer.load_state_dict(tree["optimizer"])
    template.step = int(tree["step"])
    return template


def _adam_state(opt_state) -> Any:
    """The element of an optax state tree with mu, nu and count (optax's
    ScaleByAdamState)."""
    if all(hasattr(opt_state, k) for k in ("mu", "nu", "count")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            found = _adam_state(s)
            if found is not None:
                return found
    return None


def from_flax_state(params, batch_stats, opt_state, step, image_hw,
                    tcfg: TrainConfig = TrainConfig(),
                    vss_cfg: Optional[VSSConfig] = None,
                    compute_dtype: str = "float32") -> TrainState:
    """The port's TrainState from a JAX TrainState's parts as numpy trees:
    the weights and statistics through vss.from_flax, optax's Adam mu / nu
    / count into torch's exp_avg / exp_avg_sq / step, each moment in its
    parameter's layout (HWIO kernels to OIHW). vss_cfg defaults to the
    width, classes and descriptor source the params imply and
    `compute_dtype` (the JAX model's: its variables do not say it)."""
    sd = from_flax({"params": params, "batch_stats": batch_stats})
    if vss_cfg is None:
        source = {(True, False): "d5", (False, True): "d4",
                  (True, True): "multi"}[("offset" in params,
                                          "offset_d4" in params)]
        heads = sd["decoder.head.bias"].shape[0] // 4
        vss_cfg = VSSConfig(width=sd["encoder.blocks.0.conv.weight"]
                            .shape[0], num_classes=heads - 1,
                            descr_source=source, compute_dtype=compute_dtype)
    model = VSS(vss_cfg, image_hw)
    model.load_state_dict(sd)
    state = init_state(model, tcfg)
    adam = _adam_state(opt_state)
    mu = from_flax({"params": adam.mu, "batch_stats": batch_stats})
    nu = from_flax({"params": adam.nu, "batch_stats": batch_stats})
    count = float(np.asarray(adam.count))
    for name, p in model.named_parameters():
        state.optimizer.state[p] = {
            "step": torch.tensor(count),
            "exp_avg": mu[name].to(p.dtype).clone(),
            "exp_avg_sq": nu[name].to(p.dtype).clone()}
    state.step = int(np.asarray(step))
    return state
