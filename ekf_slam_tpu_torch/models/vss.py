"""VSS — the Variational Semantic Segmentator (the CALC2 network).

Port of ``ekf_slam_tpu/models/vss.py`` (calc2.py:125-243):

* ``Encoder`` — a 3x3 conv, two bottleneck residual pairs (1x1 to w/2,
  3x3 back to w), then conv pairs at 2w / 4w / 8w / 16w with a 2x2 max
  pool before each; every conv is ``ConvBNElu`` (no bias, BatchNorm,
  ELU). Returns d5 (H/16), c5 (the full-resolution residual output, the
  keypoint source) and d4 (H/8).
* Latent heads ``mu`` and ``log_sig_sq`` (3x3 convs with bias, 4·heads
  channels); z = mu + sqrt(exp(log_sig_sq))·eps.
* The NetVLAD-style descriptor: the residual of a latent grid against the
  trained centre grid ``offset`` (1, h, w, C), intra-normalized over
  channels (``descr_intra_norm``), flattened in NHWC order and
  L2-normalized; ``descr_source`` "d5" (mu), "d4" (``mu_d4`` over d4
  against ``offset_d4``) or "multi" (both, concatenated / √2).
* ``Decoder`` — the 14 per-head towers as one tower of grouped convs
  (``GroupedConvBNElu``, groups = heads) with ``grouped_depth_to_space``
  between its four stages, then a 1x1 grouped head conv with bias:
  rec = sigmoid of group 0's first three channels, seg = channel 0 of
  groups 1.. .

The modules compute in NCHW; ``VSS`` takes images (B, H, W, 3) and
returns every output NHWC, as the JAX module does (c5 (B, H, W, width)
feeds ``keypoints.kp_descriptor``). Max pooling is 2x2 / 2 with Flax's
"SAME" padding, which is ``ceil_mode=True`` on odd sizes.

Train mode (``VSS.train()``) is Flax's: BatchNorm normalizes by the
batch's mean and biased variance, E[x²] − E[x]² clipped at 0 (Flax's
fast variance), and updates its running statistics as
running = m·running + (1 − m)·batch with Flax's momentum m
(``bn_momentum``, torch's 1 − momentum) and the biased variance.
``remat`` checkpoints each conv block (``torch.utils.checkpoint``); the
running statistics are updated outside the checkpointed function, so the
recompute in backward does not update them again. A forward with
descriptor_only runs no decoder, so it moves only the encoder's
statistics; inside ``frozen_statistics`` a forward moves none.

``compute_dtype="bfloat16"`` follows the JAX dtype policy with explicit
casts at JAX's cast points (vss.py:97-104, 156-164, 254, 272-331 of the
JAX package), not ``torch.autocast``: the parameters stay in their own
dtype (f32) and every conv block casts its input and kernel to bf16;
BatchNorm's statistics and normalization and the ELU run in the
parameters' dtype and the block's output is cast back to bf16 (so the
residual sums, pools and c5 are bf16); the heads ``mu``, ``mu_d4`` and
``log_sig_sq`` and the decoder's 1x1 head take their input in the
parameters' dtype; the decoder gets z in bf16. Gradients land on the f32
parameters through the casts.

With the data-parallel train step (``train.make_sharded_train_step``) a
block's BatchNorm normalizes by the global batch's moments: inside
``synced_statistics(model, group)`` E[x] and E[x²] are averaged over
`group` by a differentiable all-reduce, as SyncBatchNorm does, so the
backward sees it too.

Weights: ``VSS(cfg, image_hw, generator)`` draws its own from Flax's
distributions (``lecun_normal`` convs, zero biases, BatchNorm scale 1,
bias 0, mean 0, var 1, ``offset`` normal(1)) without matching Flax's
draws; ``from_flax`` carries a Flax VSS's params and batch statistics
across, so that both compute the same function (a bf16 Flax model as
well: its variables are f32 whatever its compute_dtype).

Not ported: the "convt" lowering of depth_to_space (bit-identical to the
reshape form).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from ekf_slam_tpu_torch.models.keypoints import GRID

N_CLASSES = 13                # the CALC class table size
N_HEADS = 1 + N_CLASSES       # RGB reconstruction + per-class seg
LATENT_PER_HEAD = 4           # calc2.py:176 — 4·(1 + 13) latent channels
DESCR_SOURCES = ("d5", "d4", "multi")
COMPUTE_DTYPES = ("float32", "bfloat16")
# Flax names the encoder's ConvBNElu_i in construction order: in
# conv(w)(conv(w // 2, (1, 1))(r1)) the outer 3x3 is built first. The
# torch encoder's block at position p (data-flow order) is Flax's
# ConvBNElu_{ENCODER_FLAX_INDEX[p]}.
ENCODER_FLAX_INDEX = (0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11)
# lecun_normal's truncated normal: stddev of the unit normal cut at ±2.
_TRUNC_STD = 0.87962566103423978


@dataclasses.dataclass(frozen=True)
class VSSConfig:
    num_classes: int = N_CLASSES
    width: int = 32                 # encoder base width
    compute_dtype: str = "float32"  # or "bfloat16" (activations)
    bn_momentum: float = 0.9997     # calc2.py:133 decay
    bn_epsilon: float = 1e-5
    remat: bool = False             # checkpoint each conv block
    descr_source: str = "d5"        # "d5" | "d4" | "multi"
    descr_intra_norm: bool = True

    @property
    def heads(self) -> int:
        return 1 + self.num_classes

    @property
    def latent_ch(self) -> int:
        return LATENT_PER_HEAD * self.heads


def check_config(cfg: VSSConfig) -> None:
    """Raise ValueError for the settings the port does not run."""
    if cfg.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"unknown compute_dtype {cfg.compute_dtype!r}")
    if cfg.descr_source not in DESCR_SOURCES:
        raise ValueError(f"unknown descr_source {cfg.descr_source!r}")


def pooled(n: int, times: int) -> int:
    """Size after `times` 2x2 / 2 pools with SAME padding."""
    for _ in range(times):
        n = -(-n // 2)
    return n


def compute_dtype(cfg: VSSConfig, param_dtype: torch.dtype) -> torch.dtype:
    """The activations' dtype: bf16 for compute_dtype "bfloat16", else
    the parameters' own (f32, or f64 in the parity tests)."""
    return (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
            else param_dtype)


class ConvBNElu(nn.Module):
    """Conv (no bias, SAME padding) + BatchNorm + ELU (calc2.py:139-146);
    `groups` > 1 is the decoder's grouped form. In train mode BatchNorm
    is Flax's (the module docstring). The conv runs in the compute dtype,
    BatchNorm and the ELU in the parameters' dtype, and the output is cast
    to the compute dtype."""

    def __init__(self, cin: int, cout: int, kernel: int = 3,
                 cfg: VSSConfig = VSSConfig(), groups: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, padding=kernel // 2,
                              bias=False, groups=groups)
        self.bn = nn.BatchNorm2d(cout, eps=cfg.bn_epsilon,
                                 momentum=1.0 - cfg.bn_momentum)
        self.flax_momentum = cfg.bn_momentum
        self.remat = cfg.remat
        self.vss_cfg = cfg
        self.update_running = True      # frozen_statistics turns it off
        self.group = None               # synced_statistics sets it

    @staticmethod
    def _moments(y, group):
        """(E[y], E[y²]) per channel over the batch and the pixels; over
        the global batch when a process group is given (equal shares a
        rank: the mean of the ranks' moments)."""
        m = torch.stack([torch.mean(y, dim=(0, 2, 3)),
                         torch.mean(y * y, dim=(0, 2, 3))])
        if group is not None:
            from torch.distributed.nn import functional as dist_fn
            m = dist_fn.all_reduce(m, group=group) / \
                torch.distributed.get_world_size(group)
        return m[0], m[1]

    def _block(self, x, group=None):
        """(output, batch mean, batch variance); the statistics are None
        in eval mode. The group is an argument, so that the recompute of
        a checkpointed block (remat), which runs in the backward, outside
        synced_statistics, reduces over the same group: every rank reruns
        the block's all-reduce at the same point of its backward."""
        pd = self.conv.weight.dtype
        cd = compute_dtype(self.vss_cfg, pd)
        y = self.conv._conv_forward(x.to(cd), self.conv.weight.to(cd),
                                    None).to(pd)
        if not self.training:
            return F.elu(self.bn(y)).to(cd), None, None
        mean, mean_sq = self._moments(y, group)
        var = torch.clamp(mean_sq - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.bn.eps) * self.bn.weight
        y = ((y - mean[:, None, None]) * mul[:, None, None]
             + self.bn.bias[:, None, None])
        return F.elu(y).to(cd), mean, var

    def forward(self, x):
        if self.remat and torch.is_grad_enabled():
            out, mean, var = torch.utils.checkpoint.checkpoint(
                self._block, x, self.group, use_reentrant=False)
        else:
            out, mean, var = self._block(x, self.group)
        if mean is not None and self.update_running:
            m = self.flax_momentum
            with torch.no_grad():
                self.bn.running_mean.copy_(m * self.bn.running_mean
                                           + (1 - m) * mean)
                self.bn.running_var.copy_(m * self.bn.running_var
                                          + (1 - m) * var)
        return out


@contextlib.contextmanager
def frozen_statistics(model: nn.Module):
    """Train-mode forwards of `model` inside the block normalize by their
    batch statistics but leave the running statistics as they are (the
    JAX train step keeps the statistics of its first apply only)."""
    blocks = [m for m in model.modules() if isinstance(m, ConvBNElu)]
    for b in blocks:
        b.update_running = False
    try:
        yield
    finally:
        for b in blocks:
            b.update_running = True


@contextlib.contextmanager
def synced_statistics(model: nn.Module, group):
    """Train-mode forwards of `model` inside the block normalize by the
    moments of the global batch split over the process group `group` (the
    data-parallel train step; every rank runs the same forwards)."""
    blocks = [m for m in model.modules() if isinstance(m, ConvBNElu)]
    for b in blocks:
        b.group = group
    try:
        yield
    finally:
        for b in blocks:
            b.group = None


class GroupedConvBNElu(ConvBNElu):
    """3x3 conv with `heads` contiguous channel groups + BN + ELU: the
    fused form of the reference's 14 decoder towers (calc2.py:218-236)."""

    def __init__(self, cin: int, features_per_group: int, heads: int,
                 cfg: VSSConfig):
        super().__init__(cin, features_per_group * heads, 3, cfg, heads)


def _pool(x):
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


class Encoder(nn.Module):
    def __init__(self, cfg: VSSConfig):
        super().__init__()
        w = cfg.width
        spec = [(3, w, 3), (w, w // 2, 1), (w // 2, w, 3), (w, w // 2, 1),
                (w // 2, w, 3)]
        for c in (2 * w, 4 * w, 8 * w, 16 * w):
            spec += [(c // 2, c, 3), (c, c, 3)]
        self.blocks = nn.ModuleList(ConvBNElu(i, o, k, cfg)
                                    for i, o, k in spec)

    def forward(self, x):
        b = self.blocks
        r1 = b[0](x)
        r3 = b[2](b[1](r1)) + r1
        r5 = b[4](b[3](r3)) + r3
        d2 = b[6](b[5](_pool(r5)))
        d3 = b[8](b[7](_pool(d2)))
        d4 = b[10](b[9](_pool(d3)))
        d5 = b[12](b[11](_pool(d4)))
        return d5, r5, d4


def grouped_depth_to_space(x: torch.Tensor, heads: int,
                           r: int = 2) -> torch.Tensor:
    """depth_to_space within each of `heads` channel groups, NCHW:
    x (B, heads·C, H, W), C divisible by r², -> (B, heads·C/r², rH, rW).
    Input channel head·C + i·r·c + j·c + co lands at output channel
    head·c + co, pixel (r·h + i, r·w + j), c = C/r² (the JAX reshape form,
    tf.depth_to_space inside each tower)."""
    B, HC, H, W = x.shape
    c_out = HC // heads // (r * r)
    x = x.reshape(B, heads, r, r, c_out, H, W).permute(0, 1, 4, 5, 2, 6, 3)
    return x.reshape(B, heads * c_out, H * r, W * r)


class Decoder(nn.Module):
    """The 14 towers as grouped convs; 4 stages of x2 upsampling."""

    # (input channels a group, features a group) of each GroupedConvBNElu
    SPEC = ((LATENT_PER_HEAD, 128), (32, 128), (128, 128), (32, 64),
            (64, 64), (64, 64), (16, 32), (32, 32), (32, 32), (8, 16),
            (16, 16), (16, 16))
    # the blocks after each grouped_depth_to_space
    STAGES = ((1, 3), (3, 6), (6, 9), (9, 12))

    def __init__(self, cfg: VSSConfig):
        super().__init__()
        h = cfg.heads
        self.heads = h
        self.blocks = nn.ModuleList(GroupedConvBNElu(ci * h, f, h, cfg)
                                    for ci, f in self.SPEC)
        self.head = nn.Conv2d(16 * h, LATENT_PER_HEAD * h, 1, groups=h)

    def forward(self, z):
        x = self.blocks[0](z)
        for lo, hi in self.STAGES:
            x = grouped_depth_to_space(x, self.heads)
            for blk in self.blocks[lo:hi]:
                x = blk(x)
        x = self.head(x.to(self.head.weight.dtype))
        rec = torch.sigmoid(x[:, 0:3])
        seg = x[:, LATENT_PER_HEAD::LATENT_PER_HEAD]    # (B, 13, H, W)
        return rec.permute(0, 2, 3, 1), seg.permute(0, 2, 3, 1)


class VSS(nn.Module):
    """The full VSS. forward(images (B, H, W, 3)) -> dict with
    descriptor (B, Dd), c5 (B, H, W, width) and, unless descriptor_only,
    mu, log_sig_sq, z (B, H/16, W/16, latent), rec (B, H, W, 3) and
    seg (B, H, W, num_classes)."""

    def __init__(self, cfg: VSSConfig = VSSConfig(),
                 image_hw: Tuple[int, int] = (192, 256),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_config(cfg)
        self.cfg = cfg
        self.image_hw = tuple(image_hw)
        H, W = self.image_hw
        w, lat = cfg.width, cfg.latent_ch
        self.encoder = Encoder(cfg)
        self.mu = nn.Conv2d(16 * w, lat, 3, padding=1)
        if cfg.descr_source in ("d5", "multi"):
            self.offset = nn.Parameter(
                torch.empty(1, pooled(H, 4), pooled(W, 4), lat))
        if cfg.descr_source in ("d4", "multi"):
            self.mu_d4 = nn.Conv2d(8 * w, lat, 3, padding=1)
            self.offset_d4 = nn.Parameter(
                torch.empty(1, pooled(H, 3), pooled(W, 3), lat))
        self.log_sig_sq = nn.Conv2d(16 * w, lat, 3, padding=1)
        self.decoder = Decoder(cfg)
        self.reset_parameters(generator if generator is not None
                              else torch.Generator().manual_seed(0))
        self.eval()

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """Flax's initializers, drawn from `gen` in module order."""
        for name, p in self.named_parameters():
            if name.startswith("offset"):
                nn.init.normal_(p, 0.0, 1.0, generator=gen)
            elif p.dim() == 4:          # conv kernels
                std = math.sqrt(1.0 / p[0].numel()) / _TRUNC_STD
                nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std,
                                      generator=gen)
            elif name.endswith("bn.weight"):
                p.fill_(1.0)
            else:                       # conv and BatchNorm biases
                p.zero_()
        for name, buf in self.named_buffers():
            if name.endswith("running_var"):
                buf.fill_(1.0)
            else:
                buf.zero_()

    @property
    def descr_dim(self) -> int:
        return sum(getattr(self, n).numel() for n in ("offset", "offset_d4")
                   if hasattr(self, n))

    @property
    def num_kp(self) -> int:
        return GRID * GRID * self.cfg.width

    @property
    def kp_dim(self) -> int:
        return 8 * self.cfg.width

    def _residual_descr(self, grid: torch.Tensor,
                        centers: torch.Tensor) -> torch.Tensor:
        res = grid.permute(0, 2, 3, 1) - centers
        if self.cfg.descr_intra_norm:
            res = res / (torch.linalg.vector_norm(res, dim=-1, keepdim=True)
                         + 1e-12)
        flat = res.reshape(res.shape[0], -1)
        return flat / (torch.linalg.vector_norm(flat, dim=-1, keepdim=True)
                       + 1e-12)

    def forward(self, images: torch.Tensor, descriptor_only: bool = False,
                eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> dict:
        """images (B, H, W, 3) at self.image_hw. eps (B, H/16, W/16,
        latent), the reparameterization noise, or None to draw it from
        `generator` (on its device)."""
        dt = self.mu.weight.dtype
        cd = compute_dtype(self.cfg, dt)
        d5, c5, d4 = self.encoder(images.to(cd).permute(0, 3, 1, 2))
        d5 = d5.to(dt)
        mu = self.mu(d5)
        parts = []
        if hasattr(self, "offset"):
            parts.append(self._residual_descr(mu, self.offset))
        if hasattr(self, "offset_d4"):
            parts.append(self._residual_descr(self.mu_d4(d4.to(dt)),
                                              self.offset_d4))
        descr = (parts[0] if len(parts) == 1
                 else torch.cat(parts, dim=-1) / math.sqrt(len(parts)))
        c5 = c5.permute(0, 2, 3, 1)
        if descriptor_only:
            return {"descriptor": descr, "c5": c5}
        mu = mu.permute(0, 2, 3, 1)
        log_sig_sq = self.log_sig_sq(d5).permute(0, 2, 3, 1)
        if eps is None:
            eps = torch.randn(mu.shape, generator=generator, dtype=dt,
                              device=None if generator is None
                              else generator.device).to(mu.device)
        z = mu + torch.sqrt(torch.exp(log_sig_sq)) * eps.to(dt)
        rec, seg = self.decoder(z.permute(0, 3, 1, 2).to(cd))
        return {"descriptor": descr, "mu": mu, "log_sig_sq": log_sig_sq,
                "rec": rec, "seg": seg, "z": z, "c5": c5}


# --- weights carried from a Flax VSS -----------------------------------------

def _conv_weight(kernel) -> torch.Tensor:
    """Flax HWIO (kh, kw, in/groups, out) -> torch OIHW."""
    k = np.asarray(kernel)
    if k.ndim != 4:
        raise ValueError(f"a conv kernel of rank {k.ndim}")
    return torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _block(sd: dict, prefix: str, p, s) -> None:
    sd[f"{prefix}.conv.weight"] = _conv_weight(p["Conv_0"]["kernel"])
    sd[f"{prefix}.bn.weight"] = _tensor(p["BatchNorm_0"]["scale"])
    sd[f"{prefix}.bn.bias"] = _tensor(p["BatchNorm_0"]["bias"])
    sd[f"{prefix}.bn.running_mean"] = _tensor(s["BatchNorm_0"]["mean"])
    sd[f"{prefix}.bn.running_var"] = _tensor(s["BatchNorm_0"]["var"])
    sd[f"{prefix}.bn.num_batches_tracked"] = torch.zeros((), dtype=torch.long)


def _indexed(tree, stem: str, n: int) -> list:
    """tree's stem_0 .. stem_{n-1}, by integer index (a string sort puts
    stem_10 before stem_2); raises unless those are exactly its keys."""
    want = {f"{stem}_{i}" for i in range(n)}
    got = {k for k in tree.keys() if k.startswith(stem + "_")}
    if got != want:
        raise ValueError(f"{stem}: expected {sorted(want)}, got "
                         f"{sorted(got)}")
    return [tree[f"{stem}_{i}"] for i in range(n)]


def from_flax(variables) -> dict:
    """State dict of the torch ``VSS`` from a Flax VSS's variables,
    {"params", "batch_stats"} as nested mappings of arrays. Kernels go
    from HWIO to OIHW (grouped convs have contiguous groups in both),
    BatchNorm's scale / bias come from params and mean / var from
    batch_stats; mu, log_sig_sq, mu_d4 and the decoder's head carry
    biases. Every tensor's shape is checked against the torch modules of
    the width and class count the variables imply."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: dict = {}
    enc_p = _indexed(params["Encoder_0"], "ConvBNElu", 13)
    enc_s = _indexed(stats["Encoder_0"], "ConvBNElu", 13)
    for pos, idx in enumerate(ENCODER_FLAX_INDEX):
        _block(sd, f"encoder.blocks.{pos}", enc_p[idx], enc_s[idx])
    n_dec = len(Decoder.SPEC)
    dec_p = _indexed(params["Decoder_0"], "GroupedConvBNElu", n_dec)
    dec_s = _indexed(stats["Decoder_0"], "GroupedConvBNElu", n_dec)
    for i in range(n_dec):
        _block(sd, f"decoder.blocks.{i}", dec_p[i], dec_s[i])
    head = params["Decoder_0"]["Conv_0"]
    sd["decoder.head.weight"] = _conv_weight(head["kernel"])
    sd["decoder.head.bias"] = _tensor(head["bias"])
    for name in ("mu", "log_sig_sq", "mu_d4"):
        if name in params:
            sd[f"{name}.weight"] = _conv_weight(params[name]["kernel"])
            sd[f"{name}.bias"] = _tensor(params[name]["bias"])
    for name in ("offset", "offset_d4"):
        if name in params:
            sd[name] = _tensor(params[name])

    width = sd["encoder.blocks.0.conv.weight"].shape[0]
    heads = sd["decoder.head.bias"].shape[0] // LATENT_PER_HEAD
    cfg = VSSConfig(width=width, num_classes=heads - 1)
    with torch.device("meta"):
        want = {**{f"encoder.{k}": v.shape
                   for k, v in Encoder(cfg).state_dict().items()},
                **{f"decoder.{k}": v.shape
                   for k, v in Decoder(cfg).state_dict().items()}}
    lat, w = cfg.latent_ch, width
    for name, cin in (("mu", 16 * w), ("log_sig_sq", 16 * w),
                      ("mu_d4", 8 * w)):
        want[f"{name}.weight"] = (lat, cin, 3, 3)
        want[f"{name}.bias"] = (lat,)
    for k, v in sd.items():
        if k.startswith("offset"):
            ok = v.dim() == 4 and v.shape[0] == 1 and v.shape[-1] == lat
        else:
            ok = tuple(v.shape) == tuple(want[k])
        if not ok:
            raise ValueError(f"from_flax: {k} has shape {tuple(v.shape)}, "
                             f"expected {tuple(want.get(k, ()))}")
    return sd
