"""CALC2 training losses ("CALC 2.0"/calc2.py:271-318, utils.py:278-307).

Port of ``ekf_slam_tpu/models/losses.py``:

    total = segloss + 1e-4·kld + 1e-4·recloss + simloss  (calc2.py:315-318)

with JAX's clamps (softmax at 1e-6, the reconstruction at 1e-10), its
"−3·I" exclusion of each descriptor from its own negatives and argmax's
first index on ties. In the data-parallel train step (a process `group`)
every rank holds a block of the global batch: the negatives are mined
from, and InfoNCE contrasts against, the global batch's descriptors,
gathered by a differentiable all_gather; each term is the mean over the
rank's rows, and the ranks' means average to the global batch's.
"""

from __future__ import annotations

import torch


def _self_mask(n: int, pool: torch.Tensor, offset: int) -> torch.Tensor:
    """(n, len(pool)): 1 where row i meets itself, pool row offset + i."""
    return torch.eye(n, pool.shape[0], dtype=pool.dtype,
                     device=pool.device).roll(offset, dims=1)


def hard_negative_mine(descr: torch.Tensor, pool=None,
                       offset: int = 0) -> torch.Tensor:
    """In-batch hardest negative per row (utils.py:278-307): the most
    similar OTHER descriptor of `pool` (default: descr itself, in which
    descr's rows start at row `offset`), the row itself excluded by
    subtracting 3 (a cosine never reaches −2)."""
    pool = descr if pool is None else pool
    sim = descr @ pool.T - 3.0 * _self_mask(descr.shape[0], pool, offset)
    return pool[torch.argmax(sim, dim=-1)]


def triplet_loss(descr: torch.Tensor, descr_p: torch.Tensor,
                 descr_n: torch.Tensor, margin: float = 0.5) -> torch.Tensor:
    """Hinge triplet on cosine similarities (calc2.py:276-279)."""
    lp = torch.sum(descr_p * descr, dim=-1)
    ln = torch.sum(descr_n * descr, dim=-1)
    return torch.mean(torch.clamp(ln + margin - lp, min=0.0))


def infonce_loss(descr: torch.Tensor, descr_p: torch.Tensor,
                 tau: float = 0.01, pool=None,
                 offset: int = 0) -> torch.Tensor:
    """Temperature-scaled in-batch contrastive loss (the opt-in objective
    for perceptually aliased places; the triplet is the reference's):
    the positive is the row-aligned descr_p, the negatives every other
    descriptor of the batch (`pool` and `offset` as hard_negative_mine
    takes them)."""
    pool = descr if pool is None else pool
    sim_pos = torch.sum(descr * descr_p, dim=-1)
    sim_neg = descr @ pool.T - 3.0 * _self_mask(descr.shape[0], pool,
                                                offset)
    logits = torch.cat([sim_pos[:, None], sim_neg], dim=1) / tau
    return torch.mean(torch.logsumexp(logits, dim=1) - logits[:, 0])


def softmax(x: torch.Tensor) -> torch.Tensor:
    """The JAX package's softmax: shift by the max, exp, normalize."""
    e = torch.exp(x - torch.amax(x, dim=-1, keepdim=True))
    return e / torch.sum(e, dim=-1, keepdim=True)


def seg_loss(seg_logits: torch.Tensor, labels_onehot: torch.Tensor,
             class_weights: torch.Tensor) -> torch.Tensor:
    """Class-weighted softmax cross-entropy (calc2.py:287-294), the weights
    normalized by their minimum (calc2.py:292)."""
    w = class_weights / torch.min(class_weights)
    p = torch.clamp(softmax(seg_logits), 1e-6, 1.0)
    return torch.mean(-torch.sum(labels_onehot * w * torch.log(p), dim=-1))


def recon_loss(rec: torch.Tensor, images: torch.Tensor) -> torch.Tensor:
    """Bernoulli reconstruction cross-entropy summed over pixels, batch
    mean (calc2.py:296-299)."""
    rec = torch.clamp(rec, 1e-10, 1.0 - 1e-10)
    ce = images * torch.log(rec) + (1.0 - images) * torch.log(1.0 - rec)
    return torch.mean(-torch.sum(ce, dim=(1, 2, 3)))


def kld_loss(mu: torch.Tensor, log_sig_sq: torch.Tensor) -> torch.Tensor:
    """KL(q(z|x) ‖ N(0, I)) (calc2.py:301-309)."""
    m = mu.reshape(mu.shape[0], -1)
    s = log_sig_sq.reshape(log_sig_sq.shape[0], -1)
    return torch.mean(-0.5 * torch.sum(1.0 + s - m * m - torch.exp(s),
                                       dim=-1))


def total_loss(outs: dict, outs_warp_descr: torch.Tensor,
               images: torch.Tensor, labels_onehot: torch.Tensor,
               class_weights: torch.Tensor, margin: float = 0.5,
               sim_objective: str = "triplet", sim_tau: float = 0.01,
               group=None):
    """The 4-term CALC2 objective; returns (loss, metrics). sim_objective
    "triplet" (the reference's) or "infonce". The metrics always carry
    the mean positive and hardest-negative cosines (sim_pos, sim_neg).
    With a process `group` the arguments are this rank's block of the
    global batch, the descriptors of every rank's block are gathered, and
    the loss and metrics are the means over this rank's rows."""
    descr = outs["descriptor"]
    pool, offset = None, 0
    if group is not None:
        from torch.distributed.nn import functional as dist_fn
        pool = torch.cat(dist_fn.all_gather(descr, group=group), dim=0)
        offset = torch.distributed.get_rank(group) * descr.shape[0]
    descr_n = hard_negative_mine(descr, pool, offset)
    if sim_objective == "infonce":
        simloss = infonce_loss(descr, outs_warp_descr, sim_tau, pool, offset)
    else:
        simloss = triplet_loss(descr, outs_warp_descr, descr_n, margin)
    segloss = seg_loss(outs["seg"], labels_onehot, class_weights)
    recloss = recon_loss(outs["rec"], images)
    kld = kld_loss(outs["mu"], outs["log_sig_sq"])
    loss = segloss + 1e-4 * kld + 1e-4 * recloss + simloss
    sim_pos = torch.mean(torch.sum(descr * outs_warp_descr, -1))
    sim_neg = torch.mean(torch.sum(descr * descr_n, -1))
    return loss, {"loss": loss, "segloss": segloss, "recloss": recloss,
                  "kld": kld, "simloss": simloss, "sim_pos": sim_pos,
                  "sim_neg": sim_neg}
