"""CALC2 training losses ("CALC 2.0"/calc2.py:271-318, utils.py:278-307).

Port of ``ekf_slam_tpu/models/losses.py``:

    total = segloss + 1e-4·kld + 1e-4·recloss + simloss  (calc2.py:315-318)

with JAX's clamps (softmax at 1e-6, the reconstruction at 1e-10), its
"−3·I" exclusion of each descriptor from its own negatives and argmax's
first index on ties.
"""

from __future__ import annotations

import torch


def hard_negative_mine(descr: torch.Tensor) -> torch.Tensor:
    """In-batch hardest negative per row (utils.py:278-307): the most
    similar OTHER descriptor, the diagonal excluded by subtracting 3 (a
    cosine never reaches −2)."""
    n = descr.shape[0]
    sim = descr @ descr.T - 3.0 * torch.eye(n, dtype=descr.dtype,
                                            device=descr.device)
    return descr[torch.argmax(sim, dim=-1)]


def triplet_loss(descr: torch.Tensor, descr_p: torch.Tensor,
                 descr_n: torch.Tensor, margin: float = 0.5) -> torch.Tensor:
    """Hinge triplet on cosine similarities (calc2.py:276-279)."""
    lp = torch.sum(descr_p * descr, dim=-1)
    ln = torch.sum(descr_n * descr, dim=-1)
    return torch.mean(torch.clamp(ln + margin - lp, min=0.0))


def infonce_loss(descr: torch.Tensor, descr_p: torch.Tensor,
                 tau: float = 0.01) -> torch.Tensor:
    """Temperature-scaled in-batch contrastive loss (the opt-in objective
    for perceptually aliased places; the triplet is the reference's):
    the positive is the row-aligned descr_p, the negatives every other
    in-batch descriptor."""
    n = descr.shape[0]
    sim_pos = torch.sum(descr * descr_p, dim=-1)
    sim_neg = descr @ descr.T - 3.0 * torch.eye(n, dtype=descr.dtype,
                                                device=descr.device)
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
               sim_objective: str = "triplet", sim_tau: float = 0.01):
    """The 4-term CALC2 objective; returns (loss, metrics). sim_objective
    "triplet" (the reference's) or "infonce". The metrics always carry
    the mean positive and hardest-negative cosines (sim_pos, sim_neg)."""
    descr = outs["descriptor"]
    descr_n = hard_negative_mine(descr)
    if sim_objective == "infonce":
        simloss = infonce_loss(descr, outs_warp_descr, sim_tau)
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
