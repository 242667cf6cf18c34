"""Retrieval evaluation: precision-recall and AUC of live / memory pairs.

Port of ``ekf_slam_tpu/models/evaluate.py`` ("CALC 2.0"/test_net.py):
embed each live image and each memory image, query every live image
against all of memory by cosine similarity (test_net.py:169), optionally
re-rank its top-k candidates by keypoint geometry ("G-CALC2",
test_net.py:176-206), and report the precision-recall curve and its area
(test_net.py:255-268). The correct answer of live image i is memory
image i.

The curve and its area are the JAX package's NumPy functions, copied.
``geometric_rerank`` verifies all L·top_k candidates in one batched call
of the keypoint ratio test and the fundamental-matrix RANSAC, whose
uniform draws (L, top_k, NH, K) are an input or come from a generator.
On a CUDA device ``embed`` replays each batch shape's forward from a
captured CUDA graph (the JAX package jits embed).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ekf_slam_tpu_torch.filter import graph
from ekf_slam_tpu_torch.models import keypoints as kp_mod
from ekf_slam_tpu_torch.models import loopclosure as lc

# np.trapz was renamed np.trapezoid in NumPy 2.0; TRAPEZOID names the one
# this NumPy has.
TRAPEZOID = "trapezoid" if hasattr(np, "trapezoid") else "trapz"


def cosine_similarity_matrix(d_live: torch.Tensor,
                             d_mem: torch.Tensor) -> torch.Tensor:
    """(L, D) x (M, D) -> (L, M), mapped from [-1, 1] to [0, 1] as the
    reference maps it (calc2.py:330)."""
    return (1.0 + d_live @ d_mem.T) / 2.0


def nn_retrieval_scores(sim: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Nearest-neighbour retrieval where the correct answer is the diagonal
    (calc2.py:336-357): returns (labels, scores) over live images."""
    ids = np.argmax(sim, axis=1)
    scores = sim[np.arange(sim.shape[0]), ids]
    labels = (ids == np.arange(sim.shape[0])).astype(np.int32)
    return labels, scores


def precision_recall_curve(labels: np.ndarray, scores: np.ndarray):
    """Standard PR curve (descending-threshold sweep). Returns
    (precision, recall, thresholds)."""
    order = np.argsort(-scores)
    labels = np.asarray(labels)[order]
    scores = np.asarray(scores)[order]
    tp = np.cumsum(labels)
    fp = np.cumsum(1 - labels)
    total_pos = max(int(labels.sum()), 1)
    precision = tp / np.maximum(tp + fp, 1)
    recall = tp / total_pos
    return (np.concatenate([[1.0], precision]),
            np.concatenate([[0.0], recall]), scores)


def pr_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Area under the PR curve (trapezoid over recall)."""
    p, r, _ = precision_recall_curve(labels, scores)
    return float(getattr(np, TRAPEZOID)(p, r))


def _forward(carry, inputs, model, with_keypoints: bool):
    """The eval-mode forward as graph.py's frame function: no carry;
    inputs a batch of images; outputs its descriptors and, with_keypoints,
    its Keypoints' fields."""
    outs = model(inputs[0], descriptor_only=True)
    kps = kp_mod.kp_descriptor(outs["c5"]) if with_keypoints else ()
    return (), (outs["descriptor"], *kps)


def embed(model, images, batch: int = 8, with_keypoints: bool = False,
          eager: Optional[bool] = None):
    """Descriptors (N, Dd) of images (N, H, W, 3) in batches of `batch`,
    the model in eval mode (restored after), on the model's device and
    dtype; with_keypoints also returns their Keypoints (N, K, ...). On a
    CUDA device each batch shape's forward is captured as a CUDA graph
    once and replayed (embed_batches); eager=True runs it eagerly, and
    eager=False without a card raises."""
    p = next(model.parameters())
    capture = True if graph.replays(p.device, eager) else None
    return embed_batches(model, images, batch, with_keypoints, capture)


@torch.no_grad()
def embed_batches(model, images, batch: int = 8,
                  with_keypoints: bool = False, capture=True):
    """What embed returns, each batch's forward replayed from a captured
    CUDA graph (capture=True: at most two shapes, the full batch and the
    last one, each kept by the model object, the storage of every
    parameter and buffer, and the with_keypoints form, so a model whose
    weights were replaced rather than updated in place is captured
    again), run over static buffers without a graph (capture=False, how
    the CPU tests see what replay runs) or eagerly (capture=None)."""
    p = next(model.parameters())
    if not isinstance(images, torch.Tensor):
        images = torch.from_numpy(np.array(images))
    images = images.to(device=p.device, dtype=p.dtype)
    fn = functools.partial(_forward, model=model,
                           with_keypoints=with_keypoints)
    key = ("embed", model, with_keypoints,
           tuple(t.data_ptr() for t in (*model.parameters(),
                                        *model.buffers())))
    was_training = model.training
    model.eval()
    try:
        outs = []
        for i in range(0, images.shape[0], batch):
            x = (images[i:i + batch],)
            outs.append(tuple(o.clone() for o in graph.piece(
                fn, (), x, key, capture).step(x)))
    finally:
        model.train(was_training)
    descr = torch.cat([o[0] for o in outs])
    if not with_keypoints:
        return descr
    return descr, kp_mod.Keypoints(*(torch.cat(f) for f in
                                     zip(*(o[1:] for o in outs))))


def geometric_rerank(d_live, kp_live: kp_mod.Keypoints, d_mem,
                     kp_mem: kp_mod.Keypoints, cfg: lc.LoopConfig,
                     top_k: int = 7, draws: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None):
    """G-CALC2 scoring (test_net.py:176-206): per live image, verify its
    top_k cosine candidates by the keypoint ratio test and fundamental
    RANSAC and keep the candidate with the most inliers (the first among
    ties). Returns numpy (labels, scores), score = the cosine similarity of
    the geometric winner, 0 where it has fewer than min_inliers."""
    sim = cosine_similarity_matrix(d_live, d_mem)
    L = sim.shape[0]
    cand = torch.sort(sim, dim=1, descending=True,
                      stable=True).indices[:, :top_k]        # (L, top_k)
    idx2, ok = kp_mod.ratio_test_matches(
        kp_live.descr[:, None], kp_mem.descr[cand], cfg.ratio)
    pts2 = torch.gather(kp_mem.yx[cand], 2,
                        idx2[..., None].expand(-1, -1, -1, 2))
    pts1 = kp_live.yx[:, None].expand_as(pts2)
    if draws is None:          # (L, top_k, NH, K) uniforms in [0, 1)
        draws = torch.rand(L, cand.shape[1], cfg.ransac_hypotheses,
                           pts1.shape[2], generator=generator,
                           dtype=pts1.dtype, device=pts1.device)
    counts = lc.fundamental_ransac(pts1, pts2, ok, cfg, draws)
    best = torch.argmax(counts, dim=1, keepdim=True)
    cids = torch.gather(cand, 1, best)[:, 0].cpu().numpy()
    inliers = torch.gather(counts, 1, best)[:, 0].cpu().numpy()
    sim = sim.cpu().double().numpy()
    labels = (cids == np.arange(L)).astype(np.int32)
    scores = sim[np.arange(L), cids] * (inliers >= cfg.min_inliers)
    return labels, scores.astype(np.float64)


def evaluate_pairs(model, live_images, mem_images, batch: int = 8) -> dict:
    """Descriptor-level PR evaluation of live / memory pairs, the
    ``calc2.py --mode pr`` protocol. Returns {auc, precision, recall,
    labels, scores, similarity} (numpy)."""
    sim = cosine_similarity_matrix(embed(model, live_images, batch),
                                   embed(model, mem_images, batch))
    sim = sim.cpu().numpy()
    labels, scores = nn_retrieval_scores(sim)
    p, r, _ = precision_recall_curve(labels, scores)
    return {"auc": pr_auc(labels, scores), "precision": p, "recall": r,
            "labels": labels, "scores": scores, "similarity": sim}
