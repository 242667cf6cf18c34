"""Sharded record pipeline (the gen_tfrecords.py equivalent, tfrecord-free).

A copy of ``ekf_slam_tpu/data/records.py`` (the JAX package's file
uses no JAX; the port imports nothing of that package).

The reference serializes COCO-Stuff into 100 tfrecord shards of
(320x320 image, mask) pairs plus inverse-class-frequency loss weights
("CALC 2.0"/dataset/gen_tfrecords.py:21,41-167). The equivalent here:
compressed .npz shards (no TF dependency) with the same content contract:

  images  : (N, H, W, 3) uint8
  labels  : (N, H, W)   uint8   — 13-class CALC ids (data/classes.py)
  weights : (13,) float32       — running inverse class frequencies

`write_shards` builds them from any (image, label) iterator — the COCO
adapter (data/coco.py) or the synthetic generator. `ShardReader` streams
shuffled batches for training.
"""

from __future__ import annotations

import glob as globlib
import os
from typing import Iterator, Tuple

import numpy as np

from ekf_slam_tpu_torch.data.classes import N_CALC_CLASSES


def write_shards(out_dir: str, pairs: Iterator[Tuple[np.ndarray, np.ndarray]],
                 shard_size: int = 256, num_shards: int | None = None):
    """pairs yields (image uint8 (H,W,3), label uint8 (H,W)). Returns the
    number of shards written. Also writes loss_weights.txt
    (gen_tfrecords.py:162-167 running-mean scheme)."""
    os.makedirs(out_dir, exist_ok=True)
    freq_mean = np.zeros(N_CALC_CLASSES, np.float64)
    n_seen = 0
    shard, imgs, labs = 0, [], []

    def flush():
        nonlocal shard, imgs, labs
        if not imgs:
            return
        np.savez_compressed(
            os.path.join(out_dir, f"shard_{shard:05d}.npz"),
            images=np.stack(imgs), labels=np.stack(labs))
        shard += 1
        imgs, labs = [], []

    for img, lab in pairs:
        imgs.append(img.astype(np.uint8))
        labs.append(lab.astype(np.uint8))
        counts = np.bincount(lab.reshape(-1), minlength=N_CALC_CLASSES)
        frac = counts / lab.size
        n_seen += 1
        freq_mean += (frac - freq_mean) / n_seen   # running mean
        if len(imgs) >= shard_size:
            flush()
        if num_shards is not None and shard >= num_shards:
            break
    flush()
    weights = 1.0 / np.maximum(freq_mean, 1e-4)
    np.savetxt(os.path.join(out_dir, "loss_weights.txt"), weights)
    return shard


def load_weights(data_dir: str) -> np.ndarray:
    return np.loadtxt(os.path.join(data_dir, "loss_weights.txt")).astype(
        np.float32)


class ShardReader:
    """Shuffled epoch iterator over .npz shards -> float batches.

    With `prefetch > 0` (default 2) a background thread decompresses and
    assembles batches ahead of the consumer — the host-side IO overlap the
    reference got from map_and_batch/shuffle_and_repeat (calc2.py:107-120);
    zlib decompression releases the GIL, so shard decode genuinely overlaps
    the accelerator step. `prefetch=0` keeps the synchronous path."""

    def __init__(self, data_dir: str, batch_size: int, seed: int = 0,
                 prefetch: int = 2):
        self.paths = sorted(globlib.glob(os.path.join(data_dir,
                                                      "shard_*.npz")))
        if not self.paths:
            raise FileNotFoundError(f"no shards under {data_dir}")
        self.batch_size = batch_size
        self.prefetch = prefetch
        self.rng = np.random.default_rng(seed)

    def _epoch(self):
        order = self.rng.permutation(len(self.paths))
        for si in order:
            with np.load(self.paths[si]) as shard:
                imgs = shard["images"]
                labs = shard["labels"]
            idx = self.rng.permutation(len(imgs))
            for i in range(0, len(idx) - self.batch_size + 1,
                           self.batch_size):
                sel = idx[i:i + self.batch_size]
                x = imgs[sel].astype(np.float32) / 255.0
                y = np.eye(N_CALC_CLASSES, dtype=np.float32)[labs[sel]]
                yield x, y

    def __iter__(self):
        if self.prefetch <= 0:
            yield from self._epoch()
            return
        import queue
        import threading
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        _END = object()

        def producer():
            try:
                for batch in self._epoch():
                    while not stop.is_set():
                        try:
                            q.put(batch, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            finally:
                while not stop.is_set():
                    try:
                        q.put(_END, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    break
                yield item
        finally:
            stop.set()
            t.join(timeout=5.0)


def write_val_shards(out_dir: str,
                     examples: Iterator[Tuple[np.ndarray, np.ndarray,
                                              np.ndarray, np.ndarray]],
                     shard_size: int = 256) -> int:
    """Val-split shards with EMBEDDED eval pairs — the reference bakes a
    CampusLoopDataset (live, memory) image pair into every val example
    next to the (image, label) training fields
    (gen_tfrecords.py:81-88,147-149). examples yields
    (image u8 (H,W,3), label u8 (H,W), cl_live u8 (H,W,3),
    cl_mem u8 (H,W,3)). Returns the number of shards written."""
    os.makedirs(out_dir, exist_ok=True)
    shard, bufs = 0, ([], [], [], [])

    def flush():
        nonlocal shard, bufs
        if not bufs[0]:
            return
        np.savez_compressed(
            os.path.join(out_dir, f"val_shard_{shard:05d}.npz"),
            images=np.stack(bufs[0]), labels=np.stack(bufs[1]),
            cl_live=np.stack(bufs[2]), cl_mem=np.stack(bufs[3]))
        shard += 1
        bufs = ([], [], [], [])

    for img, lab, live, mem in examples:
        for b, a in zip(bufs, (img, lab, live, mem)):
            b.append(a.astype(np.uint8))
        if len(bufs[0]) >= shard_size:
            flush()
    flush()
    return shard


def load_eval_pairs(data_dir: str) -> Tuple[np.ndarray, np.ndarray]:
    """Collect the embedded (cl_live, cl_mem) eval pairs from every val
    shard, as float batches in [0,1] — the arrays
    models/evaluate.evaluate_pairs consumes (test_net.py reads the same
    fields back out of the val tfrecords)."""
    paths = sorted(globlib.glob(os.path.join(data_dir, "val_shard_*.npz")))
    if not paths:
        raise FileNotFoundError(f"no val shards under {data_dir}")
    live, mem = [], []
    for p in paths:
        with np.load(p) as z:
            live.append(z["cl_live"])
            mem.append(z["cl_mem"])
    return (np.concatenate(live).astype(np.float32) / 255.0,
            np.concatenate(mem).astype(np.float32) / 255.0)
