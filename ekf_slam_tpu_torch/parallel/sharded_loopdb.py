"""The capacity-sharded loop-closure database over a process mesh.

Port of ``ekf_slam_tpu/parallel/sharded_loopdb.py``. The ring of
``models/loopclosure.py`` holds a descriptor, the keypoints and a pose a
frame; at LoopConfig's defaults (4,096 frames, width 32) it is 9.36 GB at
B = 4 instances, more than one device should hold beside the model. Here
each rank of the mesh axis owns a contiguous block of N/k slots of every
ring tensor (the slot axis, dim 1: the port's database has a leading
instance axis), and count / streak / last_match are replicated:

* ``init_db`` makes this rank's block empty (no rank holds the whole
  ring); ``shard_db`` cuts it from a whole database;
* ``push`` writes the frame on the slot's owner only (slot = count % N);
* ``query`` — each rank scores its slots (the masked cosine) and keeps
  its top k_loc = min(top_k, N/k) by the stable descending sort; ONE
  all_gather brings every rank's candidate packet (similarity, slot,
  frame id, keypoints, pose) to every rank, and the global top_k is the
  stable sort of the gathered packets in rank order. A rank's top k_loc
  holds every slot of it that can make the global top_k and ties keep
  the single database's order (lower slot first), so the candidates
  equal ``loopclosure.query``'s. Verification (``loopclosure.verify``)
  then runs replicated, on the same RANSAC draws on every rank;
* ``best_pose`` — the matched slot's pose from its owner, a masked
  all_reduce.

N must divide by the axis size.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ekf_slam_tpu_torch.models import loopclosure as lc
from ekf_slam_tpu_torch.models.keypoints import Keypoints
from ekf_slam_tpu_torch.parallel import mesh as pmesh
from ekf_slam_tpu_torch.parallel.mesh import Mesh


def _n_local(cap: int, mesh: Mesh, axis: str) -> int:
    k = mesh.size(axis)
    if cap % k:
        raise ValueError(f"capacity {cap} not divisible by mesh axis "
                         f"{axis!r} size {k}")
    return cap // k


def init_db(cfg: lc.LoopConfig, batch: int, descr_dim: int, num_kp: int,
            kp_dim: int, mesh: Mesh, axis: str = "data",
            dtype=torch.float32) -> lc.LoopDatabase:
    """This rank's empty block of a database of cfg.capacity slots, on
    the mesh's device."""
    n_loc = _n_local(cfg.capacity, mesh, axis)
    return lc.init_db(dataclasses.replace(cfg, capacity=n_loc), batch,
                      descr_dim, num_kp, kp_dim, dtype, mesh.device)


def shard_db(db: lc.LoopDatabase, mesh: Mesh,
             axis: str = "data") -> lc.LoopDatabase:
    """This rank's block of the slots of a whole database; the scalars
    as they are."""
    sl = pmesh.block(db.descr.shape[1], mesh, axis)
    ring = ("descr", "kp_yx", "kp_descr", "pose", "frame_id")
    return lc.LoopDatabase(**{
        f: (getattr(db, f)[:, sl] if f in ring else getattr(db, f))
        .to(mesh.device).clone() for f in lc.DB_FIELDS})


def _owner(db: lc.LoopDatabase, slot: torch.Tensor, mesh: Mesh, axis: str):
    """(this rank owns slot (B,)?, its local index, clamped)."""
    n_loc = db.descr.shape[1]
    li = slot.long() - mesh.rank(axis) * n_loc
    return (li >= 0) & (li < n_loc), li.clamp(0, n_loc - 1)


def push(db: lc.LoopDatabase, descr: torch.Tensor, kp: Keypoints,
         pose: torch.Tensor, mesh: Mesh,
         axis: str = "data") -> lc.LoopDatabase:
    """loopclosure.push on the sharded ring, in place: the frame lands in
    slot count % N on its owner; every rank advances count."""
    cap = db.descr.shape[1] * mesh.size(axis)
    mine, li = _owner(db, db.count % cap, mesh, axis)
    b = torch.arange(db.count.shape[0], device=db.count.device)

    def put(arr, val):
        cur = arr[b, li]
        m = mine.reshape((-1,) + (1,) * (cur.dim() - 1))
        arr[b, li] = torch.where(m, val.to(arr.dtype), cur)

    put(db.descr, descr)
    put(db.kp_yx, kp.yx)
    put(db.kp_descr, kp.descr)
    put(db.pose, pose)
    put(db.frame_id, db.count)
    return db.replace(count=db.count + 1)


def query(db: lc.LoopDatabase, descr: torch.Tensor, kp: Keypoints,
          cfg: lc.LoopConfig, mesh: Mesh, axis: str = "data",
          draws: Optional[torch.Tensor] = None,
          generator: Optional[torch.Generator] = None) -> lc.QueryResult:
    """loopclosure.query over the sharded ring: local scores and top
    k_loc, one all_gather of the candidate packets, the global top_k,
    then the replicated verification (draws or `generator` as query
    takes them: the same on every rank)."""
    B, n_loc = db.descr.shape[:2]
    k = mesh.size(axis)
    k_loc = min(cfg.top_k, n_loc)
    if k * k_loc < cfg.top_k:
        raise ValueError(f"top_k {cfg.top_k} exceeds capacity {k * n_loc}")
    age = db.count[:, None] - 1 - db.frame_id
    valid = (db.frame_id >= 0) & (age >= cfg.exclude_recent)
    sims = (db.descr @ descr[..., None].to(db.descr.dtype))[..., 0]
    sims = torch.where(valid, sims, -torch.inf)
    top_sims, top_loc = torch.sort(sims, dim=1, descending=True, stable=True)
    top_sims, top_loc = top_sims[:, :k_loc], top_loc[:, :k_loc]
    b = torch.arange(B, device=top_loc.device)[:, None]
    K = db.kp_yx.shape[2]
    # One packet a candidate in the ring's dtype; slots and frame ids are
    # exact in it (integers below 2^24).
    dt = db.descr.dtype
    packet = torch.cat([
        top_sims[..., None],
        (top_loc + mesh.rank(axis) * n_loc)[..., None].to(dt),
        db.frame_id[b, top_loc][..., None].to(dt),
        db.kp_yx[b, top_loc].reshape(B, k_loc, -1),
        db.kp_descr[b, top_loc].reshape(B, k_loc, -1),
        db.pose[b, top_loc]], dim=2)
    pool = pmesh.all_gather(packet, mesh, axis, dim=1)   # (B, k·k_loc, .)
    sims_all, idx = torch.sort(pool[..., 0], dim=1, descending=True,
                               stable=True)
    sel = torch.gather(pool, 1, idx[:, :cfg.top_k, None].expand(
        -1, -1, pool.shape[2]))
    kd = sel[..., 3 + 2 * K:-7]
    return lc.verify(
        kp, sims_all[:, :cfg.top_k], sel[..., 1].long(),
        sel[..., 2].to(db.frame_id.dtype),
        sel[..., 3:3 + 2 * K].reshape(B, cfg.top_k, K, 2),
        kd.reshape(B, cfg.top_k, K, -1), cfg, draws, generator)


def best_pose(db: lc.LoopDatabase, best_slot: torch.Tensor, mesh: Mesh,
              axis: str = "data") -> torch.Tensor:
    """The stored pose (B, 7) of slot best_slot (B,) from its owner: each
    rank contributes its row where it owns the slot, zeros elsewhere."""
    mine, li = _owner(db, best_slot, mesh, axis)
    b = torch.arange(li.shape[0], device=li.device)
    row = torch.where(mine[:, None], db.pose[b, li],
                      torch.zeros_like(db.pose[b, li]))
    return pmesh.all_reduce(row, mesh, axis)
