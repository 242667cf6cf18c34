"""Process meshes, their collectives, and the data-parallel ensemble.

Port of ``ekf_slam_tpu/parallel/mesh.py`` on ``torch.distributed``. JAX
places arrays on a device mesh and lets XLA insert the collectives; torch
has no GSPMD, so here every rank is a process that holds its own block
and every collective is written out:

* ``make_mesh(data=None, model=1, backend=None)`` — a ``Mesh`` over the
  ranks of the default process group with axes ``("data",)`` or
  ``("data", "model")`` (``init_device_mesh``; ranks are row-major, so
  the ranks of one data index are consecutive along "model"). Each rank's
  device is ``cuda:{local_rank % device_count}``, unless the caller asks
  for the CPU. The backend is explicit: "nccl" when every rank has a card
  of its own, "gloo" when ranks share one card (NCCL refuses two ranks on
  one GPU) or run on the CPU; gloo takes CUDA tensors and stages them
  through the host itself.
* ``spawn(fn, world, backend, *args)`` — ``world`` ranks as processes
  (``torch.multiprocessing.spawn``), each with the default group set up
  on a free localhost port; returns each rank's ``fn(*args)`` in rank
  order.
* ``shard_batch(tree, mesh, axis)`` — this rank's contiguous block of the
  leading axis; ``replicate(tree, mesh)`` — the tree as rank 0 holds it.
* ``all_gather`` / ``all_reduce`` — the collectives the parallel modules
  use, each recorded in ``COLLECTIVES`` with its payload in elements (the
  gathered or reduced tensor), which the tests hold to their bounds.
* ``run_ensemble`` — the Monte-Carlo ensemble: each rank runs
  ``engine.run_sequence`` on its block of filter instances; after the
  loop one all-reduce forms the mean trajectory and a second the
  position covariance about it (the centred two-pass form of JAX's
  mesh.py:71-75). Nothing crosses ranks inside the step loop.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import socket
import warnings
from typing import Any, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# (op, axis, elements) of every collective since the last reset, in order.
COLLECTIVES: list = []


def reset_collectives() -> None:
    COLLECTIVES.clear()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of the default group as a ("data",) or ("data", "model")
    grid, and this rank's place in it."""
    device_mesh: Any                 # torch's DeviceMesh
    names: tuple
    shape: dict                      # axis name -> size
    device: torch.device
    backend: str

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def rank(self, axis: str) -> int:
        """This rank's index along `axis` (0 along an axis the mesh has
        not: a ("data",) mesh is a ("data", "model") one of model 1)."""
        return self.device_mesh.get_local_rank(axis) if axis in self.shape \
            else 0

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def default_backend(world: int, device=None) -> str:
    """"nccl" when each of `world` ranks can have a card of its own and
    the caller does not ask for the CPU, else "gloo"."""
    cuda = torch.cuda.is_available() and (
        device is None or torch.device(device).type == "cuda")
    return "nccl" if cuda and torch.cuda.device_count() >= world else "gloo"


def make_mesh(data: Optional[int] = None, model: int = 1,
              backend: Optional[str] = None, device=None) -> Mesh:
    """A mesh over the ranks of the default process group (one of a
    single rank, set up here, when there is none): ("data",) when model is
    1, else ("data", "model"); data defaults to world // model. backend
    None takes the default group's. device "cpu" keeps every rank on the
    CPU; otherwise rank r works on cuda:{local r % device_count}."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        dist.init_process_group(
            backend or default_backend(1, device),
            init_method=f"tcp://localhost:{free_port()}", world_size=1,
            rank=0)
    world = dist.get_world_size()
    data = world // model if data is None else data
    if data * model != world:
        raise ValueError(f"mesh {data} x {model} != {world} ranks")
    backend = backend or dist.get_backend()
    if backend != dist.get_backend():
        raise ValueError(f"backend {backend!r}: the default group runs "
                         f"{dist.get_backend()!r}")
    if device is not None and torch.device(device).type == "cpu":
        dev = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device (device='cpu' "
                               "for CPU ranks)")
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    names = ("data",) if model == 1 else ("data", "model")
    shape = (data,) if model == 1 else (data, model)
    # The mesh's device type follows the backend: gloo is the CPU one
    # (the tensors it moves may still be CUDA tensors).
    dm = init_device_mesh("cuda" if backend == "nccl" else "cpu", shape,
                          mesh_dim_names=names)
    return Mesh(dm, names, dict(zip(names, shape)), dev, backend)


def _entry(rank, fn, world, backend, port, queue, args):
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    torch.set_num_threads(max(1, torch.get_num_threads() // world))
    try:
        # pickled here by value: a tensor put on the queue as it is would
        # travel as a handle to this process's memory, gone once it exits
        queue.put((rank, pickle.dumps(fn(*args))))
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, backend: str, *args) -> list:
    """Run fn(*args) in `world` fresh processes, each a rank of a default
    group on `backend` (a free localhost port); returns the ranks'
    results, which must pickle, in rank order. fn must be importable by
    name (a module-level function). Raises if a rank fails."""
    queue = mp.get_context("spawn").SimpleQueue()
    procs = mp.spawn(_entry, args=(fn, world, backend, free_port(), queue,
                                   args), nprocs=world, join=False)
    out, done = {}, False
    while not done:                 # read while the ranks run: a result
        while not queue.empty():    # larger than the pipe would block them
            rank, value = queue.get()
            out[rank] = pickle.loads(value)
        done = procs.join(timeout=0.05)     # raises if a rank failed
    while not queue.empty():
        rank, value = queue.get()
        out[rank] = pickle.loads(value)
    return [out[r] for r in range(world)]


# --- trees and collectives --------------------------------------------------

def tree_map(fn, tree):
    """fn over the tensor leaves of nested dicts, lists, tuples, named
    tuples and dataclasses; other leaves are kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return tree


def block(n: int, mesh: Mesh, axis: str = "data") -> slice:
    """This rank's contiguous block of n entries along `axis`."""
    k = mesh.size(axis)
    if n % k:
        raise ValueError(f"{n} entries do not split over {k} ranks of "
                         f"{axis!r}")
    lo = mesh.rank(axis) * (n // k)
    return slice(lo, lo + n // k)


def shard_batch(tree, mesh: Mesh, axis: str = "data"):
    """This rank's block of the leading axis of every tensor of `tree`,
    on the mesh's device."""
    return tree_map(lambda t: t[block(t.shape[0], mesh, axis)].to(
        mesh.device), tree)


def replicate(tree, mesh: Mesh):
    """`tree` on the mesh's device as rank 0 holds it (a broadcast of
    every tensor from rank 0)."""
    def bcast(t):
        t = t.to(mesh.device).clone()
        dist.broadcast(t, src=0)
        return t
    return tree_map(bcast, tree)


def all_gather(t: torch.Tensor, mesh: Mesh, axis: str,
               dim: int = 0) -> torch.Tensor:
    """The ranks' `t` along `axis`, concatenated along `dim` in rank
    order."""
    k = mesh.size(axis)
    COLLECTIVES.append(("all_gather", axis, k * t.numel()))
    if k == 1:
        return t
    t = t.movedim(dim, 0).contiguous()
    out = torch.empty((k * t.shape[0],) + t.shape[1:], dtype=t.dtype,
                      device=t.device)
    with warnings.catch_warnings():     # deprecated for all_gather_single,
        warnings.simplefilter("ignore", FutureWarning)   # not in older torch
        dist.all_gather_into_tensor(out, t, group=mesh.group(axis))
    return out.movedim(0, dim)


def all_reduce(t: torch.Tensor, mesh: Mesh, axis: str,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The ranks' `t` reduced over `axis` (a new tensor)."""
    COLLECTIVES.append(("all_reduce", axis, t.numel()))
    t = t.contiguous().clone()
    if mesh.size(axis) > 1:
        dist.all_reduce(t, op=op, group=mesh.group(axis))
    return t


# --- the data-parallel ensemble ---------------------------------------------

def run_ensemble(state_batch, obs_seq, draws: torch.Tensor, cfg,
                 mesh: Mesh, axis: str = "data"):
    """Monte-Carlo ensemble of full SLAM runs over the ranks of `axis`.

    state_batch: the global batch (B instances; FilterState); obs_seq:
    the FrameObs sequence (T frames), the same on every rank; draws
    (T, B, NHYP) RANSAC's uniforms of every instance. Each rank runs its
    block of B/k instances. Returns (this rank's final states, its
    trajectories (B/k, T, 13), the ensemble's mean trajectory (T, 13) and
    its position covariance (T, 3, 3), both over all B instances)."""
    from ekf_slam_tpu_torch.filter import engine

    states = shard_batch(state_batch, mesh, axis)
    mine = block(draws.shape[1], mesh, axis)
    final, traj, infos = engine.run_sequence(
        states, obs_seq.to(mesh.device), draws[:, mine].to(mesh.device), cfg)
    B = draws.shape[1]
    mean = all_reduce(traj.sum(dim=0), mesh, axis) / B
    dev = traj[..., 0:3] - mean[None, :, 0:3]
    cov = all_reduce(torch.einsum("bti,btj->tij", dev, dev), mesh, axis) / B
    return final, traj, mean, cov
