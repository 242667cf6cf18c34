"""CALC2 training driver, on the port: the ``calc2.py --mode train``
equivalent.

    python -m ekf_slam_tpu_torch.train_calc2 --steps 200 --batch 8 \
        --width 16 --out runs/calc2_run

Port of ``examples/train_calc2.py`` with its flags and outputs: trains the
VSS on synthetic Voronoi scenes (data/synthetic.py; or npz record shards
with --data) through ``models/train.fit``, a checkpoint every
--ckpt-every steps, then the PR evaluation on near-duplicate pairs;
writes train_metrics.jsonl, the checkpoints and ckpt_final into --out and
prints the retrieval PR-AUC. The weights are drawn from a generator
seeded TrainConfig.seed, the batches from one seeded 1 on the device.
Runs on the card unless --cpu. ``--world k`` trains data-parallel on k
ranks (processes, parallel/mesh.spawn; the JAX script's branch for more
than one device): each rank draws the same global batches and keeps its
block of --batch / k; rank 0 writes the outputs and evaluates.
``--backend gloo`` lets several ranks share one card (NCCL refuses two
ranks on one GPU); the default is nccl when every rank has a card of its
own, else gloo.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from ekf_slam_tpu_torch.data import records, synthetic
from ekf_slam_tpu_torch.models import evaluate, train
from ekf_slam_tpu_torch.models.vss import VSSConfig
from ekf_slam_tpu_torch.ops import device as devices
from ekf_slam_tpu_torch.parallel import mesh as pmesh
from ekf_slam_tpu_torch.utils.metrics import MetricsLogger


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--width", type=int, default=16)
    ap.add_argument("--hw", type=int, nargs=2, default=(64, 64))
    ap.add_argument("--data", default=None,
                    help="npz shard dir (data/records.py)")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "calc2_run"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU")
    ap.add_argument("--world", type=int, default=1,
                    help="data-parallel ranks (processes)")
    ap.add_argument("--backend", default=None, choices=["gloo", "nccl"],
                    help="the ranks' backend (gloo: ranks may share a "
                         "card)")
    return ap.parse_args(argv)


def synthetic_batches(batch: int, hw, device, seed: int = 1):
    """Endless synthetic_batch draws from a generator seeded `seed` on
    `device`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    while True:
        yield synthetic.synthetic_batch(batch, hw, generator=gen)


def eval_pairs(hw, device):
    """The PR evaluation's near-duplicate pairs (the --mode pr protocol):
    (live, mem), mem 8 synthetic scenes (a generator seeded 99 on
    `device`), live = mem + 0.02 N(0, 1) (seeded 100), clamped."""
    mem, _ = synthetic.synthetic_batch(
        8, hw, generator=torch.Generator(device=device).manual_seed(99))
    noise = torch.randn(mem.shape, device=device, generator=torch.Generator(
        device=device).manual_seed(100))
    return torch.clamp(mem + 0.02 * noise, 0.0, 1.0), mem


def main(argv=None) -> dict:
    """Train and evaluate; returns {steps, seconds, steps_per_s, auc,
    loss_first, loss_last, out, world} (rank 0's with --world > 1)."""
    args = parse_args(argv)
    if args.world == 1:
        return run(args)
    backend = args.backend or pmesh.default_backend(
        args.world, "cpu" if args.cpu else None)
    return pmesh.spawn(run, args.world, backend, args)[0]


def run(args) -> dict:
    """main's work on one rank: on a data-parallel mesh when --world > 1
    (rank 0 returns the report, the others {})."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = devices.resolve("cpu" if args.cpu else None)
    mesh = None
    if args.world > 1:
        mesh = pmesh.make_mesh(device=dev)
        dev = mesh.device
    main_rank = mesh is None or torch.distributed.get_rank() == 0
    os.makedirs(args.out, exist_ok=True)
    hw = tuple(args.hw)
    tcfg = train.TrainConfig(batch_size=args.batch, image_hw=hw,
                             ckpt_every=args.ckpt_every)
    model = train.create_model(VSSConfig(width=args.width), hw,
                               torch.Generator().manual_seed(tcfg.seed))
    model = model.to(dev)
    batches = (iter(records.ShardReader(args.data, args.batch))
               if args.data else synthetic_batches(args.batch, hw, dev))
    logger = MetricsLogger() if main_rank else None
    t0 = time.perf_counter()
    state, _ = train.fit(model, tcfg, batches, args.steps, ckpt_dir=args.out,
                         logger=logger, data_dir=args.data, mesh=mesh)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if not main_rank:
        return {}
    logger.dump_jsonl(os.path.join(args.out, "train_metrics.jsonl"))
    print(logger.table(last_n=3))
    print(f"trained {args.steps} steps in {seconds:.2f} s -> "
          f"{args.steps / seconds:.3f} steps/s "
          f"({args.steps * args.batch / seconds:.2f} images/s)", flush=True)

    live, mem = eval_pairs(hw, dev)
    out = evaluate.evaluate_pairs(state.model, live, mem, batch=4)
    print(f"retrieval PR-AUC: {out['auc']:.4f} (np.{evaluate.TRAPEZOID})")
    train.save_checkpoint(os.path.join(args.out, "ckpt_final"), state)
    print(f"outputs in {args.out}")
    loss = logger.series("loss")
    return {"steps": args.steps, "seconds": seconds,
            "steps_per_s": args.steps / seconds, "auc": out["auc"],
            "loss_first": loss[0], "loss_last": loss[-1], "out": args.out,
            "world": args.world}


if __name__ == "__main__":
    main()
