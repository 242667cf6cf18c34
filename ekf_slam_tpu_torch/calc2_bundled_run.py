"""CALC2 on bundled data, on the port: shards -> training -> PR-AUC ->
loop closure.

    python -m ekf_slam_tpu_torch.calc2_bundled_run --steps 400 \
        --out runs/calc2

Port of ``examples/calc2_bundled_run.py`` with its flags and
calc2_metrics.json. The reference trains on COCO-Stuff, evaluates PR on
CampusLoopDataset and closes loops on KITTI; none is bundled, so the same
protocol runs on the synthetic Voronoi generator (data/synthetic.py):

1. npz record shards and their loss weights (data/records.write_shards);
2. the untrained network's PR-AUC on held-out places (memory = a clean
   render, live = its augment.eval_view revisit, --eval-severity adds the
   seasonal change, --aliasing draws the places from archetypes);
3. training (models/train.fit) on the shards, or on archetype-grouped
   batches with --train-aliasing;
4. the trained PR-AUC with the aliasing statistics, the G-CALC2 re-rank
   (evaluate.geometric_rerank, top 5), the loop gate calibrated at the
   max-F1 point of the held-out scores;
5. online loop closure (models/loop_runner.run_online) over the places
   and then their revisits: the pose constraint runs K4 and K6 on the
   card every frame; loops declared and correct.

Randomness comes from torch generators seeded as the JAX script seeds its
keys (shards 7, places 1234, views 5, re-rank 9, loop RANSAC 11, aliased
batches 99), so a run matches the JAX one in distribution, not draw for
draw. Runs on the card unless --cpu. --dtype bfloat16 runs the VSS's
activations in bf16 (VSSConfig.compute_dtype). ``--world k`` trains
data-parallel on k ranks (processes, parallel/mesh.spawn; the JAX
script's branch for more than one device): rank 0 writes the shards and
runs every evaluation, all ranks train on the same global batches, each
keeping its block of --batch / k. ``--backend gloo`` lets several ranks
share one card (NCCL refuses two ranks on one GPU); the default is nccl
when every rank has a card of its own, else gloo.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import time

import numpy as np
import torch

from ekf_slam_tpu_torch.data import records, synthetic
from ekf_slam_tpu_torch.models import augment, evaluate, loop_runner, train
from ekf_slam_tpu_torch.models import loopclosure as lc
from ekf_slam_tpu_torch.models.vss import VSSConfig
from ekf_slam_tpu_torch.ops import device as devices
from ekf_slam_tpu_torch.ops import kernels
from ekf_slam_tpu_torch.parallel import mesh as pmesh
from ekf_slam_tpu_torch.utils.metrics import MetricsLogger

ALIAS_KEYS = ("true_revisit_p50", "aliased_impostor_p50",
              "aliased_impostor_p99", "cross_arch_impostor_p99")


def _gen(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def build_shards(out_dir: str, n_images: int, hw, device, seed: int = 7):
    """n_images synthetic scenes at hw as uint8 shards of 64 with their
    loss weights (the gen_tfrecords.py equivalent). Returns the number of
    shards."""
    gen = _gen(device, seed)

    def pairs():
        done = 0
        while done < n_images:
            imgs, labels = synthetic.synthetic_batch(16, hw, generator=gen)
            cls = torch.argmax(labels, dim=-1).to(torch.uint8).cpu().numpy()
            arr = (imgs * 255.0).to(torch.uint8).cpu().numpy()
            for i in range(arr.shape[0]):
                if done >= n_images:
                    return
                yield arr[i], cls[i]
                done += 1

    return records.write_shards(out_dir, pairs(), shard_size=64)


def eval_places(model, n_places: int, hw, device, severity: float = 0.0,
                aliasing: int = 0):
    """CampusLoop-style pairs and their PR evaluation: memory = clean
    renders of n_places places (from n_places / aliasing archetypes when
    aliasing > 0), live = their eval_view revisits. Returns (evaluation,
    live, mem), the evaluation with the aliasing statistics when
    aliasing > 0."""
    if aliasing:
        mem, _, arch = synthetic.aliased_places(
            n_places, aliasing, hw, generator=_gen(device, 1234))
    else:
        mem, _ = synthetic.synthetic_batch(n_places, hw,
                                           generator=_gen(device, 1234))
        arch = None
    live = augment.eval_view(mem, severity=severity,
                             generator=_gen(device, 5))
    out = evaluate.evaluate_pairs(model, live, mem, batch=8)
    if arch is not None:
        sim = out["similarity"]
        a = arch.cpu().numpy()
        eye = np.eye(n_places, dtype=bool)
        same_arch = (a[:, None] == a[None, :]) & ~eye
        cross = a[:, None] != a[None, :]
        out["true_revisit_p50"] = float(np.median(np.diag(sim)))
        out["aliased_impostor_p50"] = float(np.median(sim[same_arch]))
        out["aliased_impostor_p99"] = float(np.percentile(sim[same_arch],
                                                          99))
        out["cross_arch_impostor_p99"] = float(np.percentile(sim[cross], 99))
    return out, live, mem


def gcalc2_auc(model, live, mem, device, seed: int = 9) -> float:
    """PR-AUC of the G-CALC2 re-rank (top 5, 16 hypotheses, 10 inliers)."""
    d_l, kp_l = evaluate.embed(model, live, 8, with_keypoints=True)
    d_m, kp_m = evaluate.embed(model, mem, 8, with_keypoints=True)
    cfg = lc.LoopConfig(min_inliers=10, ransac_hypotheses=16)
    labels, scores = evaluate.geometric_rerank(
        d_l, kp_l, d_m, kp_m, cfg, top_k=5, generator=_gen(device, seed))
    return evaluate.pr_auc(labels, scores)


def calibrate_threshold(ev: dict):
    """The loop gate at the max-F1 point of the held-out retrieval scores,
    as a cosine; with the true and impostor cosines."""
    labels, scores = ev["labels"], ev["scores"]
    order = np.argsort(-scores)
    tp = np.cumsum(labels[order])
    k = np.arange(1, len(order) + 1)
    f1 = 2.0 * tp / (k + labels.sum())
    thr = float(2.0 * scores[order][np.argmax(f1)] - 1.0)
    cos = 2.0 * ev["similarity"] - 1.0
    return thr, np.diag(cos), cos[~np.eye(cos.shape[0], dtype=bool)]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--width", type=int, default=16)
    ap.add_argument("--hw", type=int, nargs=2, default=(96, 128))
    ap.add_argument("--data-hw", type=int, nargs=2, default=None,
                    help="shard-image size when larger than --hw: each "
                         "training batch is randomly cropped to --hw in "
                         "the step (calc2.py:254-258); default --hw")
    ap.add_argument("--images", type=int, default=1024)
    ap.add_argument("--places", type=int, default=64)
    ap.add_argument("--out", default="runs/calc2")
    ap.add_argument("--eval-severity", type=float, default=0.0,
                    help="seasonal_change severity of the eval revisits")
    ap.add_argument("--aliasing", type=int, default=0,
                    help="draw the eval places from places/aliasing "
                         "archetypes (0 = independent scenes)")
    ap.add_argument("--aliasing-sweep", default="",
                    help="comma list of aliasing group sizes to re-evaluate "
                         "the trained model at, e.g. '2,4,8,16'")
    ap.add_argument("--train-aliasing", type=int, default=0,
                    help="train on archetype-grouped batches of this group "
                         "size (synthetic.aliased_batches; 0 = shards)")
    ap.add_argument("--sim-objective", default="triplet",
                    choices=["triplet", "infonce"])
    ap.add_argument("--sim-tau", type=float, default=0.01)
    ap.add_argument("--train-severity", type=float, default=0.0,
                    help="TrainConfig.aug_severity: seasonal_change on the "
                         "positive training view")
    ap.add_argument("--remat", action="store_true",
                    help="checkpoint each conv block (VSSConfig.remat)")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="the VSS's activation dtype (compute_dtype)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--world", type=int, default=1,
                    help="data-parallel ranks (processes)")
    ap.add_argument("--backend", default=None, choices=["gloo", "nccl"],
                    help="the ranks' backend (gloo: ranks may share a "
                         "card)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the protocol; returns the calc2_metrics.json dict (rank 0's
    with --world > 1)."""
    args = parse_args(argv)
    if args.world == 1:
        return run(args)
    backend = args.backend or pmesh.default_backend(
        args.world, "cpu" if args.cpu else None)
    return pmesh.spawn(run, args.world, backend, args)[0]


def run(args) -> dict:
    """main's work on one rank (data-parallel training when --world > 1;
    the other ranks return {} after it)."""
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
    data_hw = tuple(args.data_hw) if args.data_hw else hw
    if data_hw[0] < hw[0] or data_hw[1] < hw[1]:
        raise ValueError("--data-hw must be >= --hw (shards are cropped "
                         "down, not up)")
    data_dir = os.path.join(args.out, "shards")
    t0 = time.time()
    if main_rank and not args.train_aliasing and not os.path.exists(
            os.path.join(data_dir, "loss_weights.txt")):
        n_shards = build_shards(data_dir, args.images, data_hw, dev)
        print(f"wrote {n_shards} shards ({args.images} images at "
              f"{data_hw[0]}x{data_hw[1]}) in {time.time() - t0:.0f}s")
    if mesh is not None:
        torch.distributed.barrier()         # the shards are written

    tcfg = train.TrainConfig(batch_size=args.batch, image_hw=hw,
                             ckpt_every=max(args.steps // 2, 1),
                             sim_objective=args.sim_objective,
                             sim_tau=args.sim_tau,
                             aug_severity=args.train_severity)
    model = train.create_model(
        VSSConfig(width=args.width, remat=args.remat,
                  compute_dtype=args.dtype), hw,
        torch.Generator().manual_seed(tcfg.seed)).to(dev)
    untrained = copy.deepcopy(model)
    if main_rank:
        base_eval, live, mem = eval_places(untrained, args.places, hw, dev,
                                           args.eval_severity, args.aliasing)
        print(f"UNTRAINED PR-AUC: {base_eval['auc']:.4f}")

    logger = MetricsLogger() if main_rank else None
    if args.train_aliasing:
        batches = synthetic.aliased_batches(args.batch, args.train_aliasing,
                                            hw, generator=_gen(dev, 99))
        fit_data_dir = None        # per-batch class-weight estimation
    else:
        batches = records.ShardReader(data_dir, args.batch)
        fit_data_dir = data_dir
    t0 = time.perf_counter()
    state, _ = train.fit(model, tcfg, batches, args.steps, ckpt_dir=args.out,
                         logger=logger, data_dir=fit_data_dir, mesh=mesh)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    if not main_rank:
        return {}
    logger.dump_jsonl(os.path.join(args.out, "train_metrics.jsonl"))
    print(logger.table(last_n=3))
    print(f"trained {args.steps} steps in {train_s:.2f} s -> "
          f"{args.steps / train_s:.3f} steps/s")
    model.eval()

    trained_eval, _, _ = eval_places(model, args.places, hw, dev,
                                     args.eval_severity, args.aliasing)
    for k in ALIAS_KEYS:
        if k in trained_eval:
            print(f"  {k}: untrained {base_eval[k]:.4f} "
                  f"-> trained {trained_eval[k]:.4f}")
    print(f"TRAINED PR-AUC: {trained_eval['auc']:.4f} "
          f"(lift {trained_eval['auc'] - base_eval['auc']:+.4f}; "
          f"np.{evaluate.TRAPEZOID})")
    g_auc = gcalc2_auc(model, live, mem, dev)
    print(f"G-CALC2 re-rank PR-AUC: {g_auc:.4f}")

    thr, true_cos, imp_cos = calibrate_threshold(trained_eval)
    print(f"calibrated loop sim_threshold: {thr:.3f} (max-F1 point; true "
          f"med {np.median(true_cos):.3f}, impostor p99 "
          f"{np.percentile(imp_cos, 99.0):.3f})")
    P = min(24, args.places)
    seq = torch.cat([mem[:P], live[:P]])[:, None]       # (T, 1, H, W, 3)
    lcfg = lc.LoopConfig(capacity=128, top_k=3, exclude_recent=P // 2,
                         min_db=P // 2, sim_threshold=thr, min_inliers=8,
                         ransac_hypotheses=16, consistency_count=2,
                         consistency_window=2)
    x0 = torch.zeros(1, 13)
    x0[:, 3] = 1.0
    P0 = torch.eye(13).expand(1, 13, 13) * 1e-2
    launches0 = dict(kernels.LAUNCHES)
    _, _, _, outs = loop_runner.run_online(
        model, seq, x0, P0, lcfg, generator=_gen(dev, 11), device=dev)
    launches = {k: v - launches0[k] for k, v in kernels.LAUNCHES.items()
                if v > launches0[k]}
    declared = outs.declared[:, 0].cpu().numpy()
    match = outs.match_id[:, 0].cpu().numpy()
    # a loop at revisit step P + i is correct within 3 frames of i
    correct = sum(1 for t in np.flatnonzero(declared)
                  if t >= P and abs(int(match[t]) - (t - P)) <= 3)
    n_declared = int(declared.sum())
    print(f"loops declared on revisit pass: {n_declared} ({correct} "
          f"correct); kernel launches {json.dumps(launches)}")

    sweep_rows = []
    for g in [int(s) for s in args.aliasing_sweep.split(",") if s]:
        ev_u, _, _ = eval_places(untrained, args.places, hw, dev,
                                 args.eval_severity, g)
        ev_t, live_g, mem_g = eval_places(model, args.places, hw, dev,
                                          args.eval_severity, g)
        row = {"group": g, "pr_auc_untrained": float(ev_u["auc"]),
               "pr_auc_trained": float(ev_t["auc"]),
               "pr_auc_gcalc2": float(gcalc2_auc(model, live_g, mem_g,
                                                 dev))}
        row.update({k: ev_t[k] for k in ("true_revisit_p50",
                                         "aliased_impostor_p50",
                                         "cross_arch_impostor_p99")
                    if k in ev_t})
        sweep_rows.append(row)
        print(f"aliasing group {g}: plain {row['pr_auc_trained']:.4f} "
              f"(untrained {row['pr_auc_untrained']:.4f}), G-CALC2 "
              f"{row['pr_auc_gcalc2']:.4f}")

    train.save_checkpoint(os.path.join(args.out, "ckpt_final"), state)
    loss = logger.series("loss")
    results = {
        "steps": args.steps, "width": args.width, "hw": list(hw),
        "images": args.images, "places": args.places,
        "loss_first": loss[0] if loss else None,
        "loss_last": loss[-1] if loss else None,
        "pr_auc_untrained": float(base_eval["auc"]),
        "pr_auc_trained": float(trained_eval["auc"]),
        "pr_auc_gcalc2": float(g_auc),
        "loops_declared": n_declared, "loops_correct": correct,
        "loop_sim_threshold": thr,
        "eval_severity": args.eval_severity, "aliasing": args.aliasing,
        "train_aliasing": args.train_aliasing,
        "train_severity": args.train_severity,
        "sim_objective": args.sim_objective, "sim_tau": args.sim_tau,
        "aliasing_sweep": sweep_rows,
        "train_steps_per_s": args.steps / train_s,
        "class_weights": (records.load_weights(data_dir).tolist()
                          if not args.train_aliasing else None),
        "loop_launches": launches, "trapezoid": evaluate.TRAPEZOID,
        "device": str(dev), "dtype": args.dtype, "world": args.world,
    }
    for k in ALIAS_KEYS:
        if k in trained_eval:
            results[k + "_untrained"] = base_eval[k]
            results[k] = trained_eval[k]
    with open(os.path.join(args.out, "calc2_metrics.json"), "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps({k: v for k, v in results.items()
                      if k != "class_weights"}, indent=2))
    return results


if __name__ == "__main__":
    main()
