"""The IEKF at the bench workload's size, JAX against the port, on the CPU.

    python tests/torch_iekf_reference.py [--batch 4] [--scenes 0,1,2,3]

chip_smoke.py's ``iekf`` slice — profile_slice.slice_config("iekf"): CAP
100, 128 landmarks, min_features 25, max_new_per_step 10, max_update_obs
64, NHYP 64, f32, Newton gain for the HI update, use_iterated_update with
3 iterations, unfused — held to bench.py's gates (finite state, the update
cap never hit, mean tracking error < 0.2) over 16 frames. For each scene
seed s it prints JAX's run (jit, vmap over B) on JAX's own world
(simulate(key(s))) and on the port's world (the port's simulate from a
torch generator seeded s, handed to JAX as arrays), with RANSAC keys from
key(1); then the port's run on its world with its draws (profile_slice
.slice_inputs), on the CPU (the kernels' plain versions). Not a test: the
record behind the slice's scene choice (PERF.md §4).
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from ekf_slam_tpu import config as jcfg  # noqa: E402
from ekf_slam_tpu.filter import engine as jengine  # noqa: E402
from ekf_slam_tpu.filter.state import init_state as j_init_state  # noqa
from ekf_slam_tpu.sim import simulate as j_simulate  # noqa: E402
from ekf_slam_tpu.sim.scene import FrameObs as JFrameObs  # noqa: E402
from ekf_slam_tpu_torch.filter import engine  # noqa: E402
from ekf_slam_tpu_torch.profile_slice import (FRAMES, slice_config,  # noqa
                                              slice_inputs)
from ekf_slam_tpu_torch.sim import simulate  # noqa: E402


def jax_config(cfg):
    """The JAX twin of a port EngineConfig."""
    kw = {f: type(getattr(jcfg.DEFAULT, f))(**vars(getattr(cfg, f)))
          for f in ("camera", "filter", "map", "matching", "ransac",
                    "vision", "sim")}
    return jcfg.EngineConfig(**kw, dtype=cfg.dtype)


def gates(tag, traj, P, xs, n_li, n_hi, cap):
    B = traj.shape[0]
    ok = (np.isfinite(traj).reshape(B, -1).all(1)
          & np.isfinite(P).reshape(B, -1).all(1))
    err = np.linalg.norm(traj[..., :3] - xs[None, :, :3], axis=-1).mean(1)
    largest = int(max(n_li.max(), n_hi.max()))
    print(f"[iekf_ref] {tag} batch={B} finite={int(ok.sum())} "
          f"mean_err={float(err[ok].mean()) if ok.any() else None:.4f} "
          f"max_err={float(err[ok].max()) if ok.any() else None:.4f} "
          f"largest_update={largest} update_cap={cap} "
          f"pass={bool(ok.all() and err.mean() < 0.2 and largest <= cap)}",
          flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--scenes", default="0")
    args = ap.parse_args(argv)
    cfg = slice_config("iekf")
    jc = jax_config(cfg)
    cap = cfg.map.max_update_obs
    B = args.batch
    run = jax.jit(jax.vmap(lambda s, o, k: jengine.run_sequence(s, o, k, jc),
                           in_axes=(0, None, 0)))
    boot = jax.jit(lambda o: jengine.bootstrap(j_init_state(jc), o, jc))

    def jax_run(tag, xs, obs):
        st = boot(jax.tree.map(lambda a: a[0], obs))
        st = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), st)
        final, traj, infos = run(st, obs, jax.random.split(
            jax.random.key(1), B))
        gates(tag, np.asarray(traj), np.asarray(final.P), np.asarray(xs),
              np.asarray(infos.n_li), np.asarray(infos.n_hi), cap)

    for s in map(int, args.scenes.split(",")):
        _, xs, obs = j_simulate(jax.random.key(s), jc, FRAMES)
        jax_run(f"jax world=jax_key{s}", xs, obs)
        _, txs, tobs = simulate(torch.Generator().manual_seed(s), cfg,
                                FRAMES, "cpu")
        jax_run(f"jax world=port_seed{s}", txs.numpy(), JFrameObs(
            jnp.asarray(tobs.pixels.numpy()),
            jnp.asarray(tobs.visible.numpy())))
        st0, pxs, pobs, u = slice_inputs(cfg, "cpu", B, FRAMES, s)
        final, traj, infos = engine.run_sequence(st0, pobs, u, cfg)
        gates(f"port world=port_seed{s}", traj.numpy(), final.P.numpy(),
              pxs.numpy(), infos.n_li.numpy(), infos.n_hi.numpy(), cap)


if __name__ == "__main__":
    main()
