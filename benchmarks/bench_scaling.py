"""Config-5 proxy benchmark: weak scaling of the distributed Schur solve on
a virtual device mesh (real multi-host runs use the same code over
``multihost_mesh()`` after ``jax.distributed.initialize()``).

Weak scaling: problem size grows with device count (poses_per_shard fixed);
efficiency = t(1 shard) / t(D shards). It runs on whatever devices JAX
sees: the GPUs of one host, or virtual CPU devices, whose absolute numbers
are meaningless but whose collective/partition structure is identical and
whose efficiency trend exposes separator growth.

Usage:
  python benchmarks/bench_scaling.py [poses_per_shard]            # GPUs
  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
      python benchmarks/bench_scaling.py [poses_per_shard]        # CPU
"""

from __future__ import annotations

import json
import sys

# Runnable as `python benchmarks/<name>.py` from the repo root:
# the script dir (not cwd) lands on sys.path, so add the root.
import os as _os
sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
import time

import numpy as np


def main():
    per_shard = int(sys.argv[1]) if len(sys.argv) > 1 else 500

    import jax
    import jax.numpy as jnp

    from ndtpu import dist
    from ndtpu.data import g2o
    from ndtpu.graph import factors as fct

    n_dev = len(jax.devices())
    results = {}
    for d in [x for x in (1, 2, 4, 8) if x <= n_dev]:
        n_poses = per_shard * d
        data = g2o.manhattan_world(n_poses, seed=0, loop_prob=0.05)
        g = g2o.to_graph(data, dtype=jnp.float32)
        rng = np.random.default_rng(0)
        g = g._replace(poses=g.poses + jnp.asarray(
            rng.normal(0, 0.05, g.poses.shape), jnp.float32))
        plan = dist.plan_partition(
            np.asarray(g.bet_i), np.asarray(g.bet_j), np.asarray(g.bet_mask),
            np.asarray(g.prior_idx), np.asarray(g.prior_mask),
            n_poses, n_shards=d)
        mesh = dist.space_mesh(d)
        lam = jnp.asarray(1e-3, jnp.float32)

        sd = dist.shard_factor_data(g, plan)

        def step(g_):
            # Shard-local linearization happens inside schur_delta.
            return dist.schur_delta(mesh, g_, plan, lam, sd=sd)

        jax.block_until_ready(step(g))
        t0 = time.perf_counter()
        rng_t = np.random.default_rng()
        for k in range(3):
            # fresh random jiggle per rep
            out = step(g._replace(poses=g.poses + jnp.asarray(
                rng_t.normal(0, 1e-6, (1, 1)), jnp.float32)))
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / 3
        results[d] = dt
        eff = results[1] / dt if 1 in results else 1.0
        print(json.dumps({
            "metric": "schur_weak_scaling", "devices": d,
            "n_poses": n_poses, "separator": int(plan.ns),
            "ms_per_step": round(dt * 1e3, 1),
            "efficiency": round(eff, 3)}))


if __name__ == "__main__":
    main()
