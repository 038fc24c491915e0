"""Config-4 benchmark: pose-graph solve ms/iter on a 10k+ Manhattan world.

Measures one damped-GN step (linearize + solve) for each solver path:
dense block Cholesky (small graphs only), block-Jacobi PCG, supernodal
partitioned Cholesky — the "BA solve ms/iter" metric of BASELINE.md.

Usage: python benchmarks/bench_solver.py [n_poses] [n_shards]
Prints one JSON line per solver to stdout.
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
    n_poses = int(sys.argv[1]) if len(sys.argv) > 1 else 10000
    n_shards = int(sys.argv[2]) if len(sys.argv) > 2 else 64

    import jax
    import jax.numpy as jnp

    from ndtpu.config import SolverConfig
    from ndtpu.data import g2o
    from ndtpu.graph import factors as fct
    from ndtpu.graph import solve as slv
    from ndtpu.graph import supernodal as sn

    print(f"# generating manhattan world: {n_poses} poses", file=sys.stderr)
    data = g2o.manhattan_world(n_poses, seed=0, loop_prob=0.1)
    g = g2o.to_graph(data, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    g = g._replace(poses=g.poses + jnp.asarray(
        rng.normal(0, 0.05, g.poses.shape), jnp.float32))
    n_edges = int(g.bet_mask.sum())
    print(f"# edges: {n_edges}", file=sys.stderr)
    cfg = SolverConfig()

    def timed(step, label, reps=10):
        # One LM iteration = relinearize + solve, as ONE compiled program
        # (what a real optimizer loop dispatches per iteration).
        full = jax.jit(lambda g_, lam: step(g_, fct.linearize(g_), lam))
        lam = jnp.asarray(1e-3, jnp.float32)
        out = full(g, lam)
        jax.block_until_ready(out)
        rng_t = np.random.default_rng()
        t0 = time.perf_counter()
        for k in range(reps):
            # fresh random pose jiggle per rep
            gk = g._replace(poses=g.poses + jnp.asarray(
                rng_t.normal(0, 1e-6, (1, 1)), jnp.float32))
            out = full(gk, lam)
        jax.block_until_ready(out)
        ms = (time.perf_counter() - t0) / reps * 1e3
        print(json.dumps({"metric": f"solve_ms_per_iter_{label}",
                          "value": round(ms, 2), "unit": "ms",
                          "n_poses": n_poses, "n_edges": n_edges}))
        return ms

    # PCG (matrix-free).
    timed(lambda g_, lin, lam: slv.pcg(g_, lin, lam, cfg)[0], "pcg")

    # Supernodal partitioned Cholesky.
    plan = sn.plan_supernodal(g, n_shards)
    print(f"# supernodal: ni={plan.schur.ni}, ns={plan.schur.ns}, "
          f"fmax={plan.schur.fmax}", file=sys.stderr)
    timed(lambda g_, lin, lam: sn.supernodal_delta(g_, lin, plan, lam),
          "supernodal")

    # Dense only when it fits comfortably.
    if n_poses <= 3000:
        timed(lambda g_, lin, lam: slv.solve_dense(g_, lin, lam), "dense")

    # Relinearization throughput alone (config 4 names it explicitly).
    lin_fn = jax.jit(lambda g_: fct.linearize(g_))
    jax.block_until_ready(lin_fn(g))
    rng_t = np.random.default_rng()
    t0 = time.perf_counter()
    for k in range(10):
        out = lin_fn(g._replace(poses=g.poses + jnp.asarray(
            rng_t.normal(0, 1e-6, (1, 1)), jnp.float32)))
    jax.block_until_ready(out)
    ms = (time.perf_counter() - t0) / 10 * 1e3
    print(json.dumps({"metric": "relinearize_ms", "value": round(ms, 3),
                      "unit": "ms", "n_factors": n_edges,
                      "factors_per_s": round(n_edges / ms * 1e3)}))


if __name__ == "__main__":
    main()
