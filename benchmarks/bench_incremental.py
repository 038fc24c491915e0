"""Incremental-update cost vs graph size (VERDICT r2 item 5).

Measures one ``incremental_update`` dispatch (the per-keyframe/per-window
backend cost, iSAM2-update role) against Manhattan graphs of growing size,
for both the active path (do_update: relinearize + inc_iters x LM-PCG) and
the settled fast path (O(K) fresh-residual test only).

Honest scaling statement: the active path is O(F) per update with a small
constant (batched relinearize + capped-iteration PCG) — linear in graph
size, NOT clique-local like GTSAM's Bayes-tree update; the settled path is
O(K). This prints the curve that quantifies both constants.

Usage: python benchmarks/bench_incremental.py [sizes...]
Prints one JSON line per size.
"""

from __future__ import annotations

import json
import sys

import os as _os
sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
import time

import numpy as np


def main():
    sizes = [int(a) for a in sys.argv[1:]] or [1000, 2000, 5000, 10000]

    import jax
    import jax.numpy as jnp

    from ndtpu.config import SolverConfig
    from ndtpu.data import g2o
    from ndtpu.graph import factors as fct
    from ndtpu.graph import incremental as inc

    cfg = SolverConfig(inc_iters=2, pcg_max_iter=25, full_solve_every=0)

    for n in sizes:
        data = g2o.manhattan_world(n, seed=0, loop_prob=0.1)
        g = g2o.to_graph(data, dtype=jnp.float32)
        rng = np.random.default_rng(0)
        g = g._replace(poses=g.poses + jnp.asarray(
            rng.normal(0, 0.03, g.poses.shape), jnp.float32))

        upd = jax.jit(lambda s: inc.incremental_update(s, cfg))

        def timed(state, reps=10):
            out = upd(state)
            jax.block_until_ready(out.graph.poses)
            rng_t = np.random.default_rng()
            t0 = time.perf_counter()
            for k in range(reps):
                # fresh random jiggle per rep
                st_k = state._replace(graph=state.graph._replace(
                    poses=state.graph.poses + jnp.asarray(
                        rng_t.normal(0, 1e-6, (1, 1)), jnp.float32)))
                out = upd(st_k)
            jax.block_until_ready(out.graph.poses)
            return (time.perf_counter() - t0) / reps * 1e3

        # Active path: perturbed graph, last step large -> full update.
        st_active = inc.SmootherState(
            graph=g, lam=jnp.asarray(1e-4, jnp.float32),
            last_max_delta=jnp.asarray(jnp.inf, jnp.float32),
            step=jnp.asarray(0, jnp.int32))
        ms_active = timed(st_active)

        # Settled path: solved graph, last step tiny -> O(K) skip.
        solved = upd(upd(st_active))
        st_settled = solved._replace(
            last_max_delta=jnp.asarray(0.0, jnp.float32))
        ms_settled = timed(st_settled)

        n_edges = int(jnp.sum(g.bet_mask))
        print(json.dumps({
            "metric": "incremental_update_ms", "n_poses": n,
            "n_edges": n_edges, "active_ms": round(ms_active, 2),
            "settled_ms": round(ms_settled, 3),
            "active_us_per_edge": round(ms_active * 1e3 / n_edges, 2),
        }), flush=True)


if __name__ == "__main__":
    main()
