"""Standalone pose-graph optimizer CLI (the ``Pose2SLAMExample_g2o``
workflow GTSAM users know — SURVEY.md §3.2 "SLAM factor library",
BASELINE config 4).

Usage::

    python -m ndtpu.solve_g2o input.g2o [-o optimized.g2o]
        [--method dense|pcg|supernodal] [--shards 64] [--huber 0]
        [--max-iter 50] [--toro] [--manhattan N]

Reads a g2o (or TORO) 2D pose-graph file — or generates a Manhattan world
with ``--manhattan N`` — optimizes it with the chosen solver, prints chi²
before/after + timing to stderr, and optionally writes the optimized graph
back in g2o format.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def main(argv=None):
    """Run the CLI; returns the :class:`ndtpu.graph.solve.SolveResult`."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input", nargs="?", default=None,
                    help="g2o/TORO file (omit with --manhattan)")
    ap.add_argument("-o", "--output", default=None,
                    help="write the optimized graph as g2o")
    ap.add_argument("--method", default="auto",
                    choices=("auto", "dense", "pcg", "supernodal"),
                    help="auto: dense <=2k poses, supernodal <=20k, "
                         "else pcg")
    ap.add_argument("--shards", type=int, default=64,
                    help="supernodal partition count")
    ap.add_argument("--huber", type=float, default=0.0,
                    help="Huber threshold in whitened units (0 = LS)")
    ap.add_argument("--max-iter", type=int, default=50)
    ap.add_argument("--toro", action="store_true",
                    help="input is TORO format")
    ap.add_argument("--manhattan", type=int, default=0,
                    help="generate an N-pose Manhattan world instead of "
                         "reading a file")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax.numpy as jnp

    from ndtpu.utils.runtime import enable_compile_cache

    enable_compile_cache()

    from ndtpu.config import SolverConfig
    from ndtpu.data import g2o
    from ndtpu.graph import factors as fct
    from ndtpu.graph import solve as slv
    from ndtpu.graph import supernodal as sn

    if args.manhattan:
        data = g2o.manhattan_world(args.manhattan, seed=args.seed,
                                   loop_prob=0.1)
        rng = np.random.default_rng(args.seed)
        data = data._replace(
            poses=data.poses + rng.normal(0, 0.05, data.poses.shape))
        src = f"manhattan({args.manhattan})"
    elif args.input:
        data = (g2o.read_toro(args.input) if args.toro
                else g2o.read_g2o(args.input))
        src = args.input
    else:
        ap.error("give an input file or --manhattan N")

    g = g2o.to_graph(data, dtype=jnp.float32)
    v = int(g.n_poses)
    f = int(g.n_between)
    method = args.method
    if method == "auto":
        method = "dense" if v <= 2000 else (
            "supernodal" if v <= 20000 else "pcg")
    print(f"[solve_g2o] {src}: {v} poses, {f} between factors; "
          f"method={method}", file=sys.stderr)

    cfg = SolverConfig(max_iter=args.max_iter,
                       pcg_max_iter=max(250, args.max_iter * 10))
    chi0 = float(fct.chi2(g, args.huber))
    t0 = time.perf_counter()
    if method == "supernodal":
        res = sn.optimize_supernodal(g, cfg, n_shards=args.shards,
                                     huber_delta=args.huber)
    else:
        res = slv.optimize(g, cfg, method=method, huber_delta=args.huber)
    chi1 = float(res.chi2)
    np.asarray(res.graph.poses)          # host read: real fence
    dt = time.perf_counter() - t0
    print(f"[solve_g2o] chi2 {chi0:.4g} -> {chi1:.4g} in "
          f"{int(res.n_iter)} iters, {dt:.2f}s "
          f"(converged={bool(res.converged)})", file=sys.stderr)

    if args.output:
        out = data._replace(
            poses=np.asarray(res.graph.poses[:v], np.float64))
        g2o.write_g2o(args.output, out)
        print(f"[solve_g2o] optimized graph -> {args.output}",
              file=sys.stderr)
    return res


if __name__ == "__main__":
    main()
