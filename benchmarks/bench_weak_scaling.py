"""Weak-scaling REHEARSAL for the distributed Schur solve (config 5).

No multi-host cluster is reachable, so the >=80% weak-scaling contract
cannot be measured on a real network. This script runs the honest
single-machine rehearsal: N real OS processes (one CPU device each,
jax.distributed + collectives) solving a Manhattan graph whose size grows with N, and reports

    efficiency(N) = solve_time(1 process, V poses)
                  / solve_time(N processes, N*V poses)

Fairness: every process in every configuration — including the 1-process
baseline — is pinned to the SAME number of cores (default 1) via taskset,
emulating "each host is an identical machine". Without pinning the baseline
gets all cores and the scaled runs share them, which structurally
understates efficiency (an early 16% rehearsal number was dominated by
exactly that artifact plus the then-replicated linearization, since
removed: the factor SoA is now sharded and each process linearizes only
its slice; see ndtpu/dist/schur.py docstring).

Each record also carries ``psum_s`` — the measured cross-process collective
latency floor for a tiny psum over the same mesh — so the efficiency number
decomposes into compute vs localhost-gRPC overhead (on a real cluster the
collectives run over NVLink and the inter-host network, orders of
magnitude faster than localhost gRPC through the JAX CPU collective
path).

Usage: python benchmarks/bench_weak_scaling.py [base_poses] [max_procs]
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ndtpu.dist.launch import launch_local


def run(base: int = 800, max_p: int = 2, cores_per_proc: int = 1,
        ladders: int = 2):
    """Run the rehearsal; returns {n_processes: record} with efficiencies.

    The whole 1..max_p ladder runs ``ladders`` times and each config keeps
    its FASTEST solve time: host interference on a shared 2-core machine
    only ever ADDS time (same-build medians straddled 0.71-0.93), so
    min-over-ladders on both sides of the ratio converges to the true
    efficiency from below-noise.
    """
    n_cores = os.cpu_count() or 1
    best = {}
    for ladder in range(ladders):
        n = 1
        while n <= max_p:
            rec = launch_local(n, n_poses=base * n,
                               port=29520 + n + 10 * ladder,
                               cores_per_proc=cores_per_proc)
            if n not in best or rec["solve_s"] < best[n]["solve_s"]:
                best[n] = rec
            n *= 2
    recs = {}
    t1 = best[1]["solve_s"]
    for n, rec in sorted(best.items()):
        eff = t1 / rec["solve_s"] if rec["solve_s"] > 0 else float("inf")
        rec.update(
            efficiency_vs_1p=round(eff, 3),
            cores_per_proc=cores_per_proc, ladders=ladders,
            oversubscribed=n * cores_per_proc > n_cores,
            caveat="single-host rehearsal: localhost gRPC collectives, "
                   "equal per-process core pinning, min over ladders",
        )
        recs[n] = rec
        print(json.dumps({"metric": "weak_scaling_rehearsal",
                          "processes": n, "n_poses": base * n, **rec}),
              flush=True)
    return recs


if __name__ == "__main__":
    run(int(sys.argv[1]) if len(sys.argv) > 1 else 800,
        int(sys.argv[2]) if len(sys.argv) > 2 else 2)
