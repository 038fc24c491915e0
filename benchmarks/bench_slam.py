"""Configs 1-3 benchmark: end-to-end SLAM throughput + accuracy on the
synthetic sequences (real logs absent — SURVEY.md §0).

Usage: python benchmarks/bench_slam.py [n_scans]
Prints one JSON line per config.
"""

from __future__ import annotations

import json
import sys

# Runnable as `python benchmarks/<name>.py` from the repo root:
# the script dir (not cwd) lands on sys.path, so add the root.
import os as _os
sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
import time


def run_config(label, cfg, n_scans, windowed=True):
    import jax
    import jax.numpy as jnp

    from ndtpu.data import synth
    from ndtpu.eval.ate import ate_rmse
    from ndtpu.slam import pipeline

    world = synth.box_world(half=11.0)
    traj = synth.rectangle_trajectory(n_scans, half=7.0, step=0.2)
    seq = synth.make_sequence(world, traj, n_beams=cfg.n_beams,
                              max_range=cfg.max_range,
                              min_range=cfg.min_range, seed=1,
                              odom_trans_std=0.04, odom_rot_std=0.01)
    entry = (pipeline.run_slam_windowed if windowed else pipeline.run_slam)
    # jit-wrapped (re-tracing costs ~1.3 s/call) + per-rep input jiggle
    # (byte-identical repeat calls are served from a result cache on this
    # backend — see bench.py docstring).
    run = jax.jit(lambda p, m, o: entry(p, m, o, cfg))
    t0 = time.perf_counter()
    state, outs = run(seq.points, seq.mask, seq.odom)
    jax.block_until_ready(state.pose)
    compile_s = time.perf_counter() - t0
    rng = __import__("numpy").random.default_rng()
    reps, tot = 3, 0.0
    for k in range(reps):
        # fresh random jiggle per rep
        pts_k = seq.points + jnp.asarray(rng.normal(0, 1e-5, (1, 1, 1)),
                                         seq.points.dtype)
        t0 = time.perf_counter()
        state, outs = run(pts_k, seq.mask, seq.odom)
        jax.block_until_ready(state.pose)
        tot += time.perf_counter() - t0
    warm = tot / reps
    traj_est = pipeline.recover_trajectory(state, outs)
    ate = float(ate_rmse(traj_est, seq.gt_poses))
    print(json.dumps({
        "metric": f"slam_{label}", "scans_per_s": round(n_scans / warm, 1),
        "ate_m": round(ate, 4), "loops": int(state.n_loops),
        "keyframes": int(state.kf.n), "compile_s": round(compile_s, 1),
        "mode": "windowed" if windowed else "sequential",
    }))


def main():
    n_scans = int(sys.argv[1]) if len(sys.argv) > 1 else 300

    from ndtpu.config import (GridConfig, KeyframeConfig, LoopConfig,
                              PipelineConfig, SolverConfig)

    base = dict(
        grid=GridConfig(x0=-14.0, y0=-14.0, cell=0.5, nx=56, ny=56,
                        overlap=4),
        keyframe=KeyframeConfig(dist_thresh=0.5, angle_thresh=0.3,
                                capacity=512),
        loop=LoopConfig(radius=3.0, min_index_gap=10, max_candidates=8,
                        local_half_extent=8.0),
        solver=SolverConfig(inc_iters=2, pcg_max_iter=60),
        n_beams=360, max_range=20.0,
    )
    run_config("config1_odometry",
               PipelineConfig(use_loop_closure=False, **base), n_scans)
    run_config("config3_loop_closure",
               PipelineConfig(use_loop_closure=True, **base), n_scans)
    if "--sequential" in sys.argv:
        run_config("config1_odometry_seq",
                   PipelineConfig(use_loop_closure=False, **base), n_scans,
                   windowed=False)
        run_config("config3_loop_closure_seq",
                   PipelineConfig(use_loop_closure=True, **base), n_scans,
                   windowed=False)


if __name__ == "__main__":
    main()
