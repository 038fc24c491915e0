"""Multi-lap robustness guard (PERF.md, VERDICT r3 item 8).

A reduced-size version of the bench's 1000-scan 3.5-lap run: revisiting
mapped territory for multiple laps exposed (a) loop-factor spam without the
accept budget, (b) least-squares loop steering without Huber, and (c) the
bistable map-maintenance dynamics (only rebuild-on-loop-windows stays on
the good attractor). This test keeps those defaults from regressing: it
runs ~2.7 laps and must land well under the no-loop drift level.

Runtime ~60 s on CPU (the heaviest single test in the suite — the guarded
failure modes only appear on revisits, so laps are irreducible).
"""

import jax
import numpy as np

from ndtpu.config import (GridConfig, KeyframeConfig, LoopConfig,
                          PipelineConfig, SolverConfig)
from ndtpu.data import synth
from ndtpu.eval.ate import ate_rmse
from ndtpu.slam import pipeline


def test_multilap_loop_budget_and_huber_hold():
    world = synth.box_world(half=8.0)
    # 480 scans x 0.2 m over a 14 m-perimeter rectangle = ~6.8 laps.
    traj = synth.rectangle_trajectory(480, half=1.75, step=0.2)
    seq = synth.make_sequence(world, traj, n_beams=180, max_range=20.0,
                              min_range=0.1, seed=7, odom_trans_std=0.04,
                              odom_rot_std=0.01)
    cfg = PipelineConfig(
        grid=GridConfig(x0=-10.0, y0=-10.0, cell=0.5, nx=40, ny=40,
                        overlap=4),
        keyframe=KeyframeConfig(dist_thresh=0.5, angle_thresh=0.3,
                                capacity=256),
        loop=LoopConfig(radius=3.0, min_index_gap=10, max_candidates=8,
                        local_half_extent=8.0),
        solver=SolverConfig(inc_iters=2, pcg_max_iter=60),
        n_beams=180, use_loop_closure=True, window=8, window_passes=2)
    run = jax.jit(lambda p, m, o: pipeline.run_slam_windowed(p, m, o, cfg))
    st, outs = run(seq.points, seq.mask, seq.odom)
    traj_est = pipeline.recover_trajectory(st, outs)
    np.asarray(traj_est)  # force completion (PERF.md trap 5)
    ate = float(ate_rmse(traj_est, seq.gt_poses))
    n_loops = int(st.n_loops)
    # Loop budget: unbudgeted acceptance measured ~1000 factors by scan
    # 600 at bench scale; with max_accept_per_query it stays O(laps*kfs).
    assert 0 < n_loops < 400, n_loops
    # Robust smoothing + rebuild-on-loop policy: diverged attractors land
    # at meters of ATE; the good attractor is centimeters.
    assert ate < 0.15, (ate, n_loops)
