"""Host/device overlap measurement (the PP analogue, SURVEY.md §3.3).

The windowed host-driven loop (ndtpu/run.py) never blocks on device
results mid-stream, so JAX's async dispatch overlaps host-side input prep
+ dispatch of window k+1 with device compute of window k. This script
MEASURES that overlap (VERDICT r3 coverage table called the row
"unmeasured"): the same window loop is driven (a) async — fence only at
the end — and (b) with a forced host read after every window. The
difference is the host work hidden under device compute; identical results
are asserted.

Usage: python benchmarks/bench_overlap.py [n_scans]
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    n_scans = int(sys.argv[1]) if len(sys.argv) > 1 else 400

    import jax
    import jax.numpy as jnp

    from ndtpu.utils.runtime import enable_compile_cache

    enable_compile_cache()

    from ndtpu.config import (GridConfig, KeyframeConfig, LoopConfig,
                              PipelineConfig)
    from ndtpu.data import synth
    from ndtpu.slam import pipeline
    from ndtpu.slam.odometry import _pad_to_windows

    cfg = PipelineConfig(
        grid=GridConfig(x0=-14.0, y0=-14.0, cell=0.5, nx=56, ny=56,
                        overlap=4),
        keyframe=KeyframeConfig(dist_thresh=0.5, angle_thresh=0.3,
                                capacity=256),
        loop=LoopConfig(radius=3.0, min_index_gap=10, max_candidates=8,
                        local_half_extent=8.0),
        n_beams=360, use_loop_closure=True, window=8, window_passes=2)
    world = synth.box_world(half=11.0)
    traj = synth.rectangle_trajectory(n_scans, half=7.0, step=0.2)
    seq = synth.make_sequence(world, traj, n_beams=360, max_range=20.0,
                              min_range=0.1, seed=3, odom_trans_std=0.04,
                              odom_rot_std=0.01)
    w = cfg.window
    pts_w, msk_w, odo_w, n_win, _ = _pad_to_windows(
        seq.points[1:], seq.mask[1:], seq.odom[1:], w)
    pts_w = pts_w.reshape(n_win, w, *pts_w.shape[1:])
    msk_w = msk_w.reshape(n_win, w, *msk_w.shape[1:])
    odo_w = odo_w.reshape(n_win, w, 3)
    step = pipeline.slam_window_step_jit

    def drive(jiggle, sync_every_window: bool):
        state = pipeline.init_slam(cfg, seq.points[0] + jiggle, seq.mask[0])
        carry = (state, state.pose)
        t0 = time.perf_counter()
        for wi in range(n_win):
            carry, out = step(carry[0], carry[1], pts_w[wi] + jiggle,
                              msk_w[wi], odo_w[wi], cfg)
            if sync_every_window:
                np.asarray(out.pose)          # host read: hard fence
        final = np.asarray(carry[0].pose)     # fence the stream's end
        return time.perf_counter() - t0, final, int(carry[0].n_loops)

    rng = np.random.default_rng()
    drive(jnp.asarray(0.0, jnp.float32), False)     # warm compile
    ts_a, ts_s = [], []
    for k in range(3):
        jig = jnp.asarray(rng.normal(0, 1e-6), jnp.float32)
        dt_a, fin_a, l_a = drive(jig, False)
        dt_s, fin_s, l_s = drive(jig, True)         # SAME inputs, synced
        assert l_a == l_s, (l_a, l_s)
        np.testing.assert_allclose(fin_a, fin_s, atol=1e-5)
        ts_a.append(dt_a)
        ts_s.append(dt_s)
    t_async = float(np.median(ts_a))
    t_sync = float(np.median(ts_s))
    print(json.dumps({
        "metric": "host_device_overlap",
        "n_windows": n_win,
        "async_s": round(t_async, 3),
        "sync_s": round(t_sync, 3),
        "hidden_host_ms_per_window": round(
            (t_sync - t_async) / n_win * 1e3, 2),
        "overlap_fraction_of_sync": round(1.0 - t_async / t_sync, 3),
        "note": "async defers every device->host fence to stream end; the "
                "gap is host prep + fence latency hidden under device "
                "compute (PP analogue, SURVEY.md 3.3)",
    }))


if __name__ == "__main__":
    main()
