"""Multi-session serving CLI — the L7 entry point for the single-chip
serving path (SURVEY.md §3.3 DP row; BASELINE north star "scans/s at 1
chip").

Runs S concurrent SLAM sessions through ONE stacked windowed program
(:func:`ndtpu.dist.slam_dp.run_sessions_stacked` under the measured
:func:`ndtpu.dist.slam_dp.serving_config` preset — PERF.md) and
writes one trajectory file per session plus an aggregate-metrics JSON.

Usage::

    # S CARMEN logs, one session each:
    python -m ndtpu.serve --config configs/config3_loop_closure.json \
        --datasets a.clf b.clf c.clf --out-dir out/

    # or synthetic sessions (no datasets on this machine, SURVEY.md §0):
    python -m ndtpu.serve --config configs/config3_loop_closure.json \
        --sessions 8 --max-scans 300 --out-dir out/

Sessions of different lengths are padded to the longest with all-false
masks and identity odometry (the matcher exits in 0 iterations on empty
scans; trajectories are truncated back on output). ``--capacity``
right-sizes the keyframe/graph stores to the session length (the flat
smoother and graph scatters pay for capacity, not occupancy —
PERF.md); ``SlamStepOut.n_dropped`` is surfaced in the metrics so
an undersized deployment is visible, not silent.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np


def _load_sessions(args, cfg):
    """Returns (points [S,T,N,2], mask [S,T,N], odom [S,T,3], lengths,
    gt_list | None)."""
    import jax.numpy as jnp

    from ndtpu.data import carmen, synth

    if args.datasets:
        seqs = []
        for path in args.datasets:
            log = carmen.read_carmen(path)
            pts, mask, odom = carmen.to_sequence(
                log, max_range=cfg.max_range, min_range=cfg.min_range)
            t = pts.shape[0] if args.max_scans is None else min(
                pts.shape[0], args.max_scans)
            seqs.append((pts[:t], mask[:t], odom[:t]))
        gts = None
    else:
        n = args.max_scans or 300
        world = synth.box_world(half=11.0)
        seqs, gts = [], []
        for k in range(args.sessions):
            traj = synth.rectangle_trajectory(
                n, half=6.0 + 0.2 * (k % 10), step=0.2)
            sq = synth.make_sequence(
                world, traj, n_beams=cfg.n_beams, max_range=cfg.max_range,
                min_range=cfg.min_range, seed=cfg.seed + 20 + k,
                odom_trans_std=0.04, odom_rot_std=0.01)
            seqs.append((np.asarray(sq.points), np.asarray(sq.mask),
                         np.asarray(sq.odom)))
            gts.append(np.asarray(sq.gt_poses))
    lengths = [p.shape[0] for p, _, _ in seqs]
    t_max = max(lengths)
    n_beams = max(p.shape[1] for p, _, _ in seqs)

    def pad(p, m, o):
        t, nb = p.shape[0], p.shape[1]
        pp = np.zeros((t_max, n_beams, 2), np.float32)
        mm = np.zeros((t_max, n_beams), bool)
        oo = np.zeros((t_max, 3), np.float32)
        pp[:t, :nb] = p
        mm[:t, :nb] = m
        oo[:t] = o
        return pp, mm, oo

    padded = [pad(*s) for s in seqs]
    return (jnp.asarray(np.stack([p for p, _, _ in padded])),
            jnp.asarray(np.stack([m for _, m, _ in padded])),
            jnp.asarray(np.stack([o for _, _, o in padded])),
            lengths, gts)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Stacked multi-session SLAM serving on one chip")
    parser.add_argument("--config", required=True)
    parser.add_argument("--datasets", nargs="*", default=None,
                        help="CARMEN logs, one session each")
    parser.add_argument("--sessions", type=int, default=8,
                        help="synthetic session count when no --datasets")
    parser.add_argument("--max-scans", type=int, default=None)
    parser.add_argument("--out-dir", default=None)
    parser.add_argument("--capacity", type=int, default=0,
                        help="keyframe/graph capacity override (0 = auto: "
                             "~1.5x the expected keyframes for the session "
                             "length)")
    args = parser.parse_args(argv)

    import jax

    from ndtpu.config import PipelineConfig
    from ndtpu.dist import slam_dp
    from ndtpu.eval.ate import ate_rmse
    from ndtpu.utils.runtime import enable_compile_cache

    enable_compile_cache()

    cfg = PipelineConfig.from_json(args.config)
    points, mask, odom, lengths, gts = _load_sessions(args, cfg)
    s, t_max = points.shape[0], points.shape[1]

    cap = args.capacity
    if cap <= 0:
        # Expected keyframes ~= path_length / dist_thresh; the synthetic
        # serving workloads land near T/2.7 keyframes. 1.5x headroom,
        # rounded up to 32, never above the configured capacity.
        cap = min(cfg.keyframe.capacity,
                  max(32, int(1.5 * t_max / 2.7 + 16) // 32 * 32))
    scfg = slam_dp.serving_config(cfg)
    scfg = dataclasses.replace(
        scfg, keyframe=dataclasses.replace(scfg.keyframe, capacity=cap))

    run = jax.jit(lambda p, m, o: slam_dp.run_sessions_stacked(
        p, m, o, scfg))
    t0 = time.perf_counter()
    state, outs = run(points, mask, odom)
    np.asarray(outs.pose)                     # host read = real fence
    compile_s = time.perf_counter() - t0
    # Warm timing: median of 3 reps, each ended by a host read.
    reps = []
    for _ in range(3):
        t0 = time.perf_counter()
        state, outs = run(points, mask, odom)
        np.asarray(outs.pose)                 # host read = real fence
        reps.append(time.perf_counter() - t0)
    warm_s = float(np.median(reps))
    # Trajectory recovery on host (numpy): re-anchor each scan on its
    # keyframe's smoothed pose. The jitted/vmapped form would add a
    # compile for a once-per-invocation O(S*T) gather+compose.
    g_poses = np.asarray(state.graph.poses)           # [S, V, 3]
    kf_idx = np.asarray(outs.kf_idx)                  # [S, T-1]
    rel = np.asarray(outs.rel)                        # [S, T-1, 3]
    anchors = np.take_along_axis(g_poses, kf_idx[..., None], axis=1)
    c, sn = np.cos(anchors[..., 2]), np.sin(anchors[..., 2])
    traj = np.stack([
        anchors[..., 0] + c * rel[..., 0] - sn * rel[..., 1],
        anchors[..., 1] + sn * rel[..., 0] + c * rel[..., 1],
        np.arctan2(np.sin(anchors[..., 2] + rel[..., 2]),
                   np.cos(anchors[..., 2] + rel[..., 2])),
    ], axis=-1)                                       # [S, T-1, 3]
    traj_all = np.concatenate([g_poses[:, :1], traj], axis=1)

    total_scans = sum(lengths)
    agg = total_scans / warm_s
    summary = {
        "sessions": s,
        "scans_total": total_scans,
        "aggregate_scans_per_s": round(agg, 1),
        "compile_s": round(compile_s, 2),
        "warm_s": warm_s,
        "capacity": cap,
        "per_session": [],
    }
    for k in range(s):
        t_k = lengths[k]
        rec = {
            "session": k,
            "scans": t_k,
            "keyframes": int(np.asarray(state.kf.n[k])),
            "loops": int(np.asarray(state.n_loops[k])),
            "dropped": int(np.asarray(outs.n_dropped[k]).sum()),
            "innov_rejected": int(np.asarray(outs.n_innov_rej[k]).sum()),
        }
        if gts is not None:
            rec["ate_m"] = round(float(ate_rmse(
                traj_all[k][:t_k], gts[k][:t_k])), 4)
        summary["per_session"].append(rec)
        if args.out_dir:
            os.makedirs(args.out_dir, exist_ok=True)
            np.savetxt(os.path.join(args.out_dir, f"traj_{k}.txt"),
                       traj_all[k][:t_k], fmt="%.6f")
    if args.out_dir:
        with open(os.path.join(args.out_dir, "serve_metrics.json"),
                  "w") as f:
            json.dump(summary, f, indent=2)
    dropped = sum(r["dropped"] for r in summary["per_session"])
    if dropped:
        print(f"[serve] WARNING: {dropped} keyframes/factors dropped at "
              f"capacity {cap} — raise --capacity", file=sys.stderr)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
