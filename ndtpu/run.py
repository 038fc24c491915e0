"""CLI dataset runner — the L7 layer (SURVEY.md §2).

Usage::

    python -m ndtpu.run --config configs/config2_intel_full.json \
        [--dataset intel.clf] [--out-traj traj.txt] [--out-metrics m.jsonl] \
        [--checkpoint-dir ckpts] [--resume]

With ``--dataset`` a CARMEN log is processed; without it the config's
synthetic sequence is simulated (the datasets are not distributable with
this machine — SURVEY.md §0). Writes the estimated trajectory in TUM-style
``x y theta`` rows, per-scan JSONL metrics, and an ASCII map sketch to
stderr.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _build_inputs(args, cfg):
    import jax.numpy as jnp

    from ndtpu.data import carmen, synth

    if args.dataset:
        log = carmen.read_carmen(args.dataset)
        pts, mask, odom = carmen.to_sequence(
            log, max_range=cfg.max_range, min_range=cfg.min_range)
        t = pts.shape[0] if args.max_scans is None else min(
            pts.shape[0], args.max_scans)
        return (jnp.asarray(pts[:t]), jnp.asarray(mask[:t]),
                jnp.asarray(odom[:t]), None)
    # Synthetic fallback with ground truth.
    n = args.max_scans or 300
    world = synth.corridor_loop_world(outer=18.0, width=5.0)
    traj = synth.rectangle_trajectory(n, half=15.0, step=0.25)
    seq = synth.make_sequence(world, traj, n_beams=cfg.n_beams,
                              max_range=cfg.max_range,
                              min_range=cfg.min_range, seed=cfg.seed,
                              odom_trans_std=0.03, odom_rot_std=0.008)
    return seq.points, seq.mask, seq.odom, seq.gt_poses


def main(argv=None):
    """Run the CLI; returns ``{"scans", "keyframes", "loops", "dropped",
    "ate_m", "trajectory"}`` (``ate_m`` is None without ground truth)."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", required=True)
    parser.add_argument("--dataset", default=None,
                        help="CARMEN .clf/.log file (synthetic if omitted)")
    parser.add_argument("--max-scans", type=int, default=None)
    parser.add_argument("--out-traj", default=None)
    parser.add_argument("--out-metrics", default=None)
    parser.add_argument("--checkpoint-dir", default=None)
    parser.add_argument("--checkpoint-every", type=int, default=100,
                        help="checkpoint cadence in SCANS (rounded up to "
                             "whole windows in windowed mode). Each save "
                             "transfers the full SLAM state (~tens of MB) "
                             "to the host")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--mode", choices=("windowed", "scan"),
                        default="windowed",
                        help="windowed: W scans per device dispatch "
                             "(window-granular checkpoints); "
                             "scan: per-scan host loop")
    args = parser.parse_args(argv)

    import jax

    from ndtpu.utils.runtime import enable_compile_cache

    enable_compile_cache()

    from ndtpu.config import PipelineConfig
    from ndtpu.eval.ate import ate_rmse, rpe
    from ndtpu.slam import pipeline
    from ndtpu.utils import checkpoint as ckpt
    from ndtpu.utils import metrics

    cfg = PipelineConfig.from_json(args.config)
    points, mask, odom, gt = _build_inputs(args, cfg)
    if cfg.downsample_voxel > 0.0:
        from ndtpu.data.preprocess import voxel_downsample
        mask = jax.jit(voxel_downsample, static_argnums=2)(
            points, mask, cfg.downsample_voxel)
        print(f"[run] voxel downsample {cfg.downsample_voxel} m: "
              f"{int(np.asarray(mask).sum())} points kept", file=sys.stderr)
    t_total = points.shape[0]
    print(f"[run] {t_total} scans x {points.shape[1]} beams; "
          f"loop_closure={cfg.use_loop_closure}", file=sys.stderr)

    # Exactly ONE cadence gate per mode (ADVICE r3: double-gating made
    # windowed checkpoints silently inert): windowed mode gates on window
    # index in the loop (manager every=1, steps are windows), scan mode
    # gates in the manager (steps are scans). Prefixes namespace the two
    # modes' structurally-different states in a shared directory.
    if args.checkpoint_dir:
        if args.mode == "windowed":
            mgr = ckpt.CheckpointManager(args.checkpoint_dir, every=1,
                                         prefix="ckpt_win_")
        else:
            mgr = ckpt.CheckpointManager(args.checkpoint_dir,
                                         every=args.checkpoint_every,
                                         prefix="ckpt_scan_")
    else:
        mgr = None

    state = pipeline.init_slam(cfg, points[0], mask[0])
    records = []
    outs = []

    if args.mode == "windowed":
        import jax.numpy as jnp

        from ndtpu.slam.odometry import _pad_to_windows

        w = cfg.window
        pts_w, msk_w, odo_w, n_win, _ = _pad_to_windows(
            points[1:], mask[1:], odom[1:], w)
        pts_w = pts_w.reshape(n_win, w, *pts_w.shape[1:])
        msk_w = msk_w.reshape(n_win, w, *msk_w.shape[1:])
        odo_w = odo_w.reshape(n_win, w, 3)

        carry = (state, state.pose)
        start_win = 0
        if args.resume and mgr is not None:
            step, restored = mgr.restore_latest(carry)
            if restored is not None:
                carry, start_win = restored, step + 1
                print(f"[run] resumed at window {start_win} "
                      f"(scan {1 + start_win * w})", file=sys.stderr)

        every_win = max(1, -(-args.checkpoint_every // w))
        t0 = time.perf_counter()
        # The loop never blocks on device results (no float()/np.asarray on
        # outputs inside it), so JAX's async dispatch pipelines host-side
        # input prep + dispatch of window k+1 with device compute of window
        # k — the host/device-overlap analogue of pipeline parallelism
        # (SURVEY.md §3.3 "PP"). Metrics are extracted after the loop.
        dispatch_ts = []
        for wi in range(start_win, n_win):
            td = time.perf_counter()
            carry, out = pipeline.slam_window_step_jit(
                carry[0], carry[1], pts_w[wi], msk_w[wi], odo_w[wi], cfg)
            dispatch_ts.append(time.perf_counter() - td)
            outs.append(out)
            if mgr is not None and (wi + 1) % every_win == 0:
                mgr.maybe_save(wi, carry)  # every=1: this gate is the only
                #                            cadence; blocks to transfer
        state = carry[0]
        jax.block_until_ready(state.pose)
        dt = time.perf_counter() - t0
        for k, (wi, out) in enumerate(zip(range(start_win, n_win), outs)):
            records.append({
                "window": wi, "scan": 1 + wi * w,
                "dispatch_s": round(dispatch_ts[k], 6),
                "score": float(out.score.mean()),
                "kf": int(np.asarray(out.is_keyframe).sum()),
                "loops": int(np.asarray(out.n_loops_new).sum()),
            })
        done = (n_win - start_win) * w
        stacked = jax.tree_util.tree_map(
            lambda *x: jax.numpy.concatenate(x, axis=0), *outs)
        stacked = jax.tree_util.tree_map(
            lambda a: a[: t_total - 1 - start_win * w], stacked)
    else:
        start = 1
        if args.resume and mgr is not None:
            step, restored = mgr.restore_latest(state)
            if restored is not None:
                state, start = restored, step + 1
                print(f"[run] resumed at scan {start}", file=sys.stderr)
        t0 = time.perf_counter()
        for t in range(start, t_total):
            rec = {"scan": t}
            with metrics.timer(rec, "step_s"):
                state, out = pipeline.slam_step_jit(state, points[t], mask[t],
                                                    odom[t], cfg)
            outs.append(out)
            rec.update(score=float(out.score), is_kf=bool(out.is_keyframe),
                       loops=int(out.n_loops_new))
            records.append(rec)
            if mgr is not None:
                mgr.maybe_save(t, state)
        jax.block_until_ready(state.pose)
        dt = time.perf_counter() - t0
        done = t_total - start
        stacked = jax.tree_util.tree_map(
            lambda *x: jax.numpy.stack(x), *outs)
    print(f"[run] {done / dt:.1f} scans/s "
          f"({dt:.1f}s total), keyframes={int(state.kf.n)}, "
          f"loops={int(state.n_loops)}", file=sys.stderr)

    n_drop = int(np.asarray(stacked.n_dropped).sum())
    if n_drop:
        print(f"[run] WARNING: {n_drop} keyframe/factor append(s) dropped at "
              f"capacity — the run is degrading toward open-loop odometry; "
              f"raise keyframe.capacity (graph capacities scale with it)",
              file=sys.stderr)

    traj = np.asarray(pipeline.recover_trajectory(state, stacked))
    summary = {"scans": t_total, "keyframes": int(state.kf.n),
               "loops": int(state.n_loops), "dropped": n_drop,
               "ate_m": None, "trajectory": traj}

    if gt is not None:
        gt_np = np.asarray(gt)[t_total - traj.shape[0]:]
        ate = float(ate_rmse(jax.numpy.asarray(traj),
                             jax.numpy.asarray(gt_np)))
        t_rmse, r_rmse = rpe(jax.numpy.asarray(traj),
                             jax.numpy.asarray(gt_np))
        print(f"[run] ATE {ate:.4f} m; RPE {float(t_rmse):.4f} m / "
              f"{float(r_rmse):.4f} rad", file=sys.stderr)
        summary["ate_m"] = ate

    if args.out_traj:
        np.savetxt(args.out_traj, traj, fmt="%.6f")
        print(f"[run] trajectory -> {args.out_traj}", file=sys.stderr)
    if args.out_metrics:
        with metrics.JsonlLogger(args.out_metrics) as lg:
            for r in records:
                lg.write(r)
            lg.write({"summary": metrics.summarize_run(records)})
        print(f"[run] metrics -> {args.out_metrics}", file=sys.stderr)

    from ndtpu.ndt import grid as ndt_grid

    m = ndt_grid.finalize(state.stats, cfg.ndt)
    v = np.asarray(m.valid[0]).reshape(cfg.grid.ny, cfg.grid.nx)
    print(metrics.map_to_ascii(v), file=sys.stderr)
    return summary


if __name__ == "__main__":
    main()
