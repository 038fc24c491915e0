"""Sweep the stacked-serving levers (VERDICT r5 task 1: >=8k aggregate).

Reproduces bench.py section 6b (8 sessions x 300 scans through
run_sessions_stacked) and sweeps the sequential-depth / amortization
levers identified by the PERF.md budget:

- window W (amortizes per-window fixed costs: packs, smoother, refresh)
- pass2_max_iter (warm-started second pass needs fewer LM iterations)
- match.max_iter (pass-1 cap)
- pcg_max_iter / verify_max_iter (already in the serving preset)

Prints one line per variant: aggregate scans/s + per-session ATE mean/max.
"""
from __future__ import annotations

import dataclasses
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, ".")

from ndtpu.config import (GridConfig, KeyframeConfig, LoopConfig,
                          PipelineConfig, SolverConfig)
from ndtpu.data import synth
from ndtpu.dist import slam_dp
from ndtpu.eval.ate import ate_rmse
from ndtpu.slam import pipeline

N_SCANS = 300
N_SESS = 8


def make_sessions():
    sworld = synth.box_world(half=11.0)
    sessions = []
    for k in range(N_SESS):
        traj_k = synth.rectangle_trajectory(N_SCANS, half=6.0 + 0.2 * k,
                                            step=0.2)
        sq = synth.make_sequence(sworld, traj_k, n_beams=360, max_range=20.0,
                                 min_range=0.1, seed=20 + k,
                                 odom_trans_std=0.04, odom_rot_std=0.01)
        sessions.append(sq)
    return sessions


def base_cfg(**over):
    pcfg_base = dict(
        grid=GridConfig(x0=-14.0, y0=-14.0, cell=0.5, nx=56, ny=56,
                        overlap=4),
        keyframe=KeyframeConfig(dist_thresh=0.5, angle_thresh=0.3,
                                capacity=512),
        loop=LoopConfig(radius=3.0, min_index_gap=10, max_candidates=8,
                        local_half_extent=8.0),
        solver=SolverConfig(inc_iters=2, pcg_max_iter=60),
        n_beams=360, max_range=20.0, window=8, window_passes=2,
    )
    cfg8 = PipelineConfig(use_loop_closure=True, **pcfg_base)
    scfg = slam_dp.serving_config(cfg8)
    scfg = dataclasses.replace(
        scfg, loop=dataclasses.replace(scfg.loop, max_candidates=4))
    return dataclasses.replace(scfg, **over) if over else scfg


def run_variant(name, cfg, sessions, P8, M8, O8, reps=3):
    rng = np.random.default_rng(0)
    run_st = jax.jit(lambda p, m, o: slam_dp.run_sessions_stacked(
        p, m, o, cfg))
    t0 = time.perf_counter()
    st8, o8 = run_st(P8, M8, O8)
    np.asarray(o8.pose)
    compile_s = time.perf_counter() - t0
    st_ates = [float(ate_rmse(pipeline.recover_trajectory(
        jax.tree_util.tree_map(lambda a: a[k], st8),
        jax.tree_util.tree_map(lambda a: a[k], o8)),
        sessions[k].gt_poses)) for k in range(N_SESS)]
    ts = []
    for _ in range(reps):
        pk = P8 + jnp.asarray(rng.normal(0, 1e-5, (1, 1, 1, 1)), P8.dtype)
        t0 = time.perf_counter()
        _, o_ = run_st(pk, M8, O8)
        np.asarray(o_.pose)
        ts.append(time.perf_counter() - t0)
    agg = N_SESS * N_SCANS / float(np.median(ts))
    loops = [int(x) for x in np.asarray(st8.n_loops)]
    print(f"{name:42s} {agg:7.0f} scans/s  ATE mean {np.mean(st_ates):.4f} "
          f"max {max(st_ates):.4f}  loops_sum {sum(loops)}  "
          f"compile {compile_s:.0f}s  med {np.median(ts)*1e3:.0f} ms",
          flush=True)
    return agg, st_ates


def main():
    sessions = make_sessions()
    P8 = jnp.stack([sq.points for sq in sessions])
    M8 = jnp.stack([sq.mask for sq in sessions])
    O8 = jnp.stack([sq.odom for sq in sessions])
    names = sys.argv[1:] or ["w8"]
    for nm in names:
        cfg = parse_tokens(base_cfg(), nm)
        run_variant(nm, cfg, sessions, P8, M8, O8)


def parse_tokens(cfg, spec: str):
    """Apply a comma-separated ``key=value`` spec to a PipelineConfig."""
    for tok in spec.split(","):
        if tok in ("w8", ""):
            continue
        k, _, v = tok.partition("=")
        if True:
            if k == "warm":
                cfg = dataclasses.replace(cfg, pass2_warm_start=True)
            elif k == "w":
                cfg = dataclasses.replace(cfg, window=int(v))
            elif k == "p2":
                cfg = dataclasses.replace(cfg, pass2_max_iter=int(v))
            elif k == "stride":
                cfg = dataclasses.replace(cfg, frontend_beam_stride=int(v))
            elif k == "pcg":
                cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
                    cfg.solver, pcg_max_iter=int(v)))
            elif k == "vfy":
                cfg = dataclasses.replace(cfg, loop=dataclasses.replace(
                    cfg.loop, verify_max_iter=int(v)))
            elif k == "top":
                cfg = dataclasses.replace(cfg, refresh_top_m=int(v))
            elif k == "m":
                cfg = dataclasses.replace(cfg, match=dataclasses.replace(
                    cfg.match, max_iter=int(v)))
            elif k == "il":
                cfg = dataclasses.replace(cfg, match=dataclasses.replace(
                    cfg.match, init_lambda=float(v)))
            elif k == "ld":
                cfg = dataclasses.replace(cfg, match=dataclasses.replace(
                    cfg.match, lambda_down=float(v)))
            elif k == "rt":
                cfg = dataclasses.replace(cfg, match=dataclasses.replace(
                    cfg.match, reject_tol=float(v)))
            elif k == "relin":
                cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
                    cfg.solver, relin_threshold=float(v)))
            elif k == "passes":
                cfg = dataclasses.replace(cfg, window_passes=int(v))
            elif k == "tp":
                cfg = dataclasses.replace(cfg, match=dataclasses.replace(
                    cfg.match, phase2_width=int(v)))
            elif k == "tp1":
                cfg = dataclasses.replace(cfg, match=dataclasses.replace(
                    cfg.match, phase1_iters=int(v)))
            elif k == "cap":
                cfg = dataclasses.replace(
                    cfg, keyframe=dataclasses.replace(
                        cfg.keyframe, capacity=int(v)))
            else:
                raise SystemExit(f"unknown token {tok}")
    return cfg


if __name__ == "__main__":
    main()
