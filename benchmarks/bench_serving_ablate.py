"""Per-stage budget of the stacked serving window, by cumulative ablation.

Runs the real 8-session x 300-scan serving workload through variants of
``_stacked_window_step`` with later stages disabled, and reports the
marginal cost of each stage (PERF.md budget, re-measured in
place). Ablation changes the trajectory the later windows see (no
smoothing -> more drift), so the numbers are budget-grade, not exact;
iteration counts in the LM while_loops are data-dependent but shapes are
identical across variants.

Stages (cumulative):
  A  frontend only (2-pass windowed registration)
  B  + appends/loop-detect (graph, keyframes, cached tables, verify LM)
  C  + smoother (batch-hoisted cond, flat block-diagonal PCG)
  D  + map extend (insert window keyframes)
  E  full step (+ top-M refresh under batch cond)  == run_sessions_stacked
"""
from __future__ import annotations

import dataclasses
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, ".")

from ndtpu.dist import slam_dp
from ndtpu.slam import pipeline

from bench_serving_sweep import N_SCANS, N_SESS, base_cfg, make_sessions


def make_step(level, cfg):
    """A stacked window step executing stages up to `level`."""
    from ndtpu.graph import incremental as inc
    from ndtpu.lie import se2

    def step(state8, lkr8, pts8, msk8, deltas8):
        vm = jax.vmap
        poses8, res8, is_kf8 = vm(
            lambda st, lk, p, m, d: pipeline._window_frontend(
                st, lk, p, m, d, cfg, cfg.window_passes)
        )(state8, lkr8, pts8, msk8, deltas8)
        if level == "A":
            st = state8._replace(pose=poses8[:, -1])
            return (st, poses8[:, -1]), poses8
        graph8, kf8, aux8 = vm(
            lambda st, lk, po, h, p, m, ik: pipeline._wb_appends(
                st, lk, po, h, p, m, ik, cfg)
        )(state8, lkr8, poses8, res8.hessian, pts8, msk8, is_kf8)
        any_kf8 = aux8["any_kf"]
        if level == "B":
            sm_g = graph8
            sm_lam, sm_md, sm_st = (state8.sm_lam, state8.sm_last_delta,
                                    state8.sm_step)
        else:
            thr = cfg.solver.relin_threshold
            settled8 = state8.sm_last_delta < thr
            fresh_small8 = vm(inc.fresh_residual_max)(graph8) < thr
            need8 = any_kf8 & ~(settled8 & fresh_small8)

            def smooth_all(_):
                return slam_dp._smooth_stacked(state8, graph8, any_kf8, cfg)

            def skip_all(_):
                sm = inc.SmootherState(
                    graph=graph8, lam=state8.sm_lam,
                    last_max_delta=jnp.where(
                        any_kf8, jnp.zeros_like(state8.sm_last_delta),
                        state8.sm_last_delta),
                    step=state8.sm_step + any_kf8.astype(jnp.int32))
                return sm, jnp.zeros(any_kf8.shape, jnp.int32)

            sm8, _ = jax.lax.cond(jnp.any(need8), smooth_all, skip_all,
                                  None)
            sm_g, sm_lam, sm_md, sm_st = (sm8.graph, sm8.lam,
                                          sm8.last_max_delta, sm8.step)
        graph8 = sm_g
        cap = kf8.poses.shape[1]
        kf8 = kf8._replace(poses=graph8.poses[:, :cap])
        stats8, mkp8 = state8.stats, state8.map_kf_poses
        if level in ("D", "E"):
            stats8, mkp8 = vm(
                lambda st, po, p, m, ik, ks: pipeline._wb_extend(
                    st, po, p, m, ik, ks, cfg)
            )(state8, poses8, pts8, msk8, is_kf8, aux8["kslot"])
        if level == "E":
            trig8 = (jnp.ones_like(any_kf8) if cfg.refresh_always
                     else aux8["n_loops_new"] > 0)

            def do_refresh(arg):
                s8, m8 = arg
                return vm(lambda s, k, m, e: pipeline._refresh_map(
                    s, kf8 if False else k, m, cfg, enable=e))(
                    jax.tree_util.tree_map(lambda a: a, s8), kf8, m8, trig8)

            stats8, mkp8 = jax.lax.cond(jnp.any(trig8), do_refresh,
                                        lambda a: a, (stats8, mkp8))
        last_idx8, lkr8n = aux8["last_idx"], aux8["lkr"]
        pose_out8 = vm(lambda g, li, lk, pw: se2.compose(
            g[li], se2.between(lk, pw)))(graph8.poses, last_idx8, lkr8n,
                                         poses8[:, -1])
        new_state8 = pipeline.SlamState(
            stats=stats8, kf=kf8, graph=graph8, sm_lam=sm_lam,
            sm_last_delta=sm_md, sm_step=sm_st, pose=pose_out8,
            last_kf_idx=last_idx8,
            n_loops=state8.n_loops + aux8["n_loops_new"],
            map_kf_poses=mkp8)
        return (new_state8, lkr8n), poses8

    return step


def run_level(level, cfg, P8, M8, O8, reps=3):
    s, t = P8.shape[0], P8.shape[1]
    w = cfg.window
    t_steps = t - 1
    n_win = -(-t_steps // w)
    pad = n_win * w - t_steps

    def padw(a):
        if not pad:
            return a
        widths = [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2)
        return jnp.pad(a, widths)

    pts_w = padw(P8[:, 1:]).reshape((s, n_win, w) + P8.shape[2:])
    msk_w = padw(M8[:, 1:]).reshape((s, n_win, w) + M8.shape[2:])
    odo_w = padw(O8[:, 1:]).reshape((s, n_win, w, 3))
    pts_w, msk_w, odo_w = (jnp.swapaxes(a, 0, 1)
                           for a in (pts_w, msk_w, odo_w))
    step = make_step(level, cfg)

    @jax.jit
    def runner(P, M, O, pw, mw, ow):
        state0 = jax.vmap(lambda p, m: pipeline.init_slam(cfg, p, m))(
            P[:, 0], M[:, 0])

        def wstep(carry, inp):
            st8, lk8 = carry
            p, m, d = inp
            return step(st8, lk8, p, m, d)

        (stf, _), outs = jax.lax.scan(wstep, (state0, state0.pose),
                                      (pw, mw, ow))
        return outs

    rng = np.random.default_rng(0)
    o = runner(P8, M8, O8, pts_w, msk_w, odo_w)
    np.asarray(o[0])
    ts = []
    for _ in range(reps):
        pk = P8 + jnp.asarray(rng.normal(0, 1e-5, (1, 1, 1, 1)), P8.dtype)
        pkw = padw(pk[:, 1:]).reshape((s, n_win, w) + P8.shape[2:])
        pkw = jnp.swapaxes(pkw, 0, 1)
        t0 = time.perf_counter()
        o = runner(pk, M8, O8, pkw, msk_w, odo_w)
        np.asarray(o[0])
        ts.append(time.perf_counter() - t0)
    med = float(np.median(ts))
    per_win = med / n_win * 1e3
    print(f"{level}: {med*1e3:7.0f} ms total  {per_win:6.2f} ms/window",
          flush=True)
    return med, per_win


def main():
    sessions = make_sessions()
    P8 = jnp.stack([sq.points for sq in sessions])
    M8 = jnp.stack([sq.mask for sq in sessions])
    O8 = jnp.stack([sq.odom for sq in sessions])
    cfg = base_cfg()
    for over in sys.argv[1:]:
        k, v = over.split("=")
        cfg = dataclasses.replace(cfg, **{k: int(v)})
    prev = 0.0
    for level in ["A", "B", "C", "D", "E"]:
        med, per_win = run_level(level, cfg, P8, M8, O8)
        print(f"   marginal: {per_win - prev:6.2f} ms/window", flush=True)
        prev = per_win


if __name__ == "__main__":
    main()
