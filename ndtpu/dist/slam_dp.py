"""Data-parallel multi-session SLAM: one full windowed pipeline per device.

Capability (SURVEY.md §3.3 "DP", BASELINE north star "scans/s measured at 1
chip, 1 host, N>=2 hosts"): S independent SLAM sessions (robots / log
shards) run concurrently — the whole windowed pipeline (registration,
keyframing, loop closure, incremental smoothing, map maintenance) is
``vmap``-ed over a leading session axis and ``shard_map``-ed over the
``"batch"`` mesh axis, so each device owns ``S / n_devices`` sessions
end-to-end with ZERO cross-device communication (sessions are independent;
merging afterwards is ndtpu.slam.merge + the distributed Schur solve,
config 5).

This is the scale-out of the SLAM pipeline itself, as opposed
to the per-primitive sharding in ndtpu.dist.registration / gridmap: at
fleet scale the right unit of parallelism is the session, exactly like
batch inference in serving.
"""

from __future__ import annotations

import dataclasses
import functools
import warnings

import jax
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ndtpu.config import PipelineConfig
from ndtpu.slam import pipeline

__all__ = ["run_sessions", "run_sessions_stacked", "run_sessions_sharded",
           "serving_config", "vmap_cond_hazards"]


def vmap_cond_hazards(cfg: PipelineConfig) -> list[str]:
    """Config fields whose ``lax.cond`` branches are EXPENSIVE under vmap.

    Under ``vmap`` every ``lax.cond`` lowers to a select that executes BOTH
    branches for the whole batch, so the cost of the rarely-taken branch is
    paid every window for every session. The offenders, most expensive
    first:

    - ``refresh_top_m == 0``: the legacy full-map rebuild (one build_stats
      over ALL keyframe points) runs every window.
    - ``solver.full_solve_every > 0``: the periodic full LM optimization
      (max_iter x PCG) runs every window.
    - ``full_rebuild_every > 0``: the periodic full rebuild runs every
      window (only reachable when refresh_top_m > 0).
    - ``solver.local_poses > 0``: both the k-hop local solve AND the global
      PCG update run every window.
    """
    bad = []
    if cfg.refresh_top_m == 0:
        bad.append("refresh_top_m=0 (full map rebuild every window)")
    elif cfg.full_rebuild_every > 0:
        bad.append("full_rebuild_every>0 (periodic rebuild every window)")
    if cfg.solver.full_solve_every > 0:
        bad.append("solver.full_solve_every>0 (full LM solve every window)")
    if cfg.solver.local_poses > 0:
        bad.append("solver.local_poses>0 (local AND global paths every "
                   "window)")
    return bad


def serving_config(cfg: PipelineConfig, refresh_top_m: int = 12,
                   fast: bool = True) -> PipelineConfig:
    """A vmap-safe variant of ``cfg`` for stacked multi-session serving.

    Replaces every :func:`vmap_cond_hazards` offender with its
    bounded-cost equivalent:

    - map maintenance: incremental top-M refresh on loop windows
      (``refresh_top_m``, eps=0 — the empirically safe cadence) instead of
      the full rebuild; the decision semantics are unchanged (the refresh
      still only APPLIES on loop windows — under vmap its cost is simply
      paid every window, bounded at M keyframes instead of all of them);
    - smoother: global warm-started PCG only (``local_poses=0``,
      ``full_solve_every=0``) — at serving session lengths (a few hundred
      scans) the periodic full solve never fired anyway, and paying both
      local and global branches per window is strictly worse than global
      alone.

    ``fast=True`` additionally applies the serving preset (a serving
    window is bound by sequential depth — ~45 dependent LM/PCG iterations —
    so the levers are sequential-depth cuts): loop verification at 6 LM
    iterations on every 2nd beam (the factor's information honestly
    reflects the subsampled scan), smoother at 1 LM iteration x 6 PCG
    iterations (warm-started),
    two-phase straggler compaction at width 16 for the fused flat
    frontend (:func:`_frontend_stacked`). On the 8-session serving
    workload (benchmarks/bench_serving_sweep.py) these caps keep
    equal-or-better per-session ATE against the exact settings (the
    shortened PCG is warm-started every window, so the smoother still
    converges across windows); their speed on the GPU is not measured.
    """
    solver = dataclasses.replace(cfg.solver, local_poses=0,
                                 full_solve_every=0)
    loop = cfg.loop
    match = cfg.match
    if fast:
        solver = dataclasses.replace(solver, pcg_max_iter=6, inc_iters=1)
        loop = dataclasses.replace(loop, verify_max_iter=6,
                                   verify_beam_stride=2)
        match = dataclasses.replace(match, phase2_width=16)
    return dataclasses.replace(
        cfg,
        refresh_top_m=refresh_top_m,
        refresh_eps=0.0,
        full_rebuild_every=0,
        loop=loop,
        solver=solver,
        match=match,
    )


def run_sessions(points, mask, odom, cfg: PipelineConfig):
    """S sessions on the local device: ``vmap`` of the windowed pipeline.

    points ``[S, T, N, 2]``, mask ``[S, T, N]``, odom ``[S, T, 3]``.
    Returns the vmapped ``(SlamState, SlamStepOut)`` with leading ``S``.
    On one chip this is the multi-robot serving shape (aggregate scans/s
    across sessions); under ``run_sessions_sharded`` it is the per-device
    workload.

    For S > 1 pass a :func:`serving_config`-shaped ``cfg``: vmapped
    ``lax.cond`` executes both branches, so the default config's full-map
    rebuild / full-solve branches run every window
    (:func:`vmap_cond_hazards` lists the offenders, and this function warns
    when one is present).
    """
    if points.shape[0] > 1:
        bad = vmap_cond_hazards(cfg)
        if bad:
            warnings.warn(
                "run_sessions with S>1: vmapped lax.cond executes BOTH "
                "branches, and this config has expensive rare branches "
                f"({'; '.join(bad)}) — every window pays for both. Use "
                "serving_config(cfg) for the bounded-cost equivalents.",
                stacklevel=2)
    return jax.vmap(
        lambda p, m, o: pipeline.run_slam_windowed(p, m, o, cfg)
    )(points, mask, odom)


def _flat_graph(graph8):
    """S per-session pose graphs as ONE block-diagonal flat graph.

    Pose/factor arrays concatenate with a per-session index offset; the
    sessions are independent components, so any mask-driven solver (PCG,
    linearize, chi2) runs on the union unchanged. This is the
    alternative to vmapping the smoother: under vmap every gather/scatter
    in the PCG matvec carries a batching dimension; flat indexing keeps
    them single-axis (the difference is not measured on the GPU).
    """
    import jax.numpy as jnp
    from ndtpu.graph import factors as fct

    s, v = graph8.poses.shape[:2]
    off = jnp.arange(s, dtype=jnp.int32)[:, None] * v
    return fct.PoseGraph(
        poses=graph8.poses.reshape(s * v, 3),
        pose_mask=graph8.pose_mask.reshape(-1),
        prior_idx=(graph8.prior_idx + off).reshape(-1),
        prior_z=graph8.prior_z.reshape(-1, 3),
        prior_sqrt_info=graph8.prior_sqrt_info.reshape(-1, 3, 3),
        prior_mask=graph8.prior_mask.reshape(-1),
        bet_i=(graph8.bet_i + off).reshape(-1),
        bet_j=(graph8.bet_j + off).reshape(-1),
        bet_z=graph8.bet_z.reshape(-1, 3),
        bet_sqrt_info=graph8.bet_sqrt_info.reshape(-1, 3, 3),
        bet_mask=graph8.bet_mask.reshape(-1),
        n_poses=jnp.asarray(s * v, jnp.int32),
        n_priors=jnp.asarray(graph8.prior_mask.shape[1] * s, jnp.int32),
        n_between=jnp.asarray(graph8.bet_mask.shape[1] * s, jnp.int32),
    )


def _smooth_stacked(state8, graph8, any_kf8, need8, cfg: PipelineConfig):
    """Damped-GN/PCG smoothing for ALL sessions in one flat program.

    Semantics per session match the global path of
    :func:`ndtpu.graph.incremental.incremental_update` (``do_global``):
    ``inc_iters`` LM iterations, each one PCG solve + per-SESSION
    chi²-accept (residuals segment-sum by session, so one session's bad
    step is never accepted because another improved), per-session lambda
    (the PCG damping takes a per-pose vector). Sessions whose window had
    no keyframe are left untouched.

    ``need8`` gates the UPDATE per session (the settled-skip test): the
    batch-level cond fires when ANY session needs smoothing, but a
    settled session must get the SKIP semantics, not a free extra step.
    Accepting steps for every session with a keyframe constantly nudges
    settled sessions' keyframe poses; the map is only re-rendered on that
    session's loop windows, so the nudges accumulate as map-vs-pose
    mismatch and the frontend drifts off — the measured bad attractor
    (one session per 8-session batch drifting to 2–7 m ATE with loop
    acceptance collapsing, on 3 of 4 seed sets; per-session gating
    restores the single-session path's behavior).
    """
    import jax.numpy as jnp
    from ndtpu.graph import factors as fct
    from ndtpu.graph import incremental as inc
    from ndtpu.graph import solve as slv

    huber = cfg.solver.huber_delta
    scfg = cfg.solver
    s, v = graph8.poses.shape[:2]
    f = graph8.bet_mask.shape[1]
    p = graph8.prior_mask.shape[1]
    dt = graph8.poses.dtype
    flat = _flat_graph(graph8)

    def chi_from(lin):
        (_, _, r), (_, rp) = lin
        return (jnp.sum(r.reshape(s, f, 3) ** 2, axis=(1, 2))
                + jnp.sum(rp.reshape(s, p, 3) ** 2, axis=(1, 2)))

    def body(_, carry):
        poses, lam8, md8 = carry
        g = flat._replace(poses=poses)
        lin = fct.linearize(g, huber)
        # Current chi2 from the SAME linearization the step uses (the
        # whitened residuals are exactly what chi_s recomputed): one
        # linearize per iteration saved — the serving window is bound by
        # sequential depth.
        chi8 = chi_from(lin)
        lam_v = jnp.repeat(lam8, v)[:, None]        # [S*V, 1] per-pose lam
        # Per-SESSION Krylov scalars: global alpha/beta dot products on the
        # block-diagonal joint system starve the small-residual sessions
        # (one stalls, drifts, ATE 7.5 m on adversarial seeds); the blocked
        # form is exactly S independent PCGs in lockstep.
        delta, _ = slv.pcg_rhs_blocked(g, lin, -slv.gradient(g, lin), lam_v,
                                       scfg, s)
        trial = slv._apply_delta(poses, delta, g.pose_mask)
        chi_t = chi_from(fct.linearize(g._replace(poses=trial), huber))
        accept8 = (chi_t < chi8) & need8            # [S]
        acc_v = jnp.repeat(accept8, v)[:, None]
        poses_n = jnp.where(acc_v, trial, poses)
        lam_n = jnp.where(
            accept8, jnp.maximum(lam8 / scfg.lambda_down, 1e-12),
            jnp.where(need8, lam8 * scfg.lambda_up, lam8))
        d8 = jnp.max(jnp.abs(delta.reshape(s, v, 3)), axis=(1, 2))
        md_n = jnp.where(accept8, jnp.maximum(md8, d8), md8)
        return poses_n, lam_n, md_n

    poses, lam8, md8 = jax.lax.fori_loop(
        0, scfg.inc_iters, body,
        (flat.poses, state8.sm_lam, jnp.zeros((s,), dt)))
    # Skipped-but-keyframed sessions record md=0 (the skip semantics);
    # updated sessions record their max step; idle sessions keep history.
    sm = inc.SmootherState(
        graph=graph8._replace(poses=poses.reshape(s, v, 3)),
        lam=lam8,
        last_max_delta=jnp.where(need8, md8,
                                 jnp.where(any_kf8,
                                           jnp.zeros_like(md8),
                                           state8.sm_last_delta)),
        step=state8.sm_step + any_kf8.astype(jnp.int32))
    return sm, need8.astype(jnp.int32)     # take code 1 = global update


def _frontend_stacked(state8, lkr8, pts8, msk8, deltas8,
                      cfg: PipelineConfig):
    """The windowed 2-pass frontend for ALL S sessions as ONE flat batched
    LM program per pass (instead of a vmap of per-session programs).

    All ``S*W`` registration lanes share one while_loop: the sequential
    iteration depth is max-over-ALL-lanes once (the vmapped form pays the
    same depth but cannot compact stragglers), and with
    ``cfg.match.phase2_width > 0`` the two-phase straggler compaction
    works across the whole fleet — the converged majority stops paying
    for the handful of frontier lanes. Session maps are shared per group
    of W lanes via :func:`ndtpu.ndt.grid.lookup_quad_grouped` (tables are
    never materialized per lane). Semantics per session are identical to
    :func:`ndtpu.slam.pipeline._window_frontend`.
    """
    import dataclasses

    import jax.numpy as jnp
    from ndtpu.lie import se2
    from ndtpu.ndt import grid as ndt_grid
    from ndtpu.ndt import match as ndt_match
    from ndtpu.slam.odometry import chain_deltas, gate_poses, kf_select

    s, w = pts8.shape[0], pts8.shape[1]
    group = jnp.repeat(jnp.arange(s, dtype=jnp.int32), w)
    stride = max(1, cfg.frontend_beam_stride)
    mpts8, mmsk8 = ((pts8, msk8) if stride == 1
                    else (pts8[:, :, ::stride], msk8[:, :, ::stride]))

    def flat(a):
        return a.reshape((s * w,) + a.shape[2:])

    def kf_flags8(lk8, poses8):
        return jax.vmap(lambda lk, p: kf_select(
            lk, p, cfg.keyframe.dist_thresh, cfg.keyframe.angle_thresh)[0]
        )(lk8, poses8)

    def pack8(stats8):
        return jax.vmap(lambda st: ndt_grid.pack_quad(
            ndt_grid.finalize(st, cfg.ndt), cfg.grid,
            compact=cfg.match.compact_table))(stats8)

    table8 = pack8(state8.stats)
    inits = jax.vmap(chain_deltas)(state8.pose, deltas8)         # [S, W, 3]
    res = ndt_match.match_batch_packed(
        flat(mpts8), flat(mmsk8), table8, inits.reshape(s * w, 3),
        cfg.grid, cfg.match, group=group)
    poses8, _ = gate_poses(res.pose.reshape(s, w, 3),
                           res.converged.reshape(s, w), inits, cfg.odom_gate)
    mcfg2 = cfg.match
    if cfg.pass2_max_iter > 0:
        mcfg2 = dataclasses.replace(cfg.match, max_iter=cfg.pass2_max_iter)
    for _ in range(max(0, cfg.window_passes - 1)):
        kf_prev8 = kf_flags8(lkr8, poses8)
        tmp8 = jax.vmap(lambda st, po, p, m: ndt_grid.add_points(
            st, se2.transform(po, p).reshape(-1, 2), m.reshape(-1),
            cfg.grid))(state8.stats, poses8, pts8,
                       msk8 & kf_prev8[..., None])
        table8 = pack8(tmp8)
        prev = jnp.concatenate([state8.pose[:, None], poses8[:, :-1]],
                               axis=1)
        inits2 = se2.compose(prev, deltas8)
        res = ndt_match.match_batch_packed(
            flat(pts8), flat(msk8), table8, inits2.reshape(s * w, 3),
            cfg.grid, mcfg2, group=group)
        poses8, _ = gate_poses(res.pose.reshape(s, w, 3),
                               res.converged.reshape(s, w), inits2,
                               cfg.odom_gate)
    is_kf8 = kf_flags8(lkr8, poses8)
    res8 = jax.tree_util.tree_map(
        lambda a: a.reshape((s, w) + a.shape[1:]), res)
    return poses8, res8, is_kf8


def _stacked_window_step(state8, lkr8, pts8, msk8, deltas8,
                         cfg: PipelineConfig):
    """One window for ALL S sessions in one program, with the rare-branch
    conds hoisted to BATCH level (VERDICT r5 task 1).

    The frontend and the append/loop-detection stages contain no
    ``lax.cond`` and vmap at full speed (the S*W registration lanes and
    S*K*C loop-verification lanes each run as one wide batched LM). The
    smoother and the map refresh DO branch — under vmap a per-session cond
    executes both branches every window (the serving trap) — so their
    conds are hoisted above the vmap: the predicate is batch-reduced to a
    scalar (``jnp.any``), and the cond
    then executes ONE branch at runtime. When any session triggers, every
    session pays (the work is masked per session); on serving workloads
    the smoother tier-1 skip fires on most windows, so the common case
    pays neither.
    """
    import jax.numpy as jnp
    from ndtpu.graph import incremental as inc
    from ndtpu.lie import se2

    vm = jax.vmap
    poses8, res8, is_kf8 = _frontend_stacked(state8, lkr8, pts8, msk8,
                                             deltas8, cfg)
    graph8, kf8, aux8 = vm(
        lambda st, lk, po, h, p, m, ik: pipeline._wb_appends(
            st, lk, po, h, p, m, ik, cfg)
    )(state8, lkr8, poses8, res8.hessian, pts8, msk8, is_kf8)
    any_kf8 = aux8["any_kf"]

    # --- smoother: ONE batch-level cond ---------------------------------
    # need = the inverse of incremental_update's O(K) tier-1 skip test,
    # evaluated per session; the cond runs the real per-session smoother
    # (with its own inner tiers) only when some session needs it, and
    # otherwise reproduces the skip semantics exactly (md=0, step+1 for
    # sessions whose window had a keyframe; untouched otherwise).
    thr = cfg.solver.relin_threshold
    settled8 = state8.sm_last_delta < thr
    fresh_small8 = vm(inc.fresh_residual_max)(graph8) < thr
    need8 = any_kf8 & ~(settled8 & fresh_small8)

    def smooth_all(_):
        return _smooth_stacked(state8, graph8, any_kf8, need8, cfg)

    def skip_all(_):
        sm = inc.SmootherState(
            graph=graph8, lam=state8.sm_lam,
            last_max_delta=jnp.where(any_kf8,
                                     jnp.zeros_like(state8.sm_last_delta),
                                     state8.sm_last_delta),
            step=state8.sm_step + any_kf8.astype(jnp.int32))
        return sm, jnp.zeros(any_kf8.shape, jnp.int32)

    sm8, take8 = jax.lax.cond(jnp.any(need8), smooth_all, skip_all, None)
    graph8 = sm8.graph
    cap = kf8.poses.shape[1]
    kf8 = kf8._replace(poses=graph8.poses[:, :cap])

    # --- map maintenance: extend always, refresh under ONE batch cond ---
    stats8, mkp8 = vm(
        lambda st, po, p, m, ik, ks: pipeline._wb_extend(
            st, po, p, m, ik, ks, cfg)
    )(state8, poses8, pts8, msk8, is_kf8, aux8["kslot"])
    trig8 = (jnp.ones_like(any_kf8) if cfg.refresh_always
             else aux8["n_loops_new"] > 0)

    def do_refresh(arg):
        s8, m8 = arg
        return vm(lambda s, k, m, e: pipeline._refresh_map(s, k, m, cfg,
                                                           enable=e))(
            s8, kf8, m8, trig8)

    stats8, mkp8 = jax.lax.cond(jnp.any(trig8), do_refresh, lambda a: a,
                                (stats8, mkp8))

    last_idx8, lkr8n = aux8["last_idx"], aux8["lkr"]
    pose_out8 = vm(lambda g, li, lk, pw: se2.compose(
        g[li], se2.between(lk, pw)))(graph8.poses, last_idx8, lkr8n,
                                     poses8[:, -1])
    new_state8 = pipeline.SlamState(
        stats=stats8, kf=kf8, graph=graph8, sm_lam=sm8.lam,
        sm_last_delta=sm8.last_max_delta, sm_step=sm8.step, pose=pose_out8,
        last_kf_idx=last_idx8,
        n_loops=state8.n_loops + aux8["n_loops_new"], map_kf_poses=mkp8)
    out8 = pipeline.SlamStepOut(
        pose=poses8, kf_idx=aux8["kf_idx_out"], rel=aux8["rel_out"],
        score=res8.score, is_keyframe=is_kf8, n_loops_new=aux8["nl_out"],
        n_dropped=aux8["nd_out"], n_innov_rej=aux8["ni_out"],
        local_take=jnp.broadcast_to(take8[:, None], is_kf8.shape))
    return (new_state8, lkr8n), out8


def run_sessions_stacked(points, mask, odom, cfg: PipelineConfig):
    """S concurrent sessions through ONE windowed program per window — the
    single-chip serving entry point (VERDICT r5 task 1).

    points ``[S, T, N, 2]``, mask ``[S, T, N]``, odom ``[S, T, 3]``.
    Returns ``(SlamState, SlamStepOut)`` with leading session axis, same
    per-session semantics as :func:`ndtpu.slam.pipeline.run_slam_windowed`
    under a :func:`serving_config` (which ``cfg`` must be — the hazards in
    :func:`vmap_cond_hazards` are rejected).

    vs. :func:`run_sessions` (plain vmap): the registration and loop-
    verification lanes of all sessions still fuse into wide batched LM
    programs, but the smoother / map-refresh conds execute ONE branch at
    runtime (batch-reduced predicates above the vmap) instead of both
    branches per session per window.
    """
    import jax.numpy as jnp

    bad = vmap_cond_hazards(cfg)
    if bad:
        raise ValueError(
            "run_sessions_stacked requires a serving-shaped config "
            f"(offenders: {'; '.join(bad)}); wrap with serving_config().")
    s, t = points.shape[0], points.shape[1]
    w = cfg.window
    t_steps = t - 1
    n_win = -(-t_steps // w)
    pad = n_win * w - t_steps

    def padw(a):
        if not pad:
            return a
        widths = [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2)
        return jnp.pad(a, widths)

    # [S, n_win, w, ...] -> scan over the window axis.
    pts_w = padw(points[:, 1:]).reshape((s, n_win, w) + points.shape[2:])
    msk_w = padw(mask[:, 1:]).reshape((s, n_win, w) + mask.shape[2:])
    odo_w = padw(odom[:, 1:]).reshape((s, n_win, w, 3))
    pts_w, msk_w, odo_w = (jnp.swapaxes(a, 0, 1)
                           for a in (pts_w, msk_w, odo_w))

    state0 = jax.vmap(lambda p, m: pipeline.init_slam(cfg, p, m))(
        points[:, 0], mask[:, 0])

    def wstep(carry, inp):
        st8, lk8 = carry
        p, m, d = inp
        return _stacked_window_step(st8, lk8, p, m, d, cfg)

    (state, _), outs = jax.lax.scan(wstep, (state0, state0.pose),
                                    (pts_w, msk_w, odo_w))
    outs = jax.tree_util.tree_map(
        lambda a: jnp.swapaxes(a, 0, 1).reshape(
            (s, n_win * w) + a.shape[3:])[:, :t_steps], outs)
    return state, outs


def run_sessions_sharded(mesh: Mesh, points, mask, odom,
                         cfg: PipelineConfig, axis: str = "batch"):
    """Shard S sessions across the mesh axis; each device runs its shard's
    sessions end-to-end (no collectives — sessions are independent).

    With exactly one session per device (the fleet-scale sweet spot) the
    pipeline runs UNBATCHED on each device: under ``vmap``, every
    ``lax.cond`` in the pipeline lowers to a select that executes BOTH
    branches — including the full-map rebuild — every window, while the
    unbatched per-device program keeps real branching.

    The ``shard_map`` runs under ``jax.jit``, compiled once per
    ``(mesh, cfg, axis)`` and input shape. Called eagerly, ``shard_map``
    dispatches the pipeline primitive by primitive and recompiles the
    window scan on every call.
    """
    return _sessions_sharded_fn(mesh, cfg, axis)(points, mask, odom)


@functools.lru_cache(maxsize=8)
def _sessions_sharded_fn(mesh: Mesh, cfg: PipelineConfig, axis: str):
    def local(p, m, o):
        if p.shape[0] == 1:
            st, outs = pipeline.run_slam_windowed(p[0], m[0], o[0], cfg)
            return jax.tree_util.tree_map(lambda a: a[None], (st, outs))
        return run_sessions(p, m, o, cfg)

    return jax.jit(shard_map(
        local, mesh=mesh, in_specs=(P(axis), P(axis), P(axis)),
        out_specs=P(axis), check_vma=False,
    ))
