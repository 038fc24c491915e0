"""Full SLAM pipeline: NDT odometry + keyframing + loop closure + smoothing.

Capability parity (SURVEY.md §4.1 "Main SLAM loop", BASELINE configs 2-3):
per scan — predict from odometry, register against the online NDT map, spawn
keyframes, detect/verify loop closures among keyframes, maintain the pose
graph with incremental smoothing, and rebuild the map after topology-changing
corrections.

Design: the whole sequence is ONE ``lax.scan``; every
data-dependent event (keyframe spawn, loop acceptance, map rebuild) is a
``lax.cond`` branch or masked write inside the step, so a T-scan run is a
single XLA program with one host->device transfer in and one out. The
reference interleaves all of this on the host per scan (SURVEY.md §4.1).

Keyframe store index == pose-graph variable index (1:1), which makes the
pose sync after smoothing a single array copy.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ndtpu.config import PipelineConfig
from ndtpu.graph import factors as fct
from ndtpu.graph import incremental as inc
from ndtpu.lie import se2
from ndtpu.loop import closure
from ndtpu.ndt import grid as ndt_grid
from ndtpu.ndt import match as ndt_match
from ndtpu.slam import keyframes as kfs

__all__ = ["SlamState", "SlamStepOut", "init_slam", "slam_step", "run_slam",
           "slam_window_step", "slam_window_step_jit", "run_slam_windowed",
           "recover_trajectory"]


class SlamState(NamedTuple):
    stats: ndt_grid.NDTStats   # online NDT map sufficient statistics
    kf: kfs.KeyframeStore      # keyframe scans + poses (index == graph index)
    graph: fct.PoseGraph       # pose graph over keyframes
    sm_lam: jax.Array          # [] smoother damping
    sm_last_delta: jax.Array   # [] smoother last max step
    sm_step: jax.Array         # [] int32 smoother update counter
                               #    (drives cfg.solver.full_solve_every)
    pose: jax.Array            # [3] current pose estimate
    last_kf_idx: jax.Array     # [] int32 graph index of the latest keyframe
    n_loops: jax.Array         # [] int32 accepted loop closures so far
    map_kf_poses: jax.Array    # [K, 3] keyframe poses the map was built at
                               #    (drives the refresh staleness ranking)


class SlamStepOut(NamedTuple):
    pose: jax.Array        # [3] per-scan pose estimate (at processing time)
    kf_idx: jax.Array      # [] int32 keyframe this scan hangs off
    rel: jax.Array         # [3] pose relative to that keyframe
    score: jax.Array       # [] NDT match quality
    is_keyframe: jax.Array  # [] bool
    n_loops_new: jax.Array  # [] int32 loops accepted at this step
    # Capacity-saturation counter (VERDICT r3 weak 6): keyframes/factors
    # silently dropped by masked appends at this step. A long run whose
    # stores fill would otherwise quietly degrade into open-loop odometry;
    # run.py warns when the total is nonzero.
    n_dropped: jax.Array   # [] int32
    # Verified-but-innovation-rejected loop candidates at this step
    # (ADVICE r4): a persistently large total means the odometry-drift
    # budget (LoopConfig.max_innovation_*) is mistuned for the platform.
    n_innov_rej: jax.Array  # [] int32
    # Smoother path taken at this step's update (VERDICT r4 missing #5):
    # 0 = settled skip / no update ran, 1 = global warm-started PCG,
    # 2 = k-hop local bounded-cost. Windowed runs broadcast the window's
    # code to its scans.
    local_take: jax.Array   # [] int32


def init_slam(cfg: PipelineConfig, first_points, first_mask,
              init_pose=None) -> SlamState:
    """Bootstrap: scan 0 becomes keyframe 0 / graph pose 0 with a prior."""
    dt = first_points.dtype
    t0 = jnp.zeros((3,), dt) if init_pose is None else init_pose.astype(dt)
    cap = cfg.keyframe.capacity

    stats = ndt_grid.add_points(
        ndt_grid.empty_stats(cfg.grid, dt),
        se2.transform(t0, first_points), first_mask, cfg.grid)

    # Loop closure on -> allocate the per-keyframe local-table cache and
    # build keyframe 0's table (sensor-frame, hence never invalidated).
    compact = cfg.match.compact_table
    tshape = (closure.local_table_shape(cfg.loop, compact)
              if cfg.use_loop_closure else None)
    tbl0 = (closure.build_local_table(first_points, first_mask, cfg.loop,
                                      cfg.ndt, compact)
            if cfg.use_loop_closure else None)
    kf = kfs.add_keyframe(
        kfs.empty_store(cap, first_points.shape[0], dt, table_shape=tshape),
        t0, first_points, first_mask, table=tbl0)

    graph = fct.empty_graph(cap, 4, 2 * cap, dt)
    graph = fct.add_pose(graph, t0)
    prior_sq = jnp.asarray(
        [[100.0, 0, 0], [0, 100.0, 0], [0, 0, 100.0]], dt)
    graph = fct.add_prior(graph, 0, t0, prior_sq)

    return SlamState(
        stats=stats, kf=kf, graph=graph,
        sm_lam=jnp.asarray(cfg.solver.init_lambda, dt),
        sm_last_delta=jnp.asarray(jnp.inf, dt),
        sm_step=jnp.asarray(0, jnp.int32),
        pose=t0, last_kf_idx=jnp.asarray(0, jnp.int32),
        n_loops=jnp.asarray(0, jnp.int32),
        map_kf_poses=kf.poses,
    )


def _odom_info_sqrt(hessian, dt):
    """Between-factor sqrt information from the registration Hessian."""
    h = 0.5 * (hessian + hessian.T) + 1e-3 * jnp.eye(3, dtype=dt)
    return fct.info_to_sqrt_info(h)


def _refresh_map(stats, kf: kfs.KeyframeStore, mkp, cfg: PipelineConfig,
                 enable=True):
    """Incremental map refresh: re-place the ``refresh_top_m`` stalest
    keyframes (smoothed pose vs. the pose the map last saw them at).

    NDT stats are sums, so moving a scan is subtract-at-old-pose +
    add-at-new-pose (:func:`ndtpu.ndt.grid.add_points` ``weight=-1``) — the
    bounded-cost replacement for the full rebuild-from-all-keyframes that
    dominated config-3 (PERF.md). Settled keyframes are never
    touched, which is what keeps the map from random-walking (re-rendering
    everything every window measurably diverges). Returns ``(stats, mkp)``.

    ``enable`` (traced bool) masks the whole refresh to a no-op — the
    stacked multi-session path runs the refresh under ONE batch-level cond
    and masks the sessions whose trigger is false (the per-session cond
    would execute both branches under vmap).
    """
    m_top = min(cfg.refresh_top_m, kf.capacity)
    big = jnp.asarray(1 << 30, jnp.int32)
    d_xy = jnp.linalg.norm(kf.poses[:, :2] - mkp[:, :2], axis=-1)
    d_th = jnp.abs(se2.wrap(kf.poses[:, 2:] - mkp[:, 2:]))[:, 0]
    stale = jnp.where(kf.live, jnp.maximum(d_xy, d_th), 0.0)
    val, sel = jax.lax.top_k(stale, m_top)
    do = (val > cfg.refresh_eps) & enable                        # [M]
    smsk = (kf.masks[sel] & kf.live[sel][:, None]
            & do[:, None]).reshape(-1)
    spts = kf.points[sel]                                        # [M, N, 2]
    old_w = se2.transform(mkp[sel], spts).reshape(-1, 2)
    new_w = se2.transform(kf.poses[sel], spts).reshape(-1, 2)
    # Subtract-old + add-new as ONE weighted call: same scatter rows, but
    # the per-call fixed cost (the dense half-cell pooling pass) is paid
    # once instead of twice — the refresh fires on most serving windows.
    both = jnp.concatenate([old_w, new_w], axis=0)
    bmsk = jnp.concatenate([smsk, smsk], axis=0)
    wts = jnp.concatenate([jnp.full((old_w.shape[0],), -1.0, both.dtype),
                           jnp.ones((new_w.shape[0],), both.dtype)])
    stats = ndt_grid.add_points(stats, both, bmsk, cfg.grid, weight=wts)
    mkp = mkp.at[jnp.where(do, sel, big)].set(kf.poses[sel], mode="drop")
    return stats, mkp


def _keyframe_branch(state: SlamState, pts, msk, pose, hessian,
                     cfg: PipelineConfig):
    """Everything that happens when a scan is promoted to a keyframe."""
    dt = pose.dtype
    new_idx = state.graph.n_poses
    last_idx = state.last_kf_idx

    # 1. new pose variable + odometry between factor (noise from H).
    graph = fct.add_pose(state.graph, pose)
    z_odo = se2.between(state.graph.poses[last_idx], pose)
    graph = fct.add_between(graph, last_idx, new_idx, z_odo,
                            _odom_info_sqrt(hessian, dt))

    # 2. keyframe store append (before detection: the query is NOT a
    #    candidate for itself thanks to the index-gap test).
    tbl = (closure.build_local_table(pts, msk, cfg.loop, cfg.ndt,
                                     cfg.match.compact_table)
           if cfg.use_loop_closure else None)
    kf = kfs.add_keyframe(state.kf, pose, pts, msk, table=tbl)

    # 3. batched loop detection + masked factor appends.
    if cfg.use_loop_closure:
        loops = closure.detect_loops_cached(
            kf, pts, msk, pose, new_idx, cfg.loop, cfg.match)

        def append(i, g):
            return fct.add_between(g, loops.j[i], new_idx, loops.z[i],
                                   loops.sqrt_info[i], enabled=loops.accept[i])

        graph = jax.lax.fori_loop(0, cfg.loop.max_candidates, append, graph)
        n_new = jnp.sum(loops.accept, dtype=jnp.int32)
        n_innov = jnp.sum(loops.innov_rej, dtype=jnp.int32)
    else:
        n_new = jnp.asarray(0, jnp.int32)
        n_innov = jnp.asarray(0, jnp.int32)

    # Capacity-saturation count: appends above are masked, so compare the
    # post-append cursors against what SHOULD have been appended.
    expect_bet = 1 + n_new
    n_drop = ((1 - (graph.n_poses - state.graph.n_poses))
              + (1 - (kf.n - state.kf.n))
              + (expect_bet - (graph.n_between - state.graph.n_between)))

    # 4. incremental smoothing (iSAM2-update role).
    sm = inc.SmootherState(graph=graph, lam=state.sm_lam,
                           last_max_delta=state.sm_last_delta,
                           step=state.sm_step)
    sm, take = inc.incremental_update(sm, cfg.solver,
                                      huber_delta=cfg.solver.huber_delta,
                                      fresh_since=state.graph.n_between,
                                      return_take=True)
    graph = sm.graph

    # 5. sync keyframe poses from the graph; current pose = newest estimate.
    kf = kf._replace(poses=graph.poses[: kf.capacity])
    pose_out = graph.poses[new_idx]

    # 6. map maintenance: loop accepted -> rebuild from all keyframes at
    #    corrected poses (one batched segment_sum); else just add this scan.
    #    (The sequential path keeps the simple legacy policy; the windowed
    #    backend uses the bounded-cost incremental refresh.)
    mkp = state.map_kf_poses.at[new_idx].set(pose_out)

    def rebuild(_):
        world = se2.transform(kf.poses, kf.points)       # [K, N, 2]
        m = kf.masks & kf.live[:, None]
        return ndt_grid.build_stats(world.reshape(-1, 2), m.reshape(-1),
                                    cfg.grid), kf.poses

    def extend(_):
        return ndt_grid.add_points(state.stats, se2.transform(pose_out, pts),
                                   msk, cfg.grid), mkp

    stats, mkp = jax.lax.cond(n_new > 0, rebuild, extend, None)

    return SlamState(
        stats=stats, kf=kf, graph=graph, sm_lam=sm.lam,
        sm_last_delta=sm.last_max_delta, sm_step=sm.step, pose=pose_out,
        last_kf_idx=new_idx, n_loops=state.n_loops + n_new,
        map_kf_poses=mkp,
    ), n_new, n_drop, n_innov, take


def slam_step(state: SlamState, pts, msk, odom_delta,
              cfg: PipelineConfig):
    """Process one scan; returns ``(new_state, SlamStepOut)``. Jittable."""
    init = se2.compose(state.pose, odom_delta)
    ndt_map = ndt_grid.finalize(state.stats, cfg.ndt)
    res = ndt_match.match(pts, msk, ndt_map, init, cfg.grid, cfg.match)
    # Fall back to the odometry prediction if registration failed outright
    # or disagrees with it beyond the innovation gate.
    from ndtpu.slam.odometry import gate_poses
    pose, _ = gate_poses(res.pose, res.converged, init, cfg.odom_gate)

    last_kf_pose = state.graph.poses[state.last_kf_idx]
    diff = se2.between(last_kf_pose, pose)
    is_kf = ((jnp.linalg.norm(diff[:2]) > cfg.keyframe.dist_thresh)
             | (jnp.abs(diff[2]) > cfg.keyframe.angle_thresh))

    def kf_branch(st):
        return _keyframe_branch(st, pts, msk, pose, res.hessian, cfg)

    def no_kf(st):
        zero = jnp.asarray(0, jnp.int32)
        return st._replace(pose=pose), zero, zero, zero, zero

    new_state, n_new, n_drop, n_innov, take = jax.lax.cond(
        is_kf, kf_branch, no_kf, state)

    out = SlamStepOut(
        pose=new_state.pose,
        kf_idx=new_state.last_kf_idx,
        rel=se2.between(new_state.graph.poses[new_state.last_kf_idx],
                        new_state.pose),
        score=res.score,
        is_keyframe=is_kf,
        n_loops_new=n_new,
        n_dropped=n_drop,
        n_innov_rej=n_innov,
        local_take=take,
    )
    return new_state, out


#: Jit-compiled :func:`slam_step` (``cfg`` static). Use this for host-driven
#: per-scan loops — checkpoint/resume drivers, online serving — where calling
#: the un-jitted step would re-trace the whole graph every scan.
slam_step_jit = jax.jit(slam_step, static_argnames="cfg")


def run_slam(points, mask, odom, cfg: PipelineConfig, init_pose=None):
    """Full-sequence SLAM as one ``lax.scan`` (configs 2-3 entry point).

    points ``[T, N, 2]``, mask ``[T, N]``, odom ``[T, 3]`` relative deltas.
    Returns ``(final_state, SlamStepOut stacked over T-1 steps)``.
    """
    state0 = init_slam(cfg, points[0], mask[0], init_pose)

    def step(state, inp):
        pts, msk, delta = inp
        return slam_step(state, pts, msk, delta, cfg)

    return jax.lax.scan(step, state0, (points[1:], mask[1:], odom[1:]))


def _window_frontend(state: SlamState, last_kf_reg, pts, msk, deltas,
                     cfg: PipelineConfig, passes: int):
    """Batched registration of one window against the (refreshed) map.

    Returns ``(poses [W,3], MatchResult, is_kf [W])`` — see
    :func:`ndtpu.slam.odometry.run_odometry_windowed` for the pass/refresh
    rationale (map staleness costs ~4x ATE beyond W=4 without it).
    """
    from ndtpu.slam.odometry import chain_deltas, gate_poses, kf_select

    def kf_flags(lk, poses):
        is_kf, last_out = kf_select(lk, poses, cfg.keyframe.dist_thresh,
                                    cfg.keyframe.angle_thresh)
        return last_out, is_kf

    # Beam stride applies to pass 1 only: its poses are provisional (they
    # seed pass 2's map refresh and warm chain), so half-resolution is
    # enough; the final pass matches at full resolution — striding it too
    # measurably degrades the bistable sessions (ATE max 0.08 -> 0.19).
    stride = max(1, cfg.frontend_beam_stride)
    mpts, mmsk = (pts, msk) if stride == 1 else (pts[:, ::stride],
                                                 msk[:, ::stride])
    table = ndt_grid.pack_quad(ndt_grid.finalize(state.stats, cfg.ndt),
                               cfg.grid, compact=cfg.match.compact_table)
    inits = chain_deltas(state.pose, deltas)
    res = ndt_match.match_batch_packed(mpts, mmsk, table, inits, cfg.grid,
                                       cfg.match)
    poses, _ = gate_poses(res.pose, res.converged, inits, cfg.odom_gate)
    mcfg2 = cfg.match
    if cfg.pass2_max_iter > 0:
        import dataclasses
        mcfg2 = dataclasses.replace(cfg.match, max_iter=cfg.pass2_max_iter)
    for _ in range(max(0, passes - 1)):
        _, kf_prev = kf_flags(last_kf_reg, poses)
        tmp = ndt_grid.add_points(
            state.stats, se2.transform(poses, pts).reshape(-1, 2),
            (msk & kf_prev[:, None]).reshape(-1), cfg.grid)
        table = ndt_grid.pack_quad(ndt_grid.finalize(tmp, cfg.ndt), cfg.grid,
                                   compact=cfg.match.compact_table)
        if cfg.pass2_warm_start:
            inits2 = poses
        else:
            prev = jnp.concatenate([state.pose[None], poses[:-1]], axis=0)
            inits2 = se2.compose(prev, deltas)
        res = ndt_match.match_batch_packed(pts, msk, table, inits2,
                                           cfg.grid, mcfg2)
        poses, _ = gate_poses(res.pose, res.converged, inits2, cfg.odom_gate)
    _, is_kf = kf_flags(last_kf_reg, poses)
    return poses, res, is_kf


def _wb_appends(state: SlamState, last_kf_reg, poses, hessians, pts, msk,
                is_kf, cfg: PipelineConfig):
    """Window backend stage 1: keyframe/factor appends + loop detection.

    Fully vectorized — no per-scan sequential loop (each tiny carried op
    is a dependent step on the device): all of the window's
    keyframes are appended with ONE masked scatter per graph array (their
    slots are a cumsum over the keyframe flags, and the odometry chain
    telescopes, so every node value and between measurement is closed-form),
    loop detection runs as ONE batched dispatch over all W scans (masked to
    the actual keyframes).

    Odometry measurements are taken between REGISTRATION-TIME poses (so
    smoothing shifts never pollute relative measurements) while node values
    are anchored on the smoothed parent.

    Contains no ``lax.cond`` — safe to vmap over sessions at full speed.
    Returns ``(graph, kf, aux)`` with ``kf`` NOT yet pose-synced (that
    happens after smoothing).
    """
    dt = poses.dtype
    w = poses.shape[0]
    graph, kf = state.graph, state.kf
    cap_v = graph.capacity
    cap_f = graph.bet_mask.shape[0]
    big = jnp.asarray(1 << 30, jnp.int32)

    # --- keyframe slots: cum[i] = # keyframes among scans 0..i ------------
    cum = jnp.cumsum(is_kf.astype(jnp.int32))
    slot = graph.n_poses + cum - 1                               # [W]
    ok = is_kf & (slot < cap_v)                                  # capacity
    k_new = jnp.sum(ok, dtype=jnp.int32)

    # Registration-time pose of each scan's governing keyframe (itself if a
    # keyframe): running max of keyframe scan indices, -1 before the first.
    idx = jnp.arange(w)
    gov = jax.lax.cummax(jnp.where(ok, idx, -1))                 # [W]
    anchor_reg = jnp.where((gov >= 0)[:, None],
                           poses[jnp.maximum(gov, 0)], last_kf_reg)

    # Parent (previous keyframe) of each keyframe scan, for between factors.
    prev_gov = jnp.concatenate([jnp.asarray([-1]), gov[:-1]])
    parent_reg = jnp.where((prev_gov >= 0)[:, None],
                           poses[jnp.maximum(prev_gov, 0)], last_kf_reg)
    parent_idx = jnp.where(cum > 1, graph.n_poses + cum - 2,
                           state.last_kf_idx)                    # [W]

    # Node values: the odometry chain telescopes, so every new node hangs
    # off the smoothed anchor by its registration-time offset.
    anchor_node = graph.poses[state.last_kf_idx]
    node_vals = se2.compose(anchor_node[None, :],
                            se2.between(last_kf_reg[None, :], poses))
    z_odo = se2.between(parent_reg, poses)                       # [W, 3]
    sqrt_infos = jax.vmap(_odom_info_sqrt, in_axes=(0, None))(hessians, dt)

    # --- ONE masked scatter per array (mode='drop' kills dead rows) -------
    vslot = jnp.where(ok, slot, big)
    graph = graph._replace(
        poses=graph.poses.at[vslot].set(node_vals, mode="drop"),
        pose_mask=graph.pose_mask.at[vslot].set(True, mode="drop"),
        n_poses=graph.n_poses + k_new,
    )
    fslot = jnp.where(ok, graph.n_between + cum - 1, big)
    fok = ok & (graph.n_between + cum - 1 < cap_f)
    fslot = jnp.where(fok, fslot, big)
    graph = graph._replace(
        bet_i=graph.bet_i.at[fslot].set(parent_idx, mode="drop"),
        bet_j=graph.bet_j.at[fslot].set(slot, mode="drop"),
        bet_z=graph.bet_z.at[fslot].set(z_odo, mode="drop"),
        bet_sqrt_info=graph.bet_sqrt_info.at[fslot].set(sqrt_infos,
                                                        mode="drop"),
        bet_mask=graph.bet_mask.at[fslot].set(True, mode="drop"),
        n_between=graph.n_between + jnp.sum(fok, dtype=jnp.int32),
    )
    kslot = jnp.where(ok, kf.n + cum - 1, big)
    kf = kf._replace(
        poses=kf.poses.at[kslot].set(node_vals, mode="drop"),
        points=kf.points.at[kslot].set(pts, mode="drop"),
        masks=kf.masks.at[kslot].set(msk, mode="drop"),
        live=kf.live.at[kslot].set(True, mode="drop"),
        n=kf.n + k_new,
    )
    if cfg.use_loop_closure:
        # Cache each new keyframe's local quad table at creation (built
        # from its own scan in sensor frame — pose-independent, so loop
        # verification never rebuilds candidate maps; VERDICT r3 weak #1).
        tbls = jax.vmap(lambda p, m: closure.build_local_table(
            p, m, cfg.loop, cfg.ndt, cfg.match.compact_table))(pts, msk)
        kf = kf._replace(
            tables=kf.tables.at[kslot].set(tbls, mode="drop"))
    last_idx = jnp.where(k_new > 0, graph.n_poses - 1, state.last_kf_idx)
    lkr = anchor_reg[-1]

    # --- loop detection: ONE batched dispatch per window ------------------
    if cfg.use_loop_closure:
        # Batch over the first K actual keyframes of the window instead of
        # all W scan slots (only ~W/3 scans are keyframes; the vmapped
        # verification is the window's dominant cost in config 3).
        kmax = cfg.loop.max_detect_per_window or w
        kmax = min(kmax, w)
        ranks = jnp.arange(kmax)
        # sel[r] = scan index of the window's r-th keyframe (0 if absent).
        hit = (cum[None, :] - 1 == ranks[:, None]) & ok[None, :]  # [K, W]
        sel = jnp.argmax(hit, axis=1)
        has = jnp.any(hit, axis=1)
        slot_k = slot[sel]
        do = has & (slot_k % cfg.loop.detect_every == 0)
        # One flat K*C-lane verification program (per-lane cached tables)
        # instead of a vmap of per-query C-lane verifications — the loop
        # verify is the window's dominant config-3 cost, and the flat
        # batch lets the LM straggler compaction work across all lanes.
        loops = closure.detect_loops_cached_flat(
            kf, pts[sel], msk[sel], node_vals[sel], slot_k,
            cfg.loop, cfg.match)
        accept = loops.accept & do[:, None]                      # [K, C]
        acc_flat = accept.reshape(-1)
        cumf = jnp.cumsum(acc_flat.astype(jnp.int32))
        lslot = graph.n_between + cumf - 1
        lok = acc_flat & (lslot < cap_f)
        lslot = jnp.where(lok, lslot, big)
        jflat = loops.j.reshape(-1)
        iflat = jnp.broadcast_to(slot_k[:, None], accept.shape).reshape(-1)
        graph = graph._replace(
            bet_i=graph.bet_i.at[lslot].set(jflat, mode="drop"),
            bet_j=graph.bet_j.at[lslot].set(iflat, mode="drop"),
            bet_z=graph.bet_z.at[lslot].set(loops.z.reshape(-1, 3),
                                            mode="drop"),
            bet_sqrt_info=graph.bet_sqrt_info.at[lslot].set(
                loops.sqrt_info.reshape(-1, 3, 3), mode="drop"),
            bet_mask=graph.bet_mask.at[lslot].set(True, mode="drop"),
            n_between=graph.n_between + jnp.sum(lok, dtype=jnp.int32),
        )
        # Count from `lok` (factors that actually landed), not `accept`:
        # when the factor array is full, accept-based counting overstates
        # appended loops and triggers the expensive full-map rebuild for
        # factors that never entered the graph (ADVICE r3).
        nl_rank = jnp.sum(lok.reshape(accept.shape), axis=1,
                          dtype=jnp.int32)                       # [K]
        nl_out = jnp.zeros((w,), jnp.int32).at[sel].add(
            jnp.where(has, nl_rank, 0))                          # [W]
        # Loop factors accepted but dropped by factor capacity.
        ld_rank = jnp.sum((acc_flat & ~lok).reshape(accept.shape),
                          axis=1, dtype=jnp.int32)               # [K]
        ld_out = jnp.zeros((w,), jnp.int32).at[sel].add(
            jnp.where(has, ld_rank, 0))                          # [W]
        # Innovation-budget rejections among this window's queries.
        ni_rank = jnp.sum(loops.innov_rej & do[:, None], axis=1,
                          dtype=jnp.int32)                       # [K]
        ni_out = jnp.zeros((w,), jnp.int32).at[sel].add(
            jnp.where(has, ni_rank, 0))                          # [W]
    else:
        nl_out = jnp.zeros((w,), jnp.int32)
        ld_out = jnp.zeros((w,), jnp.int32)
        ni_out = jnp.zeros((w,), jnp.int32)

    # Capacity-saturation counters per scan (VERDICT r3 weak 6): keyframes
    # dropped by pose capacity + odometry factors dropped by factor
    # capacity + capacity-dropped loop factors.
    nd_out = ((is_kf & ~ok).astype(jnp.int32)
              + (ok & ~fok).astype(jnp.int32) + ld_out)          # [W]

    # Anchor index per scan: the last APPENDED keyframe at-or-before it
    # (cum over `ok`, not `is_kf` — capacity-dropped keyframes must not be
    # referenced; anchor_reg above is already `ok`-based via gov).
    cum_ok = jnp.cumsum(ok.astype(jnp.int32))
    kf_idx_out = jnp.where(cum_ok > 0, state.graph.n_poses + cum_ok - 1,
                           state.last_kf_idx)
    rel_out = se2.between(anchor_reg, poses)

    aux = dict(kslot=kslot, last_idx=last_idx, lkr=lkr,
               any_kf=jnp.any(is_kf),
               n_loops_new=jnp.sum(nl_out, dtype=jnp.int32),
               kf_idx_out=kf_idx_out, rel_out=rel_out,
               nl_out=nl_out, nd_out=nd_out, ni_out=ni_out)
    return graph, kf, aux


def _wb_smooth(state: SlamState, graph, any_kf, cfg: PipelineConfig):
    """Window backend stage 2: one smoothing pass per window (iSAM2-update
    cadence at window grain). Returns ``(SmootherState, take_code)``."""
    sm = inc.SmootherState(graph=graph, lam=state.sm_lam,
                           last_max_delta=state.sm_last_delta,
                           step=state.sm_step)
    return jax.lax.cond(
        any_kf, lambda s: inc.incremental_update(
            s, cfg.solver, huber_delta=cfg.solver.huber_delta,
            fresh_since=state.graph.n_between, return_take=True),
        lambda s: (s, jnp.asarray(0, jnp.int32)),
        sm)


def _wb_extend(state: SlamState, poses, pts, msk, is_kf, kslot,
               cfg: PipelineConfig):
    """Always-run part of map maintenance: insert this window's keyframe
    scans at their registration-time poses. Returns ``(stats, mkp)``."""
    mkp = state.map_kf_poses.at[kslot].set(poses, mode="drop")
    wpts = se2.transform(poses, pts)
    stats = ndt_grid.add_points(state.stats, wpts.reshape(-1, 2),
                                (msk & is_kf[:, None]).reshape(-1),
                                cfg.grid)
    return stats, mkp


def _wb_maps(state: SlamState, kf, poses, pts, msk, is_kf, kslot,
             n_loops_new, sm_step, any_kf, cfg: PipelineConfig):
    """Window backend stage 3: map maintenance. Always extend with this
    window's keyframe scans at their registration-time insert poses, then
    incrementally re-place the stalest keyframes (refresh_top_m > 0) — or,
    legacy mode, rebuild the whole map whenever a loop factor landed
    (refresh_top_m = 0). ``kf`` must already be pose-synced."""

    def rebuild(arg):
        world = se2.transform(kf.poses, kf.points)
        m = kf.masks & kf.live[:, None]
        return ndt_grid.build_stats(world.reshape(-1, 2), m.reshape(-1),
                                    cfg.grid), kf.poses

    def extend(_):
        return _wb_extend(state, poses, pts, msk, is_kf, kslot, cfg)

    if cfg.refresh_top_m > 0:
        # Same TRIGGER as the legacy full rebuild (a loop factor landed —
        # empirically the only safe cadence: refreshing on a shift
        # threshold, every window, or never all diverge on the 1000-scan
        # multilap), but the re-render only touches the keyframes that
        # MOVED: unmoved ones already sit at their current pose in the map,
        # so top-M refresh with M >= #moved is exactly the rebuild at a
        # fraction of the scatter cost.
        stats0, mkp0 = extend(None)

        def refresh(arg):
            s, m = arg
            return _refresh_map(s, kf, m, cfg)

        trigger = (jnp.asarray(True) if cfg.refresh_always
                   else n_loops_new > 0)
        stats, mkp = jax.lax.cond(trigger, refresh,
                                  lambda a: a, (stats0, mkp0))
        if cfg.full_rebuild_every > 0:
            # Periodic full rebuild squashes the f32 subtract/re-add
            # residue and any staleness beyond the top-M budget.
            do_rb = (sm_step % cfg.full_rebuild_every
                     == cfg.full_rebuild_every - 1) & any_kf
            stats, mkp = jax.lax.cond(do_rb, rebuild,
                                      lambda _: (stats, mkp), (stats, mkp))
    else:
        stats, mkp = jax.lax.cond(n_loops_new > 0, rebuild, extend, None)
    return stats, mkp


def _window_backend(state: SlamState, last_kf_reg, poses, hessians, pts, msk,
                    is_kf, cfg: PipelineConfig):
    """Graph/keyframe/loop work for one registered window (in-graph):
    appends + detection (:func:`_wb_appends`), smoothing
    (:func:`_wb_smooth`), map maintenance (:func:`_wb_maps`).

    Returns ``(new_state, last_kf_reg, kf_idx [W], rel [W,3], nl [W],
    nd [W], ni [W], take)``.
    """
    graph, kf, aux = _wb_appends(state, last_kf_reg, poses, hessians, pts,
                                 msk, is_kf, cfg)
    sm, take = _wb_smooth(state, graph, aux["any_kf"], cfg)
    graph = sm.graph
    kf = kf._replace(poses=graph.poses[: kf.capacity])
    stats, mkp = _wb_maps(state, kf, poses, pts, msk, is_kf, aux["kslot"],
                          aux["n_loops_new"], sm.step, aux["any_kf"], cfg)

    # Current estimate: smoothed latest keyframe + registration-time offset.
    last_idx, lkr = aux["last_idx"], aux["lkr"]
    pose_out = se2.compose(graph.poses[last_idx], se2.between(lkr, poses[-1]))

    new_state = SlamState(
        stats=stats, kf=kf, graph=graph, sm_lam=sm.lam,
        sm_last_delta=sm.last_max_delta, sm_step=sm.step, pose=pose_out,
        last_kf_idx=last_idx, n_loops=state.n_loops + aux["n_loops_new"],
        map_kf_poses=mkp,
    )
    return (new_state, lkr, aux["kf_idx_out"], aux["rel_out"],
            aux["nl_out"], aux["nd_out"], aux["ni_out"], take)


def slam_window_step(state: SlamState, last_kf_reg, pts, msk, deltas,
                     cfg: PipelineConfig):
    """Process one window of W scans (registration + backend). Jittable.

    The unit of the windowed pipeline: ``run_slam_windowed`` scans over it;
    host-driven runners (checkpoint/resume, online serving) jit it once and
    loop windows on the host — window-granular checkpoints at full speed
    (``slam_window_step_jit``).

    Returns ``((state, last_kf_reg), SlamStepOut stacked over W scans)``.
    """
    poses, res, is_kf = _window_frontend(state, last_kf_reg, pts, msk,
                                         deltas, cfg, cfg.window_passes)
    state, last_kf_reg, kf_idx, rel, nl, nd, ni, take = _window_backend(
        state, last_kf_reg, poses, res.hessian, pts, msk, is_kf, cfg)
    w = poses.shape[0]
    out = SlamStepOut(pose=poses, kf_idx=kf_idx, rel=rel,
                      score=res.score, is_keyframe=is_kf, n_loops_new=nl,
                      n_dropped=nd, n_innov_rej=ni,
                      local_take=jnp.broadcast_to(take, (w,)))
    return (state, last_kf_reg), out


#: Jit-compiled :func:`slam_window_step` (``cfg`` static) for host-driven
#: window loops.
slam_window_step_jit = jax.jit(slam_window_step, static_argnames="cfg")


def run_slam_windowed(points, mask, odom, cfg: PipelineConfig,
                      init_pose=None):
    """Window-batched full SLAM (configs 2-3, the fast entry point).

    Same capability as :func:`run_slam` — odometry, keyframing, loop
    closure, incremental smoothing, online map — restructured so the chip
    sees W-wide batched registrations instead of single scans
    (the per-scan path is latency-bound: one small dependent step per
    scan).
    Registration happens in :func:`_window_frontend` (one/two batched LM
    dispatches per window), graph work in :func:`_window_backend`.

    Returns ``(final SlamState, SlamStepOut stacked over T-1 scans)`` —
    interchangeable with :func:`run_slam` for ATE evaluation via
    :func:`recover_trajectory`.
    """
    from ndtpu.slam.odometry import _pad_to_windows

    state0 = init_slam(cfg, points[0], mask[0], init_pose)
    w = cfg.window

    pts_w, msk_w, odo_w, n_win, _ = _pad_to_windows(
        points[1:], mask[1:], odom[1:], w)
    pts_w = pts_w.reshape(n_win, w, *pts_w.shape[1:])
    msk_w = msk_w.reshape(n_win, w, *msk_w.shape[1:])
    odo_w = odo_w.reshape(n_win, w, 3)

    def wstep(carry, inp):
        state, last_kf_reg = carry
        pts, msk, deltas = inp
        return slam_window_step(state, last_kf_reg, pts, msk, deltas, cfg)

    carry0 = (state0, state0.pose)
    (state, _), outs = jax.lax.scan(wstep, carry0, (pts_w, msk_w, odo_w))

    t_steps = points.shape[0] - 1
    outs = jax.tree_util.tree_map(
        lambda a: a.reshape((n_win * w,) + a.shape[2:])[:t_steps], outs)
    return state, outs


def recover_trajectory(state: SlamState, outs: SlamStepOut, init_pose=None):
    """Final per-scan trajectory: re-anchor each scan on its keyframe's
    *smoothed* pose (loop corrections propagate to every scan).

    Returns ``[T, 3]`` including scan 0.
    """
    anchors = state.graph.poses[outs.kf_idx]            # [T-1, 3]
    poses = se2.compose(anchors, outs.rel)
    p0 = state.graph.poses[0] if init_pose is None else init_pose
    return jnp.concatenate([p0[None].astype(poses.dtype), poses], axis=0)
