"""Map-maintenance correctness: half-cell builder, incremental refresh,
cached loop tables (round-4 config-3 work; PERF.md)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ndtpu.config import (GridConfig, KeyframeConfig, LoopConfig, MatchConfig,
                          NDTMapConfig, PipelineConfig)
from ndtpu.data import synth
from ndtpu.lie import se2
from ndtpu.loop import closure
from ndtpu.ndt import grid as ndt_grid
from ndtpu.slam import keyframes as kfs
from ndtpu.slam import pipeline

GRID = GridConfig(x0=-14.0, y0=-14.0, cell=0.5, nx=56, ny=56, overlap=4)


def test_halfcell_add_points_matches_pergrid_path():
    """The overlap=4 half-cell scatter must agree with the general per-grid
    path (same moments per cell; boundary points may only differ where the
    point sits within one ulp of a cell edge — none in random data)."""
    rng = np.random.default_rng(0)
    pts = jnp.asarray(rng.uniform(-13, 13, (4096, 2)), jnp.float32)
    msk = jnp.asarray(rng.random(4096) > 0.1)
    got = ndt_grid.build_stats(pts, msk, GRID)

    # Reference: force the general path via a 1-overlap grid per shift.
    h = GRID.cell / 2.0
    for g, (ox, oy) in enumerate([(0.0, 0.0), (h, 0.0), (0.0, h), (h, h)]):
        ref_grid = GridConfig(x0=GRID.x0 + ox, y0=GRID.y0 + oy,
                              cell=GRID.cell, nx=GRID.nx, ny=GRID.ny,
                              overlap=1)
        ref = ndt_grid.build_stats(pts, msk, ref_grid)
        np.testing.assert_allclose(np.asarray(got.n[g]), np.asarray(ref.n[0]),
                                   atol=0)
        np.testing.assert_allclose(np.asarray(got.s[g]), np.asarray(ref.s[0]),
                                   rtol=1e-6, atol=1e-4)
        np.testing.assert_allclose(np.asarray(got.ss[g]),
                                   np.asarray(ref.ss[0]),
                                   rtol=1e-5, atol=1e-3)


def test_add_points_negative_weight_subtracts_exactly():
    """weight=-1 must cancel a previous add bit-for-bit on counts and to
    f32-residue level on moments (the incremental-refresh contract)."""
    rng = np.random.default_rng(1)
    a = jnp.asarray(rng.uniform(-10, 10, (512, 2)), jnp.float32)
    b = jnp.asarray(rng.uniform(-10, 10, (512, 2)), jnp.float32)
    m = jnp.ones((512,), bool)
    stats = ndt_grid.build_stats(a, m, GRID)
    stats = ndt_grid.add_points(stats, b, m, GRID)
    stats = ndt_grid.add_points(stats, b, m, GRID, weight=-1.0)
    ref = ndt_grid.build_stats(a, m, GRID)
    np.testing.assert_array_equal(np.asarray(stats.n), np.asarray(ref.n))
    np.testing.assert_allclose(np.asarray(stats.s), np.asarray(ref.s),
                               atol=2e-3)
    np.testing.assert_allclose(np.asarray(stats.ss), np.asarray(ref.ss),
                               atol=2e-2)


def test_refresh_map_equals_rebuild():
    """Top-M refresh with M >= #moved must reproduce the full rebuild."""
    rng = np.random.default_rng(2)
    cap, n = 32, 120
    pts = jnp.asarray(rng.uniform(-5, 5, (cap, n, 2)), jnp.float32)
    poses_ins = jnp.asarray(rng.uniform(-2, 2, (cap, 3)), jnp.float32)
    live_k = 24
    stats = ndt_grid.empty_stats(GRID, jnp.float32)
    for j in range(live_k):
        stats = ndt_grid.add_points(
            stats, se2.transform(poses_ins[j], pts[j]),
            jnp.ones((n,), bool), GRID)
    move = (jnp.asarray(rng.normal(0, 0.3, (live_k, 3)), jnp.float32)
            * (jnp.arange(live_k)[:, None] % 3 == 0))
    poses_new = poses_ins.at[:live_k].add(move)
    kf = kfs.empty_store(cap, n, jnp.float32)._replace(
        points=pts, poses=poses_new, masks=jnp.ones((cap, n), bool),
        live=jnp.arange(cap) < live_k, n=jnp.asarray(live_k, jnp.int32))
    cfg = PipelineConfig(grid=GRID, refresh_top_m=16, refresh_eps=0.0)
    stats_r, mkp_r = pipeline._refresh_map(stats, kf, poses_ins, cfg)
    world = se2.transform(kf.poses, kf.points)
    m = kf.masks & kf.live[:, None]
    ref = ndt_grid.build_stats(world.reshape(-1, 2), m.reshape(-1), GRID)
    np.testing.assert_allclose(np.asarray(stats_r.n), np.asarray(ref.n),
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(stats_r.s), np.asarray(ref.s),
                               atol=1e-3)
    np.testing.assert_array_equal(
        np.asarray(mkp_r[:live_k]), np.asarray(kf.poses[:live_k]))


def _loop_setup():
    # 100 scans x 0.35 m around a 28 m rectangle: scan ~85+ revisits the
    # first keyframes' territory (a real loop for candidate generation).
    world = synth.box_world(half=11.0)
    traj = synth.rectangle_trajectory(100, half=3.5, step=0.35)
    seq = synth.make_sequence(world, traj, n_beams=180, max_range=20.0,
                              min_range=0.1, seed=3)
    loop_cfg = LoopConfig(radius=4.0, min_index_gap=8, max_candidates=4,
                          local_half_extent=8.0)
    ncfg, mcfg = NDTMapConfig(), MatchConfig()
    tshape = closure.local_table_shape(loop_cfg, mcfg.compact_table)
    kf = kfs.empty_store(60, 180, jnp.float32, table_shape=tshape)
    for t in range(0, 100, 2):
        tbl = closure.build_local_table(seq.points[t], seq.mask[t], loop_cfg,
                                        ncfg, mcfg.compact_table)
        kf = kfs.add_keyframe(kf, seq.gt_poses[t], seq.points[t], seq.mask[t],
                              table=tbl)
    return seq, loop_cfg, ncfg, mcfg, kf


def test_cached_loop_verification_matches_fresh():
    """Cached-table verification must find the same loops as the fresh path
    (built per query) and measure the same relative pose to mm level.

    Difference by construction: the cached map holds only the candidate's
    own scan (fresh aggregates ±1 neighbors), so scores differ slightly;
    accepted measurements must still agree.
    """
    seq, loop_cfg, ncfg, mcfg, kf = _loop_setup()
    q = 90
    qidx = jnp.asarray(45, jnp.int32)
    qpose = seq.gt_poses[q] + jnp.asarray([0.05, -0.04, 0.01], jnp.float32)
    fresh = closure.detect_loops(kf, seq.points[q], seq.mask[q], qpose,
                                 qidx, loop_cfg, ncfg, mcfg, window=0)
    cached = closure.detect_loops_cached(kf, seq.points[q], seq.mask[q],
                                         qpose, qidx, loop_cfg, mcfg)
    assert bool(jnp.any(cached.accept)), "cached path accepted no loops"
    both = np.asarray(fresh.accept & cached.accept)
    assert both.any(), (np.asarray(fresh.accept), np.asarray(cached.accept))
    dz = np.asarray(jnp.abs(fresh.z - cached.z))[both]
    assert dz.max() < 5e-3, dz


def test_pipeline_windowed_loops_still_fire_with_cache():
    """End-to-end windowed run: the cached path must close loops and beat
    the no-loop ATE (SURVEY.md §5 item 3)."""
    from ndtpu.eval.ate import ate_rmse
    world = synth.box_world(half=11.0)
    # 140 x 0.25 m = 35 m over a 28 m rectangle: the tail revisits the start.
    traj = synth.rectangle_trajectory(140, half=3.5, step=0.25)
    seq = synth.make_sequence(world, traj, n_beams=180, max_range=20.0,
                              min_range=0.1, seed=5, odom_trans_std=0.05,
                              odom_rot_std=0.012)
    cfg = PipelineConfig(
        grid=GridConfig(x0=-14.0, y0=-14.0, cell=0.5, nx=56, ny=56,
                        overlap=4),
        keyframe=KeyframeConfig(dist_thresh=0.5, angle_thresh=0.3,
                                capacity=128),
        loop=LoopConfig(radius=3.0, min_index_gap=10, max_candidates=4,
                        local_half_extent=8.0),
        n_beams=180, use_loop_closure=True, window=8, window_passes=2)
    st, outs = pipeline.run_slam_windowed(seq.points, seq.mask, seq.odom, cfg)
    ate = float(ate_rmse(pipeline.recover_trajectory(st, outs),
                         seq.gt_poses))
    assert int(st.n_loops) > 0
    assert ate < 0.15, ate


def test_corridor_reentry_recall_cached_vs_fresh():
    """Killian-shaped corridor recall (VERDICT r5 task 5): the r4 cached
    tables hold only the candidate's OWN scan (vs the fresh path's
    ±1-neighbor densified local maps) — the one semantic difference the
    cache introduced. On corridor geometry, where odometry drifts along
    the weakly-constrained axis before re-entry, assert (a) the cached
    pipeline still fires loops at re-entry and collapses the drift, and
    (b) per re-entry query, cached-path loop recall matches the fresh
    window=1 path on identical candidates."""
    import dataclasses

    from ndtpu.config import (GridConfig, KeyframeConfig, LoopConfig,
                              MatchConfig, PipelineConfig, SolverConfig)
    from ndtpu.data import synth
    from ndtpu.eval.ate import ate_rmse
    from ndtpu.loop import closure
    from ndtpu.slam import pipeline
    from ndtpu.slam.odometry import run_odometry_windowed

    cfg = PipelineConfig(
        grid=GridConfig(x0=-12.0, y0=-12.0, cell=0.5, nx=48, ny=48,
                        overlap=4),
        keyframe=KeyframeConfig(dist_thresh=0.6, angle_thresh=0.3,
                                capacity=256),
        loop=LoopConfig(radius=3.0, min_index_gap=12, max_candidates=4,
                        local_half_extent=8.0),
        solver=SolverConfig(inc_iters=2, pcg_max_iter=40),
        n_beams=180, max_range=16.0, window=8, window_passes=2,
        use_loop_closure=True)
    world = synth.corridor_loop_world(outer=10.0, width=4.0)
    # One full lap (perimeter 64 m) + re-entry stretch, noisy odometry so
    # drift accumulates along the corridor before the loop closes.
    traj = synth.rectangle_trajectory(190, half=8.0, step=0.4)
    seq = synth.make_sequence(world, traj, n_beams=180, max_range=16.0,
                              min_range=0.1, seed=13, odom_trans_std=0.06,
                              odom_rot_std=0.012)

    st, outs = jax.jit(lambda p, m, o: pipeline.run_slam_windowed(
        p, m, o, cfg))(seq.points, seq.mask, seq.odom)
    ate = float(ate_rmse(pipeline.recover_trajectory(st, outs),
                         seq.gt_poses))
    n_loops = int(st.n_loops)

    odo = run_odometry_windowed(seq.points, seq.mask, seq.odom, cfg.grid,
                                cfg.ndt, cfg.match, cfg.keyframe,
                                window=8, passes=2)
    ate_odo = float(ate_rmse(odo.poses, seq.gt_poses))
    assert n_loops > 0, "no loops fired at corridor re-entry"
    assert ate < 0.6 * ate_odo, (ate, ate_odo)

    # (b) recall parity on the re-entry keyframes, identical candidates.
    kf = st.kf
    n_kf = int(kf.n)
    q_idx = jnp.arange(max(0, n_kf - 8), n_kf, dtype=jnp.int32)
    cands = jax.vmap(closure.find_candidates, in_axes=(None, 0, 0, None))(
        kf, kf.poses[q_idx], q_idx, cfg.loop)
    cached = closure.verify_candidates_cached_flat(
        kf, kf.points[q_idx], kf.masks[q_idx], kf.poses[q_idx], cands,
        cfg.loop, cfg.match, query_index=q_idx)
    fresh = jax.vmap(
        lambda p, m, qp, cd, qi: closure.verify_candidates(
            kf, p, m, qp, cd, cfg.loop, cfg.ndt, cfg.match, window=1,
            query_index=qi)
    )(kf.points[q_idx], kf.masks[q_idx], kf.poses[q_idx], cands, q_idx)
    hit_cached = np.asarray(jnp.any(cached.accept, axis=1))
    hit_fresh = np.asarray(jnp.any(fresh.accept, axis=1))
    # Per-query recall: wherever the fresh densified path finds a loop,
    # the cached own-scan path must too (equality both ways would forbid
    # the cache ever being *better*, which it can be at the score gate).
    assert int(hit_cached.sum()) >= int(hit_fresh.sum()) - 1, (
        hit_cached.tolist(), hit_fresh.tolist())
    assert hit_cached.sum() > 0
