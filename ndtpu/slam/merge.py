"""Multi-session / multi-robot map merging (BASELINE config 5).

Capability: two SLAM sessions with unknown relative transform are merged
into one map + one pose graph:

1. **Global alignment** — batched brute force: a dense grid of candidate
   relative poses (translations x headings) is scored against the target
   session's NDT map in ONE batched call (every hypothesis is a lane of
   ``match_batch``), then the best hypothesis is refined by full LM
   registration. No feature extraction, no host loop — the search is one
   compiled program instead of the reference's sequential candidate
   testing.
2. **Graph fusion** — session B's poses/factors append to A's graph with an
   index offset; verified alignments become inter-session between factors;
   a joint optimization ties the sessions together.
3. **Map fusion** — the merged NDT statistics are rebuilt from both
   sessions' keyframe scans at their fused poses (one segment_sum); at
   scale this build shards over grid slabs (ndtpu.dist.gridmap).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ndtpu.config import (GridConfig, LoopConfig, MatchConfig, NDTMapConfig,
                          SolverConfig)
from ndtpu.graph import factors as fct
from ndtpu.graph import solve as slv
from ndtpu.lie import se2
from ndtpu.ndt import grid as ndt_grid
from ndtpu.ndt import match as ndt_match
from ndtpu.slam.keyframes import KeyframeStore

__all__ = ["AlignResult", "global_align", "find_inter_session_loops",
           "merge_graphs", "merged_map_stats"]


class AlignResult(NamedTuple):
    transform: jax.Array   # [3] pose of session B's frame in A's frame
    score: jax.Array       # [] refined NDT score
    converged: jax.Array   # [] bool
    grid_scores: jax.Array  # [H] coarse scores of every hypothesis


def _hypothesis_grid(span: float, step: float, n_theta: int, dtype):
    xs = jnp.arange(-span, span + step / 2, step, dtype=dtype)
    th = jnp.linspace(-jnp.pi, jnp.pi, n_theta, endpoint=False).astype(dtype)
    gx, gy, gt = jnp.meshgrid(xs, xs, th, indexing="ij")
    return jnp.stack([gx.reshape(-1), gy.reshape(-1), gt.reshape(-1)],
                     axis=-1)                                     # [H, 3]


def global_align(map_a: ndt_grid.NDTMap, grid_a: GridConfig, probe_points,
                 probe_mask, span: float = 8.0, step: float = 1.0,
                 n_theta: int = 16, match_cfg: MatchConfig | None = None,
                 coarse_iters: int = 5, top_k: int = 64) -> AlignResult:
    """Find the pose of a probe scan (session B frame) in map A.

    Note: ``match_cfg.reject_tol`` is always overridden to 1e-3 here — the
    throughput-tuned default (3e-3) can stop a refinement one iteration
    early and hand the win to a pi-flipped alias in symmetric rooms; a
    caller-supplied value for that one field is intentionally ignored.

    probe_points ``[N, 2]``: a representative scan of session B expressed in
    B's base frame (e.g. keyframe 0's scan). All ``H = (2*span/step+1)^2 *
    n_theta`` hypotheses run a short coarse LM in one batch; the ``top_k``
    coarse scorers are then refined with the full iteration budget (still
    batched) and the best *refined* score wins — a coarse-score argmax alone
    aliases under environment symmetry (a square room matches itself at
    90-degree rotations until the fine basin disambiguates).
    """
    # Hypothesis testing needs the fine reject_tol: the throughput-tuned
    # default (3e-3) can stop a refinement one iteration early and hand the
    # win to a pi-flipped alias in symmetric rooms (see MatchConfig).
    import dataclasses
    mcfg = dataclasses.replace(match_cfg or MatchConfig(), reject_tol=1e-3)
    dtype = probe_points.dtype
    hyp = _hypothesis_grid(span, step, n_theta, dtype)             # [H, 3]
    h = hyp.shape[0]

    coarse_cfg = MatchConfig(
        max_iter=coarse_iters, tol=mcfg.tol, d2=mcfg.d2, reject_tol=1e-3,
        init_lambda=mcfg.init_lambda, step_clip=mcfg.step_clip)
    pts = jnp.broadcast_to(probe_points, (h,) + probe_points.shape)
    msk = jnp.broadcast_to(probe_mask, (h,) + probe_mask.shape)
    coarse = ndt_match.match_batch(pts, msk, map_a, hyp, grid_a, coarse_cfg)

    # Rank hypotheses by TOTAL matched mass (sum of per-point scores), not
    # the matcher's mean-over-matched-points score: an aliased pose that
    # throws half the scan off-map gets graded only on the easy half under
    # the mean, while total mass rewards alignment quality AND coverage.
    def total_mass(pose):
        f, _, _, _ = ndt_match.score_grad_hess(pose, probe_points, probe_mask,
                                               map_a, grid_a, mcfg)
        return -f

    mass_c = jax.vmap(total_mass)(coarse.pose)
    k = min(top_k, h)
    _, best_idx = jax.lax.top_k(mass_c, k)
    pts_k = jnp.broadcast_to(probe_points, (k,) + probe_points.shape)
    msk_k = jnp.broadcast_to(probe_mask, (k,) + probe_mask.shape)
    refined = ndt_match.match_batch(pts_k, msk_k, map_a,
                                    coarse.pose[best_idx], grid_a, mcfg)
    mass_r = jax.vmap(total_mass)(refined.pose)
    best = jnp.argmax(jnp.where(refined.converged, mass_r, -1.0))
    return AlignResult(transform=refined.pose[best],
                       score=refined.score[best],
                       converged=refined.converged[best],
                       grid_scores=mass_c)


def find_inter_session_loops(kf_a: KeyframeStore, kf_b: KeyframeStore,
                             t_ab, loop_cfg: LoopConfig,
                             match_cfg: MatchConfig,
                             max_queries: int = 64,
                             candidates_per_query: int = 4,
                             innovation_budget: float = 2.0,
                             ndt_cfg: NDTMapConfig | None = None):
    """Generate inter-session loop factors after :func:`global_align`
    (VERDICT r5 task 2: a merged map whose sessions share long overlap
    should be tied by MANY cross-session constraints, not one anchor).

    Queries = up to ``max_queries`` evenly-spaced live keyframes of
    session B, placed into A's frame by ``t_ab``; candidates = the nearest
    live A keyframes within ``loop_cfg.radius`` of each query (no
    index-gap test — the sessions are distinct trajectories). Every
    (query, candidate) pair is verified by the same flat cached-table
    batched NDT registration the in-session detector uses
    (:func:`ndtpu.loop.closure.verify_candidates_cached_flat`), with the
    same score/convergence gates and a FLAT innovation budget
    (``innovation_budget``, the global-alignment + session-drift
    allowance — the per-keyframe drift model is meaningless across
    sessions).

    Returns ``(i_a [L], j_b [L], z [L, 3], sqrt_info [L, 3, 3])`` numpy
    arrays of the accepted factors (possibly empty), in the
    ``merge_graphs(inter_factors=...)`` convention: ``z`` is the measured
    pose of B-keyframe ``j_b``'s scan in A-keyframe ``i_a``'s frame.
    This is a host-side merge-time operation (dynamic output size is
    fine); the verification itself is one compiled batched program.
    """
    import dataclasses

    import numpy as np

    from ndtpu.loop.closure import (LoopCandidates, build_local_table,
                                    verify_candidates_cached_flat)

    if kf_a.tables is None:
        # Session A ran without in-session loop closure: build its local
        # tables once at merge time (one vmapped batch).
        tbls = jax.vmap(lambda p, m: build_local_table(
            p, m, loop_cfg, ndt_cfg or NDTMapConfig(),
            match_cfg.compact_table))(kf_a.points, kf_a.masks)
        kf_a = kf_a._replace(tables=tbls)

    live_b = np.flatnonzero(np.asarray(kf_b.live))
    if live_b.size == 0:
        z3 = np.zeros((0, 3)), np.zeros((0, 3, 3))
        return (np.zeros((0,), np.int32), np.zeros((0,), np.int32)) + z3
    if live_b.size > max_queries:
        sel = live_b[np.linspace(0, live_b.size - 1, max_queries)
                     .round().astype(int)]
    else:
        sel = live_b
    sel = jnp.asarray(sel, jnp.int32)                          # [K]
    dtype = kf_b.poses.dtype
    poses_q = se2.compose(
        jnp.broadcast_to(jnp.asarray(t_ab, dtype), (sel.shape[0], 3)),
        kf_b.poses[sel])                                       # [K, 3] in A

    # Nearest live A keyframes within radius (cross-session: no gap test).
    d = jnp.linalg.norm(kf_a.poses[None, :, :2] - poses_q[:, None, :2],
                        axis=-1)                               # [K, capA]
    okc = kf_a.live[None, :] & (d <= loop_cfg.radius)
    dm = jnp.where(okc, d, jnp.inf)
    c = min(candidates_per_query, kf_a.capacity)
    neg_d, idx = jax.lax.top_k(-dm, c)
    cands = LoopCandidates(idx=idx.astype(jnp.int32),
                           mask=jnp.isfinite(-neg_d), dist=-neg_d)

    # Flat budget: base = innovation_budget, per-kf term ~0 (gap values
    # are meaningless across sessions).
    cfg2 = dataclasses.replace(loop_cfg,
                               max_innovation_base=innovation_budget,
                               max_innovation_per_kf=1e-12)
    loops = verify_candidates_cached_flat(
        kf_a, kf_b.points[sel], kf_b.masks[sel], poses_q, cands, cfg2,
        match_cfg, query_index=jnp.zeros_like(sel))            # [K, C] fields

    acc = np.asarray(loops.accept)
    ki, ci = np.nonzero(acc)
    i_a = np.asarray(loops.j)[ki, ci].astype(np.int32)
    j_b = np.asarray(sel)[ki].astype(np.int32)
    z = np.asarray(loops.z)[ki, ci]
    sq = np.asarray(loops.sqrt_info)[ki, ci]
    return i_a, j_b, z, sq


def merge_graphs(ga: fct.PoseGraph, gb: fct.PoseGraph, t_ab,
                 inter_factors=None, dtype=None) -> fct.PoseGraph:
    """Fuse two pose graphs: B's poses move into A's frame via ``t_ab`` and
    its variables/factors append with an index offset.

    ``inter_factors``: optional ``(i_a [K], j_b [K], z [K, 3],
    sqrt_info [K, 3, 3])`` inter-session constraints (j_b in B's indexing).
    Capacities add; the result is a normal PoseGraph for any solver.
    """
    dtype = dtype or ga.poses.dtype
    va, vb = ga.capacity, gb.capacity
    na = va  # storage offset: arrays concatenate at full capacity
    pa, pb = ga.prior_mask.shape[0], gb.prior_mask.shape[0]
    fa, fb = ga.bet_mask.shape[0], gb.bet_mask.shape[0]
    k = 0 if inter_factors is None else inter_factors[0].shape[0]

    poses_b = se2.compose(jnp.broadcast_to(jnp.asarray(t_ab, dtype), (vb, 3)),
                          gb.poses)
    g = fct.PoseGraph(
        poses=jnp.concatenate([ga.poses, poses_b]),
        pose_mask=jnp.concatenate([ga.pose_mask, gb.pose_mask]),
        prior_idx=jnp.concatenate([ga.prior_idx, gb.prior_idx + na]),
        prior_z=jnp.concatenate([
            ga.prior_z,
            se2.compose(jnp.broadcast_to(jnp.asarray(t_ab, dtype), (pb, 3)),
                        gb.prior_z)]),
        prior_sqrt_info=jnp.concatenate([ga.prior_sqrt_info,
                                         gb.prior_sqrt_info]),
        # Session B keeps only its own prior gauge if A has none; normally
        # A's prior anchors the merged frame and B's priors are dropped.
        prior_mask=jnp.concatenate([
            ga.prior_mask, jnp.zeros_like(gb.prior_mask)]),
        bet_i=jnp.concatenate([ga.bet_i, gb.bet_i + na]),
        bet_j=jnp.concatenate([ga.bet_j, gb.bet_j + na]),
        bet_z=jnp.concatenate([ga.bet_z, gb.bet_z]),
        bet_sqrt_info=jnp.concatenate([ga.bet_sqrt_info, gb.bet_sqrt_info]),
        bet_mask=jnp.concatenate([ga.bet_mask, gb.bet_mask]),
        # Append cursors point past session B's storage region so later
        # add_pose/add_between calls cannot overwrite B's live slots (the
        # merged storage is fragmented: A's dead tail slots stay dead).
        n_poses=va + gb.n_poses,
        n_priors=ga.n_priors,
        n_between=fa + gb.n_between,
    )
    if inter_factors is not None:
        i_a, j_b, z, sq = inter_factors
        for idx in range(k):
            g = fct.add_between(g, i_a[idx], j_b[idx] + na, z[idx], sq[idx])
    return g


def merged_map_stats(kf_a: KeyframeStore, kf_b: KeyframeStore, t_ab,
                     grid: GridConfig) -> ndt_grid.NDTStats:
    """Joint NDT statistics from both sessions' keyframes (B moved by
    ``t_ab``); one batched accumulation."""
    wa = se2.transform(kf_a.poses, kf_a.points)
    poses_b = se2.compose(jnp.broadcast_to(
        jnp.asarray(t_ab, kf_b.poses.dtype), kf_b.poses.shape), kf_b.poses)
    wb = se2.transform(poses_b, kf_b.points)
    pts = jnp.concatenate([wa.reshape(-1, 2), wb.reshape(-1, 2)])
    msk = jnp.concatenate([
        (kf_a.masks & kf_a.live[:, None]).reshape(-1),
        (kf_b.masks & kf_b.live[:, None]).reshape(-1)])
    return ndt_grid.build_stats(pts, msk, grid)
