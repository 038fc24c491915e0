"""NDT odometry: the scan-to-map front-end loop, fully jitted.

Capability parity (SURVEY.md §4.1 "Main SLAM loop", frontend half): for each
scan — predict from odometry, register against the current NDT map, spawn a
keyframe on distance/angle thresholds, fold keyframe scans into the map.

Two formulations of the same capability:

- :func:`run_odometry` — the whole sequence is ONE ``lax.scan`` over time
  steps with the dense map statistics as the carry; map updates are masked
  ``segment_sum``s, so a T-scan run compiles to a single XLA program with
  one transfer in, one out (the reference loops scan-by-scan on the host).
- :func:`run_odometry_windowed` — the fast path: W scans register per
  batched LM dispatch against a per-window frozen map (quad table packed
  once per window), with a refresh pass that folds the window's own
  keyframes back in; everything sequential inside a window (dead-reckoned
  inits, greedy keyframe selection) is closed-form/log-depth vectorized,
  because every carried tiny op is a dependent step on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ndtpu.config import GridConfig, KeyframeConfig, MatchConfig, NDTMapConfig
from ndtpu.lie import se2
from ndtpu.ndt import grid as ndt_grid
from ndtpu.ndt import match as ndt_match

__all__ = ["OdometryResult", "run_odometry", "run_odometry_windowed"]


class OdometryResult(NamedTuple):
    poses: jax.Array       # [T, 3] estimated trajectory
    scores: jax.Array      # [T] per-scan NDT match quality
    n_iters: jax.Array     # [T] LM iterations per scan
    converged: jax.Array   # [T] bool
    is_keyframe: jax.Array  # [T] bool
    stats: ndt_grid.NDTStats  # final map statistics (for rendering / reuse)


def run_odometry(points, mask, odom, grid: GridConfig, ndt_cfg: NDTMapConfig,
                 match_cfg: MatchConfig, kf_cfg: KeyframeConfig,
                 init_pose=None) -> OdometryResult:
    """Run scan-to-map NDT odometry over a sequence.

    points ``[T, N, 2]`` sensor-frame scans, mask ``[T, N]``, odom ``[T, 3]``
    relative odometry deltas (``odom[0]`` ignored). Scan 0 is taken as the
    first keyframe at ``init_pose`` (default identity).
    """
    dt = points.dtype
    t0 = jnp.zeros((3,), dt) if init_pose is None else init_pose.astype(dt)

    stats0 = ndt_grid.add_points(
        ndt_grid.empty_stats(grid, dt), se2.transform(t0, points[0]),
        mask[0], grid)

    def step(carry, inp):
        stats, pose_prev, last_kf = carry
        pts, msk, delta = inp
        init = se2.compose(pose_prev, delta)
        ndt_map = ndt_grid.finalize(stats, ndt_cfg)
        res = ndt_match.match(pts, msk, ndt_map, init, grid, match_cfg)
        pose = res.pose
        diff = se2.between(last_kf, pose)
        is_kf = (jnp.sqrt(diff[0] ** 2 + diff[1] ** 2) > kf_cfg.dist_thresh) | (
            jnp.abs(diff[2]) > kf_cfg.angle_thresh)
        wpts = se2.transform(pose, pts)
        stats = ndt_grid.add_points(stats, wpts, msk & is_kf, grid)
        last_kf = jnp.where(is_kf, pose, last_kf)
        out = (pose, res.score, res.n_iter, res.converged, is_kf)
        return (stats, pose, last_kf), out

    carry0 = (stats0, t0, t0)
    (stats, _, _), (poses, scores, iters, conv, is_kf) = jax.lax.scan(
        step, carry0, (points[1:], mask[1:], odom[1:]))

    one_true = jnp.ones((1,), bool)
    return OdometryResult(
        poses=jnp.concatenate([t0[None], poses], axis=0),
        scores=jnp.concatenate([jnp.ones((1,), dt), scores]),
        n_iters=jnp.concatenate([jnp.zeros((1,), jnp.int32), iters]),
        converged=jnp.concatenate([one_true, conv]),
        is_keyframe=jnp.concatenate([one_true, is_kf]),
        stats=stats,
    )


def gate_poses(res_pose, converged, inits, gate: float):
    """Odometry innovation gate (PipelineConfig.odom_gate rationale).

    Keeps a registration only if it converged AND its translation stays
    within ``gate`` meters of the odometry-predicted init; otherwise the
    prediction wins. Shapes ``[..., 3]`` / ``[...]``. Returns
    ``(poses, ok)``.
    """
    if gate <= 0.0:
        return jnp.where(converged[..., None], res_pose, inits), converged
    dev = jnp.sqrt(jnp.sum((res_pose[..., :2] - inits[..., :2]) ** 2, -1))
    ok = converged & (dev <= gate)
    return jnp.where(ok[..., None], res_pose, inits), ok


def chain_deltas(pose0, deltas):
    """Dead-reckoned absolute poses ``[W, 3]`` from ``pose0`` and relative
    deltas ``[W, 3]`` (pose_i = pose0 ∘ delta_1 ∘ ... ∘ delta_i).

    Closed form — two ``cumsum``s, no sequential scan: heading is a prefix
    sum of delta angles, and each delta's translation is rotated by the
    *previous* heading before a prefix sum over positions. A ``lax.scan`` of
    W tiny composes is W dependent steps; this form is a handful of fused
    vector ops.
    """
    th = pose0[2] + jnp.cumsum(deltas[:, 2])
    th_prev = jnp.concatenate([pose0[2][None], th[:-1]])
    c, s = jnp.cos(th_prev), jnp.sin(th_prev)
    dx = c * deltas[:, 0] - s * deltas[:, 1]
    dy = s * deltas[:, 0] + c * deltas[:, 1]
    x = pose0[0] + jnp.cumsum(dx)
    y = pose0[1] + jnp.cumsum(dy)
    return jnp.stack([x, y, se2.wrap(th)], axis=-1)


def kf_select(last_kf, poses, dist_thresh: float, angle_thresh: float):
    """Vectorized greedy keyframe selection over a window.

    Exactly reproduces the sequential rule — walk the scans, spawn a
    keyframe whenever distance/angle from the LAST spawned keyframe exceeds
    a threshold — without a sequential scan of W dependent steps. The
    greedy chain is a functional graph
    ``next(i) = first j > i triggering from pose_i``; the selected set is
    the orbit of the pre-window keyframe, computed by boolean transitive
    closure via log2(W) matrix squarings on a ``[W+2, W+2]`` reachability
    matrix (W <= 64, so these are trivially small matmuls).

    Returns ``(is_kf [W] bool, last_out [3])``.
    """
    w = poses.shape[0]
    n = w + 2                          # node 0 = pre-window kf, node w+1 = sink
    all_p = jnp.concatenate([last_kf[None], poses], axis=0)      # [W+1, 3]
    d = all_p[None, :, :] - all_p[:, None, :]                    # [W+1, W+1]
    trig = (jnp.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2) > dist_thresh) | (
        jnp.abs(se2.wrap(d[..., 2])) > angle_thresh)
    jj = jnp.arange(w + 1)
    cand = trig & (jj[None, :] > jj[:, None])
    has = jnp.any(cand, axis=1)
    nxt = jnp.where(has, jnp.argmax(cand, axis=1), w + 1)        # [W+1]
    nxt = jnp.concatenate([nxt, jnp.asarray([w + 1])])           # sink loops
    adj = jax.nn.one_hot(nxt, n, dtype=poses.dtype)              # [n, n]
    reach = adj
    steps = max(1, int(np.ceil(np.log2(max(2, n)))))
    for _ in range(steps):
        reach = jnp.minimum(reach + reach @ reach, 1.0)
    is_kf = reach[0, 1 : w + 1] > 0.5                            # [W]
    idx = jnp.arange(w)
    last_i = jnp.max(jnp.where(is_kf, idx, -1))
    last_out = jnp.where(last_i >= 0, poses[jnp.maximum(last_i, 0)], last_kf)
    return is_kf, last_out


def _pad_to_windows(points, mask, odom, window):
    """Pad a [T-1]-step sequence so the step count divides ``window``.

    Padded steps carry identity odometry and an all-false mask, so the
    matcher exits in 0 iterations with pose = previous pose and the keyframe
    test never fires on them.
    """
    t = points.shape[0]
    n_win = -(-t // window)
    pad = n_win * window - t
    if pad:
        points = jnp.concatenate(
            [points, jnp.zeros((pad,) + points.shape[1:], points.dtype)])
        mask = jnp.concatenate([mask, jnp.zeros((pad,) + mask.shape[1:], bool)])
        odom = jnp.concatenate([odom, jnp.zeros((pad, 3), odom.dtype)])
    return points, mask, odom, n_win, pad


def run_odometry_windowed(points, mask, odom, grid: GridConfig,
                          ndt_cfg: NDTMapConfig, match_cfg: MatchConfig,
                          kf_cfg: KeyframeConfig, window: int = 16,
                          passes: int = 2, odom_gate: float = 1.0,
                          init_pose=None) -> OdometryResult:
    """Window-batched scan-to-map NDT odometry (the fast front end).

    Identical capability to :func:`run_odometry`, restructured for the
    hardware (the per-scan path is latency-bound: one small dependent
    registration per scan): scans are processed in windows of ``W = window`` steps —
    the map is finalized + quad-packed ONCE per window, all W scans register
    in ONE batched LM dispatch against that frozen map (inits dead-reckoned
    from the last known pose), and keyframe map insertion is one batched
    ``segment_sum`` over the window's keyframe points.

    ``passes=2`` re-registers with inits chained from each scan's *corrected*
    predecessor (pass 1 absorbs the within-window dead-reckoning drift), so
    accuracy matches the sequential path on all test worlds while the chip
    sees W-wide batches instead of single scans.

    The map a scan registers against lags by at most one window (the
    reference's map lags by one scan — same structure, coarser grain).
    """
    dt = points.dtype
    t0 = jnp.zeros((3,), dt) if init_pose is None else init_pose.astype(dt)

    stats0 = ndt_grid.add_points(
        ndt_grid.empty_stats(grid, dt), se2.transform(t0, points[0]),
        mask[0], grid)

    pts_w, msk_w, odo_w, n_win, pad = _pad_to_windows(
        points[1:], mask[1:], odom[1:], window)
    w = window
    pts_w = pts_w.reshape(n_win, w, *pts_w.shape[1:])
    msk_w = msk_w.reshape(n_win, w, *msk_w.shape[1:])
    odo_w = odo_w.reshape(n_win, w, 3)

    def kf_flags(last_kf, poses):
        is_kf, last_out = kf_select(last_kf, poses, kf_cfg.dist_thresh,
                                    kf_cfg.angle_thresh)
        return last_out, is_kf

    def insert_kf(stats, poses, is_kf, pts, msk):
        wpts = se2.transform(poses, pts)                       # [W, N, 2]
        return ndt_grid.add_points(
            stats, wpts.reshape(-1, 2),
            (msk & is_kf[:, None]).reshape(-1), grid)

    def wstep(carry, inp):
        stats, pose_last, last_kf0 = carry
        pts, msk, deltas = inp                       # [W,N,2],[W,N],[W,3]
        table = ndt_grid.pack_quad(ndt_grid.finalize(stats, ndt_cfg), grid,
                                   compact=match_cfg.compact_table)

        inits = chain_deltas(pose_last, deltas)
        res = ndt_match.match_batch_packed(pts, msk, table, inits, grid,
                                           match_cfg)
        poses, _ = gate_poses(res.pose, res.converged, inits, odom_gate)
        for _ in range(max(0, passes - 1)):
            # Refresh the map with THIS window's keyframes at the previous
            # pass's poses — without it the frozen map lags a full window
            # behind and odometry ATE degrades ~4x beyond W=4 (measured).
            # These temp stats are discarded; the carried stats get exactly
            # one insertion per keyframe, at the final pass's poses.
            _, kf_prev = kf_flags(last_kf0, poses)
            tmp = insert_kf(stats, poses, kf_prev, pts, msk)
            table = ndt_grid.pack_quad(ndt_grid.finalize(tmp, ndt_cfg), grid,
                                       compact=match_cfg.compact_table)
            prev = jnp.concatenate([pose_last[None], poses[:-1]], axis=0)
            inits2 = se2.compose(prev, deltas)
            res = ndt_match.match_batch_packed(pts, msk, table, inits2, grid,
                                               match_cfg)
            poses, _ = gate_poses(res.pose, res.converged, inits2, odom_gate)

        last_kf, is_kf = kf_flags(last_kf0, poses)
        stats = insert_kf(stats, poses, is_kf, pts, msk)
        out = (poses, res.score, res.n_iter, res.converged, is_kf)
        return (stats, poses[-1], last_kf), out

    carry0 = (stats0, t0, t0)
    (stats, _, _), (poses, scores, iters, conv, is_kf) = jax.lax.scan(
        wstep, carry0, (pts_w, msk_w, odo_w))

    t_steps = points.shape[0] - 1
    flat = lambda a: a.reshape((n_win * w,) + a.shape[2:])[:t_steps]
    one_true = jnp.ones((1,), bool)
    return OdometryResult(
        poses=jnp.concatenate([t0[None], flat(poses)], axis=0),
        scores=jnp.concatenate([jnp.ones((1,), dt), flat(scores)]),
        n_iters=jnp.concatenate([jnp.zeros((1,), jnp.int32), flat(iters)]),
        converged=jnp.concatenate([one_true, flat(conv)]),
        is_keyframe=jnp.concatenate([one_true, flat(is_kf)]),
        stats=stats,
    )
