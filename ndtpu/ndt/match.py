"""Batched NDT scan registration: score / gradient / Hessian + LM iteration.

Capability parity (SURVEY.md §4.2 "NDT registration"): minimize the negative
NDT likelihood ``f(T) = -sum_i exp(-1/2 d_i^T Lambda_i d_i)`` over the 2D
rigid transform ``T = (tx, ty, phi)`` with analytic gradient and Hessian
(including the second-order ``phi`` term), damped-Newton (Levenberg-
Marquardt) steps with step control, and an iteration/tolerance stop. The
converged Hessian is returned as the information matrix for the downstream
pose-graph factor (reference behavior: ``H^{-1} -> factor covariance``).

Design:

- The per-point inner loop is one fused gather + vectorized FLOP block over
  ``[G, N]`` (overlap grids x beams) — no point loop exists; XLA fuses the
  exp/outer-product chain into the gather consumers.
- The Newton iteration is a ``lax.while_loop`` whose carry holds
  ``(pose, f, g, H, lambda, ...)`` — exactly one objective evaluation per
  iteration (the trial point's f/g/H are reused on acceptance).
- The whole matcher ``vmap``s over a leading batch axis — B concurrent
  registrations (odometry windows, loop-closure candidates, multi-robot)
  share one compiled program; this batching is where the >=5x scans/s/chip
  target comes from (SURVEY.md §7).
- Data-dependent convergence under jit uses the standard masked-early-exit
  treatment (SURVEY.md §8 hard part #5).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ndtpu.config import GridConfig, MatchConfig
from ndtpu.ndt.grid import NDTMap, lookup
from ndtpu.utils.runtime import MATMUL_PRECISION as _HI

__all__ = ["MatchResult", "transform_terms", "point_terms",
           "point_terms_quad", "score_grad_hess", "lm_loop",
           "lm_loop_batch", "match", "match_batch", "match_batch_packed"]


class MatchResult(NamedTuple):
    pose: jax.Array       # [..., 3] optimized world-from-scan transform
    hessian: jax.Array    # [..., 3, 3] objective Hessian at the optimum
    score: jax.Array      # [...] mean per-point NDT score in [0, 1]
    n_iter: jax.Array     # [...] LM iterations executed
    converged: jax.Array  # [...] bool


def transform_terms(pose, points):
    """World-frame points and their phi-derivative for a pose ``[3]``.

    Returns ``(xw [N, 2], dxdphi [N, 2])`` — shared by the replicated and
    the slab-sharded (ndtpu.dist.gridmap) score paths.
    """
    c, s = jnp.cos(pose[2]), jnp.sin(pose[2])
    px, py = points[..., 0], points[..., 1]
    xw = jnp.stack(
        [c * px - s * py + pose[0], s * px + c * py + pose[1]], axis=-1
    )
    dxdphi = jnp.stack([-s * px - c * py, c * px - s * py], axis=-1)
    return xw, dxdphi


def point_terms(pose, xw, dxdphi, mean, icov, w0, cfg: MatchConfig):
    """Per-point NDT objective contributions, reduced over all axes.

    xw/dxdphi ``[N, 2]``; mean/icov/w0 ``[G, N, ...]`` gathered per-point
    Gaussians with validity weights. Returns ``(f, g [3], H [3,3], wsum,
    w0sum)`` — raw sums, so partial results from map shards can be combined
    with a plain ``psum`` (ndtpu.dist.gridmap.match_slab).
    """
    dt = xw.dtype
    d = xw[None] - mean                                 # [G, N, 2]
    q = jnp.einsum("gnij,gnj->gni", icov, d,
                   precision=_HI)                       # [G, N, 2] = Lambda d
    l2 = jnp.sum(d * q, axis=-1)                        # [G, N] Mahalanobis^2
    d2 = jnp.asarray(cfg.d2, dt)
    e = jnp.exp(-0.5 * d2 * jnp.clip(l2, 0.0, cfg.exp_clip))
    w = w0 * e                                          # [G, N]

    # a_k = d^T Lambda J_k with J = [e1 | e2 | dx/dphi]  -> a = [q_x, q_y, q.J3]
    a3 = jnp.sum(q * dxdphi[None], axis=-1)
    a = jnp.stack([q[..., 0], q[..., 1], a3], axis=-1)  # [G, N, 3]
    g = d2 * jnp.einsum("gn,gnk->k", w, a, precision=_HI)

    # J^T Lambda J assembled from Lambda entries and Lambda @ J3.
    ld = jnp.einsum("gnij,nj->gni", icov, dxdphi,
                    precision=_HI)                      # [G, N, 2]
    j33 = jnp.sum(dxdphi[None] * ld, axis=-1)           # [G, N]
    jlj = jnp.stack(
        [
            jnp.stack([icov[..., 0, 0], icov[..., 0, 1], ld[..., 0]], axis=-1),
            jnp.stack([icov[..., 0, 1], icov[..., 1, 1], ld[..., 1]], axis=-1),
            jnp.stack([ld[..., 0], ld[..., 1], j33], axis=-1),
        ],
        axis=-2,
    )                                                   # [G, N, 3, 3]
    # Second-order term: d^2 xw / dphi^2 = -(R p) = -(xw - t).
    hpp = -jnp.sum(q * (xw[None] - jnp.asarray(pose[:2], dt)), axis=-1)  # [G, N]
    e33 = jnp.zeros((3, 3), dt).at[2, 2].set(1.0)
    h_pt = (jlj + hpp[..., None, None] * e33
            - d2 * a[..., :, None] * a[..., None, :])
    h = d2 * jnp.einsum("gn,gnkl->kl", w, h_pt, precision=_HI)

    wsum = jnp.sum(w)
    return -wsum, g, h, wsum, jnp.sum(w0)


def score_grad_hess(pose, points, mask, ndt_map: NDTMap, grid: GridConfig,
                    cfg: MatchConfig):
    """Objective, gradient, Hessian of the NDT score at ``pose``.

    pose: ``[3]``; points: ``[N, 2]`` scan in the sensor frame; mask ``[N]``.
    Returns ``(f, g [3], H [3,3], score)`` where ``f`` is the value being
    minimized (negative summed score) and ``score`` the mean per-point match
    quality used by the loop-closure gate (SURVEY.md §4.5).
    """
    dt = points.dtype
    xw, dxdphi = transform_terms(pose, points)
    mean, icov, w0 = lookup(ndt_map, xw, grid)          # [G,N,2],[G,N,2,2],[G,N]
    w0 = w0 * mask.astype(dt)[None, :]
    f, g, h, wsum, w0sum = point_terms(pose, xw, dxdphi, mean, icov, w0, cfg)
    return f, g, h, wsum / jnp.maximum(w0sum, 1.0)


def solve3(a, b):
    """Closed-form 3x3 linear solve (Cramer's rule).

    XLA's general ``linalg.solve`` lowers to an LU decomposition, heavy
    machinery for a batch of tiny systems; Cramer is branch-free, batched,
    and exact to rounding for 3x3.
    a: ``[..., 3, 3]``, b: ``[..., 3]``.
    """
    c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
    c01 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
    c02 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
    det = (a[..., 0, 0] * c00 + a[..., 0, 1] * c01 + a[..., 0, 2] * c02)
    det = jnp.where(jnp.abs(det) < 1e-30, 1e-30, det)
    c10 = a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2]
    c11 = a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0]
    c12 = a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1]
    c20 = a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]
    c21 = a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2]
    c22 = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    # inv(a) = adj(a)^T / det; rows of the cofactor matrix are c{i}*.
    x0 = (c00 * b[..., 0] + c10 * b[..., 1] + c20 * b[..., 2]) / det
    x1 = (c01 * b[..., 0] + c11 * b[..., 1] + c21 * b[..., 2]) / det
    x2 = (c02 * b[..., 0] + c12 * b[..., 1] + c22 * b[..., 2]) / det
    return jnp.stack([x0, x1, x2], axis=-1)


def _solve_damped(h, g, lam, dt):
    """LM step: solve ``(H + lam * D) delta = -g`` with ``D = |diag(H)|``.

    ``|diag|`` (not clipped diag) matters: away from the optimum the NDT
    Hessian is indefinite with *negative* diagonal entries, and only a
    positive damping matrix guarantees the damped system goes positive
    definite as lam grows (large lam then recovers scaled gradient descent).
    """
    diag = jnp.maximum(jnp.abs(jnp.diagonal(h)), 1e-6)
    a = h + lam * jnp.diag(diag)
    return solve3(a, -g)


def lm_loop(sgh, init_pose, cfg: MatchConfig) -> MatchResult:
    """Damped-Newton (LM) iteration parametrized by the objective evaluator.

    ``sgh(pose) -> (f, g, H, score)``. Shared by the single-device matcher
    (objective from :func:`score_grad_hess`) and the slab-sharded matcher
    (psum-fused objective, ndtpu.dist.gridmap.match_slab). Each iteration
    performs exactly one evaluation (at the trial point) and accepts or
    rejects the step by comparing objectives.
    """
    dt = init_pose.dtype
    f0, g0, h0, s0 = sgh(init_pose)

    def cond(carry):
        pose, f, g, h, score, lam, it, done, conv = carry
        return (it < cfg.max_iter) & jnp.logical_not(done)

    def body(carry):
        pose, f, g, h, score, lam, it, done, conv = carry
        delta = _solve_damped(h, g, lam, dt)
        # Clip runaway translation steps (reference 'step control').
        tn = jnp.sqrt(delta[0] ** 2 + delta[1] ** 2)
        scale = jnp.where(tn > cfg.step_clip, cfg.step_clip / tn, 1.0)
        delta = delta * scale
        pose_try = pose + delta
        f2, g2, h2, s2 = sgh(pose_try)
        accept = f2 < f
        pose_n = jnp.where(accept, pose_try, pose)
        f_n = jnp.where(accept, f2, f)
        g_n = jnp.where(accept, g2, g)
        h_n = jnp.where(accept, h2, h)
        s_n = jnp.where(accept, s2, score)
        lam_n = jnp.where(
            accept,
            jnp.maximum(lam / cfg.lambda_down, 1e-9),
            lam * cfg.lambda_up,
        )
        # A sub-tolerance *proposed* step means the damped model sees no
        # useful motion left — the numerical optimum at this damping level.
        # A REJECTED step under reject_tol is the same signal one scale up:
        # the model wants a tiny move and the objective can't resolve it.
        dnorm = jnp.sqrt(jnp.sum(delta * delta))
        small = (dnorm < cfg.tol) | (~accept & (dnorm < cfg.reject_tol))
        stuck = lam_n > cfg.max_lambda
        done_n = small | stuck
        return pose_n, f_n, g_n, h_n, s_n, lam_n, it + 1, done_n, small

    lam0 = jnp.asarray(cfg.init_lambda, dt)
    zero_grad = jnp.sum(jnp.abs(g0)) == 0.0  # no valid cells: nothing to do
    false = jnp.asarray(False)
    carry = (init_pose, f0, g0, h0, s0, lam0, jnp.asarray(0, jnp.int32),
             zero_grad, false)
    pose, f, g, h, score, lam, it, done, conv = jax.lax.while_loop(
        cond, body, carry)
    converged = conv & (f < 0.0)  # f < 0 iff some points matched valid cells
    return MatchResult(pose=pose, hessian=h, score=score, n_iter=it,
                       converged=converged)


def match(points, mask, ndt_map: NDTMap, init_pose, grid: GridConfig,
          cfg: MatchConfig) -> MatchResult:
    """Register one scan against the map starting from ``init_pose`` ``[3]``.

    Thin wrapper over the batched quad-table path (:func:`match_batch`) with
    ``B = 1`` — the per-scan odometry/pipeline matcher and the batched
    loop-closure matcher share one implementation and one compiled hot loop.
    ``vmap`` freely (including over per-candidate maps — the quad pack and
    gather batch cleanly).
    """
    res = match_batch(points[None], mask[None], ndt_map, init_pose[None],
                      grid, cfg)
    return jax.tree_util.tree_map(lambda a: a[0], res)


def point_terms_quad(poses, x, y, dpx, dpy, rows, w_mask,
                     cfg: MatchConfig, overlap: int):
    """Batched NDT objective terms from quad-table rows (the fast path).

    poses ``[B, 3]``; x/y/dpx/dpy ``[B, N]`` world points and their
    phi-derivatives as separate planes; rows ``[B, N, G*8]`` gathered quad
    rows (:func:`ndtpu.ndt.grid.lookup_quad`); w_mask ``[B, N]`` combined
    in-bounds x scan-mask weight. All math is elementwise over ``[B, N]``
    (N in lanes — no ``[..., 2, 2]`` minor dims, no G-extent in any gathered
    index), with a static unrolled loop over the G overlap grids. Numerically
    the same model as :func:`point_terms`, with per-``B`` outputs. Returns ``(f [B], g [B,3], h [B,3,3], wsum [B],
    w0sum [B])``.
    """
    dt = x.dtype
    d2 = jnp.asarray(cfg.d2, dt)
    tx, ty = poses[:, 0, None], poses[:, 1, None]
    rx, ry = x - tx, y - ty                     # R(phi) p, reused per grid
    acc = None
    for g in range(overlap):
        if cfg.compact_table:
            from ndtpu.ndt.grid import unpack_bf16_pair
            mx, my = rows[..., g * 4 + 0], rows[..., g * 4 + 1]
            i00, i01 = unpack_bf16_pair(rows[..., g * 4 + 2], dt)
            i11, vld = unpack_bf16_pair(rows[..., g * 4 + 3], dt)
            w0 = vld * w_mask
        else:
            mx, my = rows[..., g * 8 + 0], rows[..., g * 8 + 1]
            i00, i01 = rows[..., g * 8 + 2], rows[..., g * 8 + 3]
            i11 = rows[..., g * 8 + 4]
            w0 = rows[..., g * 8 + 5] * w_mask
        dx, dy = x - mx, y - my
        qx = i00 * dx + i01 * dy
        qy = i01 * dx + i11 * dy
        l2 = jnp.maximum(dx * qx + dy * qy, 0.0)
        e = jnp.exp(-0.5 * d2 * jnp.minimum(l2, cfg.exp_clip))
        w = w0 * e
        a3 = qx * dpx + qy * dpy
        ldx = i00 * dpx + i01 * dpy
        ldy = i01 * dpx + i11 * dpy
        j33 = dpx * ldx + dpy * ldy
        hpp = -(qx * rx + qy * ry)
        red = lambda t: jnp.sum(t, axis=-1)     # [B]
        terms = (red(w), red(w0), red(w * qx), red(w * qy), red(w * a3),
                 red(w * (i00 - d2 * qx * qx)),
                 red(w * (i01 - d2 * qx * qy)),
                 red(w * (ldx - d2 * qx * a3)),
                 red(w * (i11 - d2 * qy * qy)),
                 red(w * (ldy - d2 * qy * a3)),
                 red(w * (j33 + hpp - d2 * a3 * a3)))
        acc = terms if acc is None else tuple(a + t for a, t in zip(acc, terms))
    (wsum, w0sum, g0, g1, g2, h00, h01, h02, h11, h12, h22) = acc
    g_vec = d2 * jnp.stack([g0, g1, g2], axis=-1)
    h = d2 * jnp.stack([
        jnp.stack([h00, h01, h02], axis=-1),
        jnp.stack([h01, h11, h12], axis=-1),
        jnp.stack([h02, h12, h22], axis=-1),
    ], axis=-2)
    return -wsum, g_vec, h, wsum, w0sum


def _lm_carry_init(sgh, init_poses, cfg: MatchConfig):
    dt = init_poses.dtype
    f0, g0, h0, s0 = sgh(init_poses)
    b = init_poses.shape[0]
    lam0 = jnp.full((b,), cfg.init_lambda, dt)
    zero_grad = jnp.sum(jnp.abs(g0), axis=-1) == 0.0
    return (init_poses, f0, g0, h0, s0, lam0,
            jnp.zeros((b,), jnp.int32), zero_grad, jnp.zeros((b,), bool))


def _lm_run(sgh, carry, cfg: MatchConfig, max_iter: int):
    """Advance a batched LM carry until every element is done or has spent
    ``max_iter`` TOTAL iterations (the per-element counter persists across
    calls — the two-phase matcher resumes a carry on a compacted subset)."""
    dt = carry[0].dtype

    def cond(carry):
        pose, f, g, h, score, lam, it, done, conv = carry
        return jnp.any((it < max_iter) & jnp.logical_not(done))

    def body(carry):
        pose, f, g, h, score, lam, it, done, conv = carry
        active = (it < max_iter) & jnp.logical_not(done)
        delta = jax.vmap(_solve_damped, in_axes=(0, 0, 0, None))(h, g, lam, dt)
        tn = jnp.sqrt(delta[:, 0] ** 2 + delta[:, 1] ** 2)
        scale = jnp.where(tn > cfg.step_clip, cfg.step_clip / tn, 1.0)
        delta = delta * scale[:, None]
        pose_try = jnp.where(active[:, None], pose + delta, pose)
        f2, g2, h2, s2 = sgh(pose_try)
        accept = active & (f2 < f)
        acc = accept[:, None]
        pose_n = jnp.where(acc, pose_try, pose)
        f_n = jnp.where(accept, f2, f)
        g_n = jnp.where(acc, g2, g)
        h_n = jnp.where(accept[:, None, None], h2, h)
        s_n = jnp.where(accept, s2, score)
        lam_n = jnp.where(
            accept, jnp.maximum(lam / cfg.lambda_down, 1e-9),
            jnp.where(active, lam * cfg.lambda_up, lam))
        dnorm = jnp.sqrt(jnp.sum(delta * delta, -1))
        small = active & ((dnorm < cfg.tol)
                          | (~accept & (dnorm < cfg.reject_tol)))
        stuck = active & (lam_n > cfg.max_lambda)
        return (pose_n, f_n, g_n, h_n, s_n, lam_n,
                it + active.astype(jnp.int32), done | small | stuck,
                conv | small)

    return jax.lax.while_loop(cond, body, carry)


def _lm_result(carry) -> MatchResult:
    pose, f, g, h, score, lam, it, done, conv = carry
    return MatchResult(pose=pose, hessian=h, score=score, n_iter=it,
                       converged=conv & (f < 0.0))


def lm_loop_batch(sgh, init_poses, cfg: MatchConfig) -> MatchResult:
    """Batched damped-Newton iteration: one ``lax.while_loop`` over the whole
    batch with per-element masked accept/convergence.

    ``sgh(poses [B,3]) -> (f [B], g [B,3], H [B,3,3], score [B])``. Runs
    until every element is done (or the iteration cap); finished elements are
    frozen by per-element masks, so the semantics match ``vmap``-of-
    :func:`lm_loop` while compiling to ONE loop whose body is a fully
    batched tensor program — this is where the scans/s/chip headline comes
    from (SURVEY.md §4.2, BASELINE north star).
    """
    carry = _lm_carry_init(sgh, init_poses, cfg)
    return _lm_result(_lm_run(sgh, carry, cfg, cfg.max_iter))


def match_batch(points, mask, ndt_map: NDTMap, init_poses, grid: GridConfig,
                cfg: MatchConfig) -> MatchResult:
    """B concurrent registrations against one shared map.

    points ``[B, N, 2]``, mask ``[B, N]``, init_poses ``[B, 3]``. This is the
    batched path used for loop-closure candidates and throughput benchmarks
    (SURVEY.md §4.2 'batching over B concurrent registrations'): ONE quad-
    table row gather per point per LM iteration
    (:func:`ndtpu.ndt.grid.pack_quad`) + one batched LM while-loop.
    """
    from ndtpu.ndt.grid import pack_quad

    table = pack_quad(ndt_map, grid, compact=cfg.compact_table)
    return match_batch_packed(points, mask, table, init_poses, grid, cfg)


def match_batch_packed(points, mask, table, init_poses, grid: GridConfig,
                       cfg: MatchConfig, group=None) -> MatchResult:
    """B concurrent registrations against a prebuilt quad table.

    Same semantics as :func:`match_batch` but the caller supplies the
    :func:`ndtpu.ndt.grid.pack_quad` table — the windowed odometry/pipeline
    loops pack ONCE per map change and amortize it over every scan in the
    window (VERDICT r2: the table was being rebuilt inside every match).

    ``table`` may be ``[R, L]`` (one shared map for all lanes),
    ``[B, R, L]`` (each lane registers against its OWN map — the
    loop-closure verification shape, where every candidate keyframe has a
    cached local table; :func:`ndtpu.ndt.grid.lookup_quad_multi`), or,
    with ``group [B]`` given, ``[S, R, L]`` where lane ``b`` registers
    against table ``group[b]`` (the stacked multi-session frontend shape:
    W lanes per session share the session's map table;
    :func:`ndtpu.ndt.grid.lookup_quad_grouped`).

    Two-phase mode (``cfg.phase2_width > 0``): the batched LM while_loop
    pays max-over-batch iterations at FULL batch width (measured p50=13
    iters but max=30 on the serving shape — ~2.2x theoretical waste), so
    phase 1 runs ``cfg.phase1_iters`` at full width, then the unconverged
    stragglers are COMPACTED into ``phase2_width``-wide rounds that run to
    completion. Per-element results are identical (the LM carry — pose, f,
    g, H, lambda, iteration count — travels with the element through
    gather/scatter); only the width the chip pays for the tail changes.
    """
    from ndtpu.ndt.grid import lookup_quad, lookup_quad_grouped

    dt = points.dtype
    mask_f = mask.astype(dt)                                 # [B, N]
    px, py = points[..., 0], points[..., 1]
    b = init_poses.shape[0]
    grouped = group is not None
    if table.ndim == 3:
        # Per-lane ([B, R, L], group absent) and per-group ([S, R, L])
        # tables both run the same flat row-fold: flatten ONCE here, so a
        # reshape that lowers to a copy never runs inside the LM
        # while_loop body.
        r_rows = table.shape[1]
        table = table.reshape(-1, table.shape[-1])
        if not grouped:
            group = jnp.arange(b, dtype=jnp.int32)
            grouped = True
    elif grouped:
        raise ValueError("group= requires a [S, R, L] table")

    def make_sgh(spx, spy, smask_f, sgrp=None):
        def sgh(poses):
            c = jnp.cos(poses[:, 2])[:, None]
            s = jnp.sin(poses[:, 2])[:, None]
            x = c * spx - s * spy + poses[:, 0, None]
            y = s * spx + c * spy + poses[:, 1, None]
            dpx = -s * spx - c * spy
            dpy = c * spx - s * spy
            if sgrp is not None:
                rows, inb = lookup_quad_grouped(table, r_rows, sgrp, x, y,
                                                grid)
            else:
                rows, inb = lookup_quad(table, x, y, grid)
            w_mask = smask_f * inb.astype(dt)
            f, g, h, wsum, w0sum = point_terms_quad(
                poses, x, y, dpx, dpy, rows, w_mask, cfg, grid.overlap)
            return f, g, h, wsum / jnp.maximum(w0sum, 1.0)
        return sgh

    sgh = make_sgh(px, py, mask_f, group)
    c2 = cfg.phase2_width
    if c2 <= 0 or b <= c2:
        return lm_loop_batch(sgh, init_poses.astype(dt), cfg)

    carry = _lm_carry_init(sgh, init_poses.astype(dt), cfg)
    carry = _lm_run(sgh, carry, cfg, min(cfg.phase1_iters, cfg.max_iter))

    def outer_cond(carry):
        pose, f, g, h, score, lam, it, done, conv = carry
        return jnp.any(~done & (it < cfg.max_iter))

    def outer_body(carry):
        done = carry[7]
        pending = (~done).astype(jnp.int32)
        _, idx = jax.lax.top_k(pending, c2)      # distinct slots, pending 1st
        sub = tuple(x[idx] for x in carry)
        sub_sgh = make_sgh(px[idx], py[idx], mask_f[idx],
                           group[idx] if grouped else None)
        sub = _lm_run(sub_sgh, sub, cfg, cfg.max_iter)
        return tuple(x.at[idx].set(sx) for x, sx in zip(carry, sub))

    carry = jax.lax.while_loop(outer_cond, outer_body, carry)
    return _lm_result(carry)
