"""Pose-graph solvers: dense Gauss-Newton/LM and block-Jacobi PCG.

Capability parity (SURVEY.md §3.2 "Linear layer" / "Inference /
elimination"): builds the Gauss-Newton normal equations from the batched
factor linearization and solves for the update, inside a damped nonlinear
iteration — the role GTSAM's ``GaussNewtonOptimizer`` /
``LevenbergMarquardtOptimizer`` + multifrontal elimination play.

Design — two solver paths, both expressed as dense-block tensor programs
rather than a pointer-based elimination tree:

- **Dense block Cholesky** (small/medium graphs): the block-sparse Hessian
  is scattered into ``[V, V, 3, 3]`` → ``[3V, 3V]`` and solved with XLA's
  ``cholesky`` + ``triangular_solve`` — dense matrix work instead of
  sequential sparse elimination, up to a few thousand poses.
- **Matrix-free PCG** (large graphs, BASELINE config 4): ``H @ x`` is two
  gathers + one einsum + one ``segment_sum`` over the factor SoA — never
  materializing H — preconditioned by the inverse 3x3 block diagonal.
  Chordal/sparse-direct alternatives serialize; CG iterations are pure
  batched FLOPs.

Both paths share the LM trust-region loop with chi2 accept/reject.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ndtpu.config import SolverConfig
from ndtpu.graph import factors as fct
from ndtpu.lie import se2
from ndtpu.utils.runtime import MATMUL_PRECISION as _HI

__all__ = ["SolveResult", "normal_equations", "hessian_matvec",
           "block_diag_hessian", "solve_dense", "pcg", "pcg_rhs",
           "pcg_rhs_blocked", "optimize"]


class SolveResult(NamedTuple):
    graph: fct.PoseGraph
    chi2: jax.Array        # final weighted squared error
    n_iter: jax.Array
    converged: jax.Array


def _apply_delta(poses, delta, mask):
    """Additive local update with angle wrap, masked to live poses."""
    new = poses + delta * mask[:, None]
    return jnp.concatenate([new[:, :2], se2.wrap(new[:, 2:3])], axis=-1)


def normal_equations(g: fct.PoseGraph, lin):
    """Dense ``H [3V, 3V]`` and ``b [3V]`` with ``H delta = -b`` the GN step.

    Block scatter-add via vectorized ``.at[].add`` — XLA lowers to a single
    fused scatter; no Python loop over factors.
    """
    (ai, aj, r), (ap, rp) = lin
    v = g.poses.shape[0]
    dt = ai.dtype
    h = jnp.zeros((v, v, 3, 3), dt)
    b = jnp.zeros((v, 3), dt)
    i, j = g.bet_i, g.bet_j
    h = h.at[i, i].add(jnp.einsum("fab,fac->fbc", ai, ai, precision=_HI))
    h = h.at[i, j].add(jnp.einsum("fab,fac->fbc", ai, aj, precision=_HI))
    h = h.at[j, i].add(jnp.einsum("fab,fac->fbc", aj, ai, precision=_HI))
    h = h.at[j, j].add(jnp.einsum("fab,fac->fbc", aj, aj, precision=_HI))
    b = b.at[i].add(jnp.einsum("fab,fa->fb", ai, r, precision=_HI))
    b = b.at[j].add(jnp.einsum("fab,fa->fb", aj, r, precision=_HI))
    p = g.prior_idx
    h = h.at[p, p].add(jnp.einsum("fab,fac->fbc", ap, ap, precision=_HI))
    b = b.at[p].add(jnp.einsum("fab,fa->fb", ap, rp, precision=_HI))
    hd = jnp.transpose(h, (0, 2, 1, 3)).reshape(3 * v, 3 * v)
    return hd, b.reshape(-1)


def hessian_matvec(g: fct.PoseGraph, lin, x):
    """Matrix-free ``H @ x`` over the factor SoA (x: ``[V, 3]``).

    Two gathers (x_i, x_j), per-factor 3x3 GEMMs, one segment-sum scatter —
    the batched replacement for CSR SpMV.
    """
    (ai, aj, r), (ap, rp) = lin
    v = g.poses.shape[0]
    xi = x[g.bet_i]
    xj = x[g.bet_j]
    # y_f = A_i x_i + A_j x_j  (whitened row space)
    yf = (jnp.einsum("fab,fb->fa", ai, xi, precision=_HI)
          + jnp.einsum("fab,fb->fa", aj, xj, precision=_HI))
    out = jnp.zeros((v, 3), x.dtype)
    out = out.at[g.bet_i].add(jnp.einsum("fab,fa->fb", ai, yf, precision=_HI))
    out = out.at[g.bet_j].add(jnp.einsum("fab,fa->fb", aj, yf, precision=_HI))
    yp = jnp.einsum("fab,fb->fa", ap, x[g.prior_idx], precision=_HI)
    out = out.at[g.prior_idx].add(
        jnp.einsum("fab,fa->fb", ap, yp, precision=_HI))
    return out


def gradient(g: fct.PoseGraph, lin):
    """``b = A^T r`` as ``[V, 3]`` (the GN right-hand side is ``-b``)."""
    (ai, aj, r), (ap, rp) = lin
    v = g.poses.shape[0]
    b = jnp.zeros((v, 3), r.dtype)
    b = b.at[g.bet_i].add(jnp.einsum("fab,fa->fb", ai, r, precision=_HI))
    b = b.at[g.bet_j].add(jnp.einsum("fab,fa->fb", aj, r, precision=_HI))
    b = b.at[g.prior_idx].add(jnp.einsum("fab,fa->fb", ap, rp, precision=_HI))
    return b


def block_diag_hessian(g: fct.PoseGraph, lin):
    """The ``[V, 3, 3]`` diagonal blocks of H (for damping + preconditioner)."""
    (ai, aj, r), (ap, rp) = lin
    v = g.poses.shape[0]
    d = jnp.zeros((v, 3, 3), r.dtype)
    d = d.at[g.bet_i].add(jnp.einsum("fab,fac->fbc", ai, ai, precision=_HI))
    d = d.at[g.bet_j].add(jnp.einsum("fab,fac->fbc", aj, aj, precision=_HI))
    d = d.at[g.prior_idx].add(
        jnp.einsum("fab,fac->fbc", ap, ap, precision=_HI))
    return d


def _inv3(a):
    """Batched closed-form 3x3 inverse (adjugate / determinant)."""
    c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
    c01 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
    c02 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
    c10 = a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2]
    c11 = a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0]
    c12 = a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1]
    c20 = a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]
    c21 = a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2]
    c22 = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    det = a[..., 0, 0] * c00 + a[..., 0, 1] * c01 + a[..., 0, 2] * c02
    det = jnp.where(jnp.abs(det) < 1e-30, 1e-30, det)
    adj = jnp.stack([
        jnp.stack([c00, c10, c20], axis=-1),
        jnp.stack([c01, c11, c21], axis=-1),
        jnp.stack([c02, c12, c22], axis=-1),
    ], axis=-2)
    return adj / det[..., None, None]


def solve_dense(g: fct.PoseGraph, lin, lam):
    """One damped GN step by dense Cholesky. Returns delta ``[V, 3]``."""
    h, b = normal_equations(g, lin)
    v = g.poses.shape[0]
    diag = jnp.diagonal(h)
    damp = lam * jnp.maximum(jnp.abs(diag), 1e-8)
    # Dead pose slots get identity rows so the factorization stays SPD.
    live = jnp.repeat(g.pose_mask.astype(h.dtype), 3)
    damp = damp + (1.0 - live)
    hd = h + jnp.diag(damp)
    l = jnp.linalg.cholesky(hd)
    y = jax.scipy.linalg.solve_triangular(l, -b, lower=True)
    delta = jax.scipy.linalg.solve_triangular(l.T, y, lower=False)
    return delta.reshape(v, 3)


def pcg(g: fct.PoseGraph, lin, lam, cfg: SolverConfig):
    """Damped-GN step by block-Jacobi preconditioned conjugate gradients.

    Never materializes H; each iteration is one ``hessian_matvec``. The
    ``lax.while_loop`` exits on relative residual or iteration cap.
    """
    return pcg_rhs(g, lin, -gradient(g, lin), lam, cfg)


def pcg_rhs(g: fct.PoseGraph, lin, rhs, lam, cfg: SolverConfig):
    """Solve ``(H + damping) x = rhs`` matrix-free (rhs ``[V, 3]``).

    The general entry point behind :func:`pcg`; also used for marginal
    covariances via unit-vector solves
    (:func:`ndtpu.graph.incremental.marginal_covariance_pcg`).
    """
    dblocks = block_diag_hessian(g, lin)
    dt = rhs.dtype
    eye = jnp.eye(3, dtype=dt)
    # Damping mirrors solve_dense: lam-scaled |diag| + identity on dead slots.
    dd = jnp.abs(jnp.diagonal(dblocks, axis1=-2, axis2=-1))
    damp = lam * jnp.maximum(dd, 1e-8) + (1.0 - g.pose_mask.astype(dt))[:, None]
    dblocks_d = dblocks + damp[..., None] * eye
    minv = _inv3(dblocks_d)

    def amul(x):
        return hessian_matvec(g, lin, x) + damp * x

    x0 = jnp.zeros_like(rhs)
    r0 = rhs  # - A @ 0
    z0 = jnp.einsum("vab,vb->va", minv, r0, precision=_HI)
    p0 = z0
    rz0 = jnp.sum(r0 * z0)
    bnorm = jnp.sqrt(jnp.sum(rhs * rhs))
    tol2 = (cfg.pcg_tol * jnp.maximum(bnorm, 1e-30)) ** 2

    def cond(c):
        x, r, z, p, rz, it = c
        return (it < cfg.pcg_max_iter) & (jnp.sum(r * r) > tol2)

    def body(c):
        x, r, z, p, rz, it = c
        ap = amul(p)
        alpha = rz / jnp.maximum(jnp.sum(p * ap), 1e-30)
        x = x + alpha * p
        r = r - alpha * ap
        z = jnp.einsum("vab,vb->va", minv, r, precision=_HI)
        rz_new = jnp.sum(r * z)
        beta = rz_new / jnp.maximum(rz, 1e-30)
        p = z + beta * p
        return x, r, z, p, rz_new, it + 1

    x, r, z, p, rz, it = jax.lax.while_loop(
        cond, body, (x0, r0, z0, p0, rz0, jnp.asarray(0, jnp.int32)))
    return x, it


def pcg_rhs_blocked(g: fct.PoseGraph, lin, rhs, lam, cfg: SolverConfig,
                    n_blocks: int):
    """Like :func:`pcg_rhs`, but with PER-BLOCK Krylov scalars for a graph
    whose poses are ``n_blocks`` independent components laid out
    contiguously (``V = n_blocks * v_blk`` — the stacked multi-session
    flat graph, :func:`ndtpu.dist.slam_dp._flat_graph`).

    With H block-diagonal across components, CG on the joint system with
    GLOBAL ``alpha``/``beta`` dot products is NOT equivalent to solving
    each component: the shared step scalars serve the dominant component
    and starve the others (measured: one serving session's smoother
    stalls, drifts, and collapses loop acceptance — ATE 7.5 m — while the
    same settings per-session stay at 0.15 m). Per-block dot products
    make the lockstep iteration EXACTLY ``n_blocks`` independent PCGs;
    every gather/scatter stays flat single-axis (the fast path — the
    whole point of the flat graph), only the reductions become
    ``[n_blocks]``-segmented.

    Stopping: fixed ``cfg.pcg_max_iter`` iterations (converged blocks take
    harmless extra steps — their residual is ~0, so ``alpha ~ 0/eps`` is
    guarded the same way the global form guards it).
    """
    v = rhs.shape[0]
    v_blk = v // n_blocks

    def bsum(a):                                         # [V, 3] -> [B, 1, 1]
        return jnp.sum(a.reshape(n_blocks, v_blk * a.shape[-1]),
                       axis=1)[:, None, None]

    def bexp(s):                                         # [B, 1, 1] -> [V, 1]
        return jnp.broadcast_to(s, (n_blocks, v_blk, 1)).reshape(v, 1)

    dblocks = block_diag_hessian(g, lin)
    dt = rhs.dtype
    eye = jnp.eye(3, dtype=dt)
    dd = jnp.abs(jnp.diagonal(dblocks, axis1=-2, axis2=-1))
    damp = lam * jnp.maximum(dd, 1e-8) + (1.0 - g.pose_mask.astype(dt))[:, None]
    minv = _inv3(dblocks + damp[..., None] * eye)

    def amul(x):
        return hessian_matvec(g, lin, x) + damp * x

    x0 = jnp.zeros_like(rhs)
    r0 = rhs
    z0 = jnp.einsum("vab,vb->va", minv, r0, precision=_HI)
    rz0 = bsum(r0 * z0)

    def body(_, c):
        x, r, z, p, rz = c
        ap = amul(p)
        alpha = rz / jnp.maximum(bsum(p * ap), 1e-30)
        x = x + bexp(alpha) * p
        r = r - bexp(alpha) * ap
        z = jnp.einsum("vab,vb->va", minv, r, precision=_HI)
        rz_new = bsum(r * z)
        beta = rz_new / jnp.maximum(rz, 1e-30)
        p = z + bexp(beta) * p
        return x, r, z, p, rz_new

    x, _, _, _, _ = jax.lax.fori_loop(
        0, cfg.pcg_max_iter, body, (x0, r0, z0, z0, rz0))
    return x, jnp.asarray(cfg.pcg_max_iter, jnp.int32)


def optimize(g: fct.PoseGraph, cfg: SolverConfig, method: str = "dense",
             huber_delta: float = 0.0) -> SolveResult:
    """Full nonlinear LM optimization (GaussNewton/LM-optimizer capability).

    ``method``: "dense" (block Cholesky) or "pcg" (matrix-free). The whole
    loop is jit-compatible; ``method`` and configs are static.
    """
    dt = g.poses.dtype

    def total_chi2(graph):
        return fct.chi2(graph, huber_delta)

    c0 = total_chi2(g)

    def cond(carry):
        graph, chi, lam, it, done = carry
        return (it < cfg.max_iter) & jnp.logical_not(done)

    def body(carry):
        graph, chi, lam, it, done = carry
        lin = fct.linearize(graph, huber_delta)
        if method == "dense":
            delta = solve_dense(graph, lin, lam)
        else:
            delta, _ = pcg(graph, lin, lam, cfg)
        new_poses = _apply_delta(graph.poses, delta, graph.pose_mask)
        trial = graph._replace(poses=new_poses)
        chi_t = total_chi2(trial)
        accept = chi_t < chi
        graph_n = jax.tree_util.tree_map(
            lambda a, b: jnp.where(accept, a, b), trial, graph)
        chi_n = jnp.where(accept, chi_t, chi)
        lam_n = jnp.where(accept, jnp.maximum(lam / cfg.lambda_down, 1e-12),
                          lam * cfg.lambda_up)
        small = jnp.sqrt(jnp.sum(delta * delta)) < cfg.tol
        done_n = small | (lam_n > 1e8)
        return graph_n, chi_n, lam_n, it + 1, done_n

    lam0 = jnp.asarray(cfg.init_lambda, dt)
    carry = (g, c0, lam0, jnp.asarray(0, jnp.int32), jnp.asarray(False))
    graph, chi, lam, it, done = jax.lax.while_loop(cond, body, carry)
    return SolveResult(graph=graph, chi2=chi, n_iter=it,
                       converged=done & (lam <= 1e8))
