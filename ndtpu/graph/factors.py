"""Pose-graph factors as structure-of-arrays tensors.

Capability parity (SURVEY.md §3.1 "Pose-graph construction", §3.2 "SLAM
factor library" / "Nonlinear layer"): ``PriorFactor<Pose2>`` and
``BetweenFactor<Pose2>`` with Gaussian noise models (sqrt-information form)
and optional robust (Huber) kernels, plus batched linearization.

Design: a graph is NOT a list of factor objects (GTSAM's
``NonlinearFactorGraph``) but fixed-capacity SoA arrays — ``(i, j, z,
sqrt_info, mask)`` — so linearization is one ``vmap`` producing ``[F, 3, 3]``
Jacobian blocks and ``[F, 3]`` whitened residuals, and graph growth is a
masked append (SURVEY.md §8 hard part #1: capacity padding + active masks).

Parametrization: additive local coordinates ``(x, y, theta)`` with angle
wrapping — the standard 2D pose-graph treatment (same tangent space g2o uses
for SE2). Errors are defined so that for the *between* factor
``e = [R_i^T (t_j - t_i) - t_z ; wrap(th_j - th_i - th_z)]``; Jacobians are
analytic and unit-tested against ``jax.jacfwd`` (SURVEY.md §5 item 1).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ndtpu.lie import se2
from ndtpu.utils.runtime import MATMUL_PRECISION as _HI

__all__ = [
    "PoseGraph",
    "empty_graph",
    "add_pose",
    "add_prior",
    "add_between",
    "prior_error",
    "between_error",
    "linearize",
    "chi2",
    "info_to_sqrt_info",
    "robust_weight",
]


class PoseGraph(NamedTuple):
    """Fixed-capacity SE(2) pose graph (a pytree of arrays).

    Capacities ``V`` (poses), ``P`` (priors), ``F`` (between factors) are
    static; ``n_*`` scalars track the live prefix. Masks gate dead slots out
    of every reduction.
    """

    poses: jax.Array          # [V, 3]
    pose_mask: jax.Array      # [V] bool
    prior_idx: jax.Array      # [P] int32
    prior_z: jax.Array        # [P, 3]
    prior_sqrt_info: jax.Array  # [P, 3, 3]
    prior_mask: jax.Array     # [P] bool
    bet_i: jax.Array          # [F] int32
    bet_j: jax.Array          # [F] int32
    bet_z: jax.Array          # [F, 3]
    bet_sqrt_info: jax.Array  # [F, 3, 3]
    bet_mask: jax.Array       # [F] bool
    n_poses: jax.Array        # [] int32
    n_priors: jax.Array       # [] int32
    n_between: jax.Array      # [] int32

    @property
    def capacity(self):
        return self.poses.shape[0]


def empty_graph(max_poses: int, max_priors: int, max_between: int,
                dtype=jnp.float32) -> PoseGraph:
    return PoseGraph(
        poses=jnp.zeros((max_poses, 3), dtype),
        pose_mask=jnp.zeros((max_poses,), bool),
        prior_idx=jnp.zeros((max_priors,), jnp.int32),
        prior_z=jnp.zeros((max_priors, 3), dtype),
        prior_sqrt_info=jnp.zeros((max_priors, 3, 3), dtype),
        prior_mask=jnp.zeros((max_priors,), bool),
        bet_i=jnp.zeros((max_between,), jnp.int32),
        bet_j=jnp.zeros((max_between,), jnp.int32),
        bet_z=jnp.zeros((max_between, 3), dtype),
        bet_sqrt_info=jnp.zeros((max_between, 3, 3), dtype),
        bet_mask=jnp.zeros((max_between,), bool),
        n_poses=jnp.asarray(0, jnp.int32),
        n_priors=jnp.asarray(0, jnp.int32),
        n_between=jnp.asarray(0, jnp.int32),
    )


def _masked_set(arr, slot, value, ok):
    """``arr[slot] = value`` only when ``ok`` (jit-safe no-op otherwise)."""
    return arr.at[slot].set(jnp.where(ok, value, arr[slot]))


def add_pose(g: PoseGraph, pose, enabled=True) -> PoseGraph:
    """Masked append of a new pose variable; returns the updated graph.

    The new pose's index is the pre-append ``g.n_poses`` (callers capture it
    before calling). ``enabled`` may be traced (conditional append in jit).
    """
    enabled = jnp.asarray(enabled)
    slot = jnp.minimum(g.n_poses, g.capacity - 1)
    ok = enabled & (g.n_poses < g.capacity)
    return g._replace(
        poses=_masked_set(g.poses, slot, pose, ok),
        pose_mask=g.pose_mask.at[slot].set(ok | g.pose_mask[slot]),
        n_poses=g.n_poses + ok.astype(jnp.int32),
    )


def add_prior(g: PoseGraph, idx, z, sqrt_info, enabled=True) -> PoseGraph:
    """Masked append of a prior factor (jit-safe; overflows are dropped)."""
    slot = jnp.minimum(g.n_priors, g.prior_mask.shape[0] - 1)
    ok = jnp.asarray(enabled) & (g.n_priors < g.prior_mask.shape[0])
    return g._replace(
        prior_idx=_masked_set(g.prior_idx, slot, jnp.asarray(idx, jnp.int32), ok),
        prior_z=_masked_set(g.prior_z, slot, z, ok),
        prior_sqrt_info=_masked_set(g.prior_sqrt_info, slot, sqrt_info, ok),
        prior_mask=g.prior_mask.at[slot].set(ok | g.prior_mask[slot]),
        n_priors=g.n_priors + ok.astype(jnp.int32),
    )


def add_between(g: PoseGraph, i, j, z, sqrt_info, enabled=True) -> PoseGraph:
    """Masked append of a between factor."""
    slot = jnp.minimum(g.n_between, g.bet_mask.shape[0] - 1)
    ok = jnp.asarray(enabled) & (g.n_between < g.bet_mask.shape[0])
    return g._replace(
        bet_i=_masked_set(g.bet_i, slot, jnp.asarray(i, jnp.int32), ok),
        bet_j=_masked_set(g.bet_j, slot, jnp.asarray(j, jnp.int32), ok),
        bet_z=_masked_set(g.bet_z, slot, z, ok),
        bet_sqrt_info=_masked_set(g.bet_sqrt_info, slot, sqrt_info, ok),
        bet_mask=g.bet_mask.at[slot].set(ok | g.bet_mask[slot]),
        n_between=g.n_between + ok.astype(jnp.int32),
    )


def info_to_sqrt_info(info):
    """Upper-triangular sqrt-information ``R`` with ``R^T R = info``.

    3x3 Cholesky written out closed-form (no LAPACK dependency inside jit;
    batched over leading axes). ``info`` must be (made) SPD — callers clamp.
    """
    a = info
    l11 = jnp.sqrt(jnp.maximum(a[..., 0, 0], 1e-12))
    l21 = a[..., 1, 0] / l11
    l31 = a[..., 2, 0] / l11
    l22 = jnp.sqrt(jnp.maximum(a[..., 1, 1] - l21 * l21, 1e-12))
    l32 = (a[..., 2, 1] - l31 * l21) / l22
    l33 = jnp.sqrt(jnp.maximum(a[..., 2, 2] - l31 * l31 - l32 * l32, 1e-12))
    z = jnp.zeros_like(l11)
    # L lower; return R = L^T (upper) so that R^T R = L L^T = info.
    row0 = jnp.stack([l11, l21, l31], axis=-1)
    row1 = jnp.stack([z, l22, l32], axis=-1)
    row2 = jnp.stack([z, z, l33], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def prior_error(pose, z):
    """Unwhitened prior error ``[3]`` and its Jacobian (= identity)."""
    e = jnp.concatenate([pose[:2] - z[:2], se2.wrap(pose[2:3] - z[2:3])])
    return e


def between_error(pose_i, pose_j, z):
    """Unwhitened between error ``e = [R_i^T (t_j - t_i) - t_z ;
    wrap(th_j - th_i - th_z)]``."""
    c, s = jnp.cos(pose_i[2]), jnp.sin(pose_i[2])
    dx = pose_j[0] - pose_i[0]
    dy = pose_j[1] - pose_i[1]
    et = jnp.stack([c * dx + s * dy - z[0], -s * dx + c * dy - z[1]])
    eth = se2.wrap(pose_j[2:3] - pose_i[2:3] - z[2:3])
    return jnp.concatenate([et, eth])


def _between_jacobians(pose_i, pose_j):
    """Analytic ``(de/dxi [3,3], de/dxj [3,3])`` in additive coordinates."""
    c, s = jnp.cos(pose_i[2]), jnp.sin(pose_i[2])
    dx = pose_j[0] - pose_i[0]
    dy = pose_j[1] - pose_i[1]
    # d(R^T d)/dtheta_i with dR^T/dtheta = [[-s, c], [-c, -s]].
    dth_x = -s * dx + c * dy
    dth_y = -c * dx - s * dy
    ji = jnp.asarray(
        [[-c, -s, 0.0], [s, -c, 0.0], [0.0, 0.0, -1.0]], pose_i.dtype)
    ji = ji.at[0, 2].set(dth_x).at[1, 2].set(dth_y)
    jj = jnp.asarray([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]],
                     pose_i.dtype)
    return ji, jj


def robust_weight(r_norm, delta, kind: str = "huber"):
    """IRLS sqrt-weights for the standard robust kernels (GTSAM
    ``noiseModel::mEstimator`` capability, SURVEY.md §3.2).

    Applied multiplicatively to whitened Jacobian rows and residuals, so a
    weight ``s`` scales the factor's effective information by ``s^2``:

    - ``huber``:  s^2 = min(1, delta/|r|)
    - ``cauchy``: s^2 = 1 / (1 + (r/delta)^2)
    - ``tukey``:  s^2 = (1 - (r/delta)^2)^2 for |r| < delta else 0
    - ``geman``:  s^2 = delta^2 / (delta + r^2)^2 (Geman-McClure, scaled so
      s = 1 at r = 0 when delta = 1)
    """
    r = jnp.maximum(r_norm, 1e-12)
    if kind == "huber":
        return jnp.where(r <= delta, 1.0, jnp.sqrt(delta / r))
    if kind == "cauchy":
        return 1.0 / jnp.sqrt(1.0 + (r / delta) ** 2)
    if kind == "tukey":
        u = jnp.minimum(r / delta, 1.0)
        return 1.0 - u * u
    if kind == "geman":
        return delta / (delta + r * r)
    raise ValueError(f"unknown robust kernel {kind!r}")


def _huber_weight(r_norm, delta):
    return robust_weight(r_norm, delta, "huber")


def linearize(g: PoseGraph, huber_delta: float = 0.0,
              robust: str = "huber"):
    """Batched relinearization of every factor (SURVEY.md §3.2: 'one vmap
    over the factor SoA producing [F,3,3]/[F,3] blocks').

    Returns ``(bet, pri)`` where
    ``bet = (Ai [F,3,3], Aj [F,3,3], r [F,3])`` are whitened between-factor
    Jacobian blocks/residuals (masked rows are zero), and
    ``pri = (Ap [P,3,3], rp [P,3])`` likewise for priors. The linear system
    is ``min || A delta + r ||^2``.
    """
    pi = g.poses[g.bet_i]
    pj = g.poses[g.bet_j]

    def one_bet(pose_i, pose_j, z, sqi):
        e = between_error(pose_i, pose_j, z)
        ji, jj = _between_jacobians(pose_i, pose_j)
        return (jnp.matmul(sqi, ji, precision=_HI),
                jnp.matmul(sqi, jj, precision=_HI),
                jnp.matmul(sqi, e, precision=_HI))

    ai, aj, r = jax.vmap(one_bet)(pi, pj, g.bet_z, g.bet_sqrt_info)
    if huber_delta > 0.0:
        w = robust_weight(jnp.linalg.norm(r, axis=-1), huber_delta, robust)
        ai, aj, r = ai * w[:, None, None], aj * w[:, None, None], r * w[:, None]
    m = g.bet_mask.astype(r.dtype)
    ai, aj, r = ai * m[:, None, None], aj * m[:, None, None], r * m[:, None]

    def one_pri(pose, z, sqi):
        return sqi, jnp.matmul(sqi, prior_error(pose, z), precision=_HI)

    ap, rp = jax.vmap(one_pri)(g.poses[g.prior_idx], g.prior_z,
                               g.prior_sqrt_info)
    mp = g.prior_mask.astype(rp.dtype)
    ap, rp = ap * mp[:, None, None], rp * mp[:, None]
    return (ai, aj, r), (ap, rp)


def chi2(g: PoseGraph, huber_delta: float = 0.0, robust: str = "huber"):
    """Total weighted squared error (GTSAM ``graph.error`` capability)."""
    (ai, aj, r), (ap, rp) = linearize(g, huber_delta, robust)
    return jnp.sum(r * r) + jnp.sum(rp * rp)
