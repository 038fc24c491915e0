"""Trajectory evaluation: ATE (Umeyama-aligned RMSE) and RPE.

Capability parity with the reference's evaluation stage (SURVEY.md §3.1
"Evaluation"): absolute trajectory error after optimal SE(2) alignment, plus
the Kummerle-style relative (relation) metric — SURVEY.md §8 notes Intel/MIT
lack true ground truth, so the relative metric travels better to real logs.
"""

from __future__ import annotations

import jax.numpy as jnp

from ndtpu.lie import se2
from ndtpu.utils.runtime import MATMUL_PRECISION as _HI

__all__ = ["align_se2", "ate_rmse", "rpe"]


def align_se2(est_xy, gt_xy):
    """Closed-form 2D Umeyama: rotation+translation minimizing
    ``sum ||gt - (R est + t)||^2``. Returns ``(theta, t [2])``."""
    em = jnp.mean(est_xy, axis=0)
    gm = jnp.mean(gt_xy, axis=0)
    e = est_xy - em
    g = gt_xy - gm
    # R maximizes trace(R * sum(e g^T)) -> theta = atan2(sum cross, sum dot).
    dot = jnp.sum(e * g)
    cross = jnp.sum(e[:, 0] * g[:, 1] - e[:, 1] * g[:, 0])
    theta = jnp.arctan2(cross, dot)
    c, s = jnp.cos(theta), jnp.sin(theta)
    r = jnp.array([[c, -s], [s, c]], est_xy.dtype)
    t = gm - jnp.matmul(r, em, precision=_HI)
    return theta, t


def ate_rmse(est_poses, gt_poses, align: bool = True):
    """Absolute trajectory error (RMSE of positions, meters).

    est_poses/gt_poses: ``[T, 3]``. With ``align=True`` the estimate is first
    rigidly aligned to ground truth (standard ATE protocol).
    """
    e, g = est_poses[:, :2], gt_poses[:, :2]
    if align:
        theta, t = align_se2(e, g)
        c, s = jnp.cos(theta), jnp.sin(theta)
        r = jnp.array([[c, -s], [s, c]], e.dtype)
        e = jnp.matmul(e, r.T, precision=_HI) + t
    return jnp.sqrt(jnp.mean(jnp.sum((e - g) ** 2, axis=-1)))


def rpe(est_poses, gt_poses, delta: int = 1):
    """Relative pose error over a step of ``delta`` frames.

    Returns ``(trans_rmse, rot_rmse)`` — the relation-based metric of
    Kummerle et al. 2009 with consecutive relations.
    """
    e_rel = se2.between(est_poses[:-delta], est_poses[delta:])
    g_rel = se2.between(gt_poses[:-delta], gt_poses[delta:])
    err = se2.between(g_rel, e_rel)
    t_rmse = jnp.sqrt(jnp.mean(jnp.sum(err[:, :2] ** 2, axis=-1)))
    r_rmse = jnp.sqrt(jnp.mean(err[:, 2] ** 2))
    return t_rmse, r_rmse
