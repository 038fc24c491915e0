"""Supernodal partitioned Cholesky: direct sparse elimination as batched
dense blocks (BASELINE config 4; SURVEY.md §3.2 "Inference / elimination").

GTSAM eliminates with a sequential multifrontal QR/Cholesky over a clique
tree. This re-engineering turns the same math into three batched dense
stages with NO sequential factor-level loop:

1. **Partition** (host, once per topology): split the (optionally
   RCM-permuted — ndtpu.native) pose order into P contiguous supernodes;
   poses touched by cross-supernode factors form the separator (exactly the
   nested-dissection interface).
2. **Batched interior elimination** (device): all P supernode systems
   ``H_II^(s)`` are factorized in ONE batched Cholesky ``[P, ni3, ni3]`` and
   their Schur contributions are formed with batched triangular solves +
   einsums — the "supernodal frontal matrices as blocked XLA ops" design.
3. **Separator solve + batched back-substitution**: the reduced dense
   system (sum of Schur contributions) is factorized once; interiors
   back-substitute in parallel.

The identical partition logic drives the multi-host distributed solve
(ndtpu.dist.schur) — this module is its single-chip batched counterpart and
the throughput path for 10k+-pose graphs where a [3V, 3V] dense factor does
not fit (30k x 30k f32 = 3.6 GB) and PCG iteration counts climb.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from ndtpu.config import SolverConfig
from ndtpu.dist.schur import SchurPlan, plan_partition
from ndtpu.graph import factors as fct
from ndtpu.graph import solve as slv
from ndtpu.utils.runtime import MATMUL_PRECISION as _HI

__all__ = ["SupernodalPlan", "plan_supernodal", "supernodal_delta",
           "optimize_supernodal"]


class SupernodalPlan(NamedTuple):
    schur: SchurPlan
    perm: np.ndarray       # [V] RCM permutation (position -> original pose)
    n_shards: int
    # Per-shard LOCAL separator maps (r4): each supernode couples to only a
    # few separator poses, so the interior-separator block is [ni3, ns_loc3]
    # per shard instead of [ni3, ns3] against the GLOBAL separator — the
    # dense global coupling made the Schur contraction the step's dominant
    # cost (~160 of 235 GFLOP at 10k poses, ~30x more than the sparse
    # structure needs).
    ns_loc: int            # padded local separator slots per shard
    ls_global: np.ndarray  # [P, NSL] global separator slot per local slot
    ls_mask: np.ndarray    # [P, NSL]
    i_loc_l: np.ndarray    # [P, F] LOCAL separator slot of endpoint i
    j_loc_l: np.ndarray    # [P, F]
    p_loc_l: np.ndarray    # [P, Q]


def plan_supernodal(graph: fct.PoseGraph, n_shards: int,
                    use_rcm: bool = False) -> SupernodalPlan:
    """Host-side symbolic analysis: ordering + supernode partition.

    ``use_rcm=False`` by default: SLAM trajectories and Manhattan walks are
    already near-banded in their natural (temporal) order, and contiguous
    partitioning of that order gives the smallest separators (measured on
    10k-pose Manhattan, P=64: natural ns=558 vs RCM ns=1766 — RCM's level-set
    relabeling scatters loop endpoints across supernode boundaries). Enable
    RCM for graphs whose natural order has no locality (e.g. shuffled g2o
    files)."""
    bet_i = np.asarray(graph.bet_i)
    bet_j = np.asarray(graph.bet_j)
    bet_mask = np.asarray(graph.bet_mask)
    v = graph.poses.shape[0]

    if use_rcm:
        from ndtpu.native import rcm_order
        live = bet_mask
        perm = rcm_order(bet_i[live], bet_j[live], v)   # position -> vertex
    else:
        perm = np.arange(v, dtype=np.int32)
    inv = np.empty(v, np.int64)
    inv[perm] = np.arange(v)

    plan = plan_partition(
        inv[bet_i].astype(np.int32), inv[bet_j].astype(np.int32), bet_mask,
        inv[np.asarray(graph.prior_idx)].astype(np.int32),
        np.asarray(graph.prior_mask), v, n_shards)
    p_dim, ni, ns = plan.fac_idx.shape[0], plan.ni, plan.ns
    # Per-shard LOCAL separator maps: which global separator slots does each
    # shard's factor/prior set actually touch? (Host-side symbolic work,
    # once per topology.)
    p_dim = plan.fac_idx.shape[0]
    sep_sets = []
    for s in range(p_dim):
        slots = set()
        fm = plan.fac_mask[s]
        slots.update(plan.i_loc[s][fm & (plan.i_role[s] == 1)].tolist())
        slots.update(plan.j_loc[s][fm & (plan.j_role[s] == 1)].tolist())
        pm = plan.pri_mask[s]
        slots.update(plan.p_loc[s][pm & (plan.p_role[s] == 1)].tolist())
        sep_sets.append(sorted(slots))
    ns_loc = max(1, max(len(x) for x in sep_sets))
    ls_global = np.zeros((p_dim, ns_loc), np.int32)
    ls_mask = np.zeros((p_dim, ns_loc), bool)
    local_of = [dict() for _ in range(p_dim)]
    for s, slots in enumerate(sep_sets):
        ls_global[s, : len(slots)] = slots
        ls_mask[s, : len(slots)] = True
        local_of[s] = {gs: k for k, gs in enumerate(slots)}

    def to_local(role, loc, mask):
        out = np.zeros_like(loc)
        for s in range(p_dim):
            sep_rows = mask[s] & (role[s] == 1)
            out[s, sep_rows] = [local_of[s][gs]
                                for gs in loc[s, sep_rows].tolist()]
        return out.astype(np.int32)

    i_loc_l = to_local(plan.i_role, plan.i_loc, plan.fac_mask)
    j_loc_l = to_local(plan.j_role, plan.j_loc, plan.fac_mask)
    p_loc_l = to_local(plan.p_role, plan.p_loc, plan.pri_mask)

    # One-level Schur guards: the fused segment_sum routes blocks by
    # comparing flat ids against the 2**30 no-match sentinel, so the
    # COMBINED id space n_ii + n_is + n_ss must stay below it (ADVICE r4:
    # an n_ii >= 2**30 would silently misroute interior blocks into the
    # is/ss classes — wrong Hessian, no error); and a huge global separator
    # means the replicated [3ns, 3ns] dense solve dominates. Fail with
    # guidance instead of a silent corruption deep in the step.
    n_ii = p_dim * ni * ni * 9
    n_is = p_dim * ni * ns_loc * 9
    n_ss = ns * ns * 9
    if n_ii + n_is + n_ss >= 2**30 or ns > 20000:
        raise ValueError(
            f"graph too large for the supernodal path (ns={ns}, "
            f"ns_loc={ns_loc}, flat ids={n_ii + n_is + n_ss:.2e} vs the "
            f"2**30 sentinel bound): this graph partitions poorly at "
            f"n_shards={n_shards}. Use fewer shards, "
            f"or the matrix-free PCG solver "
            f"(ndtpu.graph.solve.optimize(method='pcg')) which scales to "
            f"100k+ poses.")

    # Re-express the plan's variable maps in ORIGINAL pose indices so the
    # device step scatters straight into the unpermuted delta.
    plan = plan._replace(
        int_global=perm[plan.int_global].astype(np.int32),
        sep_global=perm[plan.sep_global].astype(np.int32),
    )
    return SupernodalPlan(schur=plan, perm=np.asarray(perm),
                          n_shards=n_shards, ns_loc=ns_loc,
                          ls_global=ls_global, ls_mask=ls_mask,
                          i_loc_l=i_loc_l, j_loc_l=j_loc_l, p_loc_l=p_loc_l)


def _assemble_parts(splan: SupernodalPlan, ai, aj, r, ap, rp, dt):
    """Assemble the partitioned normal equations WITHOUT any per-shard
    ``[m, m]`` dense structure.

    The previous formulation built ``[P, ni+ns, ni+ns, 3, 3]`` per shard —
    quadratic in the GLOBAL separator count (and padded in its trailing
    ``[3, 3]`` by tiled layouts). Here every 3x3 factor block is routed by a flat
    segment id into exactly one of three right-sized targets:

    - ``h_ii [P, ni3, ni3]``  interior-interior (same shard by construction)
    - ``h_is [P, ni3, ns3]``  interior-separator
    - ``h_ss [ns3, ns3]``     separator-separator, assembled GLOBALLY once

    plus ``b_i [P, ni3]`` / ``b_s [ns3]``. Everything is a handful of
    ``segment_sum`` calls over the ~4F ordered endpoint pairs; mismatched
    pair types go to a dead segment that is dropped.
    """
    plan = splan.schur
    ni, ns = plan.ni, plan.ns
    ns_loc = splan.ns_loc
    p_dim, fmax = plan.fac_idx.shape

    fac_idx = jnp.asarray(plan.fac_idx)
    fac_mask = jnp.asarray(plan.fac_mask)
    i_role = jnp.asarray(plan.i_role)
    i_loc = jnp.asarray(plan.i_loc)
    j_role = jnp.asarray(plan.j_role)
    j_loc = jnp.asarray(plan.j_loc)
    pri_idx = jnp.asarray(plan.pri_idx)
    pri_mask = jnp.asarray(plan.pri_mask)
    p_role = jnp.asarray(plan.p_role)
    p_loc = jnp.asarray(plan.p_loc)
    i_loc_l = jnp.asarray(splan.i_loc_l)
    j_loc_l = jnp.asarray(splan.j_loc_l)
    p_loc_l = jnp.asarray(splan.p_loc_l)

    fm = fac_mask.astype(dt)
    fa_i = ai[fac_idx] * fm[..., None, None]          # [P, F, 3, 3]
    fa_j = aj[fac_idx] * fm[..., None, None]
    fr = r[fac_idx] * fm[..., None]                   # [P, F, 3]
    pm = pri_mask.astype(dt)
    pa = ap[pri_idx] * pm[..., None, None]            # [P, Q, 3, 3]
    pr = rp[pri_idx] * pm[..., None]

    shard = jnp.arange(p_dim, dtype=jnp.int32)[:, None]

    # Ordered endpoint pairs (A, B) per factor: (i,i), (i,j), (j,i), (j,j)
    # plus the prior's (p, p); block_AB = A^T B.
    def pairs(role_a, loc_a, blk_a, role_b, loc_b, blk_b, valid):
        blocks = jnp.einsum("pfab,pfac->pfbc", blk_a, blk_b, precision=_HI)
        return (role_a, loc_a, role_b, loc_b, blocks,
                jnp.broadcast_to(shard, role_a.shape), valid)

    plist = [
        pairs(i_role, i_loc, fa_i, i_role, i_loc, fa_i, fac_mask),
        pairs(i_role, i_loc, fa_i, j_role, j_loc, fa_j, fac_mask),
        pairs(j_role, j_loc, fa_j, i_role, i_loc, fa_i, fac_mask),
        pairs(j_role, j_loc, fa_j, j_role, j_loc, fa_j, fac_mask),
        pairs(p_role, p_loc, pa, p_role, p_loc, pa, pri_mask),
    ]
    cat = lambda k: jnp.concatenate([jnp.reshape(p[k], (-1,) + p[k].shape[2:])
                                     for p in plist])
    ra, la, rb, lb = cat(0), cat(1), cat(2), cat(3)
    blocks = cat(4).reshape(-1, 9)
    shards = cat(5)
    valid = cat(6)
    # The B-side LOCAL separator slot for each ordered pair (same B order
    # as lb above: i, j, i, j, p) — routes interior-separator couplings
    # into the [ni3, ns_loc3] per-shard block instead of the global-width
    # [ni3, ns3] one.
    lb_l = jnp.concatenate([x.reshape(-1) for x in
                            (i_loc_l, j_loc_l, i_loc_l, j_loc_l, p_loc_l)])

    seg = jax.ops.segment_sum
    ii = (ra == 0) & (rb == 0) & valid
    is_ = (ra == 0) & (rb == 1) & valid
    ss = (ra == 1) & (rb == 1) & valid
    n_ii = p_dim * ni * ni * 9
    n_is = p_dim * ni * ns_loc * 9
    n_ss = ns * ns * 9
    # Scalar-flat segment ids laid out so the segment_sum output IS the
    # dense [..., 3R, 3C] matrix after a plain reshape: id = ((row*3 + a)
    # * 3C) + col*3 + b. Scattering [K*9] scalars into a flat [n] target
    # avoids an [n, 9]-shaped target with a short trailing dim.
    a_comp = jnp.arange(3, dtype=jnp.int32)[:, None]      # [3, 1]
    b_comp = jnp.arange(3, dtype=jnp.int32)[None, :]      # [1, 3]

    def flat_ids(row, col, n_cols, match):
        base = jnp.where(match, row, -1)                  # [K]
        ids = ((base[:, None, None] * 3 + a_comp) * (3 * n_cols)
               + col[:, None, None] * 3 + b_comp)         # [K, 3, 3]
        return jnp.where(match[:, None, None], ids, 2 ** 30).reshape(-1)

    vals = blocks.reshape(-1)                             # [K*9]
    ii_idx = flat_ids(shards * ni + la, lb, ni, ii)
    is_idx = flat_ids(shards * ni + la, lb_l, ns_loc, is_)
    ss_idx = flat_ids(la, lb, ns, ss)
    # ONE segment_sum over the disjoint union of the three target spaces
    # (each ordered pair belongs to exactly one class): the device trace
    # showed three separate 500k-scalar scatters as the step's dominant
    # fusions — combining them does the index routing once.
    n_all = n_ii + n_is + n_ss
    mark = 2 ** 30                       # flat_ids' no-match sentinel
    comb = jnp.where(ii_idx < mark, ii_idx,
                     jnp.where(is_idx < mark, is_idx + n_ii,
                               jnp.where(ss_idx < mark,
                                         ss_idx + n_ii + n_is, n_all)))
    h_all = seg(vals, comb, num_segments=n_all + 1)
    h_ii = h_all[:n_ii].reshape(p_dim, 3 * ni, 3 * ni)
    h_is = h_all[n_ii:n_ii + n_is].reshape(p_dim, 3 * ni, 3 * ns_loc)
    h_ss = h_all[n_ii + n_is:n_all].reshape(3 * ns, 3 * ns)

    # Right-hand side: one entry per factor endpoint (A^T r).
    def bvec(role_a, loc_a, blk_a, res, valid):
        vec = jnp.einsum("pfab,pfa->pfb", blk_a, res, precision=_HI)
        return (role_a, loc_a, vec, jnp.broadcast_to(shard, role_a.shape),
                valid)

    blist = [
        bvec(i_role, i_loc, fa_i, fr, fac_mask),
        bvec(j_role, j_loc, fa_j, fr, fac_mask),
        bvec(p_role, p_loc, pa, pr, pri_mask),
    ]
    catb = lambda k: jnp.concatenate(
        [jnp.reshape(p[k], (-1,) + p[k].shape[2:]) for p in blist])
    rb_a, lb_a, vecs, shards_b, valid_b = (catb(0), catb(1), catb(2),
                                           catb(3), catb(4))
    # One fused scatter for both RHS targets (disjoint classes).
    nb_i = p_dim * ni
    b_idx = jnp.where((rb_a == 0) & valid_b, shards_b * ni + lb_a,
                      jnp.where((rb_a == 1) & valid_b, nb_i + lb_a,
                                nb_i + ns))
    b_all = seg(vecs, b_idx, num_segments=nb_i + ns + 1)
    b_i = b_all[:nb_i].reshape(p_dim, ni, 3)
    b_s = b_all[nb_i:nb_i + ns]

    return (h_ii, h_is, h_ss,
            b_i.reshape(p_dim, 3 * ni), b_s.reshape(3 * ns))


def supernodal_delta(graph: fct.PoseGraph, lin, plan: SupernodalPlan, lam):
    """One damped-GN step via batched supernodal elimination.

    All heavy stages are batched dense ops: ``[P, ni3, ni3]`` Cholesky,
    ``[P, ni3, ns3]`` triangular solves, one ``[ns3, ns3]`` reduced solve.
    """
    (ai, aj, r), (ap, rp) = lin
    dt = ai.dtype
    sp = plan.schur
    v = graph.poses.shape[0]
    p_dim = sp.fac_idx.shape[0]
    nsl3 = 3 * plan.ns_loc
    ns3 = 3 * sp.ns

    h_ii, h_is, h_ss, b_i, b_s = _assemble_parts(plan, ai, aj, r, ap, rp, dt)

    int_mask = jnp.asarray(sp.int_mask)
    live_i = jnp.repeat(int_mask.astype(dt), 3, axis=1)          # [P, ni3]
    diag_i = jnp.abs(jnp.diagonal(h_ii, axis1=-2, axis2=-1))
    damp_i = lam * jnp.maximum(diag_i, 1e-8) + (1.0 - live_i)
    h_ii = h_ii + jax.vmap(jnp.diag)(damp_i)

    l = jnp.linalg.cholesky(h_ii)                                # [P,ni3,ni3]
    # Invert once (triangular solves against I, the narrow RHS) and apply by
    # GEMM instead of solving the wide [ni3, nsl3] RHS by substitution (the
    # two are not compared on the GPU).
    eye_i = jnp.broadcast_to(jnp.eye(h_ii.shape[-1], dtype=dt), h_ii.shape)
    h_ii_inv = jax.scipy.linalg.cho_solve((l, True), eye_i)
    w = jnp.matmul(h_ii_inv, h_is, precision=_HI)                # [P,ni3,nsl3]
    y = jnp.einsum("pij,pj->pi", h_ii_inv, b_i, precision=_HI)

    # Per-shard LOCAL Schur contributions [P, nsl3, nsl3], scattered into
    # the global separator system by flat segment ids. The previous
    # formulation contracted against the GLOBAL-width [ni3, ns3] coupling —
    # ~30x the FLOPs the sparse structure needs (the dominant step cost).
    s_part = jnp.einsum("pij,pik->pjk", h_is, w,
                        precision=_HI)                           # [P,nsl3,nsl3]
    rhs_part = jnp.einsum("pij,pi->pj", h_is, y,
                          precision=_HI)                         # [P, nsl3]

    ls_global = jnp.asarray(plan.ls_global)                      # [P, NSL]
    ls_mask = jnp.asarray(plan.ls_mask)
    comp = jnp.arange(3, dtype=jnp.int32)
    # Global flat row/col index per local component (dead slots -> dropped).
    gidx = (ls_global[:, :, None] * 3 + comp[None, None, :]).reshape(
        p_dim, nsl3)                                             # [P, nsl3]
    gvalid = jnp.repeat(ls_mask, 3, axis=1)                      # [P, nsl3]
    pair_idx = jnp.where(gvalid[:, :, None] & gvalid[:, None, :],
                         gidx[:, :, None] * ns3 + gidx[:, None, :],
                         ns3 * ns3)
    seg = jax.ops.segment_sum
    s_red = seg(s_part.reshape(-1), pair_idx.reshape(-1),
                num_segments=ns3 * ns3 + 1)[:-1].reshape(ns3, ns3)
    rhs_red = seg(rhs_part.reshape(-1),
                  jnp.where(gvalid, gidx, ns3).reshape(-1),
                  num_segments=ns3 + 1)[:-1]

    s_tot = h_ss - s_red
    rhs_tot = b_s - rhs_red
    diag_ss = jnp.diagonal(h_ss)

    sep_mask = jnp.asarray(sp.sep_mask)
    live_s = jnp.repeat(sep_mask.astype(dt), 3)
    damp_s = lam * jnp.maximum(jnp.abs(diag_ss), 1e-8) + (1.0 - live_s)
    s_tot = s_tot + jnp.diag(damp_s)
    ls = jnp.linalg.cholesky(s_tot)
    x_s = jax.scipy.linalg.cho_solve((ls, True), -rhs_tot)

    # Back-substitute with each shard's GATHERED local separator solution.
    x_s_loc = jnp.where(gvalid, x_s[jnp.clip(gidx, 0, ns3 - 1)], 0.0)
    x_i = -(y + jnp.einsum("pij,pj->pi", w, x_s_loc,
                           precision=_HI))                        # [P, ni3]

    delta = jnp.zeros((v, 3), dt)
    delta = delta.at[jnp.asarray(sp.int_global)].add(
        x_i.reshape(-1, sp.ni, 3) * int_mask[..., None].astype(dt))
    delta = delta.at[jnp.asarray(sp.sep_global)].add(
        x_s.reshape(sp.ns, 3) * sep_mask[:, None].astype(dt))
    return delta


def optimize_supernodal(graph: fct.PoseGraph, cfg: SolverConfig,
                        n_shards: int = 32, huber_delta: float = 0.0,
                        plan: SupernodalPlan | None = None) -> slv.SolveResult:
    """Nonlinear LM loop around the supernodal step (config 4 entry point)."""
    if plan is None:
        plan = plan_supernodal(graph, n_shards)
    dt = graph.poses.dtype

    step = jax.jit(lambda g, lin, lam: supernodal_delta(g, lin, plan, lam))

    lam = cfg.init_lambda
    chi = float(fct.chi2(graph, huber_delta))
    it, converged = 0, False
    for it in range(1, cfg.max_iter + 1):
        lin = fct.linearize(graph, huber_delta)
        delta = step(graph, lin, jnp.asarray(lam, dt))
        trial = graph._replace(
            poses=slv._apply_delta(graph.poses, delta, graph.pose_mask))
        chi_t = float(fct.chi2(trial, huber_delta))
        if chi_t < chi:
            graph, chi = trial, chi_t
            lam = max(lam / cfg.lambda_down, 1e-12)
            if float(jnp.max(jnp.abs(delta))) < cfg.tol:
                converged = True
                break
        else:
            lam *= cfg.lambda_up
            if lam > 1e8:
                break
    return slv.SolveResult(graph=graph, chi2=jnp.asarray(chi, dt),
                           n_iter=jnp.asarray(it, jnp.int32),
                           converged=jnp.asarray(converged))
