"""Incremental pose-graph smoothing: the iSAM2-capability re-engineering.

Capability parity (SURVEY.md §3.2 "iSAM2 incremental smoother", §4.3): after
each new keyframe the backend must refine the trajectory at bounded cost —
GTSAM does this with a Bayes tree (mark affected cliques, selective
relinearization, partial re-elimination). A pointer-based Bayes tree is the
wrong shape for batched tensor programs, so the *capability* is re-engineered (SURVEY.md §8
Phase C, explicitly "not a port"):

- **Warm start replaces partial re-elimination.** The current estimate is
  the linearization point; right after a new keyframe only a small
  neighborhood of the graph is far from its optimum, so the damped-GN
  residual is tiny and block-Jacobi PCG reaches its *relative* tolerance in
  a handful of matvecs. Cost per update is O(nnz * pcg_iters) with
  pcg_iters small and data-adaptive — the bounded-cost property iSAM2 gets
  from clique marking, obtained instead from Krylov convergence.
- **Relinearization is batched, and skipped when useless.** Relinearizing
  *all* factors is one vmap; the iSAM2 relinearization
  *threshold* survives as a skip test — if the last accepted step moved no
  pose by more than ``relin_threshold``, the estimate is declared settled
  and the update does zero solves (``lax.cond`` fast path).
- **Periodic full solve replaces periodic batch relinearization**
  (``ISAM2Params.enableRelinearization`` cadence): every
  ``full_solve_every`` updates a full LM optimization with a larger
  iteration budget squeezes out accumulated nonlinearity.

The whole update is one jittable function of static config — usable inside
scan loops and shardable (factor/pose axes) with NamedSharding.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ndtpu.config import SolverConfig
from ndtpu.graph import factors as fct
from ndtpu.graph import solve as slv
from ndtpu.lie import se2
from ndtpu.utils.runtime import MATMUL_PRECISION as _HI

__all__ = ["SmootherState", "init_smoother", "incremental_update",
           "local_update", "fresh_residual_max", "full_solve",
           "marginal_covariance", "marginal_covariance_pcg"]


class SmootherState(NamedTuple):
    graph: fct.PoseGraph
    lam: jax.Array          # [] LM damping carried across updates
    last_max_delta: jax.Array  # [] inf-norm of the last accepted step
    step: jax.Array         # [] int32 update counter


def init_smoother(graph: fct.PoseGraph) -> SmootherState:
    dt = graph.poses.dtype
    return SmootherState(
        graph=graph,
        lam=jnp.asarray(1e-4, dt),
        last_max_delta=jnp.asarray(jnp.inf, dt),
        step=jnp.asarray(0, jnp.int32),
    )


def _one_lm_step(graph, lam, chi, cfg: SolverConfig, huber_delta: float):
    """One accept/reject LM iteration with a PCG inner solve."""
    lin = fct.linearize(graph, huber_delta)
    delta, _ = slv.pcg(graph, lin, lam, cfg)
    new_poses = slv._apply_delta(graph.poses, delta, graph.pose_mask)
    trial = graph._replace(poses=new_poses)
    chi_t = fct.chi2(trial, huber_delta)
    accept = chi_t < chi
    graph_n = jax.tree_util.tree_map(
        lambda a, b: jnp.where(accept, a, b), trial, graph)
    chi_n = jnp.where(accept, chi_t, chi)
    lam_n = jnp.where(accept, jnp.maximum(lam / cfg.lambda_down, 1e-12),
                      lam * cfg.lambda_up)
    max_delta = jnp.where(accept, jnp.max(jnp.abs(delta)),
                          jnp.zeros_like(chi))
    return graph_n, chi_n, lam_n, max_delta


def fresh_residual_max(g: fct.PoseGraph, k: int = 64):
    """Max |whitened residual| over the K NEWEST live between factors.

    The O(K) replacement for the full-graph gradient in the settled-skip
    test (VERDICT r2 item 5: the skip path paid a full O(F) linearize):
    when the estimate was settled, only the factors appended since can
    perturb it, and those sit in the slots just below ``n_between``.
    """
    f_cap = g.bet_mask.shape[0]
    k = min(k, f_cap)
    start = jnp.clip(g.n_between - k, 0, f_cap - k)
    sl = lambda a: jax.lax.dynamic_slice_in_dim(a, start, k, axis=0)
    i, j = sl(g.bet_i), sl(g.bet_j)
    z, sqi = sl(g.bet_z), sl(g.bet_sqrt_info)
    m = sl(g.bet_mask)
    r = jax.vmap(fct.between_error)(g.poses[i], g.poses[j], z)
    wr = jnp.einsum("fab,fb->fa", sqi, r, precision=_HI)
    return jnp.max(jnp.where(m[:, None], jnp.abs(wr), 0.0))


def _fresh_slice(g: fct.PoseGraph, k: int, since=None):
    """(i, j, mask) of the newest between-factor slots.

    ``since`` (the factor count at the previous update) marks exactly the
    factors appended since; without it the newest K slots are assumed
    fresh — conservative for callers that do not track the cursor."""
    f_cap = g.bet_mask.shape[0]
    k = min(k, f_cap)
    start = jnp.clip(g.n_between - k, 0, f_cap - k)
    sl = lambda a: jax.lax.dynamic_slice_in_dim(a, start, k, axis=0)
    slots = jnp.arange(k) + start
    fresh_live = slots < g.n_between
    if since is not None:
        fresh_live = fresh_live & (slots >= since)
    return sl(g.bet_i), sl(g.bet_j), sl(g.bet_mask) & fresh_live


def _active_probe(g: fct.PoseGraph, cfg: SolverConfig, since=None):
    """k-hop active set around the newest factors + local-update viability.

    O(hops * F) elementwise scatter/gather — cheap enough to run before
    every update to pick the local-vs-global path. ``ok`` is False when the
    active set or its touching factors overflow the static capacities.

    A fresh factor spanning a loop (index gap > ``local_span_gap``) no
    longer forces the global path outright (VERDICT r4 missing #5: in
    loop-dense stretches that disabled the bounded-cost property exactly
    when the backend is busiest). Its correction must propagate around the
    whole CYCLE, so the cycle's poses — the contiguous index interval
    between the factor's endpoints (keyframes are appended
    chronologically, so the chain between the endpoints IS the cycle) —
    are seeded into the active set. When the cycle fits ``local_poses``
    the local solve contains every pose the correction reaches (boundary
    still held fixed); a cycle too long to fit overflows the capacity
    check and falls back to the global path, same as before.
    """
    v = g.poses.shape[0]
    fi, fj, fm = _fresh_slice(g, cfg.local_fresh_k, since)
    loopy_f = fm & (jnp.abs(fi - fj) > cfg.local_span_gap)
    # One bounding interval over all fresh loop factors (conservative
    # union; static shapes).
    lo = jnp.min(jnp.where(loopy_f, jnp.minimum(fi, fj), v))
    hi = jnp.max(jnp.where(loopy_f, jnp.maximum(fi, fj), -1))
    ids = jnp.arange(v, dtype=jnp.int32)
    cyc = (ids >= lo) & (ids <= hi)           # empty when no loopy factor

    act = jnp.zeros((v,), jnp.int32)
    act = act.at[fi].max(fm.astype(jnp.int32))
    act = act.at[fj].max(fm.astype(jnp.int32))
    act = jnp.maximum(act, cyc.astype(jnp.int32))
    m_i32 = g.bet_mask.astype(jnp.int32)
    for _ in range(cfg.local_hops):
        fa = m_i32 * jnp.maximum(act[g.bet_i], act[g.bet_j])
        act = act.at[g.bet_i].max(fa)
        act = act.at[g.bet_j].max(fa)
    act = act.astype(bool) & g.pose_mask
    touch = g.bet_mask & (act[g.bet_i] | act[g.bet_j])
    ok = ((jnp.sum(act, dtype=jnp.int32) <= cfg.local_poses)
          & (jnp.sum(touch, dtype=jnp.int32) <= cfg.local_factors))
    if since is not None:
        # Fresh-window overflow (ADVICE r4, medium): if more factors landed
        # since the last update than the fresh window holds, the overflowed
        # ones are neither seeded into the active set nor span-tested —
        # the local path would silently skip their corrections (possibly a
        # buried loop factor). Fall back to the global update instead.
        k = min(cfg.local_fresh_k, g.bet_mask.shape[0])
        ok = ok & (g.n_between - since <= k)
    return act, touch, ok


def _local_select(g: fct.PoseGraph, cfg: SolverConfig, since=None,
                  probe=None):
    """Topology-only selection for the k-hop local system: active-pose slot
    assignment, local index map, gathered-factor ids, endpoint roles.

    Hoisted out of the GN iteration (and reusable across iterations): the
    probe and two top_k sorts are O(V) over the whole graph, while the
    per-iteration relinearize/assemble/solve touches only the local
    subproblem.
    """
    from ndtpu.dist.schur import INTERIOR, SEPARATOR

    v = g.poses.shape[0]
    p_loc = min(cfg.local_poses, v)
    f_loc = min(cfg.local_factors, g.bet_mask.shape[0])
    act, touch, ok = (probe if probe is not None
                      else _active_probe(g, cfg, since))

    _, pid = jax.lax.top_k(act.astype(jnp.int32), p_loc)      # [P] pose ids
    in_set = act[pid]                                          # [P]
    loc_of = jnp.full((v,), 0, jnp.int32).at[pid].set(
        jnp.arange(p_loc, dtype=jnp.int32))
    _, fid = jax.lax.top_k(touch.astype(jnp.int32), f_loc)
    f_sel = touch[fid]                                         # [F] bool
    bi, bj = g.bet_i[fid], g.bet_j[fid]
    role = lambda ids: jnp.where(act[ids], INTERIOR, SEPARATOR).astype(
        jnp.int32)
    p_act = act[g.prior_idx] & g.prior_mask
    return dict(p_loc=p_loc, pid=pid, in_set=in_set, loc_of=loc_of,
                fid=fid, f_sel=f_sel, bi=bi, bj=bj,
                ri=role(bi), rj=role(bj), rp=role(g.prior_idx),
                p_act=p_act, ok=ok)


def _local_system(g: fct.PoseGraph, cfg: SolverConfig, huber_delta: float,
                  sel):
    """Static-capacity k-hop active subproblem around the newest factors.

    The clique-local bounded-cost property of iSAM2 (VERDICT r3 weak 5),
    re-engineered for static shapes: active poses = `local_hops`-hop
    factor-neighborhood of the newest `local_fresh_k` factors (two masked
    scatter/gather sweeps per hop); the gathered factor set is everything
    touching an active pose, with inactive endpoints held FIXED — their
    blocks are routed to a discarded separator slot by the same flat
    segment-id assembly the distributed Schur solve uses, which is exactly
    the conditional (Gauss-Seidel block) system.

    ``sel`` comes from :func:`_local_select`. Returns ``(solve, chi_local)``.
    """
    from ndtpu.dist.schur import assemble_local_parts

    v = g.poses.shape[0]
    p_loc = sel["p_loc"]
    pid, in_set, loc_of = sel["pid"], sel["in_set"], sel["loc_of"]
    fid, f_sel, bi, bj = sel["fid"], sel["f_sel"], sel["bi"], sel["bj"]
    p_act = sel["p_act"]

    # Linearization of just the gathered slice.
    def one_bet(pose_i, pose_j, z1, s1):
        e = fct.between_error(pose_i, pose_j, z1)
        ji, jj = fct._between_jacobians(pose_i, pose_j)
        return (jnp.matmul(s1, ji, precision=_HI),
                jnp.matmul(s1, jj, precision=_HI),
                jnp.matmul(s1, e, precision=_HI))

    ai, aj, r = jax.vmap(one_bet)(g.poses[bi], g.poses[bj],
                                  g.bet_z[fid], g.bet_sqrt_info[fid])
    if huber_delta > 0.0:
        w = fct.robust_weight(jnp.linalg.norm(r, axis=-1), huber_delta)
        ai, aj, r = (ai * w[:, None, None], aj * w[:, None, None],
                     r * w[:, None])
    mf = f_sel.astype(r.dtype)
    ai, aj, r = ai * mf[:, None, None], aj * mf[:, None, None], r * mf[:, None]

    # Priors on active poses also participate.
    def one_pri(pose, z1, s1):
        return s1, jnp.matmul(s1, fct.prior_error(pose, z1), precision=_HI)
    ap, rp = jax.vmap(one_pri)(g.poses[g.prior_idx], g.prior_z,
                               g.prior_sqrt_info)
    mp = p_act.astype(rp.dtype)
    ap, rp = ap * mp[:, None, None], rp * mp[:, None]

    h_ii, h_is, h_ss, b_i, b_s = assemble_local_parts(
        p_loc, 1, ai, aj, r, ap, rp, f_sel,
        sel["ri"], loc_of[bi], sel["rj"], loc_of[bj],
        p_act, sel["rp"], loc_of[g.prior_idx], r.dtype)
    # h_is/h_ss/b_s couple to FIXED boundary poses -> discarded (delta=0).

    def solve(lam):
        live = jnp.repeat(in_set.astype(r.dtype), 3)
        damp = lam * jnp.maximum(jnp.abs(jnp.diagonal(h_ii)), 1e-8)
        h = h_ii + jnp.diag(damp + (1.0 - live))
        l = jnp.linalg.cholesky(h)
        x = jax.scipy.linalg.cho_solve((l, True), -b_i)        # [3P]
        delta = jnp.zeros((v, 3), r.dtype).at[pid].add(
            x.reshape(p_loc, 3) * in_set[:, None].astype(r.dtype))
        return delta

    def chi_local(poses):
        e = jax.vmap(fct.between_error)(poses[bi], poses[bj], g.bet_z[fid])
        rr = jnp.einsum("fab,fb->fa", g.bet_sqrt_info[fid], e, precision=_HI)
        if huber_delta > 0.0:
            rr = rr * fct.robust_weight(jnp.linalg.norm(rr, axis=-1),
                                        huber_delta)[:, None]
        rr = rr * mf[:, None]
        ep = jax.vmap(fct.prior_error)(poses[g.prior_idx], g.prior_z)
        rrp = jnp.einsum("fab,fb->fa", g.prior_sqrt_info, ep,
                         precision=_HI) * mp[:, None]
        return jnp.sum(rr * rr) + jnp.sum(rrp * rrp)

    return solve, chi_local


def local_update(g: fct.PoseGraph, lam, cfg: SolverConfig,
                 huber_delta: float = 0.0, since=None, probe=None):
    """``cfg.inc_iters`` damped-GN iterations on the k-hop local system.

    Returns ``(graph, lam, max_delta)`` like the global ``do_update`` path;
    the accept test uses the LOCAL chi² (factors outside the gathered set
    are untouched by construction, so global and local accept agree).
    The selection (probe + top_k + index maps) is topology-only and
    computed ONCE; each iteration only relinearizes/assembles/solves the
    gathered subproblem.

    Safe degrade (ADVICE r4): when the viability probe fails — the active
    set or touching-factor set overflows the static capacities, or a fresh
    factor spans a loop — the step is zeroed and the input ``(graph, lam)``
    is returned unchanged instead of applying a silently-truncated partial
    update. Direct callers should prefer :func:`incremental_update`, whose
    dispatcher routes the failing case to the global path.
    """
    dt = g.poses.dtype
    sel = _local_select(g, cfg, since, probe)
    okf = sel["ok"].astype(dt)
    _, chi_local = _local_system(g, cfg, huber_delta, sel)
    chi = chi_local(g.poses)

    def solve_at(poses, lam):
        s, _ = _local_system(g._replace(poses=poses), cfg, huber_delta, sel)
        return s(lam)

    def body(_, carry):
        poses, chi, lam, md = carry
        delta = solve_at(poses, lam) * okf
        trial = slv._apply_delta(poses, delta, g.pose_mask)
        chi_t = chi_local(trial)
        accept = chi_t < chi
        poses_n = jnp.where(accept, trial, poses)
        chi_n = jnp.where(accept, chi_t, chi)
        lam_n = jnp.where(accept, jnp.maximum(lam / cfg.lambda_down, 1e-12),
                          lam * cfg.lambda_up)
        md_n = jnp.where(accept, jnp.maximum(md, jnp.max(jnp.abs(delta))),
                         md)
        return poses_n, chi_n, lam_n, md_n

    lam0 = lam
    poses, chi, lam, md = jax.lax.fori_loop(
        0, cfg.inc_iters, body,
        (g.poses, chi, lam, jnp.asarray(0.0, dt)))
    # Probe failed -> nothing was applied; don't let rejected zero-steps
    # ratchet lambda up either.
    lam = jnp.where(sel["ok"], lam, lam0)
    return g._replace(poses=poses), lam, md


def incremental_update(state: SmootherState, cfg: SolverConfig,
                       huber_delta: float = 0.0,
                       fresh_since=None, return_take: bool = False):
    """Bounded-cost refinement after new factors were appended to
    ``state.graph`` (the ``ISAM2::update`` role, SURVEY.md §4.3).

    Runs ``cfg.inc_iters`` warm-started LM-PCG iterations — unless the
    previous update already moved nothing beyond ``cfg.relin_threshold``
    AND no newly-appended factor has meaningful residual; the skip test is
    O(K) over the newest factors (no full-graph linearize), so a settled
    odometry-only run pays near-zero backend cost per update.

    Every ``cfg.full_solve_every``-th update additionally runs a full LM
    optimization (the iSAM2 periodic-batch-relinearization cadence) to
    squeeze out accumulated nonlinearity.

    ``return_take=True`` additionally returns the path taken as an int32
    code (0 = settled skip, 1 = global warm-started PCG, 2 = k-hop local)
    so callers can measure how often the bounded-cost property actually
    engages (VERDICT r4 missing #5).
    """
    g = state.graph
    dt = g.poses.dtype

    def do_global(g, lam):
        chi = fct.chi2(g, huber_delta)
        def body(_, carry):
            graph, chi, lam, md = carry
            graph, chi, lam, md_i = _one_lm_step(graph, lam, chi, cfg,
                                                 huber_delta)
            return graph, chi, lam, jnp.maximum(md, md_i)
        graph, chi, lam, md = jax.lax.fori_loop(
            0, cfg.inc_iters, body,
            (g, chi, lam, jnp.asarray(0.0, dt)))
        return graph, lam, md, jnp.asarray(1, jnp.int32)

    if cfg.local_poses > 0:
        # Clique-local bounded path (iSAM2 capability, VERDICT r3 weak 5):
        # solve only the k-hop neighborhood of the fresh factors when it
        # fits the static capacities and no fresh factor closes a loop.
        def do_update(g, lam):
            probe = _active_probe(g, cfg, fresh_since)

            def local(g, lam):
                g2, lam2, md2 = local_update(g, lam, cfg, huber_delta,
                                             fresh_since, probe=probe)
                return g2, lam2, md2, jnp.asarray(2, jnp.int32)

            return jax.lax.cond(probe[2], local, do_global, g, lam)
    else:
        do_update = do_global

    def skip(g, lam):
        return g, lam, jnp.asarray(0.0, dt), jnp.asarray(0, jnp.int32)

    # Settled-estimate fast path: nothing moved last time -> check whether
    # the *newest* factors actually perturb the solution before solving.
    # Two tiers: O(K) fresh-residual test (newly appended factors with
    # ~zero residual — the windowed odometry case — skip without touching
    # the full graph), then the O(F) full-gradient test (a converged noisy
    # graph has noise-level residuals everywhere but zero gradient).
    settled = state.last_max_delta < cfg.relin_threshold
    fresh_small = fresh_residual_max(g) < cfg.relin_threshold

    def slow_check(g, lam):
        # Compare a POSE-STEP surrogate against the threshold, not the raw
        # gradient (dimensionally a force): the block-Jacobi preconditioned
        # gradient is the unconstrained per-pose Newton step and lives in
        # the same units as relin_threshold. A converged noisy graph has
        # grad ~ 0.15 but step ~ 1e-3 (measured) — the raw-gradient test
        # never fired.
        lin = fct.linearize(g, huber_delta)
        grad = slv.gradient(g, lin)
        dblocks = slv.block_diag_hessian(g, lin)
        live = g.pose_mask.astype(dt)
        eye = jnp.eye(3, dtype=dt)
        dblocks = dblocks + (1e-8 + (1.0 - live))[:, None, None] * eye
        step = jnp.einsum("vab,vb->va", slv._inv3(dblocks), grad,
                          precision=_HI)
        return jax.lax.cond(jnp.max(jnp.abs(step)) < cfg.relin_threshold,
                            skip, do_update, g, lam)

    graph, lam, md, take = jax.lax.cond(
        settled & fresh_small, skip,
        lambda g, lam: jax.lax.cond(settled, slow_check, do_update, g, lam),
        g, state.lam)

    step = state.step + 1
    if cfg.full_solve_every > 0:
        def full(g, lam):
            res = slv.optimize(g, cfg, method="pcg",
                               huber_delta=huber_delta)
            return res.graph, jnp.asarray(cfg.init_lambda, dt)
        graph, lam = jax.lax.cond(
            step % cfg.full_solve_every == 0, full,
            lambda g, lam: (g, lam), graph, lam)
    out = SmootherState(graph=graph, lam=lam, last_max_delta=md,
                        step=step)
    return (out, take) if return_take else out


def full_solve(state: SmootherState, cfg: SolverConfig,
               method: str = "pcg", huber_delta: float = 0.0) -> SmootherState:
    """Periodic full batched optimization (the cadence knob
    ``cfg.full_solve_every`` is applied by the caller)."""
    res = slv.optimize(state.graph, cfg, method=method,
                       huber_delta=huber_delta)
    dt = state.graph.poses.dtype
    return SmootherState(graph=res.graph, lam=jnp.asarray(cfg.init_lambda, dt),
                         last_max_delta=jnp.asarray(jnp.inf, dt),
                         step=state.step)


def marginal_covariance_pcg(graph: fct.PoseGraph, idx, cfg: SolverConfig,
                            huber_delta: float = 0.0, lam: float = 1e-8):
    """3x3 marginal covariance of pose ``idx`` on LARGE graphs: three
    matrix-free PCG solves ``H x = e_k`` against the unit vectors of the
    pose's block (GTSAM ``Marginals`` capability, VERDICT r2 item 7) —
    never materializes the ``[3V, 3V]`` Hessian, so cost is
    O(nnz * pcg_iters) and memory O(V)."""
    lin = fct.linearize(graph, huber_delta)
    v = graph.poses.shape[0]
    dt = graph.poses.dtype

    def one(k):
        rhs = jnp.zeros((v, 3), dt).at[idx, k].set(1.0)
        x, _ = slv.pcg_rhs(graph, lin, rhs, jnp.asarray(lam, dt), cfg)
        return x[idx]

    cols = jax.vmap(one)(jnp.arange(3))                 # [3, 3] rows = cols
    return 0.5 * (cols + cols.T)


def marginal_covariance(graph: fct.PoseGraph, idx,
                        huber_delta: float = 0.0):
    """3x3 marginal covariance of pose ``idx`` (GTSAM ``Marginals``
    capability): the corresponding diagonal block of H^{-1} via the dense
    factorization path. Suitable for small/medium graphs; large graphs
    use :func:`marginal_covariance_pcg` (unit-vector PCG solves)."""
    lin = fct.linearize(graph, huber_delta)
    h, _ = slv.normal_equations(graph, lin)
    live = jnp.repeat(graph.pose_mask.astype(h.dtype), 3)
    h = h + jnp.diag(1e-8 + (1.0 - live))
    cov = jnp.linalg.inv(h)
    i0 = 3 * idx
    return jax.lax.dynamic_slice(cov, (i0, i0), (3, 3))
