"""Pose-graph solver tests: scipy oracle, Manhattan-world convergence,
dense == PCG (SURVEY.md §5 item 2)."""

import jax
import jax.numpy as jnp
import numpy as np

from ndtpu.config import SolverConfig
from ndtpu.data import g2o
from ndtpu.graph import factors as fct
from ndtpu.graph import solve
from ndtpu.lie import se2
import pytest

# Quick tier (SURVEY.md §5 item 5 / VERDICT r5 task 9): core-math and
# solver tests fast enough for per-commit runs (`pytest -m quick`).
pytestmark = pytest.mark.quick

CFG = SolverConfig()


def small_noisy_graph(n=12, seed=0, dtype=jnp.float64):
    data = g2o.manhattan_world(n, seed=seed, trans_noise=0.05,
                               rot_noise=0.02, loop_prob=0.3, min_gap=4,
                               loop_radius=3.0)
    return g2o.to_graph(data, dtype=dtype), data


def scipy_reference_solution(g: fct.PoseGraph, iters=50):
    """Independent dense GN in numpy/scipy, additive coords (oracle)."""
    poses = np.asarray(g.poses, float).copy()
    bi = np.asarray(g.bet_i)
    bj = np.asarray(g.bet_j)
    bz = np.asarray(g.bet_z, float)
    bs = np.asarray(g.bet_sqrt_info, float)
    bm = np.asarray(g.bet_mask)
    pidx = np.asarray(g.prior_idx)
    pz = np.asarray(g.prior_z, float)
    ps = np.asarray(g.prior_sqrt_info, float)
    pm = np.asarray(g.prior_mask)
    v = poses.shape[0]

    def wrap(t):
        return (t + np.pi) % (2 * np.pi) - np.pi

    for _ in range(iters):
        h = np.zeros((3 * v, 3 * v))
        b = np.zeros(3 * v)
        for f in range(len(bi)):
            if not bm[f]:
                continue
            i, j = bi[f], bj[f]
            c, s = np.cos(poses[i, 2]), np.sin(poses[i, 2])
            dx, dy = poses[j, 0] - poses[i, 0], poses[j, 1] - poses[i, 1]
            e = np.array([c * dx + s * dy - bz[f, 0],
                          -s * dx + c * dy - bz[f, 1],
                          wrap(poses[j, 2] - poses[i, 2] - bz[f, 2])])
            ji = np.array([[-c, -s, -s * dx + c * dy],
                           [s, -c, -c * dx - s * dy],
                           [0, 0, -1.0]])
            jj = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1.0]])
            ai, aj, r = bs[f] @ ji, bs[f] @ jj, bs[f] @ e
            sl_i, sl_j = slice(3 * i, 3 * i + 3), slice(3 * j, 3 * j + 3)
            h[sl_i, sl_i] += ai.T @ ai
            h[sl_i, sl_j] += ai.T @ aj
            h[sl_j, sl_i] += aj.T @ ai
            h[sl_j, sl_j] += aj.T @ aj
            b[sl_i] += ai.T @ r
            b[sl_j] += aj.T @ r
        for f in range(len(pidx)):
            if not pm[f]:
                continue
            i = pidx[f]
            e = np.concatenate([poses[i, :2] - pz[f, :2],
                                [wrap(poses[i, 2] - pz[f, 2])]])
            ap, r = ps[f], ps[f] @ e
            sl = slice(3 * i, 3 * i + 3)
            h[sl, sl] += ap.T @ ap
            b[sl] += ap.T @ r
        delta = np.linalg.solve(h + 1e-9 * np.eye(3 * v), -b)
        poses = poses + delta.reshape(v, 3)
        poses[:, 2] = wrap(poses[:, 2])
        if np.linalg.norm(delta) < 1e-12:
            break
    return poses


def graph_chi2_np(g):
    return float(fct.chi2(g))


def test_dense_matches_scipy_oracle():
    g, _ = small_noisy_graph()
    res = solve.optimize(g, CFG, method="dense")
    oracle = scipy_reference_solution(g)
    oracle_g = g._replace(poses=jnp.asarray(oracle))
    # Same optimum: chi2 agree to high precision, poses agree.
    assert abs(float(res.chi2) - graph_chi2_np(oracle_g)) < 1e-6
    np.testing.assert_allclose(np.asarray(res.graph.poses), oracle,
                               atol=1e-5)


def test_pcg_matches_dense():
    g, _ = small_noisy_graph(n=20, seed=3)
    r_dense = solve.optimize(g, CFG, method="dense")
    r_pcg = solve.optimize(g, CFG, method="pcg")
    assert abs(float(r_dense.chi2) - float(r_pcg.chi2)) < 1e-4 * max(
        1.0, float(r_dense.chi2))
    np.testing.assert_allclose(np.asarray(r_pcg.graph.poses),
                               np.asarray(r_dense.graph.poses), atol=1e-3)


def test_manhattan_reduces_error():
    data = g2o.manhattan_world(300, seed=1, loop_prob=0.15)
    g = g2o.to_graph(data, dtype=jnp.float64)
    chi_before = float(fct.chi2(g))
    res = solve.optimize(g, CFG, method="dense")
    assert float(res.chi2) < 0.5 * chi_before
    assert bool(res.converged)


def test_optimize_under_jit():
    g, _ = small_noisy_graph(n=15, seed=5)
    f = jax.jit(lambda gr: solve.optimize(gr, CFG, method="dense").graph.poses)
    p1 = f(g)
    res = solve.optimize(g, CFG, method="dense")
    np.testing.assert_allclose(np.asarray(p1), np.asarray(res.graph.poses),
                               atol=1e-9)


def test_g2o_roundtrip(tmp_path):
    data = g2o.manhattan_world(50, seed=2)
    path = str(tmp_path / "test.g2o")
    g2o.write_g2o(path, data)
    back = g2o.read_g2o(path)
    np.testing.assert_allclose(back.poses, data.poses, rtol=1e-6)
    np.testing.assert_array_equal(back.edges_ij, data.edges_ij)
    np.testing.assert_allclose(back.edges_z, data.edges_z, rtol=1e-6)
    np.testing.assert_allclose(back.edges_info, data.edges_info, rtol=1e-6)


def test_pcg_rhs_blocked_matches_per_block():
    """pcg_rhs_blocked on a block-diagonal stacked graph == pcg_rhs run
    independently on each component (per-block Krylov scalars make the
    lockstep iteration exactly S independent PCGs — the stacked-serving
    smoother's correctness property, PERF.md)."""
    from ndtpu.dist import slam_dp

    graphs = []
    cap = 32
    for seed in range(3):
        gk = fct.empty_graph(cap, 2, 2 * cap, jnp.float64)
        pose = jnp.zeros(3, jnp.float64)
        gk = fct.add_pose(gk, pose)
        gk = fct.add_prior(gk, 0, pose, jnp.eye(3, dtype=jnp.float64) * 10)
        step = jnp.asarray([1.0, 0.0, 0.1], jnp.float64)
        key = jax.random.PRNGKey(100 + seed)
        n = 10 + 4 * seed          # different live counts per block
        for i in range(1, n):
            noise = 0.05 * jax.random.normal(jax.random.fold_in(key, i),
                                             (3,), jnp.float64)
            pose = se2.compose(pose, step + noise)
            gk = fct.add_pose(gk, pose)
            gk = fct.add_between(gk, i - 1, i, step,
                                 jnp.eye(3, dtype=jnp.float64) * 5)
        graphs.append(gk)
    s = len(graphs)
    stacked = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *graphs)
    flat = slam_dp._flat_graph(stacked)

    cfg = SolverConfig(pcg_max_iter=25, pcg_tol=0.0)  # fixed iteration count
    lams = jnp.asarray([1e-4, 3e-3, 2e-2], jnp.float64)
    lam_v = jnp.repeat(lams, cap)[:, None]

    lin = fct.linearize(flat, 0.0)
    rhs = -solve.gradient(flat, lin)
    x_blk, _ = solve.pcg_rhs_blocked(flat, lin, rhs, lam_v, cfg, s)
    x_blk = np.asarray(x_blk).reshape(s, cap, 3)

    for k, gk in enumerate(graphs):
        lin_k = fct.linearize(gk, 0.0)
        rhs_k = -solve.gradient(gk, lin_k)
        x_k, _ = solve.pcg_rhs(gk, lin_k, rhs_k, lams[k], cfg)
        np.testing.assert_allclose(x_blk[k], np.asarray(x_k),
                                   rtol=1e-9, atol=1e-12)
