"""NDT registration tests: transform recovery, oracle agreement, batching.

SURVEY.md §5 items 1-3: recover a known perturbation on simulated scans;
agree with the single-thread NumPy implementation; batched == unbatched.
"""

import jax
import jax.numpy as jnp
import numpy as np

from ndtpu.config import GridConfig, MatchConfig, NDTMapConfig
from ndtpu.data import synth
from ndtpu.lie import se2
from ndtpu.ndt import grid as g
from ndtpu.ndt import match as m
from ndtpu.reference_impl import ndt_numpy

GRID = GridConfig(x0=-14.0, y0=-14.0, cell=1.0, nx=28, ny=28, overlap=4)
NDT = NDTMapConfig()
MCFG = MatchConfig()


def setup_scene(seed=0, dtype=jnp.float64):
    world = synth.box_world(half=12.0)
    angles = synth.beam_angles(360, dtype=dtype)
    pose_map = jnp.asarray([0.5, -0.3, 0.2], dtype)
    key = jax.random.PRNGKey(seed)
    r1 = synth.simulate_scans(world, pose_map, angles, 20.0, 0.005, key)
    pts1, mask1 = synth.polar_to_xy(r1, angles, 0.1, 20.0)
    stats = g.build_stats(se2.transform(pose_map, pts1), mask1, GRID)
    ndt_map = g.finalize(stats, NDT)
    return world, angles, ndt_map, pose_map


def test_recover_known_transform():
    world, angles, ndt_map, _ = setup_scene()
    gt = jnp.asarray([1.2, -0.8, 0.15], jnp.float64)
    r2 = synth.simulate_scans(world, gt, angles, 20.0, 0.0,
                              jax.random.PRNGKey(1))
    pts2, mask2 = synth.polar_to_xy(r2, angles, 0.1, 20.0)
    init = gt + jnp.asarray([0.4, -0.3, 0.08])
    res = m.match(pts2, mask2, ndt_map, init, GRID, MCFG)
    assert bool(res.converged)
    np.testing.assert_allclose(np.asarray(res.pose[:2]), np.asarray(gt[:2]),
                               atol=0.05)
    assert abs(float(res.pose[2] - gt[2])) < 0.02
    assert float(res.score) > 0.3
    # Hessian at the optimum must be symmetric positive definite.
    h = np.asarray(res.hessian)
    np.testing.assert_allclose(h, h.T, atol=1e-8)
    assert np.all(np.linalg.eigvalsh(h) > 0)


def test_matches_numpy_oracle():
    world, angles, ndt_map, _ = setup_scene(seed=2)
    gt = jnp.asarray([0.9, 0.4, -0.1], jnp.float64)
    r2 = synth.simulate_scans(world, gt, angles, 20.0, 0.003,
                              jax.random.PRNGKey(3))
    pts2, mask2 = synth.polar_to_xy(r2, angles, 0.1, 20.0)
    init = gt + jnp.asarray([0.25, 0.2, -0.05])

    res = m.match(pts2, mask2, ndt_map, init, GRID, MCFG)

    om = ndt_numpy.NumpyNDTMap(GRID.x0, GRID.y0, GRID.cell, GRID.nx, GRID.ny,
                               GRID.overlap, min_pts=NDT.min_pts,
                               eig_ratio=NDT.eig_ratio,
                               eig_abs_min=NDT.eig_abs_min)
    om.mean = np.asarray(ndt_map.mean)
    om.icov = np.asarray(ndt_map.icov)
    om.valid = np.asarray(ndt_map.valid) > 0.5
    pose_np, h_np, score_np, _, conv_np = ndt_numpy.match(
        np.asarray(pts2), np.asarray(mask2), om, np.asarray(init))

    assert bool(res.converged) and conv_np
    np.testing.assert_allclose(np.asarray(res.pose), pose_np, atol=5e-4)
    np.testing.assert_allclose(float(res.score), score_np, atol=5e-3)


def test_score_grad_hess_vs_autodiff():
    """Analytic gradient/Hessian == jax.grad/jax.hessian of the objective
    (the numericalDerivative pattern, SURVEY.md §5 item 1)."""
    world, angles, ndt_map, _ = setup_scene(seed=4)
    gt = jnp.asarray([0.6, -0.2, 0.05], jnp.float64)
    r2 = synth.simulate_scans(world, gt, angles, 20.0, 0.002,
                              jax.random.PRNGKey(5))
    pts2, mask2 = synth.polar_to_xy(r2, angles, 0.1, 20.0)
    pose = gt + jnp.asarray([0.11, 0.07, 0.03])

    def f_only(p):
        f, _, _, _ = m.score_grad_hess(p, pts2, mask2, ndt_map, GRID, MCFG)
        return f

    f, grad_a, hess_a, _ = m.score_grad_hess(pose, pts2, mask2, ndt_map,
                                             GRID, MCFG)
    grad_ad = jax.grad(f_only)(pose)
    hess_ad = jax.hessian(f_only)(pose)
    np.testing.assert_allclose(np.asarray(grad_a), np.asarray(grad_ad),
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np.asarray(hess_a), np.asarray(hess_ad),
                               rtol=1e-7, atol=1e-8)


def test_batched_equals_single():
    world, angles, ndt_map, _ = setup_scene(seed=6)
    gts = jnp.asarray([[1.0, 0.5, 0.1], [-0.5, 1.5, -0.2], [2.0, -1.0, 0.3]],
                      jnp.float64)
    keys = jax.random.split(jax.random.PRNGKey(7), 3)
    pts, msks, inits = [], [], []
    for i in range(3):
        r = synth.simulate_scans(world, gts[i], angles, 20.0, 0.003, keys[i])
        p, mk = synth.polar_to_xy(r, angles, 0.1, 20.0)
        pts.append(p), msks.append(mk)
        inits.append(gts[i] + jnp.asarray([0.2, -0.15, 0.04]))
    pts, msks, inits = map(jnp.stack, (pts, msks, inits))
    batched = m.match_batch(pts, msks, ndt_map, inits, GRID, MCFG)
    for i in range(3):
        single = m.match(pts[i], msks[i], ndt_map, inits[i], GRID, MCFG)
        np.testing.assert_allclose(np.asarray(batched.pose[i]),
                                   np.asarray(single.pose), atol=1e-9)


def test_no_valid_cells_is_graceful():
    _, _, ndt_map, _ = setup_scene(seed=8)
    pts = jnp.full((10, 2), 1000.0)  # far outside the grid
    mask = jnp.ones(10, bool)
    res = m.match(pts, mask, ndt_map, jnp.zeros(3), GRID, MCFG)
    np.testing.assert_allclose(np.asarray(res.pose), 0.0, atol=0)
    assert float(res.score) == 0.0


def test_compact_table_matches_full():
    """64-byte compact quad rows (bf16-packed icov) vs full 128-byte rows:
    pose difference sub-millimeter (PERF.md)."""
    import jax
    import numpy as np

    from ndtpu.config import GridConfig, MatchConfig, NDTMapConfig
    from ndtpu.data import synth
    from ndtpu.ndt import grid as ndt_grid
    from ndtpu.ndt import match as ndt_match

    grid = GridConfig(x0=-16.0, y0=-16.0, cell=1.0, nx=32, ny=32, overlap=4)
    world = synth.box_world(half=12.0)
    angles = synth.beam_angles(180, dtype=jnp.float32)
    mposes = synth.rectangle_trajectory(24, half=8.0, step=1.2,
                                        dtype=jnp.float32)
    rr = synth.simulate_scans(world, mposes, angles, 20.0, 0.01,
                              jax.random.PRNGKey(0))
    mpts, mmsk = synth.polar_to_xy(rr, angles, 0.1, 20.0)
    wpts = synth.se2.transform(mposes, mpts)
    stats = ndt_grid.build_stats(wpts.reshape(-1, 2).astype(jnp.float32),
                                 mmsk.reshape(-1), grid)
    nmap = ndt_grid.finalize(stats, NDTMapConfig())
    sp = synth.rectangle_trajectory(8, half=7.5, step=1.1, dtype=jnp.float32)
    r2 = synth.simulate_scans(world, sp, angles, 20.0, 0.01,
                              jax.random.PRNGKey(1))
    pts, msk = synth.polar_to_xy(r2, angles, 0.1, 20.0)
    init = sp + jnp.asarray([0.15, -0.1, 0.03], jnp.float32)
    pts = pts.astype(jnp.float32)
    init = init.astype(jnp.float32)

    full = ndt_match.match_batch(pts, msk, nmap, init, grid, MatchConfig())
    comp = ndt_match.match_batch(pts, msk, nmap, init, grid,
                                 MatchConfig(compact_table=True))
    d = np.abs(np.asarray(full.pose) - np.asarray(comp.pose))
    assert d[:, :2].max() < 2e-3, d[:, :2].max()
    assert d[:, 2].max() < 1e-3, d[:, 2].max()
    assert int(comp.converged.sum()) == int(full.converged.sum())


def test_bf16_pair_roundtrip():
    import numpy as np

    from ndtpu.ndt.grid import _pack_bf16_pair, unpack_bf16_pair

    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.normal(0, 50, (256,)), jnp.float32)
    b = jnp.asarray(rng.normal(0, 0.01, (256,)), jnp.float32)
    a2, b2 = unpack_bf16_pair(_pack_bf16_pair(a, b))
    ra = np.max(np.abs(np.asarray(a2 - a)) / np.maximum(np.abs(np.asarray(a)), 1e-9))
    rb = np.max(np.abs(np.asarray(b2 - b)) / np.maximum(np.abs(np.asarray(b)), 1e-9))
    assert ra < 0.01 and rb < 0.01, (ra, rb)
    # zero lane unpacks to exact zeros (padded lattice slots -> valid == 0)
    z1, z2 = unpack_bf16_pair(jnp.zeros((4,), jnp.float32))
    assert float(jnp.max(jnp.abs(z1))) == 0.0
    assert float(jnp.max(jnp.abs(z2))) == 0.0


def test_two_phase_matches_single_phase():
    """Two-phase (compacted-straggler) matching must reproduce the
    single-phase per-element results (same poses/convergence/iterations up
    to gather/scatter f32 ordering)."""
    import dataclasses

    import numpy as np

    from ndtpu.data import synth
    from ndtpu.ndt import grid as ndt_grid

    grid = GridConfig(x0=-16.0, y0=-16.0, cell=0.5, nx=64, ny=64, overlap=4)
    world = synth.box_world(half=12.0)
    angles = synth.beam_angles(180)
    map_poses = synth.rectangle_trajectory(16, half=8.0, step=1.0)
    rr = synth.raycast(world, map_poses, angles, 20.0)
    mpts, mmsk = synth.polar_to_xy(rr, angles, 0.1, 20.0)
    wp = synth.se2.transform(map_poses, mpts)
    stats = ndt_grid.build_stats(wp.reshape(-1, 2), mmsk.reshape(-1), grid)
    nmap = ndt_grid.finalize(stats, NDTMapConfig())
    table = ndt_grid.pack_quad(nmap, grid)

    b = 48
    poses = synth.rectangle_trajectory(b, half=7.0, step=0.9)
    r2 = synth.raycast(world, poses, angles, 20.0)
    spts, smsk = synth.polar_to_xy(r2, angles, 0.1, 20.0)
    init = poses + jnp.asarray([0.15, -0.1, 0.03], spts.dtype)

    one = m.match_batch_packed(spts, smsk, table, init, grid,
                               MatchConfig())
    two = m.match_batch_packed(
        spts, smsk, table, init, grid,
        MatchConfig(phase2_width=8, phase1_iters=6))
    np.testing.assert_array_equal(np.asarray(one.converged),
                                  np.asarray(two.converged))
    np.testing.assert_allclose(np.asarray(one.pose), np.asarray(two.pose),
                               atol=2e-3)
    assert int(jnp.sum(one.converged)) > b * 3 // 4
