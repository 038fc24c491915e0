"""Smoke test on the GPU: drive the system's main paths once and check them.

Usage (from the root of a checkout, on a machine with an NVIDIA GPU)::

    python chip_smoke.py          # one card: matcher, slam, serve, ba, repeat
    python chip_smoke.py --multi  # four cards: the multi-device paths only

Each phase goes through the entry points a user calls (``ndtpu.run``,
``ndtpu.serve``, ``ndtpu.solve_g2o``, ``ndtpu.ndt.match.match_batch``,
``ndtpu.dist``) at full size and prints one JSON line: its first-call time
(compile plus one run), its warm median (every rep ends in a host read) and
each comparison beside its limit. A failed comparison stops the script with
a non-zero exit. The last line of standard output is exactly::

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}

Without a GPU the script exits non-zero before any phase runs; it never
falls back to the CPU. All phases run in this one process, because a second
JAX process on the card fails for want of memory.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

import jax
import jax.numpy as jnp

from ndtpu import dist, run, serve, solve_g2o
from ndtpu.config import GridConfig, MatchConfig, NDTMapConfig, PipelineConfig
from ndtpu.config import SolverConfig
from ndtpu.data import g2o, synth
from ndtpu.eval.ate import ate_rmse
from ndtpu.graph import factors as fct
from ndtpu.graph import supernodal as sn
from ndtpu.ndt import grid as ndt_grid
from ndtpu.ndt import match as ndt_match
from ndtpu.reference_impl import ndt_numpy
from ndtpu.slam import pipeline
from ndtpu.utils.runtime import enable_compile_cache, gpu_name_and_power_limit

REPO = os.path.dirname(os.path.abspath(__file__))
SLAM_CONFIG = os.path.join(REPO, "configs", "config3_loop_closure.json")
SERVE_CONFIG = os.path.join(REPO, "configs", "config_serving.json")

# The ba phase's graph: manhattan_world(10000, seed=0, loop_prob=0.1) with
# its poses perturbed by N(0, 0.05) from default_rng(0). The phase's
# command is ``solve_g2o --method supernodal --shards 64`` (50 LM
# iterations). Two references, both chi^2 evaluated in f64:
# - BA_F64_CHI2: the same command in f64 (ba_f64_reference(), on the CPU).
#   Not converged: LM on this graph still descends after 50 iterations.
#   f32 ends 1.17% above it (986.41 on the CPU, 986.33 on the card), f32
#   dots run as TF32 end 2.2-3.2% above it (996.49 and 1006.61 on the
#   card); BA_F64_RTOL lies between (PERF.md, Findings).
# - BA_CPU_F32_CHI2: the same command in f32 on the CPU (JAX_PLATFORMS=cpu);
#   the card must reproduce it within BA_RTOL.
# tests/test_f32_scale.py keeps both constants honest.
BA_F64_CHI2 = 975.0394836789623
BA_F64_RTOL = 1.5e-2
BA_CPU_F32_CHI2 = 986.408084515116
BA_RTOL = 1e-3
# Per converged scan, f32 on the card against the f64 oracle and sharded
# against one card. The LM also stops when a step under
# MatchConfig.reject_tol (3 mm) is rejected, which f32 does where the score
# cannot resolve the step, and some scans of the matcher scene are weakly
# constrained along a wall: the f64 oracle itself moves 9.6 mm when 68 of
# 174,636 map points change cells. Readings: CPU 5.16 mm / 0.29 mrad; card
# 5.55, 5.16 and 12.35 mm / up to 0.76 mrad against the oracle; sharded
# against one card up to 9.94 mm / 0.37 mrad (PERF.md, Findings).
MATCH_XY_LIMIT_M = 2e-2
MATCH_TH_LIMIT_RAD = 2e-3
# Map build against the f64 numpy build: a point within this of a cell
# border may land in the neighbouring cell (f32 resolves about 4e-6 m at
# 30 m); elsewhere the cell sums must agree to this per point.
MAP_BORDER_M = 1e-4
# ATE bounds, set before the first GPU run from the same runs on the CPU
# (JAX_PLATFORMS=cpu): slam 0.0617 m, serve per-session max 0.0822 m. About
# 2.4x those: other reduction orders may accept other loops, but a run on a
# diverged attractor lands at metres (PERF.md, Findings). The four-card
# sessions run the unbatched pipeline, one session per card, not the
# stacked serve program: the same rule on its CPU run (max 0.116 m, session
# 3) gives its own bound, set after the first four-card reading (0.237 m on
# that session, sharded and one card alike).
SLAM_ATE_LIMIT_M = 0.15
SERVE_ATE_LIMIT_M = 0.2
MULTI_SESSION_ATE_LIMIT_M = 0.28
# Keyframe counts of a session sharded and on one card. Equal on the CPU;
# on the GPU two runs of one program are not bit-identical (the repeat
# phase), and a keyframe on the 0.5 m / 0.3 rad threshold may fall either
# way: 112 against 113 in the second four-card run (PERF.md, Findings).
MULTI_KF_DIFF = 2


class PhaseFailed(RuntimeError):
    """A phase's result broke one of its limits."""


def check(name, value, limit, ok):
    return {"name": name, "value": value, "limit": limit, "ok": bool(ok)}


def report(rec: dict) -> dict:
    """Print a phase's line; raise if any of its checks failed."""
    print(json.dumps(rec), flush=True)
    bad = [c["name"] for c in rec["checks"] if not c["ok"]]
    if bad:
        raise PhaseFailed(f"phase {rec['phase']} failed: {', '.join(bad)}")
    return rec


def note(phase, stage, seconds):
    """A stage's time on stderr as soon as it ends, so that a slow stage
    shows even when a time limit cuts the phase before its line."""
    print(f"[{phase}] {stage}: {seconds:.2f} s", file=sys.stderr, flush=True)


def _timed(fn, reps):
    """``(first-call s, warm median s, last result)``; ``fn`` must end in a
    host read so that each time covers the device work."""
    t0 = time.perf_counter()
    out = fn()
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        ts.append(time.perf_counter() - t0)
    return first, float(np.median(ts)) if ts else float("nan"), out


# ---------------------------------------------------------------- matcher --

def matcher_scene(batch, n_beams, nx):
    """The batched-registration workload: B scans x n_beams against an
    ``nx x nx`` half-metre grid with overlap 4. At (4096, 720, 128) this is
    the 64 m map of ``bench.py``; smaller ``nx`` shrinks the world with it."""
    s = nx / 128.0
    grid = GridConfig(x0=-32.0 * s, y0=-32.0 * s, cell=0.5, nx=nx, ny=nx,
                      overlap=4)
    world = synth.box_world(half=28.0 * s)
    angles = synth.beam_angles(n_beams)
    max_range = 40.0 * s
    map_poses = synth.rectangle_trajectory(64, half=18.0 * s, step=1.5 * s)
    ranges = synth.simulate_scans(world, map_poses, angles, max_range, 0.01,
                                  jax.random.PRNGKey(0))
    mpts, mmsk = synth.polar_to_xy(ranges, angles, 0.1, max_range)
    wpts = synth.se2.transform(map_poses, mpts)
    stats = ndt_grid.build_stats(wpts.reshape(-1, 2), mmsk.reshape(-1), grid)
    scan_poses = synth.rectangle_trajectory(batch, half=17.0 * s,
                                            step=1.1 * s)
    r2 = synth.simulate_scans(world, scan_poses, angles, max_range, 0.01,
                              jax.random.PRNGKey(1))
    spts, smsk = synth.polar_to_xy(r2, angles, 0.1, max_range)
    init = scan_poses + jnp.asarray([0.2, -0.15, 0.04], spts.dtype)
    return grid, stats, (wpts.reshape(-1, 2), mmsk.reshape(-1)), spts, smsk, \
        init


def oracle_map(grid, map_points, ncfg: NDTMapConfig):
    """The map built and finalized in f64 by ``ndt_numpy.build_map`` from
    the scene's points, independent of the device's build."""
    wpts, wmsk = map_points
    return ndt_numpy.build_map(
        np.asarray(wpts, np.float64), np.asarray(wmsk), grid.x0, grid.y0,
        grid.cell, grid.nx, grid.ny, grid.overlap, min_pts=ncfg.min_pts,
        eig_ratio=ncfg.eig_ratio, eig_abs_min=ncfg.eig_abs_min)


def border_points(grid, map_points, eps=None) -> int:
    """Points within ``eps`` (default MAP_BORDER_M) of a cell border,
    counted once per overlap grid: where f32 and f64 may floor a point into
    different cells."""
    eps = MAP_BORDER_M if eps is None else eps
    pts = np.asarray(map_points[0], np.float64)
    msk = np.asarray(map_points[1], bool)
    h = grid.cell / 2.0
    offsets = [(0.0, 0.0)] if grid.overlap == 1 else [
        (0.0, 0.0), (h, 0.0), (0.0, h), (h, h)]
    count = 0
    for ox, oy in offsets:
        near = np.zeros(pts.shape[0], bool)
        for k, o in ((0, grid.x0 + ox), (1, grid.y0 + oy)):
            f = (pts[:, k] - o) / grid.cell
            near |= np.abs(f - np.round(f)) * grid.cell < eps
        count += int((near & msk).sum())
    return count


def compare_map_build(grid, stats, map_points, m64):
    """The device's scatter-add build against ``ndt_numpy``'s f64 build of
    the same points. Checks: every point is counted; no more points land in
    another cell than lie on a cell border; in cells with equal counts the
    sums agree to
    MAP_BORDER_M per point (|ds|/n) and to what that error gives in the
    second moment (|dss|/n <= 2 r_max MAP_BORDER_M)."""
    n, s_, ss = (np.asarray(a, np.float64) for a in stats)
    moved = int(np.abs(n - m64.n).sum()) // 2
    border = border_points(grid, map_points)
    same = (n == m64.n) & (n > 0)
    cnt = np.maximum(n, 1.0)
    ds = float((np.abs(s_ - m64.s).max(-1) / cnt)[same].max())
    dss = float((np.abs(ss - m64.ss).max((-2, -1)) / cnt)[same].max())
    r_max = float(np.abs(np.asarray(map_points[0])).max())
    lim_ss = 2 * r_max * MAP_BORDER_M
    total, total64 = float(n.sum()), float(m64.n.sum())
    return [check("map_points_counted", total, total64, total == total64),
            check("map_points_in_other_cell", moved, border, moved <= border),
            check("map_max_sum_err_per_point_m", ds, MAP_BORDER_M,
                  ds <= MAP_BORDER_M),
            check("map_max_sq_sum_err_per_point_m2", dss, lim_ss,
                  dss <= lim_ss)]


def numpy_reference(grid, stats, ncfg: NDTMapConfig, mcfg: MatchConfig,
                    spts, smsk, init, idx):
    """``ndt_numpy.match_vectorized`` in f64 on scans ``idx``, on a map
    finalized in f64 from the device's cell sums (compare_map_build checks
    those sums). Not on ``oracle_map``: on the matcher scene, points on
    cell borders alone move the f64 poses by up to 9.6 mm between the two
    maps (PERF.md, Findings)."""
    m = ndt_numpy.NumpyNDTMap(grid.x0, grid.y0, grid.cell, grid.nx, grid.ny,
                              grid.overlap, min_pts=ncfg.min_pts,
                              eig_ratio=ncfg.eig_ratio,
                              eig_abs_min=ncfg.eig_abs_min)
    m.n = np.asarray(stats.n, np.float64)
    m.s = np.asarray(stats.s, np.float64)
    m.ss = np.asarray(stats.ss, np.float64)
    m.finalize()
    pts, msk = np.asarray(spts, np.float64), np.asarray(smsk)
    ini = np.asarray(init, np.float64)
    poses, conv = [], []
    for b in idx:
        pose, _, _, _, c = ndt_numpy.match_vectorized(
            pts[b], msk[b], m, ini[b], max_iter=mcfg.max_iter, tol=mcfg.tol,
            init_lambda=mcfg.init_lambda, lambda_up=mcfg.lambda_up,
            lambda_down=mcfg.lambda_down, max_lambda=mcfg.max_lambda,
            step_clip=mcfg.step_clip, d2=mcfg.d2, reject_tol=mcfg.reject_tol)
        poses.append(pose)
        conv.append(bool(c))
    return np.stack(poses), np.asarray(conv)


def pose_diff(a, b, rows=None):
    """``(max |dxy| m, max |dtheta| rad)`` over ``rows`` of two ``[N, 3]``
    pose arrays, with the heading difference wrapped to (-pi, pi]."""
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    if rows is not None:
        d = d[rows]
    if not d.size:
        return 0.0, 0.0
    dxy = np.hypot(d[:, 0], d[:, 1])
    dth = np.abs(np.arctan2(np.sin(d[:, 2]), np.cos(d[:, 2])))
    return float(dxy.max()), float(dth.max())


def compare_poses(name, got_pose, got_conv, ref_pose, ref_conv):
    """Checks: same converged flags; per converged scan |dxy| and |dtheta|
    within the matcher limits."""
    got_conv, ref_conv = np.asarray(got_conv), np.asarray(ref_conv)
    max_xy, max_th = pose_diff(got_pose, ref_pose, got_conv & ref_conv)
    n_diff = int((got_conv != ref_conv).sum())
    xy_lim, th_lim = MATCH_XY_LIMIT_M, MATCH_TH_LIMIT_RAD
    return [
        check(f"{name}_converged_flags_differ", n_diff, 0, n_diff == 0),
        check(f"{name}_max_dxy_m", max_xy, xy_lim, max_xy <= xy_lim),
        check(f"{name}_max_dtheta_rad", max_th, th_lim, max_th <= th_lim),
    ]


def phase_matcher(batch=4096, n_beams=720, nx=128, n_ref=32, reps=5):
    mcfg = MatchConfig(phase2_width=128, phase1_iters=16)
    ncfg = NDTMapConfig()
    grid, stats, map_points, spts, smsk, init = matcher_scene(batch, n_beams,
                                                              nx)
    ndt_map = ndt_grid.finalize(stats, ncfg)
    fn = jax.jit(lambda p, m, nm, i: ndt_match.match_batch(p, m, nm, i, grid,
                                                           mcfg))
    t0 = time.perf_counter()
    compiled = fn.lower(spts, smsk, ndt_map, init).compile()
    compile_s = time.perf_counter() - t0

    def call():
        out = compiled(spts, smsk, ndt_map, init)
        return jax.tree_util.tree_map(np.asarray, out)

    first, warm, res = _timed(call, reps)
    idx = np.linspace(0, batch - 1, min(n_ref, batch)).astype(int)
    ref_pose, ref_conv = numpy_reference(grid, stats, ncfg, mcfg, spts, smsk,
                                         init, idx)
    n_conv = int(res.converged.sum())
    checks = [check("poses_finite", bool(np.isfinite(res.pose).all()), True,
                    np.isfinite(res.pose).all()),
              check("converged", n_conv, f">= {batch // 2}",
                    n_conv >= batch // 2)]
    checks += compare_poses("vs_numpy_f64", res.pose[idx], res.converged[idx],
                            ref_pose, ref_conv)
    checks += compare_map_build(grid, stats, map_points,
                                oracle_map(grid, map_points, ncfg))
    return report({"phase": "matcher", "batch": batch, "beams": n_beams,
                   "grid": f"{nx}x{nx}", "compile_s": compile_s,
                   "first_call_s": first, "warm_median_s": warm,
                   "scans_per_s": batch / warm, "checks": checks})


# ------------------------------------------------------------ slam, repeat --

def _slam_run(name, config, max_scans, ate_limit, reps):
    """``ndtpu.run`` in windowed mode: ``(record without its checks, checks,
    trajectory)``."""
    ate_limit = SLAM_ATE_LIMIT_M if ate_limit is None else ate_limit
    argv = ["--config", config, "--max-scans", str(max_scans)]
    first, warm, s = _timed(lambda: run.main(argv), reps)
    traj = s["trajectory"]
    checks = [
        check("trajectory_finite", bool(np.isfinite(traj).all()), True,
              np.isfinite(traj).all()),
        check("ate_m", s["ate_m"], ate_limit, s["ate_m"] <= ate_limit),
        check("loops", s["loops"], "> 0", s["loops"] > 0),
        check("dropped", s["dropped"], 0, s["dropped"] == 0),
    ]
    rec = {"phase": name, "scans": max_scans, "keyframes": s["keyframes"],
           "loops": s["loops"], "first_call_s": first}
    if reps:
        rec.update(warm_median_s=warm, compile_s=first - warm,
                   scans_per_s=max_scans / warm)
    return rec, checks, traj


def phase_slam(config=SLAM_CONFIG, max_scans=1000, ate_limit=None, reps=2):
    """Returns ``(record, trajectory)``."""
    rec, checks, traj = _slam_run("slam", config, max_scans, ate_limit, reps)
    return report(dict(rec, checks=checks)), traj


def phase_repeat(first_traj, config=SLAM_CONFIG, max_scans=1000,
                 ate_limit=None):
    """The slam phase once more on the same inputs. A difference from the
    first run is recorded, not failed: scatter-adds are atomics on the GPU,
    so their order may change from run to run."""
    rec, checks, traj = _slam_run("repeat", config, max_scans, ate_limit, 0)
    dxy, dth = pose_diff(traj, first_traj)
    return report(dict(rec, bit_identical=bool(np.array_equal(traj,
                                                              first_traj)),
                       max_dxy_m=dxy, max_dtheta_rad=dth, checks=checks))


# ------------------------------------------------------------------ serve --

def phase_serve(config=SERVE_CONFIG, sessions=8, max_scans=300,
                ate_limit=None):
    ate_limit = SERVE_ATE_LIMIT_M if ate_limit is None else ate_limit
    s = serve.main(["--config", config, "--sessions", str(sessions),
                    "--max-scans", str(max_scans)])
    ates = [r["ate_m"] for r in s["per_session"]]
    dropped = sum(r["dropped"] for r in s["per_session"])
    checks = [check("max_session_ate_m", max(ates), ate_limit,
                    max(ates) <= ate_limit),
              check("dropped", dropped, 0, dropped == 0)]
    return report({"phase": "serve", "sessions": sessions,
                   "scans": max_scans, "session_ate_m": ates,
                   "loops": [r["loops"] for r in s["per_session"]],
                   "first_call_s": s["compile_s"],
                   "warm_median_s": s["warm_s"],
                   "compile_s": s["compile_s"] - s["warm_s"],
                   "aggregate_scans_per_s": s["scans_total"] / s["warm_s"],
                   "checks": checks})


# --------------------------------------------------------------------- ba --

def manhattan_graph_data(n_poses=10000, seed=0, loop_prob=0.1):
    """The config-4 graph: Manhattan world with its initial poses perturbed
    by N(0, 0.05) (the workload of tests/test_f32_scale.py)."""
    data = g2o.manhattan_world(n_poses, seed=seed, loop_prob=loop_prob)
    rng = np.random.default_rng(seed)
    return data._replace(
        poses=data.poses + rng.normal(0, 0.05, data.poses.shape))


def chi2_f64(data, poses) -> float:
    """chi^2 of ``data``'s factors at ``poses``, evaluated in f64."""
    with jax.enable_x64(True):
        g = g2o.to_graph(data, dtype=jnp.float64)
        return float(fct.chi2(g._replace(
            poses=jnp.asarray(np.asarray(poses, np.float64)))))


def ba_f64_reference(n_poses=10000, shards=64, max_iter=50) -> float:
    """chi^2 (in f64) of the ba phase's command run in f64: supernodal LM
    with ``solve_g2o``'s solver settings on the graph read back from its
    ``.g2o`` file. The source of BA_F64_CHI2."""
    data = manhattan_graph_data(n_poses)
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "manhattan.g2o")
        g2o.write_g2o(src, data)
        read = g2o.read_g2o(src)
    with jax.enable_x64(True):
        g = g2o.to_graph(read, dtype=jnp.float64)
        res = sn.optimize_supernodal(
            g, SolverConfig(max_iter=max_iter,
                            pcg_max_iter=max(250, max_iter * 10)),
            n_shards=shards)
        poses = np.asarray(res.graph.poses)[:n_poses]
    return chi2_f64(data, poses)


def phase_ba(n_poses=10000, cpu_f32=None, f64_ref=None, reps=1, shards=64):
    """``ndtpu.solve_g2o --method supernodal`` on a ``.g2o`` file, in f32
    on the card; the written result's chi^2 in f64 against the same command
    in f32 on the CPU and in f64."""
    cpu_f32 = BA_CPU_F32_CHI2 if cpu_f32 is None else cpu_f32
    f64_ref = BA_F64_CHI2 if f64_ref is None else f64_ref
    data = manhattan_graph_data(n_poses)
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "manhattan.g2o")
        dst = os.path.join(tmp, "optimized.g2o")
        g2o.write_g2o(src, data)
        argv = [src, "-o", dst, "--method", "supernodal",
                "--shards", str(shards)]
        first, warm, res = _timed(lambda: solve_g2o.main(argv), reps)
        opt = g2o.read_g2o(dst)
    chi = chi2_f64(data, opt.poses)
    lim_cpu, lim_64 = (1 + BA_RTOL) * cpu_f32, (1 + BA_F64_RTOL) * f64_ref
    checks = [check("chi2_f64_vs_cpu_f32", chi, lim_cpu, chi <= lim_cpu),
              check("chi2_f64_vs_f64", chi, lim_64, chi <= lim_64)]
    return report({"phase": "ba", "poses": n_poses, "method": "supernodal",
                   "iters": int(res.n_iter), "cpu_f32_chi2": cpu_f32,
                   "f64_chi2": f64_ref,
                   "first_call_s": first, "warm_median_s": warm,
                   "compile_s": first - warm, "checks": checks})


# ------------------------------------------------------------ four cards --

def phase_multi_sessions(mesh, config=SERVE_CONFIG, max_scans=300,
                         ate_limit=None):
    """``dist.run_sessions_sharded`` (one session per card) against
    ``pipeline.run_slam_windowed`` of each session on one card."""
    ate_limit = MULTI_SESSION_ATE_LIMIT_M if ate_limit is None else ate_limit
    cfg = PipelineConfig.from_json(config)
    n = mesh.devices.size
    ns = argparse.Namespace(datasets=None, max_scans=max_scans, sessions=n)
    pts, msk, odo, _, gts = serve._load_sessions(ns, cfg)

    def sharded():
        st, outs = dist.run_sessions_sharded(mesh, pts, msk, odo, cfg)
        return jax.tree_util.tree_map(np.asarray, (st, outs))

    first, warm, (st_sh, out_sh) = _timed(sharded, 1)
    note("multi_sessions", "sharded first call", first)
    note("multi_sessions", "sharded warm call", warm)
    one = jax.jit(lambda p, m, o: pipeline.run_slam_windowed(p, m, o, cfg))
    t0 = time.perf_counter()
    res_one = [jax.tree_util.tree_map(np.asarray, one(pts[k], msk[k], odo[k]))
               for k in range(n)]
    one_s = time.perf_counter() - t0
    note("multi_sessions", f"one card, {n} sessions in turn", one_s)
    checks, ates_sh, ates_one, dxy, dth = [], [], [], 0.0, 0.0
    for k, (st1, out1) in enumerate(res_one):
        tr1 = np.asarray(pipeline.recover_trajectory(st1, out1))
        trk = np.asarray(pipeline.recover_trajectory(
            jax.tree_util.tree_map(lambda a: a[k], st_sh),
            jax.tree_util.tree_map(lambda a: a[k], out_sh)))
        ates_sh.append(float(ate_rmse(trk, gts[k])))
        ates_one.append(float(ate_rmse(tr1, gts[k])))
        dxy_k, dth_k = pose_diff(trk, tr1)
        dxy, dth = max(dxy, dxy_k), max(dth, dth_k)
        kf_sh, kf_1 = int(st_sh.kf.n[k]), int(st1.kf.n)
        checks.append(check(f"session{k}_keyframes_sharded_vs_one",
                            [kf_sh, kf_1], f"differ by <= {MULTI_KF_DIFF}",
                            abs(kf_sh - kf_1) <= MULTI_KF_DIFF))
    checks.append(check("max_session_ate_m_sharded", max(ates_sh), ate_limit,
                        max(ates_sh) <= ate_limit))
    checks.append(check("max_session_ate_m_one_card", max(ates_one),
                        ate_limit, max(ates_one) <= ate_limit))
    return report({"phase": "multi_sessions", "sessions": n,
                   "scans": max_scans, "ate_sharded_m": ates_sh,
                   "ate_one_card_m": ates_one,
                   "max_dxy_m": dxy, "max_dtheta_rad": dth,
                   "first_call_s": first, "warm_s": warm,
                   "one_card_s": one_s, "checks": checks})


def phase_multi_schur(mesh, n_poses=10000, shards=64):
    """``dist.schur_delta`` / ``dist.optimize_schur`` over ``("space",)``.

    One damped GN step in f32 against the f64 supernodal step on one card
    (the comparison of tests/test_f32_scale.py); then the LM solve's chi^2
    (f32, evaluated in f64) against the one-card supernodal LM solve of the
    same graph with the same settings. Both take exact steps, so they follow
    the same LM path."""
    data = manhattan_graph_data(n_poses)
    g = g2o.to_graph(data, dtype=jnp.float32)
    plan = dist.plan_partition(
        np.asarray(g.bet_i), np.asarray(g.bet_j), np.asarray(g.bet_mask),
        np.asarray(g.prior_idx), np.asarray(g.prior_mask), n_poses,
        n_shards=mesh.devices.size)
    lam = 1e-3
    step = jax.jit(lambda g_, l: dist.schur_delta(mesh, g_, plan, l))
    t0 = time.perf_counter()
    d_s = np.asarray(step(g, jnp.asarray(lam, jnp.float32)))
    step_s = time.perf_counter() - t0
    note("multi_schur", "Schur step first call", step_s)
    with jax.enable_x64(True):
        g64 = g2o.to_graph(data, dtype=jnp.float64)
        splan = sn.plan_supernodal(g64, shards)
        d_64 = np.asarray(jax.jit(lambda g_: sn.supernodal_delta(
            g_, fct.linearize(g_), splan, jnp.asarray(lam, jnp.float64)))(
                g64))
    scale = max(float(np.abs(d_64).max()), 1.0)
    step_err = float(np.abs(d_s - d_64).max())

    cfg = SolverConfig()
    t0 = time.perf_counter()
    res_s = dist.optimize_schur(mesh, g, plan, cfg)
    poses_s = np.asarray(res_s.graph.poses)
    solve_s = time.perf_counter() - t0
    note("multi_schur", "Schur LM solve", solve_s)
    t0 = time.perf_counter()
    res_1 = sn.optimize_supernodal(g, cfg, n_shards=shards)
    poses_1 = np.asarray(res_1.graph.poses)[:n_poses]
    one_s = time.perf_counter() - t0
    note("multi_schur", "one-card supernodal LM solve", one_s)
    chi_s, chi_1 = chi2_f64(data, poses_s), chi2_f64(data, poses_1)
    lim = (1 + BA_RTOL) * chi_1
    checks = [check("step_max_err_vs_f64_one_card", step_err, 1e-3 * scale,
                    step_err <= 1e-3 * scale),
              check("chi2_f64_schur_vs_supernodal_one_card", chi_s, lim,
                    chi_s <= lim)]
    return report({"phase": "multi_schur", "poses": n_poses,
                   "separator_poses": int(plan.ns),
                   "iters": int(res_s.n_iter),
                   "one_card_iters": int(res_1.n_iter),
                   "step_first_call_s": step_s, "solve_s": solve_s,
                   "one_card_solve_s": one_s, "one_card_chi2": chi_1,
                   "checks": checks})


def phase_multi_registration(batch_mesh, space_mesh, batch=4096,
                             n_beams=720, nx=128, n_slab=8):
    """Data-parallel ``dist.match_batch_sharded`` against ``match_batch`` on
    one card; slab-sharded builds against the dense build; slab-sharded
    ``dist.match_slab`` against ``match`` on one card."""
    mcfg = MatchConfig(phase2_width=128, phase1_iters=16)
    ncfg = NDTMapConfig()
    grid, stats, (wpts, wmsk), spts, smsk, init = matcher_scene(
        batch, n_beams, nx)
    ndt_map = ndt_grid.finalize(stats, ncfg)
    t0 = time.perf_counter()
    got = jax.tree_util.tree_map(np.asarray, dist.match_batch_sharded(
        batch_mesh, spts, smsk, ndt_map, init, grid, mcfg))
    first = time.perf_counter() - t0
    note("multi_registration", "data-parallel first call", first)
    ref = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda p, m, nm, i: ndt_match.match_batch(p, m, nm, i, grid, mcfg))(
            spts, smsk, ndt_map, init))
    checks = compare_poses("dp_vs_one_card", got.pose, got.converged,
                           ref.pose, ref.converged)

    # Slab builds: replicated points, and points held by the card that
    # owns their x-slab (halo exchange for the shifted overlap grids).
    d = space_mesh.devices.size
    n_ref_cells = np.asarray(stats.n).reshape(grid.overlap, grid.ny, grid.nx)
    n_ref_cells = n_ref_cells.transpose(0, 2, 1)
    slab = jax.jit(lambda p, m: dist.build_slab_stats(space_mesh, p, m,
                                                      grid))(wpts, wmsk)
    err_rep = float(np.abs(np.asarray(slab.n) - n_ref_cells).max())
    pts_np, msk_np = np.asarray(wpts), np.asarray(wmsk)
    ix = np.floor((pts_np[:, 0] - grid.x0) / grid.cell).astype(int)
    owner = np.clip(ix // (grid.nx // d), 0, d - 1)
    per = max(int((owner == k).sum()) for k in range(d))
    ppts = np.zeros((d, per, 2), pts_np.dtype)
    pmsk = np.zeros((d, per), bool)
    for k in range(d):
        sel = np.flatnonzero(owner == k)
        ppts[k, :sel.size] = pts_np[sel]
        pmsk[k, :sel.size] = msk_np[sel]
    slab2 = jax.jit(lambda p, m: dist.build_slab_stats_psharded(
        space_mesh, p, m, grid, halo=2))(ppts, pmsk)
    err_halo = float(np.abs(np.asarray(slab2.n) - n_ref_cells).max())
    checks += [check("slab_build_count_err", err_rep, 0, err_rep == 0),
               check("slab_build_psharded_count_err", err_halo, 0,
                     err_halo == 0)]

    slab_map = dist.finalize_slab(slab, ncfg)
    sidx = np.linspace(0, batch - 1, n_slab).astype(int)
    one = jax.jit(lambda p, m, nm, i: ndt_match.match(p, m, nm, i, grid,
                                                      mcfg))
    on_slab = jax.jit(lambda p, m, sm, i: dist.match_slab(
        space_mesh, p, m, sm, i, grid, mcfg))
    t0 = time.perf_counter()
    r_s = [jax.tree_util.tree_map(np.asarray, on_slab(spts[b], smsk[b],
                                                      slab_map, init[b]))
           for b in sidx]
    note("multi_registration", f"slab-sharded, {sidx.size} scans",
         time.perf_counter() - t0)
    r_1 = [jax.tree_util.tree_map(np.asarray, one(spts[b], smsk[b], ndt_map,
                                                  init[b]))
           for b in sidx]
    s_pose = np.stack([r.pose for r in r_s])
    s_conv = np.asarray([bool(r.converged) for r in r_s])
    checks += compare_poses("slab_vs_one_card", s_pose, s_conv,
                            np.stack([r.pose for r in r_1]),
                            np.asarray([bool(r.converged) for r in r_1]))
    return report({"phase": "multi_registration", "batch": batch,
                   "beams": n_beams, "grid": f"{nx}x{nx}",
                   "dp_first_call_s": first, "slab_scans": n_slab,
                   "checks": checks})


# ------------------------------------------------------------------- main --

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card paths and their one-card "
                         "comparisons")
    args = ap.parse_args(argv)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"chip_smoke: no GPU found (JAX reports platform "
                 f"{dev.platform!r}); this script does not fall back to the "
                 f"CPU")
    enable_compile_cache()
    for line in gpu_name_and_power_limit():
        print(line, flush=True)

    if args.multi:
        n = len(jax.devices())
        if n < 4:
            sys.exit(f"chip_smoke --multi: needs 4 GPUs, JAX sees {n}")
        devs = jax.devices()[:4]
        batch_mesh = dist.batch_mesh(devices=devs)
        space_mesh = dist.space_mesh(devices=devs)
        phase_multi_sessions(batch_mesh)
        phase_multi_schur(space_mesh)
        phase_multi_registration(batch_mesh, space_mesh)
        count = 4
    else:
        phase_matcher()
        _, traj = phase_slam()
        phase_serve()
        phase_ba()
        phase_repeat(traj)
        count = 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
