"""Headline benchmark + BASELINE metric set, on the GPU.

Prints ONE JSON line to stdout:
    {"metric": "...", "value": N, "unit": "...", "vs_baseline": N,
     "extra": {...}}

Headline (metric/value/vs_baseline): batched NDT registration throughput in
scans/s/chip — B concurrent scan-to-map registrations (720 beams, 64x64 m map
at 0.5 m cells, 4 overlap grids), the loop-closure-verification / serving
shape where the >=5x-per-chip BASELINE target lives.

``extra`` carries the full BASELINE.md metric set (VERDICT r2 item 2b):
end-to-end SLAM scans/s + ATE for config-1 (odometry) and config-3 (loop
closure) on the synthetic sequences (real Intel/MIT logs absent from the
machine — SURVEY.md §0), and the config-4 BA solve ms/iter at 10k poses.

Timing protocol: end-to-end runs are jit-wrapped so Python re-tracing
never pollutes a measurement, and every timed rep ends with a HOST READ of
a small output (``np.asarray``), which cannot return before the device
work is done. Timed sections also perturb an input per repetition; on the
GPU that is untested as a need and harmless.

``vs_baseline`` integrity (VERDICT r2 item 2a): the single-thread baseline
(``ndt_numpy.match_vectorized`` — same algorithm/workload/stopping rules,
one-core BLAS numpy, the performance class of an Eigen C++ build; the
reference binary publishes no numbers and cannot be built, SURVEY.md §0) is
measured in a CLEAN pinned subprocess that never imports JAX (so it does
not open the card) with single-threaded BLAS; measured inside the
accelerator process it would run under contention.

Extra diagnostics go to stderr; stdout carries exactly the one JSON line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def disp(ts):
    """min/median/max/rep-count of a timing list, in ms (a single median
    hides the run-to-run spread; record the dispersion)."""
    return {"min_ms": round(min(ts) * 1e3, 2),
            "med_ms": round(float(np.median(ts)) * 1e3, 2),
            "max_ms": round(max(ts) * 1e3, 2), "n": len(ts)}


# ---------------------------------------------------------------- baseline --

def baseline_main(npz_path: str) -> None:
    """Single-thread numpy baseline; runs in a clean subprocess (no JAX)."""
    assert "jax" not in sys.modules, "baseline subprocess must not load JAX"
    from ndtpu.reference_impl.ndt_numpy import NumpyNDTMap, match_vectorized

    d = np.load(npz_path)
    m = NumpyNDTMap(*[float(x) for x in d["grid_f"]],
                    *[int(x) for x in d["grid_i"]],
                    min_pts=int(d["min_pts"]), eig_ratio=float(d["eig_ratio"]),
                    eig_abs_min=float(d["eig_abs_min"]))
    m.n, m.s, m.ss = d["n"], d["s"], d["ss"]
    m.finalize()
    pts, msk, init = d["pts"], d["msk"], d["init"]
    k = pts.shape[0]
    match_vectorized(pts[0], msk[0], m, init[0])          # warm numpy/BLAS
    t0 = time.perf_counter()
    for b in range(k):
        match_vectorized(pts[b], msk[b], m, init[b])
    per_scan = (time.perf_counter() - t0) / k
    print(json.dumps({"baseline_scans_per_s": 1.0 / per_scan}))


def measure_baseline(npz_path: str) -> float:
    """Spawn the pinned single-core subprocess and parse its one JSON line."""
    env = dict(os.environ)
    # Single-thread BLAS; the subprocess never imports JAX.
    pp = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    env["PYTHONPATH"] = os.pathsep.join([os.path.dirname(
        os.path.abspath(__file__))] + pp)
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS",
                "NUMEXPR_NUM_THREADS"):
        env[var] = "1"
    cmd = [sys.executable, os.path.abspath(__file__), "--baseline", npz_path]
    if os.path.exists("/usr/bin/taskset"):
        cmd = ["/usr/bin/taskset", "-c", "0"] + cmd
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=600, check=True)
    return float(json.loads(out.stdout.strip().splitlines()[-1])
                 ["baseline_scans_per_s"])


# -------------------------------------------------------------------- bench --

def main():
    extra = {}

    # === 0. weak-scaling rehearsal (config 5, ">=80% at 2+ hosts") ==========
    # Runs FIRST, before this process initializes JAX: the rehearsal pins
    # its N CPU worker processes (incl. the 1-process baseline) to single
    # cores, and a live accelerator runtime's threads in this process would
    # contend with them. The workers never open the GPU. See
    # bench_weak_scaling.py.
    # base=1600 poses/process: the regime where 2 hosts are actually
    # worth using; the cross-process overhead amortizes against the step.
    from benchmarks.bench_weak_scaling import run as weak_run
    recs = weak_run(base=1600, max_p=2, cores_per_proc=1)
    eff2 = recs[2]["efficiency_vs_1p"]
    log(f"weak scaling rehearsal: eff(2p) {eff2:.3f} "
        f"(solve {recs[1]['solve_s']:.3f}s -> {recs[2]['solve_s']:.3f}s, "
        f"psum floor {recs[2]['psum_s']*1e3:.1f} ms)")
    extra["weak_scaling_eff_2p"] = eff2
    extra["weak_scaling_solve_s_1p"] = recs[1]["solve_s"]
    extra["weak_scaling_solve_s_2p"] = recs[2]["solve_s"]
    extra["weak_scaling_psum_ms_2p"] = round(recs[2]["psum_s"] * 1e3, 2)
    # Efficiencies slightly above 1.0 are shared-host measurement noise,
    # not superlinear scaling — say so in the record itself.
    extra["weak_scaling_caveat"] = (
        "single-host rehearsal over localhost gRPC with equal core "
        "pinning; values near/above 1.0 are shared-host noise "
        "around 1.0, not superlinear scaling")
    # The unfavorable regime too: at 800 poses/process the cross-process
    # overhead no longer amortizes against the step.
    recs_s = weak_run(base=800, max_p=2, cores_per_proc=1, ladders=1)
    eff2s = recs_s[2]["efficiency_vs_1p"]
    log(f"weak scaling rehearsal (small, 800/proc): eff(2p) {eff2s:.3f} "
        f"(psum floor {recs_s[2]['psum_s']*1e3:.1f} ms)")
    extra["weak_scaling_eff_2p_small"] = eff2s
    extra["weak_scaling_psum_ms_2p_small"] = round(
        recs_s[2]["psum_s"] * 1e3, 2)

    import jax
    import jax.numpy as jnp

    from ndtpu.utils.runtime import (enable_compile_cache,
                                     gpu_name_and_power_limit)

    enable_compile_cache()

    from ndtpu.config import (GridConfig, KeyframeConfig, LoopConfig,
                              MatchConfig, NDTMapConfig, PipelineConfig,
                              SolverConfig)
    from ndtpu.data import g2o, synth
    from ndtpu.eval.ate import ate_rmse
    from ndtpu.graph import factors as fct
    from ndtpu.graph import supernodal as sn
    from ndtpu.ndt import grid as ndt_grid
    from ndtpu.ndt import match as ndt_match
    from ndtpu.slam import pipeline

    dev = jax.devices()[0]
    log(f"device: {dev} ({dev.platform}, {dev.device_kind})")
    for line in gpu_name_and_power_limit():
        log(f"nvidia-smi: {line}")

    # === 1. headline: batched registration throughput =======================
    grid = GridConfig(x0=-32.0, y0=-32.0, cell=0.5, nx=128, ny=128, overlap=4)
    # Serving headline config: two-phase matching (phase1 at full width,
    # stragglers compacted to 128-wide rounds) removes the max-over-batch
    # while_loop tail (p50=13 vs max=30 iters) at identical convergence.
    mcfg = MatchConfig(phase2_width=128, phase1_iters=16)
    ncfg = NDTMapConfig()
    n_beams, batch = 720, 4096

    world = synth.box_world(half=28.0)
    angles = synth.beam_angles(n_beams)
    key = jax.random.PRNGKey(0)
    map_poses = synth.rectangle_trajectory(64, half=18.0, step=1.5)
    ranges = synth.simulate_scans(world, map_poses, angles, 40.0, 0.01, key)
    mpts, mmsk = synth.polar_to_xy(ranges, angles, 0.1, 40.0)
    world_pts = synth.se2.transform(map_poses, mpts)
    stats = ndt_grid.build_stats(world_pts.reshape(-1, 2),
                                 mmsk.reshape(-1), grid)
    ndt_map = ndt_grid.finalize(stats, ncfg)

    scan_poses = synth.rectangle_trajectory(batch, half=17.0, step=1.1)
    r2 = synth.simulate_scans(world, scan_poses, angles, 40.0, 0.01,
                              jax.random.PRNGKey(1))
    spts, smsk = synth.polar_to_xy(r2, angles, 0.1, 40.0)
    init = scan_poses + jnp.asarray([0.2, -0.15, 0.04], spts.dtype)

    # The map is a runtime ARGUMENT, not a closure: closing over multi-MB
    # device arrays embeds them as HLO constants (slow to compile on the
    # original backend; untested on the GPU, harmless either way).
    fn = jax.jit(lambda p, m, nm, i: ndt_match.match_batch(
        p, m, nm, i, grid, mcfg))

    t0 = time.perf_counter()
    out0 = fn(spts, smsk, ndt_map, init)
    jax.block_until_ready(out0.pose)
    log(f"headline compile+first: {time.perf_counter() - t0:.1f}s; "
        f"converged {int(jnp.sum(out0.converged))}/{batch}, "
        f"mean iters {float(jnp.mean(out0.n_iter)):.1f}")

    rng = np.random.default_rng()        # fresh jiggle values every run
    reps = 8
    ts = []
    for k in range(reps):
        i_k = init + jnp.asarray(rng.normal(0, 1e-3, (batch, 3)),
                                 spts.dtype)
        t0 = time.perf_counter()
        out = fn(spts, smsk, ndt_map, i_k)
        np.asarray(out.pose)            # host read = real fence
        ts.append(time.perf_counter() - t0)
    dt = float(np.median(ts))
    scans_per_s = batch / dt
    log(f"headline warm: median {dt*1e3:.1f} ms / {batch} scans "
        f"-> {scans_per_s:.0f} scans/s")
    extra["headline_batch"] = batch
    extra["headline_timing"] = disp(ts)

    # === 2. single-thread baseline (clean pinned subprocess) ================
    import tempfile
    npz = os.path.join(tempfile.mkdtemp(), "ndtpu_bench_baseline.npz")
    k = 8
    np.savez(npz,
             grid_f=np.asarray([grid.x0, grid.y0, grid.cell]),
             grid_i=np.asarray([grid.nx, grid.ny, grid.overlap]),
             min_pts=ncfg.min_pts, eig_ratio=ncfg.eig_ratio,
             eig_abs_min=ncfg.eig_abs_min,
             n=np.asarray(stats.n, float), s=np.asarray(stats.s, float),
             ss=np.asarray(stats.ss, float),
             pts=np.asarray(spts[:k], float), msk=np.asarray(smsk[:k]),
             init=np.asarray(init[:k], float))
    base_scans_per_s = measure_baseline(npz)
    log(f"single-thread baseline (clean subprocess): "
        f"{base_scans_per_s:.1f} scans/s")
    extra["baseline_numpy_scans_per_s"] = round(base_scans_per_s, 1)

    # === 3. end-to-end SLAM: configs 1-3 (windowed) =========================
    # config1 = pure NDT odometry (no graph); config2 = odometry + keyframe
    # graph + incremental smoothing + online map; config3 = + loop closure.
    n_scans = 300
    pcfg_base = dict(
        grid=GridConfig(x0=-14.0, y0=-14.0, cell=0.5, nx=56, ny=56,
                        overlap=4),
        keyframe=KeyframeConfig(dist_thresh=0.5, angle_thresh=0.3,
                                capacity=512),
        loop=LoopConfig(radius=3.0, min_index_gap=10, max_candidates=8,
                        local_half_extent=8.0),
        solver=SolverConfig(inc_iters=2, pcg_max_iter=60),
        n_beams=360, max_range=20.0, window=8, window_passes=2,
    )
    sworld = synth.box_world(half=11.0)
    straj = synth.rectangle_trajectory(n_scans, half=7.0, step=0.2)
    seq = synth.make_sequence(sworld, straj, n_beams=360, max_range=20.0,
                              min_range=0.1, seed=1, odom_trans_std=0.04,
                              odom_rot_std=0.01)

    # config 1: windowed odometry front end alone.
    from ndtpu.slam.odometry import run_odometry_windowed
    ocfg = pcfg_base
    run1 = jax.jit(lambda p, m, o: run_odometry_windowed(
        p, m, o, ocfg["grid"], NDTMapConfig(), MatchConfig(),
        ocfg["keyframe"], window=8, passes=2))
    t0 = time.perf_counter()
    r0 = run1(seq.points, seq.mask, seq.odom)
    np.asarray(r0.poses)
    log(f"config1 compile+first: {time.perf_counter() - t0:.1f}s")
    ts1 = []
    for k in range(3):
        pts_k = seq.points + jnp.asarray(rng.normal(0, 1e-5, (1, 1, 1)),
                                         seq.points.dtype)
        t0 = time.perf_counter()
        r1 = run1(pts_k, seq.mask, seq.odom)
        np.asarray(r1.poses)            # host read = real fence
        ts1.append(time.perf_counter() - t0)
    e2e1 = n_scans / float(np.median(ts1))
    ate1 = float(ate_rmse(r0.poses, seq.gt_poses))  # first-call outputs
    log(f"config1 (odometry): {e2e1:.0f} scans/s e2e, ATE {ate1:.4f} m")
    extra["slam_config1_scans_per_s"] = round(e2e1, 1)
    extra["slam_config1_ate_m"] = round(ate1, 4)
    extra["slam_config1_timing"] = disp(ts1)

    for label, use_loops in (("config2", False), ("config3", True)):
        cfg = PipelineConfig(use_loop_closure=use_loops, **pcfg_base)
        run = jax.jit(lambda p, m, o: pipeline.run_slam_windowed(p, m, o,
                                                                 cfg))
        t0 = time.perf_counter()
        st0, outs0 = run(seq.points, seq.mask, seq.odom)
        np.asarray(outs0.pose)
        log(f"{label} compile+first: {time.perf_counter() - t0:.1f}s")
        reps, ts_e = 3, []
        for k in range(reps):
            # Fresh random jiggle per rep.
            pts_k = seq.points + jnp.asarray(
                rng.normal(0, 1e-5, (1, 1, 1)), seq.points.dtype)
            t0 = time.perf_counter()
            st, outs = run(pts_k, seq.mask, seq.odom)
            np.asarray(outs.pose)       # host read = real fence
            ts_e.append(time.perf_counter() - t0)
        warm = float(np.median(ts_e))
        # Correctness outputs from the FIRST call.
        st = st0
        traj = pipeline.recover_trajectory(st0, outs0)
        ate = float(ate_rmse(traj, seq.gt_poses))
        e2e = n_scans / warm
        log(f"{label}: {e2e:.0f} scans/s e2e, ATE {ate:.4f} m, "
            f"loops {int(st.n_loops)}, keyframes {int(st.kf.n)}")
        extra[f"slam_{label}_scans_per_s"] = round(e2e, 1)
        extra[f"slam_{label}_ate_m"] = round(ate, 4)
        extra[f"slam_{label}_timing"] = disp(ts_e)

    # === 3b. multi-lap robustness: 1000 scans, 3.5 laps (ATE only) ==========
    # Guards the loop-factor budget + Huber smoothing findings (PERF.md):
    # without them this run lands at 1.9 m, with them ~0.08 m. Single run,
    # first-call outputs, no timing.
    mcfg3 = PipelineConfig(use_loop_closure=True, **pcfg_base)
    traj_ml = synth.rectangle_trajectory(1000, half=7.0, step=0.2)
    seq_ml = synth.make_sequence(sworld, traj_ml, n_beams=360, max_range=20.0,
                                 min_range=0.1, seed=7, odom_trans_std=0.04,
                                 odom_rot_std=0.01)
    run_ml = jax.jit(lambda p, m, o: pipeline.run_slam_windowed(p, m, o,
                                                                mcfg3))
    t0 = time.perf_counter()
    st_ml, outs_ml = run_ml(seq_ml.points, seq_ml.mask, seq_ml.odom)
    np.asarray(outs_ml.pose)
    ate_ml = float(ate_rmse(pipeline.recover_trajectory(st_ml, outs_ml),
                            seq_ml.gt_poses))
    # Smoother-path takes per window (VERDICT r5 task 4): how often does
    # the k-hop bounded-cost local path actually engage under loop load?
    # Codes: 0 = settled skip, 1 = global PCG, 2 = k-hop local. One code
    # per window (broadcast per scan -> sample stride W).
    takes = np.asarray(outs_ml.local_take)[:: mcfg3.window]
    n_win_ml = takes.size
    frac = lambda c: float((takes == c).sum()) / max(n_win_ml, 1)
    log(f"multilap (1000 scans, 3.5 laps): ATE {ate_ml:.4f} m, "
        f"loops {int(st_ml.n_loops)} "
        f"(compile+run {time.perf_counter() - t0:.1f}s); smoother takes: "
        f"skip {frac(0):.2f} / global {frac(1):.2f} / local {frac(2):.2f}")
    extra["slam_multilap1000_ate_m"] = round(ate_ml, 4)
    extra["multilap_take_frac_skip"] = round(frac(0), 3)
    extra["multilap_take_frac_global"] = round(frac(1), 3)
    extra["multilap_take_frac_local"] = round(frac(2), 3)
    extra["multilap_innov_rejected"] = int(
        np.asarray(outs_ml.n_innov_rej).sum())

    # === 4. BA solve ms/iter at 10k poses (config 4) ========================
    data = g2o.manhattan_world(10000, seed=0, loop_prob=0.1)
    g = g2o.to_graph(data, dtype=jnp.float32)
    # Separate SEEDED generator for the deterministic graph perturbation;
    # `rng` stays the unseeded one for the per-rep timing jiggles.
    rng_g = np.random.default_rng(0)
    g = g._replace(poses=g.poses + jnp.asarray(
        rng_g.normal(0, 0.05, g.poses.shape), jnp.float32))
    plan = sn.plan_supernodal(g, 64)
    step = jax.jit(lambda g_, lam: sn.supernodal_delta(
        g_, fct.linearize(g_), plan, lam))
    lam = jnp.asarray(1e-3, jnp.float32)
    jax.block_until_ready(step(g, lam))
    ts_b = []
    for k in range(10):
        gk = g._replace(poses=g.poses + jnp.asarray(
            rng.normal(0, 1e-6, (1, 1)), jnp.float32))
        t0 = time.perf_counter()
        out = step(gk, lam)
        np.asarray(out[0])              # host read = real fence
        ts_b.append(time.perf_counter() - t0)
    ba_ms = float(np.median(ts_b)) * 1e3
    log(f"BA supernodal solve: {ba_ms:.1f} ms/iter at 10k poses")
    extra["ba_solve_ms_per_iter_10k"] = round(ba_ms, 2)
    extra["ba_solve_timing"] = disp(ts_b)

    # === 5. incremental-update cost at 10k poses (iSAM2-update role) ========
    from ndtpu.graph import incremental as inc
    from ndtpu.graph import solve as slv
    icfg = SolverConfig(inc_iters=2, pcg_max_iter=25, full_solve_every=0)
    upd = jax.jit(lambda s: inc.incremental_update(s, icfg))
    st = inc.SmootherState(graph=g, lam=lam,
                           last_max_delta=jnp.asarray(jnp.inf, jnp.float32),
                           step=jnp.asarray(0, jnp.int32))
    jax.block_until_ready(upd(st).graph.poses)
    def jiggle(s_):
        return s_._replace(graph=s_.graph._replace(
            poses=s_.graph.poses + jnp.asarray(
                rng.normal(0, 1e-6, (1, 1)), jnp.float32)))
    ts_i = []
    for k in range(10):
        t0 = time.perf_counter()
        out = upd(jiggle(st))
        np.asarray(out.graph.poses[0])  # host read = real fence
        ts_i.append(time.perf_counter() - t0)
    inc_ms = float(np.median(ts_i)) * 1e3
    # Settled path: a genuinely CONVERGED graph (zero gradient), so the
    # O(K) fresh-residual + gradient skip tiers actually fire.
    sol = slv.optimize(g, SolverConfig(max_iter=30, pcg_max_iter=250),
                       method="pcg")
    st2 = inc.SmootherState(graph=sol.graph, lam=lam,
                            last_max_delta=jnp.asarray(0.0, jnp.float32),
                            step=jnp.asarray(0, jnp.int32))
    jax.block_until_ready(upd(st2).graph.poses)
    ts_s = []
    for k in range(10):
        t0 = time.perf_counter()
        out = upd(jiggle(st2))
        np.asarray(out.graph.poses[0])  # host read = real fence
        ts_s.append(time.perf_counter() - t0)
    skip_ms = float(np.median(ts_s)) * 1e3
    log(f"incremental update at 10k poses: active {inc_ms:.1f} ms, "
        f"settled {skip_ms:.2f} ms")
    extra["incremental_update_ms_10k"] = round(inc_ms, 2)
    extra["incremental_settled_ms_10k"] = round(skip_ms, 3)
    extra["incremental_timing"] = disp(ts_i)

    # 5b. k-hop LOCAL update at 10k poses (iSAM2 clique-local capability,
    # r4): a fresh odometry chain on a settled graph solves only its
    # neighborhood — cost independent of graph size.
    from ndtpu.lie import se2 as _se2
    gbig = fct.empty_graph(10064, 4, g.bet_mask.shape[0] + 64, jnp.float32)
    f0 = g.bet_mask.shape[0]
    gbig = gbig._replace(
        poses=gbig.poses.at[:10000].set(sol.graph.poses),
        pose_mask=gbig.pose_mask.at[:10000].set(sol.graph.pose_mask),
        prior_idx=sol.graph.prior_idx, prior_z=sol.graph.prior_z,
        prior_sqrt_info=sol.graph.prior_sqrt_info,
        prior_mask=sol.graph.prior_mask,
        bet_i=gbig.bet_i.at[:f0].set(sol.graph.bet_i),
        bet_j=gbig.bet_j.at[:f0].set(sol.graph.bet_j),
        bet_z=gbig.bet_z.at[:f0].set(sol.graph.bet_z),
        bet_sqrt_info=gbig.bet_sqrt_info.at[:f0].set(sol.graph.bet_sqrt_info),
        bet_mask=gbig.bet_mask.at[:f0].set(sol.graph.bet_mask),
        n_poses=sol.graph.n_poses, n_priors=sol.graph.n_priors,
        n_between=sol.graph.n_between)
    since10 = gbig.n_between
    last10 = int(gbig.n_poses) - 1
    for kk in range(4):
        idx = int(gbig.n_poses)
        newp = _se2.compose(gbig.poses[last10 + kk],
                            jnp.asarray([1.0, 0.02, 0.01], jnp.float32))
        gbig = fct.add_pose(gbig, newp)
        gbig = fct.add_between(gbig, last10 + kk, idx,
                               jnp.asarray([1.0, 0.0, 0.0], jnp.float32),
                               jnp.eye(3, dtype=jnp.float32) * 10.0)
    # Chained x8 inside one dispatch, so one timed rep is 8 updates rather
    # than one dispatch's fixed overhead (whether the GPU needs this is
    # untested).
    k_ch = 8

    def chain_local(g_, lam_):
        def body(i, carry):
            gg, ll = carry
            gg2, ll2, _ = inc.local_update(
                gg._replace(poses=gg.poses + 1e-9), ll, icfg, since=since10)
            return gg2, ll2
        return jax.lax.fori_loop(0, k_ch, body, (g_, lam_))

    loc = jax.jit(chain_local)
    np.asarray(loc(gbig, lam)[0].poses[0])
    ts_l = []
    for kk in range(6):
        gk = gbig._replace(poses=gbig.poses + jnp.asarray(
            rng.normal(0, 1e-6, (1, 1)), jnp.float32))
        np.asarray(gk.poses[0])
        t0 = time.perf_counter()
        out = loc(gk, lam)
        np.asarray(out[0].poses[0])
        ts_l.append(time.perf_counter() - t0)
    loc_ms = float(np.median(ts_l)) / k_ch * 1e3
    log(f"k-hop local update at 10k poses: {loc_ms:.2f} ms "
        f"(chained x{k_ch}; vs {inc_ms:.1f} ms global active)")
    extra["incremental_local_ms_10k"] = round(loc_ms, 2)

    # === 6. multi-session SLAM: aggregate scans/s on one chip ===============
    # North-star "scans/s at 1 chip / 1 host / N hosts" for the PIPELINE
    # itself (VERDICT r3 item 5): 8 independent sessions (multi-robot
    # serving shape) multiplexed through ONE jitted pipeline program on
    # this chip — the realistic single-chip serving strategy. (A lockstep
    # vmap over sessions measured 176 scans/s aggregate: vmapped lax.cond
    # executes BOTH branches, so every window pays the full-map rebuild
    # for every session. Multi-DEVICE scale-out instead runs one UNBATCHED
    # session per device: dist.run_sessions_sharded, validated on the
    # 8-virtual-device mesh in test_dist.py and the driver dryrun.)
    cfg8 = PipelineConfig(use_loop_closure=True, **pcfg_base)
    run_one = jax.jit(lambda p, m, o: pipeline.run_slam_windowed(p, m, o,
                                                                 cfg8))
    n_sess = 8
    sessions = []
    for k in range(n_sess):
        traj_k = synth.rectangle_trajectory(n_scans, half=6.0 + 0.2 * k,
                                            step=0.2)
        sq = synth.make_sequence(sworld, traj_k, n_beams=360, max_range=20.0,
                                 min_range=0.1, seed=20 + k,
                                 odom_trans_std=0.04, odom_rot_std=0.01)
        sessions.append(sq)
    s0, o0 = run_one(sessions[0].points, sessions[0].mask, sessions[0].odom)
    np.asarray(o0.pose)                      # compile once
    t0 = time.perf_counter()
    loops8, ser_ates = [], []
    for k, sq in enumerate(sessions):
        pk = sq.points + jnp.asarray(rng.normal(0, 1e-5, (1, 1, 1)),
                                     sq.points.dtype)
        stk, ok_ = run_one(pk, sq.mask, sq.odom)
        np.asarray(ok_.pose)
        loops8.append(int(stk.n_loops))
        ser_ates.append(float(ate_rmse(
            pipeline.recover_trajectory(stk, ok_), sq.gt_poses)))
    dt8 = time.perf_counter() - t0
    agg = n_sess * n_scans / dt8
    log(f"multi-session SLAM serialized: {n_sess} x {n_scans} scans -> "
        f"{agg:.0f} aggregate scans/s (loops {loops8}, "
        f"ATE mean {np.mean(ser_ates):.4f} max {max(ser_ates):.4f})")
    extra["slam_sessions8_scans_per_s_1chip"] = round(agg, 1)
    extra["slam_sessions8_ate_mean_serialized"] = round(
        float(np.mean(ser_ates)), 4)
    extra["slam_sessions8_ate_max_serialized"] = round(max(ser_ates), 4)

    # 6b. STACKED serving (VERDICT r5 task 1): all 8 sessions through ONE
    # windowed program per window — S*W registration lanes and S*K*C loop
    # verifications fuse into wide batched LM calls, the smoother runs as
    # one flat block-diagonal graph, and the rare-branch conds are hoisted
    # to batch level (one branch at runtime). PERF.md carries the
    # per-window budget (a window is LATENCY-bound, ~45 sequential LM/PCG
    # iterations, which is why the aggregate lands where it does).
    import dataclasses as _dc
    from ndtpu.dist import slam_dp
    scfg8 = slam_dp.serving_config(cfg8)
    scfg8 = _dc.replace(scfg8, loop=_dc.replace(scfg8.loop,
                                                max_candidates=4))
    # Right-size the keyframe/graph capacity to the serving session length
    # (300 scans -> ~111 keyframes; 160 leaves ~40% headroom): the flat
    # smoother, refresh top_k, and every graph scatter pay for CAPACITY,
    # not occupancy, and 512 was costing ~15% aggregate throughput.
    # SlamStepOut.n_dropped guards saturation if a deployment undersizes.
    scfg8 = _dc.replace(scfg8, keyframe=_dc.replace(scfg8.keyframe,
                                                    capacity=160))
    run_st = jax.jit(lambda p, m, o: slam_dp.run_sessions_stacked(
        p, m, o, scfg8))
    P8 = jnp.stack([sq.points for sq in sessions])
    M8 = jnp.stack([sq.mask for sq in sessions])
    O8 = jnp.stack([sq.odom for sq in sessions])
    st8, o8 = run_st(P8, M8, O8)
    np.asarray(o8.pose)
    st_ates = [float(ate_rmse(pipeline.recover_trajectory(
        jax.tree_util.tree_map(lambda a: a[k], st8),
        jax.tree_util.tree_map(lambda a: a[k], o8)),
        sessions[k].gt_poses)) for k in range(n_sess)]
    ts8 = []
    for r in range(3):
        pk = P8 + jnp.asarray(rng.normal(0, 1e-5, (1, 1, 1, 1)), P8.dtype)
        t0 = time.perf_counter()
        _, o_ = run_st(pk, M8, O8)
        np.asarray(o_.pose)                 # host read = real fence
        ts8.append(time.perf_counter() - t0)
    agg_st = n_sess * n_scans / float(np.median(ts8))
    log(f"multi-session SLAM stacked: {n_sess} x {n_scans} scans -> "
        f"{agg_st:.0f} aggregate scans/s on 1 chip "
        f"(loops {[int(x) for x in np.asarray(st8.n_loops)]}, "
        f"ATE mean {np.mean(st_ates):.4f} max {max(st_ates):.4f}; "
        f"serialized: {agg:.0f})")
    extra["slam_sessions8_stacked_scans_per_s_1chip"] = round(agg_st, 1)
    extra["slam_sessions8_stacked_timing"] = disp(ts8)
    extra["slam_sessions8_ate_mean_stacked"] = round(
        float(np.mean(st_ates)), 4)
    extra["slam_sessions8_ate_max_stacked"] = round(max(st_ates), 4)

    # === 7. multi-session merge: auto inter-session loop factors ===========
    # (VERDICT r5 task 2) Two overlapping sessions, merge transform
    # deliberately perturbed by ~0.32 m: the anchor-only merge keeps the
    # offset (its one factor measures the wrong transform), the auto
    # factors (NDT verification of B scans against A keyframes' cached
    # tables) pull session B back to its true placement.
    from ndtpu.lie import se2 as _se2m
    from ndtpu.slam import merge as mrg
    mcfgp = PipelineConfig(
        grid=GridConfig(x0=-12.0, y0=-12.0, cell=1.0, nx=24, ny=24,
                        overlap=4),
        keyframe=KeyframeConfig(dist_thresh=0.7, angle_thresh=0.35,
                                capacity=48),
        loop=LoopConfig(radius=3.0, min_index_gap=8, max_candidates=4,
                        local_half_extent=8.0),
        solver=SolverConfig(inc_iters=1, pcg_max_iter=40),
        use_loop_closure=False)
    mworld = synth.box_world(half=9.0)
    mtraj_a = synth.rectangle_trajectory(60, half=6.0, step=0.3)
    mb0 = jnp.asarray([1.5, 2.0, 0.7], jnp.float32)
    mtraj_b = _se2m.compose(jnp.broadcast_to(mb0, (40, 3)),
                            synth.rectangle_trajectory(40, half=4.0,
                                                       step=0.25))
    t_exp = _se2m.between(mtraj_a[0], mtraj_b[0])
    sqa = synth.make_sequence(mworld, mtraj_a, n_beams=180,
                              max_range=16.0, min_range=0.1, seed=5)
    sqb = synth.make_sequence(mworld, mtraj_b, n_beams=180,
                              max_range=16.0, min_range=0.1, seed=6)
    msa, _ = pipeline.run_slam_windowed(sqa.points, sqa.mask, sqa.odom,
                                        mcfgp)
    msb, _ = pipeline.run_slam_windowed(sqb.points, sqb.mask, sqb.odom,
                                        mcfgp)
    al = mrg.global_align(ndt_grid.finalize(msa.stats, mcfgp.ndt),
                          mcfgp.grid, msb.kf.points[0], msb.kf.masks[0],
                          span=8.0, step=1.0, n_theta=16)
    t_bad = _se2m.compose(al.transform,
                          jnp.asarray([0.25, -0.2, 0.06], jnp.float32))
    from ndtpu.graph import solve as slvm
    idxb = np.flatnonzero(np.asarray(msb.kf.live))
    true_b = np.asarray(_se2m.compose(
        jnp.broadcast_to(t_exp, (idxb.size, 3)),
        msb.graph.poses[jnp.asarray(idxb)]))
    na = msa.graph.capacity

    def b_err(graph):
        mb = np.asarray(graph.poses)[na + idxb]
        d = mb[:, :2] - true_b[:, :2]
        return float(np.hypot(d[:, 0], d[:, 1]).mean())

    sqanchor = jnp.asarray(np.diag([10.0, 10.0, 20.0]), jnp.float32)
    anchor = (np.asarray([0]), np.asarray([0]), t_bad[None, :],
              sqanchor[None])
    ganc = mrg.merge_graphs(msa.graph, msb.graph, t_bad,
                            inter_factors=anchor)
    eanc = b_err(slvm.optimize(ganc, SolverConfig(max_iter=15),
                               method="pcg").graph)
    ia_, jb_, z_, sqi_ = mrg.find_inter_session_loops(
        msa.kf, msb.kf, t_bad, mcfgp.loop, mcfgp.match,
        ndt_cfg=mcfgp.ndt)
    gaut = mrg.merge_graphs(msa.graph, msb.graph, t_bad,
                            inter_factors=(ia_, jb_, z_, sqi_))
    eaut = b_err(slvm.optimize(gaut, SolverConfig(max_iter=15),
                               method="pcg").graph)
    log(f"merge: {ia_.size} auto inter-session loops; B placement "
        f"error {eanc:.3f} m (anchor-only) -> {eaut:.3f} m (auto)")
    extra["merge_inter_loops"] = int(ia_.size)
    extra["merge_b_placement_err_anchor_m"] = round(eanc, 4)
    extra["merge_b_placement_err_auto_m"] = round(eaut, 4)

    print(json.dumps({
        "metric": "ndt_registration_throughput",
        "value": round(scans_per_s, 1),
        "unit": "scans/s/chip",
        "vs_baseline": round(scans_per_s / base_scans_per_s, 1),
        "extra": extra,
    }))


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--baseline":
        baseline_main(sys.argv[2])
    else:
        main()
