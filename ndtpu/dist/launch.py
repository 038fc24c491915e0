"""Multi-process (multi-host) bring-up: ``jax.distributed`` + local rehearsal.

Capability parity (SURVEY.md §8 Phase E "jax.distributed bring-up", BASELINE
config 5 "across >=2 hosts"): the reference is single-process; distribution
is new capability expressed the JAX-native way — one ``initialize()`` per
process, a process-spanning ``Mesh``, and XLA collectives. No hand-rolled
transport.

Three entry points:

- :func:`initialize` — per-process bring-up (env-var driven on real pods:
  each host calls it before touching any device).
- :func:`launch_local` — spawn N single-device CPU worker processes on THIS
  machine (coordinator on localhost) running :func:`worker_main`; the
  honest rehearsal of the >=2-host path that a single-host environment
  allows (tests/test_launch.py runs it).
- ``python -m ndtpu.dist.launch --num-processes N --process-id I ...`` —
  one worker: initialize, build the process-spanning mesh, run the
  distributed Schur-complement pose-graph solve (config 5's solve), report
  chi^2 before/after as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Per-process ``jax.distributed.initialize`` with env fallbacks.

    No-op when ``num_processes`` resolves to 1 (single-process runs and
    tests stay unchanged). Must be called before any device is touched.
    Env fallbacks: ``NDTPU_COORDINATOR`` / ``NDTPU_NUM_PROCESSES`` /
    ``NDTPU_PROCESS_ID`` (pod launchers export per-host values).
    """
    coordinator_address = coordinator_address or os.environ.get(
        "NDTPU_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("NDTPU_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("NDTPU_PROCESS_ID", "0"))
    if num_processes <= 1:
        return
    import jax
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def shutdown() -> None:
    import jax
    jax.distributed.shutdown()


def worker_main(argv=None) -> None:
    """One worker of the distributed rehearsals (see module docstring)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default="localhost:29511")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--n-poses", type=int, default=120)
    ap.add_argument("--task", choices=("schur", "slam"), default="schur",
                    help="schur: distributed pose-graph solve; slam: one "
                         "full windowed SLAM session per process "
                         "(dist.run_sessions_sharded across the "
                         "process-spanning mesh)")
    ap.add_argument("--graph-npz", default="",
                    help="optional serialized PoseGraph (ndtpu.dist.launch."
                         "save_graph_npz) to solve instead of Manhattan")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    initialize(args.coordinator, args.num_processes, args.process_id)

    if args.task == "slam":
        _slam_worker(args)
        shutdown()
        return

    import jax
    import jax.numpy as jnp
    import numpy as np

    from ndtpu.config import SolverConfig
    from ndtpu.data import g2o
    from ndtpu.dist import mesh as dmesh
    from ndtpu.dist import schur
    from ndtpu.graph import factors as fct

    n_dev = len(jax.devices())
    assert n_dev >= args.num_processes, (n_dev, args.num_processes)
    mesh = dmesh.multihost_mesh("space")

    # Identical problem on every process (same seed / same file).
    if args.graph_npz:
        g = load_graph_npz(args.graph_npz)
    else:
        data = g2o.manhattan_world(args.n_poses, seed=0, loop_prob=0.2)
        g = g2o.to_graph(data, dtype=jnp.float32)
        rng = np.random.default_rng(0)
        g = g._replace(poses=g.poses + jnp.asarray(
            rng.normal(0, 0.05, g.poses.shape), jnp.float32))
    plan = schur.plan_partition(
        np.asarray(g.bet_i), np.asarray(g.bet_j), np.asarray(g.bet_mask),
        np.asarray(g.prior_idx), np.asarray(g.prior_mask),
        int(g.poses.shape[0]), n_shards=n_dev)

    chi0 = float(fct.chi2(g))
    # O(F/S) per-process data: only this process's shard rows are built
    # (numpy slice) and stitched into the globally-sharded ShardData.
    sd = schur.shard_data_global(mesh, g, plan)
    res = schur.optimize_schur(mesh, g, plan, SolverConfig(max_iter=10),
                               sd=sd)
    chi1 = float(fct.chi2(res.graph))

    # Timing: one distributed Schur GN step (shard-local linearize +
    # eliminate + psum + separator solve + backsubstitute), jitted ONCE and
    # dispatched with perturbed inputs (identical-input repeats can be
    # served from a cache on some backends — see bench.py).
    import time
    lam = jnp.asarray(1e-3, g.poses.dtype)
    # sd as a jit ARGUMENT: a globally-sharded array cannot be closed over.
    step = jax.jit(lambda g_, sd_: schur.schur_delta(
        mesh, g_, plan, lam, sd=sd_))
    jax.block_until_ready(step(g, sd))
    ts = []
    rng_t = np.random.default_rng()
    for k in range(9):
        # fresh random jiggle: result cache persists across processes
        gk = g._replace(poses=g.poses + jnp.asarray(
            rng_t.normal(0, 1e-6, (1, 1)), g.poses.dtype))
        t0 = time.perf_counter()
        jax.block_until_ready(step(gk, sd))
        ts.append(time.perf_counter() - t0)
    # MIN, not median: on a shared 2-core host the rehearsal's step time is
    # contaminated by whatever else briefly runs; the fastest rep is the
    # least-interfered estimate on both sides of the efficiency ratio
    # (run-to-run medians straddled 0.71-0.93 for the same build).
    step_s = min(ts)

    # Pure collective latency floor: one tiny psum over the same mesh.
    # Reported alongside solve_s so the rehearsal's efficiency number can
    # be decomposed into compute vs cross-process-comm overhead.
    from jax import shard_map
    from jax.sharding import PartitionSpec as _P
    tiny = jnp.ones((n_dev, 8), jnp.float32)
    ps = jax.jit(shard_map(lambda x: jax.lax.psum(x, "space"), mesh=mesh,
                           in_specs=_P("space"), out_specs=_P("space")))
    jax.block_until_ready(ps(tiny))
    ots = []
    for k in range(5):
        t0 = time.perf_counter()
        jax.block_until_ready(ps(tiny + k))
        ots.append(time.perf_counter() - t0)
    psum_s = sorted(ots)[len(ots) // 2]

    if args.process_id == 0:
        rec = {"num_processes": args.num_processes, "n_devices": n_dev,
               "n_poses": args.n_poses, "chi2_before": chi0,
               "chi2_after": chi1, "iters": int(res.n_iter),
               "solve_s": round(step_s, 4), "psum_s": round(psum_s, 4)}
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "w") as f:
                f.write(line)
    shutdown()


def _slam_worker(args) -> None:
    """Multi-process multi-session SLAM rehearsal: one full windowed
    pipeline session per process over the process-spanning ``"batch"``
    mesh (the north-star "scans/s at N hosts" shape for the pipeline
    itself — sessions are independent, so the only cross-process artifact
    is the mesh/sharding bring-up this rehearses).
    """
    import time

    import jax
    import jax.numpy as jnp
    import numpy as np

    from ndtpu import dist as ndist
    from ndtpu.config import (GridConfig, KeyframeConfig, LoopConfig,
                              PipelineConfig)
    from ndtpu.data import synth
    from ndtpu.eval.ate import ate_rmse
    from ndtpu.slam import pipeline

    n_dev = len(jax.devices())
    mesh = ndist.batch_mesh()
    n_scans = max(24, args.n_poses)
    world = synth.box_world(half=11.0)
    stacks, gts = [[], [], []], []
    for k in range(n_dev):                 # identical data on every process
        traj = synth.rectangle_trajectory(n_scans, half=3.0 + 0.3 * k,
                                          step=0.3)
        sq = synth.make_sequence(world, traj, n_beams=120, max_range=20.0,
                                 min_range=0.1, seed=40 + k,
                                 odom_trans_std=0.03, odom_rot_std=0.01)
        for st_, v in zip(stacks, (sq.points, sq.mask, sq.odom)):
            st_.append(v)
        gts.append(sq.gt_poses)
    pts, msk, odo = (jnp.stack(x) for x in stacks)
    cfg = PipelineConfig(
        grid=GridConfig(x0=-14.0, y0=-14.0, cell=1.0, nx=28, ny=28,
                        overlap=4),
        keyframe=KeyframeConfig(dist_thresh=0.5, angle_thresh=0.3,
                                capacity=48),
        loop=LoopConfig(max_candidates=4, local_half_extent=6.0,
                        min_index_gap=8),
        n_beams=120, use_loop_closure=True, window=8, window_passes=2)

    t0 = time.perf_counter()
    st, outs = ndist.run_sessions_sharded(mesh, pts, msk, odo, cfg)
    # Multi-process outputs are globally sharded: each process may only
    # read its ADDRESSABLE shard (its own sessions). Fetching it is also
    # the host-read fence.
    local = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a.addressable_shards[0].data), (st, outs))
    st_l, outs_l = local
    np.asarray(outs_l.pose)
    dt = time.perf_counter() - t0

    # Per-process report: every process evaluates its own sessions; the
    # results are gathered host-side via per-process files (sessions are
    # independent — no collective needed).
    my = []
    for k in range(st_l.kf.n.shape[0]):
        sess = args.process_id * st_l.kf.n.shape[0] + k
        traj_k = pipeline.recover_trajectory(
            jax.tree_util.tree_map(lambda a: a[k], st_l),
            jax.tree_util.tree_map(lambda a: a[k], outs_l))
        my.append({"session": sess,
                   "keyframes": int(st_l.kf.n[k]),
                   "ate": round(float(ate_rmse(traj_k, gts[sess])), 4)})
    default_out = os.path.join(tempfile.gettempdir(), "ndtpu_slam_rehearsal")
    part = (args.out or default_out) + f".p{args.process_id}"
    with open(part, "w") as f:
        f.write(json.dumps(my))

    if args.process_id == 0:
        import glob
        import time as _t
        base = (args.out or default_out) + ".p"
        sess_rows = list(my)
        for pid in range(1, args.num_processes):
            for _ in range(200):                     # wait for peers' files
                try:
                    with open(base + str(pid)) as f:
                        sess_rows += json.loads(f.read())
                    break
                except (FileNotFoundError, json.JSONDecodeError):
                    _t.sleep(0.05)
        sess_rows.sort(key=lambda r: r["session"])
        rec = {"task": "slam", "num_processes": args.num_processes,
               "n_devices": n_dev, "n_scans": n_scans,
               "compile_and_run_s": round(dt, 2),
               "keyframes": [r["keyframes"] for r in sess_rows],
               "ates": [r["ate"] for r in sess_rows]}
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "w") as f:
                f.write(line)


def save_graph_npz(path: str, graph) -> None:
    """Serialize a PoseGraph to npz (for shipping a problem to workers)."""
    import numpy as np
    np.savez(path, **{k: np.asarray(v) for k, v in graph._asdict().items()})


def load_graph_npz(path: str):
    """Inverse of :func:`save_graph_npz` (jnp arrays, scalars as int32)."""
    import jax.numpy as jnp
    import numpy as np

    from ndtpu.graph import factors as fct
    d = np.load(path)
    return fct.PoseGraph(**{k: jnp.asarray(d[k]) for k in d.files})


def launch_local(num_processes: int = 2, n_poses: int = 120,
                 timeout_s: float = 600.0, port: int = 29511,
                 graph_npz: str = "", cores_per_proc: int | None = None,
                 task: str = "schur") -> dict:
    """Spawn N local CPU worker processes and return process 0's report.

    Each worker is a fresh interpreter with ``JAX_PLATFORMS=cpu`` (one CPU
    device per process) — the same code path a real >=2-host launch takes,
    minus the network fabric. The workers never open a GPU, so they can run
    beside a process that holds the card.

    ``cores_per_proc``: pin worker ``p`` to a disjoint set of that many
    cores via ``taskset``. For weak-scaling rehearsals pass the SAME value
    for every process count (including the 1-process baseline) so each
    process has identical resources — the honest emulation of "each host
    has its own machine". Unpinned (None), N workers share all cores and
    the baseline gets N× the per-process compute of the scaled runs, which
    structurally understates efficiency. Sets are wrapped modulo the core
    count (oversubscription is the caller's choice).
    """
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    pp = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    env["PYTHONPATH"] = os.pathsep.join([repo] + pp)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)          # exactly one device per process
    out_path = os.path.join(tempfile.gettempdir(),
                            f"ndtpu_launch_{os.getpid()}.json")
    n_cores = os.cpu_count() or 1
    procs = []
    for pid in range(num_processes):
        cmd = []
        if cores_per_proc:
            cores = [str((pid * cores_per_proc + c) % n_cores)
                     for c in range(cores_per_proc)]
            cmd += ["taskset", "-c", ",".join(cores)]
        cmd += [sys.executable, "-m", "ndtpu.dist.launch",
                "--coordinator", f"localhost:{port}",
                "--num-processes", str(num_processes),
                "--process-id", str(pid), "--n-poses", str(n_poses),
                "--task", task]
        if graph_npz:
            cmd += ["--graph-npz", graph_npz]
        if pid == 0:
            cmd += ["--out", out_path]
        procs.append(subprocess.Popen(cmd, env=env, cwd=repo,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=timeout_s) for p in procs]
    for p, (so, se) in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"worker {p.args} failed rc={p.returncode}\n{so}\n{se}")
    with open(out_path) as f:
        return json.load(f)


if __name__ == "__main__":
    worker_main()
