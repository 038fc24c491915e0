"""Device trace of one stacked-serving run + top-op aggregation.

Runs the 8-session x 300-scan run_sessions_stacked workload under
``jax.profiler.trace`` and aggregates device-stream op durations from the
perfetto JSON, printing the top ops by total time. This is the op-level
ground truth behind a per-stage window budget: the budget comes from
inside the one big program, not from per-dispatch micro-benchmarks.
The trace is written under ``$TMPDIR/ndtpu_serving_trace``.
"""
from __future__ import annotations

import collections
import glob
import gzip
import json
import os
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, ".")

from ndtpu.dist import slam_dp

from bench_serving_sweep import base_cfg, make_sessions

TRACE_DIR = os.path.join(tempfile.gettempdir(), "ndtpu_serving_trace")


def main():
    from bench_serving_sweep import parse_tokens
    cfg = parse_tokens(base_cfg(), ",".join(sys.argv[1:]))
    sessions = make_sessions()
    P8 = jnp.stack([sq.points for sq in sessions])
    M8 = jnp.stack([sq.mask for sq in sessions])
    O8 = jnp.stack([sq.odom for sq in sessions])
    run_st = jax.jit(lambda p, m, o: slam_dp.run_sessions_stacked(
        p, m, o, cfg))
    st8, o8 = run_st(P8, M8, O8)
    np.asarray(o8.pose)
    t0 = time.perf_counter()
    with jax.profiler.trace(TRACE_DIR):
        _, o_ = run_st(P8, M8, O8)
        np.asarray(o_.pose)
    wall = time.perf_counter() - t0
    print(f"traced run: {wall*1e3:.0f} ms wall", flush=True)

    files = sorted(glob.glob(TRACE_DIR + "/**/*.trace.json.gz",
                             recursive=True))
    with gzip.open(files[-1], "rt") as f:
        tr = json.load(f)
    # GPU stream lanes: pick pids whose process name is a device
    # ("/device:GPU:0" ...); aggregate dur by event name.
    pid_name = {}
    for ev in tr["traceEvents"]:
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            pid_name[ev["pid"]] = ev["args"].get("name", "")
    agg = collections.Counter()
    cnt = collections.Counter()
    total = 0.0
    for ev in tr["traceEvents"]:
        if ev.get("ph") != "X":
            continue
        pname = pid_name.get(ev.get("pid"), "")
        if "/device:GPU" not in pname:
            continue
        name = ev.get("name", "?")
        dur = ev.get("dur", 0) / 1e3        # us -> ms
        agg[name] += dur
        cnt[name] += 1
        total += dur
    print(f"device total: {total:.0f} ms across {sum(cnt.values())} events")
    for name, ms in agg.most_common(30):
        print(f"{ms:9.1f} ms  x{cnt[name]:<6d} {name[:110]}")


if __name__ == "__main__":
    main()
