"""Microbenchmark of the NDT matcher hot path.

Times, on the GPU, the pieces of ``ndtpu.ndt.match.match_batch`` at the
headline bench shape (B=256 scans x 720 beams, 128x128 cells, overlap 4):

  1. one full batched LM registration        (the headline op)
  2. one sgh evaluation (gather + terms)     (per-iteration cost)
  3. the quad-row gather alone               (memory-traffic probe)
  4. the point-terms FLOP block alone        (elementwise-bound probe, fed
                                              by a pre-gathered rows tensor)

The formulation's ceiling is batch / (iterations x per-eval cost); which
bound the gather hits on the GPU is not measured yet (PERF.md, open
questions).
"""

from __future__ import annotations

import sys
import time

# the script dir (not cwd) lands on sys.path, so add the root.
import os as _os
sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import numpy as np


def log(m):
    print(m, file=sys.stderr, flush=True)


def timeit(fn, *args, reps=10, perturb=0):
    """Warm + repeat timing with a per-rep input perturbation.

    ``perturb`` is the index of the argument to jiggle by 1e-4*(k+1): this
    backend serves a repeated jitted call on byte-identical inputs from a
    result cache (measured 0.4 ms for a ~40 ms execution), which is exactly
    what made this script's round-2 numbers internally impossible
    (VERDICT r2 weak item 3 — '[1] full match_batch: 0.06 ms').
    """
    import jax

    import numpy as _np

    rng = _np.random.default_rng()
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for k in range(reps):
        a = list(args)
        # fresh random jiggle: the result cache persists across processes
        a[perturb] = a[perturb] + float(rng.normal(0, 1e-4))
        out = fn(*a)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def main():
    import jax
    import jax.numpy as jnp

    from ndtpu.utils.runtime import enable_compile_cache

    enable_compile_cache()

    from ndtpu.config import GridConfig, MatchConfig, NDTMapConfig
    from ndtpu.data import synth
    from ndtpu.ndt import grid as ndt_grid
    from ndtpu.ndt import match as ndt_match

    dev = jax.devices()[0]
    log(f"device: {dev} ({dev.platform})")

    grid = GridConfig(x0=-32.0, y0=-32.0, cell=0.5, nx=128, ny=128, overlap=4)
    mcfg = MatchConfig()
    n_beams, batch = 720, 256

    world = synth.box_world(half=28.0)
    angles = synth.beam_angles(n_beams)
    map_poses = synth.rectangle_trajectory(64, half=18.0, step=1.5)
    ranges = synth.simulate_scans(world, map_poses, angles, 40.0, 0.01,
                                  jax.random.PRNGKey(0))
    mpts, mmsk = synth.polar_to_xy(ranges, angles, 0.1, 40.0)
    world_pts = synth.se2.transform(map_poses, mpts)
    stats = ndt_grid.build_stats(world_pts.reshape(-1, 2), mmsk.reshape(-1),
                                 grid)
    ndt_map = ndt_grid.finalize(stats, NDTMapConfig())

    scan_poses = synth.rectangle_trajectory(batch, half=17.0, step=1.1)
    r2 = synth.simulate_scans(world, scan_poses, angles, 40.0, 0.01,
                              jax.random.PRNGKey(1))
    spts, smsk = synth.polar_to_xy(r2, angles, 0.1, 40.0)
    init = scan_poses + jnp.asarray([0.2, -0.15, 0.04], spts.dtype)

    table = jax.jit(lambda m: ndt_grid.pack_quad(m, grid))(ndt_map)
    jax.block_until_ready(table)
    log(f"quad table: {table.shape} {table.dtype} "
        f"({table.size * 4 / 2**20:.1f} MiB)")

    # 1. full batched registration
    full = jax.jit(lambda p, m, nm, i: ndt_match.match_batch(
        p, m, nm, i, grid, mcfg))
    t0 = time.perf_counter()
    out = full(spts, smsk, ndt_map, init)
    jax.block_until_ready(out.pose)
    log(f"[1] full match_batch compile+first: {time.perf_counter()-t0:.1f}s")
    dt_full = timeit(full, spts, smsk, ndt_map, init, perturb=3)
    iters = float(jnp.max(out.n_iter))
    log(f"[1] full match_batch: {dt_full*1e3:.2f} ms  "
        f"({batch/dt_full:.0f} scans/s, max iters {iters:.0f}, "
        f"mean {float(jnp.mean(out.n_iter)):.1f}, "
        f"conv {int(jnp.sum(out.converged))}/{batch})")

    # 2. one sgh evaluation (transform + gather + terms)
    mask_f = smsk.astype(spts.dtype)
    px, py = spts[..., 0], spts[..., 1]

    def sgh(tbl, poses):
        c = jnp.cos(poses[:, 2])[:, None]
        s = jnp.sin(poses[:, 2])[:, None]
        x = c * px - s * py + poses[:, 0, None]
        y = s * px + c * py + poses[:, 1, None]
        dpx = -s * px - c * py
        dpy = c * px - s * py
        rows, inb = ndt_grid.lookup_quad(tbl, x, y, grid)
        w_mask = mask_f * inb.astype(x.dtype)
        return ndt_match.point_terms_quad(poses, x, y, dpx, dpy, rows,
                                          w_mask, mcfg, grid.overlap)

    sgh_j = jax.jit(sgh)
    dt_sgh = timeit(sgh_j, table, init, perturb=1)
    log(f"[2] one sgh eval: {dt_sgh*1e6:.0f} us  "
        f"(x{iters:.0f} iters = {dt_sgh*iters*1e3:.2f} ms)")

    # 3. gather alone
    def gather_only(tbl, poses):
        c = jnp.cos(poses[:, 2])[:, None]
        s = jnp.sin(poses[:, 2])[:, None]
        x = c * px - s * py + poses[:, 0, None]
        y = s * px + c * py + poses[:, 1, None]
        rows, inb = ndt_grid.lookup_quad(tbl, x, y, grid)
        return jnp.sum(rows, axis=-1) + inb

    dt_g = timeit(jax.jit(gather_only), table, init, perturb=1)
    gb = batch * n_beams * 32 * 4 / 2**30
    log(f"[3] gather+sum: {dt_g*1e6:.0f} us  "
        f"({gb/dt_g:.0f} GB/s effective on the {gb*1024:.1f} MiB row read)")

    # 4. terms alone on pre-gathered rows
    c = jnp.cos(init[:, 2])[:, None]
    s = jnp.sin(init[:, 2])[:, None]
    x = c * px - s * py + init[:, 0, None]
    y = s * px + c * py + init[:, 1, None]
    dpx = -s * px - c * py
    dpy = c * px - s * py
    rows, inb = jax.jit(
        lambda t, x, y: ndt_grid.lookup_quad(t, x, y, grid))(table, x, y)
    jax.block_until_ready(rows)
    w_mask = mask_f * inb.astype(x.dtype)

    terms = jax.jit(lambda p, x, y, dpx, dpy, r, w: ndt_match.point_terms_quad(
        p, x, y, dpx, dpy, r, w, mcfg, grid.overlap))
    dt_t = timeit(terms, init, x, y, dpx, dpy, rows, w_mask)  # perturb=0 -> init
    log(f"[4] point terms on pre-gathered rows: {dt_t*1e6:.0f} us")

    log(f"summary_ms full={dt_full*1e3:.2f} sgh={dt_sgh*1e3:.3f} "
        f"gather={dt_g*1e3:.3f} terms={dt_t*1e3:.3f} iters={iters:.0f}")


if __name__ == "__main__":
    main()
