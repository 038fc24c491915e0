"""NDT grid-map construction as batched tensor programs.

Capability parity (SURVEY.md §3.1 "NDT cell / grid map", §4.4): each grid
cell accumulates the sufficient statistics ``(n, sum p, sum p p^T)`` of the
points that fell in it; the per-cell Gaussian ``(mu, Sigma)`` is derived from
them with eigenvalue regularization (Biber & Strasser 2003; Magnusson 2009).

Design (not a port of the reference's per-point C++ loop):

- The map is a **dense SoA tensor** over all ``G x C`` cells (``G`` = number
  of half-cell-shifted overlap grids, ``C = nx*ny``) — static shapes, so the
  map can live inside ``lax.scan`` carries and be sharded with
  ``NamedSharding``.
- Accumulation is one ``jax.ops.segment_sum`` over flattened ``G*N`` point
  slots — XLA lowers this to an efficient sorted scatter-add; there is no
  per-point host loop anywhere.
- Statistics are *incremental*: ``add_points`` can be called per scan (online
  map build, SURVEY.md §1 capability 4) and ``finalize`` is a cheap
  closed-form pass (2x2 eigendecomposition is analytic) done whenever the
  matcher needs a fresh Gaussian view.
- Everything is dtype-polymorphic; f32 on the device, f64 for test oracles.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ndtpu.config import GridConfig, NDTMapConfig

__all__ = [
    "NDTStats",
    "NDTMap",
    "cell_ids",
    "empty_stats",
    "add_points",
    "build_stats",
    "finalize",
    "lookup",
    "pack_map",
    "lookup_packed",
    "pack_quad",
    "lookup_quad",
    "lookup_quad_multi",
    "unpack_bf16_pair",
]


class NDTStats(NamedTuple):
    """Raw per-cell sufficient statistics (the incremental map state).

    n:  ``[G, C]``        point count per cell (float for segment_sum).
    s:  ``[G, C, 2]``     sum of points.
    ss: ``[G, C, 2, 2]``  sum of outer products ``p p^T``.
    """

    n: jax.Array
    s: jax.Array
    ss: jax.Array


class NDTMap(NamedTuple):
    """Finalized Gaussian view of the map, consumed by the matcher.

    mean:  ``[G, C, 2]``
    icov:  ``[G, C, 2, 2]`` inverse of the regularized covariance.
    valid: ``[G, C]``       1.0 where the cell has >= min_pts points.
    """

    mean: jax.Array
    icov: jax.Array
    valid: jax.Array


def _grid_offsets(grid: GridConfig, dtype) -> jnp.ndarray:
    """Origin shifts ``[G, 2]`` for the overlap grids (half-cell shifts)."""
    h = grid.cell / 2.0
    if grid.overlap == 1:
        offs = [(0.0, 0.0)]
    elif grid.overlap == 4:
        offs = [(0.0, 0.0), (h, 0.0), (0.0, h), (h, h)]
    else:
        raise ValueError(f"overlap must be 1 or 4, got {grid.overlap}")
    return jnp.asarray(offs, dtype=dtype)


def cell_ids(points: jax.Array, grid: GridConfig):
    """Cell indices for each point in each overlap grid.

    points: ``[..., N, 2]`` world-frame points.
    Returns ``(ids, inb)``: ids ``[..., G, N]`` int32 flat cell index
    (clipped into range), inb ``[..., G, N]`` bool in-bounds mask.
    """
    dtype = points.dtype
    offs = _grid_offsets(grid, dtype)  # [G, 2]
    origin = jnp.asarray([grid.x0, grid.y0], dtype=dtype)
    # [..., 1, N, 2] - [G, 1, 2] -> [..., G, N, 2]
    rel = (points[..., None, :, :] - origin - offs[:, None, :]) / jnp.asarray(
        grid.cell, dtype
    )
    ix = jnp.floor(rel[..., 0]).astype(jnp.int32)
    iy = jnp.floor(rel[..., 1]).astype(jnp.int32)
    inb = (ix >= 0) & (ix < grid.nx) & (iy >= 0) & (iy < grid.ny)
    ix = jnp.clip(ix, 0, grid.nx - 1)
    iy = jnp.clip(iy, 0, grid.ny - 1)
    return iy * grid.nx + ix, inb


def empty_stats(grid: GridConfig, dtype=jnp.float32) -> NDTStats:
    g, c = grid.overlap, grid.n_cells
    return NDTStats(
        n=jnp.zeros((g, c), dtype),
        s=jnp.zeros((g, c, 2), dtype),
        ss=jnp.zeros((g, c, 2, 2), dtype),
    )


def add_points(stats: NDTStats, points: jax.Array, mask: jax.Array,
               grid: GridConfig, weight=1.0) -> NDTStats:
    """Accumulate masked points ``[N, 2]`` into the map statistics.

    One ``segment_sum`` over ``G*N`` slots into ``G*C`` segments replaces the
    reference's sequential per-point cell update (SURVEY.md §4.4); XLA sorts
    and coalesces the scatter.

    ``weight=-1.0`` SUBTRACTS the points' contribution: because the stats
    are plain sums and the transform/product pipeline is deterministic,
    re-computing a scan's contribution at the same pose yields bitwise the
    values originally added, so subtract-then-re-add moves a scan to a new
    pose up to one f32 rounding residue per touched cell (the incremental
    map-refresh path squashes residue with a periodic full rebuild).

    ``weight`` may also be a per-point ``[N]`` array: the map-refresh path
    concatenates subtract-at-old-pose (-1) and add-at-new-pose (+1) point
    sets into ONE call — the scatter row count is unchanged but the
    fixed per-call cost (the dense half-cell pooling at overlap=4, one
    full-lattice pass) is paid once instead of twice.
    """
    g, c = grid.overlap, grid.n_cells
    if g == 4:
        return _add_points_halfcell(stats, points, mask, grid, weight)
    ids, inb = cell_ids(points, grid)                # [G, N]
    w = ((mask[None, :] & inb).astype(points.dtype)   # [G, N]
         * jnp.asarray(weight, points.dtype))
    seg = (ids + jnp.arange(g, dtype=jnp.int32)[:, None] * c).reshape(-1)
    wp = (w[..., None] * points[None, :, :]).reshape(-1, 2)          # [G*N, 2]
    outer = points[:, :, None] * points[:, None, :]                  # [N, 2, 2]
    wpp = (w[..., None, None] * outer[None]).reshape(-1, 2, 2)       # [G*N, 2, 2]
    dn = jax.ops.segment_sum(w.reshape(-1), seg, num_segments=g * c)
    ds = jax.ops.segment_sum(wp, seg, num_segments=g * c)
    dss = jax.ops.segment_sum(wpp, seg, num_segments=g * c)
    return NDTStats(
        n=stats.n + dn.reshape(g, c),
        s=stats.s + ds.reshape(g, c, 2),
        ss=stats.ss + dss.reshape(g, c, 2, 2),
    )


def _add_points_halfcell(stats: NDTStats, points, mask, grid: GridConfig,
                         weight) -> NDTStats:
    """overlap=4 accumulation via ONE half-cell scatter + dense 2x2 pooling.

    The 4 overlap grids are shifted by half-cell offsets, so a cell of grid
    ``(gx, gy)`` is exactly the 2x2 block of half-cells starting at
    ``(2i+gx, 2j+gy)`` on the ``(2ny+1, 2nx+1)`` half-cell lattice — the
    same derivation :func:`pack_quad` uses for lookup. Scattering the 7
    moment values once at half-cell resolution and pooling densely replaces
    4 per-grid scatters: 4x fewer scattered rows, while the pooling is
    cheap dense elementwise work. Consistency bonus: the builder now
    assigns boundary points by the identical half-cell floor the matcher's
    quad lookup uses.
    """
    dt = points.dtype
    wh, hh = 2 * grid.nx + 1, 2 * grid.ny + 1
    inv = jnp.asarray(2.0 / grid.cell, dt)
    fx = jnp.floor((points[:, 0] - grid.x0) * inv)
    fy = jnp.floor((points[:, 1] - grid.y0) * inv)
    inb = (fx >= 0) & (fx < wh) & (fy >= 0) & (fy < hh)
    w = ((mask & inb).astype(dt) * jnp.asarray(weight, dt))          # [N]
    fid = jnp.clip((fy * wh + fx).astype(jnp.int32), 0, wh * hh - 1)
    px, py = points[:, 0], points[:, 1]
    vals = jnp.stack([w, w * px, w * py,
                      w * px * px, w * px * py, w * py * py], axis=-1)
    fine = jax.ops.segment_sum(vals, fid, num_segments=wh * hh)
    fine = fine.reshape(hh, wh, 6)

    shifts = ((0, 0), (1, 0), (0, 1), (1, 1))   # (gx, gy) per _grid_offsets
    pooled = []
    for gx, gy in shifts:
        blk = fine[gy: gy + 2 * grid.ny, gx: gx + 2 * grid.nx]
        pooled.append(blk.reshape(grid.ny, 2, grid.nx, 2, 6).sum(axis=(1, 3))
                      .reshape(grid.n_cells, 6))
    p = jnp.stack(pooled)                                           # [4, C, 6]
    dss = jnp.stack([p[..., 3], p[..., 4], p[..., 4], p[..., 5]],
                    axis=-1).reshape(4, grid.n_cells, 2, 2)
    return NDTStats(
        n=stats.n + p[..., 0],
        s=stats.s + p[..., 1:3],
        ss=stats.ss + dss,
    )


def build_stats(points: jax.Array, mask: jax.Array, grid: GridConfig) -> NDTStats:
    """Build statistics from scratch for a point set ``[N, 2]``."""
    return add_points(empty_stats(grid, points.dtype), points, mask, grid)


def _eig2x2_sym(a, b, c):
    """Closed-form eigendecomposition of symmetric [[a, b], [b, c]].

    Returns ``(l1, l2, v1)`` with ``l1 >= l2`` and ``v1`` ``[..., 2]`` the
    unit eigenvector of ``l1``. Fully branch-free (where-selects) so it
    vmaps/jits over all cells at once — the batched replacement for Eigen's
    ``SelfAdjointEigenSolver`` per cell (SURVEY.md §3.2 'Dense linear
    algebra').
    """
    half_tr = 0.5 * (a + c)
    d = jnp.sqrt(jnp.maximum(0.25 * (a - c) ** 2 + b * b, 0.0))
    l1, l2 = half_tr + d, half_tr - d
    # Eigenvector of l1: [b, l1-a] unless b ~ 0, then an axis vector.
    b_small = jnp.abs(b) <= 1e-20
    vx = jnp.where(b_small, jnp.where(a >= c, 1.0, 0.0), b)
    vy = jnp.where(b_small, jnp.where(a >= c, 0.0, 1.0), l1 - a)
    nrm = jnp.sqrt(vx * vx + vy * vy)
    nrm = jnp.where(nrm <= 1e-30, 1.0, nrm)
    return l1, l2, jnp.stack([vx / nrm, vy / nrm], axis=-1)


def finalize(stats: NDTStats, cfg: NDTMapConfig) -> NDTMap:
    """Derive the Gaussian view: mean, regularized inverse covariance, mask.

    Covariance eigenvalues are clamped from below at
    ``max(eig_abs_min, eig_ratio * lambda_max)`` (Magnusson 2009) which keeps
    the inverse well-conditioned in f32 — SURVEY.md §8 hard part #3.
    """
    n = stats.n
    safe_n = jnp.maximum(n, 1.0)
    mean = stats.s / safe_n[..., None]                             # [G, C, 2]
    cov = stats.ss / safe_n[..., None, None] - mean[..., :, None] * mean[..., None, :]
    a, b, c = cov[..., 0, 0], cov[..., 0, 1], cov[..., 1, 1]
    l1, l2, v1 = _eig2x2_sym(a, b, c)
    lmax = jnp.maximum(l1, cfg.eig_abs_min)
    lmin = jnp.maximum(l2, jnp.maximum(cfg.eig_ratio * lmax, cfg.eig_abs_min))
    # icov = V diag(1/l) V^T with V = [v1, v2], v2 = perp(v1).
    v2 = jnp.stack([-v1[..., 1], v1[..., 0]], axis=-1)
    icov = (
        v1[..., :, None] * v1[..., None, :] / lmax[..., None, None]
        + v2[..., :, None] * v2[..., None, :] / lmin[..., None, None]
    )
    valid = (n >= cfg.min_pts).astype(mean.dtype)
    return NDTMap(mean=mean, icov=icov, valid=valid)


def pack_map(ndt_map: NDTMap) -> jax.Array:
    """Pack the Gaussian view into one gather-friendly table ``[G, C, 8]``.

    Layout per cell: ``[mu_x, mu_y, icov_00, icov_01, icov_11, valid, 0, 0]``
    (icov is symmetric — 3 unique entries). One 32-byte row per cell turns
    the matcher's three separate gathers (mean/icov/valid) into a single
    coalesced one; done once per match call, amortized over all LM
    iterations (the map is fixed while the pose iterates).
    """
    mean, icov, valid = ndt_map.mean, ndt_map.icov, ndt_map.valid
    zeros = jnp.zeros_like(valid)
    return jnp.stack(
        [mean[..., 0], mean[..., 1], icov[..., 0, 0], icov[..., 0, 1],
         icov[..., 1, 1], valid, zeros, zeros], axis=-1)


def lookup_packed(packed: jax.Array, points: jax.Array, grid: GridConfig):
    """Gather per-point Gaussians from a packed table (see :func:`pack_map`).

    Returns the same ``(mean, icov, w)`` triple as :func:`lookup`.
    """
    ids, inb = cell_ids(points, grid)                    # [G, N]
    rows = jnp.take_along_axis(packed, ids[..., None], axis=1)   # [G, N, 8]
    mean = rows[..., 0:2]
    icov = jnp.stack(
        [jnp.stack([rows[..., 2], rows[..., 3]], axis=-1),
         jnp.stack([rows[..., 3], rows[..., 4]], axis=-1)], axis=-2)
    w = rows[..., 5] * inb.astype(points.dtype)
    return mean, icov, w


def lookup(ndt_map: NDTMap, points: jax.Array, grid: GridConfig):
    """Gather per-point Gaussians from every overlap grid.

    points: ``[N, 2]`` world-frame. Returns ``(mean [G,N,2], icov [G,N,2,2],
    w [G,N])`` where ``w`` is 1.0 for in-bounds points landing in valid cells.
    This is the hot gather of the registration inner loop (SURVEY.md §4.2).
    """
    ids, inb = cell_ids(points, grid)          # [G, N]
    take = jnp.take_along_axis
    mean = take(ndt_map.mean, ids[..., None], axis=1)
    icov = take(
        ndt_map.icov.reshape(grid.overlap, grid.n_cells, 4), ids[..., None], axis=1
    ).reshape(ids.shape + (2, 2))
    valid = take(ndt_map.valid, ids, axis=1)
    return mean, icov, valid * inb.astype(points.dtype)


def _quad_lattice(grid: GridConfig):
    """Static half-cell lattice dims ``(wh, hh)`` for the quad table.

    overlap=4: a ``(2nx+1) x (2ny+1)`` half-cell lattice (the +1 preserves
    the half-cell margin where a point past the base grid's max edge still
    falls inside the shifted grids). overlap=1: the cell lattice itself.
    """
    if grid.overlap == 4:
        return 2 * grid.nx + 1, 2 * grid.ny + 1
    return grid.nx, grid.ny


def _pack_bf16_pair(a, b):
    """Pack two arrays as a bf16 pair inside one f32 lane (a = low bits)."""
    ua = jax.lax.bitcast_convert_type(a.astype(jnp.bfloat16),
                                      jnp.uint16).astype(jnp.uint32)
    ub = jax.lax.bitcast_convert_type(b.astype(jnp.bfloat16),
                                      jnp.uint16).astype(jnp.uint32)
    return jax.lax.bitcast_convert_type((ub << 16) | ua, jnp.float32)


def unpack_bf16_pair(lane, dtype=jnp.float32):
    """Invert :func:`_pack_bf16_pair` with pure elementwise integer ops
    (no minor dims — the hot unpack stays elementwise)."""
    # An f64 lane (x64 oracle path) is an exactly-promoted f32: demote first.
    u = jax.lax.bitcast_convert_type(lane.astype(jnp.float32), jnp.uint32)
    a = jax.lax.bitcast_convert_type(u << 16, jnp.float32)
    b = jax.lax.bitcast_convert_type(u & jnp.uint32(0xFFFF0000), jnp.float32)
    return a.astype(dtype), b.astype(dtype)


def pack_quad(ndt_map: NDTMap, grid: GridConfig, compact: bool = False) -> jax.Array:
    """Pack the Gaussian view into a half-cell quad table
    ``[(2ny+1)*(2nx+1), G*8]`` (overlap=4) or ``[ny*nx, 8]`` (overlap=1).

    Row layout per overlap grid g: ``[mu_x, mu_y, icov_00, icov_01, icov_11,
    valid, 0, 0]``. One row holds the Gaussians of ALL overlap grids for a
    half-cell, so the matcher's hot loop performs ONE gather per point
    instead of one per (grid, point) — 4x fewer gather indices, and the
    gather's index array has no G extent (one contiguous row per point).

    Derivation: with half-cell size ``h = cell/2`` and half-cell index
    ``hx = floor((x - x0)/h)``, the cell of overlap grid g (origin shift
    ``gx*h``) is ``(hx - gx) >> 1`` — so the per-grid lookup is a function
    of the half-cell index alone and can be precomputed here, once per map,
    amortized over all LM iterations and scans.
    """
    mean, icov, valid = ndt_map.mean, ndt_map.icov, ndt_map.valid
    dt = mean.dtype
    g_dim = valid.shape[0]
    if compact:
        # 4 lanes per grid (a 64 B row instead of 128 B): mu keeps full
        # f32 precision; the icov entries and the
        # valid flag ride as bf16 pairs packed into f32 lanes (~0.4%
        # relative icov error — immaterial next to the eig regularization).
        comp = jnp.stack(
            [mean[..., 0], mean[..., 1],
             _pack_bf16_pair(icov[..., 0, 0], icov[..., 0, 1]),
             _pack_bf16_pair(icov[..., 1, 1], valid)], axis=-1)
        width = 4
    else:
        zeros = jnp.zeros_like(valid)
        comp = jnp.stack(
            [mean[..., 0], mean[..., 1], icov[..., 0, 0], icov[..., 0, 1],
             icov[..., 1, 1], valid, zeros, zeros], axis=-1)   # [G, C, 8]
        width = 8
    comp = comp.reshape(g_dim, grid.ny, grid.nx, width)

    if grid.overlap == 1:
        return comp[0].reshape(grid.n_cells, width)

    wh, hh = _quad_lattice(grid)
    shifts = ((0, 0), (1, 0), (0, 1), (1, 1))  # (gx, gy) per _grid_offsets
    blocks = []
    for g, (gx, gy) in enumerate(shifts):
        up = jnp.repeat(jnp.repeat(comp[g], 2, axis=0), 2, axis=1)
        # up[hy, hx] = comp[g, hy >> 1, hx >> 1]; grid g needs
        # comp[g, (hy-gy) >> 1, (hx-gx) >> 1] on the (2ny+1, 2nx+1) lattice:
        # pad gy rows / gx cols in front (those lattice slots fall outside
        # grid g -> all-zero row, valid=0) and 1-gy / 1-gx at the back.
        up = jnp.pad(up, ((gy, 1 - gy), (gx, 1 - gx), (0, 0)))
        blocks.append(up)
    table = jnp.concatenate(blocks, axis=-1)           # [hh, wh, width*G]
    return table.reshape(hh * wh, width * g_dim)


def lookup_quad(table: jax.Array, x: jax.Array, y: jax.Array,
                grid: GridConfig):
    """Gather quad-table rows for world points given as separate ``x``/``y``
    component arrays (any matching shape).

    Returns ``(rows [..., G*8], inb [...])``. Keeping x/y as planes (rather
    than a stacked ``[..., 2]``) lets XLA fuse the whole index computation
    into the gather without layout churn on a minor dim of 2.
    """
    dt = x.dtype
    wh, hh = _quad_lattice(grid)
    inv = jnp.asarray((2.0 if grid.overlap == 4 else 1.0) / grid.cell, dt)
    hx = jnp.floor((x - grid.x0) * inv)
    hy = jnp.floor((y - grid.y0) * inv)
    inb = (hx >= 0) & (hx < wh) & (hy >= 0) & (hy < hh)
    # Combine in f32 (exact for lattices < 2^24 rows) -> ONE int cast+clip.
    fid = hy * wh + hx
    idx = jnp.clip(fid.astype(jnp.int32), 0, wh * hh - 1)
    return table[idx], inb


def lookup_quad_multi(tables: jax.Array, x: jax.Array, y: jax.Array,
                      grid: GridConfig):
    """Per-lane quad tables: each batch lane gathers rows from its OWN
    table — ``tables [B, R, L]``, ``x``/``y`` ``[B, N]`` ->
    ``(rows [B, N, L], inb [B, N])``.

    This is the loop-closure verification shape (every candidate keyframe
    has its own cached local table, :func:`ndtpu.loop.closure
    .build_local_table`): all candidates across all queries flatten into
    ONE batched LM program instead of a vmap of single-lane matches, which
    lets the two-phase straggler compaction work across the whole
    candidate set (VERDICT r4 missing #3 — the loop verify is the
    dominant config-3 window cost).

    The per-lane table is folded into the ROW axis (one flat ``[B*R, L]``
    table, index = lane * R + row) instead of a batched-gather
    (``take_along_axis``) formulation: the gather stays a plain row gather
    with no batching dimension (the two forms are not compared on the
    GPU).
    """
    dt = x.dtype
    b, r, l = tables.shape
    wh, hh = _quad_lattice(grid)
    inv = jnp.asarray((2.0 if grid.overlap == 4 else 1.0) / grid.cell, dt)
    hx = jnp.floor((x - grid.x0) * inv)
    hy = jnp.floor((y - grid.y0) * inv)
    inb = (hx >= 0) & (hx < wh) & (hy >= 0) & (hy < hh)
    fid = hy * wh + hx
    idx = jnp.clip(fid.astype(jnp.int32), 0, wh * hh - 1)
    lane = jnp.arange(b, dtype=jnp.int32).reshape((b,) + (1,) * (idx.ndim - 1))
    return tables.reshape(b * r, l)[idx + lane * r], inb


def lookup_quad_grouped(tables_flat: jax.Array, r: int, group: jax.Array,
                        x: jax.Array, y: jax.Array, grid: GridConfig):
    """Shared-per-group quad tables: lane ``b`` gathers from table
    ``group[b]`` — ``tables_flat [S*R, L]`` (``R = r`` rows per table),
    ``group [B]`` int32, ``x``/``y`` ``[B, N]`` ->
    ``(rows [B, N, L], inb [B, N])``.

    The stacked multi-session frontend shape: S session maps serve
    ``S*W`` registration lanes in ONE flat batched LM program (W lanes
    share each session's table), so the two-phase straggler compaction
    works across ALL sessions' lanes and the tables are never
    materialized per lane. Same flat row-fold as
    :func:`lookup_quad_multi` (a batched gather falls off the fast
    row-gather path); the only difference is the lane->table indirection.

    The caller flattens ``[S, R, L] -> [S*R, L]`` ONCE per LM call, so a
    reshape that lowers to a copy never runs inside the matcher's
    while_loop body.
    """
    dt = x.dtype
    wh, hh = _quad_lattice(grid)
    inv = jnp.asarray((2.0 if grid.overlap == 4 else 1.0) / grid.cell, dt)
    hx = jnp.floor((x - grid.x0) * inv)
    hy = jnp.floor((y - grid.y0) * inv)
    inb = (hx >= 0) & (hx < wh) & (hy >= 0) & (hy < hh)
    fid = hy * wh + hx
    idx = jnp.clip(fid.astype(jnp.int32), 0, wh * hh - 1)
    g = group.astype(jnp.int32).reshape(
        group.shape + (1,) * (idx.ndim - group.ndim))
    return tables_flat[idx + g * r], inb
