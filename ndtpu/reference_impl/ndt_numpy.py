"""Single-thread NumPy NDT implementation — oracle and baseline proxy.

Two roles (SURVEY.md §5, §7):

1. **Correctness oracle**: a straightforward per-point, per-cell loopy
   implementation of NDT map building and registration, written the way the
   reference's single-thread C++ does it (SURVEY.md §4.2/§4.4 pseudocode).
   Tests compare the JAX tensor programs against this to f64 precision.
2. **Baseline proxy**: the reference binary cannot be built (empty checkout,
   SURVEY.md §0) and it publishes no numbers (BASELINE.md). The measurable
   stand-in for "single-thread C++ baseline" is :func:`match_vectorized` —
   the same algorithm with the per-scan inner loop vectorized over points
   through BLAS-backed numpy, which is the performance class of an
   Eigen-based C++ implementation (the pure-Python per-point loop in
   :func:`match` is an *oracle*, not a baseline — it is ~100x slower than
   compiled code and would flatter ``vs_baseline``).

Intentionally independent code: no imports from the JAX modules.
"""

from __future__ import annotations

import numpy as np

__all__ = ["NumpyNDTMap", "build_map", "match", "match_vectorized"]


class NumpyNDTMap:
    def __init__(self, x0, y0, cell, nx, ny, overlap=4, min_pts=3,
                 eig_ratio=1e-3, eig_abs_min=1e-4):
        self.x0, self.y0, self.cell = x0, y0, cell
        self.nx, self.ny, self.overlap = nx, ny, overlap
        self.min_pts, self.eig_ratio, self.eig_abs_min = (
            min_pts, eig_ratio, eig_abs_min)
        h = cell / 2.0
        self.offsets = [(0.0, 0.0)] if overlap == 1 else [
            (0.0, 0.0), (h, 0.0), (0.0, h), (h, h)]
        c = nx * ny
        g = len(self.offsets)
        self.n = np.zeros((g, c))
        self.s = np.zeros((g, c, 2))
        self.ss = np.zeros((g, c, 2, 2))
        self.mean = np.zeros((g, c, 2))
        self.icov = np.zeros((g, c, 2, 2))
        self.valid = np.zeros((g, c), bool)

    def cell_index(self, pt, g):
        ox, oy = self.offsets[g]
        ix = int(np.floor((pt[0] - self.x0 - ox) / self.cell))
        iy = int(np.floor((pt[1] - self.y0 - oy) / self.cell))
        if 0 <= ix < self.nx and 0 <= iy < self.ny:
            return iy * self.nx + ix
        return -1

    def add_points(self, points, mask):
        for p, m in zip(points, mask):      # the reference-style point loop
            if not m:
                continue
            for g in range(len(self.offsets)):
                c = self.cell_index(p, g)
                if c < 0:
                    continue
                self.n[g, c] += 1.0
                self.s[g, c] += p
                self.ss[g, c] += np.outer(p, p)

    def finalize(self):
        for g in range(len(self.offsets)):
            for c in range(self.nx * self.ny):
                if self.n[g, c] < self.min_pts:
                    self.valid[g, c] = False
                    continue
                n = self.n[g, c]
                mu = self.s[g, c] / n
                cov = self.ss[g, c] / n - np.outer(mu, mu)
                w, v = np.linalg.eigh(cov)
                lmax = max(w[1], self.eig_abs_min)
                lmin = max(w[0], max(self.eig_ratio * lmax, self.eig_abs_min))
                cov_r = (v @ np.diag([lmin, lmax]) @ v.T)
                self.mean[g, c] = mu
                self.icov[g, c] = np.linalg.inv(cov_r)
                self.valid[g, c] = True


def build_map(points, mask, x0, y0, cell, nx, ny, overlap=4, **kw):
    m = NumpyNDTMap(x0, y0, cell, nx, ny, overlap, **kw)
    m.add_points(np.asarray(points, float), np.asarray(mask, bool))
    m.finalize()
    return m


def _score_grad_hess(pose, points, mask, m: NumpyNDTMap, d2=0.5,
                     exp_clip=40.0):
    c, s = np.cos(pose[2]), np.sin(pose[2])
    r = np.array([[c, -s], [s, c]])
    f, g, h = 0.0, np.zeros(3), np.zeros((3, 3))
    wsum, w0sum = 0.0, 0.0
    for p, valid in zip(points, mask):       # reference-style per-point loop
        if not valid:
            continue
        xw = r @ p + pose[:2]
        dxdphi = np.array([-s * p[0] - c * p[1], c * p[0] - s * p[1]])
        for gi in range(len(m.offsets)):
            ci = m.cell_index(xw, gi)
            if ci < 0 or not m.valid[gi, ci]:
                continue
            w0sum += 1.0
            d = xw - m.mean[gi, ci]
            lam = m.icov[gi, ci]
            q = lam @ d
            l2 = float(d @ q)
            w = np.exp(-0.5 * d2 * min(max(l2, 0.0), exp_clip))
            jac = np.zeros((2, 3))
            jac[:, 0] = [1, 0]
            jac[:, 1] = [0, 1]
            jac[:, 2] = dxdphi
            a = jac.T @ q
            f -= w
            wsum += w
            g += d2 * w * a
            hpp = -(q @ (xw - pose[:2]))
            e33 = np.zeros((3, 3))
            e33[2, 2] = hpp
            h += d2 * w * (jac.T @ lam @ jac + e33 - d2 * np.outer(a, a))
    score = wsum / max(w0sum, 1.0)
    return f, g, h, score


def match(points, mask, m: NumpyNDTMap, init_pose, max_iter=30, tol=1e-4,
          init_lambda=1.0, lambda_up=10.0, lambda_down=3.0, max_lambda=1e6,
          step_clip=2.0, d2=0.5, reject_tol=3e-3):
    """Levenberg-Marquardt NDT registration, mirroring ndtpu.ndt.match
    (including its iteration controls: damped start, rejected-small-step
    stop — see MatchConfig)."""
    pose = np.asarray(init_pose, float).copy()
    f, g, h, score = _score_grad_hess(pose, points, mask, m, d2)
    lam = init_lambda
    it, converged = 0, False
    done = np.sum(np.abs(g)) == 0.0
    while it < max_iter and not done:
        diag = np.maximum(np.abs(np.diag(h)), 1e-6)
        aa = h + lam * np.diag(diag)
        delta = np.linalg.solve(aa, -g)
        tn = np.hypot(delta[0], delta[1])
        if tn > step_clip:
            delta *= step_clip / tn
        f2, g2, h2, s2 = _score_grad_hess(pose + delta, points, mask, m, d2)
        accept = f2 < f
        if accept:
            pose, f, g, h, score = pose + delta, f2, g2, h2, s2
            lam = max(lam / lambda_down, 1e-9)
        else:
            lam *= lambda_up
        dnorm = np.linalg.norm(delta)
        small = dnorm < tol or (not accept and dnorm < reject_tol)
        done = small or lam > max_lambda
        converged = small
        it += 1
    converged = converged and f < 0.0
    return pose, h, score, it, converged


def _score_grad_hess_vec(pose, points, mask, m: NumpyNDTMap, d2=0.5,
                         exp_clip=40.0):
    """Vectorized-over-points objective — the Eigen-class single-thread
    inner loop used as the baseline of record (one numpy op per line of the
    reference's per-point math; still one core, one scan at a time)."""
    c, s = np.cos(pose[2]), np.sin(pose[2])
    pts = points[mask]
    xw = np.stack([c * pts[:, 0] - s * pts[:, 1] + pose[0],
                   s * pts[:, 0] + c * pts[:, 1] + pose[1]], axis=-1)
    dxdphi = np.stack([-s * pts[:, 0] - c * pts[:, 1],
                       c * pts[:, 0] - s * pts[:, 1]], axis=-1)
    f, g, h = 0.0, np.zeros(3), np.zeros((3, 3))
    wsum, w0sum = 0.0, 0.0
    for gi, (ox, oy) in enumerate(m.offsets):
        ix = np.floor((xw[:, 0] - m.x0 - ox) / m.cell).astype(int)
        iy = np.floor((xw[:, 1] - m.y0 - oy) / m.cell).astype(int)
        inb = (ix >= 0) & (ix < m.nx) & (iy >= 0) & (iy < m.ny)
        ci = np.clip(iy, 0, m.ny - 1) * m.nx + np.clip(ix, 0, m.nx - 1)
        ok = inb & m.valid[gi, ci]
        if not np.any(ok):
            continue
        mu = m.mean[gi, ci[ok]]
        lam = m.icov[gi, ci[ok]]
        d = xw[ok] - mu
        q = np.einsum("nij,nj->ni", lam, d)
        l2 = np.sum(d * q, axis=-1)
        w = np.exp(-0.5 * d2 * np.clip(l2, 0.0, exp_clip))
        a = np.stack([q[:, 0], q[:, 1],
                      np.sum(q * dxdphi[ok], axis=-1)], axis=-1)   # [N,3]
        f -= w.sum()
        wsum += w.sum()
        w0sum += ok.sum()
        g += d2 * (w[:, None] * a).sum(0)
        ld = np.einsum("nij,nj->ni", lam, dxdphi[ok])
        j33 = np.sum(dxdphi[ok] * ld, axis=-1)
        hpp = -np.sum(q * (xw[ok] - pose[:2]), axis=-1)
        # accumulate J^T Lam J + e33*hpp - d2 a a^T, weighted by w
        h[0, 0] += np.sum(w * lam[:, 0, 0])
        h[0, 1] += np.sum(w * lam[:, 0, 1])
        h[1, 1] += np.sum(w * lam[:, 1, 1])
        h[0, 2] += np.sum(w * ld[:, 0])
        h[1, 2] += np.sum(w * ld[:, 1])
        h[2, 2] += np.sum(w * (j33 + hpp))
        h -= d2 * np.einsum("n,na,nb->ab", w, a, a)
    h[1, 0], h[2, 0], h[2, 1] = h[0, 1], h[0, 2], h[1, 2]
    h *= d2
    score = wsum / max(w0sum, 1.0)
    return f, g, h, score


def match_vectorized(points, mask, m: NumpyNDTMap, init_pose, max_iter=30,
                     tol=1e-4, init_lambda=1.0, lambda_up=10.0,
                     lambda_down=3.0, max_lambda=1e6, step_clip=2.0, d2=0.5,
                     reject_tol=3e-3):
    """LM registration with the vectorized objective (baseline of record).

    Iteration controls match MatchConfig exactly (same damped start, same
    rejected-small-step stop) so scans/s comparisons measure the per-
    iteration compute, not differing stopping rules."""
    pose = np.asarray(init_pose, float).copy()
    f, g, h, score = _score_grad_hess_vec(pose, points, mask, m, d2)
    lam = init_lambda
    it, converged = 0, False
    done = np.sum(np.abs(g)) == 0.0
    while it < max_iter and not done:
        diag = np.maximum(np.abs(np.diag(h)), 1e-6)
        aa = h + lam * np.diag(diag)
        delta = np.linalg.solve(aa, -g)
        tn = np.hypot(delta[0], delta[1])
        if tn > step_clip:
            delta *= step_clip / tn
        f2, g2, h2, s2 = _score_grad_hess_vec(pose + delta, points, mask, m,
                                              d2)
        accept = f2 < f
        if accept:
            pose, f, g, h, score = pose + delta, f2, g2, h2, s2
            lam = max(lam / lambda_down, 1e-9)
        else:
            lam *= lambda_up
        dnorm = np.linalg.norm(delta)
        small = dnorm < tol or (not accept and dnorm < reject_tol)
        done = small or lam > max_lambda
        converged = small
        it += 1
    return pose, h, score, it, converged and f < 0.0
