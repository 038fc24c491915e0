"""chip_smoke.py at toy sizes on CPU: the GPU guard and every one-card
phase with its comparison and limit logic (the four-card paths are in
test_chip_smoke_multi.py)."""

import json
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke as cs
from ndtpu.config import SolverConfig
from ndtpu.data import g2o
from ndtpu.graph import solve as slv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Small windowed-SLAM config: the synthetic CLI sequence's corridor world
# (+-18 m) on a 1 m grid, 90 beams.
TOY_SLAM = {
    "grid": {"x0": -20.0, "y0": -20.0, "cell": 1.0, "nx": 40, "ny": 40,
             "overlap": 4},
    "keyframe": {"dist_thresh": 0.6, "angle_thresh": 0.3, "capacity": 256},
    "loop": {"radius": 5.0, "min_index_gap": 25, "max_candidates": 4,
             "local_half_extent": 8.0},
    "solver": {"inc_iters": 1, "pcg_max_iter": 30},
    "use_loop_closure": True,
    "n_beams": 90,
}
# Serving-shaped config at a small grid and beam count.
TOY_SERVE = {
    "grid": {"x0": -14.0, "y0": -14.0, "cell": 0.5, "nx": 56, "ny": 56,
             "overlap": 4},
    "keyframe": {"capacity": 64},
    "loop": {"max_candidates": 4, "local_half_extent": 6.0,
             "min_index_gap": 8},
    "solver": {"inc_iters": 1, "pcg_max_iter": 30},
    "use_loop_closure": True,
    "n_beams": 120,
}


def _write(tmp_path, name, cfg):
    path = tmp_path / name
    path.write_text(json.dumps(cfg))
    return str(path)


def _dense_optimum(n_poses):
    data = cs.manhattan_graph_data(n_poses)
    g = g2o.to_graph(data, dtype=jnp.float64)
    res = slv.optimize(g, SolverConfig(max_iter=100, tol=1e-12),
                       method="dense")
    return cs.chi2_f64(data, res.graph.poses)


def test_main_exits_without_gpu():
    with pytest.raises(SystemExit) as e:
        cs.main([])
    assert "no GPU" in str(e.value.code)


def _run_script(script_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=script_dir,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_script_fails_on_cpu_and_prints_no_result():
    out = _run_script(REPO)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no GPU" in out.stderr


def test_script_alone_fails_and_prints_no_result(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run_script(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_report_raises_on_a_broken_limit(capsys):
    rec = {"phase": "x", "checks": [cs.check("a", 1, 2, True),
                                    cs.check("b", 3, 2, False)]}
    with pytest.raises(cs.PhaseFailed, match="b"):
        cs.report(rec)
    assert json.loads(capsys.readouterr().out)["phase"] == "x"


def test_compare_poses_limits():
    ref = np.zeros((3, 3))
    conv = np.ones(3, bool)
    xy, th = cs.MATCH_XY_LIMIT_M, cs.MATCH_TH_LIMIT_RAD
    ok = cs.compare_poses("t", ref + [0.6 * xy, 0, 0.5 * th], conv, ref, conv)
    assert all(c["ok"] for c in ok)
    far = cs.compare_poses("t", ref + [1.5 * xy, 0, 0], conv, ref, conv)
    assert [c["ok"] for c in far] == [True, False, True]
    flip = cs.compare_poses("t", ref, np.array([True, False, True]), ref,
                            conv)
    assert [c["ok"] for c in flip] == [False, True, True]
    # A scan that neither side converged does not enter the pose limits.
    wild = cs.compare_poses("t", ref + [[9.0, 0, 0], [0, 0, 0], [0, 0, 0]],
                            np.array([False, True, True]), ref,
                            np.array([False, True, True]))
    assert all(c["ok"] for c in wild)
    # Headings either side of +-pi are 2 mrad apart, not 2 pi.
    assert cs.pose_diff([[3.0, 4.0, np.pi - 1e-3]],
                        [[0.0, 0.0, -np.pi + 1e-3]]) == pytest.approx(
                            (5.0, 2e-3))


def test_compare_map_build_limits():
    grid, stats, map_points, *_ = cs.matcher_scene(4, 90, 32)
    m64 = cs.oracle_map(grid, map_points, cs.NDTMapConfig())
    assert all(c["ok"] for c in cs.compare_map_build(grid, stats, map_points,
                                                     m64))
    # A point the device lost, and a cell sum off by 1 mm per point.
    g, c = np.argwhere(m64.n >= 5)[0]
    lost = stats._replace(n=stats.n.at[g, c].add(-1.0))
    assert [x["ok"] for x in cs.compare_map_build(
        grid, lost, map_points, m64)] == [False, True, True, True]
    off = stats._replace(s=stats.s.at[g, c].add(float(1e-3 * m64.n[g, c])))
    assert [x["ok"] for x in cs.compare_map_build(
        grid, off, map_points, m64)] == [True, True, False, True]
    # A point on an x border lies on the borders of the two overlap grids
    # that are not shifted in x; a point off every border counts nowhere.
    pts = np.array([[grid.x0 + 3 * grid.cell, 0.3], [0.1, 0.3]])
    assert cs.border_points(grid, (pts, np.ones(2, bool))) == 2


def test_phase_matcher_toy():
    # B=160 > phase2_width=128: the two-phase straggler path runs.
    rec = cs.phase_matcher(batch=160, n_beams=90, nx=32, n_ref=6, reps=1)
    assert all(c["ok"] for c in rec["checks"])


def test_phase_slam_and_repeat_toy(tmp_path):
    # The corridor loop first closes near scan 480, so 520 scans is the
    # shortest run with loops; its ATE (~1.1 m) is that of a fresh closure.
    cfg = _write(tmp_path, "slam.json", TOY_SLAM)
    rec, traj = cs.phase_slam(config=cfg, max_scans=520, ate_limit=1.5,
                              reps=1)
    assert traj.shape == (520, 3)
    rep = cs.phase_repeat(traj, config=cfg, max_scans=520, ate_limit=1.5)
    # On the CPU the scatter order is fixed.
    assert rep["bit_identical"] and rep["max_dxy_m"] == 0.0


def test_phase_slam_fails_without_loops(tmp_path):
    cfg = _write(tmp_path, "slam.json", dict(TOY_SLAM,
                                             use_loop_closure=False))
    with pytest.raises(cs.PhaseFailed, match="loops"):
        cs.phase_slam(config=cfg, max_scans=24, ate_limit=1.0, reps=0)


def test_phase_serve_toy(tmp_path):
    cfg = _write(tmp_path, "serve.json", TOY_SERVE)
    rec = cs.phase_serve(config=cfg, sessions=2, max_scans=40,
                         ate_limit=0.3)
    assert len(rec["session_ate_m"]) == 2


def test_phase_ba_toy():
    # At 200 poses the f32 supernodal solve reaches the f64 optimum, so
    # both references are that optimum.
    optimum = _dense_optimum(200)
    rec = cs.phase_ba(n_poses=200, cpu_f32=optimum, f64_ref=optimum, reps=0,
                      shards=4)
    chi = rec["checks"][0]["value"]
    assert optimum <= chi * (1 + 1e-6)
    with pytest.raises(cs.PhaseFailed, match="chi2_f64_vs_cpu_f32"):
        cs.phase_ba(n_poses=200, cpu_f32=0.5 * optimum, f64_ref=optimum,
                    reps=0, shards=4)
