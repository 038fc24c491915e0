"""chip_smoke.py's four-card paths at toy sizes, on four of the virtual
CPU devices, each against its one-card reference."""

import jax
import pytest

import chip_smoke as cs
from ndtpu import dist
from test_chip_smoke import TOY_SERVE, _write


@pytest.fixture(scope="module")
def meshes():
    devs = jax.devices()[:4]
    return dist.batch_mesh(devices=devs), dist.space_mesh(devices=devs)


def test_multi_registration_toy(meshes):
    rec = cs.phase_multi_registration(*meshes, batch=64, n_beams=90, nx=32,
                                      n_slab=2)
    names = [c["name"] for c in rec["checks"]]
    assert "slab_build_psharded_count_err" in names


def test_multi_schur_toy(meshes):
    rec = cs.phase_multi_schur(meshes[1], n_poses=300, shards=4)
    assert rec["iters"] == rec["one_card_iters"]


def test_multi_sessions_toy(meshes, tmp_path):
    cfg = _write(tmp_path, "serve.json", TOY_SERVE)
    rec = cs.phase_multi_sessions(meshes[0], config=cfg, max_scans=40,
                                  ate_limit=0.3)
    assert rec["sessions"] == 4
