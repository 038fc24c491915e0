"""Process set-up: the compile-cache rule, the explicit solver precision,
and the multi-device dry run's refusal to switch platforms."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.extend import core as jex_core

from ndtpu import dist
from ndtpu.config import SolverConfig
from ndtpu.data import g2o
from ndtpu.graph import factors as fct
from ndtpu.graph import incremental as inc
from ndtpu.graph import solve as slv
from ndtpu.graph import supernodal as sn
from ndtpu.utils import runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cache_config():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_cache_dir_defaults_to_checkout(monkeypatch, cache_config):
    monkeypatch.delenv(runtime.CACHE_ENV, raising=False)
    path = runtime.enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_cache_env_is_left_to_jax(monkeypatch, cache_config, tmp_path):
    monkeypatch.setenv(runtime.CACHE_ENV, str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert runtime.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_env_run_writes_only_there(tmp_path):
    """A process that compiles with the env var set writes its cache into
    that directory and leaves the checkout's default directory alone (other
    test processes may write there meanwhile, so look for this program's
    entry by its function name)."""
    cache = tmp_path / "cache"
    code = ("from ndtpu.utils.runtime import enable_compile_cache\n"
            "enable_compile_cache()\n"
            "import jax, jax.numpy as jnp\n"
            "def cache_env_probe(x):\n"
            "    return jnp.sin(x) @ x\n"
            "jax.jit(cache_env_probe)(jnp.ones((64, 64))).block_until_ready()\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(cache),
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)
    assert any("cache_env_probe" in p.name for p in cache.iterdir())
    default = runtime.default_cache_dir()
    entries = os.listdir(default) if os.path.isdir(default) else []
    assert not any("cache_env_probe" in e for e in entries)


def test_dryrun_refuses_missing_devices():
    sys.path.insert(0, REPO)
    import __graft_entry__ as ge
    with pytest.raises(RuntimeError, match="needs 64 devices"):
        ge.dryrun_multichip(64)


# ------------------------------------------------- explicit matmul precision

def _dots(jaxpr):
    """Every dot_general equation in ``jaxpr`` and its sub-jaxprs."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn)
        for v in eqn.params.values():
            subs = v if isinstance(v, (tuple, list)) else (v,)
            for sub in subs:
                if isinstance(sub, jex_core.ClosedJaxpr):
                    out += _dots(sub.jaxpr)
                elif isinstance(sub, jex_core.Jaxpr):
                    out += _dots(sub)
    return out


def _graph():
    data = g2o.manhattan_world(60, seed=1, loop_prob=0.3)
    return g2o.to_graph(data, dtype=jnp.float32)


def _supernodal(g, lam):
    plan = sn.plan_supernodal(g, 4)
    return jax.make_jaxpr(lambda g_, l_: sn.supernodal_delta(
        g_, fct.linearize(g_), plan, l_))(g, lam)


def _schur(g, lam):
    plan = dist.plan_partition(
        np.asarray(g.bet_i), np.asarray(g.bet_j), np.asarray(g.bet_mask),
        np.asarray(g.prior_idx), np.asarray(g.prior_mask),
        int(g.poses.shape[0]), n_shards=4)
    mesh = dist.space_mesh(4)
    return jax.make_jaxpr(lambda g_, l_: dist.schur_delta(
        mesh, g_, plan, l_))(g, lam)


def _dense(g, lam):
    return jax.make_jaxpr(lambda g_, l_: slv.solve_dense(
        g_, fct.linearize(g_), l_))(g, lam)


def _pcg(g, lam):
    return jax.make_jaxpr(lambda g_, l_: slv.pcg(
        g_, fct.linearize(g_), l_, SolverConfig()))(g, lam)


def _incremental(g, lam):
    st = inc.SmootherState(graph=g, lam=lam,
                           last_max_delta=jnp.asarray(1.0, jnp.float32),
                           step=jnp.asarray(0, jnp.int32))
    cfg = SolverConfig(local_poses=32, local_factors=128)
    return jax.make_jaxpr(lambda s: inc.incremental_update(s, cfg))(st)


@pytest.mark.parametrize("trace", [_supernodal, _schur, _dense, _pcg,
                                   _incremental],
                         ids=["supernodal", "schur", "dense", "pcg",
                              "incremental"])
def test_solver_dots_are_highest_precision(trace):
    """On the GPU an f32 dot without a precision may run in TF32 (~3
    digits); every pose-graph solver contraction asks for HIGHEST."""
    jaxpr = trace(_graph(), jnp.asarray(1e-3, jnp.float32))
    dots = _dots(jaxpr.jaxpr)
    assert dots
    hi = jax.lax.Precision.HIGHEST
    for eqn in dots:
        prec = eqn.params["precision"]
        prec = prec if isinstance(prec, tuple) else (prec,)
        assert all(p == hi for p in prec), (prec, eqn)
