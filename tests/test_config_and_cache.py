"""Config compatibility with older checkpoints, the compile-cache helper,
and the integrity probe's comparison."""

import json
import os
import subprocess
import sys
import warnings

import jax
import numpy as np
import pytest

from trigenicinteractionpredictor_tpu.config import Config, EngineConfig
from trigenicinteractionpredictor_tpu.utils import compile_cache, integrity

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

OLD_ENGINE = {
    "backend": "pallas",
    "batch_pad_multiple": 256,
    "tile_b": 512,
    "jnp_row_chunk": 4096,
    "precision": "strict",
    "bdr_group": 5,
}


@pytest.mark.parametrize("key", ["backend", "tile_b", "precision", "bdr_group"])
def test_removed_engine_key_is_dropped(key):
    d = Config().to_dict()
    d["engine"][key] = OLD_ENGINE[key]
    cfg = Config.from_dict(d)
    assert cfg.engine == EngineConfig()


def test_old_engine_section_keeps_live_fields():
    d = Config().to_dict()
    d["engine"] = dict(OLD_ENGINE)
    eng = Config.from_json(json.dumps(d)).engine
    assert eng == EngineConfig(batch_pad_multiple=256, jnp_row_chunk=4096)


def test_checkpoint_with_old_engine_keys_loads_and_resumes(tmp_path):
    """A checkpoint whose config carries the removed engine keys still
    loads, parses, and resumes."""
    from trigenicinteractionpredictor_tpu.config import TrainConfig
    from trigenicinteractionpredictor_tpu.data.synthetic import (
        sample_synthetic_dataset,
    )
    from trigenicinteractionpredictor_tpu.train.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )
    from trigenicinteractionpredictor_tpu.train.trainer import fit

    ds, _, _ = sample_synthetic_dataset(512, 16, 2, seed=0)
    cfg = Config(train=TrainConfig(k=2, sweeps=4, samples=2, likelihood_freq=2))
    first = fit(cfg.replace(train=TrainConfig(k=2, sweeps=2, samples=2,
                                              likelihood_freq=2)), ds)
    old = cfg.to_dict()
    old["engine"] = dict(OLD_ENGINE)
    ck = str(tmp_path / "old.ckpt.npz")
    save_checkpoint(ck, first.states, 2, first.ll_trace,
                    config_json=json.dumps(old))
    loaded = load_checkpoint(ck)
    assert Config.from_json(loaded["config_json"]).engine.jnp_row_chunk == 4096
    res = fit(cfg, ds, resume=ck)
    assert res.sweeps_run == 4 and np.isfinite(res.final_loglik).all()


def test_default_cache_dir_is_in_the_repo():
    assert compile_cache.default_cache_dir() == os.path.join(REPO, ".jax_cache")


def test_cache_dir_set_when_env_unset(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        got = compile_cache.enable_compile_cache()
        assert got == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_env_var_wins_and_nothing_is_set(monkeypatch, tmp_path):
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_cli_process_uses_the_cache_dir(tmp_path, env_dir):
    """A fresh process: with the variable set, JAX's own setting is the
    variable; without it, the CLI's helper points JAX at <repo>/.jax_cache."""
    code = (
        "import jax\n"
        "from trigenicinteractionpredictor_tpu.utils.compile_cache import "
        "enable_compile_cache\n"
        "enable_compile_cache()\n"
        "print(jax.config.jax_compilation_cache_dir)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    env.pop(compile_cache.ENV_VAR, None)
    want = os.path.join(REPO, ".jax_cache")
    if env_dir:
        want = str(tmp_path / env_dir)
        env[compile_cache.ENV_VAR] = want
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == want


def test_integrity_probe_runs_on_cpu_and_agrees():
    integrity._probe_result.cache_clear()
    assert integrity._probe_result("cpu", 2048, 64, 4, 2, 3) is True
    assert integrity._probe_result("cpu", 2048, 64, 4, 2, 2) is True


def test_integrity_check_flags_a_mismatch():
    good = [np.ones((4, 3)), np.ones((3, 3, 3, 2)), np.asarray(-10.0)]
    near = [g * (1 + integrity._TOL / 10) for g in good]
    assert integrity._check("near", near, good)
    off = [good[0] / 100, good[1], good[2]]     # the ~100x miscompile
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert not integrity._check("off", off, good)
    assert any("theta_hat" in str(x.message) for x in w)
