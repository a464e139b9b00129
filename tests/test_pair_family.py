"""The digenic (arity-2) pairwise MMSBM family.

The reference fits only trigenic triplets (SURVEY.md §1.1); the same Data S1
file also carries digenic rows, and the underlying method is the pairwise
MMSBM recommender, so the engine supports arity 2 end to end: loader, EM
(oracle parity, invariants), scoring, sharding, trainer, CLI.
"""

import json
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp

from trigenicinteractionpredictor_tpu.config import Config, DataConfig, TrainConfig
from trigenicinteractionpredictor_tpu.data.kuzmin import load_kuzmin_tsv
from trigenicinteractionpredictor_tpu.data.splits import train_test_split
from trigenicinteractionpredictor_tpu.data.synthetic import (
    sample_synthetic_dataset,
    write_kuzmin_like_tsv,
)
from trigenicinteractionpredictor_tpu.models.mmsbm import ModelState, init_state
from trigenicinteractionpredictor_tpu.ops.em import Batch, em_step, log_likelihood
from trigenicinteractionpredictor_tpu.ops.metrics import auc
from trigenicinteractionpredictor_tpu.ops.scoring import (
    predict_interaction,
    predict_proba,
)
from trigenicinteractionpredictor_tpu.parallel.mesh import make_mesh
from trigenicinteractionpredictor_tpu.parallel.sharded_em import (
    make_sharded_train_step,
    replicate,
    shard_batch,
    shard_ensemble,
)
from trigenicinteractionpredictor_tpu.train.trainer import fit

import oracle


def _pair_ds(n=400, g=20, k=3, r=2, seed=0):
    ds, theta, p = sample_synthetic_dataset(n, g, k, n_ratings=r, seed=seed, arity=2)
    assert ds.arity == 2 and ds.triplets.shape[1] == 2
    return ds, theta, p


def _state_from(theta, p):
    return ModelState(
        theta=jnp.asarray(theta, dtype=jnp.float32),
        p=jnp.asarray(p, dtype=jnp.float32),
    )


def _batch_from(ds):
    return Batch(
        triplets=jnp.asarray(ds.triplets),
        ratings=jnp.asarray(ds.ratings),
        weights=jnp.asarray(ds.weights),
    )


def test_pair_sweep_matches_oracle():
    ds, _, _ = _pair_ds(n=300, g=15, k=3, r=2, seed=1)
    theta0, p0 = oracle.init_params_pair(ds.n_genes, 3, 2, seed=7)
    degrees = ds.degrees()

    theta1, p1, ll = oracle.em_sweep_pair(
        theta0, p0, ds.triplets, ds.ratings, degrees
    )
    state = _state_from(theta0, p0)
    new_state, ll_j = em_step(state, _batch_from(ds), jnp.asarray(degrees))

    np.testing.assert_allclose(np.asarray(new_state.theta), theta1, atol=2e-5)
    np.testing.assert_allclose(np.asarray(new_state.p), p1, atol=2e-5)
    assert abs(float(ll_j) - ll) < 1e-2


def test_pair_multi_sweep_trajectory_matches_oracle():
    ds, _, _ = _pair_ds(n=500, g=25, k=2, r=2, seed=3)
    theta, p = oracle.init_params_pair(ds.n_genes, 2, 2, seed=11)
    degrees = ds.degrees()
    state = _state_from(theta, p)
    batch = _batch_from(ds)
    deg_j = jnp.asarray(degrees)

    lls = []
    for _ in range(10):
        theta, p, ll_o = oracle.em_sweep_pair(
            theta, p, ds.triplets, ds.ratings, degrees
        )
        state, ll_j = em_step(state, batch, deg_j)
        assert abs(float(ll_j) - ll_o) < 5e-3 * max(1.0, abs(ll_o) / 100.0)
        lls.append(ll_o)
    # EM monotonicity on the oracle trace and engine drift bound.
    assert (np.diff(lls) >= -1e-9).all()
    np.testing.assert_allclose(np.asarray(state.theta), theta, atol=5e-4)
    np.testing.assert_allclose(np.asarray(state.p), p, atol=5e-4)


def test_pair_log_likelihood_and_predict_match_oracle():
    ds, _, _ = _pair_ds(n=250, g=12, k=3, r=3, seed=5)
    theta, p = oracle.init_params_pair(ds.n_genes, 3, 3, seed=2)
    state = _state_from(theta, p)

    ll_o = oracle.log_likelihood_pair(theta, p, ds.triplets, ds.ratings)
    ll_j = float(log_likelihood(state, _batch_from(ds)))
    assert abs(ll_j - ll_o) < 1e-2

    probs_o = oracle.predict_proba_pair(theta, p, ds.triplets)
    probs_j = np.asarray(predict_proba(state, jnp.asarray(ds.triplets)))
    np.testing.assert_allclose(probs_j, probs_o, atol=1e-5)
    np.testing.assert_allclose(probs_j.sum(axis=1), 1.0, atol=1e-4)


def test_pair_invariants_simplex_and_monotone():
    ds, _, _ = _pair_ds(n=600, g=30, k=4, r=2, seed=9)
    deg = jnp.asarray(ds.degrees())
    batch = _batch_from(ds)
    state = init_state(jax.random.key(0), ds.n_genes, 4, 2, arity=2)
    assert state.arity == 2 and state.p.shape == (4, 4, 2)

    step = jax.jit(em_step)
    lls = []
    for _ in range(20):
        state, ll = step(state, batch, deg)
        lls.append(float(ll))
        theta = np.asarray(state.theta)
        p = np.asarray(state.p)
        np.testing.assert_allclose(theta.sum(axis=-1), 1.0, atol=1e-5)
        np.testing.assert_allclose(p.sum(axis=-1), 1.0, atol=1e-5)
        assert (theta >= -1e-7).all() and (p >= -1e-7).all()
    assert (np.diff(lls) >= -1e-3).all(), lls


def test_pair_sharded_step_matches_local():
    ds, _, _ = _pair_ds(n=512, g=24, k=3, r=2, seed=4)
    deg = jnp.asarray(ds.degrees())
    batch = _batch_from(ds)
    S = 4
    keys = jax.random.split(jax.random.key(0), S)
    states = jax.vmap(lambda k: init_state(k, ds.n_genes, 3, 2, arity=2))(keys)

    ref_states, ref_ll = jax.vmap(em_step, in_axes=(0, None, None))(
        states, batch, deg
    )

    mesh = make_mesh(data=4, ensemble=2)
    step = make_sharded_train_step(mesh)
    new_states, ll = step(
        shard_ensemble(mesh, states), shard_batch(mesh, batch), replicate(mesh, deg)
    )
    np.testing.assert_allclose(
        np.asarray(new_states.theta), np.asarray(ref_states.theta), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(new_states.p), np.asarray(ref_states.p), atol=1e-5
    )
    np.testing.assert_allclose(np.asarray(ll), np.asarray(ref_ll), rtol=1e-5)


def test_digenic_loader_roundtrip(tmp_path):
    path = str(tmp_path / "kuzmin_like.tsv")
    write_kuzmin_like_tsv(path, n_rows=300, n_genes=25, seed=6)

    tri = load_kuzmin_tsv(path, DataConfig(mutant_type="trigenic"))
    dig = load_kuzmin_tsv(path, DataConfig(mutant_type="digenic"))

    assert tri.arity == 3
    assert dig.arity == 2 and dig.n_rows > 0
    # The ho-delta control never appears as a pair member.
    assert "YDL227C" not in (dig.gene_names or [])


def test_pair_fit_recovers_signal():
    """End-to-end: trainer on a pair dataset beats chance on held-out AUC."""
    ds, theta_star, p_star = _pair_ds(n=4000, g=40, k=3, r=2, seed=12)
    train, test = train_test_split(ds, 0.2, seed=0)
    cfg = Config(
        train=TrainConfig(k=3, sweeps=300, samples=4, likelihood_freq=50, seed=1)
    )
    result = fit(cfg, train)
    assert result.states.p.shape == (4, 3, 3, 2)

    tt = jnp.asarray(test.triplets)
    labels = jnp.asarray(test.ratings)
    best = result.best_state()
    fit_auc = float(
        auc(predict_interaction(_state_from(best.theta, best.p), tt), labels)
    )
    bayes_auc = float(
        auc(predict_interaction(_state_from(theta_star, p_star), tt), labels)
    )
    assert fit_auc > 0.5 + 0.6 * (bayes_auc - 0.5), (fit_auc, bayes_auc)


def test_cli_digenic_fit(tmp_path):
    tsv = str(tmp_path / "data.tsv")
    write_kuzmin_like_tsv(tsv, n_rows=400, n_genes=20, seed=2)
    out = str(tmp_path / "run")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [
            sys.executable, "-m", "trigenicinteractionpredictor_tpu", "fit",
            "-f", tsv, "-k", "2", "-i", "30", "-s", "2", "-n", "10",
            "--mutant-type", "digenic", "-o", out,
        ],
        capture_output=True, text=True, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert np.isfinite(report["auc"])
    cfg = json.load(open(os.path.join(out, "config.json")))
    assert cfg["data"]["mutant_type"] == "digenic"
