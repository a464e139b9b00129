"""Tensor-parallel (model-axis) EM step vs the replicated reference.

SURVEY.md §3.3 marks TP optional, for the large-K regime only; correctness
is validated on the 8-virtual-device CPU mesh: sharding p over ``model``
must reproduce the replicated em_step bit-for-bit up to f32 tolerance, for
every (model, data) mesh split.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from trigenicinteractionpredictor_tpu.data.synthetic import sample_synthetic_dataset
from trigenicinteractionpredictor_tpu.models.mmsbm import init_state
from trigenicinteractionpredictor_tpu.ops.em import Batch, em_step
from trigenicinteractionpredictor_tpu.parallel.tensor_parallel import (
    make_tp_mesh,
    make_tp_train_step,
    replicate_tp,
    shard_tp_batch,
    shard_tp_state,
)


def _setup(n=512, g=24, k=4, r=2, seed=0):
    ds, _, _ = sample_synthetic_dataset(n, g, k, n_ratings=r, seed=seed)
    batch = Batch(
        triplets=jnp.asarray(ds.triplets),
        ratings=jnp.asarray(ds.ratings),
        weights=jnp.asarray(ds.weights),
    )
    return ds, batch


@pytest.mark.parametrize("model,data", [(2, 1), (4, 1), (2, 4), (4, 2), (8, 1)])
def test_tp_step_matches_replicated(model, data):
    k = 8  # Kb = k / model must be whole for every mesh split above
    ds, batch = _setup(n=512, g=24, k=k, seed=model * 10 + data)
    deg = jnp.asarray(ds.degrees())
    S = 2
    keys = jax.random.split(jax.random.key(3), S)
    states = jax.vmap(lambda kk: init_state(kk, ds.n_genes, k, 2))(keys)

    ref_states, ref_ll = jax.vmap(em_step, in_axes=(0, None, None))(
        states, batch, deg
    )

    mesh = make_tp_mesh(model=model, data=data)
    step = make_tp_train_step(mesh)
    new_states, ll = step(
        shard_tp_state(mesh, states),
        shard_tp_batch(mesh, batch),
        replicate_tp(mesh, deg),
    )

    np.testing.assert_allclose(np.asarray(ll), np.asarray(ref_ll), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(new_states.theta), np.asarray(ref_states.theta), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(new_states.p), np.asarray(ref_states.p), atol=1e-5
    )


def test_tp_through_trainer_matches_replicated_large_k():
    """`fit` with mesh.model=2 (TP x EP x DP mesh) == replicated fit at
    large K — the regime TP exists for."""
    from trigenicinteractionpredictor_tpu.config import (
        Config,
        EngineConfig,
        MeshConfig,
        TrainConfig,
    )
    from trigenicinteractionpredictor_tpu.train.trainer import fit

    k = 48  # >= SERIAL_RESTART_K so the TP path also exercises lax.map
    ds, _, _ = sample_synthetic_dataset(512, 30, 6, n_ratings=2, seed=9)
    tcfg = TrainConfig(k=k, sweeps=4, samples=2, likelihood_freq=2, seed=1)
    cfg_tp = Config(
        train=tcfg,
        mesh=MeshConfig(data=2, ensemble=2, model=2),
        engine=EngineConfig(),
    )
    cfg_rep = Config(
        train=tcfg,
        mesh=MeshConfig(data=4, ensemble=2),
        engine=EngineConfig(),
    )
    r_tp = fit(cfg_tp, ds)
    r_rep = fit(cfg_rep, ds)
    np.testing.assert_allclose(
        r_tp.final_loglik, r_rep.final_loglik, rtol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(r_tp.states.theta),
        np.asarray(r_rep.states.theta),
        atol=2e-5,
    )
    np.testing.assert_allclose(
        np.asarray(r_tp.states.p), np.asarray(r_rep.states.p), atol=2e-5
    )


def test_tp_anneal_matches_replicated_anneal():
    """The DAEM beta schedule must commute with the l-axis sharding."""
    from trigenicinteractionpredictor_tpu.config import (
        Config,
        EngineConfig,
        MeshConfig,
        TrainConfig,
    )
    from trigenicinteractionpredictor_tpu.train.trainer import fit

    ds, _, _ = sample_synthetic_dataset(512, 24, 4, n_ratings=2, seed=3)
    tcfg = TrainConfig(
        k=8, sweeps=6, samples=2, likelihood_freq=3, seed=0,
        anneal_beta0=0.4, anneal_sweeps=4,
    )
    r_tp = fit(
        Config(train=tcfg, mesh=MeshConfig(data=2, model=2),
               engine=EngineConfig()),
        ds,
    )
    r_rep = fit(
        Config(train=tcfg, mesh=MeshConfig(data=4),
               engine=EngineConfig()),
        ds,
    )
    np.testing.assert_allclose(
        r_tp.final_loglik, r_rep.final_loglik, rtol=1e-5
    )


def test_tp_multi_sweep_monotone_and_simplex():
    k = 8
    ds, batch = _setup(n=512, g=20, k=k, seed=7)
    deg = jnp.asarray(ds.degrees())
    mesh = make_tp_mesh(model=4, data=2)
    step = make_tp_train_step(mesh)
    keys = jax.random.split(jax.random.key(1), 2)
    states = shard_tp_state(
        mesh, jax.vmap(lambda kk: init_state(kk, ds.n_genes, k, 2))(keys)
    )
    batch_sh = shard_tp_batch(mesh, batch)
    deg_sh = replicate_tp(mesh, deg)
    lls = []
    for _ in range(6):
        states, ll = step(states, batch_sh, deg_sh)
        lls.append(np.asarray(ll))
    lls = np.stack(lls)
    assert (np.diff(lls, axis=0) >= -1e-2).all()
    theta = np.asarray(states.theta)
    p = np.asarray(states.p)
    np.testing.assert_allclose(theta.sum(axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(p.sum(axis=-1), 1.0, atol=1e-5)
