"""Compute-path resolution: ops/em.py is the engine's only EM path, mapped
over restarts and sharded over data by the trainer, and the resolved path
is recorded in the fit's artifacts."""

import numpy as np

from trigenicinteractionpredictor_tpu.config import Config, EngineConfig, TrainConfig
from trigenicinteractionpredictor_tpu.data.synthetic import sample_synthetic_dataset
from trigenicinteractionpredictor_tpu.train.trainer import fit


def test_serial_restart_map_matches_vmap():
    """K >= 32 flips restarts from vmap to lax.map — results identical."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from trigenicinteractionpredictor_tpu.data.synthetic import (
        sample_synthetic_dataset,
    )
    from trigenicinteractionpredictor_tpu.models import init_state
    from trigenicinteractionpredictor_tpu.ops.em import Batch, em_step
    from trigenicinteractionpredictor_tpu.parallel.mesh import make_mesh
    from trigenicinteractionpredictor_tpu.ops.em import SERIAL_RESTART_K
    from trigenicinteractionpredictor_tpu.parallel.sharded_em import (
        make_sharded_train_step,
        replicate,
        shard_batch,
        shard_ensemble,
    )

    k = SERIAL_RESTART_K
    ds, _, _ = sample_synthetic_dataset(256, 20, k, seed=2)
    batch = Batch(
        triplets=jnp.asarray(ds.triplets),
        ratings=jnp.asarray(ds.ratings),
        weights=jnp.asarray(ds.weights),
    )
    deg = jnp.asarray(ds.degrees())
    states = jax.vmap(lambda kk: init_state(kk, ds.n_genes, k, 2))(
        jax.random.split(jax.random.key(1), 2)
    )
    ref_states, ref_ll = jax.vmap(em_step, in_axes=(0, None, None))(
        states, batch, deg
    )
    mesh = make_mesh(data=2, ensemble=1)
    step = make_sharded_train_step(mesh)
    new_states, ll = step(
        shard_ensemble(mesh, states), shard_batch(mesh, batch), replicate(mesh, deg)
    )
    np.testing.assert_allclose(np.asarray(ll), np.asarray(ref_ll), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(new_states.theta), np.asarray(ref_states.theta), atol=1e-5
    )


def test_resolve_auto_on_cpu_is_jnp():
    """Without an override the trainer runs ops/em.py's statistics
    (row-chunked at the configured chunk) and records that path; a fit
    with row chunking off gives the same statistics as one with it on."""
    ds, _, _ = sample_synthetic_dataset(700, 25, 3, seed=4)
    mk = lambda rc: Config(  # noqa: E731
        train=TrainConfig(k=3, sweeps=4, samples=2, likelihood_freq=2),
        engine=EngineConfig(jnp_row_chunk=rc),
    )
    chunked = fit(mk(128), ds)
    whole = fit(mk(0), ds)
    assert chunked.dispatch == {"kernel": "jnp", "row_chunk": 128}
    assert whole.dispatch == {"kernel": "jnp", "row_chunk": 0}
    np.testing.assert_allclose(
        chunked.final_loglik, whole.final_loglik, rtol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(chunked.states.theta), np.asarray(whole.states.theta),
        atol=1e-5,
    )


def test_fit_records_dispatch_decision(tmp_path):
    """The resolved compute path (EM family, row chunk) rides in
    FitResult.dispatch and in the checkpoint (extra_dispatch_json)."""
    import json

    from trigenicinteractionpredictor_tpu.train.checkpoint import (
        load_checkpoint,
    )

    ds, _, _ = sample_synthetic_dataset(600, 30, 3, seed=0)
    cfg = Config(
        train=TrainConfig(k=3, sweeps=4, samples=2, likelihood_freq=2),
    )
    ck = str(tmp_path / "ck.npz")
    res = fit(cfg, ds, checkpoint_path=ck)
    assert res.dispatch["kernel"] == "jnp"
    assert res.dispatch["row_chunk"] == cfg.engine.jnp_row_chunk
    loaded = load_checkpoint(ck)
    dj = json.loads(bytes(loaded["extra"]["dispatch_json"]).decode())
    assert dj == res.dispatch
