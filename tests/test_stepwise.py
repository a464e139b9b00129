"""Stepwise (incremental/minibatch) EM (TrainConfig.minibatch > 0).

The reference has only full-sweep EM; stepwise EM (PAPERS.md
incremental-EM line) is the mode for datasets too large for full-batch
sweeps (streaming / beyond-HBM).  At HBM-resident Kuzmin scale full-batch
EM is the production mode (a 5-epoch stepwise warm start saved only ~10%
of full-batch sweeps — docs/DESIGN.md §6).  Tests:
the running-average update preserves the simplex invariants, the update
counter and trace behave, and a stepwise fit recovers most of the
full-batch fit's held-out AUC signal.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from trigenicinteractionpredictor_tpu.config import Config, EngineConfig, TrainConfig
from trigenicinteractionpredictor_tpu.data.splits import train_test_split
from trigenicinteractionpredictor_tpu.data.synthetic import sample_synthetic_dataset
from trigenicinteractionpredictor_tpu.models.mmsbm import ModelState, init_state
from trigenicinteractionpredictor_tpu.ops.em import Batch
from trigenicinteractionpredictor_tpu.ops.metrics import auc
from trigenicinteractionpredictor_tpu.ops.scoring import predict_interaction
from trigenicinteractionpredictor_tpu.parallel.mesh import make_mesh
from trigenicinteractionpredictor_tpu.parallel.sharded_em import (
    make_sharded_stepwise_epoch,
    replicate,
    shard_ensemble,
    zero_stats_like,
)
from trigenicinteractionpredictor_tpu.train.trainer import fit


def _batches(ds, mesh, n_mb, mb):
    from jax.sharding import NamedSharding, PartitionSpec as P

    sh = NamedSharding(mesh, P(None, "data"))
    return Batch(
        triplets=jax.device_put(
            jnp.asarray(ds.triplets.reshape(n_mb, mb, ds.arity)), sh
        ),
        ratings=jax.device_put(jnp.asarray(ds.ratings.reshape(n_mb, mb)), sh),
        weights=jax.device_put(jnp.asarray(ds.weights.reshape(n_mb, mb)), sh),
    )


def test_epoch_step_invariants():
    ds, _, _ = sample_synthetic_dataset(1024, 24, 3, seed=0)
    mesh = make_mesh(data=2, ensemble=2)
    n_mb, mb = 4, 256
    S = 2
    states = shard_ensemble(
        mesh,
        jax.vmap(lambda k: init_state(k, ds.n_genes, 3, 2))(
            jax.random.split(jax.random.key(0), S)
        ),
    )
    ema = shard_ensemble(mesh, zero_stats_like(states))
    t = replicate(mesh, jnp.zeros((), jnp.float32))
    deg = replicate(mesh, jnp.asarray(ds.degrees()))
    step = make_sharded_stepwise_epoch(mesh, n_mb)

    lls = []
    batches = _batches(ds, mesh, n_mb, mb)
    w_total = replicate(mesh, jnp.asarray(np.float32(ds.weights.sum())))
    for _ in range(5):
        states, ema, ll, t = step(states, ema, t, batches, deg, w_total)
        lls.append(np.asarray(ll))
        theta = np.asarray(states.theta)
        p = np.asarray(states.p)
        np.testing.assert_allclose(theta.sum(axis=-1), 1.0, atol=1e-5)
        np.testing.assert_allclose(p.sum(axis=-1), 1.0, atol=1e-5)
        assert (theta >= -1e-7).all() and (p >= -1e-7).all()
    assert float(np.asarray(t)) == 5 * n_mb
    # epoch-mean likelihood should improve from the random init
    assert lls[-1].mean() > lls[0].mean()


def test_stepwise_fit_matches_fullbatch_auc_with_fewer_epochs():
    ds, theta_star, p_star = sample_synthetic_dataset(
        8192, 40, 3, alpha_theta=0.2, seed=3
    )
    train, test = train_test_split(ds, 0.2, seed=0)
    tt = jnp.asarray(test.triplets)
    labels = jnp.asarray(test.ratings)

    def auc_of(result):
        best = result.best_state()
        return float(
            auc(
                predict_interaction(
                    ModelState(
                        theta=jnp.asarray(best.theta), p=jnp.asarray(best.p)
                    ),
                    tt,
                ),
                labels,
            )
        )

    full = fit(
        Config(train=TrainConfig(k=3, sweeps=150, samples=2, likelihood_freq=25)),
        train,
    )
    stepw = fit(
        Config(
            train=TrainConfig(
                k=3, sweeps=30, samples=2, likelihood_freq=5, minibatch=512
            ),
            engine=EngineConfig(batch_pad_multiple=512),
        ),
        train,
    )
    full_auc, step_auc = auc_of(full), auc_of(stepw)
    # In 5x fewer data passes, stepwise recovers most of the held-out
    # signal (the Robbins-Monro tail converges slowly; full-batch EM is
    # the production mode when the data fits HBM — see module docstring).
    assert step_auc > 0.5 + 0.6 * (full_auc - 0.5), (step_auc, full_auc)
    assert np.isfinite(stepw.final_loglik).all()
    assert stepw.sweeps_run == 30


def test_stepwise_resume_restarts_from_scratch(tmp_path):
    """A stepwise unit handed a checkpoint restarts fresh (the EMA carry is
    not checkpointed) instead of raising — raising would wedge the CV
    driver's elastic relaunch, which passes resume whenever a checkpoint
    exists."""
    from trigenicinteractionpredictor_tpu.train.checkpoint import save_checkpoint

    ds, _, _ = sample_synthetic_dataset(1024, 16, 2, seed=1)
    ck = str(tmp_path / "prev.npz")
    st = init_state(jax.random.key(0), ds.n_genes, 2, 2)
    save_checkpoint(
        ck,
        ModelState(theta=np.asarray(st.theta)[None], p=np.asarray(st.p)[None]),
        sweep=2,
        ll_trace=np.zeros((0, 1)),
    )
    cfg = Config(train=TrainConfig(k=2, sweeps=4, samples=1, minibatch=256))
    result = fit(cfg, ds, resume=ck)
    assert result.sweeps_run == 4
    assert np.isfinite(result.final_loglik).all()


def test_stepwise_minibatch_rounds_up_not_lcm():
    """minibatch=1000 with pad 512 must give 1024-row minibatches, not
    lcm(1000, 512) = 64000."""
    ds, _, _ = sample_synthetic_dataset(8192, 20, 2, seed=2)
    cfg = Config(
        train=TrainConfig(k=2, sweeps=2, samples=1, minibatch=1000)
    )
    result = fit(cfg, ds)  # would raise n_mb < 2 under the lcm sizing
    assert result.sweeps_run == 2


def test_stepwise_resume_equivalence(tmp_path):
    """fit(N) == fit(n) + resume -> N: the checkpoint carries the EMA
    statistics + update counter, and the epoch shuffle is (seed, epoch)-
    derived, so a resumed stepwise run replays exactly."""
    ds, _, _ = sample_synthetic_dataset(2048, 16, 2, seed=3)

    def cfg(sweeps):
        return Config(
            train=TrainConfig(
                k=2, sweeps=sweeps, samples=2, minibatch=256,
                likelihood_freq=1, seed=5,
            )
        )

    full = fit(cfg(6), ds)

    ck = str(tmp_path / "sw.ckpt.npz")
    fit(cfg(3), ds, checkpoint_path=ck)
    resumed = fit(cfg(6), ds, resume=ck, checkpoint_path=ck)

    assert resumed.sweeps_run == 6
    np.testing.assert_allclose(
        np.asarray(resumed.states.theta), np.asarray(full.states.theta),
        atol=1e-6,
    )
    np.testing.assert_allclose(
        resumed.final_loglik, full.final_loglik, rtol=1e-6
    )
    # The merged trace covers all 6 epochs.
    assert resumed.ll_trace.shape[0] == 6


def test_classic_resume_equivalence(tmp_path):
    """Classic EM: resumed fit reproduces the uninterrupted fit exactly
    (EM is deterministic given the checkpointed states)."""
    ds, _, _ = sample_synthetic_dataset(1024, 16, 2, seed=4)

    def cfg(sweeps):
        return Config(
            train=TrainConfig(
                k=2, sweeps=sweeps, samples=2, likelihood_freq=2, seed=9
            )
        )

    full = fit(cfg(8), ds)
    ck = str(tmp_path / "cl.ckpt.npz")
    fit(cfg(4), ds, checkpoint_path=ck)
    resumed = fit(cfg(8), ds, resume=ck, checkpoint_path=ck)
    assert resumed.sweeps_run == 8
    np.testing.assert_allclose(
        np.asarray(resumed.states.theta), np.asarray(full.states.theta),
        atol=1e-6,
    )
    np.testing.assert_allclose(
        resumed.final_loglik, full.final_loglik, rtol=1e-6
    )


@pytest.mark.parametrize("row_chunk", [100, 256])
def test_stepwise_row_chunk_matches_whole(row_chunk):
    """Stepwise EM through the row-chunked statistics (the trainer's
    default path) == the whole-minibatch statistics: chunking only splits
    sums that are linear in rows, including a ragged last chunk."""
    ds, _, _ = sample_synthetic_dataset(2048, 30, 3, seed=11)
    mk = lambda rc: Config(  # noqa: E731
        train=TrainConfig(
            k=3, sweeps=4, samples=2, likelihood_freq=2, minibatch=512
        ),
        engine=EngineConfig(batch_pad_multiple=512, jnp_row_chunk=rc),
    )
    ref = fit(mk(0), ds)
    out = fit(mk(row_chunk), ds)
    np.testing.assert_allclose(
        np.asarray(out.states.theta), np.asarray(ref.states.theta),
        atol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(out.states.p), np.asarray(ref.states.p), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(out.ll_trace), np.asarray(ref.ll_trace), rtol=1e-5
    )


@pytest.mark.parametrize("arity", [3, 2])
def test_stepwise_streaming_groups_exact(arity):
    """stream_groups must not change the stepwise result: the EMA sequence
    depends only on the carried counter and per-minibatch sums — for the
    trigenic and the digenic family alike."""
    ds, _, _ = sample_synthetic_dataset(2048, 30, 3, seed=12, arity=arity)
    mk = lambda sg: Config(  # noqa: E731
        train=TrainConfig(
            k=3, sweeps=4, samples=2, likelihood_freq=2, minibatch=512,
            stream_groups=sg,
        ),
        engine=EngineConfig(batch_pad_multiple=512),
    )
    mono = fit(mk(0), ds)
    strm = fit(mk(2), ds)
    np.testing.assert_allclose(
        np.asarray(strm.states.theta), np.asarray(mono.states.theta),
        atol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(strm.states.p), np.asarray(mono.states.p), atol=1e-5
    )
