"""Quality knobs: DAEM annealing, spectral init, refinement.

All default OFF (reference parity); these tests pin their mechanics:
annealed sweeps with beta == 1 are exact EM, the ramp ends in a monotone
exact-EM phase, refinement never loses likelihood (restart 0 keeps the
unperturbed best state + EM monotonicity), and spectral init produces
valid graded simplexes.  Quality effects are documented in docs/DESIGN.md
§5b ("EM quality study"), not asserted here — they are config-dependent.
"""

import numpy as np
import jax
import jax.numpy as jnp

from trigenicinteractionpredictor_tpu.config import Config, TrainConfig
from trigenicinteractionpredictor_tpu.data.splits import train_test_split
from trigenicinteractionpredictor_tpu.data.synthetic import (
    sample_synthetic_dataset,
)
from trigenicinteractionpredictor_tpu.train.trainer import _anneal_schedule, fit


def _ds(n=2000, g=30, k=3, seed=0, alpha=0.3):
    ds, _, _ = sample_synthetic_dataset(n, g, k, alpha_theta=alpha, seed=seed)
    return train_test_split(ds, 0.2, 0)[0]


def test_anneal_schedule_shape():
    t = TrainConfig(sweeps=100, anneal_beta0=0.25, anneal_sweeps=40)
    sched = _anneal_schedule(t)
    assert sched.shape == (100,)
    assert np.isclose(sched[0], 0.25, atol=1e-6)
    assert np.all(np.diff(sched) >= -1e-7)          # monotone ramp
    assert np.allclose(sched[40:], 1.0)             # exact EM after ramp
    assert _anneal_schedule(TrainConfig(anneal_beta0=1.0)) is None


def test_annealed_beta_one_equals_plain():
    """A beta==1 'annealed' run must reproduce plain EM exactly — the
    powered-parameter trick is the identity at beta 1."""
    train = _ds()
    base = dict(k=3, sweeps=8, samples=2, likelihood_freq=4, seed=0)
    plain = fit(Config(train=TrainConfig(**base)), train)
    # anneal_beta0 just below 1 with a 1-sweep ramp: sweep 0 uses
    # beta ~ 1-1e-6, everything after is exactly 1.
    annealed = fit(
        Config(
            train=TrainConfig(
                **base, anneal_beta0=1.0 - 1e-6, anneal_sweeps=1
            )
        ),
        train,
    )
    np.testing.assert_allclose(
        annealed.final_loglik, plain.final_loglik, rtol=1e-5
    )


def test_annealed_run_monotone_after_ramp():
    train = _ds(seed=3)
    cfg = Config(
        train=TrainConfig(
            k=3, sweeps=30, samples=2, likelihood_freq=1, seed=1,
            anneal_beta0=0.3, anneal_sweeps=10,
        )
    )
    r = fit(cfg, train)
    assert r.sweeps_run == 30
    theta = np.asarray(r.states.theta)
    np.testing.assert_allclose(theta.sum(-1), 1.0, atol=1e-5)
    # Post-ramp rows of the trace are exact-EM likelihoods: monotone.
    post = r.ll_trace[12:]
    assert (np.diff(post, axis=0) >= -1e-2).all()


def test_refinement_never_loses_likelihood():
    train = _ds(seed=5, alpha=0.1)
    base = dict(k=3, sweeps=40, samples=3, likelihood_freq=10, seed=2)
    plain = fit(Config(train=TrainConfig(**base)), train)
    refined = fit(
        Config(
            train=TrainConfig(**base, refine_rounds=2, refine_sweeps=10)
        ),
        train,
    )
    assert refined.final_loglik.max() >= plain.final_loglik.max() - 1e-3
    assert refined.sweeps_run == 40 + 2 * 10


def test_spectral_init_valid_simplexes():
    from trigenicinteractionpredictor_tpu.models.informed_init import (
        spectral_init_arrays,
    )

    train = _ds(n=1500, g=25, k=4, seed=7)
    thetas, ps = spectral_init_arrays(train, k=4, n_samples=5, seed=0)
    assert thetas.shape == (5, 25, 4)
    assert ps.shape == (5, 4, 4, 4, 2)
    np.testing.assert_allclose(thetas.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(ps.sum(-1), 1.0, atol=1e-5)
    assert (thetas >= 0).all() and (ps >= 0).all()
    # graded noise: later restarts are farther from restart 0's init
    d = [
        float(np.abs(thetas[s] - thetas[0]).mean())
        for s in range(1, 5)
    ]
    assert d == sorted(d)

    # end-to-end through fit
    r = fit(
        Config(
            train=TrainConfig(
                k=4, sweeps=10, samples=3, likelihood_freq=5,
                init_method="spectral",
            )
        ),
        train,
    )
    assert np.isfinite(r.final_loglik).all()


def test_merge_split_candidate_preserves_invariants():
    from trigenicinteractionpredictor_tpu.models.proposals import (
        merge_split_candidate,
    )

    rng = np.random.default_rng(0)
    G, K, R = 25, 5, 2
    theta = rng.dirichlet(np.ones(K), size=G)
    p = rng.dirichlet(np.ones(R), size=(K, K, K))
    th2, p2, (j, k, split) = merge_split_candidate(theta, p, rng)
    assert th2.shape == (G, K) and p2.shape == (K, K, K, R)
    np.testing.assert_allclose(th2.sum(-1), 1.0, atol=1e-5)   # simplex rows
    np.testing.assert_allclose(p2.sum(-1), 1.0, atol=1e-5)
    assert (th2 >= 0).all() and (p2 >= 0).all()
    assert j != k and split not in (j, k)
    # the merge column carries the combined mass of its parents
    np.testing.assert_allclose(
        th2[:, 0], theta[:, j] + theta[:, k], atol=1e-6
    )
    # the split children partition the parent column per gene
    np.testing.assert_allclose(
        th2[:, 1] + th2[:, 2], theta[:, split], atol=1e-6
    )
    # digenic family: p[K, K, R] goes through the same axis map
    p_di = rng.dirichlet(np.ones(R), size=(K, K))
    _, p2_di, _ = merge_split_candidate(theta, p_di, rng)
    assert p2_di.shape == (K, K, R)
    np.testing.assert_allclose(p2_di.sum(-1), 1.0, atol=1e-5)


def test_smem_never_loses_likelihood():
    train = _ds(seed=9, alpha=0.1)
    base = dict(k=3, sweeps=40, samples=3, likelihood_freq=10, seed=2)
    plain = fit(Config(train=TrainConfig(**base)), train)
    smem = fit(
        Config(train=TrainConfig(**base, smem_rounds=2, smem_sweeps=10)),
        train,
    )
    assert smem.final_loglik.max() >= plain.final_loglik.max() - 1e-3
    assert smem.sweeps_run == 40 + 2 * 10


def test_smem_composes_with_refine():
    train = _ds(seed=11)
    r = fit(
        Config(
            train=TrainConfig(
                k=3, sweeps=20, samples=2, likelihood_freq=10, seed=1,
                smem_rounds=1, smem_sweeps=5,
                refine_rounds=1, refine_sweeps=5,
            )
        ),
        train,
    )
    assert r.sweeps_run == 20 + 5 + 5
    assert np.isfinite(r.final_loglik).all()
