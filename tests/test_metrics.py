"""Metric tests: AUC and average precision vs hand-computed references."""

import numpy as np
import jax.numpy as jnp

from trigenicinteractionpredictor_tpu.ops.metrics import auc, average_precision


def _sk_auc(scores, labels):
    """Reference Mann-Whitney AUC in plain NumPy (ties via average ranks)."""
    scores = np.asarray(scores, dtype=np.float64)
    labels = np.asarray(labels)
    from scipy import stats  # type: ignore

    ranks = stats.rankdata(scores)
    n_pos = labels.sum()
    n_neg = len(labels) - n_pos
    return (ranks[labels == 1].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)


def test_auc_perfect_and_inverted():
    scores = jnp.asarray([0.9, 0.8, 0.2, 0.1])
    labels = jnp.asarray([1, 1, 0, 0])
    assert float(auc(scores, labels)) == 1.0
    assert float(auc(-scores, labels)) == 0.0


def test_auc_with_ties():
    scores = jnp.asarray([0.5, 0.5, 0.5, 0.5])
    labels = jnp.asarray([1, 0, 1, 0])
    assert abs(float(auc(scores, labels)) - 0.5) < 1e-6


def test_auc_matches_rank_reference():
    rng = np.random.default_rng(0)
    scores = np.round(rng.random(500), 2)  # induces ties
    labels = (rng.random(500) < 0.3).astype(np.int32)
    try:
        expected = _sk_auc(scores, labels)
    except ImportError:
        # scipy not present: compute average ranks manually
        order = np.argsort(scores, kind="stable")
        ranks = np.empty(len(scores))
        sorted_s = scores[order]
        i = 0
        r = np.arange(1, len(scores) + 1, dtype=np.float64)
        while i < len(scores):
            j = i
            while j + 1 < len(scores) and sorted_s[j + 1] == sorted_s[i]:
                j += 1
            ranks[order[i : j + 1]] = r[i : j + 1].mean()
            i = j + 1
        n_pos = labels.sum()
        n_neg = len(labels) - n_pos
        expected = (ranks[labels == 1].sum() - n_pos * (n_pos + 1) / 2) / (
            n_pos * n_neg
        )
    got = float(auc(jnp.asarray(scores), jnp.asarray(labels)))
    assert abs(got - expected) < 1e-5


def test_auc_ignores_padding():
    scores = jnp.asarray([0.9, 0.1, 0.8, 0.95, 0.05])
    labels = jnp.asarray([1, 0, 1, 0, 1])
    weights = jnp.asarray([1.0, 1.0, 1.0, 0.0, 0.0])  # last two are padding
    expected = float(auc(scores[:3], labels[:3]))
    got = float(auc(scores, labels, weights))
    assert abs(got - expected) < 1e-6


def test_average_precision_basics():
    scores = jnp.asarray([0.9, 0.8, 0.7, 0.6])
    labels = jnp.asarray([1, 0, 1, 0])
    # P@1 = 1, P@3 = 2/3 -> AP = (1 + 2/3)/2
    assert abs(float(average_precision(scores, labels)) - (1 + 2 / 3) / 2) < 1e-6
    assert float(average_precision(scores, jnp.asarray([1, 1, 1, 1]))) == 1.0


def test_average_precision_ignores_padding():
    scores = jnp.asarray([0.9, 0.8, 0.7, 0.99])
    labels = jnp.asarray([1, 0, 1, 1])
    weights = jnp.asarray([1.0, 1.0, 1.0, 0.0])
    expected = float(average_precision(scores[:3], labels[:3]))
    got = float(average_precision(scores, labels, weights))
    assert abs(got - expected) < 1e-6


def test_serve_predict_matches_ensemble():
    """Chained-dispatch serving path == the plain ensemble scorer, incl.
    a non-block-multiple tail (padding rows must be dropped)."""
    import jax
    import jax.numpy as jnp

    from trigenicinteractionpredictor_tpu.data.synthetic import (
        sample_synthetic_dataset,
    )
    from trigenicinteractionpredictor_tpu.models.mmsbm import init_state
    from trigenicinteractionpredictor_tpu.ops.scoring import (
        ensemble_predict_interaction,
        serve_predict_interaction,
    )

    ds, _, _ = sample_synthetic_dataset(1000, 40, 4, seed=5)
    keys = jax.random.split(jax.random.key(0), 3)
    states = jax.vmap(lambda k: init_state(k, 40, 4, 2))(keys)
    want = np.asarray(
        ensemble_predict_interaction(states, jnp.asarray(ds.triplets))
    )
    # fast path (restart-batched scorer, DEFAULT precision — on CPU that
    # is full f32, so only op-order noise separates them)
    got = serve_predict_interaction(states, ds.triplets, block_rows=256)
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=3e-6)
    # bit-stable path
    got_slow = serve_predict_interaction(
        states, ds.triplets, block_rows=256, fast=False
    )
    np.testing.assert_allclose(got_slow, want, rtol=1e-6, atol=1e-7)
    # single-state (non-ensemble) form
    st1 = init_state(jax.random.key(1), 40, 4, 2)
    got1 = serve_predict_interaction(st1, ds.triplets, block_rows=300)
    assert got1.shape == (1000,)


def test_pallas_scoring_kernel_matches_loop():
    """The fused serving kernel (Triton route, interpret mode) == the
    per-restart loop scorer, including non-tile-multiple row counts
    (padding dropped)."""
    import jax
    import jax.numpy as jnp

    from trigenicinteractionpredictor_tpu.data.synthetic import (
        sample_synthetic_dataset,
    )
    from trigenicinteractionpredictor_tpu.models.mmsbm import init_state
    from trigenicinteractionpredictor_tpu.ops.pallas_score import (
        score_kernel_applies,
        triton_ensemble_predict_interaction,
    )
    from trigenicinteractionpredictor_tpu.ops.scoring import (
        ensemble_predict_interaction,
    )

    ds, _, _ = sample_synthetic_dataset(777, 40, 4, seed=9)  # ragged B
    keys = jax.random.split(jax.random.key(1), 3)
    states = jax.vmap(lambda k: init_state(k, 40, 4, 2))(keys)
    assert score_kernel_applies(3, 3, 4)
    trips = jnp.asarray(ds.triplets)
    want = np.asarray(ensemble_predict_interaction(states, trips))
    got = np.asarray(
        triton_ensemble_predict_interaction(states, trips, interpret=True)
    )
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=3e-6)


def test_batched_ensemble_scorer_matches_loop():
    """The restart-batched scorer == the per-restart loop scorer (same
    math, one dot_general) at f32 tolerance, trigenic and with HIGHEST
    precision exactly."""
    import jax
    import jax.numpy as jnp

    from trigenicinteractionpredictor_tpu.data.synthetic import (
        sample_synthetic_dataset,
    )
    from trigenicinteractionpredictor_tpu.models.mmsbm import init_state
    from trigenicinteractionpredictor_tpu.ops.scoring import (
        ensemble_predict_interaction,
        ensemble_predict_interaction_batched,
    )

    ds, _, _ = sample_synthetic_dataset(700, 30, 5, seed=2)
    keys = jax.random.split(jax.random.key(3), 4)
    states = jax.vmap(lambda k: init_state(k, 30, 5, 2))(keys)
    trips = jnp.asarray(ds.triplets)
    want = np.asarray(ensemble_predict_interaction(states, trips))
    got = np.asarray(
        ensemble_predict_interaction_batched(
            states, trips, precision=jax.lax.Precision.HIGHEST
        )
    )
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
