"""The fused Triton scoring kernel (ops/pallas_score.py) in the Pallas
interpreter: agreement with the float64 oracle and with the
HIGHEST-precision per-restart scorer over (S, K, G, ragged B), its tile
and padding rules, and its choice by shape inside
``serve_predict_interaction``.

Tolerance: the interpreter computes in float32, so scores agree with the
HIGHEST scorer to float32 rounding (3e-6 absolute on probabilities in
[0, 1]).  On the GPU the kernel's dot runs TF32; its bound there (2e-3
absolute against the HIGHEST scorer) is checked on the card by
tests/test_on_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import oracle
from trigenicinteractionpredictor_tpu.models.mmsbm import init_state
from trigenicinteractionpredictor_tpu.ops import pallas_score
from trigenicinteractionpredictor_tpu.ops.pallas_score import (
    score_kernel_applies,
    tile_rows,
    triton_ensemble_predict_interaction,
)
from trigenicinteractionpredictor_tpu.ops.scoring import (
    _score_chunk,
    ensemble_predict_interaction,
    serve_predict_interaction,
)


def _ensemble(S, G, K, R=2, seed=0):
    return jax.vmap(lambda kk: init_state(kk, G, K, R))(
        jax.random.split(jax.random.key(seed), S)
    )


def _trips(B, G, seed=0):
    return np.random.default_rng(seed).integers(0, G, size=(B, 3)).astype(np.int32)


CASES = [
    # (S, K, G, B)
    (1, 2, 5, 1),
    (1, 3, 7, 17),
    (2, 4, 40, 63),
    (3, 5, 40, 300),
    (7, 6, 100, 65),        # prime S
    (10, 10, 1000, 777),    # the headline S, K, G; ragged B
    (4, 16, 300, 130),      # widest K of the 64-row tile
    (2, 17, 50, 33),        # first K of the 32-wide padding
    (3, 32, 64, 40),        # widest K the kernel serves
    (2, 10, 5000, 100),
]


@pytest.mark.parametrize(
    "S,K,G,B", CASES, ids=[f"S{c[0]}-K{c[1]}-G{c[2]}-B{c[3]}" for c in CASES]
)
def test_kernel_matches_oracle_and_highest_scorer(S, K, G, B):
    states = _ensemble(S, G, K, seed=S + K)
    trips = _trips(B, G, seed=B)
    got = np.asarray(
        triton_ensemble_predict_interaction(
            states, jnp.asarray(trips), interpret=True
        )
    )
    assert got.shape == (B,) and got.dtype == np.float32
    want = np.asarray(ensemble_predict_interaction(states, jnp.asarray(trips)))
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-6)
    ref = np.mean(
        [
            oracle.predict_proba(
                np.asarray(states.theta[s], np.float64),
                np.asarray(states.p[s], np.float64),
                trips,
            )[:, 1]
            for s in range(S)
        ],
        axis=0,
    )
    np.testing.assert_allclose(got, ref, rtol=0, atol=3e-6)


@pytest.mark.parametrize("rating", [0, 2])
def test_kernel_scores_any_rating(rating):
    """interact_rating picks p's slice; with R=3 every rating works."""
    states = _ensemble(3, 30, 4, R=3, seed=1)
    trips = jnp.asarray(_trips(50, 30))
    got = triton_ensemble_predict_interaction(states, trips, rating, interpret=True)
    want = ensemble_predict_interaction(states, trips, rating)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=3e-6)


@pytest.mark.parametrize("k,bt", [(2, 64), (10, 64), (16, 64), (17, 16), (32, 16)])
def test_tile_rows(k, bt):
    """64-row tiles up to K=16 (Kp=16), 16-row tiles at Kp=32: W [Bt, Kp^2]
    stays at 16K elements."""
    assert tile_rows(k) == bt


@pytest.mark.parametrize(
    "arity,S,K,applies",
    [(3, 10, 10, True), (3, 1, 32, True), (3, 10, 33, False), (2, 10, 10, False)],
)
def test_kernel_applies_by_shape(arity, S, K, applies):
    assert score_kernel_applies(arity, S, K) is applies


def test_padding_rows_never_reach_output():
    """Rows are padded to the tile with gene 0; the padded scores are
    dropped, and the real rows do not depend on the padding."""
    states = _ensemble(2, 20, 3)
    trips = _trips(70, 20)
    full = np.asarray(
        triton_ensemble_predict_interaction(states, jnp.asarray(trips), interpret=True)
    )
    head = np.asarray(
        triton_ensemble_predict_interaction(
            states, jnp.asarray(trips[:64]), interpret=True
        )
    )
    assert full.shape == (70,)
    np.testing.assert_array_equal(full[:64], head)


def _spy(monkeypatch):
    calls = []
    real = pallas_score.triton_ensemble_predict_interaction

    def spy(*a, **kw):
        calls.append(kw.get("interpret"))
        return real(*a, **kw)

    monkeypatch.setattr(pallas_score, "triton_ensemble_predict_interaction", spy)
    _score_chunk.clear_cache()       # retrace, so the spy sees the choice
    return calls


def test_serve_uses_kernel_where_it_applies(monkeypatch):
    calls = _spy(monkeypatch)
    states = _ensemble(3, 40, 4, seed=3)
    trips = _trips(300, 40, seed=3)
    got = serve_predict_interaction(
        states, trips, block_rows=128, interpret=True
    )
    assert calls and all(calls)
    want = np.asarray(ensemble_predict_interaction(states, jnp.asarray(trips)))
    np.testing.assert_allclose(got, want, atol=3e-6)


@pytest.mark.parametrize(
    "S,K,arity,fast",
    [(3, 33, 3, True), (3, 4, 2, True), (3, 4, 3, False), (0, 4, 3, True)],
    ids=["wide-K", "digenic", "not-fast", "single-state"],
)
def test_serve_skips_kernel_where_it_does_not(monkeypatch, S, K, arity, fast):
    """Past K=32, for digenic rows, with fast=False and for a single state
    the plain scorers serve, with the same results."""
    calls = _spy(monkeypatch)
    G = 30
    if S:
        states = _ensemble(S, G, K, seed=4)
    else:
        states = init_state(jax.random.key(4), G, K, 2)
    if arity == 2:
        states = jax.vmap(lambda kk: init_state(kk, G, K, 2, arity=2))(
            jax.random.split(jax.random.key(4), S)
        )
    trips = np.random.default_rng(5).integers(0, G, size=(90, arity)).astype(np.int32)
    got = serve_predict_interaction(
        states, trips, block_rows=64, fast=fast, interpret=True
    )
    assert calls == []
    assert got.shape == (90,)
    if S and arity == 3:
        want = np.asarray(ensemble_predict_interaction(states, jnp.asarray(trips)))
        np.testing.assert_allclose(got, want, atol=3e-6)


def test_serve_on_cpu_without_interpret_is_plain(monkeypatch):
    """Off the GPU the kernel is never compiled: serving without
    ``interpret`` takes the restart-batched scorer."""
    calls = _spy(monkeypatch)
    states = _ensemble(2, 20, 3)
    got = serve_predict_interaction(states, _trips(40, 20), block_rows=16)
    assert calls == [] and got.shape == (40,)
