"""Tests that need the GPU (marker ``gpu``).

They skip elsewhere through the ``gpu_device`` fixture (tests/conftest.py)
and run on the card by ``python chip_smoke.py`` (phase "gpu-tests"),
which starts pytest in its own process with TRIGENIC_TEST_DEVICE=gpu.

Tolerances:
- EM statistics vs the float64 oracle and vs the host CPU: 1e-4 relative
  to the largest entry.  The GPU runs float32 at HIGHEST precision (true
  f32, no TF32), so the two differ only in summation order; theta_hat's
  segment_sum is an atomic scatter whose order changes from run to run.
- Scores of the fused Triton kernel (TF32 dot) vs the HIGHEST-precision
  per-restart scorer: 2e-3 absolute on P(interact) in [0, 1].
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import oracle
from trigenicinteractionpredictor_tpu.models.mmsbm import init_state
from trigenicinteractionpredictor_tpu.ops.em import Batch, em_sufficient_stats

pytestmark = pytest.mark.gpu

STATS_RTOL = 1e-4
SCORE_ATOL = 2e-3


def _rel_err(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)


@pytest.mark.parametrize("arity", [3, 2])
def test_em_stats_on_gpu_match_oracle_and_cpu(gpu_device, arity):
    n, g, k, r = 16384, 1000, 10, 2
    rng = np.random.default_rng(arity)
    trip = rng.integers(0, g, size=(n, arity)).astype(np.int32)
    rat = rng.integers(0, r, size=n).astype(np.int32)
    w = np.ones(n, np.float32)
    st = init_state(jax.random.key(0), g, k, r, arity=arity)
    theta, p = np.asarray(st.theta), np.asarray(st.p)

    def run(device):
        args = [jax.device_put(jnp.asarray(a), device) for a in (theta, p, trip, rat, w)]
        out = jax.jit(
            lambda th, pp, t, rr, ww: em_sufficient_stats(th, pp, Batch(t, rr, ww))
        )(*args)
        return [np.asarray(x) for x in out]

    dev = run(gpu_device)
    cpu = run(jax.devices("cpu")[0])
    ref = oracle.em_sufficient_stats(theta, p, trip, rat, w)
    for name, a, c, o in zip(("theta_hat", "p_hat", "loglik"), dev, cpu, ref):
        assert _rel_err(a, o) <= STATS_RTOL, (name, _rel_err(a, o))
        assert _rel_err(a, c) <= STATS_RTOL, (name, _rel_err(a, c))


@pytest.mark.parametrize("g", [1000, 100_000])
def test_triton_scorer_on_gpu_matches_highest(gpu_device, g):
    """The kernel as compiled for the card, at the serving widths."""
    from trigenicinteractionpredictor_tpu.ops.pallas_score import (
        triton_ensemble_predict_interaction,
    )
    from trigenicinteractionpredictor_tpu.ops.scoring import (
        ensemble_predict_interaction,
    )

    S, K, B = 10, 10, 65536 + 37
    states = jax.vmap(lambda kk: init_state(kk, g, K, 2))(
        jax.random.split(jax.random.key(1), S)
    )
    trips = jnp.asarray(np.random.default_rng(2).integers(0, g, size=(B, 3)), jnp.int32)
    got = np.asarray(triton_ensemble_predict_interaction(states, trips))
    want = np.asarray(ensemble_predict_interaction(states, trips))
    assert got.shape == (B,)
    assert np.isfinite(got).all()
    assert float(np.abs(got - want).max()) <= SCORE_ATOL


def test_serve_on_gpu_takes_the_kernel(gpu_device, monkeypatch):
    from trigenicinteractionpredictor_tpu.ops import pallas_score
    from trigenicinteractionpredictor_tpu.ops.scoring import (
        _score_chunk,
        ensemble_predict_interaction,
        serve_predict_interaction,
    )

    calls = []
    real = pallas_score.triton_ensemble_predict_interaction

    def spy(*a, **kw):
        calls.append(kw.get("interpret"))
        return real(*a, **kw)

    monkeypatch.setattr(pallas_score, "triton_ensemble_predict_interaction", spy)
    _score_chunk.clear_cache()       # retrace, so the spy sees the choice
    states = jax.vmap(lambda kk: init_state(kk, 1000, 10, 2))(
        jax.random.split(jax.random.key(3), 10)
    )
    trips = np.random.default_rng(4).integers(0, 1000, size=(200_000, 3)).astype(np.int32)
    got = serve_predict_interaction(states, trips)
    assert calls == [False]
    want = np.asarray(ensemble_predict_interaction(states, jnp.asarray(trips)))
    assert float(np.abs(got - want).max()) <= SCORE_ATOL


def test_integrity_probe_passes_on_gpu(gpu_device):
    from trigenicinteractionpredictor_tpu.utils import integrity

    integrity._probe_result.cache_clear()
    assert integrity._probe_result("gpu", 32768, 512, 10, 2, 3)
