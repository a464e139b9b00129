"""The EM engine (ops/em.py, the only EM path) against the float64 NumPy
oracle, over the shapes the engine serves.

Each case compares the unnormalized statistics (theta_hat, p_hat, loglik)
of one ``em_sufficient_stats`` call with ``oracle.em_sufficient_stats``:
ragged row counts, K from 2 to 64, G up to 50k (the segment-sum scatter,
no [B, G] operand), R = 2 and 3, arity 3 and 2, row chunking off and on
(including a ragged last chunk), and weight-0 padding rows.

Tolerance: the engine runs float32 at HIGHEST precision, the oracle
float64; at these sizes the float32 rounding of sums over <= 1000 rows is
below 1e-5 of the largest entry, so 1e-4 relative to the largest entry
leaves an order of magnitude of margin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import oracle
from trigenicinteractionpredictor_tpu.models.mmsbm import init_state
from trigenicinteractionpredictor_tpu.ops.em import Batch, em_sufficient_stats

RTOL = 1e-4


def _case(n, g, k, r, arity, seed, n_pad=0):
    rng = np.random.default_rng(seed)
    trip = rng.integers(0, g, size=(n + n_pad, arity)).astype(np.int32)
    rat = rng.integers(0, r, size=n + n_pad).astype(np.int32)
    w = np.ones(n + n_pad, np.float32)
    w[n:] = 0.0                                   # padding rows
    st = init_state(jax.random.key(seed), g, k, r, arity=arity)
    return trip, rat, w, np.asarray(st.theta), np.asarray(st.p)


def assert_close_rel(got, want, rtol=RTOL, what=""):
    got = np.asarray(got, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: max err {err:.3g} vs scale {scale:.3g}"


CASES = [
    # (rows, G, K, R, arity, row_chunk, padding rows)
    (1, 5, 2, 2, 3, 0, 0),
    (7, 5, 3, 2, 3, 0, 0),
    (129, 40, 4, 2, 3, 0, 3),
    (333, 40, 4, 3, 3, 0, 0),
    (333, 40, 4, 2, 3, 64, 0),
    (1000, 200, 10, 2, 3, 0, 24),
    (1000, 200, 10, 2, 3, 256, 0),
    (500, 50_000, 5, 2, 3, 0, 0),
    (500, 50_000, 5, 2, 3, 128, 12),
    (200, 1000, 16, 2, 3, 0, 0),
    (64, 100, 33, 2, 3, 0, 0),
    (32, 100, 64, 2, 3, 0, 0),
    (32, 100, 64, 2, 3, 12, 0),
    (1, 5, 2, 2, 2, 0, 0),
    (129, 40, 4, 2, 2, 0, 3),
    (333, 40, 4, 3, 2, 0, 0),
    (1000, 200, 10, 2, 2, 0, 24),
    (500, 50_000, 5, 2, 2, 0, 0),
    (64, 100, 33, 2, 2, 0, 0),
    (32, 100, 64, 3, 2, 0, 0),
]


@pytest.mark.parametrize(
    "n,g,k,r,arity,row_chunk,n_pad",
    CASES,
    ids=[f"B{c[0]}-G{c[1]}-K{c[2]}-R{c[3]}-a{c[4]}-rc{c[5]}-pad{c[6]}" for c in CASES],
)
def test_em_stats_match_oracle(n, g, k, r, arity, row_chunk, n_pad):
    trip, rat, w, theta, p = _case(n, g, k, r, arity, seed=n + g + k, n_pad=n_pad)
    stats = jax.jit(
        lambda th, pp, t, rr, ww: em_sufficient_stats(
            th, pp, Batch(t, rr, ww), row_chunk=row_chunk
        )
    )(*(jnp.asarray(a) for a in (theta, p, trip, rat, w)))
    th_hat, p_hat, ll = oracle.em_sufficient_stats(theta, p, trip, rat, w)
    assert stats.theta_hat.shape == (g, k)
    assert stats.p_hat.shape == p.shape
    assert_close_rel(stats.theta_hat, th_hat, what="theta_hat")
    assert_close_rel(stats.p_hat, p_hat, what="p_hat")
    assert_close_rel(stats.loglik, np.asarray(ll), what="loglik")
