"""The sharded restart-ensemble EM step against the float64 oracle.

One sweep of ``make_sharded_train_step`` (restarts vmapped, or lax.map'd
from K = SERIAL_RESTART_K, sharded over the ``ensemble`` axis; rows
sharded over ``data`` with a psum of the statistics) must equal
``oracle.em_sweep`` run restart by restart: narrow, prime and wide S,
K up to 64, arity 3 and 2, on the 8-device CPU mesh.

Tolerance: as in test_em_oracle_parity (float32 at HIGHEST precision
against float64), 1e-4 relative to the largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import oracle
from trigenicinteractionpredictor_tpu.models.mmsbm import init_state
from trigenicinteractionpredictor_tpu.ops.em import Batch
from trigenicinteractionpredictor_tpu.parallel.mesh import make_mesh
from trigenicinteractionpredictor_tpu.parallel.sharded_em import (
    make_sharded_train_step,
    replicate,
    shard_batch,
    shard_ensemble,
)

CASES = [
    # (S, K, arity, data, ensemble, rows, G)
    (1, 4, 3, 2, 1, 256, 30),
    (2, 4, 3, 2, 2, 256, 30),
    (7, 3, 3, 4, 1, 256, 30),      # prime S
    (12, 3, 3, 2, 4, 256, 30),     # wide S, sharded restarts
    (4, 10, 3, 8, 1, 512, 200),    # headline K on 8 data shards
    (3, 33, 3, 2, 1, 64, 40),      # lax.map over restarts
    (2, 64, 3, 1, 2, 32, 40),      # K = 64
    (5, 4, 2, 2, 1, 256, 30),      # digenic
]


@pytest.mark.parametrize(
    "S,k,arity,data,ens,n,g",
    CASES,
    ids=[f"S{c[0]}-K{c[1]}-a{c[2]}-d{c[3]}e{c[4]}" for c in CASES],
)
def test_sharded_sweep_matches_oracle(S, k, arity, data, ens, n, g):
    rng = np.random.default_rng(S * 100 + k)
    trip = rng.integers(0, g, size=(n, arity)).astype(np.int32)
    rat = rng.integers(0, 2, size=n).astype(np.int32)
    w = np.ones(n, np.float32)
    deg = np.bincount(trip.reshape(-1), minlength=g).astype(np.float32)
    states = jax.vmap(lambda kk: init_state(kk, g, k, 2, arity=arity))(
        jax.random.split(jax.random.key(S + k), S)
    )
    mesh = make_mesh(data=data, ensemble=ens)
    step = make_sharded_train_step(mesh)
    new, ll = step(
        shard_ensemble(mesh, states),
        shard_batch(mesh, Batch(jnp.asarray(trip), jnp.asarray(rat), jnp.asarray(w))),
        replicate(mesh, jnp.asarray(deg)),
    )
    sweep = oracle.em_sweep if arity == 3 else oracle.em_sweep_pair
    for s in range(S):
        th1, p1, ll_o = sweep(
            np.asarray(states.theta[s], np.float64),
            np.asarray(states.p[s], np.float64),
            trip, rat, deg,
        )
        np.testing.assert_allclose(np.asarray(new.theta[s]), th1, atol=1e-4)
        np.testing.assert_allclose(np.asarray(new.p[s]), p1, atol=1e-4)
        assert abs(float(ll[s]) - ll_o) <= 1e-4 * abs(ll_o), (s, float(ll[s]), ll_o)
